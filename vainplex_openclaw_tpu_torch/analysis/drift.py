"""Drift lints: cross-file contracts that rot silently.

A copy of ``vainplex_openclaw_tpu/analysis/drift.py`` over the port's own
sets, fault sites and config modules. Two scopes differ from JAX's: the
fault-site rule reads the port's tests (``tests/test_torch_*.py``) and
``chip_smoke.py``, whose chaos phase injects on the card, and the bench
rule has no port bench to hold yet, so :func:`run` does not call it and
never reads the JAX package's ``bench.py`` or its CI workflow;
:func:`check_bench_ci` keeps JAX's signature for its fixtures.

Each rule here pins two artifacts that must agree but live in different
files — the kind of agreement someone checks once at introduction and
nobody re-checks as both sides evolve:

- **GL-DRIFT-SHED** — ``NEVER_SHED_HOOKS`` and ``ADMISSION_SHEDDABLE_HOOKS``
  (core.api) must stay disjoint and inside ``KNOWN_HOOKS``: a hook in both
  sets would let the admission controller shed verdict-bearing work — the
  fail-open the handler-granular admission design exists to prevent.
- **GL-DRIFT-FAULTSITE** — every ``FaultSpec`` site pattern used in tests
  must match at least one fault site the package actually registers
  (``maybe_fail``/``write_with_faults`` literals). A typo'd site makes a
  chaos test pass by injecting *nothing* — the most dangerous kind of
  green. Sites a test file itself drives (``plan.decide("x")`` unit tests
  of the fault machinery) count as that file's own registrations.
- **GL-DRIFT-CONFIG** — config keys read at runtime in the modules listed
  in :data:`CONFIG_SITES` must exist in that module's DEFAULTS dict: a
  key read but not defaulted is either a typo (reads None forever) or an
  undocumented knob.
- **GL-DRIFT-BENCH** — every metric name and ``bench_*`` function the CI
  parse smokes grep for must exist in ``bench.py``: a renamed metric
  otherwise turns the smoke into an always-failing (or worse, with
  ``|| true`` somewhere, always-passing) step.
"""

from __future__ import annotations

import ast
import re
from fnmatch import fnmatchcase
from pathlib import Path

from .findings import Finding

_SITE_RE = re.compile(r"^[a-z][a-z0-9_]*(\.[a-z0-9_*]+)+$")

# Keys conventional across every plugin config, never in per-module DEFAULTS.
_ALWAYS_OK_KEYS = frozenset({"enabled", "configPath", "config_path"})

# module → (defaults dict names, receiver names whose .get("k")/["k"] reads
# are checked ("self.config" style attributes spelled as written), and the
# functions to scan — None means the whole module, a tuple restricts the
# check to functions where the receiver names actually bind config (the
# journal's ``s`` is settings in __init__ but a stream-stats row in
# ``stats``).
CONFIG_SITES: tuple = (
    ("vainplex_openclaw_tpu_torch/storage/journal.py",
     ("DEFAULT_JOURNAL_SETTINGS",), ("s", "settings", "raw"),
     ("journal_settings", "__init__", "get_journal")),
    ("vainplex_openclaw_tpu_torch/resilience/admission.py",
     ("ADMISSION_DEFAULTS",), ("cfg", "merged"),
     ("from_config", "__init__")),
    ("vainplex_openclaw_tpu_torch/knowledge/fact_store.py",
     ("DEFAULT_STORE_CONFIG",), ("config", "self.config"),
     None),
    ("vainplex_openclaw_tpu_torch/cluster/supervisor.py",
     ("CLUSTER_DEFAULTS",), ("cfg", "self.cfg"),
     None),
    ("vainplex_openclaw_tpu_torch/storage/lifecycle.py",
     ("LIFECYCLE_DEFAULTS",), ("s", "raw", "self.settings"),
     ("lifecycle_settings", "__init__")),
    ("vainplex_openclaw_tpu_torch/models/serve.py",
     ("SERVE_DEFAULTS",), ("scfg", "serve_cfg"),
     ("make_local_call_llm", "shared_batcher", "_mesh_key",
      "_resolve_mesh", "_registry_key")),
    ("vainplex_openclaw_tpu_torch/models/registry.py",
     ("REGISTRY_DEFAULTS",), ("raw", "out", "s"),
     ("registry_settings", "__init__")),
    ("vainplex_openclaw_tpu_torch/parallel/plan_search.py",
     ("PLAN_SEARCH_DEFAULTS",), ("scfg",),
     ("search", "_measure_validator", "_measure_embeddings")),
    ("vainplex_openclaw_tpu_torch/cluster/fleet.py",
     ("FLEET_DEFAULTS",), ("cfg", "self.cfg"),
     None),
    ("vainplex_openclaw_tpu_torch/slo/adversarial.py",
     ("ADVERSARIAL_DEFAULTS",), ("cfg",),
     None),
)


# ── GL-DRIFT-SHED ────────────────────────────────────────────────────


def check_shed_sets() -> list:
    from ..core import api
    findings = []
    both = api.NEVER_SHED_HOOKS & api.ADMISSION_SHEDDABLE_HOOKS
    path = "vainplex_openclaw_tpu_torch/core/api.py"
    for hook in sorted(both):
        findings.append(Finding(
            "GL-DRIFT-SHED", path, 1,
            f"hook {hook!r} is both NEVER_SHED and ADMISSION_SHEDDABLE — "
            f"the admission controller would shed verdict work",
            detail=f"overlap:{hook}"))
    known = set(api.KNOWN_HOOKS)
    for name, hooks in (("NEVER_SHED_HOOKS", api.NEVER_SHED_HOOKS),
                        ("ADMISSION_SHEDDABLE_HOOKS",
                         api.ADMISSION_SHEDDABLE_HOOKS)):
        for hook in sorted(set(hooks) - known):
            findings.append(Finding(
                "GL-DRIFT-SHED", path, 1,
                f"{name} lists unknown hook {hook!r} (not in KNOWN_HOOKS) — "
                f"it can never fire, so the entry is dead or a typo",
                detail=f"unknown:{name}:{hook}"))
    return findings


# ── GL-DRIFT-FAULTSITE ───────────────────────────────────────────────


def _call_name(func) -> str:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return ""


def _str_arg0(node: ast.Call) -> str:
    if node.args and isinstance(node.args[0], ast.Constant) \
            and isinstance(node.args[0].value, str):
        return node.args[0].value
    return ""


def registered_fault_sites(root: str | Path,
                           package: str = "vainplex_openclaw_tpu_torch") -> set:
    """Site literals the package registers. Literal args to the fault hooks
    are exact; a module calling a hook with a VARIABLE site (the transport
    threads one through ``_append_text``) contributes every site-shaped
    string literal it contains — conservative in the direction that keeps
    a typo'd test site unmatched."""
    root = Path(root)
    sites: set = {"clock"}  # wrap_clock's default site
    for path in sorted((root / package).rglob("*.py")):
        try:
            tree = ast.parse(path.read_text(encoding="utf-8"))
        except SyntaxError:
            continue
        dynamic = False
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) \
                    and _call_name(node.func) in ("maybe_fail",
                                                  "write_with_faults"):
                lit = _str_arg0(node)
                if lit:
                    sites.add(lit)
                elif node.args:
                    dynamic = True
        if dynamic:
            for node in ast.walk(tree):
                if isinstance(node, ast.Constant) \
                        and isinstance(node.value, str) \
                        and len(node.value) < 40 \
                        and _SITE_RE.match(node.value):
                    sites.add(node.value)
    return sites


# The port's tests, and the root files whose fault plans run on the card.
_TESTS_GLOB = "test_torch_*.py"
_ROOT_FILES = ("chip_smoke.py",)


def check_fault_sites(root: str | Path, tests_dir: str = "tests") -> list:
    """GL-DRIFT-FAULTSITE over the port's tests and ``chip_smoke.py``."""
    root = Path(root)
    registered = registered_fault_sites(root)
    findings = []
    scan = sorted((root / tests_dir).glob(_TESTS_GLOB))
    scan += [root / name for name in _ROOT_FILES if (root / name).exists()]
    for path in scan:
        rel = path.relative_to(root).as_posix()
        try:
            tree = ast.parse(path.read_text(encoding="utf-8"))
        except SyntaxError:
            continue
        spec_sites: list = []   # (site, lineno)
        local: set = set()      # sites this file drives directly
        dynamic = False         # file drives sites through variables
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            name = _call_name(node.func)
            if name == "FaultSpec":
                lit = _str_arg0(node)
                if not lit:
                    for kw in node.keywords:
                        if kw.arg == "site" and isinstance(kw.value, ast.Constant) \
                                and isinstance(kw.value.value, str):
                            lit = kw.value.value
                if lit:
                    spec_sites.append((lit, node.lineno))
            elif name in ("maybe_fail", "write_with_faults", "decide",
                          "calls", "wrap_clock"):
                lit = _str_arg0(node)
                if lit:
                    local.add(lit)
                elif node.args:
                    dynamic = True
        known = registered | local
        for pattern, lineno in spec_sites:
            if any(fnmatchcase(site, pattern) for site in known):
                continue
            if dynamic and not _SITE_RE.match(pattern.replace("*", "x")):
                # The file drives sites through variables and this is a
                # synthetic token (no dotted-site shape) — a unit test of
                # the fault machinery itself, not a mis-typed real site.
                continue
            findings.append(Finding(
                "GL-DRIFT-FAULTSITE", rel, lineno,
                f"FaultSpec site {pattern!r} matches no registered fault "
                f"site — this spec injects nothing",
                detail=f"{rel}:{pattern}"))
    return findings


# ── GL-DRIFT-CONFIG ──────────────────────────────────────────────────


def check_config_keys(root: str | Path) -> list:
    root = Path(root)
    findings = []
    for module, defaults_names, receivers, functions in CONFIG_SITES:
        path = root / module
        if not path.exists():
            findings.append(Finding(
                "GL-DRIFT-CONFIG", module, 1,
                f"CONFIG_SITES lists missing module {module}",
                detail=f"missing:{module}"))
            continue
        tree = ast.parse(path.read_text(encoding="utf-8"))
        keys: set = set(_ALWAYS_OK_KEYS)
        for node in tree.body:
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict):
                names = [t.id for t in node.targets if isinstance(t, ast.Name)]
                if any(n in defaults_names for n in names):
                    for k in node.value.keys:
                        if isinstance(k, ast.Constant) and isinstance(k.value, str):
                            keys.add(k.value)

        def _receiver(expr) -> str:
            if isinstance(expr, ast.Name):
                return expr.id
            if (isinstance(expr, ast.Attribute)
                    and isinstance(expr.value, ast.Name)
                    and expr.value.id == "self"):
                return f"self.{expr.attr}"
            return ""

        scan_roots = []
        if functions is None:
            scan_roots.append(tree)
        else:
            for node in ast.walk(tree):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and node.name in functions:
                    scan_roots.append(node)
        for scan_root in scan_roots:
            findings.extend(_scan_config_reads(
                scan_root, module, defaults_names, receivers, keys, _receiver))
    return findings


def _scan_config_reads(scan_root, module, defaults_names, receivers, keys,
                       _receiver) -> list:
    findings = []
    for node in ast.walk(scan_root):
        key = None
        line = 0
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "get"
                and _receiver(node.func.value) in receivers):
            key, line = _str_arg0(node), node.lineno
        elif (isinstance(node, ast.Subscript)
                and _receiver(node.value) in receivers
                and isinstance(node.slice, ast.Constant)
                and isinstance(node.slice.value, str)):
            key, line = node.slice.value, node.lineno
        if key and key not in keys:
            findings.append(Finding(
                "GL-DRIFT-CONFIG", module, line,
                f"config key {key!r} read at runtime but absent from "
                f"{'/'.join(defaults_names)} — typo or undocumented knob",
                detail=f"{module}:{key}"))
    return findings


# ── GL-DRIFT-BENCH ───────────────────────────────────────────────────

_CI_METRIC_RE = re.compile(r'\["metric"\]\s*==\s*"(\w+)"')
_CI_BENCH_FN_RE = re.compile(r"bench\.(\w+)\(")
# raw-YAML form: block lines and the terminator carry the run: | indent
_HEREDOC_RE = re.compile(r"python +- +<<'?EOF'?\n(.*?)\n[ \t]*EOF[ \t]*\n",
                         re.S)


def _ci_asserted_record_keys(ci_text: str) -> list:
    """(key, block_index) pairs for every ``rec["field"]`` read the CI's
    embedded python performs on a value returned by a ``bench.*`` call
    (one subscript level deep: ``fo = rec["failover_recovery_ms"]`` makes
    ``fo`` a record too). These are the contract the parse smoke asserts;
    a renamed bench record field must fail the LINT, not just the smoke
    (cluster_scaling / slo_report --workers)."""
    import textwrap

    out = []
    for bi, block in enumerate(_HEREDOC_RE.findall(ci_text)):
        try:
            tree = ast.parse(textwrap.dedent(block))
        except SyntaxError:
            continue
        records: set = set()
        for _ in range(3):  # tiny fixpoint: records beget records
            for node in ast.walk(tree):
                if not isinstance(node, ast.Assign):
                    continue
                val = node.value
                is_rec = (isinstance(val, ast.Call)
                          and _call_name(val.func).startswith("bench")) or (
                    isinstance(val, ast.Subscript)
                    and isinstance(val.value, ast.Name)
                    and val.value.id in records)
                if is_rec:
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            records.add(t.id)
        for node in ast.walk(tree):
            if (isinstance(node, ast.Subscript)
                    and isinstance(node.value, ast.Name)
                    and node.value.id in records
                    and isinstance(node.slice, ast.Constant)
                    and isinstance(node.slice.value, str)):
                out.append((node.slice.value, bi))
    return out


def check_bench_ci(root: str | Path, ci_path: str = ".github/workflows/ci.yml",
                   bench_path: str = "bench.py") -> list:
    root = Path(root)
    ci_file, bench_file = root / ci_path, root / bench_path
    findings = []
    if not ci_file.exists() or not bench_file.exists():
        return findings
    ci_text = ci_file.read_text(encoding="utf-8")
    metrics: set = set()
    functions: set = set()
    record_keys: set = set()
    # Metric names may be emitted by bench.py itself or by the harness
    # modules it delegates to (slo_report lives in slo/harness.py; the
    # cluster_scaling record is assembled over cluster/ machinery).
    scan = [bench_file] + sorted(
        (root / "vainplex_openclaw_tpu_torch" / "slo").glob("*.py")) + sorted(
        (root / "vainplex_openclaw_tpu_torch" / "cluster").glob("*.py")) + sorted(
        (root / "vainplex_openclaw_tpu_torch" / "utils").glob("*.py"))
    for src in scan:
        tree = ast.parse(src.read_text(encoding="utf-8"))
        for node in ast.walk(tree):
            # Record fields are dict-literal keys, ``rec["k"] = …`` stores,
            # or ``dict(k=…)`` kwargs — NOT every string constant: a renamed
            # field whose old name survives in a docstring or log message
            # must still fail the lint, not hide behind the prose.
            if isinstance(node, ast.Dict):
                for k in node.keys:
                    if isinstance(k, ast.Constant) and isinstance(k.value, str):
                        record_keys.add(k.value)
            elif isinstance(node, ast.Assign):
                for t in node.targets:
                    if (isinstance(t, ast.Subscript)
                            and isinstance(t.slice, ast.Constant)
                            and isinstance(t.slice.value, str)):
                        record_keys.add(t.slice.value)
            elif isinstance(node, ast.Call) and _call_name(node.func) == "dict":
                for kw in node.keywords:
                    if kw.arg:
                        record_keys.add(kw.arg)
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if src == bench_file:
                    functions.add(node.name)
            elif isinstance(node, ast.Dict):
                for k, v in zip(node.keys, node.values):
                    if (isinstance(k, ast.Constant) and k.value == "metric"
                            and isinstance(v, ast.Constant)
                            and isinstance(v.value, str)):
                        metrics.add(v.value)
            elif isinstance(node, ast.Call):
                # helper-built records: _bench_policy_eval("metric_name", …)
                name = _call_name(node.func)
                if name.startswith(("bench_", "_bench")):
                    lit = _str_arg0(node)
                    if lit:
                        metrics.add(lit)
            elif (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Constant)
                    and isinstance(node.value.value, str)):
                for t in node.targets:
                    if (isinstance(t, ast.Subscript)
                            and isinstance(t.slice, ast.Constant)
                            and t.slice.value == "metric"):
                        metrics.add(node.value.value)
    for m in sorted(set(_CI_METRIC_RE.findall(ci_text)) - metrics):
        findings.append(Finding(
            "GL-DRIFT-BENCH", ci_path, 1,
            f"CI parse smoke asserts metric {m!r} but bench.py never emits "
            f"it — the smoke can only fail (or silently skip)",
            detail=f"metric:{m}"))
    for fn in sorted(set(_CI_BENCH_FN_RE.findall(ci_text)) - functions):
        findings.append(Finding(
            "GL-DRIFT-BENCH", ci_path, 1,
            f"CI calls bench.{fn}() which bench.py does not define",
            detail=f"fn:{fn}"))
    missing = {k for k, _ in _ci_asserted_record_keys(ci_text)
               if k not in record_keys}
    for key in sorted(missing):
        findings.append(Finding(
            "GL-DRIFT-BENCH", ci_path, 1,
            f"CI parse smoke reads record field {key!r} but no bench/"
            f"harness source ever emits that key — the smoke can only "
            f"KeyError (or silently skip)",
            detail=f"key:{key}"))
    return findings


def run(root: str | Path) -> tuple[list, int]:
    """The port has no bench module yet, so GL-DRIFT-BENCH is not run
    here: JAX's bench.py and CI are not the port's to hold."""
    findings = []
    findings += check_shed_sets()
    findings += check_fault_sites(root)
    findings += check_config_keys(root)
    return findings, 4  # four contract surfaces scanned
