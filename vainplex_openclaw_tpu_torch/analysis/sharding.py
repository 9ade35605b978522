"""Mesh/partition-spec contract lints (GL-SHARD-*).

A copy of ``vainplex_openclaw_tpu/analysis/sharding.py`` over the port's
``parallel/``. JAX's constructs are still read as JAX reads them; the
port's own spellings are read beside them:

- a partition spec is a tuple of axis names and ``None``
  (``parallel/plan.py``), so **SHARD-AXIS** checks the axis names in the
  spec tuples of the port's rule tables and in ``ShardingPlan(data_spec=,
  axes=)``, and the axis universe adds the port's mesh constructors
  (``make_mesh(axes=)``, ``cached_mesh``, ``Mesh(devices, shape, axes)``)
  over the port's tree, its tests (``tests/test_torch_*.py``) and
  ``chip_smoke.py``;
- **SHARD-RULE** reads ``((pattern, spec), …)`` tables as tuples or lists
  (``parallel/plan.py``'s rule tables, ``models/moe.py``'s rules), and the
  port's ``parallel/plan_table.json``; :func:`validate_rule_table` is the
  one the port's plans arm at every placement;
- **SHARD-DONATE** has no torch construct to read: torch has no
  ``donate_argnums``, so on the port's tree the rule can only report
  nothing; its fixture check stays, with JAX's verdicts.

JAX's text follows.

Sharding bugs fail late and silently: an axis-name typo in a
``PartitionSpec`` raises only when the spec finally meets a mesh (or, in
``in_specs`` of an un-exercised code path, never); a donated buffer read
after the call returns garbage only on real hardware (CPU aliasing hides
it); a partition rule that matches zero params silently replicates what
it was supposed to shard. Three rules:

- **GL-SHARD-AXIS** — every axis-name string literal inside a
  ``P(...)``/``PartitionSpec(...)`` call, and every ``*_axis`` parameter
  default, must be an axis some mesh constructor in the repo actually
  declares (``make_mesh(axes=…)`` / ``Mesh(devices, (...))`` literals —
  the same register-then-check shape as GL-DRIFT-FAULTSITE).
- **GL-SHARD-DONATE** — a ``donate_argnums`` argument must not be read
  again after the call before being rebound, and must not be passed
  twice in one call (aliased donation).
- **GL-SHARD-RULE** — partition-rule tables (``[(pattern, P(...)), …]``,
  first match wins — the match_partition_rules shape) must have no duplicate patterns, no rule shadowed by an
  earlier substring/regex superset (dead rule), and no unparseable
  regex. The runtime side is :func:`validate_rule_table`: given the
  actual param paths, every rule must WIN on at least one path.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path

from .findings import Finding
from .retrace import _leaf
from .tracing import _dotted

_PKG = "vainplex_openclaw_tpu_torch"
_SPEC_NAMES = frozenset({"P", "PartitionSpec"})
_REGEXY = re.compile(r"[\\^$*+?\[\]()|{}]")


def _spec_tuple(node) -> bool:
    """A port partition spec: a tuple literal of axis names, None, and
    axis variables (``(ep_axis, None, None)``)."""
    return isinstance(node, ast.Tuple) and all(
        isinstance(e, ast.Name) or (isinstance(e, ast.Constant) and (
            e.value is None or isinstance(e.value, str)))
        for e in node.elts)


def _port_rule_nodes(tree: ast.Module) -> set:
    """ids of the port's rule-table literals: values bound to a name
    containing ``rules`` (``ENCODER_VALIDATOR_RULES = (…)``) or returned
    by a function whose name does (``moe_sharding_rules``). The naming
    keeps other tables of string pairs (gate prefixes, search sites) out."""
    out: set = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            if node.value is not None and any(
                    isinstance(t, ast.Name) and "rules" in t.id.lower()
                    for t in targets):
                out.add(id(node.value))
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and "rules" in node.name.lower():
            out.update(id(r.value) for r in ast.walk(node)
                       if isinstance(r, ast.Return) and r.value is not None)
    return out


def _str_elements(node):
    """String constants directly in an expression (handles tuples/lists)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        yield node.value
    elif isinstance(node, (ast.Tuple, ast.List)):
        for e in node.elts:
            yield from _str_elements(e)


# ── axis universe ────────────────────────────────────────────────────


def registered_axes(root: str | Path, trees: dict = None) -> set:
    """Axis names any mesh constructor in the repo declares. Conservative
    in the direction that keeps a typo'd SPEC unmatched: only literal
    tuples register axes; meshes built from variables register nothing.
    ``trees`` (path → parsed ast) lets :func:`run` share one parse per
    file across the passes."""
    root = Path(root)
    axes: set = {"dp", "tp", "sp"}  # make_mesh's signature default
    scan = [p for p in (root / _PKG).rglob("*.py")]
    scan += sorted((root / "tests").glob("test_torch_*.py"))
    if (root / "chip_smoke.py").exists():
        scan.append(root / "chip_smoke.py")
    for path in scan:
        tree = (trees or {}).get(path)
        if tree is None:
            try:
                tree = ast.parse(path.read_text(encoding="utf-8"))
            except SyntaxError:
                continue
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            leaf = _leaf(_dotted(node.func))
            if leaf == "make_mesh":
                for kw in node.keywords:
                    if kw.arg == "axes":
                        axes.update(_str_elements(kw.value))
                if len(node.args) >= 2:
                    axes.update(_str_elements(node.args[1]))
            elif leaf == "Mesh" and len(node.args) >= 2:
                axes.update(_str_elements(node.args[1]))
                # the port's Mesh(devices, shape, axis_names)
                if len(node.args) >= 3:
                    axes.update(_str_elements(node.args[2]))
            if leaf in ("Mesh", "cached_mesh"):
                for kw in node.keywords:
                    if kw.arg in ("axes", "axis_names"):
                        axes.update(_str_elements(kw.value))
                if leaf == "cached_mesh" and len(node.args) >= 2:
                    axes.update(_str_elements(node.args[1]))
    return axes


def check_axis_source(src: str, path: str, axes: set, tree=None) -> list:
    """GL-SHARD-AXIS findings for one module against an axis universe."""
    tree = ast.parse(src) if tree is None else tree
    findings = []
    # the port's spec tuples: in rule tables, and a plan's data_spec/axes
    port_specs = [(spec, spec.lineno) for _line, pairs
                  in _rule_table_pairs(tree)
                  for _pat, spec in pairs if _spec_tuple(spec)]
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) \
                and _leaf(_dotted(node.func)) == "ShardingPlan":
            port_specs += [(kw.value, node.lineno) for kw in node.keywords
                           if kw.arg in ("data_spec", "axes")
                           and _spec_tuple(kw.value)]
    for spec, lineno in port_specs:
        for name in _str_elements(spec):
            if name not in axes:
                findings.append(Finding(
                    "GL-SHARD-AXIS", path, lineno,
                    f"partition spec names axis {name!r} which no mesh in "
                    f"the repo declares — typo, or an undeclared mesh axis",
                    detail=f"axis:{name}:{lineno}"))
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) \
                and _leaf(_dotted(node.func)) in _SPEC_NAMES:
            for arg in node.args:
                for name in _str_elements(arg):
                    if name not in axes:
                        findings.append(Finding(
                            "GL-SHARD-AXIS", path, node.lineno,
                            f"PartitionSpec names axis {name!r} which no "
                            f"mesh in the repo declares — typo, or an "
                            f"undeclared mesh axis",
                            detail=f"axis:{name}:{node.lineno}"))
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            args = node.args
            # align trailing defaults with trailing named args
            pos_with_default = list(zip(args.args[-len(args.defaults):]
                                        if args.defaults else [],
                                        args.defaults))
            kw_with_default = [(a, d) for a, d in
                               zip(args.kwonlyargs, args.kw_defaults)
                               if d is not None]
            for a, d in pos_with_default + kw_with_default:
                if a.arg.endswith("_axis") and isinstance(d, ast.Constant) \
                        and isinstance(d.value, str) and d.value not in axes:
                    findings.append(Finding(
                        "GL-SHARD-AXIS", path, node.lineno,
                        f"{node.name}() defaults {a.arg}={d.value!r} but "
                        f"no mesh in the repo declares that axis",
                        detail=f"default:{node.name}:{a.arg}:{d.value}"))
    return findings


# ── donation discipline ──────────────────────────────────────────────


def _donating_functions(tree: ast.Module) -> dict:
    """function name → donated positional indices, from jit decorators."""
    out: dict = {}
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for dec in node.decorator_list:
            if not isinstance(dec, ast.Call):
                continue
            is_jit = _leaf(_dotted(dec.func)) in ("jit", "pjit") or (
                _leaf(_dotted(dec.func)) == "partial"
                and any(_leaf(_dotted(a)) in ("jit", "pjit")
                        for a in dec.args))
            if not is_jit:
                continue
            for kw in dec.keywords:
                if kw.arg == "donate_argnums":
                    idxs = []
                    val = kw.value
                    vals = val.elts if isinstance(val, (ast.Tuple, ast.List)) \
                        else [val]
                    for v in vals:
                        if isinstance(v, ast.Constant) \
                                and isinstance(v.value, int):
                            idxs.append(v.value)
                    if idxs:
                        out[node.name] = tuple(idxs)
    return out


def check_donation_source(src: str, path: str,
                          donors: dict | None = None, tree=None) -> list:
    """GL-SHARD-DONATE findings for one module. ``donors`` maps function
    name → donated positions; defaults to the module's own jit
    decorators (cross-module donors are passed in by :func:`run`)."""
    tree = ast.parse(src) if tree is None else tree
    table = dict(_donating_functions(tree))
    if donors:
        table.update(donors)
    if not table:
        return []
    findings = []
    for fn in [n for n in ast.walk(tree)
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]:
        # name → [(lineno, col, is_store)] events, in source order
        events: dict = {}
        for node in ast.walk(fn):
            if isinstance(node, ast.Name):
                events.setdefault(node.id, []).append(
                    (node.lineno, node.col_offset,
                     isinstance(node.ctx, (ast.Store, ast.Del))))
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            donated = table.get(_leaf(_dotted(node.func)))
            if not donated:
                continue
            names = [a.id if isinstance(a, ast.Name) else None
                     for a in node.args]
            for idx in donated:
                if idx >= len(names) or names[idx] is None:
                    continue
                name = names[idx]
                if names.count(name) > 1:
                    findings.append(Finding(
                        "GL-SHARD-DONATE", path, node.lineno,
                        f"{name!r} passed twice to "
                        f"{_leaf(_dotted(node.func))}() with argument "
                        f"{idx} donated — aliased donation",
                        detail=f"alias:{name}:{node.lineno}"))
                # first event strictly after the call line: a Load before
                # any rebind means reading a donated (deleted) buffer.
                # Stores on the call line itself (`x, y = f(x, …)`) bind
                # after the call returns and count as the rebind.
                later = sorted(e for e in events.get(name, [])
                               if e[0] > node.lineno
                               or (e[0] == node.lineno and e[2]))
                if later and not later[0][2]:
                    findings.append(Finding(
                        "GL-SHARD-DONATE", path, node.lineno,
                        f"{name!r} is donated to "
                        f"{_leaf(_dotted(node.func))}() at line "
                        f"{node.lineno} but read again at line "
                        f"{later[0][0]} before being rebound — donated "
                        f"buffers are deleted on dispatch",
                        detail=f"read-after-donate:{name}:{node.lineno}"))
    return findings


# ── partition-rule tables ────────────────────────────────────────────


def _rule_table_pairs(tree: ast.Module):
    """Yield (lineno, [(pattern, spec_node), ...]) for every
    ``[(str, P(...)), …]`` list (JAX's form) and every rule-named list or
    tuple of ``(str, spec tuple)`` pairs (the port's form)."""
    port_nodes = _port_rule_nodes(tree)
    for node in ast.walk(tree):
        if not isinstance(node, (ast.List, ast.Tuple)) or not node.elts:
            continue
        port = id(node) in port_nodes
        pairs = []
        for e in node.elts:
            if (isinstance(e, ast.Tuple) and len(e.elts) == 2
                    and isinstance(e.elts[0], ast.Constant)
                    and isinstance(e.elts[0].value, str)
                    and ((isinstance(node, ast.List)
                          and isinstance(e.elts[1], ast.Call)
                          and _leaf(_dotted(e.elts[1].func)) in _SPEC_NAMES)
                         or (port and _spec_tuple(e.elts[1])))):
                pairs.append((e.elts[0].value, e.elts[1]))
            else:
                pairs = None
                break
        if pairs:
            yield node.lineno, pairs


def _rule_tables(tree: ast.Module):
    """Yield (lineno, [pattern, ...]) for every rule table."""
    for lineno, pairs in _rule_table_pairs(tree):
        yield lineno, [pat for pat, _spec in pairs]


def _pattern_findings(patterns, path: str, lineno, where: str = "") -> list:
    """Dup/dead/bad-regex findings for one ordered pattern list — shared
    by the static-table AST pass and the checked-in plan_table.json pass
    so hand-written and searched tables are linted by ONE
    implementation. ``where`` disambiguates detail keys when several
    tables live at the same location (JSON entries have no lineno)."""
    findings = []
    at = f"{where}:" if where else ""
    ctx = f" [{where}]" if where else ""
    seen: dict = {}
    for i, pat in enumerate(patterns):
        if pat in seen:
            findings.append(Finding(
                "GL-SHARD-RULE", path, lineno,
                f"rule table{ctx} repeats pattern {pat!r} — the second "
                f"entry can never win (first match wins)",
                detail=f"dup:{at}{pat}:{lineno}"))
            continue
        seen[pat] = i
        if pat == "" and i != len(patterns) - 1:
            findings.append(Finding(
                "GL-SHARD-RULE", path, lineno,
                f"empty pattern{ctx} matches every path — all later "
                f"rules are dead",
                detail=f"empty:{at}{lineno}"))
        if _REGEXY.search(pat):
            try:
                re.compile(pat)
            except re.error as exc:
                findings.append(Finding(
                    "GL-SHARD-RULE", path, lineno,
                    f"rule pattern {pat!r}{ctx} is not a valid regex: "
                    f"{exc}",
                    detail=f"badre:{at}{pat}:{lineno}"))
        for prev in patterns[:i]:
            if prev and prev in pat:
                findings.append(Finding(
                    "GL-SHARD-RULE", path, lineno,
                    f"rule {pat!r}{ctx} is dead: earlier rule {prev!r} "
                    f"is a substring, so it wins on every path the "
                    f"later rule matches",
                    detail=f"shadow:{at}{prev}->{pat}:{lineno}"))
    return findings


def check_rule_tables_source(src: str, path: str, tree=None) -> list:
    """GL-SHARD-RULE findings for the static rule tables in one module."""
    tree = ast.parse(src) if tree is None else tree
    findings = []
    for lineno, patterns in _rule_tables(tree):
        findings.extend(_pattern_findings(patterns, path, lineno))
    return findings


# The plan.PLAN_TABLE_SCHEMA twin — spelled here so graftlint stays free
# of jax imports; tests/test_plan_search.py pins the two equal.
PLAN_TABLE_SCHEMA = "plan-table-v1"

# twins of plan.RUNNERS / plan.COLLECTIVE_KINDS —
# pinned equal in tests/test_big_model_serving.py, same discipline as the
# schema twin above. The CommSketch grammar's declared-collective rows in
# the JSON artifact are linted against these.
RUNNERS = ("forward", "pipeline", "long")
COLLECTIVE_KINDS = ("psum", "all_gather", "ppermute", "all_to_all",
                    "reduce_scatter")


def check_plan_table_file(path, rel: str) -> list:
    """GL-SHARD-RULE over the CHECKED-IN searched plan table
    (parallel/plan_table.json). The searched artifact gets the
    same pattern lint as the hand-written Python tables — dup, shadow,
    bad regex — plus the structural contract a JSON table can violate
    that a Python literal cannot: key format, a device-count key whose
    ``mesh_shape`` does not factor its N, axes whose rank disagrees with
    the key's mesh shape. The deep schema gate (``validate_plan_table``
    against real param trees) runs in tests; this pass is the cheap
    always-on half."""
    import json

    findings: list = []
    try:
        table = json.loads(Path(path).read_text(encoding="utf-8"))
    except (OSError, ValueError) as exc:
        return [Finding(
            "GL-SHARD-RULE", rel, 1,
            f"searched plan table is unreadable ({exc}) — serving falls "
            f"back to hand-written rules everywhere",
            detail="table:unreadable")]
    if not isinstance(table, dict) \
            or table.get("schema") != PLAN_TABLE_SCHEMA:
        return [Finding(
            "GL-SHARD-RULE", rel, 1,
            f"searched plan table has schema "
            f"{table.get('schema') if isinstance(table, dict) else None!r}"
            f" (want {PLAN_TABLE_SCHEMA!r}) — the loader will ignore it",
            detail="table:schema")]
    entries = table.get("entries")
    if not isinstance(entries, dict):
        return [Finding(
            "GL-SHARD-RULE", rel, 1,
            "searched plan table has no entries object",
            detail="table:entries")]
    for key, ent in sorted(entries.items()):
        parts = key.split(":")
        if len(parts) != 3:
            findings.append(Finding(
                "GL-SHARD-RULE", rel, 1,
                f"plan-table key {key!r} is not "
                f"device_family:shape:family",
                detail=f"table:key:{key}"))
            continue
        if not isinstance(ent, dict):
            findings.append(Finding(
                "GL-SHARD-RULE", rel, 1,
                f"plan-table entry {key!r} is not an object",
                detail=f"table:ent:{key}"))
            continue
        shape_s = parts[1]
        if shape_s[:1] == "n" and shape_s[1:].isdigit():
            ms = ent.get("mesh_shape")
            prod = 1
            for x in (ms if isinstance(ms, list) else [0]):
                prod *= x if isinstance(x, int) else 0
            if prod != int(shape_s[1:]):
                findings.append(Finding(
                    "GL-SHARD-RULE", rel, 1,
                    f"plan-table entry {key!r}: mesh_shape {ms!r} does "
                    f"not factor {shape_s[1:]} devices — stale "
                    f"factorization",
                    detail=f"table:factor:{key}"))
            continue
        rules = ent.get("rules")
        patterns = [r[0] for r in (rules if isinstance(rules, list)
                                   else [])
                    if isinstance(r, list) and len(r) == 2
                    and isinstance(r[0], str)]
        if patterns:
            findings.extend(_pattern_findings(patterns, rel, 1,
                                              where=key))
        # Big-model family fields: an unknown runner would
        # make the loader fall back loudly at serve time — catch the
        # typo here; collectives rows are the CommSketch grammar's
        # serialized signature and must use declared kinds.
        runner = ent.get("runner", "forward")
        if runner not in RUNNERS:
            findings.append(Finding(
                "GL-SHARD-RULE", rel, 1,
                f"plan-table entry {key!r}: unknown runner {runner!r} "
                f"(known: {RUNNERS})",
                detail=f"table:runner:{key}"))
        for coll in (ent.get("collectives") or []):
            kind = coll[0] if isinstance(coll, list) and coll else None
            if kind not in COLLECTIVE_KINDS:
                findings.append(Finding(
                    "GL-SHARD-RULE", rel, 1,
                    f"plan-table entry {key!r}: collective row {coll!r} "
                    f"does not name a known collective kind "
                    f"(known: {COLLECTIVE_KINDS})",
                    detail=f"table:coll:{key}"))
        try:
            rank = len(shape_s.split("x"))
            axes = ent.get("axes")
            if isinstance(axes, list) and axes and len(axes) != rank:
                findings.append(Finding(
                    "GL-SHARD-RULE", rel, 1,
                    f"plan-table entry {key!r}: {len(axes)} axes vs "
                    f"{rank}-d mesh shape {shape_s}",
                    detail=f"table:rank:{key}"))
        except ValueError:
            pass
    return findings


def validate_rule_table(rules, paths, regex: bool = False) -> list:
    """Runtime contract for a partition-rule table against REAL param
    paths (the ``match_partition_rules`` precondition): every rule
    must WIN (be the first match) on at least one path. Returns human-
    readable problem strings; empty means the table is live end to end.
    ``regex=True`` matches with ``re.search``,
    else substring (parallel/mesh.shard_params semantics)."""
    problems = []
    hit = [False] * len(rules)

    def matches(pat, path):
        return bool(re.search(pat, path)) if regex else pat in path

    for path in paths:
        for i, (pat, _spec) in enumerate(rules):
            if matches(pat, path):
                hit[i] = True
                break
    for i, ((pat, _spec), won) in enumerate(zip(rules, hit)):
        if not won:
            if any(matches(pat, p) for p in paths):
                problems.append(
                    f"rule {i} ({pat!r}) matches paths but never wins — "
                    f"shadowed by an earlier rule on every match")
            else:
                problems.append(
                    f"rule {i} ({pat!r}) matches zero param paths — dead "
                    f"rule (typo, or params renamed)")
    return problems


# ── entry point ──────────────────────────────────────────────────────


def run(root) -> tuple[list, int]:
    root = Path(root)
    findings: list = []
    scan = sorted((root / _PKG).rglob("*.py"))
    # one read + parse per file, shared across every check below
    trees: dict = {}
    for path in scan:
        try:
            trees[path] = ast.parse(path.read_text(encoding="utf-8"))
        except SyntaxError:
            continue
    axes = registered_axes(root, trees)
    # donors visible across modules (train_step is called package-wide)
    donors: dict = {}
    for tree in trees.values():
        donors.update(_donating_functions(tree))
    for path, tree in trees.items():
        rel = path.relative_to(root).as_posix()
        findings.extend(check_axis_source("", rel, axes, tree=tree))
        findings.extend(check_donation_source("", rel, donors, tree=tree))
        findings.extend(check_rule_tables_source("", rel, tree=tree))
    # the searched-placement artifact rides the same gate
    table_path = root / _PKG / "parallel" / "plan_table.json"
    if table_path.exists():
        findings.extend(check_plan_table_file(
            table_path, table_path.relative_to(root).as_posix()))
    return findings, len(trees)
