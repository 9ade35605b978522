"""Static-analysis gates over the port's own tree: graftlint + tracelint +
protolint, with their runtime witnesses.

A counterpart of ``vainplex_openclaw_tpu/analysis/`` under the same module
names, rule ids and summary lines, scanning ``vainplex_openclaw_tpu_torch/``
(and the port's tests and ``chip_smoke.py`` where a rule reads call sites)
and importing nothing of the JAX package. One runner, one shared baseline,
one exit code; three gates, each with its own greppable summary line:

- **graftlint** — concurrency + pattern-safety + contract drift:
  :mod:`.locks` (GL-LOCK-GUARD/-BLOCKING over the guarded-state table),
  :mod:`.lock_order` (GL-LOCK-ORDER, paired with the runtime
  :class:`~.witness.LockOrderWitness` the cluster storms arm, on the card
  too), :mod:`.redos` (GL-REDOS over the shipped packs/policies),
  :mod:`.drift` (GL-DRIFT-*).
- **tracelint** — per-call discipline off the declarative
  :mod:`.jit_table`: :mod:`.tracing` (GL-TRACE-*: host syncs, branches on
  tensor values, unseeded draws), :mod:`.retrace` (GL-RETRACE-*: shape
  bucketing and kernel builds reached per call, paired with the
  :class:`~.witness.RetraceWitness`), :mod:`.sharding` (GL-SHARD-*).
- **protolint** — distributed-protocol invariants off the declarative
  :mod:`.proto_table`: :mod:`.proto` (GL-PROTO-EPOCH/-FENCE/-ORDER/-ACK
  AST lints over cluster/ + storage/), and :mod:`.explore` — the
  exhaustive interleaving explorer (GL-PROTO-SCHED) through the port's
  real supervisor/worker/lease/journal stack; paired with the
  :class:`~.witness.ProtocolWitness` the cluster storms arm.

The gates are host work only (AST scans, and the explorer over stub
gateways that run no model), so no function here takes a ``device``: this
is not an entry point that silently runs on the CPU.

Run as ``python -m vainplex_openclaw_tpu_torch.analysis`` (exit 1 on any
non-baselined finding, 2 on crash). ``--only <rule-prefix>[,...]`` runs a
subset of rule families (``--only GL-PROTO-SCHED`` is the explorer alone).
Suppressions live in ``analysis/baseline.json`` — one entry per finding
key, each with a rationale.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

from . import (drift, explore, lock_order, locks, proto, redos, retrace,
               sharding, tracing)
from .findings import (GATES, Finding, LintReport, apply_baseline, gate_of,
                       load_baseline)
from .jit_table import JIT_TABLE, JitEntry
from .proto_table import EXPLORER_CONFIGS, PROTO_MODULES
from .witness import (LockOrderWitness, ProtocolWitness, RetraceWitness,
                      launch_counters)

__all__ = [
    "Finding", "LintReport", "LockOrderWitness", "ProtocolWitness",
    "RetraceWitness", "JIT_TABLE", "JitEntry", "GATES", "gate_of",
    "EXPLORER_CONFIGS", "PROTO_MODULES", "run_analysis",
    "collect_findings", "default_pack_findings", "load_baseline",
    "launch_counters",
]

_PKG = "vainplex_openclaw_tpu_torch"


def default_pack_findings() -> list:
    """GL-REDOS findings over the patterns the port SHIPS: every cortex
    language pack + base moods, and every regex the builtin governance
    policies carry. This is the gate that keeps the default packs clean
    — operator/user patterns are screened at their own compile time by the
    planner/bank wiring instead."""
    findings: list = []
    from ..cortex.patterns import BASE_MOODS, PACKS
    for pack in PACKS.values():
        for attr in ("decision", "close", "wait", "topic"):
            for pattern in getattr(pack, attr):
                unsafe = redos.unsafe_report(pattern, pack.flags)
                if unsafe:
                    findings.append(Finding(
                        "GL-REDOS", f"{_PKG}/cortex/patterns.py",
                        1, f"builtin {pack.code}.{attr} pattern {pattern!r}: "
                           f"{unsafe}",
                        detail=f"pack:{pack.code}:{attr}:{pattern}"))
        for mood, pattern in pack.moods.items():
            unsafe = redos.unsafe_report(pattern, pack.flags)
            if unsafe:
                findings.append(Finding(
                    "GL-REDOS", f"{_PKG}/cortex/patterns.py", 1,
                    f"builtin {pack.code} mood {mood!r} pattern {pattern!r}: "
                    f"{unsafe}",
                    detail=f"pack:{pack.code}:mood:{mood}:{pattern}"))
    for mood, pattern in BASE_MOODS.items():
        unsafe = redos.unsafe_report(pattern)
        if unsafe:
            findings.append(Finding(
                "GL-REDOS", f"{_PKG}/cortex/patterns.py", 1,
                f"base mood {mood!r} pattern {pattern!r}: {unsafe}",
                detail=f"base-mood:{mood}:{pattern}"))

    from ..governance.policy_plan import iter_policy_patterns
    for policy in _builtin_policies():
        for pattern in iter_policy_patterns(policy):
            unsafe = redos.unsafe_report(pattern)
            if unsafe:
                findings.append(Finding(
                    "GL-REDOS", f"{_PKG}/governance/builtin_policies.py", 1,
                    f"builtin policy {policy.get('id')} pattern {pattern!r}: "
                    f"{unsafe}",
                    detail=f"policy:{policy.get('id')}:{pattern}"))
    return findings


def _builtin_policies() -> list:
    """EVERY builtin policy, through the canonical enumeration
    (``get_builtin_policies``) with all features enabled. The enable-all
    config is built by introspecting the enumerator's own
    ``config.get("…")`` reads (every builder accepts a truthy non-dict and
    falls back to its defaults), so a newly added builtin is screened the
    day it lands."""
    import inspect
    import re as _re
    from ..governance.builtin_policies import get_builtin_policies
    keys = set(_re.findall(r'config\.get\("(\w+)"\)',
                           inspect.getsource(get_builtin_policies)))
    # Known builders, kept as a floor in case the enumerator's config
    # plumbing is ever refactored away from config.get literals.
    keys |= {"nightMode", "credentialGuard", "productionSafeguard",
             "rateLimiter"}
    return get_builtin_policies({k: True for k in sorted(keys)})


# Each pass with the rule families it can emit — what ``--only`` filters
# against. A pass runs when the filter could match any of its rules;
# findings are additionally filtered per rule id, so ``--only
# GL-PROTO-EPOCH`` runs the proto pass but reports only that family.
# GL-SHARD-DONATE stays listed though no torch construct can trigger it
# (torch has no donate_argnums): its fixture check still runs.
_PASS_RULES = {
    "locks": ("GL-LOCK-GUARD", "GL-LOCK-BLOCKING"),
    "lock_order": ("GL-LOCK-ORDER",),
    "drift": ("GL-DRIFT-SHED", "GL-DRIFT-FAULTSITE", "GL-DRIFT-CONFIG",
              "GL-DRIFT-BENCH"),
    "redos": ("GL-REDOS",),
    "tracing": ("GL-TRACE-HOSTSYNC", "GL-TRACE-CONTROLFLOW",
                "GL-TRACE-IMPURE", "GL-TRACE-TABLE"),
    "retrace": ("GL-RETRACE-UNBUCKETED", "GL-RETRACE-DTYPE"),
    "sharding": ("GL-SHARD-AXIS", "GL-SHARD-DONATE", "GL-SHARD-RULE"),
    "proto": ("GL-PROTO-EPOCH", "GL-PROTO-FENCE", "GL-PROTO-ORDER",
              "GL-PROTO-ACK"),
    "explore": ("GL-PROTO-SCHED",),
}


def _wanted(only, rules) -> bool:
    if only is None:
        return True
    return any(r.startswith(o) or o.startswith(r)
               for o in only for r in rules)


def _matches(only, rule: str) -> bool:
    return only is None or any(rule.startswith(o) for o in only)


def _collect(root: str | Path, only=None) -> tuple:
    """(findings, scanned, proto_files, schedules). ``scanned`` stays
    pinned to the lock-order pass's full-package file count: the other
    passes traverse the package too, but reporting ONE canonical
    traversal keeps the greppable ``files=`` number stable and still
    catches a scan that stopped walking. The explorer (the one slow
    family) runs only when the filter reaches GL-PROTO-SCHED."""
    findings: list = []
    # The canonical package traversal backs the files= number on the
    # graftlint/tracelint lines; skip it entirely when the filter selects
    # neither gate (e.g. the explorer alone) — those lines don't print,
    # so parsing the whole package would buy nothing.
    fast = ("locks", "lock_order", "drift", "redos", "tracing", "retrace",
            "sharding")
    scanned = 0
    if any(_wanted(only, _PASS_RULES[p]) for p in fast):
        order_f, scanned = lock_order.run(root)
        if _wanted(only, _PASS_RULES["lock_order"]):
            findings.extend(order_f)
    if _wanted(only, _PASS_RULES["locks"]):
        findings.extend(locks.run(root)[0])
    if _wanted(only, _PASS_RULES["drift"]):
        findings.extend(drift.run(root)[0])
    if _wanted(only, _PASS_RULES["redos"]):
        findings.extend(default_pack_findings())
    if _wanted(only, _PASS_RULES["tracing"]):
        findings.extend(tracing.run(root)[0])
    if _wanted(only, _PASS_RULES["retrace"]):
        findings.extend(retrace.run(root)[0])
    if _wanted(only, _PASS_RULES["sharding"]):
        findings.extend(sharding.run(root)[0])
    proto_files = 0
    if _wanted(only, _PASS_RULES["proto"]):
        proto_f, proto_files = proto.run(root)
        findings.extend(proto_f)
    schedules = 0
    if _wanted(only, _PASS_RULES["explore"]):
        explore_f, schedules = explore.run(root)
        findings.extend(explore_f)
    if only is not None:
        findings = [f for f in findings if _matches(only, f.rule)]
    return findings, scanned, proto_files, schedules


def collect_findings(root: str | Path) -> tuple[list, int]:
    """All passes over ``root``; → (findings, files_scanned). Kept as the
    historical two-tuple surface; :func:`run_analysis` carries the
    per-gate accounting."""
    findings, scanned, _proto_files, _schedules = _collect(root)
    return findings, scanned


def run_analysis(root: str | Path,
                 baseline_path: Optional[str | Path] = None,
                 only=None) -> LintReport:
    findings, scanned, proto_files, schedules = _collect(root, only)
    gates_run = tuple(
        gate for gate, prefixes in GATES
        if only is None or any(_wanted(only, rules)
                               and gate_of(rules[0]) == gate
                               for rules in _PASS_RULES.values()))
    report = LintReport(
        files_scanned=scanned,
        gate_files={"protolint": proto_files},
        schedules=schedules,
        gates_run=gates_run)
    baseline = load_baseline(baseline_path)
    if only is not None:
        # Scope the baseline to the families that ran: entries for
        # skipped families are neither suppressions nor stale this run.
        baseline = {k: r for k, r in baseline.items()
                    if _matches(only, k.split("::", 1)[0])}
    apply_baseline(findings, baseline, report)
    return report
