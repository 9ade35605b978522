"""protolint AST passes: distributed-protocol invariants, machine-checked.

A copy of ``vainplex_openclaw_tpu/analysis/proto.py``; its table
(:mod:`.proto_table`) names the port's modules.

Four rule families over the sites :data:`.proto_table.PROTOCOL modules
<.proto_table.PROTO_MODULES>` declare — see the invariant catalog in
:mod:`.proto_table`:

- **GL-PROTO-EPOCH** — ``==``/``!=`` on an epoch-bearing comparison.
  Epochs are a staleness *order* (grants are the only mutation and they
  only increment), so identity checks are latent inversions: they flip
  meaning the first time a workspace moves twice. Declared exemptions
  (with rationale) ride the table, and an exemption matching nothing is
  reported stale.
- **GL-PROTO-FENCE** — a ``Journal`` method that writes at the wal/legacy
  boundary without a fence re-read lexically before the write and without
  a declared ``guarded`` rationale.
- **GL-PROTO-ORDER** — call-order contracts: barrier-before-regrant,
  fence-before-traffic (grant → recovery → delivery), wake-refences.
  Granularity is first-occurrence lexical order inside one function — the
  documented static approximation; the interleaving explorer
  (:mod:`.explore`) owns the dynamic truth.
- **GL-PROTO-ACK** — ack-protocol sites: seqs released only after the
  group commit; watermark stores guarded by an ordered comparison.

Scope and honesty: like the lock checker, these passes see call *names*
and lexical order, not data flow. A rename that hides a grant behind a
helper also moves it out of the declared site — which is reviewable, and
the stale-row reporting makes the drift loud. Every check has a
fixture-corpus entry point (``check_*_source``) so the CI injected-
violation smoke can prove the family still detects.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Optional

from .findings import Finding
from .proto_table import (ACK_RULES, EPOCH_RULES, FENCE_RULES, ORDER_RULES,
                          AckRule, EpochRule, FenceRule, OrderRule)


def _call_name(node: ast.Call) -> str:
    if isinstance(node.func, ast.Name):
        return node.func.id
    if isinstance(node.func, ast.Attribute):
        return node.func.attr
    return ""


def _mentions_epoch(node) -> bool:
    """True when the subtree names an epoch: an identifier containing
    'epoch' or a call to an .epoch() accessor."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and "epoch" in sub.id.lower():
            return True
        if isinstance(sub, ast.Attribute) and "epoch" in sub.attr.lower():
            return True
        if isinstance(sub, ast.Constant) and isinstance(sub.value, str) \
                and sub.value.lower() == "epoch":
            return True  # current.get("epoch", 0) — the fence-file read
    return False


class _QualnameIndex(ast.NodeVisitor):
    """{qualname: FunctionDef} with Class.method naming (one level)."""

    def __init__(self):
        self.functions: dict[str, ast.AST] = {}
        self._stack: list[str] = []

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._stack.append(node.name)
        self.generic_visit(node)
        self._stack.pop()

    def _fn(self, node) -> None:
        qual = ".".join(self._stack + [node.name])
        self.functions.setdefault(qual, node)
        self._stack.append(node.name)
        self.generic_visit(node)
        self._stack.pop()

    visit_FunctionDef = _fn
    visit_AsyncFunctionDef = _fn


def _index(tree: ast.Module) -> dict:
    idx = _QualnameIndex()
    idx.visit(tree)
    return idx.functions


# ── GL-PROTO-EPOCH ───────────────────────────────────────────────────


def check_epoch_source(source: str, path: str,
                       exempt: tuple = ()) -> list:
    tree = ast.parse(source)
    findings: list = []
    exemptions = dict(exempt)
    used: set = set()

    class _Walker(ast.NodeVisitor):
        def __init__(self):
            self.stack: list[str] = []

        def visit_ClassDef(self, node):
            self.stack.append(node.name)
            self.generic_visit(node)
            self.stack.pop()

        def _fn(self, node):
            self.stack.append(node.name)
            self.generic_visit(node)
            self.stack.pop()

        visit_FunctionDef = _fn
        visit_AsyncFunctionDef = _fn

        def visit_Compare(self, node):
            eq_ops = [op for op in node.ops
                      if isinstance(op, (ast.Eq, ast.NotEq))]
            if eq_ops and (_mentions_epoch(node.left)
                           or any(_mentions_epoch(c)
                                  for c in node.comparators)):
                qual = ".".join(self.stack[-2:]) if len(self.stack) >= 2 \
                    else (self.stack[-1] if self.stack else "<module>")
                rationale = exemptions.get(qual)
                if rationale is not None:
                    used.add(qual)
                    if not rationale.strip():
                        findings.append(Finding(
                            "GL-PROTO-EPOCH", path, node.lineno,
                            f"epoch equality exemption for {qual} has no "
                            f"rationale",
                            detail=f"no-rationale:{qual}"))
                else:
                    op = "==" if isinstance(eq_ops[0], ast.Eq) else "!="
                    findings.append(Finding(
                        "GL-PROTO-EPOCH", path, node.lineno,
                        f"{qual} compares epochs with {op!r} — staleness "
                        f"is an order, use an ordered comparison against "
                        f"the fence",
                        detail=f"{qual}:equality"))
            self.generic_visit(node)

    _Walker().visit(tree)
    for qual in sorted(set(exemptions) - used):
        findings.append(Finding(
            "GL-PROTO-EPOCH", path, 1,
            f"stale epoch exemption: {qual} has no equality comparison "
            f"left (fixed? delete the table entry)",
            detail=f"stale-exempt:{qual}"))
    return findings


# ── GL-PROTO-FENCE ───────────────────────────────────────────────────


def _write_lines(fn_node, rule: FenceRule) -> list:
    """Line numbers of wal/legacy-boundary write calls inside a method."""
    lines = []
    for node in ast.walk(fn_node):
        if not isinstance(node, ast.Call):
            continue
        name = _call_name(node)
        if name in rule.write_calls:
            lines.append(node.lineno)
        elif name == "write_with_faults" and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and node.args[0].value in rule.write_fault_sites:
            lines.append(node.lineno)
    return lines


def _fence_check_lines(fn_node, rule: FenceRule) -> list:
    lines = []
    for node in ast.walk(fn_node):
        if isinstance(node, ast.Attribute) and node.attr in rule.fence_checks:
            lines.append(node.lineno)
        elif isinstance(node, ast.Call) \
                and _call_name(node) in rule.fence_checks:
            lines.append(node.lineno)
    return lines


def check_fence_source(source: str, path: str, rule: FenceRule) -> list:
    tree = ast.parse(source)
    findings: list = []
    guarded = dict(rule.guarded)
    used: set = set()
    cls = None
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == rule.cls:
            cls = node
            break
    if cls is None:
        return [Finding(
            "GL-PROTO-FENCE", path, 1,
            f"fence-rule class missing: {rule.cls} (table is stale)",
            detail=f"missing:{rule.cls}")]
    for item in cls.body:
        if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        writes = _write_lines(item, rule)
        if not writes:
            continue
        method = item.name
        rationale = guarded.get(method)
        if rationale is not None:
            used.add(method)
            if not rationale.strip():
                findings.append(Finding(
                    "GL-PROTO-FENCE", path, item.lineno,
                    f"guarded fence helper {rule.cls}.{method} has no "
                    f"rationale",
                    detail=f"no-rationale:{rule.cls}.{method}"))
            continue
        checks = _fence_check_lines(item, rule)
        if not checks or min(checks) > min(writes):
            findings.append(Finding(
                "GL-PROTO-FENCE", path, min(writes),
                f"{rule.cls}.{method} writes at the journal boundary "
                f"without a fence re-read before the write (declare it "
                f"guarded with a rationale, or gate it)",
                detail=f"{rule.cls}.{method}:unfenced-write"))
    for method in sorted(set(guarded) - used):
        findings.append(Finding(
            "GL-PROTO-FENCE", path, 1,
            f"stale guarded entry: {rule.cls}.{method} performs no "
            f"boundary write any more (fixed? delete the table entry)",
            detail=f"stale-guarded:{rule.cls}.{method}"))
    return findings


# ── GL-PROTO-ORDER ───────────────────────────────────────────────────


def _call_lines(fn_node, name: str) -> list:
    return [node.lineno for node in ast.walk(fn_node)
            if isinstance(node, ast.Call) and _call_name(node) == name]


def check_order_source(source: str, path: str, rules) -> list:
    tree = ast.parse(source)
    functions = _index(tree)
    findings: list = []
    for rule in rules:
        fn = functions.get(rule.qualname)
        if fn is None:
            findings.append(Finding(
                "GL-PROTO-ORDER", path, 1,
                f"order-rule site missing: {rule.qualname} (table is "
                f"stale)",
                detail=f"missing:{rule.qualname}"))
            continue
        firsts = _call_lines(fn, rule.first)
        thens = _call_lines(fn, rule.then)
        if not firsts:
            findings.append(Finding(
                "GL-PROTO-ORDER", path, fn.lineno,
                f"{rule.qualname} never calls {rule.first}() — the "
                f"{rule.invariant} table row is stale",
                detail=f"stale-first:{rule.qualname}:{rule.first}"))
            continue
        first_min = min(firsts)
        if rule.forbid_early:
            for line in thens:
                if line < first_min:
                    findings.append(Finding(
                        "GL-PROTO-ORDER", path, line,
                        f"{rule.qualname} calls {rule.then}() before "
                        f"{rule.first}() — violates {rule.invariant}",
                        detail=f"{rule.qualname}:{rule.then}-before-"
                               f"{rule.first}"))
        if not any(line >= first_min for line in thens):
            findings.append(Finding(
                "GL-PROTO-ORDER", path, first_min,
                f"{rule.qualname} never calls {rule.then}() after "
                f"{rule.first}() — violates {rule.invariant}",
                detail=f"{rule.qualname}:missing-{rule.then}"))
    return findings


# ── GL-PROTO-ACK ─────────────────────────────────────────────────────


def _is_empty_list(node) -> bool:
    return isinstance(node, ast.List) and not node.elts


def check_ack_source(source: str, path: str, rules) -> list:
    tree = ast.parse(source)
    functions = _index(tree)
    findings: list = []
    for rule in rules:
        fn = functions.get(rule.qualname)
        if fn is None:
            findings.append(Finding(
                "GL-PROTO-ACK", path, 1,
                f"ack-rule site missing: {rule.qualname} (table is stale)",
                detail=f"missing:{rule.qualname}"))
            continue
        if rule.kind == "commit-before-release":
            commits = _call_lines(fn, "commit")
            if not commits:
                findings.append(Finding(
                    "GL-PROTO-ACK", path, fn.lineno,
                    f"{rule.qualname} releases route-log seqs without any "
                    f"journal commit — acked must mean durable",
                    detail=f"{rule.qualname}:no-commit"))
                continue
            for node in ast.walk(fn):
                if isinstance(node, ast.Return) and node.value is not None \
                        and not _is_empty_list(node.value) \
                        and node.lineno < min(commits):
                    findings.append(Finding(
                        "GL-PROTO-ACK", path, node.lineno,
                        f"{rule.qualname} returns seqs before the group "
                        f"commit — a crash here turns redelivery into "
                        f"loss",
                        detail=f"{rule.qualname}:release-before-commit"))
        elif rule.kind == "monotonic-watermark":
            guarded = False
            for node in ast.walk(fn):
                if isinstance(node, ast.Compare) \
                        and any(isinstance(op, (ast.Gt, ast.GtE))
                                for op in node.ops):
                    subtrees = [node.left, *node.comparators]
                    if any(isinstance(s, ast.Attribute)
                           and s.attr == rule.attr
                           or any(isinstance(x, ast.Attribute)
                                  and x.attr == rule.attr
                                  for x in ast.walk(s))
                           for s in subtrees):
                        guarded = True
                        break
            if not guarded:
                findings.append(Finding(
                    "GL-PROTO-ACK", path, fn.lineno,
                    f"{rule.qualname} advances {rule.attr} without an "
                    f"ordered comparison — a late ack would move the "
                    f"watermark backwards",
                    detail=f"{rule.qualname}:unguarded-watermark"))
    return findings


# ── the pass ─────────────────────────────────────────────────────────


def run(root: str | Path,
        epoch_rules=EPOCH_RULES, fence_rules=FENCE_RULES,
        order_rules=ORDER_RULES, ack_rules=ACK_RULES) -> tuple[list, int]:
    """(findings, files_scanned) for every table site under ``root``."""
    root = Path(root)
    findings: list = []
    sources: dict[str, Optional[str]] = {}

    def _source(module: str) -> Optional[str]:
        if module not in sources:
            path = root / module
            sources[module] = (path.read_text(encoding="utf-8")
                               if path.exists() else None)
        return sources[module]

    for rule in epoch_rules:
        src = _source(rule.module)
        if src is None:
            findings.append(Finding(
                "GL-PROTO-EPOCH", rule.module, 1,
                f"protocol module missing: {rule.module} (table is stale)",
                detail=f"missing:{rule.module}"))
            continue
        findings.extend(check_epoch_source(src, rule.module, rule.exempt))
    for rule in fence_rules:
        src = _source(rule.module)
        if src is None:
            findings.append(Finding(
                "GL-PROTO-FENCE", rule.module, 1,
                f"protocol module missing: {rule.module} (table is stale)",
                detail=f"missing:{rule.module}"))
            continue
        findings.extend(check_fence_source(src, rule.module, rule))
    by_module: dict[str, list] = {}
    for rule in order_rules:
        by_module.setdefault(rule.module, []).append(rule)
    for module, rules in sorted(by_module.items()):
        src = _source(module)
        if src is None:
            findings.append(Finding(
                "GL-PROTO-ORDER", module, 1,
                f"protocol module missing: {module} (table is stale)",
                detail=f"missing:{module}"))
            continue
        findings.extend(check_order_source(src, module, rules))
    ack_by_module: dict[str, list] = {}
    for rule in ack_rules:
        ack_by_module.setdefault(rule.module, []).append(rule)
    for module, rules in sorted(ack_by_module.items()):
        src = _source(module)
        if src is None:
            findings.append(Finding(
                "GL-PROTO-ACK", module, 1,
                f"protocol module missing: {module} (table is stale)",
                detail=f"missing:{module}"))
            continue
        findings.extend(check_ack_source(src, module, rules))
    scanned = sum(1 for s in sources.values() if s is not None)
    return findings, scanned
