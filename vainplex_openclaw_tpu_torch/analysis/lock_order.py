"""Static lock-acquisition-order analysis over the whole package.

A copy of ``vainplex_openclaw_tpu/analysis/lock_order.py`` whose default
``package`` is the port's own tree.

Deadlocks need two ingredients: two locks and two orders. The discipline
that prevents them — "always commit-lock before buffer-lock" — is global
and invisible at any single call site, so this pass reconstructs it: every
``with self.<lock>`` nesting (including ``with a, b`` multi-item form) and
every call made *while holding* a lock to a same-class method that itself
acquires one contributes a directed edge ``outer → inner`` labelled
``Class.lock_attr``. A cycle in the resulting graph is a potential
deadlock schedule — **GL-LOCK-ORDER**.

Lock recognition is name-based (``*_lock`` / ``*_LOCK`` attributes and
module globals) — the same convention every lock in this repo already
follows. Manual ``self.<lock>.acquire()`` calls mark the lock held for the
remainder of the function (the journal's non-blocking group-wait probe is
the one real use; over-approximating its extent only ADDS edges, and the
discipline is per-(class, attr), so extra coverage errs toward catching
inversions, not missing them).

Self-edges (re-acquiring the lock you hold) are reported only for plain
``threading.Lock`` — on an RLock that is legal re-entry, and the checker
learns which attributes are RLocks from their ``__init__`` assignment.
A lock whose constructor it cannot see is assumed plain: the dangerous
default.

The static graph sees lexical structure only — locks taken through
different objects' methods (StageTimer inside FactStore's ``with``) meet
in the RUNTIME witness (:mod:`.witness`), which the chaos suites arm.
"""

from __future__ import annotations

import ast
from pathlib import Path

from .findings import Finding

_LOCK_SUFFIXES = ("_lock", "_LOCK")


def _is_lock_name(name: str) -> bool:
    return name.endswith(_LOCK_SUFFIXES) or name in ("lock", "LOCK")


def _lock_label(node, cls: str | None):
    """Node → lock label ('Cls.attr' / 'module.NAME') or None."""
    if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id == "self" and _is_lock_name(node.attr)):
        return f"{cls}.{node.attr}" if cls else None
    if isinstance(node, ast.Name) and _is_lock_name(node.id):
        return node.id
    return None


class _FuncScan(ast.NodeVisitor):
    """One function: collects (held_set, acquired_label, lineno) events and
    same-class calls made under held locks."""

    def __init__(self, cls):
        self.cls = cls
        self.held: list[str] = []
        self.acquisitions: list = []   # (tuple(held), label, lineno)
        self.calls_under: list = []    # (tuple(held), method_name, lineno)
        self.all_acquired: set = set()

    def _acquire(self, label: str, lineno: int) -> None:
        self.acquisitions.append((tuple(self.held), label, lineno))
        self.all_acquired.add(label)
        self.held.append(label)

    def visit_With(self, node: ast.With) -> None:
        added = []
        for item in node.items:
            self.visit(item.context_expr)
            label = _lock_label(item.context_expr, self.cls)
            if label is not None:
                self._acquire(label, node.lineno)
                added.append(label)
        for stmt in node.body:
            self.visit(stmt)
        # Remove exactly the labels THIS with added (newest hold of each):
        # a manual .acquire() inside the body also appended to ``held`` and
        # popping from the end would release the wrong lock, corrupting the
        # held set for the rest of the function.
        for label in reversed(added):
            for i in range(len(self.held) - 1, -1, -1):
                if self.held[i] == label:
                    del self.held[i]
                    break

    visit_AsyncWith = visit_With

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        if isinstance(func, ast.Attribute):
            # self.<lock>.acquire(...) — held for the rest of the function
            # (over-approximation; see module docstring).
            if func.attr == "acquire":
                label = _lock_label(func.value, self.cls)
                if label is not None:
                    self._acquire(label, node.lineno)
            elif (isinstance(func.value, ast.Name) and func.value.id == "self"
                  and self.held):
                self.calls_under.append(
                    (tuple(self.held), func.attr, node.lineno))
        self.generic_visit(node)

    def visit_FunctionDef(self, node):  # nested defs: deferred execution,
        return                          # their acquisitions are their own

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef


def _scan_module(tree: ast.Module, path: str):
    """→ (per-class method scans, rlock attrs, module-level scans)."""
    classes: dict[str, dict[str, _FuncScan]] = {}
    rlocks: set[str] = set()

    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            methods: dict[str, _FuncScan] = {}
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    scan = _FuncScan(node.name)
                    for stmt in item.body:
                        scan.visit(stmt)
                    methods[item.name] = scan
                    if item.name == "__init__":
                        for stmt in ast.walk(item):
                            if (isinstance(stmt, ast.Assign)
                                    and isinstance(stmt.value, ast.Call)
                                    and isinstance(stmt.value.func, ast.Attribute)
                                    and stmt.value.func.attr == "RLock"):
                                for t in stmt.targets:
                                    lbl = _lock_label(t, node.name)
                                    if lbl:
                                        rlocks.add(lbl)
            classes[node.name] = methods
    return classes, rlocks


def build_graph(root: str | Path, package: str = "vainplex_openclaw_tpu_torch"):
    """→ (edges: {(a, b): (path, line)}, rlocks: set, files_scanned)."""
    root = Path(root)
    edges: dict = {}
    rlocks: set = set()
    scanned = 0
    for path in sorted((root / package).rglob("*.py")):
        rel = path.relative_to(root).as_posix()
        try:
            tree = ast.parse(path.read_text(encoding="utf-8"))
        except SyntaxError:
            continue  # the compileall CI step owns syntax errors
        scanned += 1
        classes, file_rlocks = _scan_module(tree, rel)
        rlocks |= file_rlocks
        _merge_module_edges(edges, classes, rel)
    return edges, rlocks, scanned


def _merge_module_edges(edges: dict, classes: dict, path: str) -> None:
    """Fold one module's (with-nesting + call) edges into ``edges`` —
    shared by the repo scan and the fixture entry point so the corpus
    tests exercise the same edge semantics that gate CI."""
    for methods in classes.values():
        # lock set acquired anywhere in each method, for call edges
        acquired_by = {m: s.all_acquired for m, s in methods.items()}
        for scan in methods.values():
            for held, label, lineno in scan.acquisitions:
                for h in held:
                    edges.setdefault((h, label), (path, lineno))
            for held, callee, lineno in scan.calls_under:
                for inner in acquired_by.get(callee, ()):
                    for h in held:
                        edges.setdefault((h, inner), (path, lineno))


def elementary_cycles(graph: dict) -> list:
    """ALL elementary cycles in ``{node: successors}`` as node lists
    ``[a, b, …, a]`` — the one enumerator both the static pass and the
    runtime witness use. Each cycle is found exactly once, rooted at its
    smallest node (the Johnson-style ordering trick: a root only explores
    nodes ordering after it, so a cycle can't be re-discovered from its
    other members). No global visited-set pruning — that shortcut reports
    *whether* the graph is cyclic but silently drops cycles sharing nodes
    with an already-reported one, and the finding list presents itself as
    complete. Exponential in the worst case; lock graphs are tiny."""
    cycles: list = []
    for root in sorted(graph):
        path = [root]
        on_path = {root}

        def dfs(node) -> None:
            for nxt in sorted(graph.get(node, ())):
                if nxt == root:
                    cycles.append(path + [root])
                elif nxt not in on_path and nxt > root:
                    path.append(nxt)
                    on_path.add(nxt)
                    dfs(nxt)
                    path.pop()
                    on_path.discard(nxt)

        dfs(root)
    return cycles


def find_cycles(edges: dict, rlocks: set) -> list:
    """Cycles in the acquisition graph as (cycle, example_site) pairs.
    Self-edges on RLocks are legal re-entry and dropped before the
    search."""
    graph: dict[str, set] = {}
    self_edges = []
    for (a, b), site in edges.items():
        if a == b:
            if a not in rlocks:
                self_edges.append(([a, a], site))
            continue
        graph.setdefault(a, set()).add(b)
    out = []
    for cyc in elementary_cycles(graph):
        site = edges.get((cyc[-2], cyc[-1])) or ("", 0)
        out.append((cyc, site))
    return self_edges + out


def run(root: str | Path, package: str = "vainplex_openclaw_tpu_torch"):
    """(findings, files_scanned) — one GL-LOCK-ORDER finding per cycle."""
    edges, rlocks, scanned = build_graph(root, package)
    findings = []
    for cyc, (path, line) in find_cycles(edges, rlocks):
        sig = " -> ".join(cyc)
        findings.append(Finding(
            "GL-LOCK-ORDER", path or package, line,
            f"lock acquisition cycle: {sig}",
            detail=sig))
    return findings, scanned


def check_source(source: str, path: str = "<fixture>"):
    """Fixture entry point: edges+cycles for one module's source, through
    the same edge builder the repo scan uses."""
    tree = ast.parse(source)
    classes, rlocks = _scan_module(tree, path)
    edges: dict = {}
    _merge_module_edges(edges, classes, path)
    return find_cycles(edges, rlocks)
