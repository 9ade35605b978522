"""Per-call body lints over the JIT_TABLE (GL-TRACE-*).

A copy of ``vainplex_openclaw_tpu/analysis/tracing.py``: the same taint
analysis over the port's per-call bodies (:mod:`.jit_table`), where the
arguments are device tensors. Each rule keeps JAX's id, findings and
wording on JAX's constructs, and carries its torch meaning:

- **HOSTSYNC** — ``.item()``/``.tolist()``/``float()``/``int()``/``bool()``
  on a device tensor, and ``.cpu()``/``.numpy()``/``np.asarray``: each
  is a silent device→host sync on the served path.
- **CONTROLFLOW** — a Python branch on a tensor's value: the same sync,
  spelled as an ``if``.
- **IMPURE** — ``time.*``/``random.*``/``np.random.*``, and a
  ``torch.rand*``/``randn*`` draw (or an in-place ``uniform_``-style fill)
  without ``generator=``: the port draws every random number from an
  explicit ``torch.Generator``, so a run is reproducible from its seed.

Tensor metadata (``.device``, ``.dim()``, ``.numel()``, ``.stride()``,
``.data_ptr()`` beside JAX's ``.shape``/``.dtype``) is host state and never
tainted. JAX's text follows.

Inside a jitted body the arguments are tracers, not arrays; three idioms
that are fine in host code silently break or poison a trace:

- **GL-TRACE-HOSTSYNC** — ``.item()``/``.tolist()``/``float()``/``bool()``/
  ``int()``/``np.asarray``/``np.array`` on a traced value: either a
  ConcretizationTypeError at trace time or, under ``jit``-free eager
  fallback, a silent device→host sync on the hot path.
- **GL-TRACE-CONTROLFLOW** — Python ``if``/``while``/``assert``/ternary on
  a traced value: branches burn into the compiled program based on the
  tracer's (unavailable) value; the fix is ``lax.cond``/``jnp.where`` or
  declaring the argument static in the table.
- **GL-TRACE-IMPURE** — ``time.*``/``random.*``/``np.random.*`` inside a
  jitted body: runs ONCE at trace time and freezes into the program — a
  "random" kernel that returns the same numbers forever.

The pass is a per-function taint analysis: an entry's parameters (minus
its declared ``static`` names) are traced; taint propagates through
assignments, arithmetic, subscripts and calls, and stops at shape-like
attributes (``.shape``/``.dtype``/``.ndim``/``.size``) and
``len``/``isinstance``/``type``/``range`` — those are static under jit.
``is``/``is not``/``in``/``not in`` comparisons are structure checks on
pytrees, not value reads, and never count as control flow on a tracer.
Roots are expanded through the same-module call graph (a helper reached
only from a jitted body is scanned without being listed); taint crosses
call boundaries by parameter name via the entry's ``static`` tuple.
"""

from __future__ import annotations

import ast
from pathlib import Path

from .findings import Finding
from .jit_table import JIT_TABLE, JitEntry, entries_for

# Attribute reads that are static under jit even on a traced value; the
# torch names after JAX's are a tensor's host-side metadata.
_SHAPE_ATTRS = frozenset({"shape", "dtype", "ndim", "size", "sharding",
                          "aval", "weak_type",
                          "device", "is_cuda", "dim", "numel", "stride",
                          "data_ptr", "element_size", "is_contiguous",
                          "requires_grad"})
# Builtins whose result is static regardless of argument taint.
_UNTAINT_CALLS = frozenset({"len", "isinstance", "type", "range", "hash",
                            "id", "getattr", "hasattr"})
# Builtins that force a concrete value out of a tracer.
_HOSTSYNC_BUILTINS = frozenset({"float", "bool", "int", "complex"})
# Method calls that force a device→host transfer.
_HOSTSYNC_METHODS = frozenset({"item", "tolist", "block_until_ready"})
# The same on a torch tensor: a copy to host memory.
_HOSTSYNC_TORCH_METHODS = frozenset({"cpu", "numpy"})
# numpy entry points that concretize their argument.
_HOSTSYNC_NP = frozenset({"asarray", "array", "copyto", "save", "savez"})
# Module roots whose calls are impure at trace time.
_IMPURE_ROOTS = ("time", "random", "datetime")
# torch draws that must name their generator (``torch.<name>(…)``), and
# the in-place fills that draw (``t.<name>(…)``).
_TORCH_DRAWS = frozenset({"rand", "randn", "randint", "randperm",
                          "rand_like", "randn_like", "randint_like",
                          "bernoulli", "multinomial", "normal", "poisson"})
_TORCH_FILLS = frozenset({"uniform_", "normal_", "random_", "bernoulli_",
                          "exponential_", "geometric_", "log_normal_",
                          "cauchy_"})


def _torch_aliases(tree: ast.Module) -> set:
    """Names the module binds to the torch package."""
    return {a.asname or a.name for n in ast.walk(tree)
            if isinstance(n, ast.Import) for a in n.names
            if a.name == "torch"}


def _numpy_aliases(tree: ast.Module) -> set:
    """Names the module binds to the numpy package (``np``, ``numpy``…)."""
    aliases = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "numpy":
                    aliases.add(a.asname or "numpy")
        elif isinstance(node, ast.ImportFrom):
            if node.module == "numpy":
                aliases.add("__from_numpy__")  # not alias-tracked; rare
    return aliases


def _dotted(node) -> str:
    """``a.b.c`` for an Attribute/Name chain, else ''."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


# ── function resolution + call-graph expansion ───────────────────────


def _function_index(tree: ast.Module) -> dict:
    """Dotted name → FunctionDef for every function in the module,
    including methods (``Class.method``) and nested defs
    (``outer.inner``); a plain ``forward`` resolves module-level defs."""
    index: dict = {}

    def visit(node, prefix):
        # Descend through control-flow statements (a jit impl defined
        # under an ``if _jit is None:`` lazy-builder guard still belongs
        # to the enclosing function's namespace).
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                name = f"{prefix}{child.name}"
                index[name] = child
                visit(child, f"{name}.")
            elif isinstance(child, ast.ClassDef):
                visit(child, f"{prefix}{child.name}.")
            elif isinstance(child, (ast.If, ast.For, ast.While, ast.With,
                                    ast.Try)):
                visit(child, prefix)
    visit(tree, "")
    return index


def expanded_jit_functions(tree: ast.Module, entry: JitEntry) -> dict:
    """Dotted name → FunctionDef for the entry's roots plus every
    same-module function referenced (called OR passed as a callback —
    ``lax.scan``/``value_and_grad`` take function references) from an
    already-included body. BFS to fixpoint; nested defs of an included
    function are included implicitly (they trace with it)."""
    index = _function_index(tree)
    # leaf name → dotted candidates, for resolving bare-name references
    by_leaf: dict = {}
    for dotted in index:
        by_leaf.setdefault(dotted.rsplit(".", 1)[-1], []).append(dotted)

    included: dict = {}
    queue = [n for n in entry.jit_fns if n in index]
    queue += [leaf for n in entry.jit_fns if n not in index
              for leaf in by_leaf.get(n, [])[:1]]
    while queue:
        name = queue.pop()
        if name in included or name not in index:
            continue
        # nested defs trace with their parent and are walked inside it —
        # a separately-included ancestor already covers this function
        if any(name.startswith(p + ".") for p in included):
            continue
        fn = index[name]
        included[name] = fn
        for node in ast.walk(fn):
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
                for cand in by_leaf.get(node.id, []):
                    if cand not in included:
                        queue.append(cand)
    # drop any earlier-included function that a later-included one contains
    for name in list(included):
        if any(name != p and name.startswith(p + ".") for p in included):
            del included[name]
    return included


# ── taint analysis ───────────────────────────────────────────────────


class _Taint:
    """Name-level taint for one function body."""

    def __init__(self, fn, static: frozenset, np_aliases: set,
                 torch_aliases: frozenset = frozenset()):
        self.static = static
        self.np = np_aliases
        self.torch = torch_aliases
        self.tainted: set = set()
        # Seed from the body's params AND every nested def's params (nested
        # functions are walked inside their parent and trace with it; their
        # closure shares the parent's taint env — name-merged, which only
        # errs toward over-tainting).
        for node in ast.walk(fn):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    or isinstance(node, ast.Lambda):
                args = node.args
                for a in (list(getattr(args, "posonlyargs", []))
                          + list(args.args) + list(args.kwonlyargs)
                          + ([args.vararg] if args.vararg else [])
                          + ([args.kwarg] if args.kwarg else [])):
                    if a.arg not in static and a.arg != "self":
                        self.tainted.add(a.arg)

    def is_tainted(self, node) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.tainted
        if isinstance(node, ast.Attribute):
            if node.attr in _SHAPE_ATTRS:
                return False
            return self.is_tainted(node.value)
        if isinstance(node, ast.Subscript):
            return self.is_tainted(node.value) or self.is_tainted(node.slice)
        if isinstance(node, ast.Call):
            fname = _dotted(node.func)
            leaf = fname.rsplit(".", 1)[-1] if fname else ""
            if leaf in _UNTAINT_CALLS:
                return False
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _SHAPE_ATTRS:
                return False
            return (any(self.is_tainted(a) for a in node.args)
                    or any(self.is_tainted(k.value) for k in node.keywords)
                    or (isinstance(node.func, ast.Attribute)
                        and self.is_tainted(node.func.value)))
        if isinstance(node, (ast.BinOp,)):
            return self.is_tainted(node.left) or self.is_tainted(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.is_tainted(node.operand)
        if isinstance(node, ast.Compare):
            return self.is_tainted(node.left) or \
                any(self.is_tainted(c) for c in node.comparators)
        if isinstance(node, ast.BoolOp):
            return any(self.is_tainted(v) for v in node.values)
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return any(self.is_tainted(e) for e in node.elts)
        if isinstance(node, ast.Dict):
            return any(v is not None and self.is_tainted(v)
                       for v in node.values)
        if isinstance(node, ast.Starred):
            return self.is_tainted(node.value)
        if isinstance(node, ast.IfExp):
            return self.is_tainted(node.body) or self.is_tainted(node.orelse)
        if isinstance(node, ast.NamedExpr):
            return self.is_tainted(node.value)
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            return any(self.is_tainted(g.iter) for g in node.generators) \
                or self.is_tainted(node.elt)
        if isinstance(node, ast.Slice):
            return any(p is not None and self.is_tainted(p)
                       for p in (node.lower, node.upper, node.step))
        return False

    def _mark_targets(self, target) -> None:
        if isinstance(target, ast.Name):
            self.tainted.add(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self._mark_targets(e)
        elif isinstance(target, ast.Starred):
            self._mark_targets(target.value)

    def propagate(self, fn) -> None:
        """Fixpoint over assignments (use-before-def across nested defs)."""
        for _ in range(8):
            before = len(self.tainted)
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign) and self.is_tainted(node.value):
                    for t in node.targets:
                        self._mark_targets(t)
                elif isinstance(node, ast.AnnAssign) and node.value is not None \
                        and self.is_tainted(node.value):
                    self._mark_targets(node.target)
                elif isinstance(node, ast.AugAssign) \
                        and (self.is_tainted(node.value)
                             or self.is_tainted(node.target)):
                    self._mark_targets(node.target)
                elif isinstance(node, ast.NamedExpr) \
                        and self.is_tainted(node.value):
                    self._mark_targets(node.target)
                elif isinstance(node, ast.For) and self.is_tainted(node.iter):
                    self._mark_targets(node.target)
                elif isinstance(node, (ast.ListComp, ast.SetComp,
                                       ast.GeneratorExp, ast.DictComp)):
                    for g in node.generators:
                        if self.is_tainted(g.iter):
                            self._mark_targets(g.target)
            if len(self.tainted) == before:
                return


def _control_tainted(taint: _Taint, test) -> bool:
    """Taint of a branch test, EXCLUDING identity/membership compares —
    ``x is None`` / ``"moe" in p`` are pytree-structure checks, legal on
    traced containers."""
    if isinstance(test, ast.Compare) and all(
            isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
            for op in test.ops):
        return False
    if isinstance(test, ast.BoolOp):
        return any(_control_tainted(taint, v) for v in test.values)
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        return _control_tainted(taint, test.operand)
    return taint.is_tainted(test)


# ── the three rules over one traced body ─────────────────────────────


def _scan_body(fn, dotted_name: str, path: str, taint: _Taint) -> list:
    findings = []

    def note(rule, node, msg, symbol):
        findings.append(Finding(
            rule, path, getattr(node, "lineno", fn.lineno),
            f"{dotted_name}: {msg}",
            detail=f"{dotted_name}:{symbol}"))

    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            fname = _dotted(node.func)
            leaf = fname.rsplit(".", 1)[-1] if fname else ""
            root = fname.split(".", 1)[0] if fname else ""
            # HOSTSYNC: float()/bool()/int() on traced values
            if isinstance(node.func, ast.Name) \
                    and node.func.id in _HOSTSYNC_BUILTINS \
                    and any(taint.is_tainted(a) for a in node.args):
                note("GL-TRACE-HOSTSYNC", node,
                     f"{node.func.id}() on a traced value forces a "
                     f"host sync / concretization inside the jitted body",
                     f"{node.func.id}:{node.lineno - fn.lineno}")
            # HOSTSYNC: .item()/.tolist() on traced receivers
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _HOSTSYNC_METHODS \
                    and taint.is_tainted(node.func.value):
                note("GL-TRACE-HOSTSYNC", node,
                     f".{node.func.attr}() on a traced value forces a "
                     f"host sync inside the jitted body",
                     f"{node.func.attr}:{node.lineno - fn.lineno}")
            # HOSTSYNC: .cpu()/.numpy() on traced tensors
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _HOSTSYNC_TORCH_METHODS \
                    and taint.is_tainted(node.func.value):
                note("GL-TRACE-HOSTSYNC", node,
                     f".{node.func.attr}() copies a device tensor to the "
                     f"host inside the per-call body (a silent sync)",
                     f"{node.func.attr}:{node.lineno - fn.lineno}")
            # HOSTSYNC: np.asarray/np.array on traced values
            elif root in taint.np and leaf in _HOSTSYNC_NP \
                    and (any(taint.is_tainted(a) for a in node.args)
                         or any(taint.is_tainted(k.value)
                                for k in node.keywords)):
                note("GL-TRACE-HOSTSYNC", node,
                     f"np.{leaf} on a traced value concretizes it at "
                     f"trace time (host sync / trace break)",
                     f"np.{leaf}:{node.lineno - fn.lineno}")
            # IMPURE: time.* / random.* / np.random.*
            if root in _IMPURE_ROOTS and "." in fname:
                note("GL-TRACE-IMPURE", node,
                     f"{fname}() runs once at trace time and freezes "
                     f"into the compiled program",
                     f"{fname}")
            elif root in taint.np and fname.startswith(
                    tuple(f"{a}.random." for a in taint.np)):
                note("GL-TRACE-IMPURE", node,
                     f"{fname}() runs once at trace time and freezes "
                     f"into the compiled program",
                     f"{fname}")
            elif not any(k.arg == "generator" for k in node.keywords) and (
                    (root in taint.torch and fname.count(".") == 1
                     and leaf in _TORCH_DRAWS)
                    or (isinstance(node.func, ast.Attribute)
                        and node.func.attr in _TORCH_FILLS)):
                note("GL-TRACE-IMPURE", node,
                     f"{fname or leaf}() draws from torch's global "
                     f"generator — pass generator= so the run is "
                     f"reproducible from its seed",
                     f"{fname or leaf}")
        elif isinstance(node, ast.If) and _control_tainted(taint, node.test):
            note("GL-TRACE-CONTROLFLOW", node,
                 "Python `if` on a traced value — use lax.cond/jnp.where "
                 "or declare the argument static in JIT_TABLE",
                 f"if:{node.lineno - fn.lineno}")
        elif isinstance(node, ast.While) \
                and _control_tainted(taint, node.test):
            note("GL-TRACE-CONTROLFLOW", node,
                 "Python `while` on a traced value — use "
                 "lax.while_loop/fori_loop",
                 f"while:{node.lineno - fn.lineno}")
        elif isinstance(node, ast.Assert) \
                and _control_tainted(taint, node.test):
            note("GL-TRACE-CONTROLFLOW", node,
                 "`assert` on a traced value concretizes it — use "
                 "checkify or move the check outside jit",
                 f"assert:{node.lineno - fn.lineno}")
        elif isinstance(node, ast.IfExp) \
                and _control_tainted(taint, node.test):
            note("GL-TRACE-CONTROLFLOW", node,
                 "ternary on a traced value — use jnp.where",
                 f"ifexp:{node.lineno - fn.lineno}")
    return findings


# ── public API ───────────────────────────────────────────────────────


def check_source(src: str, path: str, entries: list) -> list:
    """Trace-safety findings for one module's source under ``entries``
    (the fixture-corpus entry point; the repo gate feeds JIT_TABLE rows)."""
    tree = ast.parse(src)
    np_aliases = _numpy_aliases(tree)
    torch_aliases = frozenset(_torch_aliases(tree))
    findings: list = []
    seen: set = set()
    for entry in entries:
        static = frozenset(entry.static)
        included = expanded_jit_functions(tree, entry)
        # Analyzer-goes-blind guard: a table row naming a function that no
        # longer exists means this pass is silently skipping code — the
        # same failure mode as drift's missing-module CONFIG_SITES check.
        index = _function_index(tree)
        leaves = {d.rsplit(".", 1)[-1] for d in index}
        for name in entry.jit_fns:
            if name not in index and name.rsplit(".", 1)[-1] not in leaves:
                f = Finding(
                    "GL-TRACE-TABLE", path, 1,
                    f"JIT_TABLE names {name!r} but {path} defines no such "
                    f"function — the tracing pass is blind to this entry",
                    detail=f"unresolved:{name}")
                if f.key not in seen:
                    seen.add(f.key)
                    findings.append(f)
        for dotted, fn in sorted(included.items()):
            taint = _Taint(fn, static, np_aliases, torch_aliases)
            taint.propagate(fn)
            for f in _scan_body(fn, dotted, path, taint):
                if f.key not in seen:  # entries may share helpers
                    seen.add(f.key)
                    findings.append(f)
    return findings


def run(root) -> tuple[list, int]:
    root = Path(root)
    findings: list = []
    scanned = 0
    for module in sorted({e.module for e in JIT_TABLE}):
        path = root / module
        if not path.exists():
            findings.append(Finding(
                "GL-TRACE-TABLE", module, 1,
                f"JIT_TABLE lists missing module {module}",
                detail=f"missing:{module}"))
            continue
        scanned += 1
        findings.extend(check_source(path.read_text(encoding="utf-8"),
                                     module, entries_for(module)))
    return findings, scanned
