"""Rebuild-hazard lints over the JIT_TABLE (GL-RETRACE-*).

A copy of ``vainplex_openclaw_tpu/analysis/retrace.py`` over the port's
tree, with each rule's torch meaning beside JAX's (whose constructs it
still flags, with JAX's wording):

- **UNBUCKETED** keeps the shape discipline (wrappers bucket, callers of
  an entry bucket or are declared), and where JAX flags a ``jax.jit``
  built inside a plain function, the port flags a kernel build reached
  per call outside a cache: ``_build.build(…)`` or a ``ctypes.CDLL(…)``
  load in a function that is neither a declared builder (``load_library``
  is the cache; the kernel search builds on purpose) nor ``lru_cache``-d.
  Such a call would run ``nvcc`` at serve time. This is the static half
  of the port's :class:`~.witness.RetraceWitness`, which counts builds.
- **DTYPE** is the same rule: a float64 numpy scalar or a float-defaulting
  ``np.zeros``/``ones``/``full``/``empty`` that flows into
  ``torch.from_numpy``/``torch.as_tensor`` gives a float64 tensor.

JAX's text follows.

A jitted function recompiles for every new (shape, dtype, static-value)
signature. Two hazard classes rot silently:

- **GL-RETRACE-UNBUCKETED** — shape-space discipline. Every entry must
  either bucket (its wrapper routes batch dims through
  ``pow2_bucket``/``pad_rows`` — the bucketing policy, O(log N) compiles) or be
  declared FIXED with a rationale. Package call sites feeding an entry
  must bucket locally, be a traced body themselves, or be declared
  ``fixed_callers`` — the bug class this catches is a serving path
  compiling once per distinct batch size (one XLA compile per request
  burst). The same rule flags ``jax.jit``/``shard_map`` constructed inside
  a plain function: a closure re-wrapped per call gets a FRESH compile
  cache every time, which is a guaranteed per-call retrace no bucketing
  can save (only declared lazy ``builders`` and ``lru_cache``-memoized
  constructors are exempt), and a module-level jit in a module with no
  JIT_TABLE row is an undeclared entry point the other passes are blind
  to.
- **GL-RETRACE-DTYPE** — the float64-drift bug class. ``np.sqrt``/``np.log``/…
  on a Python scalar returns a **strong** ``np.float64``; multiplied into
  jit inputs it either doubles array bytes (numpy side) or flips the
  whole computation to f64 the moment ``jax_enable_x64`` is on. Flagged
  unless the result is explicitly narrowed (``float(…)`` /
  ``np.float32(…)`` / ``math.sqrt`` which returns a weak Python float).
  Float-defaulting numpy constructors (``np.zeros``/``ones``/``full``/
  ``empty``) without an explicit ``dtype=`` in a JIT_TABLE module are
  flagged for the same reason.
"""

from __future__ import annotations

import ast
from pathlib import Path

from .findings import Finding
from .jit_table import BUCKETED, FIXED, JIT_TABLE, entries_for
from .tracing import _dotted, _function_index, expanded_jit_functions

_PKG = "vainplex_openclaw_tpu_torch"

# Calls that satisfy the bucketing requirement when present in a body.
# serve_bucket is the mesh-serving form: pow2_bucket floored
# at the mesh dp size, same O(log N) shape space per mesh.
_BUCKET_GUARDS = frozenset({"pow2_bucket", "pad_rows", "_pad_vec",
                            "serve_bucket"})
# jit/shard_map constructors the in-function rule watches for. (pallas_call
# is NOT here: invoked inside a traced body it builds an op, not a cache.)
_JIT_MAKERS = frozenset({"jit", "shard_map", "pjit"})
# The port's kernel builds: _build.build(…) (or a bare build(…) imported
# from a _build module) runs nvcc; ctypes.CDLL(…) loads a library.
_BUILD_MAKERS = frozenset({"build", "CDLL"})
# Decorators that make an in-function constructor a sanctioned memo.
_MEMO_DECORATORS = frozenset({"lru_cache", "cache"})
# numpy ufuncs returning strong float64 on Python scalars.
_F64_UFUNCS = frozenset({"sqrt", "log", "log2", "log10", "exp", "power",
                         "cbrt", "reciprocal"})
# numpy constructors whose default dtype is float64.
_F64_CTORS = frozenset({"zeros", "ones", "empty", "full", "eye", "linspace"})
# Wrappers that explicitly narrow a float64 scalar.
_NARROWERS = frozenset({"float", "float32", "bfloat16", "float16", "int",
                        "int32", "asarray", "array"})


# The port's copy of the root-level __graft_entry__.py (the graft entry
# points, fixed-shape legs), which JAX's pass does not scan either.
_OUT_OF_SCOPE = ("graft_entry.py",)


def _module_paths(root: Path) -> list:
    return sorted(p for p in (root / _PKG).rglob("*.py")
                  if p.relative_to(root / _PKG).as_posix()
                  not in _OUT_OF_SCOPE)


def _leaf(fname: str) -> str:
    return fname.rsplit(".", 1)[-1] if fname else ""


def _has_decorator(fn, names: frozenset) -> bool:
    for dec in fn.decorator_list:
        d = dec.func if isinstance(dec, ast.Call) else dec
        if _leaf(_dotted(d)) in names:
            return True
    return False


def _body_calls(fn, names: frozenset) -> bool:
    return any(isinstance(n, ast.Call) and _leaf(_dotted(n.func)) in names
               for n in ast.walk(fn))


def _enclosing_map(tree: ast.Module) -> dict:
    """id(node) → dotted name of the nearest enclosing function. Decorator
    expressions belong to the ENCLOSING scope, not the function they
    decorate: ``@partial(jax.jit, …)`` on a module-level def is module-
    level (applied once at import), while the same decorator on a def
    nested in a plain function re-runs — and rebuilds its cache — per
    call. First write wins (setdefault), so the decorator pre-marking
    below survives the recursive walk."""
    owner: dict = {}

    def visit(node, prefix, current):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                name = f"{prefix}{child.name}"
                owner.setdefault(id(child), current)
                for dec in child.decorator_list:
                    for n in ast.walk(dec):
                        owner.setdefault(id(n), current)
                visit(child, f"{name}.", name)
            elif isinstance(child, ast.ClassDef):
                owner.setdefault(id(child), current)
                visit(child, f"{prefix}{child.name}.", current)
            else:
                owner.setdefault(id(child), current)
                visit(child, prefix, current)
    visit(tree, "", "")
    return owner


# ── table integrity + wrapper discipline ─────────────────────────────


def check_table(root: Path, table: tuple = None) -> list:
    findings = []
    for entry in (JIT_TABLE if table is None else table):
        path = root / entry.module
        if not path.exists():
            findings.append(Finding(
                "GL-RETRACE-UNBUCKETED", entry.module, 1,
                f"JIT_TABLE lists missing module {entry.module}",
                detail=f"missing:{entry.module}"))
            continue
        tree = ast.parse(path.read_text(encoding="utf-8"))
        index = _function_index(tree)
        if entry.shape_policy == FIXED and not entry.rationale.strip():
            findings.append(Finding(
                "GL-RETRACE-UNBUCKETED", entry.module, 1,
                f"FIXED-shape entry {entry.jit_fns} carries no rationale — "
                f"declare why its compile cache is bounded",
                detail=f"no-rationale:{entry.jit_fns[0] if entry.jit_fns else entry.module}"))
        if entry.shape_policy == BUCKETED:
            wrapper = index.get(entry.wrapper)
            if wrapper is None:
                findings.append(Finding(
                    "GL-RETRACE-UNBUCKETED", entry.module, 1,
                    f"BUCKETED entry declares wrapper {entry.wrapper!r} "
                    f"which does not exist",
                    detail=f"no-wrapper:{entry.wrapper}"))
            elif not _body_calls(wrapper, _BUCKET_GUARDS):
                findings.append(Finding(
                    "GL-RETRACE-UNBUCKETED", entry.module, wrapper.lineno,
                    f"wrapper {entry.wrapper} never routes shapes through "
                    f"pow2_bucket/pad_rows — every distinct batch size "
                    f"compiles a fresh XLA program",
                    detail=f"unguarded-wrapper:{entry.wrapper}"))
        for mod, func, rationale in entry.fixed_callers:
            if not str(rationale).strip():
                findings.append(Finding(
                    "GL-RETRACE-UNBUCKETED", mod, 1,
                    f"fixed_caller ({mod}, {func}) carries no rationale",
                    detail=f"no-rationale-caller:{mod}:{func}"))
    return findings


# ── in-function jit construction + undeclared entry points ───────────


def _sanctioned(enclosing: str, builders: set, index: dict) -> bool:
    """Whether ``enclosing`` or a function around it is a declared
    builder or an ``lru_cache``-memoized constructor."""
    chain = enclosing.split(".")
    prefixes = [".".join(chain[:i + 1]) for i in range(len(chain))]
    return any(p in builders for p in prefixes) or any(
        p in index and _has_decorator(index[p], _MEMO_DECORATORS)
        for p in prefixes)


def _build_calls(tree: ast.Module, rel: str) -> list:
    """Calls that build or load a kernel library: ``<x>._build.build``/
    ``_build.build``, ``ctypes.CDLL``, and the bare ``build``/``CDLL``
    where the module imports them from a ``_build`` module or ``ctypes``
    (or, in ``_build.py`` itself, defines ``build``)."""
    bare: set = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module:
            src = node.module.rsplit(".", 1)[-1]
            for a in node.names:
                if (src == "_build" and a.name == "build") \
                        or (src == "ctypes" and a.name == "CDLL"):
                    bare.add(a.asname or a.name)
    if rel.endswith("/_build.py") and any(
            isinstance(n, ast.FunctionDef) and n.name == "build"
            for n in tree.body):
        bare.add("build")
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = _dotted(node.func)
        leaf = _leaf(name)
        if leaf not in _BUILD_MAKERS:
            continue
        parts = name.split(".")
        if (len(parts) == 1 and leaf in bare) \
                or (leaf == "build" and len(parts) >= 2
                    and parts[-2] == "_build") \
                or (leaf == "CDLL" and parts[0] == "ctypes"):
            out.append(node)
    return out


def check_jit_construction(root: Path, table: tuple = None) -> list:
    findings = []
    for path in _module_paths(root):
        rel = path.relative_to(root).as_posix()
        try:
            tree = ast.parse(path.read_text(encoding="utf-8"))
        except SyntaxError:
            continue
        entries = entries_for(rel, table)
        builders = {b for e in entries for b in e.builders}
        declared = bool(entries)
        index = _function_index(tree)
        owner = _enclosing_map(tree)
        uses_jit_at_module_level = False
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            name = _dotted(node.func)
            leaf = _leaf(name)
            # ``partial(shard_map, …)`` / ``partial(jax.jit, …)`` builds
            # the same per-call cache a direct call would.
            if leaf == "partial" and any(
                    _leaf(_dotted(a)) in _JIT_MAKERS for a in node.args):
                leaf = next(_leaf(_dotted(a)) for a in node.args
                            if _leaf(_dotted(a)) in _JIT_MAKERS)
                name = leaf
            if leaf not in _JIT_MAKERS:
                continue
            # jax.jit / shard_map / pjit only — not e.g. SomeClass.jit
            root_name = name.split(".", 1)[0]
            if root_name not in ("jax", "jit", "shard_map", "pjit"):
                continue
            enclosing = owner.get(id(node), "")
            if not enclosing:
                uses_jit_at_module_level = True
                continue
            # walk up: any ancestor function sanctioned as builder/memo?
            if not _sanctioned(enclosing, builders, index):
                findings.append(Finding(
                    "GL-RETRACE-UNBUCKETED", rel, node.lineno,
                    f"{_leaf(name)}() constructed inside {enclosing}() — a "
                    f"fresh compile cache per call (guaranteed retrace); "
                    f"memoize the built callable (lru_cache builder) or "
                    f"declare the function in JIT_TABLE builders",
                    detail=f"percall-jit:{enclosing}"))
                continue
            uses_jit_at_module_level = True  # sanctioned builder counts
        # The port's kernel builds: the same nesting rule, with its own
        # wording (nvcc per call, not a fresh compile cache).
        for node in _build_calls(tree, rel):
            enclosing = owner.get(id(node), "")
            if not enclosing or _sanctioned(enclosing, builders, index):
                uses_jit_at_module_level = True
                continue
            findings.append(Finding(
                "GL-RETRACE-UNBUCKETED", rel, node.lineno,
                f"{_leaf(_dotted(node.func))}() reached inside {enclosing}() outside a cache — "
                f"a kernel build (nvcc) or library load per call; go "
                f"through _build.load_library's cache, memoize the "
                f"function (lru_cache), or declare it in JIT_TABLE "
                f"builders",
                detail=f"percall-build:{enclosing}"))
        # Decorator-applied jit. Call-form decorators (@partial(jax.jit,…),
        # @shard_map(…)) are Call nodes the walk above already polices;
        # the BARE form (@jax.jit on a def) has no Call node, so it gets
        # the same nesting check here: module-level (or under a sanctioned
        # builder) counts as module-level use, while a bare @jax.jit on a
        # def nested in a plain function is the identical per-call
        # fresh-cache bug the call form would be.
        for fn in index.values():
            for dec in fn.decorator_list:
                d = dec.func if isinstance(dec, ast.Call) else dec
                leaf = _leaf(_dotted(d))
                call_form = leaf in _JIT_MAKERS and isinstance(dec, ast.Call)
                partial_form = (isinstance(dec, ast.Call) and leaf == "partial"
                                and any(_leaf(_dotted(a)) in _JIT_MAKERS
                                        for a in dec.args))
                if call_form or partial_form:
                    uses_jit_at_module_level = True  # policed by Call walk
                    continue
                if leaf not in _JIT_MAKERS:
                    continue
                enclosing = owner.get(id(fn), "")
                if not enclosing:
                    uses_jit_at_module_level = True
                    continue
                if _sanctioned(enclosing, builders, index):
                    uses_jit_at_module_level = True
                    continue
                findings.append(Finding(
                    "GL-RETRACE-UNBUCKETED", rel, fn.lineno,
                    f"@{leaf} on {fn.name}() nested inside {enclosing}() — "
                    f"a fresh compile cache per call (guaranteed retrace); "
                    f"memoize the built callable (lru_cache builder) or "
                    f"declare the function in JIT_TABLE builders",
                    detail=f"percall-jit-dec:{enclosing}:{fn.name}"))
        if uses_jit_at_module_level and not declared:
            findings.append(Finding(
                "GL-RETRACE-UNBUCKETED", rel, 1,
                f"{rel} jits code but has no JIT_TABLE entry — the "
                f"trace/retrace passes are blind to it; add a row",
                detail=f"undeclared-module:{rel}"))
    return findings


# ── call sites feeding table entries ─────────────────────────────────


def check_call_sites(root: Path, table: tuple = None) -> list:
    findings = []
    tab = JIT_TABLE if table is None else table
    # entry name → owning entry (for fixed_callers lookup)
    watched: dict = {}
    for entry in tab:
        for name in entry.entry_names:
            watched[name] = entry
    if not watched:
        return findings
    declared_callers = {(m, f): r for e in tab
                        for (m, f, r) in e.fixed_callers}
    used_callers: set = set()
    for path in _module_paths(root):
        rel = path.relative_to(root).as_posix()
        try:
            tree = ast.parse(path.read_text(encoding="utf-8"))
        except SyntaxError:
            continue
        src_entries = entries_for(rel, table)
        # every traced body / wrapper / builder of this module is exempt
        exempt: set = set()
        for e in src_entries:
            exempt.update(expanded_jit_functions(tree, e))
            exempt.update(e.builders)
            if e.wrapper:
                exempt.add(e.wrapper)
        index = _function_index(tree)
        owner = _enclosing_map(tree)
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            leaf = _leaf(_dotted(node.func))
            if leaf not in watched:
                continue
            enclosing = owner.get(id(node), "")
            if not enclosing:
                continue  # module-level example/test scaffolding
            chain = enclosing.split(".")
            prefixes = [".".join(chain[:i + 1]) for i in range(len(chain))]
            if any(p in exempt for p in prefixes):
                continue
            if (rel, chain[0]) in declared_callers or \
                    any((rel, p) in declared_callers for p in prefixes):
                key = next(k for k in [(rel, p) for p in prefixes]
                           + [(rel, chain[0])] if k in declared_callers)
                used_callers.add(key)
                continue
            fn = next((index[p] for p in reversed(prefixes) if p in index),
                      None)
            if fn is not None and _body_calls(fn, _BUCKET_GUARDS):
                continue
            findings.append(Finding(
                "GL-RETRACE-UNBUCKETED", rel, node.lineno,
                f"{enclosing}() feeds jitted {leaf}() without bucketing "
                f"its batch through pow2_bucket/pad_rows — one XLA "
                f"compile per distinct batch size; bucket, or declare "
                f"(module, function) in the entry's fixed_callers with a "
                f"rationale",
                detail=f"unbucketed-call:{enclosing}:{leaf}"))
    # stale fixed_caller declarations (the fix landed, or a typo means
    # the exemption guards nothing) — mirror the stale-baseline report
    for (mod, func), _ in declared_callers.items():
        if (mod, func) not in used_callers:
            findings.append(Finding(
                "GL-RETRACE-UNBUCKETED", mod, 1,
                f"fixed_caller ({mod}, {func}) matches no call site — "
                f"stale declaration, delete it",
                detail=f"stale-caller:{mod}:{func}"))
    return findings


# ── dtype drift ──────────────────────────────────────────────────────


def check_dtype_source(src: str, path: str) -> list:
    """float64-drift findings for one module's source."""
    tree = ast.parse(src)
    np_aliases = {a.asname or a.name for n in ast.walk(tree)
                  if isinstance(n, ast.Import)
                  for a in n.names if a.name == "numpy"}
    if not np_aliases:
        return []
    findings = []
    # names explicitly narrowed by assignment: w = np.float32(...)
    narrowed: set = set()
    # names bound from non-narrowing calls — almost always arrays
    # (np.zeros/jnp.einsum/forward(...)); np.sqrt on those is dtype-
    # correct and must not flag
    arrayish: set = set()
    # np-ufunc calls that sit directly inside a narrowing wrapper
    wrapped: set = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            leaf = _leaf(_dotted(node.value.func))
            if leaf in _NARROWERS:
                bucket = narrowed
            elif leaf in ("len", "max", "min", "abs", "round"):
                bucket = None  # scalar producers: stay suspect
            else:
                bucket = arrayish
            if bucket is not None:
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        bucket.add(t.id)
        if isinstance(node, ast.Call) and _leaf(_dotted(node.func)) in _NARROWERS:
            for a in list(node.args) + [k.value for k in node.keywords]:
                if isinstance(a, ast.Call):
                    wrapped.add(id(a))

    def scalarish(expr) -> bool:
        """Plausibly a Python scalar (the float64-producing shape).
        Names bound from calls other than explicit narrowers are assumed
        arrays and exempt; params and shape-derived names stay suspect."""
        if isinstance(expr, ast.Constant):
            return isinstance(expr.value, (int, float))
        if isinstance(expr, ast.Name):
            return expr.id not in narrowed and expr.id not in arrayish
        if isinstance(expr, ast.Attribute):
            return True       # cfg.d_model, self.learned_weight, …
        if isinstance(expr, ast.Subscript):
            return True       # shape[0]
        if isinstance(expr, ast.BinOp):
            return scalarish(expr.left) and scalarish(expr.right)
        if isinstance(expr, ast.UnaryOp):
            return scalarish(expr.operand)
        if isinstance(expr, ast.Call):
            return _leaf(_dotted(expr.func)) in ("len", "max", "min", "abs")
        return False

    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = _dotted(node.func)
        root_name = name.split(".", 1)[0]
        if root_name not in np_aliases:
            continue
        leaf = _leaf(name)
        if leaf in _F64_UFUNCS and id(node) not in wrapped \
                and node.args and scalarish(node.args[0]):
            findings.append(Finding(
                "GL-RETRACE-DTYPE", path, node.lineno,
                f"np.{leaf} on a Python scalar returns a STRONG float64 "
                f"that upcasts jit math under x64 (and numpy math always) "
                f"— use math.{leaf if leaf != 'power' else 'pow'} / "
                f"float(...) / np.float32(...)",
                detail=f"f64-ufunc:{leaf}:{node.lineno}"))
        elif leaf in _F64_CTORS \
                and not any(k.arg == "dtype" for k in node.keywords) \
                and not (len(node.args) >= 2 and leaf in ("zeros", "ones",
                                                          "empty")):
            findings.append(Finding(
                "GL-RETRACE-DTYPE", path, node.lineno,
                f"np.{leaf} without dtype= defaults to float64 — 2x the "
                f"bytes and a silent promotion hazard for jit args",
                detail=f"f64-ctor:{leaf}:{node.lineno}"))
    return findings


def check_dtype(root: Path) -> list:
    findings = []
    for module in sorted({e.module for e in JIT_TABLE}):
        path = root / module
        if path.exists():
            findings.extend(check_dtype_source(
                path.read_text(encoding="utf-8"), module))
    return findings


# ── entry point ──────────────────────────────────────────────────────


def run(root) -> tuple[list, int]:
    root = Path(root)
    findings = []
    findings += check_table(root)
    findings += check_jit_construction(root)
    findings += check_call_sites(root)
    findings += check_dtype(root)
    return findings, len(JIT_TABLE)
