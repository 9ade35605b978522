"""Lock-discipline checker: the guarded-state table, machine-enforced.

A copy of ``vainplex_openclaw_tpu/analysis/locks.py`` with one
:data:`GUARDED` row per JAX row, each pointed at the port's module and
class; where the port's class differs from JAX's, the row says how.

Seven PRs of threading grew invariants that lived only in comments — "the
index bookkeeping must not interleave", "guarded by ``_facts_lock``" — and
a comment cannot fail CI when a new method forgets the ``with``. This pass
turns each of those comments into a row of :data:`GUARDED`: a class, its
locks, and the attributes each lock protects. The AST checker then flags

- **GL-LOCK-GUARD** — a read or write of a guarded attribute outside a
  ``with self.<lock>`` scope and outside the method's declared-holder set
  (``holders`` lists methods whose CALLERS hold the lock — ``_index`` is
  only ever called under ``_facts_lock``; the declaration is itself
  reviewable, which is the point);
- **GL-LOCK-BLOCKING** — a blocking call (fsync / file I/O / sleep /
  regex scan) made while a **hot** lock is held. Hot locks sit on serving
  paths where every microsecond under the lock is convoy time for other
  threads. The journal's ``_commit_lock`` is deliberately NOT hot:
  blocking under it IS the design (group commit amortizes the fsync all
  writers are waiting for), so it appears in specs without a ``hot``
  entry, the table-level equivalent of an allowlist.

Scope and honesty: the checker sees ``self.<attr>`` accesses lexically.
It does not do interprocedural alias analysis — state reached through
local variables (``st = self._streams[name]; st.pending…``) is out of
scope, and a closure defined under a ``with`` but *called* later reads as
guarded. The table buys precision where the real races live (the
collections and compound state the serving threads share) and the
runtime lock-order witness covers what static scoping cannot.

``attrs`` guards reads AND writes; ``write_only`` attrs flag writes only
(single-slot scalars whose torn reads are documented-tolerable; listing
them here rather than baselining every reader keeps intent in one place).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import Path

from .findings import Finding

# Direct calls considered blocking for GL-LOCK-BLOCKING. Names are matched
# on the called attribute (``x.fsync(…)``) or bare name (``open(…)``) —
# deliberately syntactic: a rename that hides I/O behind a helper also
# moves it out of the lock's lexical scope, which is reviewable.
BLOCKING_CALL_ATTRS = frozenset({
    "fsync", "sleep", "write", "flush", "read", "readline", "readlines",
    "open", "unlink", "rename", "replace", "mkdir", "rmdir", "stat",
    "read_text", "write_text", "read_bytes", "write_bytes",
    "search", "match", "fullmatch", "sub", "subn", "findall", "finditer",
})
BLOCKING_CALL_NAMES = frozenset({"open", "print"})

# Builtins that call a lambda argument synchronously: a key= lambda under a
# lock runs under that lock. Anything else taking a callable (Timer,
# save_debounced, executor.submit) is assumed to DEFER it.
INLINE_CALLABLES = frozenset({
    "sorted", "min", "max", "map", "filter", "any", "all", "sum", "list",
    "tuple", "set", "next",
})


@dataclass(frozen=True)
class GuardSpec:
    """One guarded class: which lock protects which attributes."""

    module: str                           # repo-relative, forward slashes
    cls: str
    locks: dict                           # lock attr -> tuple of guarded attrs
    write_only: tuple = ()                # subset of attrs: writes only
    holders: dict = field(default_factory=dict)   # method -> locks held by caller
    init_only: tuple = ()                 # construction-time methods, exempt
    hot: tuple = ()                       # locks that must not cover blocking calls
    allow_blocking: tuple = ()            # methods exempt from the hot rule


# ── the guarded-state table ──────────────────────────────────────────
# Seeded from the real sites. To declare a new guarded attribute: add it
# to its lock's tuple (or a new GuardSpec row), run
# ``python -m vainplex_openclaw_tpu_torch.analysis``, and either fix or
# baseline (with rationale) what it flags.

GUARDED: tuple = (
    GuardSpec(
        module="vainplex_openclaw_tpu_torch/storage/journal.py", cls="Journal",
        locks={
            "_buffer_lock": ("_pending_records", "_appends_since_commit",
                             "_timer_handle", "_streams"),
            "_commit_lock": ("_marks", "_fh", "_wal_bytes", "_gen",
                             "_meta_dirty", "_wal_tail_dirty",
                             "_fenced", "fence_rejected", "fence_path",
                             "fence_epoch", "_records_since_ship", "ships",
                             "ship_failures", "cold_demoted", "cold_dropped",
                             "demote_failures", "_demote_backlog"),
        },
        # _streams: registration writes race _drain_pending's iteration;
        # point reads (dict probe) are GIL-atomic and stay unflagged.
        # _wal_bytes/_gen: stats() reads are documented torn-tolerant.
        # fence state: written only under the commit lock
        # (set_fence / the commit-time check); append's fast-path read of
        # _fenced and stats()' counter reads are torn-tolerant scalars.
        # lifecycle state: ship/demote counters and the demote
        # backlog are commit-lock-owned; _lifecycle_stats()' reads are
        # torn-tolerant scalars/len probes, declared write_only like the
        # other stats counters.
        write_only=("_streams", "_wal_bytes", "_gen",
                    "_fenced", "fence_rejected", "fence_path", "fence_epoch",
                    "_records_since_ship", "ships", "ship_failures",
                    "cold_demoted", "cold_dropped", "demote_failures",
                    "_demote_backlog"),
        holders={
            "_open": ("_commit_lock",),
            # _open-only recovery helpers (construction-time, like _open).
            "_replay_record": ("_commit_lock",),
            "_rehydrate_cold": ("_commit_lock",),
            "_adopt_recovered": ("_commit_lock",),
            "_spill_locked": ("_commit_lock", "_buffer_lock"),
            "_write_meta": ("_commit_lock",),
            "_maybe_rotate": ("_commit_lock",),
            # Lifecycle: ship/demote run only from commit(),
            # compact()-adjacent paths and _maybe_rotate — all commit-lock
            # holders.
            "_ship_locked": ("_commit_lock",),
            "_demote_segment": ("_commit_lock",),
            "_retry_demotes": ("_commit_lock",),
            "_cap_cold_tier": ("_commit_lock",),
            # commit() takes _commit_lock via acquire()/release() (the
            # non-blocking group_wait probe needs the manual form).
            "commit": ("_commit_lock",),
        },
        init_only=("_open", "_replay_record", "_rehydrate_cold"),
        hot=("_buffer_lock",),
    ),
    GuardSpec(
        module="vainplex_openclaw_tpu_torch/knowledge/fact_store.py", cls="FactStore",
        locks={"_facts_lock": ("facts", "_content_index", "_lower")},
        holders={
            "_index": ("_facts_lock",),
            "_unindex": ("_facts_lock",),
            "_prune": ("_facts_lock",),
            "_commit": ("_facts_lock",),
        },
        hot=("_facts_lock",),
        # load() reads facts.json under the lock once at startup — blocking
        # there is serialization of first use, not a serving-path convoy.
        # hibernate() flushes under the lock for the same
        # reason inverted: eviction is an idle-path event, and releasing
        # the lock mid-evict lets a reload race the clear.
        allow_blocking=("load", "hibernate"),
    ),
    GuardSpec(
        module="vainplex_openclaw_tpu_torch/knowledge/embeddings.py",
        cls="LocalEmbeddings",
        locks={
            "_lock": ("_arena", "_size", "_ids", "_pos", "_docs",
                      "_query_cache", "query_cache_hits", "query_cache_misses",
                      # mesh serving: the committed device arena copy + its
                      # dirty flag ride the same lock — a sync's in-place
                      # mutation must not race a search's commit.
                      "_device_arena", "_device_arena_rows", "_arena_dirty"),
            # write-once lazy init: unguarded reads after init are safe.
            # The port keeps one slot where JAX keeps two: its forward
            # runs eagerly on the device, so there is no jitted callable
            # (JAX's _forward_jit) to cache beside the (cfg, params) pair.
            "_init_lock": ("_model",),
        },
        write_only=("_model",),
        holders={"_reserve": ("_lock",), "_scores": ("_lock",)},
    ),
    GuardSpec(
        module="vainplex_openclaw_tpu_torch/resilience/admission.py",
        cls="AdmissionController",
        locks={"_lock": ("_window", "_window_counts", "queue_depth",
                         "max_queue_depth", "admitted", "shed",
                         "shed_by_tenant")},
        holders={
            "_record_admit": ("_lock",),
            "_record_shed": ("_lock",),
        },
        hot=("_lock",),
    ),
    GuardSpec(
        module="vainplex_openclaw_tpu_torch/utils/stage_timer.py", cls="StageTimer",
        locks={"_lock": ("_ms", "_counts", "_hist")},
        hot=("_lock",),
    ),
    GuardSpec(
        module="vainplex_openclaw_tpu_torch/resilience/faults.py", cls="FaultPlan",
        locks={"_lock": ("fired", "_calls", "_rngs")},
        holders={"_rng": ("_lock",)},
        hot=("_lock",),
    ),
    GuardSpec(
        module="vainplex_openclaw_tpu_torch/storage/atomic.py", cls="Debouncer",
        locks={"_lock": ("_timer", "_pending")},
        hot=("_lock",),
    ),
    # Cluster classes: the supervisor's bookkeeping is read by
    # sitrep/status threads while the dispatch path mutates it, and the
    # lease table is the fencing source of truth — both hot (delivery and
    # lease grants must never convoy behind blocking work under the lock;
    # journal/fence I/O happens outside the critical sections).
    # Handoff/admission state: the handoff record list and the
    # abort/shed counters join the same dispatch lock; the ack-watermark
    # publish throttle (_ack_unpub) is mutated inside _note_ack's critical
    # section, with the actual transport publish deliberately OUTSIDE it.
    GuardSpec(
        module="vainplex_openclaw_tpu_torch/cluster/supervisor.py",
        cls="ClusterSupervisor",
        locks={"_lock": ("_workers", "_acked", "_ack_unpub", "_inflight",
                         "_backlog", "_failovers", "_handoffs", "_retired",
                         "routed", "redelivered", "route_faults",
                         "handoff_aborts", "ingress_shed")},
        hot=("_lock",),
    ),
    GuardSpec(
        module="vainplex_openclaw_tpu_torch/cluster/ring.py", cls="LeaseTable",
        locks={"_lock": ("_leases",)},
        hot=("_lock",),
    ),
    # Replica fleet: the routing table, in-flight/watermark
    # bookkeeping, latency window, and autoscaler state share one hot lock
    # on the request path — batcher enqueue/step, route-log publishes, and
    # result callbacks all deliberately run OUTSIDE it.
    GuardSpec(
        module="vainplex_openclaw_tpu_torch/cluster/fleet.py", cls="ReplicaFleet",
        locks={"_lock": ("_replicas", "_inflight", "_acked", "_ack_unpub",
                         "_last_seq", "_next_idx", "_lat_window",
                         "_decisions", "_scale_events", "_failovers",
                         "_retired", "_ops_since_eval", "_cooldown",
                         "routed", "served", "shed", "redelivered")},
        hot=("_lock",),
    ),
    # Workspace lifecycle: recency bookkeeping is read by the
    # ingest path per message — hot, and eviction callbacks (journal close,
    # tracker flush: blocking I/O) deliberately run OUTSIDE it.
    GuardSpec(
        module="vainplex_openclaw_tpu_torch/storage/lifecycle.py",
        cls="LifecycleManager",
        locks={"_lock": ("_resident", "_owners", "_timers", "_sleeping",
                         "wakes", "evictions", "hibernate_failures")},
        hot=("_lock",),
    ),
    # Versioned model registry: the version book, active/canary
    # pointers, tenant pins, the shadow ring, and swap counters are read on
    # the request path (resolve per enqueue, checkout per batch) — hot, and
    # all device/disk work (weight placement, checkpoint loads, placement-cache
    # eviction) deliberately runs OUTSIDE the critical sections.
    GuardSpec(
        module="vainplex_openclaw_tpu_torch/models/registry.py",
        cls="ModelRegistry",
        locks={"_lock": ("_versions", "_placed", "_active", "_previous",
                         "_canary", "_canary_fraction", "_pins", "_shadow",
                         "_resolved", "swaps", "rollbacks", "promotions")},
        hot=("_lock",),
    ),
)


def _self_attr(node) -> str:
    """'X' for an ``self.X`` attribute node, else ''."""
    if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return ""


class _MethodChecker(ast.NodeVisitor):
    """Walks ONE method body tracking the lexically-held lock set."""

    def __init__(self, spec: GuardSpec, method: str, path: str,
                 findings: list):
        self.spec = spec
        self.method = method
        self.path = path
        self.findings = findings
        self.attr_lock = {a: lk for lk, attrs in spec.locks.items()
                          for a in attrs}
        self.held: list[str] = list(spec.holders.get(method, ()))
        self.exempt = (method == "__init__" or method in spec.init_only)

    # ── lock scopes ──────────────────────────────────────────────────

    def visit_With(self, node: ast.With) -> None:
        added = []
        for item in node.items:
            self.visit(item.context_expr)  # the lock attr read itself
            name = _self_attr(item.context_expr)
            if name in self.spec.locks:
                self.held.append(name)
                added.append(name)
            if item.optional_vars is not None:
                self.visit(item.optional_vars)
        for stmt in node.body:
            self.visit(stmt)
        for name in added:
            self.held.remove(name)

    visit_AsyncWith = visit_With

    # ── deferred execution ───────────────────────────────────────────
    # A lambda / nested def runs when CALLED, not where written: a closure
    # built under a lock and handed to a timer or debouncer executes on
    # another thread with no lock held. Its body therefore inherits
    # NOTHING — not the lexical ``with`` scope, not the holder
    # declaration. (Comprehensions execute inline and keep the scope.)

    def _visit_deferred(self, node) -> None:
        saved, self.held = self.held, []
        saved_exempt, self.exempt = self.exempt, False
        try:
            if isinstance(node, ast.Lambda):
                self.visit(node.body)
            else:
                for stmt in node.body:
                    self.visit(stmt)
        finally:
            self.held = saved
            self.exempt = saved_exempt

    def visit_Lambda(self, node: ast.Lambda) -> None:
        self._visit_deferred(node)

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._visit_deferred(node)

    visit_AsyncFunctionDef = visit_FunctionDef

    # ── guarded attribute accesses ───────────────────────────────────

    def _flag(self, node, attr: str, access: str) -> None:
        lock = self.attr_lock[attr]
        self.findings.append(Finding(
            "GL-LOCK-GUARD", self.path, node.lineno,
            f"{self.spec.cls}.{self.method} {access}s self.{attr} without "
            f"holding self.{lock}",
            detail=f"{self.spec.cls}.{self.method}:{attr}"))

    def _check(self, node, attr: str, is_write: bool) -> None:
        if self.exempt or attr not in self.attr_lock:
            return
        if not is_write and attr in self.spec.write_only:
            return
        if self.attr_lock[attr] in self.held:
            return
        self._flag(node, attr, "write" if is_write else "read")

    def _visit_target(self, node) -> None:
        """Assignment-target subtree: self.X and self.X[...] are writes of
        X; everything nested deeper (subscript keys, starred values) reads."""
        attr = _self_attr(node)
        if attr:
            self._check(node, attr, is_write=True)
            return
        if isinstance(node, ast.Subscript):
            base_attr = _self_attr(node.value)
            if base_attr:
                # self.X[k] = v mutates the container behind self.X
                self._check(node.value, base_attr, is_write=True)
            else:
                self.visit(node.value)
            self.visit(node.slice)
            return
        if isinstance(node, (ast.Tuple, ast.List)):
            for elt in node.elts:
                self._visit_target(elt)
            return
        if isinstance(node, ast.Starred):
            self._visit_target(node.value)
            return
        self.visit(node)

    def visit_Assign(self, node: ast.Assign) -> None:
        for target in node.targets:
            self._visit_target(target)
        self.visit(node.value)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._visit_target(node.target)  # read-modify-write: write dominates
        self.visit(node.value)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        self._visit_target(node.target)
        if node.value is not None:
            self.visit(node.value)

    def visit_Delete(self, node: ast.Delete) -> None:
        for target in node.targets:
            self._visit_target(target)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        attr = _self_attr(node)
        if attr:
            self._check(node, attr, is_write=False)
        self.generic_visit(node)

    # ── blocking calls under hot locks ───────────────────────────────

    def visit_Call(self, node: ast.Call) -> None:
        hot_held = [lk for lk in self.held if lk in self.spec.hot]
        if hot_held and self.method not in self.spec.allow_blocking:
            name = None
            if isinstance(node.func, ast.Attribute):
                if node.func.attr in BLOCKING_CALL_ATTRS:
                    name = node.func.attr
            elif isinstance(node.func, ast.Name):
                if node.func.id in BLOCKING_CALL_NAMES:
                    name = node.func.id
            if name is not None:
                self.findings.append(Finding(
                    "GL-LOCK-BLOCKING", self.path, node.lineno,
                    f"{self.spec.cls}.{self.method} calls blocking "
                    f"{name}() while holding hot lock "
                    f"self.{hot_held[0]}",
                    detail=f"{self.spec.cls}.{self.method}:{name}"))
        if (isinstance(node.func, ast.Name)
                and node.func.id in INLINE_CALLABLES):
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                if isinstance(arg, ast.Lambda):
                    self.visit(arg.body)  # runs inline: scope applies
                else:
                    self.visit(arg)
            return
        self.generic_visit(node)


def check_class(tree: ast.Module, spec: GuardSpec, path: str) -> list:
    findings: list = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.ClassDef) and node.name == spec.cls):
            continue
        for item in node.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                _MethodChecker(spec, item.name, path, findings).generic_visit(item)
        break
    return findings


def check_module_source(source: str, path: str, specs) -> list:
    """Fixture-corpus entry point: run the given specs over raw source."""
    tree = ast.parse(source)
    out: list = []
    for spec in specs:
        out.extend(check_class(tree, spec, path))
    return out


def run(root: str | Path, specs=GUARDED) -> tuple[list, int]:
    """(findings, files_scanned) for every spec'd module under ``root``."""
    root = Path(root)
    findings: list = []
    scanned = 0
    for spec in specs:
        path = root / spec.module
        if not path.exists():
            findings.append(Finding(
                "GL-LOCK-GUARD", spec.module, 1,
                f"guarded module missing: {spec.module} (table is stale)",
                detail=f"missing:{spec.module}"))
            continue
        scanned += 1
        tree = ast.parse(path.read_text(encoding="utf-8"))
        findings.extend(check_class(tree, spec, spec.module))
    return findings, scanned
