"""PROTOCOL_TABLE: the declarative registry of distributed-protocol
invariants.

A copy of ``vainplex_openclaw_tpu/analysis/proto_table.py`` with every
row pointed at the port's own cluster, storage and batching modules.

graftlint's lock passes are driven by the guarded-state table in
:mod:`.locks`; tracelint's passes by :mod:`.jit_table`. The protolint
passes (:mod:`.proto`, :mod:`.explore`) are driven by this table: one row
per *invariant site* of the cluster's coordination protocols — epoch-fenced
leases, hibernation wake-fencing, drain→barrier→regrant→resume handoff and
supervisor adoption. The invariant CATALOG the rows implement:

- **epoch-monotonic** (GL-PROTO-EPOCH) — epochs are staleness *order*, not
  identity tokens: every epoch comparison against the durable fence (or a
  lease snapshot standing in for it) must be ordered (``<``/``<=``/``>``/
  ``>=``), never ``==``/``!=``. An equality check silently inverts when a
  workspace moves twice — exactly the schedule chaos seeds rarely produce.
- **fence-before-write** (GL-PROTO-FENCE) — no ``Journal`` wal/legacy-file
  write path may be reachable without the commit-lock fence re-read
  (``_fence_ok``/``_fenced``). Helpers whose *callers* own the gate are
  declared with a rationale, the reviewable artifact.
- **barrier-before-regrant** (GL-PROTO-ORDER) — a planned handoff may not
  regrant (epoch++/fence, the commit point) until the source's
  ``release_workspace`` barrier returned; and every failover-shaped grant
  must precede the new owner's ``add_workspace`` recovery, which must
  precede traffic.
- **ack-after-commit** (GL-PROTO-ACK) — route-log sequence numbers are
  released only after the journal group-commit that makes their effects
  durable; the supervisor's acked watermark only ever advances through an
  ordered comparison.
- **wake-refences** (GL-PROTO-ORDER) — any journal open on a sharded
  workspace (first recovery, hibernation wake, takeover adoption) re-arms
  the fence before traffic; a fresh instance that knows nothing about the
  lease is the zombie-writer back door hibernation would open.

The static passes enforce the *discipline* at the table's sites; the
:data:`EXPLORER_CONFIGS` at the bottom name the small configurations the
interleaving explorer (:mod:`.explore`) enumerates *exhaustively*,
asserting the same catalog at every step of every schedule — the runtime
half, armed in CI like the LockOrderWitness and RetraceWitness. A table
row matching nothing in the source is reported stale, exactly like a stale
baseline entry.
"""

from __future__ import annotations

from dataclasses import dataclass, field

_PKG = "vainplex_openclaw_tpu_torch"


@dataclass(frozen=True)
class EpochRule:
    """Modules whose epoch comparisons must be ordered, with declared
    equality exemptions ``((qualname, rationale), …)`` — an identity check
    that is provably not a staleness check may be exempted, and an empty
    rationale is itself a finding."""

    module: str
    exempt: tuple = field(default_factory=tuple)


@dataclass(frozen=True)
class FenceRule:
    """One journal-shaped class: methods that perform wal/legacy writes
    must contain a fence check lexically before the write, or be declared
    a ``guarded`` helper (callers own the gate) with a rationale."""

    module: str
    cls: str
    # Call names that ARE writes at the journal/legacy boundary
    # (``replace``/``unlink`` cover the rename-commit and segment-drop
    # halves of the atomic-write discipline).
    write_calls: tuple = ("_write_text_atomic", "write_json_atomic", "sink",
                          "replace", "unlink")
    # First-arg literals that make a write_with_faults(...) call a write.
    write_fault_sites: tuple = ("journal.append",)
    # Attribute reads / call names that count as the fence check.
    fence_checks: tuple = ("_fenced", "_fence_ok")
    guarded: tuple = field(default_factory=tuple)  # ((method, rationale), …)


@dataclass(frozen=True)
class OrderRule:
    """Within ``qualname``, require ≥1 call of ``then`` at-or-after the
    first call of ``first``; with ``forbid_early``, additionally flag any
    ``then`` call before the first ``first``. First-occurrence lexical
    order is this pass's documented granularity — the explorer owns the
    dynamic truth."""

    module: str
    qualname: str           # Class.method
    first: str              # called attribute / name
    then: str
    forbid_early: bool = False
    invariant: str = "barrier-before-regrant"


@dataclass(frozen=True)
class AckRule:
    """Ack-protocol site checks (GL-PROTO-ACK). Kinds:

    - ``commit-before-release``: the function must call ``commit`` and no
      non-empty ``return`` may precede the first commit call;
    - ``monotonic-watermark``: the function must guard its watermark store
      with an ordered comparison mentioning the watermark attribute."""

    module: str
    qualname: str
    kind: str
    attr: str = "_acked"    # watermark attribute (monotonic-watermark)


# ── the protocol table — seeded from the real sites ──────────────────
# To declare a new site: add a row, run the analysis module, and either
# fix or baseline (with rationale) what it flags.

PROTO_MODULES: tuple = (
    f"{_PKG}/cluster/supervisor.py",
    f"{_PKG}/cluster/worker.py",
    f"{_PKG}/cluster/ring.py",
    f"{_PKG}/cluster/fleet.py",
    f"{_PKG}/storage/journal.py",
    f"{_PKG}/storage/lifecycle.py",
)

EPOCH_RULES: tuple = tuple(EpochRule(module=m) for m in PROTO_MODULES)

FENCE_RULES: tuple = (
    FenceRule(
        module=f"{_PKG}/storage/journal.py", cls="Journal",
        guarded=(
            ("_write_meta",
             "persists watermarks for records already committed/compacted; "
             "every caller (commit/_ship_locked/_maybe_rotate/close) holds "
             "the commit lock and re-checked the fence, and a stale meta "
             "only re-replays idempotent records"),
            ("_demote_segment",
             "moves fully-committed rotated bytes between tiers (no new "
             "records); reachable only from rotation/ship paths that "
             "already re-checked the fence under the commit lock"),
            ("_cap_cold_tier",
             "unlinks oldest cold segments (drop, not write) from the "
             "fence-gated rotation path"),
            ("_maybe_rotate",
             "rotation only runs with everything compacted, from "
             "commit/compact/_ship_locked after their fence checks; the "
             "meta write it performs covers only committed watermarks"),
        ),
    ),
)

ORDER_RULES: tuple = (
    # barrier-before-regrant: the handoff's epoch++/fence commit point may
    # not precede the source's release barrier.
    OrderRule(f"{_PKG}/cluster/supervisor.py", "ClusterSupervisor.handoff",
              first="release_workspace", then="grant", forbid_early=True,
              invariant="barrier-before-regrant"),
    # fence-before-traffic: every failover-shaped grant precedes the new
    # owner's recovery, which precedes delivery.
    OrderRule(f"{_PKG}/cluster/supervisor.py", "ClusterSupervisor.failover",
              first="grant", then="add_workspace", forbid_early=True,
              invariant="fence-before-traffic"),
    OrderRule(f"{_PKG}/cluster/supervisor.py",
              "ClusterSupervisor._ensure_owner",
              first="grant", then="add_workspace", forbid_early=True,
              invariant="fence-before-traffic"),
    OrderRule(f"{_PKG}/cluster/supervisor.py",
              "ClusterSupervisor._adopt_cluster",
              first="grant", then="add_workspace", forbid_early=True,
              invariant="fence-before-traffic"),
    # wake-refences: any tracker/journal open on a sharded workspace is
    # followed by a fence re-arm before the method returns to traffic.
    OrderRule(f"{_PKG}/cluster/worker.py",
              "InProcessWorker._ensure_workspace_awake",
              first="trackers", then="set_fence",
              invariant="wake-refences"),
    OrderRule(f"{_PKG}/cluster/worker.py", "InProcessWorker.add_workspace",
              first="trackers", then="set_fence",
              invariant="wake-refences"),
    # the release barrier must reach the ack boundary before the workspace
    # leaves this worker's shard.
    OrderRule(f"{_PKG}/cluster/worker.py",
              "InProcessWorker.release_workspace",
              first="_ack", then="pop", forbid_early=True,
              invariant="barrier-before-regrant"),
    # lease durability precedes the fence stamp (the fence is only
    # meaningful if the epoch it advertises is recoverable).
    OrderRule(f"{_PKG}/cluster/ring.py", "LeaseTable.grant",
              first="commit", then="write_fence", forbid_early=True,
              invariant="fence-before-traffic"),
    # drain-before-retire: a planned replica scale-down must
    # serve everything the replica already accepted BEFORE unregistering
    # and closing it — flipping the order strands accepted requests
    # exactly like the pre-fleet process-global teardown did.
    OrderRule(f"{_PKG}/cluster/fleet.py", "ReplicaFleet.retire_replica",
              first="_drain_replica", then="_unregister", forbid_early=True,
              invariant="drain-before-retire"),
    # worker retirement drains its resident replicas before workspace
    # handoff begins — the fleet side of the same invariant.
    OrderRule(f"{_PKG}/cluster/supervisor.py",
              "ClusterSupervisor.retire_worker",
              first="drain_worker", then="handoff", forbid_early=True,
              invariant="drain-before-retire"),
    # Hot weight swap: the swap protocol's legs are strictly
    # drain → place → resume. Placing before the open bucket window is
    # drained would mix versions inside one batch; resuming (flipping the
    # active pointer) before the new version's params are placed would
    # stall the first post-swap batch on a cold weight copy — exactly the
    # serving-path cost the hot swap exists to avoid.
    OrderRule(f"{_PKG}/models/batching.py", "ContinuousBatcher.swap_to",
              first="_swap_drain", then="_swap_place", forbid_early=True,
              invariant="drain-before-place"),
    OrderRule(f"{_PKG}/models/batching.py", "ContinuousBatcher.swap_to",
              first="_swap_place", then="_swap_resume", forbid_early=True,
              invariant="place-before-resume"),
)

ACK_RULES: tuple = (
    # The port's _ack keeps JAX's shape and adds one release: when a
    # commit fails it reports the seqs of the workspaces whose journals
    # DID commit (JAX withholds them, and a crash then applies their ops
    # twice). Every return that carries seqs still follows the commit
    # loop, which is what this row checks.
    AckRule(f"{_PKG}/cluster/worker.py", "InProcessWorker._ack",
            kind="commit-before-release"),
    AckRule(f"{_PKG}/cluster/supervisor.py", "ClusterSupervisor._note_ack",
            kind="monotonic-watermark", attr="_acked"),
    # The fleet's request watermark advances exactly like the
    # supervisor's: min(inflight)-1, stored behind an ordered guard.
    AckRule(f"{_PKG}/cluster/fleet.py", "ReplicaFleet._reap",
            kind="monotonic-watermark", attr="_acked"),
)


# ── explorer configurations (the runtime half's bounded universe) ────
# Each entry is exhaustively enumerated by analysis/explore.py: every
# interleaving of the client-op streams with the control steps, invariants
# asserted after every step, one replayable schedule string per run.
# Control tokens: P = partition failover of A's owner (worker stays alive:
# the zombie shape) · K = crash A's owner, then tick-detect · H = planned
# handoff of A · S = hibernate A on its owner (journal close; next op is
# the wake) · Z = stale-epoch zombie commit probe · G = supervisor
# generation switch (abandon gen-1 uncleanly, adopt with gen-2).

@dataclass(frozen=True)
class ExplorerConfig:
    name: str
    workspaces: tuple               # ws labels, each an ordered op stream
    ops: tuple                      # ops per workspace (same order)
    controls: tuple                 # control tokens, mutually ordered
    workers: int = 2
    ack_every: int = 2
    # ((site, step_ordinal), …): FaultSpec armed for the whole schedule.
    faults: tuple = ()
    # Ops after the G token run on the adopted generation-2 supervisor.
    adoption: bool = False
    # Streams that provably commute (pinned to disjoint workers by a
    # pre-grant): adjacent B-before-A orders are skipped as equivalent —
    # the DPOR-lite reduction; () explores the full interleaving set.
    commuting: tuple = ()


EXPLORER_CONFIGS: tuple = (
    ExplorerConfig("failover-partition", workspaces=("A",), ops=(3,),
                   controls=("P", "Z")),
    ExplorerConfig("failover-crash", workspaces=("A",), ops=(3,),
                   controls=("K",)),
    ExplorerConfig("failover-2ws", workspaces=("A", "B"), ops=(2, 2),
                   controls=("K",)),
    ExplorerConfig("handoff", workspaces=("A",), ops=(3,),
                   controls=("H",)),
    ExplorerConfig("handoff-barrier-fault", workspaces=("A",), ops=(3,),
                   controls=("H",),
                   faults=(("cluster.handoff.barrier", 1),)),
    ExplorerConfig("hibernate-wake", workspaces=("A",), ops=(3,),
                   controls=("S", "Z")),
    ExplorerConfig("adoption", workspaces=("A",), ops=(4,),
                   controls=("G", "Z"), adoption=True),
)


def explorer_config(name: str) -> ExplorerConfig:
    for cfg in EXPLORER_CONFIGS:
        if cfg.name == name:
            return cfg
    raise KeyError(f"unknown explorer config {name!r} "
                   f"(have: {[c.name for c in EXPLORER_CONFIGS]})")
