"""Cluster workers: the real Gateway, sharded by workspace.

A copy of ``vainplex_openclaw_tpu/cluster/worker.py`` under the same names,
on the port's own ``Gateway``, ``GovernancePlugin``, ``CortexPlugin``,
journal registry, fault sites and ``utils/ids``, so the port imports
nothing of the JAX package.

A worker is a full serving stack — governance enforcement + redaction over
its own root, cortex conversation intelligence per tenant workspace — fed
ops by the supervisor and answering with verdict observations. Two shapes
share one contract:

- :class:`InProcessWorker` — the worker pipeline in the supervisor's
  process. This is the deterministic shape: a settable virtual clock, per-op
  id seeding, and seeded fault sites (``cluster.worker.crash``,
  ``cluster.heartbeat``) make a worker-kill storm bit-reproducible, which is
  what lets the chaos suite compare a crashed-and-recovered cluster against
  a never-crashed oracle byte for byte.
- :class:`ProcessWorker` — a real ``multiprocessing.Process`` (stdlib only,
  same discipline as the rest of the repo) speaking over queues: ops in,
  results/acks/heartbeats out. This is the shape the scaling bench runs; a
  ``kill()`` here is a real SIGKILL and failover detection rides
  ``Process.is_alive`` + the heartbeat deadline. A child never touches the
  card: it builds its worker with no ``serve_cfg``.

**The ack protocol is the durability boundary.** A worker acks a batch of
route-log sequence numbers only after group-committing every workspace
journal it touched since the previous ack. The supervisor replays
everything past the acked watermark to the new owner after a failover, and
a crash loses only journal-*buffered* (never committed, never acked)
records — so redelivery is effectively exactly-once: the recovered state
contains an op's effects iff that op was acked, and exactly the un-acked
ops are redelivered.

What the port changes, each a deliberate deviation pinned by a test:

- ``build_worker_gateway(..., serve_cfg, device)`` builds the replica
  batcher from the port's ``shared_batcher`` on ``device`` (None = the
  card), and raises where ``serve_cfg`` is given but no checkpoint is
  servable: the JAX package skips the batcher there, with a log line only
  when a logger was passed. A caller that wants no batcher passes
  ``serve_cfg=None``.
- ``InProcessWorker.stop`` drains its own batcher scope through
  ``close_batchers``, which lets a device error
  (``device.is_device_error``) out instead of swallowing it.
- ``InProcessWorker._ack`` releases the seqs whose workspace journal
  committed even when another journal's commit failed. The JAX package
  releases none then, so a crash before the next boundary both replays
  those ops' records from the wal and redelivers the ops: their effects
  land twice.
- :func:`mp_context` takes ``spawn`` whenever this process has initialised
  CUDA: a ``fork`` of a process holding a CUDA context gives a child that
  cannot use it, and the fleet's collector threads make ``fork`` unsafe
  besides.
"""

from __future__ import annotations

import os
import time
from pathlib import Path
from typing import Any, Callable, Optional

from ..device import DeviceLike
from ..resilience.faults import FaultError, maybe_fail
from ..storage.journal import peek_journal
from ..utils import ids
from .ring import FENCE_FILE

# One literal per fault site, so a scan of the package's sources finds the
# cluster's injection points:
#   cluster.worker.crash — worker dies at a seeded delivery step
#   cluster.heartbeat    — a heartbeat probe is lost (partition)
#   cluster.recover      — workspace recovery on the new owner fails once
#   cluster.route        — transient routing fault in the supervisor
#   cluster.lease        — lease/fence persistence fault (ring.py)
# Planned-handoff stages (supervisor.py): drain/barrier/regrant
# faults abort the handoff cleanly pre-grant; resume faults are retried
# post-grant like failover recovery:
#   cluster.handoff.drain / cluster.handoff.barrier /
#   cluster.handoff.regrant / cluster.handoff.resume


class WorkerCrashed(RuntimeError):
    """Raised by a dead worker handle; the supervisor's failover trigger."""


def dispatch_op(gw, kind: str, content: str, ctx: dict) -> dict:
    """Run one workload op through a gateway; returns verdict-path
    observations. Shared by the SLO harness and the cluster workers — one
    implementation, so the single-process and sharded paths can never
    disagree about what an op *is*."""
    if kind == "msg_in":
        gw.message_received(content, ctx)
        return {}
    if kind == "msg_out":
        gw.message_sent(content, ctx)
        return {}
    if kind == "tool_ok" or kind == "tool_denied":
        decision, _ = gw.run_tool("read", {"path": content},
                                  lambda p: f"contents of {content}", ctx)
        return {"blocked": decision.blocked}
    # tool_secret: result must come back redacted (NEVER_SHED path)
    out = gw.tool_result_persist("exec", content, ctx)
    return {"redacted": isinstance(out, str) and "[REDACTED" in out}


def build_worker_gateway(worker_root: str | Path, worker_id: str,
                         clock: Callable[[], float] = time.time,
                         wall_timers: bool = True,
                         journal_cfg: Any = True, lifecycle_cfg: Any = True,
                         logger=None, serve_cfg: Optional[dict] = None,
                         device: DeviceLike = None):
    """The standard worker profile: governance (credential guard +
    redaction, audit at the worker root) + cortex (per-tenant trackers over
    the shared workspace journals). Stage-timer keys carry the worker's
    prefix so merged cluster views stay attributable. With ``serve_cfg``
    the worker owns a replica batcher on ``device`` (None = the card), and
    a ``serve_cfg`` whose checkpoint is not servable raises
    ``FileNotFoundError``."""
    from ..core import Gateway
    from ..cortex import CortexPlugin
    from ..governance import GovernancePlugin

    root = Path(worker_root)
    root.mkdir(parents=True, exist_ok=True)
    config = {"workspace": str(root), "agents": [{"id": worker_id}],
              "cluster": {"workerPrefix": f"{worker_id}:"}}
    kwargs = {} if clock is time.time else {"clock": clock}
    gw = Gateway(config=config, logger=logger, **kwargs)
    gov = GovernancePlugin(workspace=str(root), device=device, **kwargs)
    gw.load(gov, plugin_config={
        "redaction": {"enabled": True},
        "builtinPolicies": {"credentialGuard": True,
                            "rateLimiter": {"maxPerMinute": 10_000_000}},
        "storage": {"journal": journal_cfg},
    })
    cortex = CortexPlugin(wall_timers=wall_timers, device=device, **kwargs)
    gw.load(cortex, plugin_config={"languages": "all",
                                   "traceAnalyzer": {"enabled": False},
                                   "registerTools": False,
                                   # lifecycle: shipping keeps
                                   # per-tenant recovery O(wal tail) after a
                                   # worker death; hibernation bounds a
                                   # worker's resident tenant trackers.
                                   "storage": {"journal": journal_cfg,
                                               "lifecycle": lifecycle_cfg}})
    gw.start()
    if serve_cfg is not None:
        # Fleet serving: this worker OWNS a replica batcher out of the
        # scoped shared-batcher book, scope keyed to the worker id so
        # stop()/retirement closes exactly its own collector threads, never
        # a peer's. A worker without a model passes serve_cfg=None (the
        # fleet's injected-factory seam covers those); a serve_cfg with no
        # servable checkpoint is a configuration error, not a degrade.
        from ..config.loader import deep_merge
        from ..models.pretrained import available
        from ..models.serve import SERVE_DEFAULTS, shared_batcher

        merged = deep_merge(SERVE_DEFAULTS, serve_cfg)
        ckpt = merged.pop("checkpointDir", None)
        if not available(ckpt):
            gw.stop()
            raise FileNotFoundError(
                f"[cluster] worker {worker_id}: serve_cfg given but no "
                f"servable checkpoint at {ckpt or 'the shipped default'}; "
                "pass serve_cfg=None for a worker without a replica batcher")
        gw.serve_batcher = shared_batcher(
            ckpt, merged, scope=f"{worker_id}@{root}", device=device)
    return gw, cortex, gov


class InProcessWorker:
    """Deterministic in-process worker (chaos storms, slo --workers)."""

    sync = True

    def __init__(self, worker_id: str, root: str | Path,
                 clock: Callable[[], float] = time.time,
                 ack_every: int = 16, wall_timers: bool = True,
                 deterministic_ids: bool = False,
                 settable_clock: Any = None,
                 journal_cfg: Any = True, lifecycle_cfg: Any = True,
                 logger=None, gateway_builder: Optional[Callable] = None,
                 serve_cfg: Optional[dict] = None,
                 device: DeviceLike = None):
        self.worker_id = worker_id
        self.root = Path(root)
        # Registry scope for any serve batchers this worker's gateway owns:
        # stop() closes exactly this scope (drain first, so planned
        # retirement strands nothing); crash() deliberately leaves
        # it (a corpse's queue is redelivery's job, not teardown's).
        self.serve_scope = f"{worker_id}@{self.root}"
        self.clock = clock
        self.ack_every = max(1, int(ack_every))
        self.deterministic_ids = deterministic_ids
        self._settable_clock = settable_clock
        self.shard: dict[str, int] = {}  # ws -> lease epoch
        self.alive = True
        self.delivered = 0
        self.acked = 0
        self._since_ack: list[int] = []   # route-log seqs awaiting ack
        # per seq of _since_ack: its workspace, and whether a partial ack
        # already released it (see _ack)
        self._since_ack_ws: list[str] = []
        self._released_early: list[bool] = []
        self._touched: set[str] = set()   # workspaces dirty since last ack
        # Committed-and-acked seqs whose REPORT was lost to a failed
        # release barrier (the commit landed; the OSError preempted the
        # return) — they ride out with the next successful ack, or the
        # supervisor's _inflight entries for them would leak forever.
        self._unreported_acks: list[int] = []
        # gateway_builder is the protocol/payload seam: every
        # protocol-bearing method on this class (deliver/ack/fence/crash/
        # release) runs verbatim over whatever stack the builder returns;
        # an interleaving explorer substitutes a stub executor here so
        # exhaustive schedule enumeration doesn't pay a full
        # governance+cortex build per schedule.
        builder_kwargs = dict(
            clock=clock, wall_timers=wall_timers, journal_cfg=journal_cfg,
            lifecycle_cfg=lifecycle_cfg, logger=logger)
        if serve_cfg is not None and gateway_builder is None:
            # Only the default builder understands serve_cfg and device;
            # injected builders (a stub executor) keep their signature.
            builder_kwargs["serve_cfg"] = serve_cfg
            builder_kwargs["device"] = device
        self.gw, self.cortex, self.gov = (gateway_builder
                                          or build_worker_gateway)(
            self.root, worker_id, **builder_kwargs)

    # ── shard management ─────────────────────────────────────────────

    def add_workspace(self, ws: str, epoch: int) -> dict:
        """Own ``ws`` at lease ``epoch``: recover state by journal replay
        (tracker construction opens the workspace journal, which replays
        wal segments and completes crashed compactions BEFORE the tracker's
        load, the journal's contract), then arm the fence so this worker's own
        writes die cleanly if the lease ever moves on. Traffic for ``ws``
        must not be delivered before this returns."""
        maybe_fail("cluster.recover")
        # Takeover barrier: if a previous owner's journal instance is still
        # open in this process (partition-style failover — the worker was
        # presumed dead, not actually dead), adopt it at the new epoch,
        # DISCARD its un-acked buffer (the supervisor redelivers those ops
        # — committing them here would double-apply), and compact the
        # committed records so the files the trackers load reflect exactly
        # the acked prefix. A genuinely crashed owner's journal is
        # abandoned/closed instead, and the fresh open below replays its
        # wal — same end state, two routes.
        stale = peek_journal(ws)
        if stale is not None:
            try:
                stale.set_fence(Path(ws) / FENCE_FILE, epoch)
                stale.drop_pending()
                stale.compact()
            except OSError:
                pass  # failed compaction: recovery replay covers it
        trackers = self.cortex.trackers({"workspace": ws})
        journal = trackers.journal
        replay = {}
        if journal is not None:
            replay = dict(journal.stats()["replay"])
            journal.set_fence(Path(ws) / FENCE_FILE, epoch)
        self.shard[ws] = epoch
        return replay

    def drop_workspace(self, ws: str) -> None:
        self.shard.pop(ws, None)

    def release_workspace(self, ws: str) -> list:
        """Planned-handoff barrier, worker side: group-commit
        everything buffered (the ack boundary), then evict the workspace
        through the hibernation seam — flush, durable snapshot ship,
        journal close, tracker cache drop — so the legacy files ARE the
        state, the live wal is rotated empty (the target opens with **zero
        replay**), and this worker retains no stale tracker state to flush
        over the new owner's later. Raises on a failed ship so the
        supervisor aborts the handoff and this worker keeps serving."""
        acked = self._ack()
        try:
            if not self.cortex.release_workspace(ws):
                raise OSError("handoff barrier: release/ship failed")
            journal = peek_journal(ws)
            if journal is not None:
                # Non-cortex streams (audit, events) on a still-open
                # journal: ship them too so nothing is left to replay.
                ok = (journal.ship_snapshot()
                      if journal.lifecycle is not None else journal.compact())
                if not ok:
                    raise OSError(journal.last_error
                                  or "handoff barrier: snapshot ship failed")
        except OSError:
            # The group commit above already landed and cleared
            # _since_ack; losing these seqs with the raise would leak the
            # supervisor's _inflight entries (drains would time out
            # forever). Park them for the next successful ack instead.
            self._unreported_acks.extend(acked)
            raise
        self.shard.pop(ws, None)
        return acked

    # ── delivery / ack ───────────────────────────────────────────────

    def deliver(self, seq: int, op: dict) -> tuple[dict, Optional[list]]:
        """Process one op; returns ``(obs, acked_seqs_or_None)``. The crash
        fault site fires at delivery entry — between ops, where a real
        kill -9 would land — and converts this handle into a corpse: state
        buffered since the last ack is gone (journals abandoned, exactly as
        an OS would drop a dead process's memory)."""
        try:
            maybe_fail("cluster.worker.crash")
        except FaultError as exc:
            self.crash()
            raise WorkerCrashed(str(exc)) from exc
        if not self.alive:
            raise WorkerCrashed(f"{self.worker_id} is dead")
        if self._settable_clock is not None and "at" in op:
            self._settable_clock.t = op["at"]
        if self.deterministic_ids and "ids" in op:
            ids._ID_RNG.seed(op["ids"])
        ws = op["ws"]
        ctx = {"workspace": ws, "agent_id": self.worker_id,
               "session_key": f"agent:{self.worker_id}:cluster"}
        self._ensure_workspace_awake(ws)
        obs = dispatch_op(self.gw, op["kind"], op["content"], ctx)
        self.delivered += 1
        self._touched.add(ws)
        self._since_ack.append(seq)
        self._since_ack_ws.append(ws)
        self._released_early.append(False)
        if len(self._since_ack) >= self.ack_every:
            return obs, self._ack()
        return obs, None

    def _ensure_workspace_awake(self, ws: str) -> None:
        """Close the hibernation/fencing gap: LRU eviction
        closes a tenant's journal, and the wake on the next op opens a
        FRESH instance that knows nothing about the lease — a partitioned
        zombie worker waking a moved tenant would otherwise write unfenced.
        Before dispatching, any sharded workspace whose journal is missing
        or fence-less is woken through the cortex path and re-armed at this
        worker's lease epoch, so the commit-time fence check covers
        post-wake writes exactly like post-takeover ones."""
        epoch = self.shard.get(ws)
        if epoch is None:
            return
        journal = peek_journal(ws)
        if journal is not None and journal.fence_epoch is not None:
            return
        try:
            trackers = self.cortex.trackers({"workspace": ws})
        except OSError:
            return  # wake fault: the dispatch hooks retry fail-open
        if trackers.journal is not None:
            trackers.journal.set_fence(Path(ws) / FENCE_FILE, epoch)

    def _ack(self) -> list:
        """Group-commit every touched journal, then release the seqs. The
        commit is what makes the ack honest: an acked op's effects are on
        disk (per the fsync policy), so failover never needs to replay it.
        A seq is released once its workspace's journal committed: releasing
        seqs whose records were dropped would advance the supervisor's
        watermark past ops that never became durable, turning redelivery
        into loss; withholding seqs whose records DID commit (the JAX
        package's rule: one failed journal acks nothing) lets a crash
        replay their effects from the wal AND redeliver them, applying
        them twice. When any commit failed, the touched set and every seq
        stay retained exactly as in the JAX package (the next boundary
        retries the same commits); only the committed workspaces' seqs are
        reported now, and never again."""
        ok = True
        committed = set()
        for ws in sorted(self._touched):
            journal = peek_journal(ws)
            if journal is None or journal.commit():
                committed.add(ws)
            else:
                ok = False
        root_journal = peek_journal(self.root)
        if root_journal is not None:
            ok = root_journal.commit() and ok  # worker-own audit/events
        if not ok:
            # seqs + touched set retained; next boundary retries. The
            # workers' audit and events (the root journal) stay
            # at-least-once: they ride the next successful commit.
            early = []
            for k, ws in enumerate(self._since_ack_ws):
                if ws in committed and not self._released_early[k]:
                    self._released_early[k] = True
                    early.append(self._since_ack[k])
            self.acked += len(early)
            acked = self._unreported_acks + early
            self._unreported_acks = []
            return acked
        self._touched.clear()
        fresh = [seq for seq, done in zip(self._since_ack,
                                          self._released_early) if not done]
        self._since_ack, self._since_ack_ws = [], []
        self._released_early = []
        self.acked += len(fresh)
        acked = self._unreported_acks + fresh
        self._unreported_acks = []
        return acked

    def flush(self) -> list:
        return self._ack()

    # ── liveness ─────────────────────────────────────────────────────

    def heartbeat(self) -> float:
        maybe_fail("cluster.heartbeat")
        if not self.alive:
            raise WorkerCrashed(f"{self.worker_id} is dead")
        return self.clock()

    def crash(self) -> None:
        """Die like a process: abandon every journal (buffered records drop,
        committed wal stays for the next owner's replay), keep the gateway
        object only as a corpse. Nothing is flushed, stopped, or compacted."""
        if not self.alive:
            return
        self.alive = False
        for ws in list(self.shard) + [str(self.root)]:
            journal = peek_journal(ws)
            if journal is not None:
                journal.abandon()
        self._since_ack, self._since_ack_ws = [], []
        self._released_early = []
        self._touched.clear()

    kill = crash

    def stop(self) -> None:
        if not self.alive:
            return
        self._ack()
        self.gw.stop()
        # Scoped batcher teardown: drain + close ONLY this worker's
        # registry batchers, so a retired worker strands no queued serve
        # request and leaks no collector thread. A device error in the
        # drain propagates (after every batcher of the scope is closed).
        from ..models.serve import close_batchers

        try:
            close_batchers(scope=self.serve_scope, drain=True)
        finally:
            self.alive = False

    # ── observability ────────────────────────────────────────────────

    def stage_states(self) -> dict:
        """Raw mergeable StageTimer states, keyed with the worker prefix."""
        return {name: timer.state()
                for name, timer in self.gw.stage_timers.items()}

    def stats(self) -> dict:
        fenced = 0
        for ws in self.shard:
            journal = peek_journal(ws)
            if journal is not None:
                fenced += journal.fence_rejected
        out = {"workerId": self.worker_id, "alive": self.alive,
               "kind": "inproc", "workspaces": len(self.shard),
               "delivered": self.delivered, "acked": self.acked,
               "unacked": self._released_early.count(False),
               "fencedRecords": fenced}
        lc = self.cortex.lifecycle
        if lc is not None:
            out["lifecycle"] = {"wakes": lc.wakes, "evictions": lc.evictions,
                                "hibernateFailures": lc.hibernate_failures}
        return out


# ── real-process worker (the scaling bench shape) ────────────────────


def mp_context():
    """The safest usable multiprocessing context. A process that has
    initialised CUDA always takes ``spawn``: a forked child cannot use the
    parent's CUDA context, and the fleet's collector threads are exactly
    the thread zoo below. Otherwise JAX's rule. Prefer ``spawn``: the
    supervisor process carries threads (journal timers, queue feeders,
    logging) and a ``fork`` taken while one of them holds a lock deadlocks
    the child (observed intermittently on the JAX package's scaling
    bench). Spawn requires
    a re-importable ``__main__`` (it re-runs the main module in the child
    under the ``__mp_main__`` guard); interactive/stdin mains don't have
    one, so those fall back to fork, which is safe there exactly because a
    fresh interactive interpreter hasn't started the thread zoo yet."""
    import multiprocessing as mp
    import sys

    import torch

    if torch.cuda.is_initialized():
        return mp.get_context("spawn")
    main = sys.modules.get("__main__")
    main_file = getattr(main, "__file__", None)
    if main_file and os.path.exists(main_file):
        return mp.get_context("spawn")
    return mp.get_context("fork")


def _process_worker_main(worker_id: str, root: str, ack_every: int,
                         hb_interval_s: float, journal_cfg, lifecycle_cfg,
                         in_q, out_q) -> None:
    """Child entry point: build the worker profile, loop on the op queue.
    Every outbound message doubles as a heartbeat (the supervisor stamps
    ``last_hb`` on anything it drains); an idle child beats explicitly."""
    import queue as _queue

    worker = InProcessWorker(worker_id, root, ack_every=ack_every,
                             wall_timers=True, journal_cfg=journal_cfg,
                             lifecycle_cfg=lifecycle_cfg)
    out_q.put(("hb", worker_id, time.time()))
    while True:
        try:
            msg = in_q.get(timeout=hb_interval_s)
        except _queue.Empty:
            out_q.put(("hb", worker_id, time.time()))
            continue
        kind = msg[0]
        if kind == "ws":
            _k, ws, epoch = msg
            try:
                replay = worker.add_workspace(ws, epoch)
                out_q.put(("recovered", worker_id, ws, replay))
            except OSError as exc:
                out_q.put(("recover_failed", worker_id, ws, str(exc)))
        elif kind == "op":
            _k, seq, op = msg
            try:
                obs, acked = worker.deliver(seq, op)
            except WorkerCrashed:
                break
            out_q.put(("res", worker_id, op.get("i"), obs, seq))
            if acked:
                out_q.put(("ack", worker_id, acked))
        elif kind == "flush":
            out_q.put(("ack", worker_id, worker.flush()))
        elif kind == "release":
            _k, ws = msg
            try:
                acked = worker.release_workspace(ws)
                out_q.put(("ack", worker_id, acked))
                out_q.put(("released", worker_id, ws, True))
            except OSError as exc:
                out_q.put(("released", worker_id, ws, False))
                out_q.put(("release_failed", worker_id, ws, str(exc)))
        elif kind == "stop":
            acked = worker.flush()
            out_q.put(("ack", worker_id, acked))
            out_q.put(("stats", worker_id, worker.stats(),
                       worker.stage_states()))
            worker.stop()
            break


class ProcessWorker:
    """Worker in its own OS process; the contract of :class:`InProcessWorker`
    flipped asynchronous: ``deliver`` enqueues, results/acks/heartbeats
    arrive on the supervisor's shared result queue."""

    sync = False

    def __init__(self, worker_id: str, root: str | Path, out_q,
                 ack_every: int = 16, hb_interval_s: float = 0.25,
                 journal_cfg: Any = True, lifecycle_cfg: Any = True):
        # spawn re-imports the worker module, torch included (see
        # mp_context), once per worker at start.
        ctx = mp_context()
        self.worker_id = worker_id
        self.root = Path(root)
        self._in_q = ctx.Queue()
        self._out_q = out_q
        self.proc = ctx.Process(
            target=_process_worker_main,
            args=(worker_id, str(root), ack_every, hb_interval_s,
                  journal_cfg, lifecycle_cfg, self._in_q, out_q),
            daemon=True, name=f"cluster-{worker_id}")
        self.proc.start()
        self.shard: dict[str, int] = {}
        self.delivered = 0

    @property
    def alive(self) -> bool:
        return self.proc.is_alive()

    def add_workspace(self, ws: str, epoch: int) -> dict:
        self.shard[ws] = epoch
        self._in_q.put(("ws", ws, epoch))
        return {}

    def drop_workspace(self, ws: str) -> None:
        self.shard.pop(ws, None)

    def release_workspace(self, ws: str) -> list:
        """Asynchronous shape of the handoff barrier: enqueue the release;
        the child acks + ships and answers with a ``released`` message the
        supervisor's result pump records in ``self.released``."""
        if not self.proc.is_alive():
            raise WorkerCrashed(f"{self.worker_id} process is dead")
        # A confirmation from an earlier, timed-out-and-aborted handoff of
        # this workspace may still be parked here; consuming it for THIS
        # release would regrant before the child ran the barrier.
        self.released.pop(ws, None)
        self.shard.pop(ws, None)
        self._in_q.put(("release", ws))
        return []

    # ws -> bool, filled by the supervisor when it drains ("released", …)
    # messages; the handoff barrier polls it (single-reader: the
    # supervisor's dispatch thread, so no lock needed).
    @property
    def released(self) -> dict:
        out = getattr(self, "_released", None)
        if out is None:
            out = self._released = {}
        return out

    def deliver(self, seq: int, op: dict) -> tuple[Optional[dict], None]:
        if not self.proc.is_alive():
            raise WorkerCrashed(f"{self.worker_id} process is dead")
        self._in_q.put(("op", seq, op))
        self.delivered += 1
        return None, None  # results arrive on the shared queue

    def flush(self) -> list:
        self._in_q.put(("flush",))
        return []

    def heartbeat(self) -> float:
        """Liveness only — real heartbeats arrive on the result queue; a
        dead process is the immediate signal."""
        if not self.proc.is_alive():
            raise WorkerCrashed(f"{self.worker_id} process is dead")
        return time.time()

    def kill(self) -> None:
        """Real SIGKILL — the bench's failover clock starts here."""
        if self.proc.is_alive():
            os.kill(self.proc.pid, 9)
        self.proc.join(timeout=5.0)

    def request_stop(self) -> None:
        """Phase one of shutdown: ask the child to flush and exit. The
        caller must keep draining the shared result queue until the child
        exits — its final stats message can be larger than the pipe buffer,
        and an undrained pipe wedges the child's queue feeder thread,
        turning a clean exit into a join timeout."""
        if self.proc.is_alive():
            self._in_q.put(("stop",))

    def finish_stop(self, timeout_s: float = 10.0) -> None:
        self.proc.join(timeout=timeout_s)
        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join(timeout=5.0)
        # The child is gone: end this side's queue feeder thread too, so a
        # stopped cluster leaves no thread behind (the JAX package leaves
        # it to the queue's garbage collection).
        self._in_q.cancel_join_thread()
        self._in_q.close()

    def stop(self) -> None:
        self.request_stop()
        self.finish_stop(timeout_s=30.0)

    def stage_states(self) -> dict:
        # Shipped via the ("stats", …) message at stop; the supervisor
        # stores it here when it drains the message.
        return getattr(self, "_final_stage_states", {})

    def stats(self) -> dict:
        return {"workerId": self.worker_id, "alive": self.alive,
                "kind": "process", "workspaces": len(self.shard),
                "delivered": self.delivered, "acked": None,
                "unacked": None, "fencedRecords": None}
