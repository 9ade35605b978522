"""Cluster supervisor: routing, health, lease-fenced failover.

A copy of ``vainplex_openclaw_tpu/cluster/supervisor.py`` under the same
names, over the port's ring, workers, event transports, resilience
policies and ``ReplicaFleet``, so the port imports nothing of the JAX
package.

The supervisor owns the membership ring, the lease table, and the **route
log** — every op is published onto the events spine (``cluster.route.<ws>``
subjects over the existing transport machinery) *before* delivery, making
the cross-shard communication schedule an explicit, replayable artifact
(TACCL's argument applied at the process level): per-workspace watermarks
advance only on worker acks, and a failover re-fetches everything past the
watermark for the moved workspaces — redelivery comes from the spine, not
from bespoke in-memory buffers.

Failure detection is layered exactly like the rest of the resilience stack:
a per-worker :class:`CircuitBreaker` absorbs delivery errors, heartbeat
probes run on a miss-limit deadline, and a dead process (``ProcessWorker``)
is its own signal. Failover is the sequence the chaos suite pins:

1. remove the worker from the ring (bounded movement: only its keys move);
2. per moved workspace — ``grant`` a new lease (epoch++, journal-persisted,
   **fence file written durably** before anything else happens);
3. the new owner recovers the workspace by journal replay *before* traffic
   (``add_workspace``), under a RetryPolicy for transient recovery faults;
4. replay the route log past the acked watermark to the new owner.

Stage attribution lands on one StageTimer (``route`` / ``recover`` /
``rebalance``), registered in the gateway quantile registry as ``cluster``
so sitrep and the SLO harness read it like any other edge.

What the port changes, each a deliberate deviation pinned by a test:

- ``routeTransport: "nats"`` builds the JetStream adapter as the JAX
  package does, but without the ``nats`` client package it raises
  ``ImportError`` (from ``create_nats_transport``): the JAX package's
  quiet fall back to a memory route log would hand a multi-machine
  deployment a single-box schedule.
- The catches around a worker's ``stop`` (in :meth:`ClusterSupervisor.
  retire_worker` and :meth:`ClusterSupervisor.stop`) and around a process
  worker's ``request_stop`` let an error of the device
  (``device.is_device_error``) propagate: a worker with a replica batcher
  drains it on the card in ``stop``, and a failed launch there must not
  end as a log line. Every other error is logged (or passed over) as in
  the JAX package.
- :meth:`ClusterSupervisor.enable_fleet` takes ``device`` (None = the
  card) for the port's ``ReplicaFleet``.
"""

from __future__ import annotations

import threading
import time
from pathlib import Path
from typing import Any, Callable, Optional

from ..device import DeviceLike, is_device_error
from ..events.envelope import ClawEvent
from ..resilience.faults import FaultError, maybe_fail
from ..resilience.policy import CircuitBreaker, RetryPolicy
from ..storage.journal import peek_journal
from ..utils.stage_timer import StageTimer
from .ring import HashRing, LeaseTable
from .worker import InProcessWorker, ProcessWorker, WorkerCrashed

CLUSTER_DEFAULTS = {
    # Escape hatch: nothing builds a cluster unless asked — the default
    # single-process path is byte-for-byte the pre-cluster gateway.
    "enabled": False,
    "workers": 2,
    "vnodes": 160,
    "ackEveryOps": 16,
    "heartbeatMissLimit": 3,
    "heartbeatDeadlineS": 1.5,
    "routeSubject": "cluster.route",
    "deterministicIds": False,
    "recoverRetries": 3,
    # Bounded-load placement cap: no worker owns more than this factor of
    # the mean lease count (consistent hashing with bounded loads). 1.15
    # keeps the max-loaded worker within 15% of fair share — the balance
    # term that dominates measured scaling efficiency.
    "loadFactor": 1.15,
    # Route-log transport behind the EventTransport seam: "memory" is the
    # single-box route log; "file" gives a single machine a durable
    # replayable schedule; "nats" (JetStream, shared by supervisors on
    # different machines) needs the nats client package, and raises
    # without it.
    "routeTransport": "memory",
    "routeNatsUrl": "nats://localhost:4222",
    "routeStream": "CLAW_ROUTES",
    # JetStream stream subjects are "<routePrefix>.>" — both the route
    # subjects (cluster.route.<ws>) and the ack-watermark subjects
    # (cluster.ack.<ws>) must live under it.
    "routePrefix": "cluster",
    # Acked watermarks as spine events: every Nth per-workspace watermark
    # advancement is published to ``<ackSubject>.<ws>`` so a peer (or
    # replacement) supervisor can recover redelivery positions from the
    # schedule itself instead of from this process's memory. 0 = off: the
    # spine carries route events only.
    "ackSubject": "cluster.ack",
    "ackWatermarkEvery": 0,
    # Supervisor-side admission: a dict ({"enabled": True,
    # "highWatermark": …}) arms the AdmissionController at INGRESS — sheddable op kinds are dropped
    # before they enter the route log when the reported queue depth says
    # the cluster is saturated. None keeps ingress unconditional.
    "admission": None,
    # Planned handoff: how long drain() may wait for a workspace's
    # in-flight ops (process mode) before the handoff aborts.
    "handoffDrainTimeoutS": 30.0,
    # Worker-id prefix ("w" → w0, w1, …). A second supervisor adopting the
    # same root names its workers distinctly (e.g. "b") so lease history
    # reads unambiguously across supervisor generations.
    "workerPrefix": "w",
    # Fleet serving: model replicas as cluster residents: the
    # supervisor routes stage-3 validator traffic across worker-resident
    # ContinuousBatcher replicas (cluster/fleet.py), replica death rides
    # the failover path, and an SLO-driven autoscaler spawns/retires
    # through the planned drain-before-retire sequence. Default OFF: the
    # single-process make_local_call_llm path is the
    # equivalence oracle for verdict parity, never deleted. ``fleet`` is
    # the FLEET_DEFAULTS overlay armed by enable_fleet().
    "fleetServing": False,
    "fleet": None,
}

# Ingress kinds the supervisor may shed under admission pressure: message
# ingest feeds observability/cortex work (the single-process path sheds the
# same work via ADMISSION_SHEDDABLE_HOOKS); verdict-bearing tool ops are
# never consulted — mirroring NEVER_SHED_HOOKS one level up.
SHEDDABLE_KINDS = frozenset({"msg_in", "msg_out"})


def build_route_transport(cfg: dict, root: Path, clock, logger=None):
    """The route log's transport behind the ``EventTransport`` seam:
    ``(transport, kind)`` per ``cluster.routeTransport``. The TACCL stance
    made concrete: the route log IS the cross-shard communication schedule,
    so which wire carries it is a *config choice with a contract* —
    ``fetch(subject, start_seq=watermark)`` replay semantics are the same
    for every kind, not an accident of whatever transport happened to be
    handy. ``"nats"`` without the ``nats`` client package raises
    ``ImportError`` here, where the JAX package degrades to memory."""
    kind = str(cfg.get("routeTransport", "memory"))
    if kind == "nats":
        from ..events.transport import create_nats_transport

        transport = create_nats_transport(
            str(cfg.get("routeNatsUrl", "nats://localhost:4222")),
            stream=str(cfg.get("routeStream", "CLAW_ROUTES")),
            prefix=str(cfg.get("routePrefix", "cluster")),
            logger=logger)
        transport.connect()  # failure is fine: outbox + reconnect probes
        return transport, "nats"
    if kind == "file":
        from ..events.transport import FileTransport

        path = Path(root) / "route-log"
        path.mkdir(parents=True, exist_ok=True)
        return FileTransport(path, clock=clock), "file"
    if kind != "memory":
        raise ValueError(f"unknown cluster.routeTransport {kind!r}")
    from ..events.transport import MemoryTransport

    return MemoryTransport(clock=clock), "memory"


class _WorkerState:
    __slots__ = ("handle", "alive", "misses", "breaker", "last_hb",
                 "last_miss_at")

    def __init__(self, handle, breaker: CircuitBreaker, now: float):
        self.handle = handle
        self.alive = True
        self.misses = 0
        self.breaker = breaker
        self.last_hb = now
        self.last_miss_at = 0.0


class ClusterSupervisor:
    """Routes ops to workspace-sharded workers and survives their deaths.

    ``on_result(op, obs)`` fires for every op the cluster finishes —
    including redeliveries after a failover, which OVERWRITE the op's
    earlier (rolled-back) observation when the caller keys by ``op["i"]``;
    that keying is what makes at-least-once delivery read as exactly-once
    accounting.

    State-effect semantics depend on ``journal_cfg``: with the journal's
    defaults, a commit can land between acks (batch-full / window timer),
    so a crash redelivers a committed-but-unacked tail — at-least-once
    effects, the journal layer's standing contract. Configs that make the
    ack boundary the sole commit trigger (``maxBatchRecords`` huge,
    ``windowMs`` 0, what the chaos storms pin) tighten that to
    exactly-once state; docs/cluster.md walks the trade."""

    def __init__(self, root: str | Path, config: Optional[dict] = None,
                 clock: Callable[[], float] = time.time,
                 transport=None, logger=None,
                 worker_mode: str = "inproc", wall_timers: bool = True,
                 settable_clock: Any = None, journal_cfg: Any = True,
                 lifecycle_cfg: Any = True,
                 on_result: Optional[Callable[[dict, dict], None]] = None,
                 adopt: bool = False,
                 worker_factory: Optional[Callable[[str, Path], Any]] = None):
        cfg = dict(CLUSTER_DEFAULTS)
        cfg.update(config or {})
        self.cfg = cfg
        self.root = Path(root)
        self.clock = clock
        self.logger = logger
        self.worker_mode = worker_mode
        self.wall_timers = wall_timers
        self.settable_clock = settable_clock
        self.journal_cfg = journal_cfg
        # Handle-construction seam: an interleaving explorer drives the REAL supervisor/lease/journal protocol stack
        # with a protocol-faithful worker whose op executor is a stub —
        # None keeps the production InProcessWorker/ProcessWorker builds.
        self.worker_factory = worker_factory
        # Workspace lifecycle: with the default settings a new
        # owner's recovery loads the last shipped snapshot + wal tail —
        # failover cost tracks the ship cadence, not the journal's age.
        self.lifecycle_cfg = lifecycle_cfg
        self.on_result = on_result or (lambda op, obs: None)
        self.timer = StageTimer()
        self.ring = HashRing(int(cfg.get("vnodes", 160)))
        self.leases = LeaseTable(self.root / "cluster", clock=clock,
                                 logger=logger)
        if transport is None:
            transport, kind = build_route_transport(cfg, self.root,
                                                    clock=clock, logger=logger)
        else:
            # Explicitly-injected transports map to the same kind
            # vocabulary the routeLog stats/sitrep summary document —
            # dashboards match on "memory"/"file"/"nats", never on a
            # Python class name.
            kind = {"MemoryTransport": "memory", "FileTransport": "file",
                    "NatsTransport": "nats"}.get(type(transport).__name__,
                                                 type(transport).__name__)
        self.transport = transport
        self.route_transport_kind = kind
        self._route_subject = str(cfg.get("routeSubject", "cluster.route"))
        self._ack_subject = str(cfg.get("ackSubject", "cluster.ack"))
        self._ack_pub_every = int(cfg.get("ackWatermarkEvery", 0))
        from ..resilience.admission import AdmissionController

        self.admission = AdmissionController.from_config(
            cfg.get("admission") or None)
        self._recover_retry = RetryPolicy(
            max_attempts=int(cfg.get("recoverRetries", 3)),
            base_delay_s=0.0, jitter=0.0, sleep=lambda _s: None)
        self._result_q = None
        if worker_mode == "process":
            from .worker import mp_context

            # Queues and processes must come from one context; mp_context
            # picks spawn where possible (fork-with-threads deadlocks the
            # child — see worker.py).
            self._result_q = mp_context().Queue()

        # ── guarded state (self._lock) ──
        self._lock = threading.Lock()
        self._workers: dict[str, _WorkerState] = {}
        self._acked: dict[str, int] = {}      # ws -> route-log watermark
        self._ack_unpub: dict[str, int] = {}  # ws -> advancements since pub
        self._inflight: dict[int, str] = {}   # route seq -> ws
        self._backlog: list[tuple[int, dict]] = []
        self._failovers: list[dict] = []
        self._handoffs: list[dict] = []
        self._retired: list[str] = []
        self.routed = 0
        self.redelivered = 0
        self.route_faults = 0
        self.handoff_aborts = 0
        self.ingress_shed = 0

        # Replica fleet: armed by enable_fleet() when
        # cfg["fleetServing"] — never built implicitly, so the default
        # supervisor is byte-for-byte the pre-fleet one.
        self.fleet = None

        for i in range(int(cfg.get("workers", 2))):
            self.add_worker(f"{str(cfg.get('workerPrefix', 'w'))}{i}")
        if adopt:
            self._adopt_cluster()

    # ── membership ───────────────────────────────────────────────────

    def _make_handle(self, worker_id: str):
        worker_root = self.root / "workers" / worker_id
        if self.worker_factory is not None:
            return self.worker_factory(worker_id, worker_root)
        if self.worker_mode == "process":
            return ProcessWorker(worker_id, worker_root, self._result_q,
                                 ack_every=int(self.cfg.get("ackEveryOps", 16)),
                                 journal_cfg=self.journal_cfg,
                                 lifecycle_cfg=self.lifecycle_cfg)
        return InProcessWorker(
            worker_id, worker_root, clock=self.clock,
            ack_every=int(self.cfg.get("ackEveryOps", 16)),
            wall_timers=self.wall_timers,
            deterministic_ids=bool(self.cfg.get("deterministicIds", False)),
            settable_clock=self.settable_clock,
            journal_cfg=self.journal_cfg, lifecycle_cfg=self.lifecycle_cfg,
            logger=self.logger)

    def add_worker(self, worker_id: str) -> None:
        handle = self._make_handle(worker_id)
        breaker = CircuitBreaker(failure_threshold=3, failure_rate=0.5,
                                 window_s=30.0, recovery_s=5.0,
                                 clock=self.clock)
        state = _WorkerState(handle, breaker, self.clock())
        with self._lock:
            self._workers[worker_id] = state
        self.ring.add(worker_id)

    def workers(self) -> dict:
        with self._lock:
            return dict(self._workers)

    def _live_worker_ids(self) -> list:
        with self._lock:
            return [w for w, s in self._workers.items() if s.alive]

    def enable_fleet(self, batcher_factory=None, on_result=None,
                     adopt: bool = False, registry=None,
                     device: DeviceLike = None):
        """Arm fleet serving behind ``cluster.fleetServing``, the escape
        hatch: when the flag is off this returns None and the
        single-process serve path (models/serve.make_local_call_llm) is
        untouched. When on, the fleet places replica batchers on live
        workers (by default scoped shared batchers on ``device``, None =
        the card), publishes its schedule on this supervisor's route
        transport, and rides failover/retirement through
        on_worker_failed/drain_worker."""
        if not self.cfg.get("fleetServing"):
            return None
        from .fleet import ReplicaFleet

        self.fleet = ReplicaFleet(
            dict(self.cfg.get("fleet") or {}),
            transport=self.transport, clock=self.clock,
            workers=self._live_worker_ids, logger=self.logger,
            batcher_factory=batcher_factory,
            on_result=on_result or self.on_result, adopt=adopt,
            registry=registry, device=device)
        return self.fleet

    def _worker(self, worker_id: str) -> Optional[_WorkerState]:
        with self._lock:
            return self._workers.get(worker_id)

    # ── routing ──────────────────────────────────────────────────────

    def _subject(self, op: dict) -> str:
        return f"{self._route_subject}.{op['wsKey']}"

    def _publish_route(self, op: dict) -> int:
        """Append the op to the route log; returns its spine sequence (the
        redelivery watermark unit). A publish failure (counted by the
        transport) degrades replay coverage for this op, never delivery."""
        event = ClawEvent(
            id=f"route:{op.get('i')}", ts=self.clock() * 1000.0,
            agent="cluster", session="cluster", type="cluster.route",
            canonical_type=None, legacy_type=None, schema_version=1,
            source={"component": "cluster-supervisor"}, actor={}, scope={},
            trace={}, visibility="internal", payload=dict(op))
        if not self.transport.publish(self._subject(op), event):
            return -1
        # Every transport stamps the event's TRUE sequence at publish
        # (memory/file locally, NATS from the PubAck) — prefer it over
        # last_sequence(), which on a broker stream shared by peer
        # supervisors could already reflect someone else's later publish.
        if event.seq is not None:
            return event.seq
        return self.transport.last_sequence()

    def _placement(self, incoming: int = 1) -> tuple[dict, int]:
        """Current per-live-worker lease counts and the bounded-load cap
        sized for ``incoming`` additional grants. O(leases) — grants are
        rare (first sight, failover), delivery never pays this."""
        import math

        live = set(self.ring.members())
        counts = {w: 0 for w in live}
        for lease in self.leases.snapshot().values():
            if lease["owner"] in counts:
                counts[lease["owner"]] += 1
        total = sum(counts.values())
        cap = max(1, math.ceil(float(self.cfg.get("loadFactor", 1.15))
                               * (total + incoming) / max(1, len(live))))
        return counts, cap

    def _ensure_owner(self, ws: str, ws_key: str) -> str:
        """Current live owner of ``ws``, leasing it on first sight. The
        first grant is a failover-shaped path minus the recovery replay
        (nothing to recover on a fresh workspace — but the fence is written
        either way, so epoch 1 is fenceable from the very first write)."""
        owner = self.leases.owner(ws)
        if owner is not None:
            state = self._worker(owner)
            if state is not None and state.alive:
                return owner
        loads, cap = self._placement()
        new_owner = self.ring.owner(ws_key, loads, cap)
        epoch = self.leases.grant(ws, new_owner)
        state = self._worker(new_owner)
        t0 = time.perf_counter
        start = t0()
        self._recover_retry.call(
            lambda: state.handle.add_workspace(ws, epoch),
            retry_on=(FaultError, OSError))
        self.timer.add("recover", (t0() - start) * 1000.0)
        return new_owner

    def note_queue_depth(self, depth: int) -> None:
        """Ingress backpressure signal (whoever owns the arrival queue
        reports it — the SLO harness's open-loop driver, a front-end's
        accept loop). Forwards to the admission controller when armed."""
        if self.admission is not None:
            self.admission.note_queue_depth(depth)

    def submit(self, op: dict) -> Optional[dict]:
        """Route one op: publish to the route log, deliver to the owner.
        Returns the op's observation when delivery was synchronous (the
        in-process shape); process-mode results arrive via ``tick()``.

        With ``cluster.admission`` armed, sheddable op kinds are consulted
        BEFORE the route publish: a shed op never enters the schedule (no
        seq, no redelivery debt), completes immediately with a ``shed``
        observation, and verdict-bearing kinds are never consulted — the
        workers-mode twin of the single-process hook-level shedding."""
        if self.admission is not None and op.get("kind") in SHEDDABLE_KINDS:
            if not self.admission.admit(str(op.get("wsKey")
                                            or op.get("ws") or "")):
                with self._lock:
                    self.ingress_shed += 1
                obs = {"shed": True}
                self.on_result(op, obs)
                return obs
        self._drain_backlog()
        pc = time.perf_counter
        t0 = pc()
        seq = self._publish_route(op)
        try:
            maybe_fail("cluster.route")
        except FaultError:
            with self._lock:
                self.route_faults += 1
                self._backlog.append((seq, op))
                if seq >= 0:
                    self._inflight[seq] = op["ws"]
            self.timer.add("route", (pc() - t0) * 1000.0)
            return None
        obs = self._deliver(seq, op)
        self.timer.add("route", (pc() - t0) * 1000.0)
        return obs

    def _deliver(self, seq: int, op: dict) -> Optional[dict]:
        ws = op["ws"]
        owner = self._ensure_owner(ws, op["wsKey"])
        state = self._worker(owner)
        with self._lock:
            self.routed += 1
            if seq >= 0:
                self._inflight[seq] = ws
        try:
            obs, acked = state.handle.deliver(seq, op)
        except WorkerCrashed as exc:
            state.breaker.record_failure(str(exc))
            self.failover(owner, reason=f"crash during delivery: {exc}")
            return None
        state.breaker.record_success()
        if state.handle.sync:
            self.on_result(op, obs)
            if acked:
                self._note_ack(acked)
        return obs

    def _note_ack(self, seqs: list) -> None:
        to_publish: list[tuple[str, int]] = []
        with self._lock:
            for seq in seqs:
                ws = self._inflight.pop(seq, None)
                if ws is not None and seq > self._acked.get(ws, 0):
                    self._acked[ws] = seq
                    if self._ack_pub_every > 0:
                        n = self._ack_unpub.get(ws, 0) + 1
                        if n >= self._ack_pub_every:
                            self._ack_unpub[ws] = 0
                            to_publish.append((ws, seq))
                        else:
                            self._ack_unpub[ws] = n
        # Publish OUTSIDE the dispatch lock: the transport may do I/O.
        for ws, mark in to_publish:
            self._publish_watermark(ws, mark)

    def _publish_watermark(self, ws: str, mark: int) -> None:
        """Acked watermark as a spine event (``cluster.ack.<ws>``): the
        redelivery position becomes part of the shared schedule, so a peer
        supervisor recovers it from the transport instead of from this
        process's memory. Publish failures degrade a peer's recovered
        watermark backwards (it redelivers MORE, never less) — safe, and
        counted by the transport like any publish failure."""
        event = ClawEvent(
            id=f"ack:{Path(ws).name}", ts=self.clock() * 1000.0,
            agent="cluster", session="cluster", type="cluster.ack",
            canonical_type=None, legacy_type=None, schema_version=1,
            source={"component": "cluster-supervisor"}, actor={}, scope={},
            trace={}, visibility="internal",
            payload={"ws": ws, "watermark": mark})
        self.transport.publish(f"{self._ack_subject}.{Path(ws).name}", event)

    def recover_watermarks(self) -> dict:
        """Rebuild ``ws -> acked watermark`` from the schedule's ack events
        (max per workspace). What a replacement/peer supervisor starts
        redelivery from; a workspace with no published ack recovers to 0 —
        full route-log replay, the conservative direction."""
        marks: dict[str, int] = {}
        for event in self.transport.fetch(
                subject_filter=f"{self._ack_subject}.>"):
            payload = event.payload or {}
            ws = payload.get("ws")
            try:
                mark = int(payload.get("watermark") or 0)
            except (TypeError, ValueError):
                continue
            if ws and mark > marks.get(ws, 0):
                marks[ws] = mark
        return marks

    def _adopt_cluster(self) -> None:
        """Take over a cluster root from another (presumed-partitioned or
        retired) supervisor: recover redelivery watermarks from the shared
        schedule, then re-grant every persisted lease to this supervisor's
        own workers — each grant is failover-shaped (epoch++, durable
        fence, recovery on the new owner, route-log catch-up), so any
        still-running writer of the previous supervisor generation is
        fenced at the journal boundary from the first adopted commit on."""
        pc = time.perf_counter
        t0 = pc()
        marks = self.recover_watermarks()
        with self._lock:
            self._acked.update(marks)
        adopted = sorted(self.leases.snapshot())
        loads, cap = self._placement(incoming=len(adopted))
        replayed_records = 0
        redelivered = 0
        for ws in adopted:
            new_owner = self.ring.owner(self._ws_key(ws), loads, cap)
            loads[new_owner] = loads.get(new_owner, 0) + 1
            epoch = self.leases.grant(ws, new_owner)
            state = self._worker(new_owner)
            t_rec = pc()
            replay = self._recover_retry.call(
                lambda: state.handle.add_workspace(ws, epoch),
                retry_on=(FaultError, OSError))
            self.timer.add("recover", (pc() - t_rec) * 1000.0)
            replayed_records += (replay or {}).get("records", 0)
            redelivered += self._redeliver(ws, state)
        if not adopted:
            return
        with self._lock:
            self.redelivered += redelivered
            self._failovers.append({
                "at": self.clock(), "worker": "(adopted)",
                "reason": "supervisor adoption",
                "workspacesMoved": len(adopted),
                "replayedRecords": replayed_records,
                "redelivered": redelivered,
                "durationMs": round((pc() - t0) * 1000.0, 3)})

    def _drain_backlog(self) -> None:
        with self._lock:
            if not self._backlog:
                return
            backlog, self._backlog = self._backlog, []
        for seq, op in backlog:
            self._deliver(seq, op)

    # ── health / failover ────────────────────────────────────────────

    def tick(self) -> None:
        """One health pass: drain process-mode messages, probe heartbeats,
        fail over anything past its deadline. The deterministic storms call
        this between ops; wall deployments call it on an interval."""
        self._drain_results()
        self._drain_backlog()
        deadline = float(self.cfg.get("heartbeatDeadlineS", 1.5))
        limit = int(self.cfg.get("heartbeatMissLimit", 3))
        with self._lock:
            snapshot = list(self._workers.items())
        for worker_id, state in snapshot:
            if not state.alive:
                continue
            if state.handle.sync:
                try:
                    state.last_hb = state.handle.heartbeat()
                    state.misses = 0
                except WorkerCrashed as exc:
                    self.failover(worker_id, reason=f"crash: {exc}")
                    continue
                except FaultError:
                    state.misses += 1
                    state.breaker.record_failure("heartbeat lost")
            else:
                if not state.handle.alive:
                    self.failover(worker_id, reason="process died")
                    continue
                now = self.clock()
                if now - state.last_hb > deadline:
                    # Rate-limit miss counting to one per deadline window:
                    # tick() may run many times per second (the dispatch
                    # loop calls it), and counting a miss per CALL would
                    # let a burst of quick ticks fail over a worker that is
                    # merely slow to start — missLimit × deadline must be a
                    # WALL-time budget, not a tick budget.
                    if now - max(state.last_hb, state.last_miss_at) > deadline:
                        state.misses += 1
                        state.last_miss_at = now
                        state.breaker.record_failure("heartbeat deadline")
                else:
                    state.misses = 0
            if state.misses >= limit:
                self.failover(worker_id,
                              reason=f"{state.misses} heartbeats missed")

    def _drain_results(self) -> None:
        """Process-mode message pump: results, acks, heartbeats, recovery
        reports — anything from a worker refreshes its liveness stamp."""
        if self._result_q is None:
            return
        import queue as _queue

        while True:
            try:
                msg = self._result_q.get_nowait()
            except _queue.Empty:
                return
            worker_id = msg[1]
            state = self._worker(worker_id)
            if state is not None:
                state.last_hb = time.time()
                state.misses = 0
            kind = msg[0]
            if kind == "res":
                _k, _w, _i, obs, _seq = msg
                self.on_result({"i": _i}, obs)
            elif kind == "ack":
                self._note_ack(msg[2])
            elif kind == "released" and state is not None:
                state.handle.released[msg[2]] = msg[3]
            elif kind == "release_failed" and self.logger is not None:
                self.logger.warn(f"[cluster] release of {msg[2]} on "
                                 f"{worker_id} failed: {msg[3]}")
            elif kind == "stats" and state is not None:
                # The child's parting gift: final counters + mergeable
                # stage-timer states for the cross-worker quantile view.
                state.handle._final_stats = msg[2]
                state.handle._final_stage_states = msg[3]

    def failover(self, worker_id: str, reason: str = "") -> None:
        """Re-shard a dead worker's workspaces onto the survivors; each
        moved workspace is fenced (epoch++), journal-replay recovered on
        its new owner, then caught up from the route log."""
        pc = time.perf_counter
        t0 = pc()
        with self._lock:
            state = self._workers.get(worker_id)
            if state is None or not state.alive:
                return
            state.alive = False
        if self.logger is not None:
            self.logger.warn(f"[cluster] worker {worker_id} FAILED: {reason}"
                             f" — re-sharding")
        t_reb = pc()
        self.ring.remove(worker_id)
        if not self.ring.members():
            raise RuntimeError("cluster has no live workers left")
        moved = self.leases.owned_by(worker_id)
        loads, cap = self._placement(incoming=len(moved))
        grants: list[tuple[str, str, int]] = []
        for ws in moved:
            new_owner = self.ring.owner(self._ws_key(ws), loads, cap)
            loads[new_owner] = loads.get(new_owner, 0) + 1
            epoch = self.leases.grant(ws, new_owner)
            grants.append((ws, new_owner, epoch))
        self.timer.add("rebalance", (pc() - t_reb) * 1000.0)

        replayed_records = 0
        redelivered = 0
        for ws, new_owner, epoch in grants:
            # Cascading failure: a survivor can die DURING this loop (its
            # crash inside _redeliver triggers a nested failover that
            # re-grants everything it owned — including grants from THIS
            # list). A superseded grant must not be applied: add_workspace
            # at the stale epoch would re-fence the third owner's live
            # journal backwards and drop its buffer. Ordered comparison,
            # not `!=`: epochs are monotonic (grant is the only mutation),
            # so "superseded" IS "a newer epoch exists", and every epoch
            # staleness check takes the ordered form.
            if self.leases.epoch(ws) > epoch:
                continue  # re-granted by a nested failover; it owns recovery
            new_state = self._worker(new_owner)
            if new_state is None or not new_state.alive:
                continue  # new owner died; its own failover re-homed the ws
            t_rec = pc()
            replay = self._recover_retry.call(
                lambda: new_state.handle.add_workspace(ws, epoch),
                retry_on=(FaultError, OSError))
            self.timer.add("recover", (pc() - t_rec) * 1000.0)
            replayed_records += (replay or {}).get("records", 0)
            redelivered += self._redeliver(ws, new_state)
        if self.fleet is not None:
            # Replica death rides the same path: the fleet
            # re-fetches the dead worker's in-flight requests past its
            # watermark and re-routes them, then respawns capacity.
            self.fleet.on_worker_failed(worker_id, reason=reason)
        with self._lock:
            self.redelivered += redelivered
            self._failovers.append({
                "at": self.clock(), "worker": worker_id, "reason": reason,
                "workspacesMoved": len(moved),
                "replayedRecords": replayed_records,
                "redelivered": redelivered,
                "durationMs": round((pc() - t0) * 1000.0, 3)})

    def _ws_key(self, ws: str) -> str:
        # The route subject key rides on the op; recover it from the route
        # log's subjects is overkill — tenant keys are the basename by
        # construction in every harness, and a miss only degrades balance,
        # never correctness (the ring accepts any string).
        return Path(ws).name

    def _redeliver(self, ws: str, new_state: _WorkerState) -> int:
        """Replay the route log past the acked watermark — every op whose
        effects the crash rolled back (journal-buffered, never committed,
        never acked) runs again on the new owner, in original order."""
        with self._lock:
            mark = self._acked.get(ws, 0)
        subject = f"{self._route_subject}.{Path(ws).name}"
        count = 0
        for event in self.transport.fetch(subject_filter=subject,
                                          start_seq=mark):
            op = event.payload
            if op.get("ws") != ws:
                continue
            seq = event.seq if event.seq is not None else -1
            try:
                obs, acked = new_state.handle.deliver(seq, op)
            except WorkerCrashed as exc:
                # Cascading failure: the new owner died too. Its own
                # failover (triggered by the next tick/delivery) replays
                # from the same watermarks — nothing is lost, this pass
                # just stops early.
                new_state.breaker.record_failure(str(exc))
                self.failover(new_state.handle.worker_id,
                              reason=f"crash during redelivery: {exc}")
                return count
            count += 1
            if new_state.handle.sync:
                self.on_result(op, obs)
                if acked:
                    self._note_ack(acked)
        return count

    # ── planned handoff: failover's zero-downtime peer ───────────────

    def _pick_handoff_target(self, ws_key: str, source: str) -> Optional[str]:
        """Least-loaded live worker other than the source (ties broken by
        id for determinism). Bounded-load placement applies on the grant
        like everywhere else; this only picks the candidate."""
        loads, _cap = self._placement()
        best = None
        for wid in self.ring.members():
            if wid == source:
                continue
            state = self._worker(wid)
            if state is None or not state.alive:
                continue
            key = (loads.get(wid, 0), wid)
            if best is None or key < best[0]:
                best = (key, wid)
        return best[1] if best else None

    def _wait_ws_drained(self, ws: str, state: _WorkerState) -> bool:
        """Drain the source's in-flight ops for ``ws`` to the ack boundary.
        Sync workers flush inline; process workers flush over the queue and
        we pump results until no in-flight seq maps to ``ws`` (bounded by
        ``handoffDrainTimeoutS``)."""
        if state.handle.sync:
            self._note_ack(state.handle.flush())
            with self._lock:
                return ws not in self._inflight.values()
        state.handle.flush()
        deadline = time.time() + float(
            self.cfg.get("handoffDrainTimeoutS", 30.0))
        while time.time() < deadline:
            self._drain_results()
            with self._lock:
                if ws not in self._inflight.values():
                    return True
            time.sleep(0.005)
        return False

    def _wait_released(self, ws: str, state: _WorkerState) -> bool:
        """Pump results until the child confirms the barrier ran (or the
        drain budget runs out / the child dies — both abort the handoff)."""
        deadline = time.time() + float(
            self.cfg.get("handoffDrainTimeoutS", 30.0))
        while time.time() < deadline:
            self._drain_results()
            if ws in state.handle.released:
                return bool(state.handle.released.pop(ws))
            if not state.handle.alive:
                return False
            time.sleep(0.005)
        return False

    def handoff(self, ws: str, target: Optional[str] = None,
                reason: str = "planned") -> Optional[dict]:
        """Move ``ws`` to ``target`` with no journal replay and no
        redelivery: **drain** the source's in-flight ops to the ack
        boundary → **barrier** (journal group-commit + snapshot ship, so
        the shipped snapshot IS current state and the wal tail is empty) →
        **regrant** (epoch++, durable fence — the commit point) →
        **resume** on the target. Everything before the regrant aborts
        cleanly (the source keeps serving, ``handoffAborts`` counts it);
        after the regrant the resume is retried like failover recovery.

        This is what rebalancing, rolling restarts (``retire_worker``) and
        lifecycle-driven moves ride instead of the crash path: failover
        pays fence + journal replay + route-log redelivery; a handoff pays
        fence + an already-shipped snapshot open — no replay, nothing past
        the watermark to redeliver."""
        pc = time.perf_counter
        t0 = pc()
        source = self.leases.owner(ws)
        if source is None:
            return None
        src_state = self._worker(source)
        if src_state is None or not src_state.alive:
            return None  # dead owner: that move is failover's job
        ws_key = self._ws_key(ws)
        if target is None:
            target = self._pick_handoff_target(ws_key, source)
        tgt_state = self._worker(target) if target else None
        if (tgt_state is None or not tgt_state.alive or target == source):
            return None
        stages: dict[str, float] = {}
        journal = peek_journal(ws)
        try:
            # 1 — drain: in-flight ops for ws reach the ack boundary
            # (committed + acked), so nothing is owed past the watermark.
            t = pc()
            maybe_fail("cluster.handoff.drain")
            self._drain_backlog()
            if not self._wait_ws_drained(ws, src_state):
                raise FaultError("handoff drain timed out")
            stages["drain"] = (pc() - t) * 1000.0
            # 2 — barrier: group-commit + snapshot ship ON THE OWNER (the
            # journal lives in the child in process mode). After this the
            # legacy files ARE the state and the live wal is rotated empty
            # — a fresh open on the target replays nothing.
            t = pc()
            maybe_fail("cluster.handoff.barrier")
            if src_state.handle.sync:
                self._note_ack(src_state.handle.release_workspace(ws))
            else:
                src_state.handle.release_workspace(ws)
                if not self._wait_released(ws, src_state):
                    raise FaultError("handoff barrier: release not confirmed")
            stages["barrier"] = (pc() - t) * 1000.0
            # 3 — regrant precheck (the last abortable instant).
            maybe_fail("cluster.handoff.regrant")
        except (FaultError, OSError) as exc:
            with self._lock:
                self.handoff_aborts += 1
            if src_state.alive and ws not in src_state.handle.shard:
                # barrier partially ran: re-arm the source's ownership so
                # it keeps serving at its (unchanged) epoch.
                self._recover_retry.call(
                    lambda: src_state.handle.add_workspace(
                        ws, self.leases.epoch(ws)),
                    retry_on=(FaultError, OSError))
            if self.logger is not None:
                self.logger.warn(f"[cluster] handoff of {ws_key} aborted "
                                 f"pre-grant: {exc}")
            return None
        t = pc()
        try:
            epoch = self.leases.grant(ws, target)  # commit point: durable fence
        except (FaultError, OSError) as exc:
            # The regrant did not complete durably (fence write failed —
            # possibly with the lease table already advanced to the
            # target). Never admit an owner behind an unwritten fence:
            # fall back to the SOURCE with a fresh grant, which restores a
            # consistent (owner, fence) pair at a newer epoch, then re-arm
            # it — an abort, just one epoch later. A persistent lease
            # failure here propagates, exactly like failover's grants.
            with self._lock:
                self.handoff_aborts += 1
            epoch_back = self.leases.grant(ws, source)
            self._recover_retry.call(
                lambda: src_state.handle.add_workspace(ws, epoch_back),
                retry_on=(FaultError, OSError))
            if self.logger is not None:
                self.logger.warn(f"[cluster] handoff of {ws_key} aborted at "
                                 f"regrant: {exc}")
            return None
        stages["regrant"] = (pc() - t) * 1000.0
        # 4 — resume: the target opens the shipped snapshot (no replay) and
        # catches up from the route log (nothing past the watermark after a
        # clean drain). Post-commit faults are retried like recovery.
        t = pc()

        def _resume():
            maybe_fail("cluster.handoff.resume")
            return tgt_state.handle.add_workspace(ws, epoch)

        self._recover_retry.call(_resume, retry_on=(FaultError, OSError))
        # Replay accounting: the barrier closed the source's journal, so
        # the target's open is FRESH and its replay stats are exactly what
        # the takeover replayed — 0 when the ship did its job. (Process
        # mode recovers in the child; its replay report rides the
        # ``recovered`` message like failover's and reads 0 here.)
        replayed = 0
        new_journal = peek_journal(ws)
        if new_journal is not None and new_journal is not journal:
            try:
                replayed = int(new_journal.stats()["replay"]["records"])
            except (KeyError, TypeError, ValueError):
                replayed = 0
        redelivered = self._redeliver(ws, tgt_state)
        stages["resume"] = (pc() - t) * 1000.0
        total = (pc() - t0) * 1000.0
        self.timer.add("handoff", total)
        record = {"at": self.clock(), "ws": ws_key, "from": source,
                  "to": target, "reason": reason, "epoch": epoch,
                  "replayedRecords": replayed,
                  "redelivered": redelivered,
                  "stagesMs": {k: round(v, 3) for k, v in stages.items()},
                  "durationMs": round(total, 3)}
        with self._lock:
            self.redelivered += redelivered
            self._handoffs.append(record)
        return record

    def rebalance(self) -> list:
        """Planned-handoff sweep: move workspaces off any worker above the
        bounded-load cap until every live worker is within it. Returns the
        handoff records (empty when already balanced)."""
        records = []
        while True:
            loads, cap = self._placement()
            over = sorted((w for w, n in loads.items() if n > cap),
                          key=lambda w: (-loads[w], w))
            if not over:
                return records
            moved_any = False
            for wid in over:
                owned = self.leases.owned_by(wid)
                if not owned:
                    continue
                rec = self.handoff(owned[0], reason="rebalance")
                if rec is not None:
                    records.append(rec)
                    moved_any = True
            if not moved_any:
                return records  # every candidate aborted: stop, don't spin

    def retire_worker(self, worker_id: str, reason: str = "retire") -> dict:
        """Rolling-restart primitive: hand every owned workspace off (each
        a planned, zero-replay move), then stop the worker and remove it
        from the ring. Workspaces whose handoff aborted stay owned and are
        moved by the failover path when the worker actually goes away."""
        moved, aborted = 0, 0
        if self.fleet is not None:
            # Fleet first (drain-before-retire): every replica resident
            # here serves out its
            # accepted queue and closes before the workspace handoffs run,
            # so a retired worker strands neither requests nor collector
            # threads.
            self.fleet.drain_worker(worker_id)
        for ws in self.leases.owned_by(worker_id):
            rec = self.handoff(ws, reason=reason)
            if rec is not None:
                moved += 1
            else:
                aborted += 1
        state = self._worker(worker_id)
        if state is not None and state.alive and aborted == 0:
            self.ring.remove(worker_id)
            try:
                if state.handle.sync:
                    self._note_ack(state.handle.flush())
                state.handle.stop()
            except Exception as exc:  # noqa: BLE001 — stop paths can't raise
                if is_device_error(exc):
                    raise
                if self.logger is not None:
                    self.logger.warn(f"[cluster] retire stop failed: {exc}")
            with self._lock:
                # A cleanly retired worker leaves membership entirely —
                # listing it "dead" would latch the sitrep collector to
                # warn forever over a PLANNED operation. It is remembered
                # in membership["retired"] instead.
                self._workers.pop(worker_id, None)
                self._retired.append(worker_id)
        return {"worker": worker_id, "moved": moved, "aborted": aborted,
                "retired": aborted == 0}

    # ── lifecycle / observability ────────────────────────────────────

    def drain(self, timeout_s: float = 30.0) -> None:
        """Deliver anything parked in the route-fault backlog, then flush
        every live worker's ack boundary (and, in process mode, wait for
        the in-flight set to empty). Two backlog→flush rounds: an op a
        route fault parked after the caller's last submit must still be
        delivered AND committed before drain returns — otherwise the
        final op of a run can simply vanish from the accounting."""
        for _ in range(2):
            self._drain_backlog()
            with self._lock:
                snapshot = list(self._workers.values())
            for state in snapshot:
                if not state.alive:
                    continue
                if state.handle.sync:
                    self._note_ack(state.handle.flush())
                else:
                    state.handle.flush()
        if self._result_q is not None:
            deadline = time.time() + timeout_s
            while time.time() < deadline:
                self._drain_results()
                self._drain_backlog()
                with self._lock:
                    if not self._inflight:
                        return
                time.sleep(0.01)

    def stop(self) -> None:
        if self.fleet is not None:
            self.fleet.drain()
            self.fleet.close()
        self.drain()
        with self._lock:
            snapshot = list(self._workers.values())
        if self._result_q is not None:
            # Two-phase shutdown: request every child's exit first, then
            # drain the result queue WHILE waiting — a child's final stats
            # message can exceed the pipe buffer, and an undrained pipe
            # wedges its feeder thread (observed as serial 30s join
            # timeouts per worker on the scaling bench).
            for state in snapshot:
                if state.handle.sync or not state.handle.alive:
                    continue
                try:
                    state.handle.request_stop()
                except Exception as exc:  # noqa: BLE001
                    if is_device_error(exc):
                        raise
            deadline = time.time() + 30.0
            while time.time() < deadline:
                self._drain_results()
                if not any((not s.handle.sync) and s.handle.alive
                           for s in snapshot):
                    break
                time.sleep(0.02)
            self._drain_results()
        for state in snapshot:
            try:
                if state.handle.sync:
                    state.handle.stop()
                else:
                    state.handle.finish_stop()
            except Exception as exc:  # noqa: BLE001 — stop paths can't raise
                if is_device_error(exc):
                    raise
                if self.logger is not None:
                    self.logger.warn(f"[cluster] worker stop failed: {exc}")
        self._drain_results()
        self.leases.close()

    def attach_gateway(self, gw) -> None:
        """Register the cluster's observability on a supervisor-side
        gateway: the ``cluster`` StageTimer edge in the quantile registry
        and the ``cluster.status`` method the sitrep collector reads."""
        gw.stage_timers["cluster"] = self.timer
        gw.methods["cluster.status"] = self.stats
        if self.fleet is not None:
            gw.stage_timers["fleet"] = self.fleet.timer

    def stage_snapshots(self, qs=(0.5, 0.95, 0.99)) -> dict:
        """Merged per-edge snapshots across every worker (prefix stripped,
        histograms absorbed bucket-wise) plus the supervisor's own
        ``cluster`` edge — the satellite fix: a multi-worker slo report
        aggregates all workers, not just the supervisor's process."""
        merged: dict[str, StageTimer] = {}
        with self._lock:
            snapshot = list(self._workers.values())
        for state in snapshot:
            prefix = f"{state.handle.worker_id}:"
            for name, st in state.handle.stage_states().items():
                edge = name[len(prefix):] if name.startswith(prefix) else name
                merged.setdefault(edge, StageTimer()).absorb(st)
        out = {edge: timer.snapshot(qs=qs)
               for edge, timer in sorted(merged.items())}
        out["cluster"] = self.timer.snapshot(qs=qs)
        return out

    def stats(self) -> dict:
        with self._lock:
            snapshot = sorted(self._workers.items())
            membership = {"live": [w for w, s in self._workers.items()
                                   if s.alive],
                          "dead": [w for w, s in self._workers.items()
                                   if not s.alive],
                          "retired": list(self._retired)}
            failovers = list(self._failovers)
            handoffs = list(self._handoffs)
            counters = {"routed": self.routed,
                        "redelivered": self.redelivered,
                        "routeFaults": self.route_faults,
                        "inflight": len(self._inflight),
                        "backlog": len(self._backlog),
                        "handoffAborts": self.handoff_aborts,
                        "ingressShed": self.ingress_shed}
        # handle.stats() probes per-workspace journals (path resolution,
        # registry lock) — filesystem-adjacent work that must not run
        # under the hot dispatch lock.
        workers = {}
        fenced_total = 0
        for worker_id, state in snapshot:
            row = state.handle.stats()
            row.update({"alive": state.alive,
                        "heartbeatMisses": state.misses,
                        "breaker": state.breaker.stats()})
            fenced_total += row.get("fencedRecords") or 0
            workers[worker_id] = row
        stats = {
            "workers": workers,
            "membership": membership,
            "fencedRecords": fenced_total,
            **counters,
        }
        stats["leases"] = self.leases.snapshot()
        stats["failovers"] = failovers
        stats["lastFailover"] = failovers[-1] if failovers else None
        stats["handoffs"] = handoffs
        stats["lastHandoff"] = handoffs[-1] if handoffs else None
        stats["routeLog"] = self._route_log_stats()
        if self.fleet is not None:
            stats["fleet"] = self.fleet.stats()
        if self.admission is not None:
            stats["admission"] = self.admission.stats()
        if self.leases.journal is not None:
            stats["leaseJournal"] = {
                k: self.leases.journal.stats()[k]
                for k in ("commits", "pendingRecords", "lastError")}
        return stats

    def _route_log_stats(self) -> dict:
        """Transport kind + health for the schedule's wire: the
        sitrep collector warns on a backed-up outbox or an open breaker —
        a degraded route log narrows redelivery coverage, which an
        operator should see BEFORE the next failover needs it."""
        t = self.transport
        out = {
            "kind": self.route_transport_kind,
            "published": t.stats.published,
            "publishFailures": t.stats.publish_failures,
            "replayed": t.stats.replayed,
            "outboxDropped": t.stats.outbox_dropped,
            "healthy": bool(t.healthy()),
        }
        deep = getattr(t, "stats_dict", None)
        if deep is not None:  # NATS adapter: outbox depth + breaker state
            d = deep()
            out["outboxDepth"] = d.get("outbox_len", 0)
            out["connected"] = d.get("connected")
            out["breaker"] = (d.get("breaker") or {}).get("state")
        else:
            out["outboxDepth"] = 0
        return out
