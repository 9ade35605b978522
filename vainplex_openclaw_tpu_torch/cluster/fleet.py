"""Replica fleet: model replicas as first-class cluster residents.

A copy of ``vainplex_openclaw_tpu/cluster/fleet.py`` under the same names,
kept here so the port imports nothing of the JAX package. Each live worker
owns replica batchers, and the fleet routes stage-3 validator traffic
across them with fleet-level batching awareness:

- **Every request is published to the route log before enqueue**
  (``<routeSubject>.req`` on an event transport), so the serving schedule
  is an explicit, replayable artifact.
- **A fleet-wide acked watermark** advances as requests complete (the
  contiguous frontier of route-log sequences) and is published on
  ``<ackSubject>.fleet`` every ``ackEvery`` completions, so a replacement
  recovers the redelivery position from the transport.
- **Replica death rides the failover path**: :meth:`ReplicaFleet.
  on_worker_failed` re-fetches everything past the watermark from the
  route log, filters it to the dead replica's in-flight sequences, and
  re-routes them to survivors. Results keyed by ``op["i"]`` read as
  exactly-once.
- **Scale and model events are logged too** (``<routeSubject>.ctl``), so a
  replacement replays them to adopt the serving fleet.

Routing prefers the replica whose bucket window is OPEN (``0 < pending <
maxBatch``, the fullest wins), else the least pending. Admission is
consulted once, at the fleet edge; replica batchers run admission-free.
The autoscaler is the pure :func:`autoscale_decision`; a retirement drains
the replica before it unregisters it.

What the port adds: ``device`` (None = the card; raises without one),
on which the default factory's batchers (``models/serve.shared_batcher``)
and the fleet's own :class:`~..models.registry.ModelRegistry` serve. A
retired replica's shared batchers close with ``drain=True``. A replica
whose batcher runs a collector thread is drained by waiting for the
collector's batch to complete; the JAX fleet stops draining when
``step()`` finds the queue already taken, and retires the replica with
verdicts still in flight.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Optional

from ..device import DeviceLike, resolve_device
from ..events.envelope import ClawEvent
from ..resilience.admission import AdmissionController
from ..utils.stage_timer import StageTimer

# Fleet knobs, the JAX package's key for key and value for value: they
# live under ``cluster.fleet`` and are armed behind ``cluster.fleetServing``.
FLEET_DEFAULTS = {
    "enabled": False,
    # Initial replica count (clamped to [minReplicas, maxReplicas]).
    "replicas": 2,
    "minReplicas": 1,
    "maxReplicas": 8,
    # Per-replica batcher knobs (models/batching.py semantics).
    "maxBatch": 32,
    "windowMs": 2.0,
    "checkpointDir": None,
    # Fleet-EDGE admission: consulted once per request
    # before the route publish — a shed request never enters the schedule.
    # Replica batchers always run admission-free.
    "admission": None,
    # SLO-driven autoscaler. Evaluated every ``evalEveryOps`` submissions
    # (count-based cadence, so the schedule is a pure function of the
    # trace); spawn when per-replica queue depth or windowed p99 breaches,
    # retire when both run well under. ``cooldownEvals`` holds after any
    # scale event so one burst can't thrash spawn/retire.
    "autoscale": False,
    "evalEveryOps": 64,
    "scaleUpQueueDepth": 24.0,
    "scaleDownQueueDepth": 4.0,
    "p99BudgetMs": 60.0,
    "p99Window": 256,
    "cooldownEvals": 2,
    # Route-log subjects: requests on ``<routeSubject>.req``,
    # scale/ctl events on ``<routeSubject>.ctl``, acked watermarks on
    # ``<ackSubject>.fleet`` every ``ackEvery`` completions.
    "routeSubject": "cluster.fleet",
    "ackSubject": "cluster.fleetack",
    "ackEvery": 8,
    # A fleet-wide versioned registry: versions resolve at the FLEET EDGE
    # (tenant pin > canary > active) before the route publish, so the
    # version rides the route-log payload and redelivery serves a request
    # by its original stamp. Version decisions (activate/canary/pin) are
    # ctl events a replacement replays. Bool or dict
    # (models/registry.REGISTRY_DEFAULTS); default off.
    "modelRegistry": False,
}


# How long a drain waits for a collector thread's batch before it takes
# the replica for desynchronized and stops (a batch takes milliseconds).
_COLLECTOR_WAIT_S = 60.0


def autoscale_decision(cfg: dict, replicas: int, queued: int,
                       p99_ms: Optional[float], cooldown: int) -> tuple:
    """The fleet's scale policy as a pure function — ``(action, reason)``
    with action in {"spawn", "retire", "hold"}. No clocks, no randomness,
    no I/O: the same (trace-derived) inputs always produce the same scale
    schedule, and every decision is explainable in the sitrep panel."""
    if cooldown > 0:
        return "hold", f"cooldown ({cooldown} evals left)"
    per_replica = queued / max(1, replicas)
    budget = float(cfg.get("p99BudgetMs", 60.0))
    if replicas < int(cfg.get("maxReplicas", 8)):
        up_at = float(cfg.get("scaleUpQueueDepth", 24.0))
        if per_replica >= up_at:
            return "spawn", (f"queue depth {per_replica:.1f}/replica "
                             f">= {up_at:g}")
        if p99_ms is not None and p99_ms > budget:
            return "spawn", f"p99 {p99_ms:.1f}ms over budget {budget:g}ms"
    if replicas > int(cfg.get("minReplicas", 1)):
        down_at = float(cfg.get("scaleDownQueueDepth", 4.0))
        if per_replica <= down_at and (p99_ms is None
                                       or p99_ms <= 0.5 * budget):
            return "retire", (f"queue depth {per_replica:.1f}/replica "
                              f"<= {down_at:g} and p99 under half budget")
    return "hold", "steady"


class _Replica:
    __slots__ = ("rid", "idx", "worker_id", "batcher", "scope", "alive",
                 "fifo", "pending", "oldest_at")

    def __init__(self, rid: str, idx: int, worker_id: str, batcher,
                 scope: Optional[str]):
        self.rid = rid
        self.idx = idx
        self.worker_id = worker_id
        self.batcher = batcher
        self.scope = scope          # registry scope when factory-shared
        self.alive = True
        self.fifo: list = []        # [(seq, op, ticket)] in enqueue order
        self.pending = 0
        self.oldest_at: Optional[float] = None


class ReplicaFleet:
    """Routes stage-3 validator requests across worker-resident replicas.

    Standalone-usable (the SLO harness drives one over a bare
    transport); a supervisor feeds worker failover and retirement into
    :meth:`on_worker_failed` / :meth:`drain_worker`.

    ``batcher_factory(rid, worker_id) -> (batcher, scope_or_None)`` is the
    construction seam: by default, scoped shared batchers on ``device``
    (models/serve.shared_batcher); the sim harness and tests inject
    ``model_fn`` batchers on per-replica virtual clocks. ``step_hook(rid)``
    (optional attr) runs before every batch step — the virtual-time driver
    uses it to pin the replica's clock to the schedule.
    """

    def __init__(self, config: Optional[dict] = None, *,
                 transport, clock: Callable[[], float] = time.time,
                 workers: Callable[[], list], logger=None,
                 batcher_factory: Optional[Callable] = None,
                 on_result: Optional[Callable[[dict, dict], None]] = None,
                 adopt: bool = False, registry=None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        cfg = dict(FLEET_DEFAULTS)
        cfg.update(config or {})
        self.cfg = cfg
        self.transport = transport
        self.clock = clock
        self.workers = workers
        self.logger = logger
        self.on_result = on_result or (lambda op, obs: None)
        self.timer = StageTimer()
        self.step_hook: Optional[Callable[[str], None]] = None
        self._factory = batcher_factory or self._default_batcher_factory
        self._max_batch = max(1, int(cfg.get("maxBatch", 32)))
        self._window_s = float(cfg.get("windowMs", 2.0)) / 1e3
        self._req_subject = f"{cfg.get('routeSubject', 'cluster.fleet')}.req"
        self._ctl_subject = f"{cfg.get('routeSubject', 'cluster.fleet')}.ctl"
        self._ack_subject = f"{cfg.get('ackSubject', 'cluster.fleetack')}.fleet"
        self._ack_every = max(1, int(cfg.get("ackEvery", 8)))
        self._autoscale = bool(cfg.get("autoscale", False))
        self._eval_every = max(1, int(cfg.get("evalEveryOps", 64)))
        self.admission = AdmissionController.from_config(
            cfg.get("admission") or None)
        # ONE registry per fleet: version decisions are fleet-wide,
        # ctl-logged, and every replica batcher shares it (injected via the
        # default factory). An explicit ``registry=`` wins (sim rigs book
        # stub versions); otherwise an enabled config section builds one on
        # ``device`` with the fleet checkpoint as the incumbent "v0".
        self.registry = registry
        if self.registry is None:
            from ..models.registry import ModelRegistry, registry_settings

            rcfg = registry_settings(cfg.get("modelRegistry", False))
            if rcfg["enabled"]:
                self.registry = ModelRegistry(
                    rcfg, name=f"fleet:{cfg.get('routeSubject', 'cluster.fleet')}",
                    device=self.device)
                self.registry.register("v0", cfg.get("checkpointDir"))

        # ── guarded state (self._lock; see the GUARDED table) ────────────
        self._lock = threading.Lock()
        self._replicas: dict[str, _Replica] = {}
        self._inflight: dict[int, str] = {}   # route seq -> rid
        self._acked = 0                       # fleet-wide watermark
        self._ack_unpub = 0                   # completions since publish
        self._last_seq = 0                    # highest published route seq
        self._next_idx = 0
        self._lat_window: list[float] = []
        self._decisions: list[dict] = []
        self._scale_events: list[dict] = []
        self._failovers: list[dict] = []
        self._retired: list[str] = []
        self._ops_since_eval = 0
        self._cooldown = 0
        self.routed = 0
        self.served = 0
        self.shed = 0
        self.redelivered = 0

        if adopt:
            self._adopt_fleet()
        else:
            lo = int(cfg.get("minReplicas", 1))
            hi = int(cfg.get("maxReplicas", 8))
            for _ in range(max(lo, min(hi, int(cfg.get("replicas", 2))))):
                self.spawn_replica(reason="initial")

    # ── construction seams ───────────────────────────────────────────

    def _default_batcher_factory(self, rid: str, worker_id: str):
        """Replicas come out of the scoped shared-batcher book on the
        fleet's device: one batcher per (scope, checkpoint, knobs, mesh),
        scope keyed to the owner worker so a retirement closes exactly its
        own (models/serve.close_batchers)."""
        from ..models.serve import SERVE_DEFAULTS, shared_batcher

        scfg_fleet = dict(SERVE_DEFAULTS)
        scfg_fleet["maxBatch"] = self._max_batch
        scfg_fleet["windowMs"] = float(self.cfg.get("windowMs", 2.0))
        # Admission lives at the fleet edge ONLY: an edge-admitted
        # request must never be shed again per replica.
        scfg_fleet["admission"] = None
        scope = f"{worker_id}:fleet:{rid}"
        return (shared_batcher(self.cfg.get("checkpointDir"), scfg_fleet,
                               scope=scope, registry=self.registry,
                               device=self.device), scope)

    def _pick_worker(self) -> str:
        """Live worker with the fewest resident replicas (deterministic
        tie-break by id) — bounded-load placement in miniature."""
        live = sorted(self.workers())
        if not live:
            raise RuntimeError("fleet has no live workers to place on")
        with self._lock:
            counts = {w: 0 for w in live}
            for rep in self._replicas.values():
                if rep.alive and rep.worker_id in counts:
                    counts[rep.worker_id] += 1
        return min(live, key=lambda w: (counts[w], w))

    # ── ctl / route-log publication ──────────────────────────────────

    def _publish(self, subject: str, etype: str, payload: dict) -> int:
        event = ClawEvent(
            id=f"{etype}:{payload.get('i', payload.get('rid', ''))}",
            ts=self.clock() * 1000.0,
            agent="cluster", session="cluster", type=etype,
            canonical_type=None, legacy_type=None, schema_version=1,
            source={"component": "cluster-fleet"}, actor={}, scope={},
            trace={}, visibility="internal", payload=payload)
        if not self.transport.publish(subject, event):
            return -1
        if event.seq is not None:
            return event.seq
        return self.transport.last_sequence()

    def _publish_ctl(self, action: str, rid: str, worker_id: str,
                     reason: str) -> None:
        self._publish(self._ctl_subject, "cluster.fleet.ctl",
                      {"action": action, "rid": rid, "worker": worker_id,
                       "reason": reason})

    # ── replica lifecycle ────────────────────────────────────────────

    def spawn_replica(self, worker_id: Optional[str] = None,
                      reason: str = "scale-up") -> str:
        """Place one replica on a live worker, log the decision, open for
        traffic. The spawn is replayable: a replacement supervisor counts
        ctl spawns/retires/deaths to rebuild the fleet's size."""
        if worker_id is None:
            worker_id = self._pick_worker()
        with self._lock:
            idx = self._next_idx
            self._next_idx += 1
        rid = f"r{idx}"
        batcher, scope = self._factory(rid, worker_id)
        rep = _Replica(rid, idx, worker_id, batcher, scope)
        with self._lock:
            self._replicas[rid] = rep
        self._publish_ctl("spawn", rid, worker_id, reason)
        return rid

    def retire_replica(self, rid: str, reason: str = "scale-down") -> int:
        """Planned scale-down: **drain first** — serve every request this
        replica already accepted (and ack them) — then unregister and close.
        The drain-before-retire order is a protocol invariant: flipping it
        strands accepted requests. Returns drained count."""
        served = self._drain_replica(rid)
        self._unregister(rid, reason=reason)
        return served

    def _drain_replica(self, rid: str) -> int:
        with self._lock:
            rep = self._replicas.get(rid)
        if rep is None or not rep.alive:
            return 0
        served = 0
        while True:
            with self._lock:
                remaining = rep.pending
            if remaining <= 0:
                return served
            hook = self.step_hook
            if hook is not None:
                hook(rid)
            stepped = rep.batcher.step()
            reaped = self._reap(rid)
            served += reaped
            if stepped == 0 and reaped == 0 and not self._await_head(rep):
                return served  # bookkeeping desync guard: never spin

    def _await_head(self, rep: _Replica) -> bool:
        """Wait for the head ticket when a collector thread may hold its
        batch (``step()`` found the queue already taken). False without a
        collector, or when the head stays undone for the wait."""
        if getattr(rep.batcher, "_thread", None) is None:
            return False
        with self._lock:
            head = rep.fifo[0][2] if rep.fifo else None
        return head is not None and head.done.wait(_COLLECTOR_WAIT_S)

    def _unregister(self, rid: str, reason: str = "scale-down") -> None:
        with self._lock:
            rep = self._replicas.pop(rid, None)
            if rep is None:
                return
            rep.alive = False
            self._retired.append(rid)
        self._close_replica(rep, drain=True)
        self._publish_ctl("retire", rid, rep.worker_id, reason)

    def _close_replica(self, rep: _Replica, drain: bool = False) -> None:
        """Close a replica's batcher; ``drain`` (retirement) serves what
        its scoped batchers still hold first, a failover does not."""
        if rep.scope is not None:
            from ..models.serve import close_batchers

            close_batchers(scope=rep.scope, drain=drain)
        else:
            rep.batcher.close()

    def drain_worker(self, worker_id: str) -> int:
        """Planned worker retirement, fleet side: drain-retire every replica
        resident on ``worker_id`` BEFORE the supervisor hands its workspaces
        off — a retired worker must strand neither queued requests nor
        collector threads. Returns requests served by the drains."""
        with self._lock:
            rids = sorted(r.rid for r in self._replicas.values()
                          if r.alive and r.worker_id == worker_id)
        served = 0
        for rid in rids:
            served += self.retire_replica(rid, reason=f"worker {worker_id} "
                                                      "retiring")
        return served

    def on_worker_failed(self, worker_id: str, reason: str = "") -> dict:
        """Replica death riding the failover path: every replica resident on
        the dead worker becomes a corpse (no drain — its queue is exactly
        what redelivery covers), its in-flight sequences are re-fetched from
        the route log past the fleet watermark and re-routed to survivors,
        and a replacement replica is spawned per death so capacity recovers
        like a re-granted lease."""
        with self._lock:
            dead = [r for r in self._replicas.values()
                    if r.alive and r.worker_id == worker_id]
            for rep in dead:
                rep.alive = False
                rep.fifo = []
                rep.pending = 0
                rep.oldest_at = None
        redelivered = 0
        respawned = []
        for rep in dead:
            self._close_replica(rep)
            with self._lock:
                self._replicas.pop(rep.rid, None)
            redelivered += self._redeliver_replica(rep.rid)
            self._publish_ctl("dead", rep.rid, worker_id,
                              reason or "worker failed")
            if self.workers():
                respawned.append(self.spawn_replica(
                    reason=f"replace {rep.rid} (worker {worker_id} failed)"))
        record = {"at": self.clock(), "worker": worker_id,
                  "reason": reason, "replicasLost": [r.rid for r in dead],
                  "respawned": respawned, "redelivered": redelivered}
        with self._lock:
            self.redelivered += redelivered
            self._failovers.append(record)
        return record

    def _redeliver_replica(self, rid: str) -> int:
        """Replay the route log past the acked watermark, filtered to the
        dead replica's in-flight sequences, re-routing each to a survivor —
        the supervisor's ``_redeliver`` one level up. The sequence keeps its
        original route-log identity (no republish), so the watermark
        machinery covers redelivered requests unchanged."""
        with self._lock:
            mark = self._acked
            dead_seqs = {s for s, r in self._inflight.items() if r == rid}
        if not dead_seqs:
            return 0
        count = 0
        for event in self.transport.fetch(subject_filter=self._req_subject,
                                          start_seq=mark):
            if event.seq not in dead_seqs:
                continue
            op = dict(event.payload or {})
            new_rid = self._route(op)
            if new_rid is None:
                raise RuntimeError("fleet has no live replicas left")
            self._assign(new_rid, event.seq, op)
            count += 1
        return count

    # ── request path ─────────────────────────────────────────────────

    def _depth(self) -> int:
        with self._lock:
            return sum(r.pending for r in self._replicas.values() if r.alive)

    def _route(self, op: dict) -> Optional[str]:
        """Batching-aware routing: fullest OPEN bucket window first (join
        the forming batch), else least-pending; deterministic tie-break by
        replica index. Pure placement — no I/O, runs under the hot lock."""
        with self._lock:
            alive = [r for r in self._replicas.values() if r.alive]
            if not alive:
                return None
            open_windows = [r for r in alive
                            if 0 < r.pending < self._max_batch]
            if open_windows:
                best = max(open_windows, key=lambda r: (r.pending, -r.idx))
            else:
                best = min(alive, key=lambda r: (r.pending, r.idx))
            return best.rid

    def _assign(self, rid: str, seq: int, op: dict) -> Any:
        """Enqueue on the chosen replica and book the in-flight sequence."""
        with self._lock:
            rep = self._replicas.get(rid)
        if rep is None:
            return None
        kwargs: dict = {"at": op.get("at")}
        if op.get("version") is not None:
            # Keyword only when stamped: injected sim batchers without the
            # version seam keep their enqueue signature working.
            kwargs["version"] = op.get("version")
        ticket = rep.batcher.enqueue(str(op.get("text") or ""),
                                     str(op.get("tenant") or "serve"),
                                     **kwargs)
        with self._lock:
            rep.fifo.append((seq, op, ticket))
            rep.pending += 1
            if rep.oldest_at is None:
                rep.oldest_at = (op.get("at")
                                 if op.get("at") is not None
                                 else ticket.enqueued_at)
            if seq >= 0:
                self._inflight[seq] = rid
                if seq > self._last_seq:
                    self._last_seq = seq
            self.routed += 1
        return ticket

    def submit(self, op: dict) -> Optional[str]:
        """Route one validator request: fleet-edge admission → route-log
        publish → batching-aware placement → enqueue. Returns the replica
        id (None when shed). ``op`` needs ``i`` (result key) and ``text``;
        ``tenant`` and ``at`` (virtual arrival) are optional. Results fire
        through ``on_result(op, {"verdict", "latMs"})`` as batches complete
        (:meth:`pump` / :meth:`step_replica`)."""
        if self.admission is not None:
            self.admission.note_queue_depth(self._depth() + 1)
            if not self.admission.admit(str(op.get("tenant") or "serve")):
                with self._lock:
                    self.shed += 1
                self.on_result(dict(op), {"shed": True})
                return None
        if self.registry is not None and op.get("version") is None:
            # Version resolved at the fleet EDGE, before the publish: the
            # stamp rides the route-log payload, so a redelivered or
            # adopted request is served by the version that admitted it —
            # never silently re-resolved onto whatever is active later.
            op = dict(op, version=self.registry.resolve(
                str(op.get("tenant") or "serve")))
        pc = time.perf_counter
        t0 = pc()
        rid = self._route(op)
        if rid is None:
            raise RuntimeError("fleet has no live replicas")
        seq = self._publish(self._req_subject, "cluster.fleet.route",
                            dict(op))
        self._assign(rid, seq, op)
        self.timer.add("route", (pc() - t0) * 1e3)
        self._maybe_autoscale()
        return rid

    def step_replica(self, rid: str) -> int:
        """Serve one batch on ``rid`` (manual/virtual-time drive) and reap
        completions. Returns requests completed."""
        with self._lock:
            rep = self._replicas.get(rid)
        if rep is None or not rep.alive or rep.pending <= 0:
            return 0
        hook = self.step_hook
        if hook is not None:
            hook(rid)
        rep.batcher.step()
        return self._reap(rid)

    def pump(self, now: Optional[float] = None) -> int:
        """Wall/driver loop: step every replica whose bucket window is due —
        full (``pending >= maxBatch``) or expired (``now`` past the oldest
        enqueue + windowMs). ``now=None`` steps everything with work."""
        done = 0
        while True:
            with self._lock:
                due = [r.rid for r in self._replicas.values()
                       if r.alive and r.pending > 0
                       and (now is None or r.pending >= self._max_batch
                            or (r.oldest_at is not None
                                and now - r.oldest_at >= self._window_s))]
            if not due:
                return done
            for rid in sorted(due):
                done += self.step_replica(rid)

    def _reap(self, rid: str) -> int:
        """Pop completed tickets off the replica's FIFO, deliver results,
        advance the fleet watermark, publish it every ``ackEvery``."""
        with self._lock:
            rep = self._replicas.get(rid)
            if rep is None:
                return 0
            finished = []
            while rep.fifo and rep.fifo[0][2].done.is_set():
                finished.append(rep.fifo.pop(0))
            rep.pending = len(rep.fifo)
            rep.oldest_at = None
            if rep.fifo:
                head_op = rep.fifo[0][1]
                rep.oldest_at = (head_op.get("at")
                                 if head_op.get("at") is not None
                                 else rep.fifo[0][2].enqueued_at)
        if not finished:
            return 0
        done_at = rep.batcher._clock()
        to_publish = None
        with self._lock:
            for seq, op, ticket in finished:
                if seq >= 0:
                    self._inflight.pop(seq, None)
                self.served += 1
                self._ack_unpub += 1
                lat = (done_at - ticket.enqueued_at) * 1e3
                self._lat_window.append(lat)
            window = int(self.cfg.get("p99Window", 256))
            if len(self._lat_window) > window:
                self._lat_window = self._lat_window[-window:]
            mark = (min(self._inflight) - 1 if self._inflight
                    else self._last_seq)
            if mark > self._acked:
                self._acked = mark
            if self._ack_unpub >= self._ack_every:
                self._ack_unpub = 0
                to_publish = self._acked
        for seq, op, ticket in finished:
            obs = ({"error": str(ticket.error)} if ticket.error is not None
                   else {"verdict": ticket.result,
                         "latMs": (done_at - ticket.enqueued_at) * 1e3})
            if getattr(ticket, "version", None) is not None:
                # Every verdict carries the version that served it; a
                # mis-versioned count reads this.
                obs["version"] = ticket.version
            self.on_result(op, obs)
        if to_publish is not None:
            self._publish(self._ack_subject, "cluster.fleet.ack",
                          {"watermark": to_publish})
        return len(finished)

    # ── autoscaler ───────────────────────────────────────────────────

    def _p99(self) -> Optional[float]:
        with self._lock:
            window = list(self._lat_window)
        if not window:
            return None
        ordered = sorted(window)
        return ordered[int(0.99 * (len(ordered) - 1))]

    def _maybe_autoscale(self) -> Optional[dict]:
        if not self._autoscale:
            return None
        with self._lock:
            self._ops_since_eval += 1
            if self._ops_since_eval < self._eval_every:
                return None
            self._ops_since_eval = 0
            n_alive = sum(1 for r in self._replicas.values() if r.alive)
            queued = sum(r.pending for r in self._replicas.values()
                         if r.alive)
            cooldown = self._cooldown
            if cooldown > 0:
                self._cooldown -= 1
            at_op = self.routed
        action, reason = autoscale_decision(self.cfg, n_alive, queued,
                                            self._p99(), cooldown)
        decision = {"atOp": at_op, "action": action, "reason": reason,
                    "replicas": n_alive, "queued": queued}
        with self._lock:
            self._decisions.append(decision)
        if action == "hold":
            return decision
        self._publish_ctl(f"decision-{action}", "", "", reason)
        if action == "spawn":
            rid = self.spawn_replica(reason=reason)
            decision = dict(decision, rid=rid)
        else:
            with self._lock:
                candidates = [r for r in self._replicas.values() if r.alive]
            victim = min(candidates, key=lambda r: (r.pending, -r.idx))
            self.retire_replica(victim.rid, reason=reason)
            decision = dict(decision, rid=victim.rid)
        with self._lock:
            self._cooldown = int(self.cfg.get("cooldownEvals", 2))
            self._scale_events.append(decision)
        return decision

    # ── model lifecycle ctl ──────────────────────────────────────────

    def _publish_model(self, op: str, version: str = "", tenant: str = "",
                       fraction: float = 0.0, reason: str = "") -> None:
        self._publish(self._ctl_subject, "cluster.fleet.ctl",
                      {"action": "model", "op": op, "version": version,
                       "tenant": tenant, "fraction": fraction,
                       "reason": reason})

    def activate_model(self, version: str, reason: str = "rollout") -> None:
        """Fleet-wide hot swap, ctl-logged BEFORE application (the
        decision is a replayable schedule entry, so a
        replacement supervisor adopting from the route log lands on the
        same active version). Application runs the per-replica swap
        protocol — drain the open window, place once through the shared
        placement cache, resume — rollback included (activate the
        registry's rollback target)."""
        if self.registry is None:
            raise RuntimeError("fleet has no model registry "
                               "(cluster fleet modelRegistry is off)")
        self._publish_model("activate", version=str(version), reason=reason)
        self._apply_model({"op": "activate", "version": str(version)})

    def set_model_canary(self, version: str, fraction: float,
                         reason: str = "canary") -> None:
        if self.registry is None:
            raise RuntimeError("fleet has no model registry")
        self._publish_model("canary", version=str(version),
                            fraction=float(fraction), reason=reason)
        self._apply_model({"op": "canary", "version": str(version),
                           "fraction": float(fraction)})

    def pin_tenant_model(self, tenant: str, version: str,
                         reason: str = "pin") -> None:
        if self.registry is None:
            raise RuntimeError("fleet has no model registry")
        self._publish_model("pin", version=str(version), tenant=str(tenant),
                            reason=reason)
        self._apply_model({"op": "pin", "version": str(version),
                           "tenant": str(tenant)})

    def unpin_tenant_model(self, tenant: str, reason: str = "unpin") -> None:
        if self.registry is None:
            raise RuntimeError("fleet has no model registry")
        self._publish_model("pin", tenant=str(tenant), reason=reason)
        self._apply_model({"op": "pin", "tenant": str(tenant)})

    def _apply_model(self, payload: dict) -> None:
        """Apply one model ctl payload to the fleet registry — the shared
        path for live verbs and adoption replay. Replayed versions this
        generation has not (yet) registered are skipped with a warning,
        never a crash: adoption must finish even when a deployment trimmed
        its version book."""
        reg = self.registry
        if reg is None:
            return
        op = str(payload.get("op") or "")
        version = str(payload.get("version") or "")
        if version and not reg.has(version):
            if self.logger is not None:
                self.logger.warn(f"[fleet] model ctl {op!r} skipped: "
                                 f"version {version!r} not registered "
                                 "in this generation")
            return
        if op == "activate":
            with self._lock:
                rids = sorted(r.rid for r in self._replicas.values()
                              if r.alive)
            for rid in rids:
                with self._lock:
                    rep = self._replicas.get(rid)
                if rep is not None and rep.alive \
                        and hasattr(rep.batcher, "swap_to"):
                    rep.batcher.swap_to(version)
            if reg.active() != version:  # no replicas live yet (adoption)
                reg.activate(version)
        elif op == "canary":
            if version:
                reg.set_canary(version, float(payload.get("fraction") or 0.0))
            else:
                reg.clear_canary()
        elif op == "pin":
            tenant = str(payload.get("tenant") or "")
            if version:
                reg.pin(tenant, version)
            else:
                reg.unpin(tenant)

    # ── adoption (replacement supervisor) ────────────────────────────

    def recover_watermark(self) -> int:
        """Max published fleet watermark from the schedule's ack events —
        where a replacement starts redelivery. No published ack → 0: full
        route-log replay, the conservative direction."""
        mark = 0
        for event in self.transport.fetch(subject_filter=self._ack_subject):
            payload = event.payload or {}
            try:
                m = int(payload.get("watermark") or 0)
            except (TypeError, ValueError):
                continue
            if m > mark:
                mark = m
        return mark

    def _adopt_fleet(self) -> None:
        """Adopt a serving fleet from the schedule: replay the ctl log to
        learn the fleet's size (spawns − retires − deaths), spawn that many
        fresh replicas on this supervisor's workers, then redeliver every
        request past the recovered watermark. Requests completed-but-
        unacked by the previous generation re-run — at-least-once, read as
        exactly-once by result keying, exactly like workspace adoption."""
        size = 0
        max_idx = -1
        model_ops: list[dict] = []
        for event in self.transport.fetch(subject_filter=self._ctl_subject):
            payload = event.payload or {}
            action = payload.get("action")
            if action == "model":
                # Version decisions replay in order AFTER the fleet is
                # re-sized — the last activate/canary/pin state wins,
                # exactly what the previous generation was serving.
                model_ops.append(dict(payload))
                continue
            if action == "spawn":
                size += 1
                rid = str(payload.get("rid") or "")
                if rid.startswith("r"):
                    try:
                        max_idx = max(max_idx, int(rid[1:]))
                    except ValueError:
                        pass
            elif action in ("retire", "dead"):
                size -= 1
        lo = int(self.cfg.get("minReplicas", 1))
        hi = int(self.cfg.get("maxReplicas", 8))
        if size <= 0:
            size = int(self.cfg.get("replicas", 2))
        size = max(lo, min(hi, size))
        with self._lock:
            self._next_idx = max_idx + 1
            self._acked = 0
        mark = self.recover_watermark()
        with self._lock:
            self._acked = mark
        for _ in range(size):
            self.spawn_replica(reason="adoption")
        for payload in model_ops:
            self._apply_model(payload)
        redelivered = 0
        for event in self.transport.fetch(subject_filter=self._req_subject,
                                          start_seq=mark):
            op = dict(event.payload or {})
            rid = self._route(op)
            if rid is None:
                raise RuntimeError("fleet adoption found no live replicas")
            self._assign(rid, event.seq if event.seq is not None else -1, op)
            redelivered += 1
        with self._lock:
            self.redelivered += redelivered
            if redelivered:
                self._failovers.append({
                    "at": self.clock(), "worker": "(adopted)",
                    "reason": "supervisor adoption",
                    "replicasLost": [], "respawned": [],
                    "redelivered": redelivered})

    # ── lifecycle / observability ────────────────────────────────────

    def drain(self) -> int:
        """Serve everything pending on every live replica (run end)."""
        with self._lock:
            rids = sorted(r.rid for r in self._replicas.values() if r.alive)
        return sum(self._drain_replica(rid) for rid in rids)

    def close(self) -> None:
        with self._lock:
            reps = list(self._replicas.values())
            self._replicas.clear()
        for rep in reps:
            rep.alive = False
            self._close_replica(rep)

    def occupancy(self) -> dict:
        """Per-replica window occupancy for routers/drivers/sitrep."""
        with self._lock:
            return {r.rid: {"workerId": r.worker_id, "alive": r.alive,
                            "pending": r.pending, "oldestAt": r.oldest_at,
                            "maxBatch": self._max_batch,
                            "windowOpen": 0 < r.pending < self._max_batch}
                    for r in self._replicas.values()}

    def stage_states(self) -> dict:
        """Mergeable StageTimer states across replicas + the fleet's own
        route edge — the cross-replica quantile view (StageTimer.absorb)."""
        with self._lock:
            reps = list(self._replicas.values())
        out = {"fleet": self.timer.state()}
        for rep in reps:
            out[f"{rep.rid}:serve"] = rep.batcher.timer.state()
        return out

    def stats(self) -> dict:
        with self._lock:
            reps = sorted(self._replicas.values(), key=lambda r: r.idx)
            counters = {"routed": self.routed, "served": self.served,
                        "shed": self.shed, "redelivered": self.redelivered,
                        "inflight": len(self._inflight),
                        "watermark": self._acked}
            decisions = list(self._decisions)
            scale_events = list(self._scale_events)
            failovers = list(self._failovers)
            retired = list(self._retired)
            cooldown = self._cooldown
        replicas = {}
        for rep in reps:
            row = rep.batcher.stats()
            replicas[rep.rid] = {
                "worker": rep.worker_id, "alive": rep.alive,
                "pending": rep.pending,
                "windowOpen": 0 < rep.pending < self._max_batch,
                "maxBatch": self._max_batch,
                "mesh": row.get("mesh"), "served": row.get("served"),
                "batches": row.get("batches"),
                "meanBatch": row.get("meanBatch")}
        p99 = self._p99()
        budget = float(self.cfg.get("p99BudgetMs", 60.0))
        out = {"replicas": replicas,
               "membership": {"alive": [r.rid for r in reps if r.alive],
                              "dead": [r.rid for r in reps if not r.alive],
                              "retired": retired},
               **counters,
               "p99Ms": p99, "p99BudgetMs": budget,
               "sloBreached": bool(p99 is not None and p99 > budget),
               "autoscaler": {"enabled": self._autoscale,
                              "cooldown": cooldown,
                              "decisions": len(decisions),
                              "lastDecision": (decisions[-1] if decisions
                                               else None),
                              "scaleEvents": scale_events},
               "failovers": failovers,
               "lastFailover": failovers[-1] if failovers else None}
        if self.admission is not None:
            out["admission"] = self.admission.stats()
        if self.registry is not None:
            out["modelRegistry"] = self.registry.stats()
        return out
