"""Open-loop SLO harness over the full serving pipeline, and the replica
fleet's virtual-time SLO runs.

The port's copy of ``vainplex_openclaw_tpu/slo/harness.py``, kept here so
the port imports nothing of the JAX package.

The gateway half (``run_slo_report``) drives the seeded workload
(``workload.py``) through a real gateway with all five plugins loaded —
governance enforcement + redaction, cortex ingest, knowledge extraction,
event mirroring, sitrep — and reports p50/p95/p99 per stage and
end-to-end, admission-control shedding, and verdict-path integrity.

- ``mode="wall"`` — honest wall-clock measurement. Capacity is calibrated
  on a throwaway gateway first, then the workload is offered OPEN-LOOP at
  ``saturation`` × capacity: each op has a scheduled arrival instant and
  its latency is measured from that instant (not from dispatch), so queue
  wait is charged to the report — no coordinated omission.
- ``mode="sim"`` — deterministic discrete-event run. The same real
  pipeline executes (verdicts, redaction, shed decisions, stage counts
  all real), but time comes from a virtual clock and per-op service times
  from a seeded log-normal model, so the whole report is bit-identical
  for a given seed, and equal to the JAX package's. Sim reports carry
  stage *counts* instead of stage quantiles.
- ``workers > 0`` runs the same workload through the port's
  ``ClusterSupervisor`` over in-process workers (wall mode only).

The knowledge plugin's local embeddings take ``device`` (None = the card;
tests pass ``device="cpu"``): the harness's gateways ask for the card as
every entry point of the port does.

The fleet half (``run_fleet_slo_report``) drives a real
:class:`~..cluster.fleet.ReplicaFleet` in virtual time; a report is
bit-identical per (seed, args), and equal to the JAX package's.
"""

from __future__ import annotations

import hashlib
import random
import tempfile
import time
from pathlib import Path

from ..device import DeviceLike
from ..utils.stage_timer import StageTimer


# Simulated service-time model (seconds) per op kind. The absolute values
# are a stylized container profile (persist-dominated messages, cheaper
# verdict-only tool ops); what matters is the RATIO — shedding a message's
# cortex/knowledge handlers removes ~94% of its cost, which is what makes
# 2x-saturation degradation graceful rather than collapsing.
_SIM_SERVICE_S = {"msg_in": 0.0020, "msg_out": 0.0018, "tool_ok": 0.0012,
                  "tool_denied": 0.0010, "tool_secret": 0.0008}
_SIM_SHED_FACTOR = 0.06
SIM_CAPACITY_OPS_S = 600.0  # ≈ 1 / Σ p(kind)·service(kind)

_QS = (0.5, 0.95, 0.99)


class _SimClock:
    """Mutable virtual clock."""

    def __init__(self, start: float = 1_753_772_400.0):
        self.t = start

    def __call__(self) -> float:
        return self.t


def _build_gateway(root: Path, tenants: int, clock, admission: bool,
                   watermark: int, device: DeviceLike = None):
    from ..core import Gateway
    from ..cortex import CortexPlugin
    from ..events import EventStorePlugin
    from ..events.transport import MemoryTransport
    from ..governance import GovernancePlugin
    from ..knowledge import KnowledgeEnginePlugin
    from ..sitrep import SitrepPlugin

    config = {"workspace": str(root),
              "agents": [{"id": f"agent{i}"} for i in range(tenants)]}
    if admission:
        config["resilience"] = {"admission": {"enabled": True,
                                              "highWatermark": watermark,
                                              "shedAllFactor": 4.0}}
    kwargs = {} if clock is None else {"clock": clock}
    gw = Gateway(config=config, **kwargs)
    gov = GovernancePlugin(workspace=str(root), **kwargs)
    gw.load(gov, plugin_config={
        "redaction": {"enabled": True},
        "builtinPolicies": {"credentialGuard": True,
                            "rateLimiter": {"maxPerMinute": 10_000_000}},
    })
    transport = MemoryTransport(**kwargs)
    gw.load(EventStorePlugin(transport=transport, **kwargs), plugin_config={})
    cortex = CortexPlugin(workspace=str(root), wall_timers=False, **kwargs)
    gw.load(cortex, plugin_config={"languages": "all",
                                   "traceAnalyzer": {"enabled": False}})
    knowledge = KnowledgeEnginePlugin(workspace=str(root), wall_timers=False,
                                      device=device, **kwargs)
    gw.load(knowledge, plugin_config={})
    sitrep = SitrepPlugin(workspace=str(root), wall_timers=False, **kwargs)
    gw.load(sitrep, plugin_config={"intervalMinutes": 0})
    gw.start()
    return gw, sitrep


def _tenant_ctx(root: Path, tenant: int) -> dict:
    return {"agent_id": f"agent{tenant}",
            "session_key": f"agent:agent{tenant}:slo",
            "workspace": str(root / f"tenant{tenant}")}


def _dispatch(gw, op, ctx) -> dict:
    """Run one op through the gateway; returns verdict-path observations.
    Delegates to the cluster's shared op dispatcher so the
    single-process and sharded paths execute the identical pipeline."""
    from ..cluster.worker import dispatch_op

    return dispatch_op(gw, op.kind, op.content, ctx)


def _normalize_edge(name: str, root: Path) -> str:
    """cortex:/tmp/xyz/tenant3 → cortex:tenant3 (stable report keys)."""
    return name.replace(str(root) + "/", "").replace(str(root), "ws")


def _calibrate(ops, tenants: int, watermark: int,
               device: DeviceLike = None) -> float:
    """Closed-loop ops/s on a throwaway gateway — the capacity that
    ``saturation`` scales. Uses the workload's own head so the calibration
    mix matches the offered mix. Zombie-writer ops never reach
    the gateway, so they are not part of its capacity either."""
    ops = [op for op in ops if op.kind != "zombie_write"]
    sample = ops[:min(220, len(ops))]
    # Warmup shrinks with tiny workloads so the timed set is never empty
    # (a 40-op warmup on a 40-op run would report garbage capacity).
    warm = max(0, min(40, len(sample) - 10))
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        gw, _ = _build_gateway(root, tenants, None, False, watermark,
                               device=device)
        ctxs = {t: _tenant_ctx(root, t) for t in range(tenants)}
        for t in range(tenants):
            gw.session_start(ctxs[t])
        for op in sample[:warm]:  # warmup: banks, indexes, first persist
            _dispatch(gw, op, ctxs[op.tenant])
        t0 = time.perf_counter()
        for op in sample[warm:]:
            _dispatch(gw, op, ctxs[op.tenant])
        dt = time.perf_counter() - t0
        gw.stop()
    return max(len(sample) - warm, 1) / max(dt, 1e-6)


def run_slo_report(seed: int = 0, n_ops: int = 2000, tenants: int = 4,
                   saturation: float = 1.0, mode: str = "wall",
                   admission: bool = True, watermark: int = 32,
                   workers: int = 0, device: DeviceLike = None) -> dict:
    """The ``bench.py slo_report`` entry point. Returns one JSON-ready
    record; see module docstring for the wall/sim contract. ``device``
    (None = the card) is the knowledge plugin's, where its local
    embeddings run.

    ``workers > 0`` runs the SAME workload through a
    workspace-sharded cluster of in-process workers instead of one gateway:
    per-worker stage timers are merged bucket-wise (not just the
    supervisor's process — the satellite fix), and the report gains a
    ``cluster`` section with membership/lease/failover state. Wall mode
    only: the cluster path has no virtual-clock service model."""
    from .workload import generate_workload, workload_digest

    if mode not in ("wall", "sim"):
        raise ValueError(f"mode must be 'wall' or 'sim', got {mode!r}")
    if n_ops < 1:
        raise ValueError(f"n_ops must be >= 1, got {n_ops}")
    if saturation <= 0:
        raise ValueError(f"saturation must be > 0, got {saturation}")
    if tenants < 1:
        raise ValueError(f"tenants must be >= 1, got {tenants}")
    if workers:
        if mode != "wall":
            raise ValueError("workers mode requires mode='wall'")
        return _run_cluster_report(seed, n_ops, tenants, saturation,
                                   int(workers), watermark,
                                   admission=admission, device=device)
    ops = generate_workload(seed, n_ops, tenants)
    digest = workload_digest(ops)
    return _run_single_report(ops, digest, seed=seed, tenants=tenants,
                              saturation=saturation, mode=mode,
                              admission=admission, watermark=watermark,
                              device=device)


def _run_single_report(ops, digest, *, seed: int, tenants: int,
                       saturation: float, mode: str, admission: bool,
                       watermark: int, metric: str = "slo_report",
                       zombie_factory=None,
                       device: DeviceLike = None) -> dict:
    """The single-process engine behind :func:`run_slo_report`, factored
    out so the adversarial runner can offer a merged
    friendly+attack op stream through the IDENTICAL loop. Two additions
    ride along for every caller:

    - per-tenant e2e quantiles (``e2e.byTenant`` — the tenant-skew
      isolation gate's measurement, and a useful ``/ops`` block on its own);
    - ``zombie_factory(root)`` — when set, ops of kind ``zombie_write``
      are routed to the returned handler instead of the gateway (they
      model a PARTITIONED writer attacking the fence, not edge traffic),
      and its ``stats()`` land in the report as ``fence``.
    """
    if mode == "wall":
        capacity = _calibrate(ops, tenants, watermark, device=device)
        rate = capacity * saturation
        clock = None
    else:
        capacity = SIM_CAPACITY_OPS_S
        rate = capacity * saturation
        clock = _SimClock()

    e2e = StageTimer()
    expected_denials = sum(1 for op in ops if op.kind == "tool_denied")
    expected_redactions = sum(1 for op in ops if op.kind == "tool_secret")
    observed_denials = 0
    observed_redactions = 0
    false_blocks = 0

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        gw, sitrep = _build_gateway(root, tenants, clock, admission, watermark,
                                    device=device)
        zombie = zombie_factory(root) if zombie_factory is not None else None
        ctxs = {t: _tenant_ctx(root, t) for t in range(tenants)}
        for t in range(tenants):
            gw.session_start(ctxs[t])

        arrivals = [op.arrival / rate for op in ops]  # seconds from start
        adm = gw.admission

        if mode == "wall":
            t0 = time.perf_counter()
            arrived = 0
            for i, op in enumerate(ops):
                sched = t0 + arrivals[i]
                now = time.perf_counter()
                while now < sched:  # open-loop: honor the arrival schedule
                    time.sleep(min(sched - now, 0.0005))
                    now = time.perf_counter()
                if op.kind == "zombie_write":
                    # Fence attack, not edge traffic: it spends no gateway
                    # capacity and earns no latency sample.
                    if zombie is not None:
                        zombie.handle(op)
                    continue
                if adm is not None:
                    while arrived < len(ops) and t0 + arrivals[arrived] <= now:
                        arrived += 1
                    adm.note_queue_depth(arrived - i)
                obs = _dispatch(gw, op, ctxs[op.tenant])
                lat_ms = (time.perf_counter() - sched) * 1000.0
                e2e.add("e2e", lat_ms)
                e2e.add(f"kind:{op.kind}", lat_ms)
                e2e.add(f"tenant:tenant{op.tenant}", lat_ms)
                observed_denials += _denied(obs, op)
                observed_redactions += _redacted(obs)
                false_blocks += _false_block(obs, op)
            elapsed = time.perf_counter() - t0
        else:
            svc_rng = random.Random(f"svc:{seed}")
            factors = [svc_rng.lognormvariate(0.0, 0.4) for _ in ops]
            server_free = 0.0
            base_t = clock.t
            arrived = 0
            for i, op in enumerate(ops):
                if op.kind == "zombie_write":
                    # max(): the busy server may already sit past this
                    # arrival — a sim clock must never run backward.
                    clock.t = max(clock.t, base_t + arrivals[i])
                    if zombie is not None:
                        zombie.handle(op)
                    continue
                start = max(arrivals[i], server_free)
                clock.t = base_t + start
                if adm is not None:
                    while arrived < len(ops) and arrivals[arrived] <= start:
                        arrived += 1
                    adm.note_queue_depth(arrived - i)
                    shed_before = adm.shed
                obs = _dispatch(gw, op, ctxs[op.tenant])
                service = _SIM_SERVICE_S[op.kind] * factors[i]
                if adm is not None and adm.shed > shed_before:
                    service *= _SIM_SHED_FACTOR
                done = start + service
                server_free = done
                lat_ms = (done - arrivals[i]) * 1000.0
                e2e.add("e2e", lat_ms)
                e2e.add(f"kind:{op.kind}", lat_ms)
                e2e.add(f"tenant:tenant{op.tenant}", lat_ms)
                observed_denials += _denied(obs, op)
                observed_redactions += _redacted(obs)
                false_blocks += _false_block(obs, op)
            elapsed = max(server_free, arrivals[-1])

        for t in range(tenants):
            gw.session_end(ctxs[t])

        status = gw.get_status()
        hook_stats = {name: dict(st) for name, st in sorted(status["hooks"].items())}
        admission_stats = dict(status["admission"])
        if admission_stats.get("shedByTenant"):
            # Tenant keys are tmp workspace paths — normalize so the
            # report is stable across runs (the determinism contract).
            admission_stats["shedByTenant"] = {
                _normalize_edge(k, root): v
                for k, v in admission_stats["shedByTenant"].items()}

        if mode == "wall":
            edge_snaps = {_normalize_edge(name, root): timer.snapshot(qs=_QS)
                          for name, timer in sorted(gw.stage_timers.items())}
            stage_counts = {edge: snap["counts"]
                            for edge, snap in sorted(edge_snaps.items())}
        else:
            # Sim reports carry counts only — skip the quantile estimation
            # the wall snapshot pays, it would be discarded anyway.
            edge_snaps = {}
            stage_counts = {_normalize_edge(name, root): timer.counts()
                            for name, timer in sorted(gw.stage_timers.items())}

        sitrep_report = sitrep.generate()
        sitrep_line = {
            "health": sitrep_report["health"],
            "gatewayShed": ((sitrep_report["collectors"].get("gateway") or {})
                            .get("shed", None)),
        }
        gw.stop()

    e2e_snap = e2e.snapshot(qs=_QS)
    e2e_q = e2e_snap["quantiles"]

    report = {
        "metric": metric,
        "seed": seed,
        "mode": mode,
        "saturation": saturation,
        "tenants": tenants,
        "admission": admission_stats,
        "capacity_ops_s": round(capacity, 1),
        "offered_ops_s": round(rate, 1),
        "workload": digest,
        "verdicts": {
            "expected_denials": expected_denials,
            "observed_denials": observed_denials,
            "expected_redactions": expected_redactions,
            "observed_redactions": observed_redactions,
            "false_blocks": false_blocks,
            "losses": (expected_denials - observed_denials)
                      + (expected_redactions - observed_redactions),
        },
        "e2e": {"count": e2e_snap["counts"].get("e2e", 0),
                **{k: v for k, v in e2e_q.get("e2e", {}).items()},
                "byKind": {k.split(":", 1)[1]: q
                           for k, q in sorted(e2e_q.items())
                           if k.startswith("kind:")},
                "byTenant": {k.split(":", 1)[1]: q
                             for k, q in sorted(e2e_q.items())
                             if k.startswith("tenant:")}},
        "stage_counts": stage_counts,
        "hook_stats": hook_stats,
        "sitrep": sitrep_line,
        "elapsed_s": round(elapsed, 3),
        "throughput_ops_s": round(len(ops) / max(elapsed, 1e-9), 1),
    }
    if zombie is not None:
        report["fence"] = zombie.stats()
    if mode == "wall":
        # Real per-stage quantiles only exist under a real clock.
        report["stages"] = {edge: snap["quantiles"]
                            for edge, snap in edge_snaps.items()}
    return report


def _run_cluster_report(seed: int, n_ops: int, tenants: int,
                        saturation: float, workers: int,
                        watermark: int, admission: bool = True,
                        device: DeviceLike = None) -> dict:
    """The ``workers > 0`` branch: same seeded workload, offered open-loop
    at ``saturation`` × single-process capacity, routed through a real
    :class:`..cluster.ClusterSupervisor` over in-process workers. Verdict
    accounting keys by op index so an op redelivered after a failover
    counts once, with its final observation.

    Supervisor-side admission: the
    driver reports arrival backlog to the supervisor exactly like the
    single-process loop reports it to the gateway's controller, and the
    supervisor sheds sheddable op KINDS at ingress — verdict kinds are
    never consulted, so ``losses`` stays the invariant it always was."""
    from ..cluster import ClusterSupervisor
    from .workload import generate_workload, workload_digest

    ops = generate_workload(seed, n_ops, tenants)
    digest = workload_digest(ops)
    capacity = _calibrate(ops, tenants, watermark, device=device)
    rate = capacity * saturation

    e2e = StageTimer()
    expected_denials = sum(1 for op in ops if op.kind == "tool_denied")
    expected_redactions = sum(1 for op in ops if op.kind == "tool_secret")
    results: dict[int, dict] = {}

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        sup = ClusterSupervisor(
            root, {"workers": workers,
                   "admission": ({"enabled": True,
                                  "highWatermark": watermark}
                                 if admission else None)},
            wall_timers=True,
            on_result=lambda op, obs: results.__setitem__(op.get("i"), obs))
        # Supervisor-side gateway: hosts sitrep so /ops renders the cluster
        # collector exactly as a deployment would see it.
        from ..core import Gateway
        from ..sitrep import SitrepPlugin

        gw = Gateway(config={"workspace": str(root)})
        sitrep = SitrepPlugin(workspace=str(root), wall_timers=False)
        gw.load(sitrep, plugin_config={"intervalMinutes": 0})
        sup.attach_gateway(gw)
        gw.start()

        arrivals = [op.arrival / rate for op in ops]
        t0 = time.perf_counter()
        arrived = 0
        for i, op in enumerate(ops):
            sched = t0 + arrivals[i]
            now = time.perf_counter()
            while now < sched:
                time.sleep(min(sched - now, 0.0005))
                now = time.perf_counter()
            if sup.admission is not None:
                while arrived < len(ops) and t0 + arrivals[arrived] <= now:
                    arrived += 1
                sup.note_queue_depth(arrived - i)
            sup.submit({"i": op.index, "ws": str(root / f"tenant{op.tenant}"),
                        "wsKey": f"tenant{op.tenant}", "kind": op.kind,
                        "content": op.content})
            lat_ms = (time.perf_counter() - sched) * 1000.0
            e2e.add("e2e", lat_ms)
            e2e.add(f"kind:{op.kind}", lat_ms)
            e2e.add(f"tenant:tenant{op.tenant}", lat_ms)
            if i % 50 == 0:
                sup.tick()
        sup.drain()
        elapsed = time.perf_counter() - t0

        observed_denials = observed_redactions = false_blocks = 0
        for op in ops:
            obs = results.get(op.index, {})
            observed_denials += _denied(obs, op)
            observed_redactions += _redacted(obs)
            false_blocks += _false_block(obs, op)

        edge_snaps = {_normalize_edge(name, root): snap
                      for name, snap in sup.stage_snapshots(qs=_QS).items()}
        hook_stats: dict[str, dict] = {}
        for state in sup.workers().values():
            for hook, st in state.handle.gw.get_status()["hooks"].items():
                row = hook_stats.setdefault(
                    hook, {"fired": 0, "errors": 0, "skipped": 0})
                for k in row:
                    row[k] += st.get(k, 0)

        sitrep_report = sitrep.generate()
        cluster_stats = sup.stats()
        cluster_stats["leases"] = {
            _normalize_edge(ws, root): lease
            for ws, lease in cluster_stats["leases"].items()}
        sup.stop()
        gw.stop()

    e2e_snap = e2e.snapshot(qs=_QS)
    e2e_q = e2e_snap["quantiles"]
    return {
        "metric": "slo_report",
        "seed": seed,
        "mode": "wall",
        "workers": workers,
        "saturation": saturation,
        "tenants": tenants,
        "admission": (cluster_stats.get("admission")
                      or {"enabled": False}),
        "ingress_shed": cluster_stats.get("ingressShed", 0),
        "capacity_ops_s": round(capacity, 1),
        "offered_ops_s": round(rate, 1),
        "workload": digest,
        "verdicts": {
            "expected_denials": expected_denials,
            "observed_denials": observed_denials,
            "expected_redactions": expected_redactions,
            "observed_redactions": observed_redactions,
            "false_blocks": false_blocks,
            "losses": (expected_denials - observed_denials)
                      + (expected_redactions - observed_redactions),
        },
        "e2e": {"count": e2e_snap["counts"].get("e2e", 0),
                **{k: v for k, v in e2e_q.get("e2e", {}).items()},
                "byKind": {k.split(":", 1)[1]: q
                           for k, q in sorted(e2e_q.items())
                           if k.startswith("kind:")},
                "byTenant": {k.split(":", 1)[1]: q
                             for k, q in sorted(e2e_q.items())
                             if k.startswith("tenant:")}},
        "stage_counts": {edge: snap["counts"]
                         for edge, snap in sorted(edge_snaps.items())},
        "stages": {edge: snap["quantiles"]
                   for edge, snap in sorted(edge_snaps.items())},
        "hook_stats": dict(sorted(hook_stats.items())),
        "cluster": cluster_stats,
        "sitrep": {"health": sitrep_report["health"],
                   "cluster": ((sitrep_report["collectors"].get("cluster")
                                or {}).get("summary"))},
        "elapsed_s": round(elapsed, 3),
        "throughput_ops_s": round(len(ops) / max(elapsed, 1e-9), 1),
    }


def _denied(obs: dict, op) -> int:
    """Counts only denials of ops that EXPECT one — a false block of a
    tool_ok op must surface as false_blocks, not inflate observed_denials
    (compensating errors would zero out the losses gate)."""
    return 1 if (op.kind == "tool_denied" and obs.get("blocked") is True) else 0


def _redacted(obs: dict) -> int:
    return 1 if obs.get("redacted") else 0


def _false_block(obs: dict, op) -> int:
    return 1 if (op.kind == "tool_ok" and obs.get("blocked") is True) else 0


# ── fleet serving: virtual-time replica-fleet SLO runs ───────────────
#
# Service-time model for one batched validator forward on a replica:
# a fixed dispatch floor plus a per-row marginal, scaled by a seeded
# log-normal factor. The RATIO is what matters — batch-32 amortizes the
# floor ~8x over batch-1 — so the fleet's batching-aware routing earns
# real scaling efficiency in the sim instead of having it assumed.
_FLEET_SVC_BASE_S = 0.004      # per-batch dispatch floor (seconds)
_FLEET_SVC_ROW_S = 0.0007      # per-row marginal (seconds)
_FLEET_BASE_T = 1_753_772_400.0
# ≈ maxBatch / service(maxBatch) at the default maxBatch=32 — the knee
# the A/B workload rates are chosen against.
FLEET_SIM_CAPACITY_OPS_S = 32 / (_FLEET_SVC_BASE_S + 32 * _FLEET_SVC_ROW_S)


def sim_severity(text: str) -> int:
    """Deterministic stand-in severity head: a pure function of the text.
    Shared by the fleet sim and any one-process parity oracle, so the two
    paths can only disagree through scheduling."""
    return int(hashlib.sha256(text.encode("utf-8")).hexdigest()[:8], 16) % 4


def _run_fleet_sim(ops, fleet_cfg: dict, seed: int,
                   device: DeviceLike = None) -> dict:
    """Deterministic discrete-event run of a :class:`ReplicaFleet`.

    The REAL fleet machinery executes — route-log publishes, batching-aware
    placement, watermark acks, autoscale decisions, drain-before-retire —
    while time is virtual: one global `_SimClock` orders arrivals and one
    per-replica clock carries each replica's service history (a shared
    clock would serialize replicas and no fleet could ever scale). The
    driver interleaves arrivals with due batch firings in virtual-time
    order: a replica fires at ``max(free, oldest + window)`` (or as soon
    as free once its bucket is full), so requests landing during a batch's
    service correctly wait for the next one. Everything derived from the
    run — latencies, scale schedule, watermark — is a pure function of
    (ops, fleet_cfg, seed), bit for bit the JAX package's run. The stub
    batchers hold no tensors, but are built on ``device`` like every
    batcher of the port (None = the card).
    """
    from ..cluster.fleet import ReplicaFleet
    from ..events.transport import MemoryTransport
    from ..models.batching import ContinuousBatcher

    clock = _SimClock(_FLEET_BASE_T)
    cursor = [_FLEET_BASE_T]          # latest processed virtual instant
    rclocks: dict[str, _SimClock] = {}
    free: dict[str, float] = {}       # rid -> service-end frontier

    def factory(rid: str, worker_id: str):
        rc = _SimClock(cursor[0])
        rclocks[rid] = rc
        free[rid] = cursor[0]
        svc_rng = random.Random(f"fleetsvc:{seed}:{rid}")

        def model_fn(texts, _rc=rc, _rng=svc_rng):
            _rc.t += ((_FLEET_SVC_BASE_S
                       + _FLEET_SVC_ROW_S * len(texts))
                      * _rng.lognormvariate(0.0, 0.35))
            return [sim_severity(t) for t in texts]

        batcher = ContinuousBatcher(
            max_batch=int(fleet_cfg.get("maxBatch", 32)),
            window_ms=float(fleet_cfg.get("windowMs", 2.0)),
            clock=rc, autostart=False, model_fn=model_fn, device=device)
        return batcher, None

    results: dict[int, dict] = {}
    fleet = ReplicaFleet(
        fleet_cfg, transport=MemoryTransport(clock=clock), clock=clock,
        workers=lambda: ["sim-w0"], batcher_factory=factory,
        on_result=lambda op, obs: results.__setitem__(op.get("i"), obs),
        device=device)

    def pin(rid: str) -> None:
        # Autoscaler retires drain mid-submit; pin the victim's clock to
        # the schedule so drained batches serve "now", never in the past.
        rc = rclocks.get(rid)
        if rc is not None and rc.t < cursor[0]:
            rc.t = cursor[0]

    fleet.step_hook = pin
    max_batch = fleet._max_batch
    window_s = fleet._window_s

    i = 0
    while True:
        occ = fleet.occupancy()
        best_rid = None
        best_t = None
        for rid in sorted(occ):
            row = occ[rid]
            if not row["alive"] or row["pending"] <= 0:
                continue
            if row["pending"] >= max_batch:
                t_fire = max(free.get(rid, cursor[0]), cursor[0])
            else:
                oldest = (row["oldestAt"] if row["oldestAt"] is not None
                          else cursor[0])
                t_fire = max(free.get(rid, cursor[0]), oldest + window_s)
            if best_t is None or t_fire < best_t:
                best_rid, best_t = rid, t_fire
        if i < len(ops) and (best_t is None
                             or _FLEET_BASE_T + ops[i].arrival <= best_t):
            op = ops[i]
            i += 1
            at = _FLEET_BASE_T + op.arrival
            cursor[0] = max(cursor[0], at)
            clock.t = cursor[0]
            fleet.submit({"i": op.index, "text": op.content,
                          "tenant": f"tenant{op.tenant}", "at": at})
        elif best_rid is not None:
            cursor[0] = max(cursor[0], best_t)
            clock.t = cursor[0]
            pin(best_rid)
            fleet.step_replica(best_rid)
            free[best_rid] = rclocks[best_rid].t
        else:
            break

    stats = fleet.stats()
    stage_states = fleet.stage_states()
    fleet.close()
    makespan = max(max((rc.t for rc in rclocks.values()),
                       default=cursor[0]), cursor[0]) - _FLEET_BASE_T
    return {"results": results, "stats": stats,
            "stage_states": stage_states,
            "makespan_s": makespan}


def run_fleet_slo_report(seed: int = 0, n_ops: int = 2000, tenants: int = 4,
                         replicas: int = 1, autoscale: bool = True,
                         profile: str = "diurnal", base_rate: float = 400.0,
                         peak_factor: float = 4.0, period_s: float = 1.0,
                         max_replicas: int = 6,
                         p99_budget_ms: float = 100.0,
                         fleet_config: dict = None,
                         device: DeviceLike = None) -> dict:
    """SLO report for the replica fleet under a rate-modulated workload —
    the autoscaler's A/B gate. Virtual time end to end, so the ENTIRE
    report is bit-identical per (seed, args): same trace in, same scale
    schedule and same latencies out.

    The default knobs tell the acceptance story on one diurnal trace: the
    peak rate (base_rate × peak_factor = 1600 ops/s) exceeds one replica's
    batched capacity (≈ ``FLEET_SIM_CAPACITY_OPS_S`` ≈ 1200 ops/s), and
    ``period_s=1.0`` with ~3.4 virtual seconds of trace leaves a long
    low-rate tail past the peak. ``autoscale=False`` with ``replicas=1``
    saturates at the peak and breaches the p99 budget (~150–180 ms across
    seeds); ``autoscale=True`` spawns into the ramp, holds p99 at ~63–71 ms,
    and retires back down the tail. The 100 ms budget is deliberately above
    the batch-32 service tail (~26 ms × the σ=0.35 log-normal p99 factor
    2.26 ≈ 59 ms) — a budget under the single-batch tail would breach at
    ANY replica count and gate nothing."""
    from .workload import generate_fleet_workload, workload_digest

    if profile not in ("diurnal", "burst"):
        raise ValueError(f"unknown fleet profile {profile!r}")
    if n_ops < 1:
        raise ValueError(f"n_ops must be >= 1, got {n_ops}")
    ops = generate_fleet_workload(seed, n_ops, tenants, profile=profile,
                                  base_rate=base_rate,
                                  peak_factor=peak_factor,
                                  period_s=period_s)
    digest = workload_digest(ops)
    # Autoscaler knobs tuned for the diurnal ramp: evaluate every 16
    # submissions, spawn at 4 queued/replica (anticipatory — waiting for
    # deep queues means the breach already happened), retire only when
    # nearly idle, 3-eval cooldown against ramp thrash.
    fcfg = {"replicas": replicas, "minReplicas": 1,
            "maxReplicas": max_replicas, "autoscale": autoscale,
            "p99BudgetMs": p99_budget_ms, "evalEveryOps": 16,
            "scaleUpQueueDepth": 4.0, "scaleDownQueueDepth": 1.0,
            "p99Window": 128, "cooldownEvals": 3}
    fcfg.update(fleet_config or {})
    run = _run_fleet_sim(ops, fcfg, seed, device=device)
    stats = run["stats"]
    lats = sorted(obs["latMs"] for obs in run["results"].values()
                  if "latMs" in obs)
    served = len(lats)
    shed = sum(1 for obs in run["results"].values() if obs.get("shed"))

    def q(p: float) -> float:
        return round(lats[int(p * (len(lats) - 1))], 3) if lats else 0.0

    p99 = q(0.99)
    makespan = run["makespan_s"]
    scale_events = stats["autoscaler"]["scaleEvents"]
    return {
        "metric": "fleet_slo_report",
        "seed": seed,
        "mode": "sim",
        "profile": profile,
        "autoscale": autoscale,
        "workload": digest,
        "offered": {"n_ops": n_ops, "base_rate": base_rate,
                    "peak_factor": peak_factor, "period_s": period_s,
                    "capacity_per_replica_ops_s":
                        round(FLEET_SIM_CAPACITY_OPS_S, 1)},
        "replicas": {"initial": replicas,
                     "final": len(stats["membership"]["alive"]),
                     "min": 1, "max": max_replicas},
        "served": served,
        "shed": shed,
        "losses": n_ops - served - shed,
        "latencyMs": {"p50": q(0.5), "p95": q(0.95), "p99": p99},
        "p99BudgetMs": p99_budget_ms,
        "breached": bool(p99 > p99_budget_ms),
        "scaleEvents": scale_events,
        "spawns": sum(1 for e in scale_events if e["action"] == "spawn"),
        "retires": sum(1 for e in scale_events if e["action"] == "retire"),
        "decisions": stats["autoscaler"]["decisions"],
        "watermark": stats["watermark"],
        "redelivered": stats["redelivered"],
        "elapsed_s": round(makespan, 6),
        "throughput_ops_s": round(served / max(makespan, 1e-9), 1),
    }


def slo_stage_records(report: dict) -> list:
    """One machine-readable line per (edge, stage, quantile) — the same
    pre-attributed-regression discipline as every other bench family."""
    out = []
    for edge, stages in (report.get("stages") or {}).items():
        for stage, qd in stages.items():
            rec = {"metric": "slo_stage_quantiles", "edge": edge,
                   "stage": stage}
            rec.update(qd)
            out.append(rec)
    return out
