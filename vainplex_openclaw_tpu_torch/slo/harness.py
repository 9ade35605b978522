"""The replica fleet's SLO harness: virtual-time runs of a real
:class:`~..cluster.fleet.ReplicaFleet`.

A copy of the fleet half of ``vainplex_openclaw_tpu/slo/harness.py``
(``_SimClock``, ``sim_severity``, ``_run_fleet_sim``,
``run_fleet_slo_report``), kept here so the port imports nothing of the
JAX package. Time is virtual and service times come from a seeded
log-normal model, so a report is bit-identical per (seed, args), and equal
to the JAX package's. The gateway half (``run_slo_report``) is not ported
yet.
"""

from __future__ import annotations

import hashlib
import random

from ..device import DeviceLike


class _SimClock:
    """Mutable virtual clock."""

    def __init__(self, start: float = 1_753_772_400.0):
        self.t = start

    def __call__(self) -> float:
        return self.t


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
