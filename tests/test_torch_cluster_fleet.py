"""The port's replica fleet under its supervisor against the JAX package's,
and the port's deliberate deviations in the cluster.

The fleet storm is JAX's ``run_fleet_storm`` (``tests/test_fleet_serving
.py``) with JAX's deterministic ``det_factory`` batchers on both sides: a
seeded step kills the worker that hosts the fullest replica, another
retires the fullest replica under load, and (here also) a worker is
retired with ``retire_worker`` before the final drain. Both packages give
equal duration-free summaries. The deviations are pinned one by one:

- the catches around a worker's ``stop`` (``retire_worker``, ``stop``) and
  a process worker's ``request_stop`` let a device error through and
  handle a plain error as JAX does;
- ``close_batchers(drain=True)`` raises a device error from a drain once
  the scope is closed, so ``InProcessWorker.stop`` does too;
- ``serve_cfg`` without a servable checkpoint raises, where JAX skips the
  batcher;
- ``routeTransport: "nats"`` without the nats client raises, where JAX
  degrades to memory;
- ``mp_context`` takes ``spawn`` once CUDA is initialised.
"""

from __future__ import annotations

import functools
import random
import types
from pathlib import Path

import pytest

from test_torch_cluster_failover import (JAX, JOURNAL_CFG, PORT, SEED,
                                         SetClock, build_ops,
                                         check_protocol, lock_witness,
                                         strip_timing, verdict_check)

from vainplex_openclaw_tpu.cluster import supervisor as jax_supervisor
from vainplex_openclaw_tpu.cluster import worker as jax_worker
from vainplex_openclaw_tpu.core.api import list_logger as jax_list_logger
from vainplex_openclaw_tpu.models import batching as jax_batching
from vainplex_openclaw_tpu.models import serve as jax_serve
from vainplex_openclaw_tpu.slo import harness as jax_harness
from vainplex_openclaw_tpu.storage import journal as jax_journal
from vainplex_openclaw_tpu_torch.cluster import supervisor, worker
from vainplex_openclaw_tpu_torch.core.api import list_logger
from vainplex_openclaw_tpu_torch.device import DeviceError
from vainplex_openclaw_tpu_torch.models import batching, serve
from vainplex_openclaw_tpu_torch.slo import harness
from vainplex_openclaw_tpu_torch.storage import journal

N_OPS = 180

FLEET_PORT = types.SimpleNamespace(
    pkg=PORT, batching=batching, harness=harness, kw={"device": "cpu"})
FLEET_JAX = types.SimpleNamespace(
    pkg=JAX, batching=jax_batching, harness=jax_harness, kw={})


@pytest.fixture(autouse=True)
def _clean_books():
    yield
    serve.close_batchers()
    jax_serve.close_batchers()
    journal.reset_journals()
    jax_journal.reset_journals()


def det_factory(side, clock):
    """JAX's deterministic replica batchers: no collector thread, the pure
    severity head, the shared settable clock."""
    def factory(rid: str, worker_id: str):
        return side.batching.ContinuousBatcher(
            max_batch=8, window_ms=0.0, clock=clock, autostart=False,
            model_fn=lambda texts: [side.harness.sim_severity(t)
                                    for t in texts], **side.kw), None
    return factory


def run_fleet_storm(side, root: Path, seed: int = SEED,
                    retire_worker: bool = True) -> dict:
    pkg = side.pkg
    pkg.reset_journals()
    clock = SetClock()
    ws_results: dict[int, dict] = {}
    fleet_results: dict[int, dict] = {}
    sup = pkg.ClusterSupervisor(
        root, {"workers": 3, "ackEveryOps": 6, "deterministicIds": True,
               "fleetServing": True,
               "fleet": {"replicas": 3, "maxBatch": 8, "windowMs": 0.0,
                         "ackEvery": 4}},
        clock=clock, wall_timers=False, settable_clock=clock,
        journal_cfg=JOURNAL_CFG, logger=pkg.list_logger(),
        on_result=lambda op, obs: ws_results.__setitem__(op.get("i"), obs))
    fleet = sup.enable_fleet(
        batcher_factory=det_factory(side, clock),
        on_result=lambda op, obs: fleet_results.__setitem__(op.get("i"),
                                                            obs),
        **side.kw)
    assert fleet is not None and sup.fleet is fleet
    locks = lock_witness(sup, extra=((fleet, "ReplicaFleet._lock"),))
    proto = pkg.ProtocolWitness()
    proto.arm_supervisor(sup)
    ops = build_ops(pkg, seed, root, N_OPS)
    chaos = random.Random(f"fleetstorm:{seed}")
    kill_step = chaos.randrange(40, 80)
    retire_step = chaos.randrange(80, 110)
    chaos_log: list = []
    plan = pkg.FaultPlan([pkg.FaultSpec("journal.fsync", rate=0.05)],
                         seed=seed)
    with pkg.installed(plan):
        for step, op in enumerate(ops):
            sup.submit(op)
            sup.tick()
            fleet.submit({"i": step, "text": op["content"],
                          "tenant": op["wsKey"], "at": clock.t})
            if step == kill_step:
                occ = fleet.occupancy()
                rid = max(sorted(occ), key=lambda r: occ[r]["pending"])
                assert occ[rid]["pending"] > 0
                chaos_log.append({"chaos": "kill", "step": step, "rid": rid,
                                  "worker": occ[rid]["workerId"]})
                sup.failover(occ[rid]["workerId"], reason="chaos kill")
            if step == retire_step:
                occ = fleet.occupancy()
                live = [r for r in sorted(occ) if occ[r]["alive"]]
                rid = max(live, key=lambda r: (occ[r]["pending"], r))
                chaos_log.append({"chaos": "retire", "step": step,
                                  "rid": rid,
                                  "pending": occ[rid]["pending"]})
                fleet.retire_replica(rid, reason="chaos scale-down")
            if step % 6 == 5:
                fleet.pump()
        if retire_worker:
            survivor = sup.stats()["membership"]["live"][0]
            chaos_log.append({"chaos": "retire_worker", "worker": survivor,
                              "out": sup.retire_worker(survivor)})
        fleet.drain()
        sup.drain()
    fstats = fleet.stats()
    sstats = sup.stats()
    summary = {
        "wsResults": {i: ws_results.get(i) for i in range(N_OPS)},
        "fleetResults": {i: fleet_results.get(i) for i in range(N_OPS)},
        "chaos": chaos_log,
        "fired": dict(plan.fired),
        "fleet": {k: fstats[k] for k in (
            "membership", "routed", "served", "shed", "redelivered",
            "inflight", "watermark", "failovers")},
        "replicas": {rid: {k: v for k, v in row.items() if k != "meanBatch"}
                     for rid, row in fstats["replicas"].items()},
        "supFailovers": [strip_timing(f) for f in sstats["failovers"]],
        "handoffs": [strip_timing(h) for h in sstats["handoffs"]],
        "fencedRecords": sstats["fencedRecords"],
        "membership": sstats["membership"],
    }
    sup.stop()
    locks.assert_acyclic()
    check_protocol(proto)
    pkg.reset_journals()
    return summary


def test_fleet_storm_under_the_supervisor_equals_jax(tmp_path):
    got = run_fleet_storm(FLEET_PORT, tmp_path / "port")
    assert got == run_fleet_storm(FLEET_JAX, tmp_path / "jax")
    assert [c["chaos"] for c in got["chaos"]] == ["kill", "retire",
                                                   "retire_worker"]
    dead = got["supFailovers"][0]["worker"]
    assert got["membership"]["dead"] == [dead]
    assert got["membership"]["retired"] == [got["chaos"][2]["worker"]]
    assert got["chaos"][2]["out"]["retired"] is True
    frec = got["fleet"]["failovers"][0]
    assert frec["worker"] == dead and frec["redelivered"] >= 1
    assert len(frec["replicasLost"]) == 1 and len(frec["respawned"]) == 1
    ops = build_ops(PORT, SEED, tmp_path, N_OPS)
    for i, op in enumerate(ops):
        assert got["fleetResults"][i]["verdict"] == batching.render_verdict(
            harness.sim_severity(op["content"]))
    verdict_check({"results": got["wsResults"]}, ops, N_OPS)
    assert got["fencedRecords"] == 0
    assert got["fleet"]["inflight"] == 0
    assert got["fleet"]["served"] == N_OPS
    assert got["fleet"]["routed"] == N_OPS + got["fleet"]["redelivered"]
    # drain before retire: the retired worker hosts no replica any more
    assert all(row["worker"] != got["chaos"][2]["worker"]
               for rid, row in got["replicas"].items()
               if rid in got["fleet"]["membership"]["alive"])


def test_fleet_storm_is_bit_identical_per_seed(tmp_path):
    a = run_fleet_storm(FLEET_PORT, tmp_path / "a", retire_worker=False)
    b = run_fleet_storm(FLEET_PORT, tmp_path / "b", retire_worker=False)
    assert a == b


def test_fleet_serving_defaults_off_as_jax(tmp_path):
    for mod, root in ((supervisor, tmp_path / "port"),
                      (jax_supervisor, tmp_path / "jax")):
        assert mod.CLUSTER_DEFAULTS["fleetServing"] is False
        sup = mod.ClusterSupervisor(root, {"workers": 1},
                                    journal_cfg=JOURNAL_CFG)
        try:
            assert sup.enable_fleet() is None and "fleet" not in sup.stats()
        finally:
            sup.stop()
    assert supervisor.CLUSTER_DEFAULTS == jax_supervisor.CLUSTER_DEFAULTS
    assert supervisor.SHEDDABLE_KINDS == jax_supervisor.SHEDDABLE_KINDS


# ── the catches of a worker's stop ──────────────────────────────────


def small_cluster(mod, root, logger, **kw):
    return mod.ClusterSupervisor(root, {"workers": 2, "ackEveryOps": 4},
                                 journal_cfg=JOURNAL_CFG, logger=logger,
                                 **kw)


def failing_stop(handle, exc):
    real = handle.stop

    def stop():
        real()
        raise exc
    handle.stop = stop


@pytest.mark.parametrize("where", ["retire_worker", "stop"])
def test_a_plain_stop_error_is_logged_as_in_jax(tmp_path, where):
    seen = []
    for mod, logger in ((supervisor, list_logger()),
                        (jax_supervisor, jax_list_logger())):
        sup = small_cluster(mod, tmp_path / mod.__name__, logger)
        failing_stop(sup.workers()["w1"].handle, RuntimeError("disk gone"))
        out = sup.retire_worker("w1") if where == "retire_worker" else None
        sup.stop()
        seen.append((out, logger.messages()))
    assert seen[0] == seen[1]
    word = "retire" if where == "retire_worker" else "worker"
    assert seen[0][1] == [f"[cluster] {word} stop failed: disk gone"]


@pytest.mark.parametrize("where", ["retire_worker", "stop"])
def test_a_device_error_in_a_worker_stop_propagates(tmp_path, where):
    sup = small_cluster(supervisor, tmp_path, list_logger())
    failing_stop(sup.workers()["w1"].handle,
                 DeviceError("K1 launch failed in the drain"))
    with pytest.raises(DeviceError, match="K1 launch failed"):
        if where == "retire_worker":
            sup.retire_worker("w1")
        else:
            sup.stop()
    assert sup.logger.messages() == []


class AsyncStub:
    """A process-shaped handle whose ``request_stop`` fails."""

    sync = False

    def __init__(self, worker_id, exc):
        self.worker_id, self.exc, self.alive = worker_id, exc, True
        self.shard, self.released = {}, {}

    def flush(self):
        return []

    def request_stop(self):
        self.alive = False
        raise self.exc

    def finish_stop(self, timeout_s: float = 10.0):
        self.alive = False

    def stage_states(self):
        return {}

    def stats(self):
        return {"workerId": self.worker_id}


@pytest.mark.parametrize("exc", [RuntimeError("queue closed"),
                                 DeviceError("CUDA error: launch failure")])
def test_request_stop_catch(tmp_path, exc):
    outcomes = []
    for mod, logger in ((supervisor, list_logger()),
                        (jax_supervisor, jax_list_logger())):
        sup = small_cluster(mod, tmp_path / mod.__name__, logger,
                            worker_mode="process",
                            worker_factory=lambda wid, root: AsyncStub(
                                wid, exc))
        try:
            sup.stop()
            outcomes.append(("stopped", logger.messages()))
        except Exception as err:  # noqa: BLE001 — the outcome is the test
            outcomes.append((type(err).__name__, str(err)))
    if isinstance(exc, DeviceError):
        assert outcomes[0] == ("DeviceError", str(exc))
        assert outcomes[1] == ("stopped", [])  # JAX passes over it
    else:
        assert outcomes[0] == outcomes[1] == ("stopped", [])


# ── the drain inside InProcessWorker.stop ───────────────────────────


def stepped_book(monkeypatch, fn):
    """The shared-batcher book with stepped batchers serving ``fn``."""
    stepped = functools.partial(batching.ContinuousBatcher, autostart=False)
    monkeypatch.setattr(serve, "ContinuousBatcher", stepped)

    def register(scope, max_batch=4):
        b = serve.shared_batcher(None, {"windowMs": 0.0,
                                        "maxBatch": max_batch},
                                 scope=scope, device="cpu")
        b.model_fn = fn
        return b
    return register


def test_close_batchers_raises_a_device_error_after_closing(monkeypatch):
    def broken(texts):
        raise DeviceError("K1 launch failed")

    register = stepped_book(monkeypatch, broken)
    first, second = register("w0@r", 4), register("w0@r", 8)
    other = register("w1@r")
    tickets = [first.enqueue("held"), second.enqueue("held too")]
    with pytest.raises(DeviceError, match="K1 launch failed"):
        serve.close_batchers(scope="w0@r", drain=True)
    # every batcher of the scope was drained and closed before the raise
    assert first._closed and second._closed and not other._closed
    assert all(isinstance(t.error, DeviceError) for t in tickets)


def test_a_plain_drain_error_is_passed_over_as_in_jax(monkeypatch):
    def broken(texts):
        raise ValueError("bad batch")

    register = stepped_book(monkeypatch, broken)
    b = register("w0@r")
    ticket = b.enqueue("held")
    serve.close_batchers(scope="w0@r", drain=True)
    assert b._closed and isinstance(ticket.error, ValueError)


def test_inprocess_worker_stop_lets_a_drain_device_error_through(
        tmp_path, monkeypatch):
    def broken(texts):
        raise DeviceError("K1 launch failed in the drain")

    register = stepped_book(monkeypatch, broken)
    sup = small_cluster(supervisor, tmp_path, list_logger())
    handle = sup.workers()["w1"].handle
    register(handle.serve_scope).enqueue("queued on w1's replica")
    with pytest.raises(DeviceError):
        sup.retire_worker("w1")
    assert handle.alive is False
    sup.stop()


# ── serve_cfg, nats and the start method ────────────────────────────


def test_serve_cfg_without_a_checkpoint_raises_where_jax_skips(tmp_path):
    missing = {"checkpointDir": str(tmp_path / "no-checkpoint")}
    with pytest.raises(FileNotFoundError, match="serve_cfg=None"):
        worker.build_worker_gateway(tmp_path / "port", "w0",
                                    serve_cfg=missing, device="cpu",
                                    journal_cfg=JOURNAL_CFG)
    logger = jax_list_logger()
    gw, _cortex, _gov = jax_worker.build_worker_gateway(
        tmp_path / "jax", "w0", serve_cfg=missing, journal_cfg=JOURNAL_CFG,
        logger=logger)
    assert getattr(gw, "serve_batcher", None) is None
    assert any("replica batcher skipped" in m for m in logger.messages())
    gw.stop()
    gw, _c, _g = worker.build_worker_gateway(tmp_path / "none", "w0",
                                             serve_cfg=None,
                                             journal_cfg=JOURNAL_CFG)
    assert getattr(gw, "serve_batcher", None) is None
    gw.stop()


def test_nats_route_transport_raises_where_jax_degrades(tmp_path):
    """Without the ``nats`` client package JAX degrades the route log to
    memory; the port raises (with the scripted client both build the
    adapter: ``tests/test_torch_nats.py``)."""
    cfg = {"routeTransport": "nats"}
    with pytest.raises(ImportError, match="'nats' client package"):
        supervisor.build_route_transport(cfg, tmp_path, clock=lambda: 0.0)
    _t, kind = jax_supervisor.build_route_transport(cfg, tmp_path,
                                                    clock=lambda: 0.0)
    assert kind == "memory"
    for name in ("memory", "file"):
        got = supervisor.build_route_transport({"routeTransport": name},
                                               tmp_path, clock=lambda: 0.0)
        want = jax_supervisor.build_route_transport(
            {"routeTransport": name}, tmp_path / "jax", clock=lambda: 0.0)
        assert got[1] == want[1] == name
        assert type(got[0]).__name__ == type(want[0]).__name__
    with pytest.raises(ValueError):
        supervisor.build_route_transport({"routeTransport": "carrier"},
                                         tmp_path, clock=lambda: 0.0)


@pytest.mark.parametrize("cuda", [True, False])
def test_mp_context_takes_spawn_once_cuda_is_initialised(monkeypatch, cuda):
    import sys

    import torch

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: cuda)
    main = types.ModuleType("__main__")  # a stdin main: JAX forks
    monkeypatch.setitem(sys.modules, "__main__", main)
    got = worker.mp_context().get_start_method()
    assert jax_worker.mp_context().get_start_method() == "fork"
    assert got == ("spawn" if cuda else "fork")
    main.__file__ = __file__  # a re-importable main: both spawn
    assert worker.mp_context().get_start_method() == "spawn"
    assert jax_worker.mp_context().get_start_method() == "spawn"


# ── a worker that owns a replica batcher ────────────────────────────


def serve_worker_run(mod, root, **kw) -> dict:
    """Two in-process workers with the shipped checkpoint served on their
    own scopes: verdicts through each, then one worker's stop."""
    texts = harness_texts()
    a = mod.InProcessWorker("wA", root, journal_cfg=JOURNAL_CFG,
                            serve_cfg={"windowMs": 0.0}, **kw)
    b = mod.InProcessWorker("wB", root, journal_cfg=JOURNAL_CFG,
                            serve_cfg={"windowMs": 0.0}, **kw)
    verdicts = [[w.gw.serve_batcher.submit(t) for t in texts]
                for w in (a, b)]
    a.stop()
    after = [a.gw.serve_batcher._closed, b.gw.serve_batcher._closed,
             b.gw.serve_batcher.submit(texts[0])]
    b.stop()
    return {"verdicts": verdicts, "after_stop": after,
            "scopes": [a.serve_scope.replace(str(root), "ROOT"),
                       b.serve_scope.replace(str(root), "ROOT")]}


def harness_texts() -> list:
    from vainplex_openclaw_tpu_torch.slo.workload import generate_serve_texts

    return generate_serve_texts(SEED, 6)


def test_worker_with_serve_cfg_serves_its_own_scope_as_jax(tmp_path):
    got = serve_worker_run(worker, tmp_path / "port", device="cpu")
    want = serve_worker_run(jax_worker, tmp_path / "jax")
    assert got == want
    assert got["after_stop"][:2] == [True, False]
    assert got["scopes"] == ["wA@ROOT", "wB@ROOT"]
