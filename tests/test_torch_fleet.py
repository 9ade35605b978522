"""The port's replica fleet against the JAX package's.

The machinery (routing, route log, watermark, autoscaler, drain before
retire, failover redelivery, fleet-wide versions) runs on stub ``model_fn``
batchers and virtual clocks, where both fleets must give equal results
exactly: per-op results, ``stats()``, decisions, scale events, failovers,
watermark and route-log payloads. The fleet SLO report is held equal bit
for bit. One case serves the shipped checkpoint through the port's default
factory on the CPU against JAX's one-shot oracle. The shared-batcher book
(``models/serve.py``) is held to JAX's sharing, scoping and draining.
"""

from __future__ import annotations

import functools
import json
import threading

import pytest
import torch

from vainplex_openclaw_tpu.cluster import fleet as jax_fleet
from vainplex_openclaw_tpu.events import transport as jax_transport
from vainplex_openclaw_tpu.models import batching as jax_batching
from vainplex_openclaw_tpu.models import registry as jax_registry
from vainplex_openclaw_tpu.models import serve as jax_serve
from vainplex_openclaw_tpu.slo import harness as jax_harness
from vainplex_openclaw_tpu.slo import workload as jax_workload
from vainplex_openclaw_tpu_torch.cluster import fleet
from vainplex_openclaw_tpu_torch.device import DeviceError
from vainplex_openclaw_tpu_torch.events import transport
from vainplex_openclaw_tpu_torch.models import batching, registry, serve
from vainplex_openclaw_tpu_torch.slo import harness, workload

PORT = {"fleet": fleet, "transport": transport, "batching": batching,
        "registry": registry, "harness": harness, "kw": {"device": "cpu"}}
JAX = {"fleet": jax_fleet, "transport": jax_transport,
       "batching": jax_batching, "registry": jax_registry,
       "harness": jax_harness, "kw": {}}
VERSION_BUMP = {"v1": 0, "v2": 1}


@pytest.fixture(autouse=True)
def _clean_books():
    yield
    serve.close_batchers()
    jax_serve.close_batchers()
    registry.clear_registries()
    jax_registry.clear_registries()


def sim_fn(texts):
    return [harness.sim_severity(t) for t in texts]


def versioned_fn(texts, version):
    return [min(3, harness.sim_severity(t) + VERSION_BUMP[version])
            for t in texts]


# ── the shared-batcher book ─────────────────────────────────────────


def shared_book(pkg_serve, pkg_batching, cfg, shared, monkeypatch):
    """One drive of the book: sharing, scoping and draining, read through
    what a caller sees (identities, closed flags, verdicts)."""
    stepped = functools.partial(pkg_batching.ContinuousBatcher,
                                autostart=False)
    for module in (pkg_batching, pkg_serve):
        if hasattr(module, "ContinuousBatcher"):
            monkeypatch.setattr(module, "ContinuousBatcher", stepped)
    texts = workload.generate_serve_texts(3, 6)
    a = shared(cfg, scope="w0:fleet:r0")
    b = shared(cfg, scope="w1:fleet:r1")
    g = shared(cfg)
    out = {"same_scope_shared": shared(cfg, scope="w0:fleet:r0") is a,
           "scopes_apart": len({id(a), id(b), id(g)}) == 3,
           "admission_off": a.admission is None}
    reg_cfg = dict(cfg, modelRegistry=True)
    own = shared(reg_cfg, scope="w2:fleet:r2")
    out["own_registry"] = (own.registry.name, own.registry.active())
    for batcher in (a, b, g):
        batcher.model_fn = sim_fn
    ta = [a.enqueue(t) for t in texts]
    tb = [b.enqueue(t) for t in texts]
    pkg_serve.close_batchers(scope="w0:fleet:r0", drain=True)
    out["drained"] = [tk.result if tk.done.is_set() else None for tk in ta]
    out["after_scoped_close"] = (a._closed, b._closed, g._closed)
    pkg_serve.close_batchers(scope="w1:fleet:r1")
    out["undrained_done"] = [tk.done.is_set() for tk in tb]
    out["rebuilt"] = shared(cfg, scope="w0:fleet:r0") is not a
    pkg_serve.close_batchers()
    out["all_closed"] = (g._closed, own._closed, not pkg_serve._batchers)
    return out


def test_shared_batcher_scope_registry_and_drain_match_jax(monkeypatch):
    cfg = {"windowMs": 0.0, "maxBatch": 4, "admission": None}
    got = shared_book(
        serve, batching, cfg,
        lambda c, **kw: serve.shared_batcher(None, c, device="cpu", **kw),
        monkeypatch)
    jcfg = {**jax_serve.SERVE_DEFAULTS, **cfg}
    want = shared_book(
        jax_serve, jax_batching, jcfg,
        lambda c, **kw: jax_serve.shared_batcher(
            None, {**jax_serve.SERVE_DEFAULTS, **c}, **kw),
        monkeypatch)
    assert got == want
    assert got["same_scope_shared"] and got["scopes_apart"]
    assert got["admission_off"]
    assert got["own_registry"] == ("serve:w2:fleet:r2", "v0")
    assert None not in got["drained"]
    assert got["after_scoped_close"] == (True, False, False)
    assert not any(got["undrained_done"]) and got["rebuilt"]


def test_shared_batcher_takes_the_fleet_registry():
    reg = registry.ModelRegistry({"enabled": True}, name="fleet:shared",
                                 device="cpu")
    reg.register_stub("v1")
    b = serve.shared_batcher(None, {"windowMs": 0.0}, scope="w0:fleet:r0",
                             registry=reg, device="cpu")
    assert b.registry is reg
    assert serve.shared_batcher(None, {"windowMs": 0.0}, scope="w0:fleet:r0",
                                device="cpu") is b


# ── the machinery on stub batchers and virtual clocks ───────────────


FLEET_CASES = {
    "diurnal_fixed": ("diurnal", 0, {"replicas": 3, "minReplicas": 3,
                                     "maxReplicas": 3, "autoscale": False}),
    "diurnal_autoscale": ("diurnal", 1, {
        "replicas": 1, "maxReplicas": 5, "autoscale": True,
        "evalEveryOps": 16, "scaleUpQueueDepth": 4.0,
        "scaleDownQueueDepth": 1.0, "p99Window": 128, "cooldownEvals": 3}),
    "burst_edge_admission": ("burst", 2, {
        "replicas": 2, "autoscale": True, "evalEveryOps": 16,
        "scaleUpQueueDepth": 4.0, "ackEvery": 5,
        "admission": {"enabled": True, "highWatermark": 6}}),
}


@pytest.mark.parametrize("case", sorted(FLEET_CASES))
def test_fleet_sim_equals_jax(case):
    profile, seed, cfg = FLEET_CASES[case]
    ops = workload.generate_fleet_workload(seed, 300, 4, profile=profile,
                                           base_rate=400.0, peak_factor=4.0)
    assert [op.to_tuple() for op in ops] == [
        op.to_tuple() for op in jax_workload.generate_fleet_workload(
            seed, 300, 4, profile=profile, base_rate=400.0,
            peak_factor=4.0)]
    got = harness._run_fleet_sim(ops, dict(cfg), seed, device="cpu")
    want = jax_harness._run_fleet_sim(ops, dict(cfg), seed)
    assert got["results"] == want["results"]
    assert got["stats"] == want["stats"]
    assert got["makespan_s"] == want["makespan_s"]
    assert sorted(got["stage_states"]) == sorted(want["stage_states"])
    assert len(got["results"]) == len(ops)
    if cfg["autoscale"]:
        assert got["stats"]["autoscaler"]["scaleEvents"]


@pytest.mark.parametrize("profile", ["diurnal", "burst"])
@pytest.mark.parametrize("seed", [0, 3])
def test_fleet_slo_report_equals_jax_bit_for_bit(profile, seed):
    got = harness.run_fleet_slo_report(seed=seed, n_ops=360, profile=profile,
                                       device="cpu")
    want = jax_harness.run_fleet_slo_report(seed=seed, n_ops=360,
                                            profile=profile)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert got["losses"] == 0


def scripted_drive(pkg):
    """Canary, failover with requests in flight, a worker's planned
    retirement, a pin and a fleet-wide activate, then a rollback, on a
    virtual clock. Returns everything a caller or a replacement reads."""
    clock = pkg["harness"]._SimClock()
    log = pkg["transport"].MemoryTransport(clock=clock)
    reg = pkg["registry"].ModelRegistry({"enabled": True},
                                        name="fleet:scripted", **pkg["kw"])
    reg.register_stub("v1", activate=True)
    reg.register_stub("v2")
    live = {"w0", "w1", "w2"}
    delivered: list = []

    def factory(rid, worker_id):
        return pkg["batching"].ContinuousBatcher(
            max_batch=4, window_ms=0.0, clock=clock, autostart=False,
            model_fn=versioned_fn, registry=reg, **pkg["kw"]), None

    f = pkg["fleet"].ReplicaFleet(
        {"replicas": 3, "maxReplicas": 6, "maxBatch": 4, "windowMs": 0.0,
         "ackEvery": 3}, transport=log, clock=clock,
        workers=lambda: sorted(live), batcher_factory=factory, registry=reg,
        on_result=lambda op, obs: delivered.append((op["i"], obs)),
        **pkg["kw"])
    texts = workload.generate_serve_texts(11, 40)

    def submit(lo, hi):
        for i in range(lo, hi):
            clock.t += 0.0005
            f.submit({"i": i, "text": texts[i], "tenant": f"t{i % 3}"})

    submit(0, 6)
    f.set_model_canary("v2", 0.5)
    submit(6, 14)
    f.pump(now=clock.t)
    submit(14, 20)
    occupancy = f.occupancy()
    live.discard("w1")
    failover = f.on_worker_failed("w1", "killed mid-flight")
    submit(20, 26)
    drained = f.drain_worker("w2")
    f.pin_tenant_model("t1", "v2")
    f.activate_model("v2")
    submit(26, 34)
    f.activate_model(reg.rollback_target(), reason="rollback")
    submit(34, 40)
    f.drain()
    stats = f.stats()
    f.close()
    events = [(e.seq, e.type, e.ts, e.payload)
              for e in log.fetch(subject_filter="cluster.>")]
    return {"delivered": delivered, "stats": stats, "events": events,
            "occupancy": occupancy, "failover": failover,
            "drained": drained, "watermark": f.recover_watermark(),
            "texts": texts}


def test_scripted_fleet_equals_jax():
    got = scripted_drive(PORT)
    want = scripted_drive(JAX)
    for key in ("delivered", "stats", "events", "occupancy", "failover",
                "drained", "watermark"):
        assert got[key] == want[key], key
    keys = [i for i, _ in got["delivered"]]
    assert sorted(keys) == list(range(40)), "not served exactly once"
    assert got["failover"]["redelivered"] > 0
    for i, obs in got["delivered"]:
        assert obs["verdict"] == batching.render_verdict(
            versioned_fn([got["texts"][i]], obs["version"])[0])
    stamps = {obs["version"] for _, obs in got["delivered"]}
    assert stamps == {"v1", "v2"}
    assert got["stats"]["modelRegistry"]["rollbacks"] == 1


def test_retire_waits_for_a_collectors_batch():
    """A replica whose collector thread holds its batch is drained by
    waiting for that batch: every accepted request is delivered. The JAX
    fleet stops draining when ``step()`` finds the queue taken and
    retires the replica with its verdicts undelivered."""
    outcomes = {}
    for name, pkg in (("port", PORT), ("jax", JAX)):
        go = threading.Event()

        def held(texts, _go=go):
            _go.wait(10.0)
            return sim_fn(texts)

        batchers = []

        def factory(rid, worker_id, _pkg=pkg):
            b = _pkg["batching"].ContinuousBatcher(
                max_batch=8, window_ms=0.0, model_fn=held, **_pkg["kw"])
            batchers.append(b)
            return b, None

        delivered = {}
        f = pkg["fleet"].ReplicaFleet(
            {"replicas": 1, "maxBatch": 8, "windowMs": 0.0},
            transport=pkg["transport"].MemoryTransport(),
            workers=lambda: ["w0"], batcher_factory=factory,
            on_result=lambda op, obs: delivered.__setitem__(op["i"], obs),
            **pkg["kw"])
        for i in range(3):
            f.submit({"i": i, "text": f"held request {i}"})
        for _ in range(1000):  # until the collector took the queue
            if batchers[0].occupancy()["queued"] == 0:
                break
            threading.Event().wait(0.002)
        threading.Timer(0.2, go.set).start()
        f.retire_replica("r0")
        outcomes[name] = sorted(delivered)
        f.close()
    assert outcomes == {"port": [0, 1, 2], "jax": []}


# ── the default factory on the shipped checkpoint ───────────────────


def test_default_factory_serves_the_shipped_checkpoint_like_jax_oracle():
    from vainplex_openclaw_tpu.models.data import synthetic_examples

    texts = workload.generate_serve_texts(5, 6) + [
        text for text, label in synthetic_examples(24, seed=3)
        if label["severity"] == 3][:4]
    delivered = {}
    f = fleet.ReplicaFleet(
        {"replicas": 2, "maxBatch": 4, "windowMs": 0.0,
         "modelRegistry": True},
        transport=transport.MemoryTransport(), workers=lambda: ["w0", "w1"],
        on_result=lambda op, obs: delivered.__setitem__(op["i"], obs),
        device="cpu")
    try:
        assert f.registry.name == "fleet:cluster.fleet"
        assert registry.all_registries()["fleet:cluster.fleet"] is f.registry
        for i, t in enumerate(texts):
            f.submit({"i": i, "text": t})
        f.retire_replica("r1")
        f.drain()
        scopes = sorted({k[0] for k in serve._batchers})
    finally:
        f.close()
    assert scopes == ["w0:fleet:r0"]
    assert not serve._batchers
    oracle = jax_serve.make_local_call_llm(
        serve_cfg={"continuousBatching": False}, force=True)
    assert [delivered[i]["verdict"] for i in range(len(texts))] == \
        [oracle(t) for t in texts]
    assert {delivered[i]["version"] for i in range(len(texts))} == {"v0"}
    assert len({delivered[i]["verdict"] for i in range(len(texts))}) > 1


def test_fleet_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(DeviceError):
        fleet.ReplicaFleet({"replicas": 1},
                           transport=transport.MemoryTransport(),
                           workers=lambda: ["w0"])


def test_chip_smoke_fleet_audit_catches_each_fault():
    """The fleet phase's audit on the card: a drop, a second delivery and
    a verdict of the wrong version each count."""
    import chip_smoke

    ops = chip_smoke.fleet_ops(4, 1, profile="burst")
    oracle = {"v0": {op.content: f"v0:{op.content}" for op in ops},
              "v2": {op.content: f"v2:{op.content}" for op in ops}}
    delivered = {op.index: {"verdict": oracle["v0"][op.content]}
                 for op in ops}
    counts = {op.index: 1 for op in ops}
    clean = {"dropped": 0, "served_twice": 0, "verdict_mismatches": 0}
    assert chip_smoke.fleet_audit(ops, delivered, counts, oracle) == clean
    delivered[ops[1].index] = {"verdict": oracle["v0"][ops[1].content],
                               "version": "v2"}
    counts[ops[2].index] = 2
    del delivered[ops[3].index]
    assert chip_smoke.fleet_audit(ops, delivered, counts, oracle) == {
        "dropped": 1, "served_twice": 1, "verdict_mismatches": 1}
