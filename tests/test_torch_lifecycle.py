"""Versioned serving in the port against the JAX package: hot swap under
load, rollback, the seeded swap-and-rollback storm, fleet versioning, the
canary → promote → swap → rollback arc through the real gateway, a mesh
swap, and the shared batcher's registry.

The port runs on ``device="cpu"`` (the attention's plain version). Per
ticket, the port's verdict must equal the JAX batcher's for the same stamp:
on twin checkpoints written as fp32 models (bf16 noise can flip a near-tie
between the two packages), and on stub versions under the JAX chaos rig's
versioned sim head. ``ops._build.builds`` is the port's witness for JAX's
zero-retrace pin: a swap builds nothing.
"""

from __future__ import annotations

import random
import threading
import time
import types

import pytest
import torch

from helpers import make_gateway
from test_torch_registry import twin_checkpoints
from vainplex_openclaw_tpu.events.transport import MemoryTransport
from vainplex_openclaw_tpu.models import batching as jax_batching
from vainplex_openclaw_tpu.models import registry as jax_registry
from vainplex_openclaw_tpu.models import serve as jax_serve
from vainplex_openclaw_tpu.slo.harness import sim_severity
from vainplex_openclaw_tpu.slo.workload import generate_serve_texts
from vainplex_openclaw_tpu_torch.models import batching, registry, serve
from vainplex_openclaw_tpu_torch.ops import _build
from vainplex_openclaw_tpu_torch.parallel import plan
from vainplex_openclaw_tpu_torch.parallel.mesh import cached_mesh

VERSION_BUMP = {"v1": 0, "v2": 1, "v3": 2}


@pytest.fixture(autouse=True)
def _clean_registries():
    yield
    registry.clear_registries()
    jax_registry.clear_registries()


def sim_fn(texts, version):
    """The JAX chaos rig's versioned sim head: pure in (text, version), so
    a mis-versioned batch shows in the verdict itself."""
    return [min(3, sim_severity(t) + VERSION_BUMP[version]) for t in texts]


def expected_verdict(text, version):
    return batching.render_verdict(
        min(3, sim_severity(text) + VERSION_BUMP[version]))


PORT = (registry.ModelRegistry, batching.ContinuousBatcher,
        {"device": "cpu"})
JAX = (jax_registry.ModelRegistry, jax_batching.ContinuousBatcher, {})


def make_registry(pkg, name, **settings):
    cls, _, kw = pkg
    return cls({"enabled": True, **settings}, name=name, **kw)


def make_batcher(pkg, reg, **kw):
    _, cls, extra = pkg
    kw.setdefault("autostart", False)
    kw.setdefault("window_ms", 0.0)
    return cls(registry=reg, **extra, **kw)


def stub_registry(pkg, name, versions=("v1", "v2", "v3"), **settings):
    reg = make_registry(pkg, name, **settings)
    for i, v in enumerate(versions):
        reg.register_stub(v, activate=(i == 0))
    return reg


def twin_registry(pkg, tmp_path, name, **settings):
    _, dir_a, dir_b = twin_checkpoints(tmp_path, same_weights=False,
                                       dtype="float32")
    reg = make_registry(pkg, name, **settings)
    reg.register("v1", dir_a, activate=True)
    reg.register("v2", dir_b)
    return reg, dir_a


def drain_all(batcher):
    while batcher.step():
        pass


# ── hot swap ────────────────────────────────────────────────────────


def swap_protocol(pkg, tmp_path, texts, **batcher_kw):
    """16 stamped v1, one batch served, swap to v2 (drains the other 8),
    the rest stamped v2: [(stamp, verdict)], the swap's result."""
    reg, dir_a = twin_registry(pkg, tmp_path, "hotswap")
    batcher = make_batcher(pkg, reg, max_batch=8, **batcher_kw)
    try:
        tickets = [batcher.enqueue(t) for t in texts[:16]]
        batcher.step()
        res = batcher.swap_to("v2")
        tickets += [batcher.enqueue(t) for t in texts[16:]]
        drain_all(batcher)
        assert all(tk.done.is_set() and tk.error is None for tk in tickets)
        return [(tk.version, tk.result) for tk in tickets], res, batcher
    finally:
        batcher.close()


class TestHotSwap:
    def test_swap_protocol_equals_jax_ticket_for_ticket(self, tmp_path):
        texts = generate_serve_texts(0, 28)
        builds = _build.builds
        got, res, batcher = swap_protocol(PORT, tmp_path, texts)
        assert _build.builds == builds, "a hot swap built a kernel"
        want, jres, _ = swap_protocol(JAX, tmp_path, texts)
        assert got == want
        assert [v for v, _ in got] == ["v1"] * 16 + ["v2"] * 12
        assert res["drained"] == jres["drained"] == 8
        assert set(res["stages"]) == {"drain", "place", "resume"}
        assert res["version"] == "v2" and res["totalMs"] >= 0
        q = batcher.timer.quantiles()
        assert {"swap_drain", "swap_place", "swap_resume"} <= set(q)
        assert batcher.stats()["activeVersion"] == "v2"
        # the negated head really differs: v1 and v2 verdicts disagree
        assert {r for v, r in got if v == "v1"} != \
            {r for v, r in got if v == "v2"}

    def test_swap_under_load_serves_every_stamp(self, tmp_path):
        """Eight threads through the collector, a swap after ~32 stamps and
        a rollback after ~64: every ticket served, by its stamp (JAX's
        verdict for that version), no kernel built."""
        texts = generate_serve_texts(1, 96)
        reg, _ = twin_registry(PORT, tmp_path, "load")
        jreg, _ = twin_registry(JAX, tmp_path, "load-oracle")
        want = {v: jreg._score(v, texts) for v in ("v1", "v2")}
        batcher = make_batcher(PORT, reg, max_batch=8, window_ms=1.0,
                               autostart=True)
        stamped = []
        lock = threading.Lock()
        results: list = [None] * len(texts)
        builds = _build.builds

        def worker(w):
            for i in range(w, len(texts), 8):
                tk = batcher.enqueue(texts[i])
                with lock:
                    stamped.append(i)
                assert tk.done.wait(60.0)
                results[i] = tk

        swaps = []

        def controller():
            deadline = time.monotonic() + 60.0
            for at, target in ((32, "v2"), (64, None)):
                while time.monotonic() < deadline:
                    with lock:
                        if len(stamped) >= at:
                            break
                    time.sleep(0.0005)
                swaps.append(batcher.swap_to(
                    target or reg.rollback_target()))

        threads = [threading.Thread(target=worker, args=(w,))
                   for w in range(8)] + [threading.Thread(target=controller)]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(120.0)
                assert not t.is_alive()
        finally:
            batcher.close()
        assert _build.builds == builds
        assert len(swaps) == 2 and reg.active() == "v1"
        assert reg.stats()["rollbacks"] == 1
        versions = {tk.version for tk in results}
        assert versions == {"v1", "v2"}
        for i, tk in enumerate(results):
            assert tk.error is None, "dropped request"
            assert tk.result == want[tk.version][i], \
                f"request {i} mis-versioned"

    def test_swap_requires_registry(self):
        batcher = batching.ContinuousBatcher(
            max_batch=4, window_ms=0.0, autostart=False, device="cpu",
            model_fn=lambda texts: [0] * len(texts))
        try:
            with pytest.raises(RuntimeError, match="model registry"):
                batcher.swap_to("v2")
            assert "activeVersion" not in batcher.stats()
        finally:
            batcher.close()

    def test_registry_off_path_equals_registry_on(self):
        """Registry off is the oracle: one shipped version through a
        registry serves the verdicts of the registry-less batcher, which
        are the JAX registry-less batcher's."""
        texts = generate_serve_texts(7, 12)

        def serve_with(pkg, reg):
            b = make_batcher(pkg, reg, max_batch=4)
            try:
                tickets = [b.enqueue(t) for t in texts]
                drain_all(b)
                return [tk.result for tk in tickets]
            finally:
                b.close()

        oracle = serve_with(PORT, None)
        reg = make_registry(PORT, "equiv")
        reg.register("v0")
        assert serve_with(PORT, reg) == oracle == serve_with(JAX, None)
        assert reg.stats()["versions"]["v0"]["served"] == len(texts)

    def test_failed_checkout_fails_the_batch_without_fallback(self, tmp_path):
        """A stamp whose checkout raises (a stub version behind a real
        batcher) fails its batch's tickets through the collector; other
        versions keep serving. JAX fails them the same way."""
        outcomes = []
        for pkg in (PORT, JAX):
            reg, _ = twin_registry(pkg, tmp_path, "failing")
            reg.register_stub("sim")
            reg.pin("t-sim", "sim")
            b = make_batcher(pkg, reg, max_batch=4, autostart=True)
            try:
                bad = b.enqueue("routine status", tenant="t-sim")
                good = b.enqueue("routine status", tenant="t0")
                assert bad.done.wait(30.0) and good.done.wait(30.0)
            finally:
                b.close()
            outcomes.append((type(bad.error), bad.result, good.error,
                             good.result))
        assert outcomes[0] == outcomes[1]
        assert outcomes[0][0] is RuntimeError and outcomes[0][3] is not None

    @pytest.mark.parametrize("with_registry", [False, True])
    def test_step_after_a_collector_took_the_queue_serves_nothing(
            self, with_registry):
        """``step`` saw a queued request, but the collector drained it
        before ``step`` could: the empty drain is a step that served 0."""
        reg = stub_registry(PORT, "raced") if with_registry else None
        b = make_batcher(PORT, reg, max_batch=4,
                         model_fn=sim_fn if with_registry else
                         (lambda texts: [0] * len(texts)))
        try:
            tk = b.enqueue("routine status")
            real_drain = b._drain
            b._drain = lambda: (real_drain(), [])[1]   # the collector won
            assert b.step() == 0
            assert not tk.done.is_set() and b.stats()["batches"] == 0
        finally:
            b.close()

    def test_swaps_race_a_running_collector(self):
        """The swap drains by stepping on the caller's thread while the
        collector serves the same queue: every ticket is served by its
        stamp, none fails, and every swap lands."""
        texts = generate_serve_texts(5, 200)
        reg = stub_registry(PORT, "race")
        b = make_batcher(PORT, reg, max_batch=4, model_fn=sim_fn,
                         autostart=True)
        tickets, lock = [], threading.Lock()

        def submitter(k):
            for t in texts[k::4]:
                tk = b.enqueue(t)
                with lock:
                    tickets.append(tk)
                time.sleep(0.0005)

        threads = [threading.Thread(target=submitter, args=(k,))
                   for k in range(4)]
        try:
            for th in threads:
                th.start()
            swaps = [b.swap_to(v) for v in ("v2", "v3", "v1") * 4]
            for th in threads:
                th.join(30.0)
            assert all(tk.done.wait(30.0) for tk in tickets)
        finally:
            b.close()
        assert len(tickets) == len(texts) and len(swaps) == 12
        assert reg.active() == "v1"
        for tk in tickets:
            assert tk.error is None, "dropped request"
            assert tk.result == expected_verdict(tk.text, tk.version)

    def test_failed_checkout_in_a_swap_drain_fails_that_batch(
            self, tmp_path):
        """A queued stamp whose checkout raises meets the swap's drain:
        its ticket gets the error at once, the swap raises and activates
        nothing, and the next swap serves the rest by their stamps."""
        reg, _ = twin_registry(PORT, tmp_path, "drain-fail")
        reg.register_stub("sim")
        reg.pin("t-sim", "sim")
        b = make_batcher(PORT, reg, max_batch=4)
        try:
            bad = b.enqueue("routine status", tenant="t-sim")
            good = [b.enqueue(t) for t in generate_serve_texts(3, 4)]
            with pytest.raises(RuntimeError, match="stub"):
                b.swap_to("v2")
            assert bad.done.is_set() and isinstance(bad.error, RuntimeError)
            assert bad.result is None and reg.active() == "v1"
            res = b.swap_to("v2")
            assert res["drained"] == len(good) and reg.active() == "v2"
            assert all(tk.done.is_set() and tk.error is None
                       and tk.version == "v1" for tk in good)
        finally:
            b.close()

    def test_registry_on_another_device_is_refused(self):
        other = types.SimpleNamespace(device=torch.device("cuda"))
        with pytest.raises(ValueError, match="places on"):
            batching.ContinuousBatcher(autostart=False, device="cpu",
                                       registry=other)


# ── seeded storms over stub versions ────────────────────────────────


def run_storm(pkg, seed):
    """JAX's TestSwapRollbackChaosStorm schedule on ``pkg``'s batcher."""
    reg = stub_registry(pkg, f"storm-{seed}")
    batcher = make_batcher(pkg, reg, max_batch=4, model_fn=sim_fn)
    rng = random.Random(f"lifecycle-storm:{seed}")
    texts = generate_serve_texts(seed, 120)
    tickets, log = [], []
    try:
        for text in texts:
            r = rng.random()
            if r < 0.08:
                target = rng.choice([v for v in reg.versions()
                                     if v != reg.active()])
                log.append(("swap", target,
                            batcher.swap_to(target)["drained"]))
            elif r < 0.12:
                if rng.random() < 0.5:
                    v, f = rng.choice(["v2", "v3"]), rng.choice([0.25, 0.5])
                    reg.set_canary(v, f)
                    log.append(("canary", v, f))
                else:
                    reg.clear_canary()
                    log.append(("canary", None, 0.0))
            elif r < 0.16:
                t = f"tenant{rng.randrange(3)}"
                if rng.random() < 0.5:
                    v = rng.choice(reg.versions())
                    reg.pin(t, v)
                    log.append(("pin", t, v))
                else:
                    reg.unpin(t)
                    log.append(("unpin", t))
            tickets.append((text, batcher.enqueue(
                text, tenant=f"tenant{rng.randrange(3)}")))
            if rng.random() < 0.5:
                batcher.step()
        drain_all(batcher)
    finally:
        batcher.close()
    st = reg.stats()
    for text, tk in tickets:
        assert tk.done.is_set() and tk.error is None, "dropped request"
        assert tk.result == expected_verdict(text, tk.version), \
            "mis-versioned verdict"
    summary = [(text, tk.version, tk.result) for text, tk in tickets]
    return summary + [("counters", st["swaps"], st["rollbacks"],
                       st["resolved"])] + log


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_storm_equals_jax_ticket_for_ticket(seed):
    got = run_storm(PORT, seed)
    assert got == run_storm(PORT, seed)          # reruns bit-identical
    assert got == run_storm(JAX, seed)
    assert any(e[0] == "swap" for e in got if isinstance(e, tuple))


def test_rollback_is_the_same_protocol():
    outs = []
    for pkg in (PORT, JAX):
        reg = stub_registry(pkg, "storm-rollback")
        b = make_batcher(pkg, reg, max_batch=4, model_fn=sim_fn)
        try:
            b.swap_to("v2")
            tk = b.enqueue("after rollout")
            b.swap_to(reg.rollback_target())
            tk2 = b.enqueue("after rollback")
            drain_all(b)
        finally:
            b.close()
        assert (tk.version, tk2.version) == ("v2", "v1")
        assert tk.result == expected_verdict("after rollout", "v2")
        assert tk2.result == expected_verdict("after rollback", "v1")
        assert reg.stats()["rollbacks"] == 1
        outs.append((tk.result, tk2.result, reg.stats()["swaps"]))
    assert outs[0] == outs[1]


# ── a JAX ReplicaFleet hosting the port's batchers ──────────────────


class TestFleetVersioning:
    """``tests/test_model_lifecycle.py::TestFleetVersioning`` with the
    port's batchers and registry behind the JAX fleet (``batcher_factory``
    returns ``(batcher, None)``: the fleet closes the batcher itself)."""

    def make_fleet(self, transport, name, results):
        from vainplex_openclaw_tpu.cluster.fleet import ReplicaFleet

        reg = make_registry(PORT, name)
        reg.register_stub("v1", activate=True)
        reg.register_stub("v2")

        def factory(rid, worker_id):
            return make_batcher(PORT, reg, max_batch=4, model_fn=sim_fn), None

        fleet = ReplicaFleet(
            {"replicas": 2, "maxBatch": 4, "windowMs": 0.0, "ackEvery": 64},
            transport=transport, workers=lambda: ["w0"],
            batcher_factory=factory, registry=reg,
            on_result=lambda op, obs: results.__setitem__(op.get("i"), obs),
            adopt=(name.endswith("-b")))
        return fleet, reg

    def test_edge_stamps_and_obs_carry_version(self):
        transport = MemoryTransport()
        results: dict = {}
        fleet, reg = self.make_fleet(transport, "fleet-stamp", results)
        try:
            fleet.set_model_canary("v2", 0.5)
            for i in range(8):
                fleet.submit({"i": i, "text": f"op {i}", "tenant": "t0"})
            fleet.pump()
        finally:
            fleet.close()
        versions = [results[i]["version"] for i in range(8)]
        assert versions.count("v2") == 4
        for i in range(8):
            assert results[i]["verdict"] == \
                expected_verdict(f"op {i}", versions[i])
        reqs = [e.payload for e in transport.fetch(
            subject_filter=fleet._req_subject)]
        assert [r["version"] for r in reqs] == versions

    def test_ctl_adoption_and_redelivery_preserve_stamps(self):
        transport = MemoryTransport()
        ra: dict = {}
        a, _ = self.make_fleet(transport, "fleet-a", ra)
        for i in range(6):
            a.submit({"i": i, "text": f"op {i}", "tenant": "t0"})
        a.pin_tenant_model("t9", "v2")
        a.activate_model("v2")     # drains + swaps A's replicas, ctl-logged
        rb: dict = {}
        b, reg_b = self.make_fleet(transport, "fleet-b", rb)
        try:
            assert b.redelivered >= 6
            assert reg_b.active() == "v2"
            assert reg_b.stats()["pins"] == {"t9": "v2"}
            b.pump()
            for i in range(6):
                assert rb[i]["version"] == "v1", "redelivery lost the stamp"
                assert rb[i]["verdict"] == expected_verdict(f"op {i}", "v1")
            b.submit({"i": 100, "text": "post-adopt", "tenant": "t0"})
            b.pump()
            assert rb[100]["version"] == "v2"
        finally:
            a.close()
            b.close()

    def test_unknown_replayed_version_skipped_with_warning(self):
        from vainplex_openclaw_tpu.core.api import list_logger

        fleet, reg = self.make_fleet(MemoryTransport(), "fleet-skip", {})
        try:
            fleet.logger = list_logger()
            fleet._apply_model({"op": "activate", "version": "v99"})
            assert reg.active() == "v1"
            assert any("not registered" in m
                       for m in fleet.logger.messages("warn"))
        finally:
            fleet.close()

    def test_fleet_stats_surface_registry(self):
        fleet, _ = self.make_fleet(MemoryTransport(), "fleet-stats", {})
        try:
            st = fleet.stats()
            assert st["modelRegistry"]["active"] == "v1"
            assert "paging" in st["modelRegistry"]
        finally:
            fleet.close()


# ── the arc through the real gateway ────────────────────────────────


def test_canary_promote_swap_rollback_through_the_gateway(
        tmp_path, openclaw_home):
    """The port's call_llm (``serve.modelRegistry`` on) in the real
    GovernancePlugin: bootstrap v0, canary a twin, promote through the
    gate, hot-swap, roll back; the port's sitrep collector reads the
    port's book."""
    from vainplex_openclaw_tpu.governance import GovernancePlugin
    from vainplex_openclaw_tpu_torch.sitrep.collectors import (
        collect_model_registry)

    meta = {"agent_id": "main", "session_key": "agent:main",
            "channel_id": "twitter"}
    try:
        call = serve.make_local_call_llm(
            serve_cfg={"modelRegistry": {"benchRounds": 1,
                                         "benchFactor": 4.0}},
            device="cpu")
        gw, _ = make_gateway()
        plugin = GovernancePlugin(workspace=str(tmp_path), clock=gw.clock,
                                  call_llm=call)
        gw.load(plugin, plugin_config={
            "enabled": True, "builtinPolicies": {},
            "validation": {"enabled": True, "llmValidator": {
                "enabled": True, "failMode": "closed"}}})
        gw.start()
        batcher = plugin.engine.output_validator.llm_validator \
            .call_llm.batcher
        reg = batcher.registry
        assert reg is not None and reg.active() == "v0"
        assert reg.name == "serve:global" and reg.device.type == "cpu"
        assert batcher.stats()["activeVersion"] == "v0"
        assert hasattr(gw.message_sending("status update one", meta),
                       "blocked")

        reg.register("v1")            # twin from the shipped default
        reg.set_canary("v1", 0.5)
        for i in range(4):
            gw.message_sending(f"canary probe {i}", meta)
        assert reg.stats()["versions"]["v1"]["served"] >= 1

        report = reg.promotion_report("v1")   # shadow ring replay
        assert report["replayed"] >= 1
        assert report["verdictRegressions"] == 0
        reg.promote("v1", report=report)
        res = batcher.swap_to("v1")
        assert reg.active() == "v1" and res["version"] == "v1"
        after = gw.message_sending("tool deploy failed: connection refused",
                                   meta)
        batcher.swap_to(reg.rollback_target())
        assert reg.active() == "v0" and reg.stats()["rollbacks"] == 1
        again = gw.message_sending("tool deploy failed: connection refused",
                                   meta)
        assert (after.blocked, after.content) == (again.blocked,
                                                  again.content)
        gw.stop()

        ops = collect_model_registry({}, {})
        assert ops["status"] == "ok"
        item = next(i for i in ops["items"]
                    if i["registry"] == "serve:global")
        assert item["active"] == "v0" and item["swaps"] >= 2
        assert item["promotions"] == 1
    finally:
        serve.close_batchers()


# ── mesh swap ───────────────────────────────────────────────────────


def test_mesh_swap_equals_single_device_swap(tmp_path):
    """The swap protocol on a (2, 2) dp×tp grid of CPUs serves the
    single-device swap's verdicts; with one resident version the evicted
    version leaves no placement behind."""
    texts = generate_serve_texts(2, 28)
    single, _, _ = swap_protocol(PORT, tmp_path, texts)
    registry.clear_registries()
    reg, _ = twin_registry(PORT, tmp_path, "mesh", maxResidentVersions=1)
    b = make_batcher(PORT, reg, max_batch=8,
                     mesh=cached_mesh((2, 2), ("dp", "tp"), "cpu"))
    try:
        tickets = [b.enqueue(t) for t in texts[:16]]
        b.step()
        b.swap_to("v2")
        tickets += [b.enqueue(t) for t in texts[16:]]
        drain_all(b)
    finally:
        b.close()
    assert [(tk.version, tk.result) for tk in tickets] == single
    assert reg.is_paged("v1") and b.stats()["mesh"] == "2x2"
    with plan._sharded_lock:
        keys = {ck[0] for ck in plan._sharded_params}
    assert reg.placement_key("v1") not in keys
    assert reg.placement_key("v2") in keys
    plan.drop_sharded_params(reg.placement_key("v2"))


# ── the shared batcher ──────────────────────────────────────────────


def test_shared_batcher_keys_on_the_registry_section():
    """The section decides the batcher: on and off never share a queue,
    and an enabled section serves from ``serve:global`` with the
    checkpoint as ``"v0"``, as the JAX shared batcher does."""
    cfg = {"windowMs": 0.0}
    try:
        a = serve.shared_batcher(None, dict(cfg, modelRegistry=True),
                                 device="cpu")
        assert serve.shared_batcher(None, dict(cfg, modelRegistry=True),
                                    device="cpu") is a
        plain = serve.shared_batcher(None, cfg, device="cpu")
        assert plain is not a and plain.registry is None
        j = jax_serve.shared_batcher(
            None, {**jax_serve.SERVE_DEFAULTS, **cfg, "modelRegistry": True})
        assert a.registry.name == j.registry.name == "serve:global"
        assert a.registry.active() == j.registry.active() == "v0"
        assert registry.all_registries() == {"serve:global": a.registry}
        assert a.submit("routine status") == j.submit("routine status")
    finally:
        serve.close_batchers()
        jax_serve.close_batchers()
    assert not serve._batchers
