"""The port's serve path against the JAX one-shot oracle.

The port's ``ContinuousBatcher`` (``device="cpu"``: the attention's plain
version) must render verdict strings identical to the JAX package's
one-shot path (``make_local_call_llm(force=True, serve_cfg=
{"continuousBatching": False})``) over the seeded request mixes of
``tests/test_serve_batching.py`` and over triage texts whose verdicts span
pass, flag and block — stepped, through the collector thread, at every
drain size from 1 to 33, and end to end through the real gateway with the
port's ``call_llm`` injected into ``GovernancePlugin``.
"""

from __future__ import annotations

import json
import threading
import time

import numpy as np
import pytest
import torch

from helpers import make_gateway
from vainplex_openclaw_tpu.config.loader import deep_merge as jax_deep_merge
from vainplex_openclaw_tpu.governance.validation.llm_validator import (
    build_prompt)
from vainplex_openclaw_tpu.models import batching as jax_batching
from vainplex_openclaw_tpu.models import serve as jax_serve
from vainplex_openclaw_tpu.models.data import synthetic_examples
from vainplex_openclaw_tpu.resilience.admission import (
    AdmissionController as JaxAdmission)
from vainplex_openclaw_tpu.utils.stage_timer import StageTimer as JaxTimer
from vainplex_openclaw_tpu_torch.config.loader import deep_merge
from vainplex_openclaw_tpu_torch.models import batching, serve
from vainplex_openclaw_tpu_torch.parallel.mesh import cached_mesh
from vainplex_openclaw_tpu_torch.resilience.admission import (
    AdmissionController)
from vainplex_openclaw_tpu_torch.utils.stage_timer import StageTimer


def seeded_texts(n, seed=0):
    """The request mix of tests/test_serve_batching.py, verbatim."""
    rng = np.random.default_rng(seed)
    subjects = ("deploy", "incident", "migration", "quarterly report",
                "release", "benchmark", "audit", "customer email")
    verbs = ("completed", "failed", "regressed", "crashed", "improved",
             "shipped", "stalled", "recovered")
    return [
        f"The {rng.choice(subjects)} {rng.choice(verbs)} with code "
        f"{int(rng.integers(0, 500))}; throughput changed "
        f"{int(rng.integers(-60, 90))}%."
        for _ in range(n)
    ]


def mixed_texts(n, seed=0):
    """Seeded mix plus triage texts: verdicts span pass, flag and block."""
    triage = [t for t, _ in synthetic_examples(n, seed=seed)]
    seeded = seeded_texts(n, seed)
    return [triage[i] if i % 2 else seeded[i] for i in range(n)]


_jax_oneshot = None


def jax_oracle(texts):
    global _jax_oneshot
    if _jax_oneshot is None:
        _jax_oneshot = jax_serve.make_local_call_llm(
            force=True, serve_cfg={"continuousBatching": False})
    return [_jax_oneshot(build_prompt(t, [])) for t in texts]


def make_batcher(**kw):
    kw.setdefault("autostart", False)
    kw.setdefault("device", "cpu")
    return batching.ContinuousBatcher(**kw)


def serve_all(batcher, texts, poll_s: float = 0.02):
    """Submit every text from its own thread and step the batcher from the
    test thread. Returns results in submission order."""
    results: list = [None] * len(texts)
    errors: list = [None] * len(texts)

    def worker(i):
        try:
            results[i] = batcher.submit(texts[i], timeout_s=120.0)
        except Exception as exc:  # noqa: BLE001 — surfaced per index
            errors[i] = exc

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(texts))]
    for t in threads:
        t.start()
    served = 0
    deadline = time.monotonic() + 120.0
    while served < len(texts) and time.monotonic() < deadline:
        served += batcher.step(wait_s=poll_s)
    for t in threads:
        t.join(10.0)
        assert not t.is_alive()
    for exc in errors:
        if exc is not None:
            raise exc
    return results


class TestVerdictParity:
    @pytest.mark.parametrize("seed,n", [(0, 7), (1, 16), (2, 33)])
    def test_seeded_concurrent_mix_equals_jax_oracle(self, seed, n):
        texts = seeded_texts(n, seed)
        prompts = [build_prompt(t, []) for t in texts]
        batcher = make_batcher(max_batch=8, window_ms=0.0)
        try:
            got = serve_all(batcher, [serve._extract_message(p)
                                      for p in prompts])
        finally:
            batcher.close()
        assert got == jax_oracle(texts)
        assert batcher.served == n and batcher.batches >= -(-n // 8)

    @pytest.mark.parametrize("seed,n", [(0, 7), (1, 16), (2, 33)])
    def test_mixed_severity_mix_equals_jax_oracle(self, seed, n):
        texts = mixed_texts(n, seed)
        oracle = jax_oracle(texts)
        batcher = make_batcher(max_batch=8, window_ms=0.0)
        try:
            got = serve_all(batcher, texts)
        finally:
            batcher.close()
        assert got == oracle
        verdicts = {json.loads(v)["verdict"] for v in oracle}
        assert len(verdicts) >= 2
        if n >= 33:
            assert verdicts == {"pass", "flag", "block"}

    @pytest.mark.parametrize("n", range(1, 34))
    def test_every_drain_size_equals_jax_oracle(self, n):
        """One drain of n requests → one batch padded to pow2(n): the pad
        rows (every key masked) never leak into the real rows."""
        texts = mixed_texts(n, seed=100 + n)
        batcher = make_batcher(max_batch=64, window_ms=0.0)
        try:
            tickets = [batcher.enqueue(t) for t in texts]
            assert batcher.step() == n
            assert batcher.batches == 1
        finally:
            batcher.close()
        assert [t.result for t in tickets] == jax_oracle(texts)

    def test_collector_thread_path_equals_jax_oracle(self):
        texts = mixed_texts(12, seed=4)
        prompts = [build_prompt(t, []) for t in texts]
        call = serve.make_local_call_llm(
            serve_cfg={"maxBatch": 4, "windowMs": 1.0}, device="cpu")
        try:
            assert call.batcher._thread is not None
            got: list = [None] * len(prompts)

            def worker(i):
                got[i] = call(prompts[i])

            threads = [threading.Thread(target=worker, args=(i,))
                       for i in range(len(prompts))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(120.0)
            assert got == jax_oracle(texts)
        finally:
            serve.close_batchers()

    def test_port_oneshot_equals_port_batched_and_jax(self):
        texts = mixed_texts(9, seed=8)
        oneshot = serve.make_local_call_llm(
            serve_cfg={"continuousBatching": False}, device="cpu")
        assert getattr(oneshot, "batcher", None) is None
        got = [oneshot(build_prompt(t, [])) for t in texts]
        assert got == jax_oracle(texts)


class TestSharedContracts:
    @pytest.mark.parametrize("severity", range(8))
    def test_render_verdict_string_identical(self, severity):
        assert batching.render_verdict(severity) == \
            jax_batching.render_verdict(severity)

    def test_severity_table_and_defaults_equal(self):
        assert batching.SEVERITY_TO_VERDICT == jax_batching.SEVERITY_TO_VERDICT
        assert serve.SERVE_DEFAULTS == jax_serve.SERVE_DEFAULTS

    @pytest.mark.parametrize("text", [
        "plain text", "para one\n\npara two\n\nIdentify issues inside",
        "", "  padded  "])
    def test_extract_message_equal(self, text):
        for prompt in (build_prompt(text, []), text):
            assert serve._extract_message(prompt) == \
                jax_serve._extract_message(prompt)

    def test_deep_merge_equal(self):
        over = {"maxBatch": 4, "admission": {"highWatermark": 2},
                "extra": {"a": 1}}
        assert deep_merge(serve.SERVE_DEFAULTS, over) == \
            jax_deep_merge(jax_serve.SERVE_DEFAULTS, over)

    def test_admission_decisions_equal(self):
        rng = np.random.default_rng(0)
        mine, ref = AdmissionController(8), JaxAdmission(8)
        for _ in range(400):
            depth = int(rng.integers(0, 40))
            tenant = f"t{int(rng.integers(0, 3))}"
            mine.note_queue_depth(depth)
            ref.note_queue_depth(depth)
            assert mine.admit(tenant) == ref.admit(tenant)
        assert mine.stats() == ref.stats()

    def test_stage_timer_equal(self):
        rng = np.random.default_rng(1)
        mine, ref = StageTimer(), JaxTimer()
        for _ in range(200):
            stage = ("queue", "batch", "prefill", "decode")[
                int(rng.integers(0, 4))]
            ms = float(rng.exponential(3.0))
            mine.add(stage, ms)
            ref.add(stage, ms)
        assert mine.snapshot() == ref.snapshot()
        assert mine.state() == ref.state()


class TestAdmissionAndFailureModes:
    def test_shed_raises_and_counts_never_fabricates_verdict(self):
        batcher = make_batcher(max_batch=8, window_ms=0.0,
                               admission=AdmissionController(high_watermark=1))
        texts = seeded_texts(4, seed=6)
        try:
            blocked = [threading.Thread(target=batcher.submit, args=(t,))
                       for t in texts]
            for t in blocked:
                t.start()
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline:
                with batcher._lock:
                    if len(batcher._queue) == 4:
                        break
                time.sleep(0.005)
            with pytest.raises(batching.ServeSheddedError,
                               match="admission shed"):
                batcher.submit("one request too many")
            stats = batcher.stats()
            assert stats["shed"] == 1 and stats["admission"]["shed"] == 1
            while batcher.step(wait_s=0.05):
                pass
            for t in blocked:
                t.join(5.0)
                assert not t.is_alive()
            assert batcher.stats()["served"] == 4
        finally:
            batcher.close()

    def test_closed_batcher_refuses_submits(self):
        batcher = make_batcher()
        batcher.close()
        with pytest.raises(RuntimeError, match="closed"):
            batcher.submit("late request")

    def test_worker_exception_fans_out_to_requests(self, monkeypatch):
        def boom(self, batch):
            raise RuntimeError("boom")

        monkeypatch.setattr(batching.ContinuousBatcher, "_run_batch", boom)
        batcher = make_batcher(max_batch=4, window_ms=0.0, autostart=True)
        errs: list = [None, None]

        def worker(i):
            try:
                batcher.submit(f"text {i}", timeout_s=10.0)
            except Exception as exc:  # noqa: BLE001
                errs[i] = exc

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(2)]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(15.0)
                assert not t.is_alive()
        finally:
            batcher.close()
        assert all(isinstance(e, RuntimeError) and "boom" in str(e)
                   for e in errs)

    @pytest.mark.parametrize("package", ["port", "jax"])
    @pytest.mark.parametrize("exc_type", [SystemExit, KeyboardInterrupt])
    def test_base_exception_reaches_submitters_and_collector_survives(
            self, exc_type, package):
        """A SystemExit or KeyboardInterrupt raised inside a batch reaches
        that batch's submitters at once, as in the JAX batcher, and the
        collector thread goes on serving the next batch."""
        raised = []

        def model_fn(texts):
            if not raised:
                raised.append(1)
                raise exc_type("inside the batch")
            return [1] * len(texts)

        kw = dict(max_batch=4, window_ms=0.0, autostart=True,
                  model_fn=model_fn)
        batcher = make_batcher(**kw) if package == "port" else \
            jax_batching.ContinuousBatcher(**kw)
        got: list = [None]

        def worker():
            try:
                got[0] = batcher.submit("first", timeout_s=10.0)
            except BaseException as exc:  # noqa: BLE001 — the subject
                got[0] = exc

        try:
            t0 = time.monotonic()
            t = threading.Thread(target=worker)
            t.start()
            t.join(15.0)
            assert not t.is_alive()
            assert isinstance(got[0], exc_type)
            assert time.monotonic() - t0 < 5.0  # not the submit timeout
            assert batcher._thread.is_alive()
            assert batcher.submit("second", timeout_s=10.0) == \
                batching.render_verdict(1)
        finally:
            batcher.close()

    def test_missing_checkpoint_refused_at_construction(self, tmp_path):
        with pytest.raises(RuntimeError, match="no trained checkpoint"):
            batching.ContinuousBatcher(str(tmp_path / "nope"),
                                       autostart=False, device="cpu")
        with pytest.raises(RuntimeError, match="no trained checkpoint"):
            serve.make_local_call_llm(str(tmp_path / "nope"), device="cpu")

    def test_model_fn_seam(self):
        batcher = make_batcher(max_batch=4, window_ms=0.0,
                               model_fn=lambda texts: [len(t) % 4
                                                       for t in texts])
        try:
            tickets = [batcher.enqueue("x" * i) for i in range(6)]
            assert batcher.drain() == 6
        finally:
            batcher.close()
        assert [t.result for t in tickets] == \
            [batching.render_verdict(i % 4) for i in range(6)]
        assert batcher.occupancy() == {"queued": 0, "maxBatch": 4,
                                       "oldestAt": None}


class TestDeviceAndUnportedOptions:
    def test_no_device_means_the_card_and_raises_here(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.make_local_call_llm()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            batching.ContinuousBatcher(autostart=False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.shared_batcher(None, {})

    @pytest.mark.parametrize("scfg", [
        {"meshServing": True}, {"planFamily": "encoder_validator_pp"},
        {"modelRegistry": True}, {"modelRegistry": {"benchRounds": 1}}])
    def test_unported_serve_options_raise(self, scfg):
        """Every one of these options now serves the JAX oracle's
        verdicts: the model registry (the checkpoint as the incumbent
        "v0"), mesh serving (the default dp×tp family over the auto grid)
        and a plan family without meshServing (one device)."""
        try:
            call = serve.make_local_call_llm(
                serve_cfg=dict(scfg, windowMs=0.0), device="cpu")
            texts = mixed_texts(6, seed=2)
            assert [call(build_prompt(t, [])) for t in texts] == \
                jax_oracle(texts)
            assert call.batcher.stats()["mesh"] == \
                ("2x4" if scfg.get("meshServing") else None)
            if "modelRegistry" in scfg:
                assert call.batcher.registry.active() == "v0"
                assert call.batcher.stats()["activeVersion"] == "v0"
            else:
                assert call.batcher.registry is None
        finally:
            serve.close_batchers()

    def test_registry_off_dict_is_accepted(self):
        call = serve.make_local_call_llm(
            serve_cfg={"modelRegistry": {"enabled": False},
                       "continuousBatching": False}, device="cpu")
        assert json.loads(call("ok"))["verdict"] in ("pass", "flag", "block")

    @pytest.mark.parametrize("kw", [{"mesh": (2, 2)}, {"registry": "v0"}])
    def test_batcher_mesh_and_registry_raise(self, kw):
        """Neither raises any more: a dp×tp mesh, and a registry serving
        the shipped checkpoint as its one version, serve the verdicts of
        the plain batcher."""
        from vainplex_openclaw_tpu_torch.models.registry import (
            ModelRegistry, clear_registries)

        if "registry" in kw:
            reg = ModelRegistry({"enabled": True}, name="batcher-kw",
                                device="cpu")
            reg.register(kw["registry"])
            meshy = make_batcher(registry=reg)
            clear_registries()
        else:
            meshy = make_batcher(mesh=cached_mesh(kw["mesh"], ("dp", "tp"),
                                                  "cpu"))
        plain = make_batcher()
        texts = mixed_texts(7, seed=3)
        try:
            got = [meshy.enqueue(t) for t in texts]
            want = [plain.enqueue(t) for t in texts]
            assert meshy.drain() == plain.drain() == len(texts)
        finally:
            meshy.close()
            plain.close()
        assert [t.result for t in got] == [t.result for t in want]
        if "registry" in kw:
            assert [t.version for t in got] == ["v0"] * len(texts)
            assert meshy.stats()["activeVersion"] == "v0"
        else:
            assert meshy.stats()["mesh"] == "2x2"

    def test_swap_to_raises(self):
        """Without a registry, swap_to raises JAX's RuntimeError."""
        batcher = make_batcher()
        try:
            with pytest.raises(RuntimeError, match="model registry"):
                batcher.swap_to("v1")
        finally:
            batcher.close()


class TestStageAttributionAndSharing:
    def test_stage_timer_counts_every_request(self):
        batcher = make_batcher(max_batch=4, window_ms=0.0)
        texts = seeded_texts(9, seed=7)
        try:
            serve_all(batcher, texts)
            snap = batcher.timer.snapshot()
            for stage in ("queue", "batch", "prefill", "decode"):
                assert stage in snap["stages_ms"], stage
                assert set(snap["quantiles"][stage]) == {"p50", "p95",
                                                         "p99"}
            assert snap["counts"]["queue"] == len(texts)
            assert snap["counts"]["prefill"] == batcher.batches
            stats = batcher.stats()
            assert stats["served"] == len(texts)
            assert stats["device"] == "cpu"
        finally:
            batcher.close()

    def test_shared_batcher_per_config_and_device(self):
        try:
            a = serve.make_local_call_llm(device="cpu")
            b = serve.make_local_call_llm(device=torch.device("cpu"))
            assert a.batcher is b.batcher
            c = serve.make_local_call_llm(serve_cfg={"maxBatch": 4},
                                          device="cpu")
            assert c.batcher is not a.batcher
            assert a.batcher.device == torch.device("cpu")
        finally:
            serve.close_batchers()

    def test_close_batchers_stops_collectors(self):
        call = serve.make_local_call_llm(device="cpu")
        t = call.batcher._thread
        assert t is not None and t.is_alive()
        serve.close_batchers()
        t.join(5.0)
        assert not t.is_alive()
        assert not serve._batchers


class TestGatewayEndToEnd:
    """The port's call_llm injected into the real GovernancePlugin gives
    the same decisions as the JAX local path, with no JAX file edited."""

    META = {"agent_id": "main", "session_key": "agent:main",
            "channel_id": "twitter"}

    def load(self, workspace, call_llm, lcfg):
        from vainplex_openclaw_tpu.governance import GovernancePlugin

        gw, _ = make_gateway()
        plugin = GovernancePlugin(workspace=str(workspace), clock=gw.clock,
                                  call_llm=call_llm)
        gw.load(plugin, plugin_config={
            "enabled": True, "builtinPolicies": {},
            "validation": {"enabled": True, "llmValidator": lcfg}})
        gw.start()
        return gw, plugin

    def decisions(self, gw, texts):
        out = []
        for text in texts:
            d = gw.message_sending(text, dict(self.META))
            out.append((d.blocked, d.content, d.block_reason))
        return out

    def test_injected_port_call_matches_jax_local_path(self, tmp_path,
                                                       openclaw_home):
        pool = synthetic_examples(200, seed=11)
        texts = [t for sev in range(4)
                 for t in [t for t, lab in pool if lab["severity"] == sev][:5]]
        texts += seeded_texts(4, seed=11)
        (tmp_path / "a").mkdir()
        (tmp_path / "b").mkdir()
        try:
            port_call = serve.make_local_call_llm(device="cpu")
            gw_port, plugin = self.load(tmp_path / "a", port_call,
                                        {"enabled": True,
                                         "failMode": "closed"})
            assert plugin.engine.output_validator.llm_validator.call_llm \
                is port_call
            got = self.decisions(gw_port, texts)
            gw_jax, _ = self.load(tmp_path / "b", None,
                                  {"enabled": True, "local": True,
                                   "failMode": "closed"})
            want = self.decisions(gw_jax, texts)
            gw_port.stop()
            gw_jax.stop()
        finally:
            serve.close_batchers()
            jax_serve.close_batchers()
        assert got == want
        assert any(blocked for blocked, _, _ in got)
        assert any(not blocked for blocked, _, _ in got)
