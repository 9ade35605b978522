"""The port's ``CortexPlugin`` against the JAX package's, each through its
own ``Gateway``.

JAX's demo script and a seeded multi-tenant stream (received and sent
messages, ``agent_end``, ``session_start``, ``before_compaction``, the
virtual clock moving by minutes to days) through both gateways, with the
journal and the lifecycle on, the journal alone, and both off: every hook
result, ``/cortexstatus`` (less its host-clock lines), ``cortex.patternSafety``
and each workspace's tree (a gzip'd cold segment by its content) are
equal, with the id RNG seeded alike. The worker profile's two configs
(JAX's ``build_worker_gateway``) load into the port's ``Gateway`` and
answer JAX's ``dispatch_op`` kinds as JAX's do. ``/trace-analyze`` through
the plugin writes JAX's files.

Deviations, each beside the JAX behaviour it departs from: an error of the
device raised by an injected enhancer ``call_llm`` propagates out of the
port's ``gw.message_received``, where JAX logs it and falls back to regex; a
plain ``RuntimeError`` gives identical files on both sides; a missing card
raises at ``gw.load`` for a plugin whose trace analyzer is enabled without
``device="cpu"``; redaction loads, with JAX's hook priorities.
"""

from __future__ import annotations

import dataclasses
import gzip
import json
import random
from pathlib import Path

import pytest

from helpers import FakeClock
# the bounds module puts the repository root on the path for chip_smoke
from test_torch_chip_smoke_bounds import one_torch_thread  # noqa: F401
from test_cortex_perf_equiv import random_message
import chip_smoke  # noqa: E402
from vainplex_openclaw_tpu import core as jax_core
from vainplex_openclaw_tpu.cluster import worker as jax_worker
from vainplex_openclaw_tpu.core import api as jax_api
from vainplex_openclaw_tpu.cortex import CortexPlugin as JaxCortex
from vainplex_openclaw_tpu.cortex import demo as jax_demo
from vainplex_openclaw_tpu.cortex import plugin as jax_plugin_mod
from vainplex_openclaw_tpu.cortex.trace_analyzer import (
    MemoryTraceSource as JaxTraceSource)
from vainplex_openclaw_tpu.storage import journal as jax_journal
from vainplex_openclaw_tpu.utils import ids as jax_ids
from vainplex_openclaw_tpu_torch import core as port_core
from vainplex_openclaw_tpu_torch.core import api as port_api
from vainplex_openclaw_tpu_torch.cortex import CortexPlugin
from vainplex_openclaw_tpu_torch.cortex import demo as port_demo
from vainplex_openclaw_tpu_torch.cortex import patterns as port_patterns
from vainplex_openclaw_tpu_torch.cortex import plugin as port_plugin_mod
from vainplex_openclaw_tpu_torch.cortex.trace_analyzer import (
    MemoryTraceSource)
from vainplex_openclaw_tpu_torch.device import DeviceError
from vainplex_openclaw_tpu_torch.governance import GovernancePlugin
from vainplex_openclaw_tpu_torch.storage import journal as port_journal
from vainplex_openclaw_tpu_torch.utils import ids as port_ids

JAX = dict(core=jax_core, api=jax_api, cortex=JaxCortex, ids=jax_ids,
           journal=jax_journal)
PORT = dict(core=port_core, api=port_api, ids=port_ids, journal=port_journal,
            cortex=lambda **kw: CortexPlugin(device="cpu", **kw))
STORAGE = {"journal+lifecycle": {"journal": True,
                                 "lifecycle": {"maxResident": 2}},
           "journal": {"journal": True, "lifecycle": False},
           "legacy": {"journal": False, "lifecycle": False}}
START = 1_700_000_000.0


def tree(ws: Path) -> dict:
    out = {}
    for p in sorted(ws.rglob("*")):
        if p.is_file():
            data = p.read_bytes()
            out[str(p.relative_to(ws))] = (gzip.decompress(data)
                                           if p.suffix == ".gz" else data)
    return out


def cortex_gateway(pkg, ws: Path, config: dict, clock, call_llm=None,
                   **plugin_kw):
    log = pkg["api"].list_logger()
    gw = pkg["core"].Gateway(config={"workspace": str(ws)}, logger=log,
                             clock=clock)
    plugin = pkg["cortex"](workspace=str(ws), clock=clock, wall_timers=False,
                           call_llm=call_llm, **plugin_kw)
    gw.load(plugin, plugin_config={"enabled": True, **config}, logger=log)
    gw.start()
    return gw, plugin, log


def status_of(gw, ws: Path) -> str:
    return chip_smoke.worker_status_text(gw.command("/cortexstatus")["text"],
                                         str(ws))


def run_stream(pkg, ws: Path, config: dict, ops, call_llm=None) -> dict:
    pkg["ids"]._ID_RNG.seed(3)
    clock = FakeClock(START)
    gw, plugin, log = cortex_gateway(pkg, ws, config, clock, call_llm)
    results = []
    try:
        for op in ops:
            kind, ctx = op[0], dict(op[2], workspace=str(ws / op[2]["t"]))
            if kind == "in":
                res = gw.message_received(op[1], ctx)
            elif kind == "out":
                res = gw.message_sent(op[1], ctx)
            elif kind == "end":
                res = gw.agent_end(ctx, final_message=op[1])
            elif kind == "start":
                res = gw.session_start(ctx)
            elif kind == "compact":
                res = gw.before_compaction(ctx, messages=[
                    {"role": "user", "content": op[1]}])
            elif kind == "status":
                res = status_of(gw, ws)
            else:
                res = clock.advance(op[1])
            results.append(res)
        out = {"results": results, "status": status_of(gw, ws),
               "safety": gw.call_method("cortex.patternSafety"),
               "lifecycle": (None if plugin.lifecycle is None else {
                   k: v for k, v in plugin.lifecycle.stats().items()
                   if k not in ("wakeP50Ms", "wakeP99Ms")})}
        gw.stop()
    finally:
        pkg["journal"].reset_journals()
    out["tree"] = tree(ws)
    out["log"] = [m for _, m in log.records]
    return out


def stream_ops(seed: int, tenants: int, n: int = 90,
               fold_safe: bool = True) -> list:
    """A seeded op stream over ``tenants`` workspaces. ``fold_safe`` keeps
    only messages without a fold-unsafe character: on the others JAX's
    compiled path is the one at fault under Python 3.12
    (``tests/test_torch_cortex.py``)."""
    rng = random.Random(f"cortex-plugin:{seed}")

    def message() -> str:
        while True:
            text = random_message(rng)
            if not fold_safe or port_patterns.fold_lower(text) is not None:
                return text

    ops = []
    for _ in range(n):
        ctx = {"agent_id": "main", "t": f"t{rng.randrange(tenants)}",
               "session_key": f"agent:main:{rng.randrange(2)}"}
        r = rng.random()
        if r < 0.45:
            ops.append(("in", message(), ctx))
        elif r < 0.65:
            ops.append(("out", message(), ctx))
        elif r < 0.7:
            ops.append(("end", message(), ctx))
        elif r < 0.77:
            ops.append(("start", None, ctx))
        elif r < 0.82:
            ops.append(("compact", message(), ctx))
        elif r < 0.85:
            ops.append(("status", None, ctx))
        else:
            ops.append(("advance", rng.choice([30.0, 3600.0, 30_000.0,
                                               200_000.0]), ctx))
    return ops


def both(tmp_path, config, ops, **kw):
    return (run_stream(PORT, tmp_path / "port", config, ops, **kw),
            run_stream(JAX, tmp_path / "jax", config, ops, **kw))


def assert_equal(got: dict, want: dict) -> None:
    for i, (g, w) in enumerate(zip(got["results"], want["results"])):
        assert g == w, i
    for key in ("status", "safety", "lifecycle", "log"):
        assert got[key] == want[key], key
    assert sorted(got["tree"]) == sorted(want["tree"])
    for name in want["tree"]:
        assert got["tree"][name] == want["tree"][name], name


# ── the plugin ───────────────────────────────────────────────────────


def test_manifest_and_defaults_are_jax_s():
    assert port_plugin_mod.DEFAULTS == jax_plugin_mod.DEFAULTS
    assert dataclasses.asdict(port_plugin_mod.MANIFEST) == \
        dataclasses.asdict(jax_plugin_mod.MANIFEST)
    assert port_demo.SCRIPT == jax_demo.SCRIPT


@pytest.mark.parametrize("storage", sorted(STORAGE))
def test_demo_script_through_both_gateways(tmp_path, openclaw_home, storage):
    ctx = {"agent_id": "demo", "session_key": "agent:demo", "t": "demo"}
    ops = [("in" if sender == "user" else "out", message, ctx)
           for sender, message in jax_demo.SCRIPT]
    ops += [("status", None, ctx),
            ("compact", jax_demo.SCRIPT[-1][1], ctx), ("start", None, ctx)]
    got, want = both(tmp_path, {"languages": "both",
                                "storage": STORAGE[storage]}, ops)
    assert_equal(got, want)
    boot = want["results"][-1]
    assert any(isinstance(r, dict) and "quarterly infrastructure review"
               in r.get("prepend_context", "") for r in boot)


@pytest.mark.parametrize("storage,compiled", [
    *((name, True) for name in sorted(STORAGE)), ("journal+lifecycle", False)])
def test_seeded_multi_tenant_stream_through_both_gateways(
        tmp_path, openclaw_home, storage, compiled):
    """Compiled patterns on fold-safe messages; the interpreter path
    (``compiledPatterns: false``) on every message."""
    config = {"languages": "all", "storage": STORAGE[storage],
              "compiledPatterns": compiled,
              "customPatterns": {"decision": [r"(dup)\1ed", r"(?:x+)+ shipped",
                                              r"ship it:\s*\w+"],
                                 "mode": "extend"}}
    got, want = both(tmp_path, config,
                     stream_ops(7, tenants=5, fold_safe=compiled))
    assert_equal(got, want)
    assert want["safety"]  # the nested-quantifier custom pattern
    tenants = {name.split("/")[0] for name in want["tree"]}
    assert len(tenants) == 5
    if want["lifecycle"] is not None:
        assert want["lifecycle"]["evictions"] > 0
        assert want["lifecycle"]["wakes"] > 0


def test_enhancer_errors_through_both_gateways(tmp_path, openclaw_home):
    """A plain error from the enhancer's ``call_llm`` is logged and the
    trackers fall back to regex on both sides: equal files."""
    def failing(prompt):
        raise RuntimeError("enhancer endpoint down")

    config = {"llmEnhance": {"enabled": True, "batchSize": 2}}
    got, want = both(tmp_path, config, stream_ops(2, tenants=2, n=40),
                     call_llm=failing)
    assert_equal(got, want)
    assert any("regex-only fallback" in m for m in want["log"])
    assert any(name.endswith("threads.json") for name in want["tree"])


def test_a_device_error_leaves_message_received(tmp_path, openclaw_home):
    """The deviation: an error of the device from the enhancer propagates
    out of the port's ``message_received``, where JAX logs it and keeps
    ingesting by regex."""
    def no_card(prompt):
        raise DeviceError("device cuda requested but no CUDA device")

    config = {"llmEnhance": {"enabled": True, "batchSize": 1}}
    ctx = {"agent_id": "main", "session_key": "agent:main",
           "workspace": str(tmp_path / "t")}
    gw, _, _ = cortex_gateway(PORT, tmp_path / "port", config,
                              FakeClock(START), no_card)
    with pytest.raises(DeviceError):
        gw.message_received("we decided to ship the rollout", ctx)
    gw.stop()
    port_journal.reset_journals()
    gw, plugin, log = cortex_gateway(JAX, tmp_path / "jax", config,
                                     FakeClock(START), no_card)
    assert gw.message_received("we decided to ship the rollout", ctx) == []
    assert plugin.trackers(ctx).decisions.decisions
    gw.stop()
    jax_journal.reset_journals()


def test_trace_analyzer_needs_the_card_unless_told(tmp_path, openclaw_home,
                                                   monkeypatch):
    """With ``traceAnalyzer.enabled`` the plugin builds its analyzer on
    ``device`` at ``register``: no card and no ``device="cpu"`` raises at
    ``gw.load``; JAX's plugin has no device and loads."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = {"traceAnalyzer": {"enabled": True}}
    gw = port_core.Gateway(config={"workspace": str(tmp_path)},
                           logger=port_api.list_logger())
    with pytest.raises(DeviceError, match="no CUDA device"):
        gw.load(CortexPlugin(workspace=str(tmp_path), wall_timers=False),
                plugin_config=cfg)
    assert "cortex" not in gw.plugins
    gw.load(CortexPlugin(workspace=str(tmp_path), wall_timers=False,
                         device="cpu"), plugin_config=cfg)
    assert "trace-analyze" in gw.commands
    jgw = jax_core.Gateway(config={"workspace": str(tmp_path)},
                           logger=jax_api.list_logger())
    jgw.load(JaxCortex(workspace=str(tmp_path), wall_timers=False),
             plugin_config=cfg)
    assert "trace-analyze" in jgw.commands


def test_trace_analyze_through_the_plugin_writes_jax_s_files(
        tmp_path, openclaw_home, one_torch_thread):
    raws = chip_smoke.trace_corpus(0, 6, 0, 1, chip_smoke.TRACE_BASE_TS,
                                   chip_smoke.TRACE_SEED)
    config = {"classify": {"enabled": False}, "cluster": {"incremental": True}}
    out = {}
    for name, pkg, source in (("port", PORT, MemoryTraceSource),
                              ("jax", JAX, JaxTraceSource)):
        ws = tmp_path / name
        clock = lambda: chip_smoke.TRACE_CLOCK  # noqa: E731
        gw, _, _ = cortex_gateway(pkg, ws, {"traceAnalyzer": {
            "enabled": True, **config}}, clock, trace_source=source(raws))
        text = gw.command("/trace-analyze")["text"]
        gw.stop()
        pkg["journal"].reset_journals()
        out[name] = (text.splitlines()[0].split(" in ")[0],
                     chip_smoke.trace_files(str(ws)))
    assert out["port"] == out["jax"]
    assert out["port"][1]["report"]["runStats"]["signals"] > 0


# ── the worker profile ───────────────────────────────────────────────


def worker_configs(tmp_path, monkeypatch) -> list:
    """``(plugin id, plugin_config)`` of each plugin JAX's
    ``build_worker_gateway`` loads."""
    loaded = []
    real = jax_core.Gateway.load

    def record(self, plugin, plugin_config=None, logger=None):
        loaded.append((plugin.id, json.loads(json.dumps(plugin_config))))
        return real(self, plugin, plugin_config, logger)

    monkeypatch.setattr(jax_core.Gateway, "load", record)
    jax_ids._ID_RNG.seed(9)
    gw, _, _ = jax_worker.build_worker_gateway(
        tmp_path / "jax", "w0", clock=FakeClock(START), wall_timers=False,
        logger=jax_api.list_logger())
    monkeypatch.setattr(jax_core.Gateway, "load", real)
    return gw, loaded


WORKER_OPS = [("msg_in", "let's talk about the payment gateway hardening"),
              ("msg_out", "I'll draft the migration plan tonight"),
              ("tool_ok", "docs/readme.md"), ("tool_denied", "config/.env"),
              ("tool_secret", "export API_KEY=sk-" + "k" * 24),
              ("msg_in", "we decided to use postgres because it is simple"),
              ("tool_denied", "secrets/prod-credentials.json")]


def test_worker_profile_configs_load_into_the_port(tmp_path, openclaw_home,
                                                   monkeypatch):
    jgw, loaded = worker_configs(tmp_path, monkeypatch)
    assert [pid for pid, _ in loaded] == ["governance", "cortex"]
    root = tmp_path / "port"
    root.mkdir()
    port_ids._ID_RNG.seed(9)
    clock = FakeClock(START)
    gw = port_core.Gateway(config={"workspace": str(root),
                                   "agents": [{"id": "w0"}],
                                   "cluster": {"workerPrefix": "w0:"}},
                           logger=port_api.list_logger(), clock=clock)
    plugins = {"governance": GovernancePlugin(workspace=str(root),
                                              clock=clock),
               "cortex": CortexPlugin(wall_timers=False, clock=clock,
                                      device="cpu")}
    for pid, cfg in loaded:
        gw.load(plugins[pid], plugin_config=cfg)
    gw.start()
    results = {}
    for name, g, ws in (("port", gw, root), ("jax", jgw, tmp_path / "jax")):
        out = []
        for i, (kind, content) in enumerate(WORKER_OPS):
            ctx = {"agent_id": "w0", "session_key": f"agent:w0:t{i % 2}",
                   "workspace": str(ws / "tenants" / f"t{i % 2}")}
            out.append(jax_worker.dispatch_op(g, kind, content, ctx))
        hooks = {hook: [(r.plugin_id, r.priority, r.never_shed)
                        for r in g.bus.handlers_for(hook)]
                 for hook in jax_api.KNOWN_HOOKS}
        g.stop()
        results[name] = (out, hooks, sorted(g.commands), sorted(g.methods),
                         {k: tree(ws / "tenants" / k)
                          for k in ("t0", "t1")})
    port_journal.reset_journals()
    jax_journal.reset_journals()
    assert results["port"] == results["jax"]
    out = results["port"][0]
    assert out[2] == {"blocked": False} and out[3] == {"blocked": True}
    assert out[4] == {"redacted": True}
    assert plugins["governance"].redaction_state is not None
    assert plugins["cortex"].lifecycle is not None
