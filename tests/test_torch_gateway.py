"""The port's ``Gateway`` and hook bus against the JAX package's.

One scripted stub plugin, built over each package's own plugin API types,
is loaded into each package's ``Gateway`` on a virtual clock, and one
seeded script of hook fires runs on both: tool calls with a parameter
rewrite and a short-circuiting block, outbound messages with content
mutation and a blocking fallback, sheddable ingest under admission
control, sync and async handlers (and a sync handler that hands back a
coroutine), a handler that keeps failing until its breaker opens and a
probe closes it. Every result, every ``get_status()``, the plugin's view
``get_gateway_status()`` and the log lines must be equal. The port's own
``SitrepPlugin`` and ``register_trace_analyzer`` load into the port's
``Gateway``.
"""

from __future__ import annotations

import asyncio
import dataclasses
import random

import pytest

from helpers import FakeClock
from vainplex_openclaw_tpu import core as jax_core
from vainplex_openclaw_tpu.core import api as jax_api
from vainplex_openclaw_tpu_torch import core as port_core
from vainplex_openclaw_tpu_torch.core import api as port_api
from vainplex_openclaw_tpu_torch.device import DeviceError
from vainplex_openclaw_tpu_torch.resilience import policy as port_policy

CONFIG = {"workspace": "unused",
          "resilience": {"pluginBreaker": {"failureThreshold": 3,
                                           "failureRate": 0.5,
                                           "windowS": 60.0,
                                           "recoveryS": 10.0},
                         "admission": {"enabled": True, "highWatermark": 2,
                                       "shedAllFactor": 2.0,
                                       "windowOps": 16}}}


class StubPlugin:
    """Handlers on every kind of hook, over the given package's API."""

    id = "stub"

    def __init__(self, api_mod):
        self.api_mod = api_mod
        self.seen: list = []
        self.flaky_ok = False

    def register(self, api):
        self.api = api
        on = api.on
        on("before_tool_call", self.redact, priority=950)
        on("before_tool_call", self.deny_rm, priority=1000)
        on("before_tool_call", self.late, priority=1100)
        on("after_tool_call", self.flaky, priority=100)
        on("tool_result_persist", self.scrub, priority=100)
        on("message_sending", self.shout, priority=10)
        on("message_sending", self.block_secret, priority=20)
        on("message_sending", self.late, priority=30)
        on("before_message_write", self.gate, priority=1000)
        on("message_received", self.observe, priority=100)
        on("message_received", self.critical, priority=200, never_shed=True)
        on("session_start", self.async_start, priority=1)
        on("agent_end", lambda e, c: self.async_start(e, c), priority=5)
        on("before_agent_start", lambda e, c: {"prepend_context": "ctx"},
           priority=5)
        api.register_command(self.api_mod.PluginCommand(
            name="stub", description="stub dashboard",
            handler=lambda ctx: {"text": f"seen={len(self.seen)} "
                                         f"args={ctx.get('args')}"}))
        api.register_gateway_method("stub.seen", lambda: list(self.seen))
        api.register_service(self.api_mod.PluginService(
            id="stub-svc", start=lambda gw: self.seen.append("start"),
            stop=lambda gw: self.seen.append("stop")))

    def redact(self, event, ctx):
        params = dict(event["params"])
        if "token" in params:
            params["token"] = "[redacted]"
            return {"params": params}
        return None

    def deny_rm(self, event, ctx):
        cmd = str(event["params"].get("command", ""))
        if "rm -rf" in cmd:
            return {"block": True, "block_reason": f"denied: {cmd}"}
        return None

    def late(self, event, ctx):
        self.seen.append(("late", ctx.get("tool_name")))
        return None

    def flaky(self, event, ctx):
        if not self.flaky_ok:
            raise RuntimeError(f"flaky handler for {event['tool_name']}")
        self.seen.append(("after", event["tool_name"]))
        return None

    def scrub(self, event, ctx):
        return {"result": str(event["result"]).replace("secret", "***")}

    def shout(self, event, ctx):
        if "!" in event["content"]:
            return {"content": event["content"].upper()}
        return None

    def block_secret(self, event, ctx):
        if "SK-" in event["content"].upper():
            return {"block": True, "block_reason": "secret in message",
                    "fallback_message": "[withheld]"}
        return None

    def gate(self, event, ctx):
        if "forbidden" in event["content"]:
            return {"block": True, "blockReason": "gate"}
        return None

    def observe(self, event, ctx):
        self.seen.append(("observe", event["content"]))
        return {"observed": len(event["content"])}

    def critical(self, event, ctx):
        return {"critical": event["content"][:4]}

    async def async_start(self, event, ctx):
        await asyncio.sleep(0)
        self.seen.append(("async", ctx.get("session_key")))
        return {"started": ctx.get("session_key")}


def script(seed: int, n: int = 120) -> list:
    rng = random.Random(seed)
    cmds = ("ls -la", "rm -rf /tmp/x", "cat notes.txt", "echo hi")
    texts = ("hello there", "ship it!", "key sk-abc123 inside", "all good",
             "this is forbidden", "status!")
    ops = []
    for i in range(n):
        r = rng.random()
        sess = {"session_key": f"s{rng.randrange(3)}", "agent_id": "main",
                "workspace": f"t{rng.randrange(2)}"}
        if r < 0.25:
            params = {"command": rng.choice(cmds)}
            if rng.random() < 0.4:
                params["token"] = f"tok{i}"
            ops.append(("run_tool", "exec", params, sess))
        elif r < 0.40:
            ops.append(("message_sending", rng.choice(texts), sess))
        elif r < 0.50:
            ops.append(("before_message_write", rng.choice(texts), sess))
        elif r < 0.68:
            ops.append(("message_received", rng.choice(texts), sess))
        elif r < 0.74:
            ops.append(("depth", rng.choice((0, 3, 5))))
        elif r < 0.77:
            ops.append(("session_start", sess))
        elif r < 0.80:
            ops.append(("agent_end", sess))
        elif r < 0.82:
            ops.append(("before_agent_start", sess))
        elif r < 0.86:
            ops.append(("advance", rng.choice((1.0, 5.0, 11.0))))
        elif r < 0.88:
            ops.append(("heal",))
        elif r < 0.94:
            ops.append(("command", "/stub", f"a{i}"))
        else:
            ops.append(("status",))
    # a fixed tail: a shed-all depth, then the breaker's whole cycle
    tail_sess = {"session_key": "s0", "agent_id": "main", "workspace": "t0"}
    ops += [("depth", 5), ("message_received", "shed me", tail_sess),
            ("depth", 0), ("heal",), ("heal",)]
    ops += [("run_tool", "exec", {"command": "ls"}, tail_sess)] * 4
    ops += [("status",), ("advance", 11.0), ("heal",),
            ("run_tool", "exec", {"command": "ls"}, tail_sess), ("status",)]
    return ops


def normalize(obj):
    if dataclasses.is_dataclass(obj):
        return dataclasses.asdict(obj)
    if isinstance(obj, tuple):
        return [normalize(x) for x in obj]
    return obj


def drive(core_mod, api_mod, ops):
    clock = FakeClock()
    logger = api_mod.list_logger()
    gw = core_mod.Gateway(config=CONFIG, logger=logger, clock=clock)
    plugin = StubPlugin(api_mod)
    api = gw.load(plugin)
    gw.start()
    out = []
    for op in ops:
        kind = op[0]
        if kind == "run_tool":
            res = gw.run_tool(op[1], op[2], lambda p: f"ran {p} secret",
                              dict(op[3]))
        elif kind in ("message_sending", "before_message_write",
                      "message_received"):
            res = getattr(gw, kind)(op[1], dict(op[2]))
        elif kind == "depth":
            gw.admission.note_queue_depth(op[1])
            res = None
        elif kind in ("session_start", "agent_end", "before_agent_start"):
            res = getattr(gw, kind)(dict(op[1]))
        elif kind == "advance":
            res = clock.advance(op[1])
        elif kind == "heal":
            plugin.flaky_ok = not plugin.flaky_ok
            res = plugin.flaky_ok
        elif kind == "command":
            res = gw.command(op[1], args=op[2])
        else:
            res = (gw.get_status(), api.get_gateway_status())
        out.append((op, normalize(res)))
    gw.stop()
    out.append(("final", gw.get_status(), gw.call_method("stub.seen"),
                sorted(gw.commands), sorted(gw.methods)))
    return out, list(logger.records)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_scripted_stub_matches_jax_gateway(seed):
    ops = script(seed)
    want, want_log = drive(jax_core, jax_api, ops)
    got, got_log = drive(port_core, port_api, ops)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w
    assert got_log == want_log
    # the script reached every mechanism it is meant to
    final = want[-1][1]
    assert final["hooks"]["message_received"]["skipped"] > 0  # shed
    assert final["admission"]["shed"] > 0
    assert final["hooks"]["after_tool_call"]["errors"] > 0
    assert any("DEGRADED" in m for _, m in want_log)
    assert any(op[0] == "run_tool" and res[0]["blocked"]
               for op, res in want[:-1])
    assert any(op[0] == "message_sending" and res["blocked"]
               and res["fallback_message"] == "[withheld]"
               for op, res in want[:-1])


def test_breaker_opens_skips_and_closes_on_a_probe():
    for core_mod, api_mod in ((jax_core, jax_api), (port_core, port_api)):
        clock = FakeClock()
        gw = core_mod.Gateway(config=CONFIG, logger=api_mod.list_logger(),
                              clock=clock)
        plugin = StubPlugin(api_mod)
        gw.load(plugin)
        for _ in range(3):
            gw.after_tool_call("exec", {})
        st = gw.get_status()
        assert st["degraded"] == ["stub"]
        assert st["breakers"]["stub"]["after_tool_call"]["state"] == "open"
        gw.after_tool_call("exec", {})
        assert gw.get_status()["hooks"]["after_tool_call"]["skipped"] == 1
        clock.advance(10.0)
        plugin.flaky_ok = True
        gw.after_tool_call("exec", {})  # the half-open probe succeeds
        assert gw.get_status()["degraded"] == []


class DeviceFailingPlugin:
    id = "dev"

    def __init__(self, exc):
        self.exc = exc

    def register(self, api):
        def boom(event, ctx):
            raise self.exc

        api.on("message_sending", boom, priority=1)
        api.on("message_received", boom, priority=1)


def test_device_error_propagates_from_the_bus_where_jax_logs_it():
    """JAX's bus logs every handler error and goes on (``api.py:379``,
    ``:458``); the port's lets an error of the device through, counted on
    the hook but not on the plugin's breaker. A plain error is handled
    alike on both sides."""
    for exc in (DeviceError("kernel did not launch"),
                RuntimeError("CUDA error: an illegal memory access")):
        jax_gw = jax_core.Gateway(config=CONFIG,
                                  logger=jax_api.list_logger(),
                                  clock=FakeClock())
        jax_gw.load(DeviceFailingPlugin(exc))
        assert not jax_gw.message_sending("hi", {}).blocked
        port_gw = port_core.Gateway(config=CONFIG,
                                    logger=port_api.list_logger(),
                                    clock=FakeClock())
        port_gw.load(DeviceFailingPlugin(exc))
        for hook in ("message_sending", "message_received"):
            for _ in range(5):
                with pytest.raises(type(exc)):
                    getattr(port_gw, hook)("hi", {})
        st = port_gw.get_status()
        assert st["hooks"]["message_received"]["errors"] == 5
        assert st["degraded"] == [] and st["breakers"] == {}
    plain = RuntimeError("plugin bug")
    outs = []
    for core_mod, api_mod in ((jax_core, jax_api), (port_core, port_api)):
        logger = api_mod.list_logger()
        gw = core_mod.Gateway(config=CONFIG, logger=logger, clock=FakeClock())
        gw.load(DeviceFailingPlugin(plain))
        outs.append(([normalize(gw.message_sending("hi", {}))
                      for _ in range(4)],
                     [gw.message_received("hi", {}) for _ in range(4)],
                     gw.get_status(), logger.records))
    assert outs[0] == outs[1]


def test_a_device_error_hands_back_a_half_open_probe():
    br = port_policy.CircuitBreaker(failure_threshold=1, failure_rate=0.5,
                                    recovery_s=1.0, clock=FakeClock())
    br.record_failure("x")
    br.clock.advance(1.0)
    assert br.allow() and not br.allow()  # the one probe is taken
    br.release()
    assert br.state == "half-open" and br.allow()


def test_port_plugins_load_into_the_port_gateway(tmp_path, openclaw_home):
    from vainplex_openclaw_tpu_torch.cortex import trace_analyzer as pta
    from vainplex_openclaw_tpu_torch.cortex.trace_analyzer import \
        analyzer as port_an
    from vainplex_openclaw_tpu_torch.sitrep import SitrepPlugin

    gw = port_core.Gateway(config={"workspace": str(tmp_path)},
                           logger=port_api.list_logger(), clock=FakeClock())
    api = gw.load(SitrepPlugin(workspace=str(tmp_path), wall_timers=False),
                  plugin_config={"intervalMinutes": 0})
    analyzer = pta.TraceAnalyzer({}, tmp_path / "ta", api.logger,
                                 device="cpu")
    port_an.register_trace_analyzer(api, analyzer, wall_timers=False)
    gw.start()
    assert gw.command("/ops")["text"].startswith("🛰 ops: ")
    assert gw.command("/sitrep")["text"]
    assert gw.command("/trace-analyze")["text"].startswith(
        "🔍 trace analysis: 0 events")
    assert sorted(gw.get_status()["plugins"]) == ["sitrep"]
    gw.stop()


def test_api_surface_matches_jax():
    for name in ("NEVER_SHED_HOOKS", "SYNC_ONLY_HOOKS",
                 "ADMISSION_SHEDDABLE_HOOKS", "KNOWN_HOOKS",
                 "PLUGIN_BREAKER_DEFAULTS"):
        assert getattr(port_api, name) == getattr(jax_api, name), name
    for cls in ("PluginCommand", "PluginService", "ListLogger"):
        assert [f.name for f in dataclasses.fields(getattr(port_api, cls))] \
            == [f.name for f in dataclasses.fields(getattr(jax_api, cls))]
    assert sorted(port_core.__all__) == sorted(jax_core.__all__)


def test_a_device_error_on_a_half_open_probe_leaves_the_probe_free():
    """A device error that ends a half-open probe counts neither way: the
    next call probes again instead of being skipped."""

    class Scripted:
        id = "dev"

        def __init__(self):
            self.errors = [RuntimeError("plain")] * 3 + [DeviceError("x")]
            self.calls = 0

        def register(self, api):
            api.on("message_received", self.handle, priority=1)

        def handle(self, event, ctx):
            self.calls += 1
            if self.errors:
                raise self.errors.pop(0)
            return {"ok": True}

    clock = FakeClock()
    gw = port_core.Gateway(config=CONFIG, logger=port_api.list_logger(),
                           clock=clock)
    plugin = Scripted()
    gw.load(plugin)
    for _ in range(3):
        gw.message_received("x", {})
    assert gw.get_status()["degraded"] == ["dev"]
    clock.advance(10.0)
    with pytest.raises(DeviceError):
        gw.message_received("x", {})  # the half-open probe
    assert gw.message_received("x", {}) == [{"ok": True}]
    assert plugin.calls == 5
    st = gw.get_status()
    assert st["degraded"] == [] and st["hooks"]["message_received"] == {
        "fired": 5, "errors": 4, "skipped": 0}
