"""The port's ``EventStorePlugin`` and hook mappings against the JAX
package's, each through its own ``Gateway`` on a virtual clock.

- One case per ``HOOK_MAPPINGS`` row (``after_tool_call`` with and without
  an error) and per ``EXTRA_EMITTERS`` entry: the hook fired with the same
  event and context publishes the same subjects and envelopes (a context
  without a stable id gets a ``uuid4`` event id in both packages, compared
  as such).
- A seeded stream of hooks on the file transport, with the workspace
  journal and without: the day files byte-equal; ``/eventstatus``,
  ``eventstore.status``, the manifest, defaults and hook priorities equal.
- ``transport: "nats"``: with the scripted client (``tests/fake_nats.py``)
  both build the JetStream adapter and publish the same messages; without
  one JAX falls back to the memory transport and the port raises at
  ``gw.load`` (a deviation).
"""

from __future__ import annotations

import itertools
import json
import random
import types
import uuid

import pytest

from fake_nats import FakeJetStreamState, install
from helpers import FakeClock
from vainplex_openclaw_tpu import core as jax_core
from vainplex_openclaw_tpu.core import api as jax_api
from vainplex_openclaw_tpu.events import EventStorePlugin as JaxEvents
from vainplex_openclaw_tpu.events import envelope as jax_envelope
from vainplex_openclaw_tpu.events import mappings as jax_mappings
from vainplex_openclaw_tpu.events import plugin as jax_plugin
from vainplex_openclaw_tpu.events.transport import (
    MemoryTransport as JaxMemory)
from vainplex_openclaw_tpu.storage import journal as jax_journal
from vainplex_openclaw_tpu_torch import core as port_core
from vainplex_openclaw_tpu_torch.core import api as port_api
from vainplex_openclaw_tpu_torch.events import EventStorePlugin
from vainplex_openclaw_tpu_torch.events import envelope as port_envelope
from vainplex_openclaw_tpu_torch.events import mappings as port_mappings
from vainplex_openclaw_tpu_torch.events import plugin as port_plugin
from vainplex_openclaw_tpu_torch.events.transport import MemoryTransport
from vainplex_openclaw_tpu_torch.storage import journal as port_journal

JAX = dict(core=jax_core, api=jax_api, events=JaxEvents, memory=JaxMemory,
           journal=jax_journal, envelope=jax_envelope)
PORT = dict(core=port_core, api=port_api, events=EventStorePlugin,
            memory=MemoryTransport, journal=port_journal,
            envelope=port_envelope)
START = 1_753_747_200.0


@pytest.fixture(autouse=True)
def fresh_journals():
    for pkg in (JAX, PORT):
        pkg["journal"].reset_journals()
    yield
    for pkg in (JAX, PORT):
        pkg["journal"].reset_journals()


def events_gateway(pkg, ws, config: dict, clock, transport=None):
    log = pkg["api"].list_logger()
    gw = pkg["core"].Gateway(config={"workspace": str(ws)}, logger=log,
                             clock=clock)
    plugin = pkg["events"](transport=transport, clock=clock)
    gw.load(plugin, plugin_config=config, logger=log)
    gw.start()
    return gw, plugin, log


def published(transport) -> list:
    out = []
    for subject, event, _ in list(transport._events):
        env = event.to_dict()
        if not str(env["id"]).startswith("evt-"):
            env["id"] = "uuid"
        out.append([subject, env])
    return out


_EVENT = {"from": "user:7", "to": "chan:3", "content": "hello there",
          "metadata": {"k": 1}, "tool_name": "exec",
          "params": {"command": "ls -la"}, "result": "x" * 37,
          "prompt": "p" * 120, "completion": "c" * 40, "model": "tiny",
          "redaction_applied": True, "session_key": "s9"}
_CTX = {"agent_id": "main", "session_key": "agent:main:s1",
        "channel_id": "slack", "run_id": "run-4", "sender_id": "u1"}
CASES = ([(m.hook_name, {}) for m in jax_mappings.HOOK_MAPPINGS]
         + [("after_tool_call", {"error": "exit 2"}),
            ("agent_end", {"error": "boom"})])


@pytest.mark.parametrize("hook,extra", CASES,
                         ids=[f"{h}{'-' + next(iter(e)) if e else ''}"
                              for h, e in CASES])
@pytest.mark.parametrize("ids", ["stable", "uuid"])
def test_each_mapping_publishes_jax_s_envelopes(tmp_path, hook, extra, ids):
    event = {**_EVENT, **extra}
    ctx = dict(_CTX, **({"message_id": "m-1", "tool_call_id": "t-1"}
                        if ids == "stable" else {}))
    if ids == "uuid":
        ctx.pop("run_id")
    got = {}
    for name, pkg in (("port", PORT), ("jax", JAX)):
        clock = FakeClock(START)
        transport = pkg["memory"](clock=clock)
        gw, _, _ = events_gateway(pkg, tmp_path / name, {}, clock, transport)
        before = len(transport._events)
        clock.advance(3.5)
        gw.fire(hook, dict(event), dict(ctx))
        got[name] = published(transport)[before:]
    assert got["port"] == got["jax"]
    assert got["port"], hook


def test_tables_defaults_and_priorities_are_jax_s(tmp_path):
    def rows(mod):
        return [(m.hook_name, m.event_type if isinstance(m.event_type, str)
                 else "callable", m.legacy_type, m.visibility, m.redaction,
                 m.system_event, m.priority) for m in mod.HOOK_MAPPINGS] + \
            [(e.hook_name, e.event_type, e.legacy_type, e.visibility)
             for e in mod.EXTRA_EMITTERS]

    assert rows(port_mappings) == rows(jax_mappings)
    assert len(port_mappings.HOOK_MAPPINGS) == 15
    assert len(port_mappings.EXTRA_EMITTERS) == 1
    assert port_plugin.DEFAULTS == jax_plugin.DEFAULTS
    assert port_plugin.MANIFEST.config_schema == \
        jax_plugin.MANIFEST.config_schema
    assert port_plugin.MANIFEST.hooks == jax_plugin.MANIFEST.hooks
    regs = {}
    for name, pkg in (("port", PORT), ("jax", JAX)):
        gw, plugin, _ = events_gateway(pkg, tmp_path / name, {},
                                       FakeClock(START))
        regs[name] = (sorted((hook, r.priority) for hook, rs in
                             gw.bus._handlers.items() for r in rs),
                      sorted(gw.commands), sorted(gw.methods),
                      gw.command("/eventstatus")["text"],
                      gw.call_method("eventstore.status"))
        gw.stop()
    assert regs["port"] == regs["jax"]


def hook_stream(gw, clock, seed: int, n: int) -> None:
    rng = random.Random(seed)
    hooks = [m.hook_name for m in jax_mappings.HOOK_MAPPINGS]
    for i in range(n):
        clock.advance(rng.choice((0.5, 60.0, 7200.0)))
        event = dict(_EVENT, content=f"msg {i} {rng.random():.6f}",
                     error=rng.choice((None, "exit 1")))
        ctx = dict(_CTX, message_id=f"m{i}", tool_call_id=f"t{i}",
                   agent_id=rng.choice(("main", "ops")))
        gw.fire(rng.choice(hooks), event, ctx)


def tree(root) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def seeded_uuids(monkeypatch, pkg) -> None:
    """The envelope module's ``uuid4`` fallback drawn from a counter, so
    two runs write the same bytes."""
    count = itertools.count()
    monkeypatch.setattr(pkg["envelope"], "uuid", types.SimpleNamespace(
        uuid4=lambda: uuid.UUID(int=next(count))))


@pytest.mark.parametrize("journal", [True, False])
def test_file_transport_day_files_equal_jax_s(tmp_path, monkeypatch,
                                              journal):
    files = {}
    for name, pkg in (("port", PORT), ("jax", JAX)):
        seeded_uuids(monkeypatch, pkg)
        clock = FakeClock(START)
        root = tmp_path / name / "events"
        gw, plugin, _ = events_gateway(
            pkg, tmp_path / name, {"transport": "file",
                                   "fileRoot": str(root),
                                   "storage": {"journal": journal}}, clock)
        hook_stream(gw, clock, 5, 120)
        status = plugin.status()
        gw.stop()
        files[name] = (tree(root), {k: v for k, v in status.items()
                                    if k != "transport"})
    assert files["port"] == files["jax"]
    assert len(files["port"][0]) > 3


def test_nats_transport_through_the_scripted_client(tmp_path):
    state = FakeJetStreamState()
    uninstall = install(state)
    try:
        got = {}
        for name, pkg in (("port", PORT), ("jax", JAX)):
            clock = FakeClock(START)
            gw, plugin, _ = events_gateway(
                pkg, tmp_path / name,
                {"transport": "nats", "natsUrl": "nats://u:p@broker:4222",
                 "stream": f"S_{name}", "prefix": f"p{name}",
                 "retention": {"maxMsgs": 50}}, clock)
            assert type(plugin.transport).__name__ == "NatsTransport"
            hook_stream(gw, clock, 9, 40)
            status = plugin.status()
            gw.stop()
            msgs = []
            for seq, subject, payload in state.messages[f"S_{name}"]:
                env = json.loads(payload.decode())
                if not env["id"].startswith("evt-"):
                    env["id"] = "uuid"
                msgs.append((seq, subject.split(".", 1)[1], env))
            got[name] = (msgs, {k: v for k, v in status.items()
                                if k not in ("transport", "breaker")},
                         state.streams[f"S_{name}"]["max_msgs"])
        assert got["port"] == got["jax"]
        assert len(got["port"][0]) == 42  # gateway start, 40 hooks, stop
    finally:
        uninstall()


def test_nats_without_a_client_raises_where_jax_falls_back(tmp_path):
    config = {"transport": "nats"}
    with pytest.raises(ImportError, match="'nats' client package"):
        events_gateway(PORT, tmp_path / "port", config, FakeClock(START))
    gw, plugin, log = events_gateway(JAX, tmp_path / "jax", config,
                                     FakeClock(START))
    assert type(plugin.transport).__name__ == "MemoryTransport"
    assert any("falling back" in m for m in log.messages())
    gw.stop()
