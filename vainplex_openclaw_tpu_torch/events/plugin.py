"""The event-store plugin: wires HOOK_MAPPINGS onto the gateway bus.

Reference: nats-eventstore/index.ts:20-81 (service + /eventstatus command +
``eventstore.status`` gateway method) and src/hooks.ts (table-driven handler
registration, fire-and-forget publishing).

The port's copy of ``vainplex_openclaw_tpu/events/plugin.py`` over the
port's envelope, subjects and transports, with JAX's ``DEFAULTS``,
``MANIFEST``, handlers and priorities. One deviation: with
``transport: "nats"`` and no ``nats`` client package JAX logs a warning
and falls back to the in-memory transport; the port's
``create_nats_transport`` raises ``ImportError``, so ``gw.load`` fails
rather than record events where nobody expects them.
"""

from __future__ import annotations

import time
from typing import Callable

from ..core.api import PluginCommand, PluginService
from ..config.loader import load_plugin_config
from ..config.manifest import PluginManifest
from ..storage.journal import get_journal, journal_settings
from .envelope import build_envelope
from .mappings import EXTRA_EMITTERS, HOOK_MAPPINGS, ExtraEmitter, HookMapping
from .subjects import build_subject
from .transport import FileTransport, MemoryTransport, create_nats_transport

DEFAULTS = {
    "enabled": True,
    "transport": "memory",  # memory | file | nats
    "prefix": "claw",
    "stream": "CLAW_EVENTS",
    "natsUrl": "nats://localhost:4222",
    "fileRoot": None,  # required for transport=file
    "retention": {"maxMsgs": 100_000, "maxBytes": 256 * 1024 * 1024, "maxAgeS": None},
    "publishPriority": 10_000,  # after every other plugin has seen the hook
    # storage.journal: file-transport publishes append to the
    # shared group-commit workspace journal (compacted into the daily files
    # on read barriers); false restores the per-event day-file append.
    "storage": {"journal": True},
}

MANIFEST = PluginManifest(
    id="eventstore",
    description="Durable event log: canonical envelope, hook→event mapping, "
                "memory/file/NATS transports",
    config_schema={
        "type": "object",
        "properties": {
            "enabled": {"type": "boolean"},
            "transport": {"type": "string", "enum": ["memory", "file", "nats"]},
            "prefix": {"type": "string"},
            "stream": {"type": "string"},
            "natsUrl": {"type": "string"},
            "fileRoot": {"type": ["string", "null"]},
            "retention": {"type": "object", "properties": {
                "maxMsgs": {"type": "integer", "minimum": 1},
                "maxBytes": {"type": "integer", "minimum": 1},
                "maxAgeS": {"type": ["number", "null"]}}},
            "publishPriority": {"type": "integer"},
            "storage": {"type": "object", "properties": {
                "journal": {"type": ["boolean", "object"]}}},
        },
    },
    commands=("eventstatus",),
    gateway_methods=("eventstore.status",),
    hooks=tuple(sorted({m.hook_name for m in HOOK_MAPPINGS}
                       | {e.hook_name for e in EXTRA_EMITTERS})),
)


class EventStorePlugin:
    id = "eventstore"
    manifest = MANIFEST

    def __init__(self, transport=None, clock: Callable[[], float] = time.time):
        self._injected_transport = transport
        self.transport = None
        self.clock = clock
        self.config: dict = {}

    def register(self, api) -> None:
        self.config = load_plugin_config(self.id, api.plugin_config, defaults=DEFAULTS,
                                         logger=api.logger)
        if not self.config.get("enabled", True):
            api.logger.info("disabled via config")
            return

        self.transport = self._injected_transport or self._build_transport(api)
        journal = getattr(self.transport, "journal", None)
        if journal is not None and hasattr(api, "register_journal"):
            workspace = api.config.get("workspace") or "."
            api.register_journal(f"journal:{workspace}", journal)

        api.register_service(PluginService(id="eventstore", start=self._start, stop=self._stop))
        api.register_command(PluginCommand(name="eventstatus", description="Event store status",
                                           handler=lambda ctx: {"text": self.status_text()}))
        api.register_gateway_method("eventstore.status", self.status)

        default_prio = int(self.config.get("publishPriority", 10_000))
        for mapping in HOOK_MAPPINGS:
            prio = mapping.priority if mapping.priority is not None else default_prio
            api.on(mapping.hook_name, self._make_handler(mapping), priority=prio)
        for extra in EXTRA_EMITTERS:
            api.on(extra.hook_name, self._make_extra_handler(extra), priority=default_prio + 1)

    def _build_transport(self, api):
        logger = api.logger
        kind = self.config.get("transport", "memory")
        r = self.config.get("retention", {})
        if kind == "nats":
            # raises without the client package: no fallback to memory
            return create_nats_transport(
                self.config.get("natsUrl"), stream=self.config.get("stream"),
                prefix=self.config.get("prefix"), logger=logger,
                retention={"max_msgs": r.get("maxMsgs"), "max_bytes": r.get("maxBytes"),
                           "max_age_s": r.get("maxAgeS")})
        if kind == "file" and self.config.get("fileRoot"):
            # Shared per-workspace group-commit journal; injected
            # transports are never wrapped — their owner decides. wall=True:
            # acked events must reach the wal within windowMs even on a
            # quiet store (a plugin-built transport is production, not a
            # seeded chaos rig — those inject their own journal).
            js = journal_settings(self.config)
            journal = (get_journal(api.config.get("workspace") or ".", js,
                                   clock=self.clock, wall=True, logger=logger)
                       if js["enabled"] else None)
            return FileTransport(self.config["fileRoot"], clock=self.clock,
                                 journal=journal)
        return MemoryTransport(
            max_msgs=r.get("maxMsgs", 100_000),
            max_bytes=r.get("maxBytes", 256 * 1024 * 1024),
            max_age_s=r.get("maxAgeS"),
            clock=self.clock,
        )

    def _start(self, ctx) -> None:
        connect = getattr(self.transport, "connect", None)
        if connect is not None:
            connect()

    def _stop(self, ctx) -> None:
        if self.transport is not None:
            self.transport.drain()

    def _emit(self, canonical_type, mapping_attrs: dict, event: dict, ctx: dict) -> None:
        if self.transport is None:
            return
        payload = mapping_attrs["mapper"](event, ctx)
        envelope = build_envelope(
            canonical_type, payload, ctx,
            plugin=self.id,
            legacy_type=mapping_attrs.get("legacy_type"),
            visibility=mapping_attrs.get("visibility", "internal"),
            redaction=mapping_attrs.get("redaction"),
            system_event=mapping_attrs.get("system_event", False),
            now_ms=self.clock() * 1000.0,
        )
        subject = build_subject(self.config.get("prefix", "claw"), envelope.agent, envelope.type)
        self.transport.publish(subject, envelope)  # fire-and-forget; failures counted

    def _make_handler(self, mapping: HookMapping):
        attrs = {
            "mapper": mapping.mapper, "legacy_type": mapping.legacy_type,
            "visibility": mapping.visibility, "redaction": mapping.redaction,
            "system_event": mapping.system_event,
        }

        def handler(event: dict, ctx: dict) -> None:
            et = mapping.event_type
            canonical = et(event, ctx) if callable(et) else et
            self._emit(canonical, attrs, event, ctx)
            return None

        return handler

    def _make_extra_handler(self, extra: ExtraEmitter):
        def handler(event: dict, ctx: dict) -> None:
            if not extra.condition(event):
                return None
            et = extra.event_type
            canonical = et(event, ctx) if callable(et) else et
            self._emit(canonical, {
                "mapper": extra.mapper, "legacy_type": extra.legacy_type,
                "visibility": extra.visibility, "redaction": None, "system_event": False,
            }, event, ctx)
            return None

        return handler

    def status(self) -> dict:
        t = self.transport
        if t is None:
            return {"enabled": False}
        out = {"enabled": True, "healthy": t.healthy(),
               "transport": type(t).__name__}
        # Full resilience counter surface: outbox/reconnect state
        # from the NATS adapter, torn-tail/quarantine counts from the file
        # log, plus the base published/failure counters every transport has.
        stats_dict = getattr(t, "stats_dict", None)
        out.update(stats_dict() if stats_dict is not None else t.stats())
        return out

    def status_text(self) -> str:
        s = self.status()
        if not s.get("enabled"):
            return "event store: disabled"
        return (f"event store: {s['transport']} healthy={s['healthy']} "
                f"published={s['published']} failures={s['publish_failures']}")
