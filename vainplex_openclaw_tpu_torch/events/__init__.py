"""Event store: envelope taxonomy, hook→event mapping, pluggable transports.

The port's copy of ``vainplex_openclaw_tpu/events/`` (reference:
packages/openclaw-nats-eventstore): an in-memory JetStream-lite ring, a
durable JSONL file log, and a NATS JetStream adapter. Without the ``nats``
client package ``create_nats_transport`` raises, where the JAX package's
returns None and its callers degrade to a local transport.
"""

from .envelope import (
    CANONICAL_EVENT_TYPES,
    ClawEvent,
    build_envelope,
    derive_event_id,
)
from .mappings import EXTRA_EMITTERS, HOOK_MAPPINGS, HookMapping
from .plugin import EventStorePlugin
from .subjects import build_subject
from .transport import (FileTransport, MemoryTransport, TransportStats,
                        create_nats_transport)

__all__ = [
    "CANONICAL_EVENT_TYPES",
    "ClawEvent",
    "EXTRA_EMITTERS",
    "EventStorePlugin",
    "FileTransport",
    "HOOK_MAPPINGS",
    "HookMapping",
    "MemoryTransport",
    "TransportStats",
    "build_envelope",
    "build_subject",
    "create_nats_transport",
    "derive_event_id",
]
