"""Event envelope, subjects and transports, the part of the JAX package's
``events/`` that the replica fleet's route log rides. The event-store
plugin, the hook mappings and the NATS adapter are not ported yet."""

from .envelope import (
    CANONICAL_EVENT_TYPES,
    ClawEvent,
    build_envelope,
    derive_event_id,
)
from .subjects import build_subject
from .transport import FileTransport, MemoryTransport, TransportStats

__all__ = [
    "CANONICAL_EVENT_TYPES",
    "ClawEvent",
    "FileTransport",
    "MemoryTransport",
    "TransportStats",
    "build_envelope",
    "build_subject",
    "derive_event_id",
]
