"""Trace sources: a copy of
``vainplex_openclaw_tpu/cortex/trace_analyzer/source.py``.

``TraceSource`` is the fetch seam: batched iteration by time range or agent,
plus last-sequence/count for incremental runs. Implementations: in-memory
(tests + single-process), a bridge over our event-store transports
(Memory/File — the integrated path), and a NATS JetStream consumer created
only when the client lib imports (graceful None otherwise, R-004).
"""

from __future__ import annotations

from typing import Iterator, Optional, Protocol

from .events import NormalizedEvent, normalize_event


class TraceSource(Protocol):
    def fetch(self, start_seq: int = 0, batch_size: int = 500,
              max_events: Optional[int] = None) -> Iterator[NormalizedEvent]: ...
    def last_sequence(self) -> int: ...
    def event_count(self) -> int: ...
    def close(self) -> None: ...


class MemoryTraceSource:
    """In-memory source over raw event dicts (either schema)."""

    def __init__(self, raw_events: list[dict], fail_on_connect: bool = False):
        if fail_on_connect:
            raise ConnectionError("MemoryTraceSource configured to fail")
        self._raw = raw_events

    def fetch(self, start_seq: int = 0, batch_size: int = 500,
              max_events: Optional[int] = None) -> Iterator[NormalizedEvent]:
        n = 0
        for i, raw in enumerate(self._raw):
            seq = int(raw.get("seq") or (i + 1))
            if seq <= start_seq:
                continue
            event = normalize_event(raw, seq=seq)
            if event is None:
                continue
            yield event
            n += 1
            if max_events is not None and n >= max_events:
                return

    def last_sequence(self) -> int:
        return max((int(r.get("seq") or (i + 1)) for i, r in enumerate(self._raw)), default=0)

    def event_count(self) -> int:
        return len(self._raw)

    def close(self) -> None:
        pass


class TransportTraceSource:
    """Bridge over an event-store transport (MemoryTransport/FileTransport):
    analyzer and event store share one history without a broker."""

    def __init__(self, transport, subject_filter: str = ">"):
        self.transport = transport
        self.subject_filter = subject_filter

    def fetch(self, start_seq: int = 0, batch_size: int = 500,
              max_events: Optional[int] = None) -> Iterator[NormalizedEvent]:
        n = 0
        for claw_event in self.transport.fetch(self.subject_filter, start_seq=start_seq):
            raw = claw_event.to_dict()
            event = normalize_event(raw, seq=claw_event.seq or 0)
            if event is None:
                continue
            yield event
            n += 1
            if max_events is not None and n >= max_events:
                return

    def last_sequence(self) -> int:
        return self.transport.last_sequence()

    def event_count(self) -> int:
        return self.transport.event_count()

    def close(self) -> None:
        pass


def create_nats_trace_source(url: str, stream: str = "CLAW_EVENTS",
                             logger=None):  # pragma: no cover - requires broker
    """JetStream-backed source; None when the nats lib is absent (the
    analyzer then produces a graceful empty report — reference
    nats-trace-source.ts:71-115)."""
    try:
        import nats  # type: ignore  # noqa: F401
    except ImportError:
        if logger is not None:
            logger.warn("nats client not available; trace analyzer has no source")
        return None
    from .nats_source import NatsTraceSource

    return NatsTraceSource(url, stream=stream, logger=logger)
