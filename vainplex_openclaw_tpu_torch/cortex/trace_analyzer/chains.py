"""Chain reconstruction: a copy of
``vainplex_openclaw_tpu/cortex/trace_analyzer/chains.py``.

Bucket by (session, agent) → sort by ts → dedupe (cross-schema double
capture) → split on lifecycle boundaries / 30-min gaps / event caps →
chains with deterministic sha256-derived ids and type counts. Chains need
≥2 events (nothing to analyze in singletons).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Iterable, Optional

from .events import NormalizedEvent

DEFAULT_GAP_MINUTES = 30.0
DEFAULT_MAX_EVENTS_PER_CHAIN = 1000


@dataclass
class ConversationChain:
    id: str
    agent: str
    session: str
    start_ts: float
    end_ts: float
    events: list[NormalizedEvent]
    type_counts: dict = field(default_factory=dict)
    boundary_type: str = "time_range"
    # per-run cache of tool.call→tool.result pairing, shared by the three
    # tool-failure detectors (signals._tool_attempts)
    _tool_attempts: Optional[list] = field(default=None, repr=False, compare=False)
    # per-run cache of completion-claim msg.out indices, shared by the
    # hallucination and unverified-claim detectors
    # (signals._completion_claim_indices)
    _completion_claims: Optional[list] = field(default=None, repr=False, compare=False)
    # per-run cache of consecutive-attempt similarities
    # (signals._consecutive_similarities)
    _pair_sims: Optional[list] = field(default=None, repr=False, compare=False)


def compute_chain_id(session: str, agent: str, first_ts: float) -> str:
    digest = hashlib.sha256(f"{session}:{agent}:{first_ts}".encode()).hexdigest()
    return digest[:16]


def _dedupe(events: list[NormalizedEvent]) -> list[NormalizedEvent]:
    """Drop CROSS-SCHEMA duplicates only: the same logical event captured by
    both the event store (A) and session-sync (B) shares (type, second,
    content) but differs in schema. Same-schema repeats — e.g. three
    identical failing retries within one second, the doom-loop shape — are
    real events and must survive.
    """
    first_schema: dict = {}
    out = []
    for e in events:
        content = e.payload.get("content") or e.payload.get("tool_name") or ""
        key = (e.type, round(e.ts / 1000.0), str(content)[:80])
        prior = first_schema.get(key)
        if prior is not None and prior != e.schema:
            continue  # cross-schema duplicate of an already-kept event
        first_schema.setdefault(key, e.schema)
        out.append(e)
    return out


def _is_boundary(prev: NormalizedEvent, curr: NormalizedEvent, gap_ms: float) -> bool:
    if curr.type == "session.start":
        return True
    if prev.type == "session.end":
        return True
    if prev.type == "run.end" and curr.type == "run.start" and curr.ts - prev.ts > 5 * 60_000:
        return True
    return curr.ts - prev.ts > gap_ms


def _segment_to_chain(segment: list[NormalizedEvent], boundary_type: str) -> ConversationChain:
    counts: dict = {}
    for e in segment:
        counts[e.type] = counts.get(e.type, 0) + 1
    first, last = segment[0], segment[-1]
    return ConversationChain(
        id=compute_chain_id(first.session, first.agent, first.ts),
        agent=first.agent,
        session=first.session,
        start_ts=first.ts,
        end_ts=last.ts,
        events=segment,
        type_counts=counts,
        boundary_type=boundary_type,
    )


def reconstruct_chains(events: Iterable[NormalizedEvent],
                       gap_minutes: float = DEFAULT_GAP_MINUTES,
                       max_events_per_chain: int = DEFAULT_MAX_EVENTS_PER_CHAIN,
                       ) -> list[ConversationChain]:
    buckets: dict[tuple[str, str], list[NormalizedEvent]] = {}
    for event in events:
        buckets.setdefault((event.session, event.agent), []).append(event)

    gap_ms = gap_minutes * 60_000
    chains: list[ConversationChain] = []
    for bucket in buckets.values():
        bucket.sort(key=lambda e: e.ts)
        deduped = _dedupe(bucket)
        segment: list[NormalizedEvent] = []
        boundary = "time_range"
        for event in deduped:
            if segment and (_is_boundary(segment[-1], event, gap_ms)
                            or len(segment) >= max_events_per_chain):
                if len(segment) >= 2:
                    chains.append(_segment_to_chain(
                        segment,
                        "memory_cap" if len(segment) >= max_events_per_chain
                        else ("lifecycle" if (event.type == "session.start"
                                              or segment[-1].type == "session.end")
                              else "gap")))
                segment = []
            segment.append(event)
        if len(segment) >= 2:
            chains.append(_segment_to_chain(segment, boundary))
    chains.sort(key=lambda c: c.start_ts)
    return chains
