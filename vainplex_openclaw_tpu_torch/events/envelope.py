"""The event envelope.

A copy of ``vainplex_openclaw_tpu/events/envelope.py`` under the same
names, kept here so the port imports nothing of the JAX package; an event
built by one package reads the same in the other.

Reference: nats-eventstore/src/events.ts:1-130 — a canonical "nervous-system"
taxonomy (``message.in.received``, ``tool.call.failed``, …) dual-written with
legacy type names, plus source/actor/scope/trace/visibility metadata and
deterministic event IDs for idempotent re-publish
(``evt-<sha256(session:type:stableId)[:16]>``, src/hooks.ts:67-98).
"""

from __future__ import annotations

import hashlib
import time
import uuid
from dataclasses import asdict, dataclass, field
from typing import Any, Optional

CANONICAL_EVENT_TYPES = (
    "message.in.received",
    "message.out.sending",
    "message.out.sent",
    "tool.call.requested",
    "tool.call.executed",
    "tool.call.failed",
    "run.started",
    "run.ended",
    "run.failed",
    "model.input.observed",
    "model.output.observed",
    "session.started",
    "session.ended",
    "session.compaction.started",
    "session.compaction.ended",
    "session.reset",
    "gateway.started",
    "gateway.stopped",
)

VISIBILITIES = ("public", "internal", "confidential", "secret")


@dataclass
class ClawEvent:
    id: str
    ts: float  # unix ms
    agent: str
    session: str
    type: str  # legacy identifier (routing compatibility)
    canonical_type: Optional[str]
    legacy_type: Optional[str]
    schema_version: int
    source: dict
    actor: dict
    scope: dict
    trace: dict
    visibility: str
    payload: dict
    redaction: Optional[dict] = None
    seq: Optional[int] = None  # assigned by the transport on publish

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ClawEvent":
        known = {f for f in cls.__dataclass_fields__}  # type: ignore[attr-defined]
        return cls(**{k: v for k, v in d.items() if k in known})


def _first_str(*values: Any) -> Optional[str]:
    for v in values:
        if isinstance(v, str) and v:
            return v
    return None


def derive_event_id(canonical_type: str, session: str, payload: dict, ctx: dict) -> str:
    """Deterministic ID from the MOST SPECIFIC stable source identifier.

    Specificity order tool-call id → message id → job id → run id (the
    reference checks run_id first, hooks.ts:74-86 — but a coarse-scoped id
    collapses every same-type event within that scope to a single ID, which
    defeats dedup: two inbound messages in one run, or two tool calls fired
    while handling one message, must not share an event id). UUID fallback.
    """
    oe = ctx.get("original_event") or {}
    stable = _first_str(
        payload.get("tool_call_id"), ctx.get("tool_call_id"), oe.get("tool_call_id"),
        ctx.get("message_id"), payload.get("message_id"), oe.get("message_id"),
        ctx.get("job_id"), payload.get("job_id"), oe.get("job_id"),
        ctx.get("run_id"), payload.get("run_id"), oe.get("run_id"),
        oe.get("id"),
    )
    return _event_id(canonical_type, session, stable)


def _event_id(canonical_type: str, session: str, stable: Optional[str]) -> str:
    if stable:
        h = hashlib.sha256(f"{session}:{canonical_type}:{stable}".encode()).hexdigest()[:16]
        return f"evt-{h}"
    return str(uuid.uuid4())


def build_envelope(
    canonical_type: str,
    payload: dict,
    ctx: dict,
    *,
    plugin: str = "eventstore",
    legacy_type: Optional[str] = None,
    visibility: str = "internal",
    redaction: Optional[dict] = None,
    system_event: bool = False,
    now_ms: Optional[float] = None,
) -> ClawEvent:
    oe = ctx.get("original_event") or {}
    # Hot path (every hook publishes through here): look each identifier up
    # ONCE and reuse across id/scope/trace instead of re-deriving per field.
    cg, pg, og = ctx.get, payload.get, oe.get
    session_key = _first_str(cg("session_key"), og("session_key"))
    session_id = _first_str(cg("session_id"), og("session_id"))
    run_id = _first_str(cg("run_id"), pg("run_id"), og("run_id"))
    tool_call_id = _first_str(pg("tool_call_id"), cg("tool_call_id"), og("tool_call_id"))
    message_id = _first_str(cg("message_id"), pg("message_id"), og("message_id"))
    job_id = _first_str(cg("job_id"), pg("job_id"), og("job_id"))

    agent = "system" if system_event else (
        _first_str(cg("agent_id"), pg("agent_id"), og("agent_id")) or "unknown")
    # precedence: ctx.session_key → ctx.session_id → original_event.session_key
    session = "system" if system_event else (
        _first_str(cg("session_key"), cg("session_id"), og("session_key")) or agent)
    ts = now_ms if now_ms is not None else time.time() * 1000.0
    # Specificity order tool-call id → message id → job id → run id
    # (see derive_event_id docstring).
    stable = tool_call_id or message_id or job_id or run_id or _first_str(og("id"))
    return ClawEvent(
        id=_event_id(canonical_type, session, stable),
        ts=ts,
        agent=agent,
        session=session,
        type=legacy_type or canonical_type,
        canonical_type=canonical_type,
        legacy_type=legacy_type,
        schema_version=1,
        source={"plugin": plugin},
        actor={
            "agent_id": None if system_event else agent,
            "user_id": _first_str(cg("sender_id")),
            "channel": _first_str(cg("channel_id")),
        },
        scope={
            "session_key": session_key,
            "session_id": session_id,
            "run_id": run_id,
            "tool_call_id": tool_call_id,
            "message_id": message_id,
            "job_id": job_id,
        },
        trace={
            "trace_id": _first_str(cg("trace_id"), og("trace_id")),
            "span_id": _first_str(cg("span_id"), og("span_id")),
            "parent_span_id": _first_str(cg("parent_span_id"), og("parent_span_id")),
            "causation_id": _first_str(pg("causation_id"), og("causation_id")),
            "correlation_id": _first_str(cg("run_id"), cg("session_id"), cg("session_key"),
                                         og("run_id"), og("session_id"), og("session_key")),
        },
        visibility=visibility,
        redaction=redaction,
        payload=payload,
    )
