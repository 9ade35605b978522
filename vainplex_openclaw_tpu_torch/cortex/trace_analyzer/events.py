"""Normalized events + dual-schema sniffing: a copy of
``vainplex_openclaw_tpu/cortex/trace_analyzer/events.py``.

Schema A = our event store's envelopes (legacy types ``msg.in`` etc., ``ts``
in ms). Schema B = session-sync exports (``conversation.*`` types,
``timestamp`` field, ``meta.source == "session-sync"``). Detectors only ever
see the normalized shape.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

ANALYZER_EVENT_TYPES = ("msg.in", "msg.out", "tool.call", "tool.result",
                        "session.start", "session.end", "run.start", "run.end",
                        "run.error")

_EVENT_TYPE_MAP = {
    # Schema A (event-store legacy types)
    **{t: t for t in ANALYZER_EVENT_TYPES},
    # NOTE: "msg.sending" is deliberately NOT mapped — drivers that fire both
    # message_sending and message_sent would double-count every agent reply
    # (same-schema repeats survive dedupe by design); msg.out covers the send.
    # Schema B (session-sync conversation events)
    "conversation.message.in": "msg.in",
    "conversation.message.out": "msg.out",
    "conversation.tool_call": "tool.call",
    "conversation.tool_result": "tool.result",
}


@dataclass(slots=True)
class NormalizedEvent:
    id: str
    ts: float  # ms epoch
    agent: str
    session: str
    type: str
    payload: dict = field(default_factory=dict)
    seq: int = 0
    schema: str = "A"  # source schema — dedupe only collapses across schemas


def map_event_type(raw: str) -> Optional[str]:
    return _EVENT_TYPE_MAP.get(raw)


def detect_schema(raw: dict) -> Optional[str]:
    rtype = raw.get("type")
    if not isinstance(rtype, str):
        return None
    if rtype.startswith("conversation."):
        return "B"
    meta = raw.get("meta")
    if isinstance(meta, dict) and meta.get("source") == "session-sync":
        return "B"
    if isinstance(raw.get("ts"), (int, float)) and rtype in _EVENT_TYPE_MAP:
        return "A"
    if isinstance(raw.get("timestamp"), (int, float)):
        return "B"
    if rtype in _EVENT_TYPE_MAP:
        return "A"
    return None


def normalize_session(session: str) -> str:
    """Schema B sessions look like ``agent:main:uuid`` → keep the uuid tail."""
    parts = session.split(":")
    if len(parts) >= 3 and parts[0] == "agent":
        return parts[-1]
    return session


def _normalize_payload_a(rtype: str, payload: dict) -> dict:
    out: dict = {}
    if rtype in ("msg.in", "msg.out"):
        out["content"] = payload.get("content") or ""
        out["role"] = "user" if rtype == "msg.in" else "assistant"
        out["from"] = payload.get("from")
        out["to"] = payload.get("to")
        out["channel"] = payload.get("channel")
    elif rtype == "tool.call":
        out["tool_name"] = payload.get("tool_name") or payload.get("toolName")
        out["tool_params"] = payload.get("params") or payload.get("tool_params") or {}
    elif rtype == "tool.result":
        out["tool_name"] = payload.get("tool_name") or payload.get("toolName")
        out["tool_error"] = payload.get("error") or payload.get("tool_error")
        out["tool_result"] = payload.get("result")
        out["tool_is_error"] = bool(out["tool_error"])
    elif rtype in ("run.start", "run.end", "run.error"):
        out["error"] = payload.get("error")
        out["duration_ms"] = payload.get("duration_ms")
    return out


def _normalize_payload_b(rtype: str, raw: dict) -> dict:
    body = raw.get("data") or raw.get("payload") or {}
    out: dict = {}
    if rtype in ("msg.in", "msg.out"):
        out["content"] = body.get("text") or body.get("content") or ""
        out["role"] = "user" if rtype == "msg.in" else "assistant"
        out["channel"] = body.get("channel")
    elif rtype == "tool.call":
        out["tool_name"] = body.get("tool") or body.get("name")
        out["tool_params"] = body.get("arguments") or body.get("params") or {}
    elif rtype == "tool.result":
        out["tool_name"] = body.get("tool") or body.get("name")
        out["tool_error"] = body.get("error")
        out["tool_result"] = body.get("output") or body.get("result")
        out["tool_is_error"] = bool(body.get("error")) or body.get("is_error") is True
    return out


def normalize_event(raw: dict, seq: int = 0) -> Optional[NormalizedEvent]:
    schema = detect_schema(raw)
    if schema is None:
        return None
    rtype = map_event_type(raw["type"])
    if rtype is None:
        return None
    if schema == "A":
        ts = float(raw.get("ts") or 0)
        agent = raw.get("agent") or "unknown"
        session = str(raw.get("session") or agent)
        payload = _normalize_payload_a(rtype, raw.get("payload") or {})
    else:
        ts = float(raw.get("timestamp") or raw.get("ts") or 0)
        agent = raw.get("agent") or (raw.get("meta") or {}).get("agent") or "unknown"
        session = normalize_session(str(raw.get("session") or raw.get("sessionKey") or agent))
        payload = _normalize_payload_b(rtype, raw)
    return NormalizedEvent(
        id=str(raw.get("id") or f"{session}:{rtype}:{ts}"),
        ts=ts,
        agent=agent,
        session=session,
        type=rtype,
        payload=payload,
        seq=int(raw.get("seq") or seq),
        schema=schema,
    )
