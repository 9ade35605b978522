"""Data-driven hook→event mapping table.

Reference: nats-eventstore/src/hook-mappings.ts:9-120+. A copy of
``vainplex_openclaw_tpu/events/mappings.py``, kept here so the port imports
nothing of the JAX package: the same 15 ``HOOK_MAPPINGS``, the one
``EXTRA_EMITTERS`` entry and their payload mappers. Each row maps one
gateway hook to an envelope: canonical+legacy type, visibility tier, and a
payload mapper. Notable semantics preserved:

- ``after_tool_call`` discriminates failed vs executed via ``event.error``.
- ``llm_input``/``llm_output`` record **lengths only**, never prompt bodies
  (privacy: the event stream must not become a prompt archive).
- Gateway lifecycle hooks are system events (agent/session = "system").
- EXTRA_EMITTERS adds ``run.failed`` from ``agent_end`` when an error is set.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional, Union

HookPayload = dict
HookCtx = dict
EventTypeSpec = Union[str, Callable[[HookPayload, HookCtx], str]]


@dataclass
class HookMapping:
    hook_name: str
    event_type: EventTypeSpec
    legacy_type: Optional[str] = None
    visibility: str = "internal"
    redaction: Optional[dict] = None
    system_event: bool = False
    mapper: Callable[[HookPayload, HookCtx], dict] = field(default=lambda e, c: dict(e))
    # Hook-bus priority for the publishing handler. Default: dead last, so the
    # event records the post-mutation view. Exceptions, set per-row below:
    # - before_tool_call publishes at 1 (a "requested" event semantically
    #   precedes evaluation, and a DENIED call must still be auditable — an
    #   enforcement block at prio ~1000 short-circuits later handlers; bonus:
    #   params are captured pre-vault-resolution, i.e. still redacted).
    # - outbound message hooks publish at 990: after the redaction layer
    #   (prio 900) scrubs content but before enforcement (prio 1000) can
    #   block, so blocked sends are still recorded — scrubbed.
    priority: Optional[int] = None


@dataclass
class ExtraEmitter:
    hook_name: str
    event_type: EventTypeSpec
    condition: Callable[[HookPayload], bool]
    mapper: Callable[[HookPayload, HookCtx], dict]
    legacy_type: Optional[str] = None
    visibility: str = "internal"


def _msg_payload(e: HookPayload, c: HookCtx) -> dict:
    return {
        "from": e.get("from"),
        "content": e.get("content"),
        "channel": c.get("channel_id"),
        "metadata": e.get("metadata"),
    }


def _tool_call_payload(e: HookPayload, c: HookCtx) -> dict:
    return {
        "tool_name": e.get("tool_name"),
        "params": e.get("params"),
        "tool_call_id": e.get("tool_call_id") or c.get("tool_call_id"),
    }


def _tool_result_payload(e: HookPayload, c: HookCtx) -> dict:
    result = e.get("result")
    return {
        "tool_name": e.get("tool_name"),
        "tool_call_id": e.get("tool_call_id") or c.get("tool_call_id"),
        "error": e.get("error"),
        "result_chars": len(str(result)) if result is not None else 0,
    }


def _llm_meta_payload(e: HookPayload, c: HookCtx) -> dict:
    # Lengths and redaction metadata only — bodies are deliberately omitted.
    # llm_input carries "prompt"/"content"; llm_output carries "completion".
    body = e.get("prompt") or e.get("content") or e.get("completion") or ""
    return {
        "chars": len(str(body)),
        "model": e.get("model"),
        "redaction_applied": bool(e.get("redaction_applied")),
    }


HOOK_MAPPINGS: list[HookMapping] = [
    HookMapping("message_received", "message.in.received", "msg.in", "confidential",
                mapper=_msg_payload),
    HookMapping("message_sending", "message.out.sending", "msg.sending", "confidential",
                mapper=lambda e, c: {"to": e.get("to"), "content": e.get("content"),
                                     "channel": c.get("channel_id")},
                priority=990),
    HookMapping("message_sent", "message.out.sent", "msg.out", "confidential",
                mapper=lambda e, c: {"to": e.get("to"), "content": e.get("content"),
                                     "channel": c.get("channel_id")}),
    HookMapping("before_tool_call", "tool.call.requested", "tool.call", "internal",
                mapper=_tool_call_payload, priority=1),
    HookMapping("after_tool_call",
                lambda e, c: "tool.call.failed" if e.get("error") else "tool.call.executed",
                "tool.result", "internal", mapper=_tool_result_payload),
    HookMapping("before_agent_start", "run.started", "run.start", "internal",
                mapper=lambda e, c: {"run_id": c.get("run_id"), "prompt_chars": len(str(e.get("prompt") or ""))}),
    HookMapping("agent_end", "run.ended", "run.end", "internal",
                mapper=lambda e, c: {"run_id": c.get("run_id"), "error": e.get("error")}),
    HookMapping("llm_input", "model.input.observed", "llm.input", "secret",
                redaction={"applied": True, "policy": "omit-bodies", "omitted_fields": ["prompt"]},
                mapper=_llm_meta_payload),
    HookMapping("llm_output", "model.output.observed", "llm.output", "secret",
                redaction={"applied": True, "policy": "omit-bodies", "omitted_fields": ["completion"]},
                mapper=_llm_meta_payload),
    HookMapping("session_start", "session.started", "session.start", "internal",
                mapper=lambda e, c: {"session_key": c.get("session_key")}),
    HookMapping("session_end", "session.ended", "session.end", "internal",
                mapper=lambda e, c: {"session_key": c.get("session_key")}),
    HookMapping("before_compaction", "session.compaction.started", "session.compaction_start",
                "internal", mapper=lambda e, c: {"session_key": c.get("session_key")}),
    HookMapping("after_compaction", "session.compaction.ended", "session.compaction_end",
                "internal", mapper=lambda e, c: {"session_key": c.get("session_key")}),
    HookMapping("gateway_start", "gateway.started", "gateway.start", "public",
                system_event=True, mapper=lambda e, c: {}),
    HookMapping("gateway_stop", "gateway.stopped", "gateway.stop", "public",
                system_event=True, mapper=lambda e, c: {}),
]

EXTRA_EMITTERS: list[ExtraEmitter] = [
    ExtraEmitter(
        hook_name="agent_end",
        event_type="run.failed",
        legacy_type="run.error",
        condition=lambda e: bool(e.get("error")),
        mapper=lambda e, c: {"run_id": c.get("run_id"), "error": str(e.get("error"))},
    ),
]
