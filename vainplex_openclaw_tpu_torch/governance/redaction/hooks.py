"""Redaction hook layering (reference: governance/src/redaction/hooks.ts).

Priority layout relative to governance enforcement @1000:
- ``tool_result_persist`` @800 — Layer 1: scrub tool results before they
  enter LLM context (synchronous, mutating).
- ``after_tool_call`` @800 — audit-only scan counterpart.
- ``before_tool_call`` @950 — vault resolution: re-inject real secrets into
  tool params right before execution (after policy checks have seen the
  redacted view at 950 < 1000? No — governance runs at 1000 *after* this, by
  design: the tool must receive working credentials, and the evaluation
  happens on the resolved params exactly as the reference orders it).
- ``message_sending`` / ``before_message_write`` @900 — Layer 2 outbound
  scan, before enforcement can block at 1000.

Allowlist semantics: exempt tools/agents still get a credential-only scan
(never ship raw credentials anywhere); pii/financial categories can be
allowed per channel.

A copy of ``vainplex_openclaw_tpu/governance/redaction/hooks.py``. Its four
catches wrap host-only scans and keep JAX's behaviour and failModes
exactly: no device work runs inside them.
"""

from __future__ import annotations

import json
from dataclasses import dataclass

from .engine import RedactionEngine
from .registry import PatternRegistry
from .vault import RedactionVault

DEFAULT_REDACTION_CONFIG = {
    "enabled": False,
    "categories": ["credential", "pii", "financial"],
    "vaultExpirySeconds": 3600,
    "failMode": "closed",
    "customPatterns": [],
    "allowlist": {
        "piiAllowedChannels": [],
        "financialAllowedChannels": [],
        "exemptTools": [],
        "exemptAgents": [],
    },
    "performanceBudgetMs": 5,
}


@dataclass
class RedactionState:
    registry: PatternRegistry
    vault: RedactionVault
    engine: RedactionEngine
    credential_only_engine: RedactionEngine
    config: dict


def init_redaction(config: dict, logger, clock=None) -> RedactionState:
    from ...config.loader import deep_merge

    config = deep_merge(DEFAULT_REDACTION_CONFIG, config or {})
    registry = PatternRegistry(config["categories"], config["customPatterns"], logger)
    kwargs = {"clock": clock} if clock is not None else {}
    vault = RedactionVault(logger, config["vaultExpirySeconds"], **kwargs)
    engine = RedactionEngine(registry, vault)
    credential_only = RedactionEngine(PatternRegistry(["credential"], [], logger), vault)
    return RedactionState(registry, vault, engine, credential_only, config)


def _engine_for(state: RedactionState, tool_name, agent_id) -> RedactionEngine:
    allow = state.config["allowlist"]
    if tool_name in allow.get("exemptTools", ()) or agent_id in allow.get("exemptAgents", ()):
        return state.credential_only_engine
    return state.engine


def _engine_for_channel(state: RedactionState, channel) -> RedactionEngine:
    """Outbound: build the scan from categories minus channel allowances."""
    allow = state.config["allowlist"]
    cats = list(state.config["categories"])
    if channel and channel in allow.get("piiAllowedChannels", ()):
        cats = [c for c in cats if c != "pii"]
    if channel and channel in allow.get("financialAllowedChannels", ()):
        cats = [c for c in cats if c != "financial"]
    if cats == list(state.config["categories"]):
        return state.engine
    return RedactionEngine(PatternRegistry(cats, state.config["customPatterns"], None),
                           state.vault)


def register_redaction_hooks(api, state: RedactionState) -> None:
    logger = api.logger
    fail_closed = state.config.get("failMode", "closed") == "closed"

    def handle_tool_result_persist(event: dict, ctx: dict):
        try:
            engine = _engine_for(state, event.get("tool_name"), ctx.get("agent_id"))
            result = engine.scan(event.get("result"))
            if result.redaction_count == 0:
                return None
            return {"result": result.output, "redaction_applied": True}
        except Exception as exc:  # noqa: BLE001
            logger.error(f"[redaction] tool_result_persist failed: {exc}")
            if fail_closed:
                return {"result": "[REDACTION FAILED - RESULT WITHHELD]"}
            return None

    def handle_after_tool_call(event: dict, ctx: dict):
        # audit-only counterpart: count what WOULD be redacted (result already
        # scrubbed by persist when it ran first)
        try:
            engine = _engine_for(state, event.get("tool_name"), ctx.get("agent_id"))
            res = engine.scan(event.get("result"))
            if res.redaction_count:
                logger.info(f"[redaction] after_tool_call: {res.redaction_count} redactions "
                            f"({','.join(sorted(res.categories))})")
        except Exception as exc:  # noqa: BLE001
            logger.error(f"[redaction] after_tool_call failed: {exc}")
        return None

    def handle_before_tool_call(event: dict, ctx: dict):
        # Vault resolution: placeholders in params become live secrets so the
        # tool actually works (reference redaction/hooks.ts:121-125).
        try:
            params = event.get("params") or {}
            text = json.dumps(params)
            resolved, count = state.vault.resolve_placeholders(text)
            if count == 0:
                return None
            return {"params": json.loads(resolved)}
        except Exception as exc:  # noqa: BLE001
            logger.error(f"[redaction] vault resolution failed: {exc}")
            return None  # params stay redacted; the tool may fail but nothing leaks

    def handle_outbound(event: dict, ctx: dict):
        try:
            engine = _engine_for_channel(state, ctx.get("channel_id"))
            res = engine.scan_string(event.get("content") or "")
            if res.redaction_count == 0:
                return None
            return {"content": res.output, "redaction_applied": True}
        except Exception as exc:  # noqa: BLE001
            logger.error(f"[redaction] outbound scan failed: {exc}")
            if fail_closed:
                return {"block": True,
                        "fallback_message": "[message withheld: redaction failure]"}
            return None

    api.on("tool_result_persist", handle_tool_result_persist, priority=800)
    api.on("after_tool_call", handle_after_tool_call, priority=800)
    api.on("before_tool_call", handle_before_tool_call, priority=950)
    api.on("message_sending", handle_outbound, priority=900)
    api.on("before_message_write", handle_outbound, priority=900)
    logger.info("[redaction] Hooks registered (Layer 1 + Layer 2)")
