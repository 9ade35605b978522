"""Builtin policies: nightMode, credentialGuard, productionSafeguard,
rateLimiter (reference: governance/src/builtin-policies.ts:20-215).
Semantics preserved: same ids, priorities, ISO-27001 control tags, trust-tier
exemptions, and doubled rate limits for trusted+ agents.
"""

from __future__ import annotations

from typing import Optional

from .types import Policy

READONLY_NIGHT_TOOLS = ["read", "memory_search", "memory_get", "web_search"]

_CRED_COMMAND_PATTERNS = [
    r"(cat|less|head|tail|cp|mv|grep|find|scp|rsync|docker\s+cp).*\.(env|pem|key)",
    r"(cp|mv|scp|rsync|docker\s+cp).*(credentials|secrets|\.env|\.pem|\.key)",
    r"(grep|find).*(password|token|secret|credential)",
]

_PROD_OPS_CONDITIONS = [
    {"type": "tool", "name": "exec", "params": {"command": {
        "matches": r"(docker push|docker-compose.*prod|systemctl.*(restart|stop|enable|disable))"}}},
    {"type": "tool", "name": "exec", "params": {"command": {
        "matches": r"git push.*(origin|upstream).*(main|master|prod)"}}},
    {"type": "tool", "name": "gateway", "params": {"action": {
        "matches": r"(restart|config\.apply|update\.run)"}}},
]


def night_mode(config) -> Optional[Policy]:
    if not config:
        return None
    cfg = config if isinstance(config, dict) else {}
    after = cfg.get("after") or cfg.get("start") or "23:00"
    before = cfg.get("before") or cfg.get("end") or "08:00"
    return {
        "id": "builtin-night-mode",
        "name": "Night Mode",
        "version": "1.0.0",
        "description": f"Restricts non-critical operations between {after} and {before}",
        "scope": {"hooks": ["before_tool_call", "message_sending"]},
        "priority": 100,
        "controls": ["A.7.1", "A.6.2"],
        "rules": [
            {
                "id": "allow-critical-at-night",
                "conditions": [
                    {"type": "time", "after": after, "before": before},
                    {"type": "tool", "name": READONLY_NIGHT_TOOLS},
                ],
                "effect": {"action": "allow"},
            },
            {
                "id": "deny-non-critical-at-night",
                "conditions": [
                    {"type": "time", "after": after, "before": before},
                    {"type": "not", "condition": {"type": "tool", "name": READONLY_NIGHT_TOOLS}},
                ],
                "effect": {
                    "action": "deny",
                    "reason": f"Night mode active ({after}-{before}). Only critical operations allowed.",
                },
            },
        ],
    }


def credential_guard(enabled) -> Optional[Policy]:
    if not enabled:
        return None
    any_conditions = [
        {"type": "tool", "params": {"file_path": {"matches": r"\.(env|pem|key)$"}}},
        {"type": "tool", "params": {"path": {"matches": r"\.(env|pem|key)$"}}},
    ]
    any_conditions += [{"type": "tool", "params": {"command": {"matches": p}}}
                       for p in _CRED_COMMAND_PATTERNS]
    any_conditions += [
        {"type": "tool", "params": {key: {"contains": word}}}
        for word in ("credentials", "secrets")
        for key in ("file_path", "path")
    ]
    return {
        "id": "builtin-credential-guard",
        "name": "Credential Guard",
        "version": "1.0.0",
        "description": "Prevents access to credential files and secrets",
        "scope": {"hooks": ["before_tool_call"]},
        "priority": 200,
        "controls": ["A.8.11", "A.8.4", "A.5.33"],
        "rules": [
            {
                "id": "block-credential-read",
                "conditions": [
                    {"type": "tool", "name": ["read", "exec", "write", "edit"]},
                    {"type": "any", "conditions": any_conditions},
                ],
                "effect": {
                    "action": "deny",
                    "reason": "Credential Guard: Access to credential files is restricted",
                },
            }
        ],
    }


def production_safeguard(enabled) -> Optional[Policy]:
    if not enabled:
        return None
    trusted = {"type": "agent", "trustTier": ["trusted", "elevated"]}
    return {
        "id": "builtin-production-safeguard",
        "name": "Production Safeguard",
        "version": "1.2.0",
        "description": "Restricts production-impacting operations (trusted+ agents exempt)",
        "scope": {"hooks": ["before_tool_call"], "excludeAgents": ["unresolved"]},
        "priority": 150,
        "controls": ["A.8.31", "A.8.32", "A.8.9"],
        "rules": [
            {
                "id": "allow-production-ops-trusted",
                "conditions": [trusted, {"type": "any", "conditions": _PROD_OPS_CONDITIONS}],
                "effect": {"action": "allow"},
            },
            {
                "id": "block-production-ops",
                "conditions": [
                    {"type": "not", "condition": trusted},
                    {"type": "any", "conditions": _PROD_OPS_CONDITIONS},
                ],
                "effect": {
                    "action": "deny",
                    "reason": "Production Safeguard: This operation requires explicit approval (trusted+ agents only)",
                },
            },
        ],
    }


def rate_limiter(config) -> Optional[Policy]:
    if not config:
        return None
    max_per_minute = config.get("maxPerMinute", 15) if isinstance(config, dict) else 15
    trusted_limit = max_per_minute * 2
    trusted = {"type": "agent", "trustTier": ["trusted", "elevated"]}
    return {
        "id": "builtin-rate-limiter",
        "name": "Rate Limiter",
        "version": "1.1.0",
        "description": f"Limits agents to {max_per_minute}/min (trusted+: {trusted_limit}/min)",
        "scope": {"hooks": ["before_tool_call"]},
        "priority": 50,
        "controls": ["A.8.6"],
        "rules": [
            {
                "id": "rate-limit-trusted",
                "conditions": [
                    trusted,
                    {"type": "frequency", "maxCount": trusted_limit, "windowSeconds": 60, "scope": "agent"},
                ],
                "effect": {"action": "deny",
                           "reason": f"Rate limit exceeded ({trusted_limit}/min for trusted agents)"},
            },
            {
                "id": "rate-limit-default",
                "conditions": [
                    {"type": "not", "condition": trusted},
                    {"type": "frequency", "maxCount": max_per_minute, "windowSeconds": 60, "scope": "agent"},
                ],
                "effect": {"action": "deny", "reason": f"Rate limit exceeded ({max_per_minute}/min)"},
            },
        ],
    }


def get_builtin_policies(config: dict) -> list[Policy]:
    out = []
    for policy in (
        night_mode(config.get("nightMode")),
        credential_guard(config.get("credentialGuard")),
        production_safeguard(config.get("productionSafeguard")),
        rate_limiter(config.get("rateLimiter")),
    ):
        if policy is not None:
            out.append(policy)
    return out
