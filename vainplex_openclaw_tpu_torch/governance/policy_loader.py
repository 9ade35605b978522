"""Policy loading, validation, and indexing
(reference: governance/src/policy-loader.ts:12-134).

Includes the ReDoS guard: user-policy regexes are rejected when longer than
500 chars or containing nested quantifiers; surviving patterns are
pre-compiled into the shared regex cache so the hot path never compiles.
"""

from __future__ import annotations

import re
from typing import Optional

from .builtin_policies import get_builtin_policies
from .types import Policy, PolicyIndex

MAX_PATTERN_LENGTH = 500
# quantified group followed by another quantifier: (a+)+ (a*)* (a+){2} etc.
_NESTED_QUANTIFIER = re.compile(r"\([^)]*[+*]\)[+*{]|\([^)]*\{\d+,?\d*\}\)[+*{]")


def validate_regex(pattern: str) -> Optional[str]:
    """Return an error string when the pattern is unsafe/invalid, else None."""
    if len(pattern) > MAX_PATTERN_LENGTH:
        return f"pattern exceeds {MAX_PATTERN_LENGTH} chars"
    if _NESTED_QUANTIFIER.search(pattern):
        return "nested quantifiers (ReDoS risk)"
    try:
        re.compile(pattern)
    except re.error as exc:
        return f"invalid regex: {exc}"
    return None


def _walk_patterns(condition: dict):
    if condition.get("type") == "tool":
        for matcher in (condition.get("params") or {}).values():
            if "matches" in matcher:
                yield matcher["matches"]
    elif condition.get("type") == "context":
        for key in ("conversationContains", "messageContains"):
            val = condition.get(key)
            if isinstance(val, str):
                yield val
            elif isinstance(val, list):
                yield from val
    elif condition.get("type") == "any":
        for sub in condition.get("conditions", []):
            yield from _walk_patterns(sub)
    elif condition.get("type") == "not":
        if condition.get("condition"):
            yield from _walk_patterns(condition["condition"])


def policy_patterns(policy: Policy):
    for rule in policy.get("rules", []):
        for condition in rule.get("conditions", []):
            yield from _walk_patterns(condition)


def load_policies(builtin_config: dict, user_policies: list[Policy], logger,
                  regex_cache: Optional[dict] = None) -> list[Policy]:
    """Builtins + enabled user policies, with per-policy regex validation;
    a policy with any unsafe pattern is dropped (fail-closed for ReDoS)."""
    policies = get_builtin_policies(builtin_config)
    for policy in user_policies:
        if policy.get("enabled") is False:
            continue
        bad = None
        for pattern in policy_patterns(policy):
            err = validate_regex(pattern)
            if err:
                bad = f"{pattern!r}: {err}"
                break
        if bad:
            logger.warn(f"policy {policy.get('id')} dropped — {bad}")
            continue
        policies.append(policy)
    if regex_cache is not None:
        precompile(policies, regex_cache)
    return policies


def precompile(policies: list[Policy], cache: dict) -> None:
    for policy in policies:
        for pattern in policy_patterns(policy):
            if pattern not in cache:
                try:
                    cache[pattern] = re.compile(pattern)
                except re.error:
                    pass


def build_policy_index(policies: list[Policy]) -> PolicyIndex:
    by_hook: dict[str, list[Policy]] = {}
    by_agent: dict[str, list[Policy]] = {}
    unscoped: list[Policy] = []
    for policy in policies:
        scope = policy.get("scope", {})
        for hook in scope.get("hooks") or ["*"]:
            by_hook.setdefault(hook, []).append(policy)
        agents = scope.get("agents")
        if agents:
            for agent in agents:
                by_agent.setdefault(agent, []).append(policy)
        else:
            unscoped.append(policy)
    return PolicyIndex(all=policies, by_hook=by_hook, by_agent=by_agent,
                       unscoped=unscoped,
                       unique_policy_count=len({p["id"] for p in policies}))


def policies_for(index: PolicyIndex, agent_id: str, hook: str) -> list[Policy]:
    """Policies applicable to (agent, hook): agent-scoped ∪ unscoped, filtered
    by hook scope."""
    candidates = index.by_agent.get(agent_id, []) + index.unscoped
    out = []
    for policy in candidates:
        hooks = policy.get("scope", {}).get("hooks")
        if hooks and hook not in hooks:
            continue
        out.append(policy)
    return out
