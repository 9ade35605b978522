"""Condition evaluators — 8 types: tool, time, context, agent, risk,
frequency, any (OR), not (reference: governance/src/conditions/*).

Differences from the reference: the evaluator map travels in ``deps`` rather
than module-global state (the reference's ``setEvaluatorMap`` singleton makes
composite conditions share one map process-wide).
"""

from __future__ import annotations

import re
from typing import Optional

from .types import Condition, ConditionDeps, EvaluationContext
from .util import (
    glob_to_regex,
    is_in_time_range,
    parse_time_to_minutes,
    risk_ordinal,
)


def _compile_cached(pattern: str, cache: dict) -> Optional[re.Pattern]:
    cached = cache.get(pattern)
    if cached is not None:
        return cached
    try:
        compiled = re.compile(pattern)
    except re.error:
        return None
    cache[pattern] = compiled
    return compiled


def _match_name(pattern, name: Optional[str]) -> bool:
    if not name:
        return False
    patterns = pattern if isinstance(pattern, list) else [pattern]
    for p in patterns:
        if "*" in p or "?" in p:
            if glob_to_regex(p).match(name):
                return True
        elif p == name:
            return True
    return False


def _match_param(matcher: dict, value, cache: dict) -> bool:
    if "equals" in matcher:
        return value == matcher["equals"]
    if "contains" in matcher:
        return isinstance(value, str) and matcher["contains"] in value
    if "matches" in matcher:
        if not isinstance(value, str):
            return False
        compiled = _compile_cached(matcher["matches"], cache)
        return bool(compiled and compiled.search(value))
    if "startsWith" in matcher:
        return isinstance(value, str) and value.startswith(matcher["startsWith"])
    if "in" in matcher:
        return value in matcher["in"]
    return False


def eval_tool(c: Condition, ctx: EvaluationContext, deps: ConditionDeps) -> bool:
    if "name" in c and not _match_name(c["name"], ctx.tool_name):
        return False
    if "params" in c:
        if ctx.tool_params is None:
            return False
        for key, matcher in c["params"].items():
            if not _match_param(matcher, ctx.tool_params.get(key), deps.regex_cache):
                return False
    return True


def eval_time(c: Condition, ctx: EvaluationContext, deps: ConditionDeps) -> bool:
    current = ctx.time.hour * 60 + ctx.time.minute
    if "window" in c:
        win = deps.time_windows.get(c["window"])
        if not win:
            return False
        start, end = parse_time_to_minutes(win["start"]), parse_time_to_minutes(win["end"])
        if start < 0 or end < 0 or not is_in_time_range(current, start, end):
            return False
        days = win.get("days")
        return not days or ctx.time.day_of_week in days
    after, before = c.get("after"), c.get("before")
    if after is not None and before is not None:
        a, b = parse_time_to_minutes(after), parse_time_to_minutes(before)
        if a < 0 or b < 0 or not is_in_time_range(current, a, b):
            return False
    elif after is not None:
        a = parse_time_to_minutes(after)
        if a < 0 or current < a:
            return False
    elif before is not None:
        b = parse_time_to_minutes(before)
        if b < 0 or current >= b:
            return False
    days = c.get("days")
    return not days or ctx.time.day_of_week in days


def _matches_any(patterns, texts: list[str], cache: dict) -> bool:
    items = patterns if isinstance(patterns, list) else [patterns]
    for pattern in items:
        compiled = _compile_cached(pattern, cache)
        if compiled is not None:
            if any(compiled.search(t) for t in texts):
                return True
        elif any(pattern in t for t in texts):
            return True
    return False


def eval_context(c: Condition, ctx: EvaluationContext, deps: ConditionDeps) -> bool:
    if "conversationContains" in c:
        convo = ctx.conversation_context or []
        if not convo or not _matches_any(c["conversationContains"], convo, deps.regex_cache):
            return False
    if "messageContains" in c:
        if not ctx.message_content:
            return False
        if not _matches_any(c["messageContains"], [ctx.message_content], deps.regex_cache):
            return False
    if "hasMetadata" in c:
        keys = c["hasMetadata"] if isinstance(c["hasMetadata"], list) else [c["hasMetadata"]]
        if not all(k in (ctx.metadata or {}) for k in keys):
            return False
    if "channel" in c:
        channels = c["channel"] if isinstance(c["channel"], list) else [c["channel"]]
        if not ctx.channel or ctx.channel not in channels:
            return False
    if "sessionKey" in c:
        if not ctx.session_key or not glob_to_regex(c["sessionKey"]).match(ctx.session_key):
            return False
    return True


def eval_agent(c: Condition, ctx: EvaluationContext, deps: ConditionDeps) -> bool:
    if "id" in c and not _match_name(c["id"], ctx.agent_id):
        return False
    # trustTier checks the persistent agent tier, not the ephemeral session
    # tier (production-access decisions key off configured trust — reference
    # conditions/simple.ts:50-55).
    if "trustTier" in c:
        tiers = c["trustTier"] if isinstance(c["trustTier"], list) else [c["trustTier"]]
        if ctx.trust.agent.tier not in tiers:
            return False
    if "minScore" in c and ctx.trust.agent.score < c["minScore"]:
        return False
    if "maxScore" in c and ctx.trust.agent.score > c["maxScore"]:
        return False
    return True


def eval_risk(c: Condition, ctx: EvaluationContext, deps: ConditionDeps) -> bool:
    current = risk_ordinal(deps.risk.level)
    if "minRisk" in c and current < risk_ordinal(c["minRisk"]):
        return False
    if "maxRisk" in c and current > risk_ordinal(c["maxRisk"]):
        return False
    return True


def eval_frequency(c: Condition, ctx: EvaluationContext, deps: ConditionDeps) -> bool:
    scope = c.get("scope", "agent")
    count = deps.frequency_tracker.count(c["windowSeconds"], scope, ctx.agent_id, ctx.session_key)
    return count >= c["maxCount"]


def eval_any(c: Condition, ctx: EvaluationContext, deps: ConditionDeps) -> bool:
    for sub in c.get("conditions", []):
        fn = deps.evaluators.get(sub.get("type"))
        if fn is not None and fn(sub, ctx, deps):
            return True
    return False


def eval_not(c: Condition, ctx: EvaluationContext, deps: ConditionDeps) -> bool:
    sub = c.get("condition")
    if not sub:
        return True
    fn = deps.evaluators.get(sub.get("type"))
    if fn is None:
        return True
    return not fn(sub, ctx, deps)


def create_condition_evaluators() -> dict:
    return {
        "tool": eval_tool,
        "time": eval_time,
        "context": eval_context,
        "agent": eval_agent,
        "risk": eval_risk,
        "frequency": eval_frequency,
        "any": eval_any,
        "not": eval_not,
    }


def evaluate_conditions_interp(conditions: list[Condition], ctx: EvaluationContext,
                               deps: ConditionDeps) -> bool:
    """AND across the list; unknown condition types fail the rule (deny-safe).

    This dict-walking interpreter is the governance semantics of record: the
    compiled planner (policy_plan.py) is pinned to it by randomized
    equivalence tests and must never diverge from what this returns.
    """
    for c in conditions:
        fn = deps.evaluators.get(c.get("type"))
        if fn is None or not fn(c, ctx, deps):
            return False
    return True


# The hot path now runs compiled policy plans; the interpreter keeps its old
# name as an alias because it IS the behavior contract, not a legacy path.
evaluate_conditions = evaluate_conditions_interp
