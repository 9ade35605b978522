"""Load-time policy plans: the compiled governance enforcement hot path.

``GovernanceEngine.evaluate`` is the per-request tax on every agent action
(the reference's only continuously measured metric, engine.ts:535-544), yet
the interpretive evaluator re-filters, re-sorts, and re-dispatches dict
conditions on every call. This module compiles each policy ONCE:

- every rule condition becomes a closure with all regexes, globs, tier
  ordinals, and time windows resolved ahead of time;
- per-(agent, parent, hook) candidate lists are pre-partitioned, pre-filtered
  by the static scope parts (agents, excludeAgents, hooks), and pre-sorted by
  (priority, specificity) — only the channel check stays dynamic;
- cross-agent inheritance (own ∪ parent, deduped by policy id) is folded into
  the memoized plan together with its inherited-id list.

The dict-walking interpreter (`conditions.evaluate_conditions_interp`) stays
untouched as the equivalence oracle: `tests/test_governance_plan_equiv.py`
pins the JAX package's planner to it on randomized policy matrices, and
`tests/test_torch_governance.py` holds this copy to both; any condition this
compiler cannot handle falls back to a closure that defers to the oracle —
the plan path can be faster, never different.

Closure calling convention: ``fn(ctx, risk, tracker) -> bool``. ``ctx`` and
``risk`` are per-evaluation; ``tracker`` is the engine's FrequencyTracker
(passed rather than baked in so a planner is reusable across engines in
tests).
"""

from __future__ import annotations

import re
from typing import Callable, Iterator, Optional

from ..analysis.redos import pattern_safe, unsafe_report
from .conditions import create_condition_evaluators
from .policy_evaluator import aggregate_matches, policy_specificity
from .types import (
    Condition,
    ConditionDeps,
    EvalResult,
    EvaluationContext,
    MatchedPolicy,
    Policy,
    PolicyIndex,
)
from .util import (
    ALTERNATION_UNSAFE,
    RISK_LEVELS,
    TRUST_TIERS,
    glob_to_regex,
    is_in_time_range,
    parse_time_to_minutes,
)

_TIER_ORD = {t: i for i, t in enumerate(TRUST_TIERS)}
_RISK_ORD = {r: i for i, r in enumerate(RISK_LEVELS)}

# Plans are memoized per (agent, parent, hook); agents are bounded in real
# deployments but the key is attacker-influencable (session keys parse into
# agent ids), so cap the memo and compute un-cached beyond it.
PLAN_CACHE_MAX = 4096

ConditionFn = Callable[..., bool]


def _never(ctx, risk, tracker) -> bool:
    return False


def _always(ctx, risk, tracker) -> bool:
    return True


# ── condition compilers ──────────────────────────────────────────────
# Each mirrors its interpreter in conditions.py exactly; the interpreter is
# the contract, these are its partial evaluation against a fixed condition.


def _compile_regex(pattern: str) -> Optional[re.Pattern]:
    try:
        return re.compile(pattern)
    except re.error:
        return None


def _compile_name_match(pattern) -> Callable[[Optional[str]], bool]:
    """_match_name with globs pre-compiled: exact names become a set probe,
    wildcards a pre-built anchored regex."""
    patterns = pattern if isinstance(pattern, list) else [pattern]
    exact = frozenset(p for p in patterns if "*" not in p and "?" not in p)
    globs = tuple(glob_to_regex(p) for p in patterns if "*" in p or "?" in p)
    if not globs:
        def match_exact(name: Optional[str]) -> bool:
            return bool(name) and name in exact
        return match_exact

    def match(name: Optional[str]) -> bool:
        if not name:
            return False
        if name in exact:
            return True
        return any(g.match(name) for g in globs)
    return match


def _compile_param_matcher(matcher: dict) -> Callable[[object], bool]:
    """_match_param with the same key precedence (equals > contains > matches
    > startsWith > in) resolved at compile time."""
    if "equals" in matcher:
        expected = matcher["equals"]
        return lambda value: value == expected
    if "contains" in matcher:
        needle = matcher["contains"]
        return lambda value: isinstance(value, str) and needle in value
    if "matches" in matcher:
        rx = _compile_regex(matcher["matches"])
        if rx is None:
            return lambda value: False
        search = rx.search
        return lambda value: isinstance(value, str) and search(value) is not None
    if "startsWith" in matcher:
        prefix = matcher["startsWith"]
        return lambda value: isinstance(value, str) and value.startswith(prefix)
    if "in" in matcher:
        allowed = matcher["in"]
        return lambda value: value in allowed
    return lambda value: False


def _compile_tool(c: Condition) -> ConditionFn:
    name_match = _compile_name_match(c["name"]) if "name" in c else None
    param_checks = None
    if "params" in c:
        param_checks = tuple((key, _compile_param_matcher(m))
                             for key, m in c["params"].items())

    # Specialized shapes: most real conditions are name-only or a single
    # param matcher, and the generic loop was the hottest closure in the
    # profile.
    if param_checks is None:
        if name_match is None:
            return _always

        def fn_name(ctx, risk, tracker) -> bool:
            return name_match(ctx.tool_name)
        return fn_name
    if len(param_checks) == 1:
        key, check = param_checks[0]
        if name_match is None:
            def fn_param(ctx, risk, tracker) -> bool:
                params = ctx.tool_params
                return params is not None and check(params.get(key))
            return fn_param

        def fn_name_param(ctx, risk, tracker) -> bool:
            if not name_match(ctx.tool_name):
                return False
            params = ctx.tool_params
            return params is not None and check(params.get(key))
        return fn_name_param

    def fn(ctx, risk, tracker) -> bool:
        if name_match is not None and not name_match(ctx.tool_name):
            return False
        params = ctx.tool_params
        if params is None:
            return False
        for key, check in param_checks:
            if not check(params.get(key)):
                return False
        return True
    return fn


def _compile_time(c: Condition, time_windows: dict) -> ConditionFn:
    days = None
    if "window" in c:
        win = time_windows.get(c["window"])
        if not win:
            return _never
        start, end = parse_time_to_minutes(win["start"]), parse_time_to_minutes(win["end"])
        if start < 0 or end < 0:
            return _never
        days = win.get("days")
        lo, hi = start, end
    else:
        after, before = c.get("after"), c.get("before")
        days = c.get("days")
        if after is not None and before is not None:
            lo, hi = parse_time_to_minutes(after), parse_time_to_minutes(before)
            if lo < 0 or hi < 0:
                return _never
        elif after is not None:
            a = parse_time_to_minutes(after)
            if a < 0:
                return _never

            def fn_after(ctx, risk, tracker) -> bool:
                if ctx.time.hour * 60 + ctx.time.minute < a:
                    return False
                return not days or ctx.time.day_of_week in days
            return fn_after
        elif before is not None:
            b = parse_time_to_minutes(before)
            if b < 0:
                return _never

            def fn_before(ctx, risk, tracker) -> bool:
                if ctx.time.hour * 60 + ctx.time.minute >= b:
                    return False
                return not days or ctx.time.day_of_week in days
            return fn_before
        else:
            if not days:
                return _always

            def fn_days(ctx, risk, tracker) -> bool:
                return ctx.time.day_of_week in days
            return fn_days

    def fn_range(ctx, risk, tracker) -> bool:
        if not is_in_time_range(ctx.time.hour * 60 + ctx.time.minute, lo, hi):
            return False
        return not days or ctx.time.day_of_week in days
    return fn_range


def _compile_text_match(patterns) -> Callable[[list[str]], bool]:
    """_matches_any partially evaluated: valid regexes pre-compiled, invalid
    ones kept as substring probes (the interpreter's fallback)."""
    items = patterns if isinstance(patterns, list) else [patterns]
    compiled: list = []
    for pattern in items:
        rx = _compile_regex(pattern)
        compiled.append(rx.search if rx is not None else pattern)

    def match(texts: list[str]) -> bool:
        for probe in compiled:
            if isinstance(probe, str):
                if any(probe in t for t in texts):
                    return True
            elif any(probe(t) for t in texts):
                return True
        return False
    return match


def _compile_context(c: Condition) -> ConditionFn:
    convo_match = (_compile_text_match(c["conversationContains"])
                   if "conversationContains" in c else None)
    msg_match = (_compile_text_match(c["messageContains"])
                 if "messageContains" in c else None)
    meta_keys = None
    if "hasMetadata" in c:
        raw = c["hasMetadata"]
        meta_keys = tuple(raw if isinstance(raw, list) else [raw])
    channels = None
    if "channel" in c:
        raw = c["channel"]
        channels = frozenset(raw if isinstance(raw, list) else [raw])
    session_rx = glob_to_regex(c["sessionKey"]).match if "sessionKey" in c else None

    def fn(ctx, risk, tracker) -> bool:
        if convo_match is not None:
            convo = ctx.conversation_context or []
            if not convo or not convo_match(convo):
                return False
        if msg_match is not None:
            if not ctx.message_content or not msg_match([ctx.message_content]):
                return False
        if meta_keys is not None:
            meta = ctx.metadata or {}
            for k in meta_keys:
                if k not in meta:
                    return False
        if channels is not None:
            if not ctx.channel or ctx.channel not in channels:
                return False
        if session_rx is not None:
            if not ctx.session_key or not session_rx(ctx.session_key):
                return False
        return True
    return fn


def _compile_agent(c: Condition) -> ConditionFn:
    id_match = _compile_name_match(c["id"]) if "id" in c else None
    tiers = None
    if "trustTier" in c:
        raw = c["trustTier"]
        tiers = frozenset(raw if isinstance(raw, list) else [raw])
    min_score, max_score = c.get("minScore"), c.get("maxScore")

    def fn(ctx, risk, tracker) -> bool:
        if id_match is not None and not id_match(ctx.agent_id):
            return False
        agent = ctx.trust.agent
        if tiers is not None and agent.tier not in tiers:
            return False
        if min_score is not None and agent.score < min_score:
            return False
        if max_score is not None and agent.score > max_score:
            return False
        return True
    return fn


def _compile_risk(c: Condition) -> ConditionFn:
    min_ord = _RISK_ORD.get(c["minRisk"], 0) if "minRisk" in c else None
    max_ord = _RISK_ORD.get(c["maxRisk"], 0) if "maxRisk" in c else None

    def fn(ctx, risk, tracker) -> bool:
        current = _RISK_ORD.get(risk.level, 0)
        if min_ord is not None and current < min_ord:
            return False
        if max_ord is not None and current > max_ord:
            return False
        return True
    return fn


def _compile_frequency(c: Condition) -> ConditionFn:
    window, max_count = c["windowSeconds"], c["maxCount"]
    scope = c.get("scope", "agent")

    def fn(ctx, risk, tracker) -> bool:
        return tracker.count(window, scope, ctx.agent_id, ctx.session_key) >= max_count
    return fn


def _is_single_param_tool(sub) -> bool:
    return (isinstance(sub, dict) and sub.get("type") == "tool"
            and isinstance(sub.get("params"), dict) and len(sub["params"]) == 1)


def _compile_any(c: Condition, time_windows: dict) -> ConditionFn:
    conditions = c.get("conditions", [])
    # Fused shape: an OR made entirely of single-param tool matchers
    # (optionally name-gated — the builtin credential guard is 9 param
    # matchers, the production safeguard 3 name+param ones) collapses into
    # one loop over (name_match, key, check) triples — no nested closure
    # hops. Only applied when EVERY sub qualifies, so evaluation order is
    # preserved exactly (the matchers are pure, but a malformed later sub
    # must still only be reached when the earlier ones failed, as in the
    # interpreter).
    if conditions and all(_is_single_param_tool(sub) for sub in conditions):
        checks = tuple(
            (_compile_name_match(sub["name"]) if "name" in sub else None,
             key, _compile_param_matcher(matcher))
            for sub in conditions
            for key, matcher in sub["params"].items())

        def fn_fused(ctx, risk, tracker) -> bool:
            params = ctx.tool_params
            if params is None:
                return False
            for name_match, key, check in checks:
                if name_match is not None and not name_match(ctx.tool_name):
                    continue
                if check(params.get(key)):
                    return True
            return False
        return fn_fused

    # Unknown sub-types never fire in the interpreter's OR; dropping them
    # compiles to the same truth table.
    subs = tuple(compile_condition(sub, time_windows)
                 for sub in conditions
                 if sub.get("type") in _COMPILERS)
    if not subs:
        return _never

    def fn(ctx, risk, tracker) -> bool:
        for sub in subs:
            if sub(ctx, risk, tracker):
                return True
        return False
    return fn


def _compile_not(c: Condition, time_windows: dict) -> ConditionFn:
    sub = c.get("condition")
    if not sub or sub.get("type") not in _COMPILERS:
        return _always  # interpreter: missing/unknown inner condition → True
    inner = compile_condition(sub, time_windows)

    def fn(ctx, risk, tracker) -> bool:
        return not inner(ctx, risk, tracker)
    return fn


_COMPILERS = {
    "tool": lambda c, tw: _compile_tool(c),
    "time": _compile_time,
    "context": lambda c, tw: _compile_context(c),
    "agent": lambda c, tw: _compile_agent(c),
    "risk": lambda c, tw: _compile_risk(c),
    "frequency": lambda c, tw: _compile_frequency(c),
    "any": _compile_any,
    "not": _compile_not,
}

_ORACLE_EVALUATORS = create_condition_evaluators()


def _interp_fallback(c: Condition, time_windows: dict) -> ConditionFn:
    """Defer a condition the compiler cannot handle to the interpreter —
    correctness degrades to the oracle, never past it."""
    fn = _ORACLE_EVALUATORS.get(c.get("type"))
    if fn is None:
        return _never

    def fallback(ctx, risk, tracker) -> bool:
        deps = ConditionDeps(regex_cache={}, time_windows=time_windows,
                             risk=risk, frequency_tracker=tracker,
                             evaluators=_ORACLE_EVALUATORS)
        return fn(c, ctx, deps)
    return fallback


def iter_condition_patterns(c: Condition) -> Iterator[str]:
    """Every regex-like string a condition can hand to ``re`` at eval time:
    tool-param ``matches`` values and context ``messageContains``/
    ``conversationContains`` items (regex-or-substring semantics — invalid
    regexes degrade to substring probes and are harmless). ``sessionKey``
    and name globs compile through ``glob_to_regex`` (escaped, bounded) and
    are safe by construction."""
    if not isinstance(c, dict):
        return
    params = c.get("params")
    if isinstance(params, dict):
        for matcher in params.values():
            if isinstance(matcher, dict) and isinstance(matcher.get("matches"), str):
                yield matcher["matches"]
    for key in ("messageContains", "conversationContains"):
        raw = c.get(key)
        for pattern in (raw if isinstance(raw, list) else [raw] if raw else []):
            if isinstance(pattern, str):
                yield pattern
    for sub in c.get("conditions") or ():
        yield from iter_condition_patterns(sub)
    inner = c.get("condition")
    if inner:
        yield from iter_condition_patterns(inner)


def iter_policy_patterns(policy: Policy) -> Iterator[str]:
    for rule in policy.get("rules") or ():
        for c in rule.get("conditions") or ():
            yield from iter_condition_patterns(c)


def condition_unsafe(c: Condition) -> bool:
    """True when any regex in the condition screens as ReDoS-catastrophic
    (analysis.redos). Such conditions are DEMOTED: evaluated by the
    interpreter oracle instead of compiled into closures or prefilter
    banks, so the verdict is unchanged while the pattern stays out of the
    per-request compiled path and visible in ``pattern_reports()``."""
    return any(not pattern_safe(p) for p in iter_condition_patterns(c))


def compile_condition(c: Condition, time_windows: dict) -> ConditionFn:
    compiler = _COMPILERS.get(c.get("type"))
    if compiler is None:
        return _never  # unknown type fails the rule (deny-safe), as interp
    if condition_unsafe(c):
        return _interp_fallback(c, time_windows)
    try:
        return compiler(c, time_windows)
    except Exception:  # noqa: BLE001 — malformed condition: let the oracle decide
        return _interp_fallback(c, time_windows)


# ── compiled policies & rules ────────────────────────────────────────


class CompiledRule:
    __slots__ = ("rule_id", "min_ord", "max_ord", "cond_fns", "effect", "controls")

    def __init__(self, rule: dict, policy: Policy, time_windows: dict):
        self.rule_id = rule.get("id", "?")
        # Falsy min/maxTrust is skipped by the interpreter's truthiness check.
        self.min_ord = _TIER_ORD.get(rule["minTrust"], 0) if rule.get("minTrust") else None
        self.max_ord = _TIER_ORD.get(rule["maxTrust"], 0) if rule.get("maxTrust") else None
        self.cond_fns = tuple(compile_condition(c, time_windows)
                              for c in rule.get("conditions", []))
        # dict.get default, NOT `or`: an explicit null effect must surface
        # downstream exactly as the interpreter's would.
        self.effect = rule["effect"] if "effect" in rule else {"action": "allow"}
        self.controls = tuple(policy.get("controls") or ())


class CompiledPolicy:
    __slots__ = ("policy_id", "priority", "specificity", "exclude_agents",
                 "channels", "rules", "prefilter_key", "prefilter_patterns")

    def __init__(self, policy: Policy, time_windows: dict):
        scope = policy.get("scope", {})
        self.policy_id = policy["id"]
        self.priority = policy.get("priority") or 0
        self.specificity = policy_specificity(policy)
        self.exclude_agents = frozenset(scope.get("excludeAgents") or ())
        channels = scope.get("channels")
        self.channels = frozenset(channels) if channels else None
        self.rules = tuple(CompiledRule(r, policy, time_windows)
                           for r in policy.get("rules", []))
        self.prefilter_key, self.prefilter_patterns = _policy_prefilter(policy)


def _rule_regex_requirements(rule: dict) -> dict[str, str]:
    """{param_key: pattern} for every top-level AND-ed tool condition of the
    rule that demands ``params[key] matches pattern``. A rule can only fire
    when each of these regexes matches, so a proven non-match anywhere lets
    the whole rule be skipped."""
    out: dict[str, str] = {}
    for cond in rule.get("conditions", []):
        if not isinstance(cond, dict) or cond.get("type") != "tool":
            continue
        params = cond.get("params")
        if not isinstance(params, dict):
            continue
        for key, matcher in params.items():
            if (isinstance(matcher, dict) and isinstance(matcher.get("matches"), str)
                    # _match_param precedence: equals/contains shadow
                    # "matches", so the regex is only a NECESSARY condition
                    # (bank-miss-skippable) when neither is present.
                    and "equals" not in matcher and "contains" not in matcher
                    and key not in out
                    and _compile_regex(matcher["matches"]) is not None
                    and not ALTERNATION_UNSAFE.search(matcher["matches"])
                    # A ReDoS-catastrophic member must never ride a combined
                    # bank: the bank runs on EVERY evaluation, which is
                    # exactly the amplification an attacker wants.
                    and pattern_safe(matcher["matches"])):
                out[key] = matcher["matches"]
    return out


def _policy_prefilter(policy: Policy) -> tuple[Optional[str], tuple]:
    """(key, patterns) when EVERY rule of the policy requires a regex match
    on the same tool param — such a policy can be skipped entirely when the
    plan's combined pattern bank for that key misses."""
    rules = policy.get("rules") or []
    if not rules:
        return None, ()
    per_rule = [_rule_regex_requirements(r) for r in rules]
    common = set(per_rule[0])
    for req in per_rule[1:]:
        common &= set(req)
    if not common:
        return None, ()
    key = sorted(common)[0]
    return key, tuple(req[key] for req in per_rule)


class Plan:
    """A fully resolved (agent, parent, hook) evaluation plan.

    ``banks`` is the prefilter bank set: for each tool-param key where ≥2
    member policies are regex-gated, one alternation-combined pattern. A bank
    MISS (param absent / not a string / combined pattern unmatched) proves no
    member pattern matches, so every member policy is skipped with a single
    scan — the Hyperscan-style prefilter the AOT playbook suggests. A bank
    hit falls back to the policies' own compiled conditions, so hits cost one
    extra scan and misses (the common case for deny-lists) replace N regex
    policies with one."""

    __slots__ = ("entries", "banks")

    def __init__(self, entries: tuple, banks: tuple):
        # entries: flat per-policy tuples — (bank_key | None, channels | None,
        # rules) with rules = ((min_ord, max_ord, cond_fns, policy_id,
        # rule_id, effect, controls), ...). Flat tuples instead of attribute
        # probes: the evaluation loop runs for every agent action.
        self.entries = entries
        self.banks = banks      # ((key, combined_search), ...)


def _build_plan(policies: list) -> Plan:
    # Bank membership is a property of the PLAN (compiled policies are shared
    # across plans), so it lives in the per-plan entries, not on the policy.
    by_key: dict[str, list] = {}
    for cp in policies:
        if cp.prefilter_key is not None:
            by_key.setdefault(cp.prefilter_key, []).append(cp)
    banks = []
    banked: set[int] = set()
    for key, members in by_key.items():
        if len(members) < 2:
            continue  # a one-member bank just doubles that policy's regex work
        patterns: list[str] = []
        for cp in members:
            patterns.extend(cp.prefilter_patterns)
        try:
            combined = re.compile("|".join(f"(?:{p})" for p in dict.fromkeys(patterns)))
        except re.error:
            continue
        banks.append((key, combined.search))
        banked.update(id(cp) for cp in members)
    entries = tuple(
        (cp.prefilter_key if id(cp) in banked else None,
         cp.channels,
         tuple((cr.min_ord, cr.max_ord, cr.cond_fns, cp.policy_id,
                cr.rule_id, cr.effect, cr.controls) for cr in cp.rules))
        for cp in policies)
    return Plan(entries, tuple(banks))


def evaluate_plan(plan: Plan, ctx: EvaluationContext, risk, tracker) -> EvalResult:
    """Compiled mirror of PolicyEvaluator.evaluate: the plan is already
    scope-filtered (agents/excludeAgents/hooks) and sorted; only channels,
    trust gates, and conditions remain per call."""
    matches: list[MatchedPolicy] = []
    sess_ord = _TIER_ORD.get(ctx.trust.session.tier, 0)
    channel = ctx.channel
    bank_miss = None
    if plan.banks:
        params = ctx.tool_params
        bank_miss = {}
        for key, search in plan.banks:
            value = params.get(key) if params is not None else None
            bank_miss[key] = not (isinstance(value, str)
                                  and search(value) is not None)
    append = matches.append
    for pk, channels, rules in plan.entries:
        if pk is not None and bank_miss[pk]:
            continue
        if channels is not None and (not channel or channel not in channels):
            continue
        for min_ord, max_ord, cond_fns, policy_id, rule_id, effect, controls in rules:
            if min_ord is not None and sess_ord < min_ord:
                continue
            if max_ord is not None and sess_ord > max_ord:
                continue
            matched = True
            for fn in cond_fns:
                if not fn(ctx, risk, tracker):
                    matched = False
                    break
            if matched:
                append(MatchedPolicy(policy_id, rule_id, effect, list(controls)))
                break
    return aggregate_matches(matches)


class PolicyPlanner:
    """Compiles a PolicyIndex into per-(agent, parent, hook) plans.

    ``plan_for`` replicates policy_loader.policies_for + CrossAgentManager.
    resolve_effective_policies + the evaluator's static scope filter + sort,
    all folded into one memoized tuple. Stable sort commutes with filtering,
    so pre-sorting the filtered candidates is order-identical to the
    interpreter's filter-then-sort.
    """

    def __init__(self, index: PolicyIndex, time_windows: Optional[dict] = None):
        self.index = index
        self.time_windows = time_windows or {}
        self._compiled: dict[int, CompiledPolicy] = {}
        self._plans: dict[tuple, tuple] = {}
        # ReDoS screening reports, filled as policies compile: each entry is
        # {"policyId", "pattern", "issue"} — surfaced via
        # engine.get_status()["patternSafety"] and the sitrep collector.
        self._unsafe: list[dict] = []

    def _compile(self, policy: Policy) -> CompiledPolicy:
        cp = self._compiled.get(id(policy))
        if cp is None:
            cp = CompiledPolicy(policy, self.time_windows)
            self._compiled[id(policy)] = cp
            for pattern in dict.fromkeys(iter_policy_patterns(policy)):
                issue = unsafe_report(pattern)
                if issue:
                    self._unsafe.append({"policyId": policy.get("id", "?"),
                                         "pattern": pattern, "issue": issue})
        return cp

    def pattern_reports(self) -> list[dict]:
        """Unsafe patterns found while compiling (conditions carrying them
        run on the interpreter oracle — same verdicts, no compiled-path
        amplification)."""
        return list(self._unsafe)

    def _candidates(self, agent_id: str, hook: str) -> list[Policy]:
        # policy_loader.policies_for, inlined (agent-scoped ∪ unscoped,
        # filtered by hook scope).
        out = []
        for policy in self.index.by_agent.get(agent_id, []) + self.index.unscoped:
            hooks = policy.get("scope", {}).get("hooks")
            if hooks and hook not in hooks:
                continue
            out.append(policy)
        return out

    def plan_for(self, agent_id: str, hook: str,
                 parent_agent_id: Optional[str] = None) -> tuple[Plan, tuple]:
        """→ (Plan, inherited_policy_ids); immutable, safe to share."""
        key = (agent_id, parent_agent_id, hook)
        cached = self._plans.get(key)
        if cached is not None:
            return cached
        merged = self._candidates(agent_id, hook)
        inherited_ids: list[str] = []
        if parent_agent_id is not None:
            seen = {p["id"] for p in merged}
            for policy in self._candidates(parent_agent_id, hook):
                if policy["id"] not in seen:
                    merged.append(policy)
                    seen.add(policy["id"])
                    inherited_ids.append(policy["id"])
        compiled = [self._compile(p) for p in merged
                    if agent_id not in self._compile(p).exclude_agents]
        compiled.sort(key=lambda cp: (-cp.priority, -cp.specificity))
        result = (_build_plan(compiled), tuple(inherited_ids))
        if len(self._plans) < PLAN_CACHE_MAX:
            self._plans[key] = result
        return result
