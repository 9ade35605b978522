"""Policy evaluation: scope filter → priority+specificity sort → per-rule
trust gates → conditions → aggregate with precedence deny > 2fa > audit >
allow (reference: governance/src/policy-evaluator.ts:18-146)."""

from __future__ import annotations

from .conditions import evaluate_conditions
from .types import ConditionDeps, EvalResult, EvaluationContext, MatchedPolicy, Policy
from .util import is_tier_at_least, is_tier_at_most


def matches_scope(policy: Policy, ctx: EvaluationContext) -> bool:
    scope = policy.get("scope", {})
    if ctx.agent_id in (scope.get("excludeAgents") or []):
        return False
    channels = scope.get("channels")
    if channels:
        if not ctx.channel or ctx.channel not in channels:
            return False
    return True


def policy_specificity(policy: Policy) -> int:
    scope = policy.get("scope", {})
    score = 0
    if scope.get("agents"):
        score += 10
    if scope.get("channels"):
        score += 5
    if scope.get("hooks"):
        score += 3
    return score


def sort_policies(policies: list[Policy]) -> list[Policy]:
    return sorted(policies, key=lambda p: (-(p.get("priority") or 0), -policy_specificity(p)))


def aggregate_matches(matches: list[MatchedPolicy]) -> EvalResult:
    deny_reason = twofa_reason = ""
    has_deny = has_2fa = has_audit = False
    for m in matches:
        action = m.effect.get("action")
        if action == "deny":
            has_deny = True
            if not deny_reason:
                deny_reason = m.effect.get("reason") or ""
        elif action == "2fa":
            has_2fa = True
            if not twofa_reason:
                twofa_reason = m.effect.get("reason") or ""
        elif action == "audit":
            has_audit = True
    if has_deny:
        return EvalResult("deny", deny_reason or "Denied by governance policy", matches)
    if has_2fa:
        return EvalResult("2fa", twofa_reason or "Requires 2FA approval", matches)
    if has_audit:
        return EvalResult("allow", "Allowed with audit logging", matches, audit_only=True)
    reason = "Allowed by governance policy" if matches else "No matching policies"
    return EvalResult("allow", reason, matches)


class PolicyEvaluator:
    def evaluate(self, ctx: EvaluationContext, policies: list[Policy],
                 deps: ConditionDeps) -> EvalResult:
        applicable = sort_policies([p for p in policies if matches_scope(p, ctx)])
        matches = []
        for policy in applicable:
            match = self._match_policy(policy, ctx, deps)
            if match is not None:
                matches.append(match)
        return aggregate_matches(matches)

    def _match_policy(self, policy: Policy, ctx: EvaluationContext,
                      deps: ConditionDeps):
        for rule in policy.get("rules", []):
            # Per-rule trust-tier gates check the *session* tier (the
            # reference's evaluator, policy-evaluator.ts:128-133): a rule can
            # require minTrust for its effect to apply at all.
            if rule.get("minTrust") and not is_tier_at_least(ctx.trust.session.tier, rule["minTrust"]):
                continue
            if rule.get("maxTrust") and not is_tier_at_most(ctx.trust.session.tier, rule["maxTrust"]):
                continue
            if evaluate_conditions(rule.get("conditions", []), ctx, deps):
                return MatchedPolicy(
                    policy_id=policy["id"],
                    rule_id=rule.get("id", "?"),
                    effect=rule.get("effect", {"action": "allow"}),
                    controls=list(policy.get("controls") or []),
                )
        return None
