"""Risk assessment: 5 weighted factors → 0-100 score → level
(reference: governance/src/risk-assessor.ts:10-99)."""

from __future__ import annotations

from .types import EvaluationContext, RiskAssessment, RiskFactor
from .util import clamp

DEFAULT_TOOL_RISK = {
    "gateway": 95, "cron": 90, "elevated": 95,
    "exec": 70, "write": 65, "edit": 60,
    "sessions_spawn": 45, "sessions_send": 50,
    "browser": 40, "message": 40,
    "read": 10, "memory_search": 5, "memory_get": 5,
    "web_search": 15, "web_fetch": 20, "image": 10, "canvas": 15,
}
UNKNOWN_TOOL_RISK = 30


def score_to_risk_level(score: float) -> str:
    if score <= 25:
        return "low"
    if score <= 50:
        return "medium"
    if score <= 75:
        return "high"
    return "critical"


def _is_external_target(ctx: EvaluationContext) -> bool:
    if ctx.message_to:
        return True
    params = ctx.tool_params
    if not params:
        return False
    host = params.get("host")
    if isinstance(host, str) and host != "sandbox":
        return True
    return params.get("elevated") is True


class RiskAssessor:
    def __init__(self, tool_risk_overrides: dict | None = None):
        self.overrides = tool_risk_overrides or {}
        # (raw risk, description) memo — both are pure functions of the tool
        # name, and the f-string was being rebuilt on every evaluation.
        self._tool_memo: dict = {}

    def _tool_risk(self, tool_name) -> int:
        if not tool_name:
            return UNKNOWN_TOOL_RISK
        if tool_name in self.overrides:
            return self.overrides[tool_name]
        return DEFAULT_TOOL_RISK.get(tool_name, UNKNOWN_TOOL_RISK)

    def _tool_factor(self, tool_name) -> tuple[int, str]:
        memo = self._tool_memo.get(tool_name)
        if memo is None:
            raw = self._tool_risk(tool_name)
            if len(self._tool_memo) > 4096:
                self._tool_memo.clear()
            memo = self._tool_memo[tool_name] = (
                raw, f"Tool {tool_name or 'unknown'} risk={raw}")
        return memo

    # Interned constant factors: their (weight, value, description) never
    # varies, and five dataclass constructions per evaluation showed up in
    # the enforcement profile. Factors are read-only by contract (the
    # assessor owns them; consumers only read attributes).
    _OFF_HOURS = RiskFactor("time_of_day", 15, 15, "Off-hours operation")
    _BUSINESS = RiskFactor("time_of_day", 15, 0, "Business hours")
    _EXTERNAL = RiskFactor("target_scope", 20, 20, "External target")
    _INTERNAL = RiskFactor("target_scope", 20, 0, "Internal target")

    def assess(self, ctx: EvaluationContext, frequency_tracker) -> RiskAssessment:
        tool_raw, tool_desc = self._tool_factor(ctx.tool_name)
        is_off_hours = ctx.time.hour < 8 or ctx.time.hour >= 23
        recent = frequency_tracker.count(60, "agent", ctx.agent_id, ctx.session_key)
        external = _is_external_target(ctx)
        session_score = ctx.trust.session.score
        factors = [
            RiskFactor("tool_sensitivity", 30, (tool_raw / 100) * 30, tool_desc),
            self._OFF_HOURS if is_off_hours else self._BUSINESS,
            RiskFactor("trust_deficit", 20, ((100 - session_score) / 100) * 20,
                       f"Trust score {session_score}/100"),
            RiskFactor("frequency", 15, min(recent / 20, 1) * 15,
                       f"{recent} actions in last 60s"),
            self._EXTERNAL if external else self._INTERNAL,
        ]
        total = clamp(factors[0].value + factors[1].value + factors[2].value
                      + factors[3].value + factors[4].value, 0, 100)
        return RiskAssessment(level=score_to_risk_level(total), score=round(total), factors=factors)
