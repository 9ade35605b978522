"""Governance data model (reference: governance/src/types.ts).

Policies/rules/conditions stay plain dicts (they are user-authored JSON);
runtime objects are dataclasses.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from .util import TimeContext

# A policy is a dict:
# {
#   "id": str, "name": str, "description": str, "version": str,
#   "enabled": bool (default True),
#   "scope": {"agents": [..], "excludeAgents": [..], "channels": [..], "hooks": [..]},
#   "priority": int, "controls": ["A.8.11", ...],
#   "rules": [{"id": str, "conditions": [<condition>...],
#              "minTrust"/"maxTrust": tier,
#              "effect": {"action": "allow"|"deny"|"audit"|"2fa", "reason": str}}]
# }
# A condition is {"type": "tool"|"time"|"context"|"agent"|"risk"|"frequency"|"any"|"not", ...}

Policy = dict
Rule = dict
Condition = dict


# slots=True on the per-evaluation runtime objects: they are constructed on
# every enforcement call (EvalTrust + two snapshots per context), and slotted
# dataclasses build measurably faster and probe attributes cheaper.
@dataclass(slots=True)
class TrustSnapshot:
    score: float
    tier: str


@dataclass(slots=True)
class EvalTrust:
    agent: TrustSnapshot
    session: TrustSnapshot


@dataclass(slots=True)
class CrossAgentInfo:
    parent_agent_id: str
    parent_session_key: str
    inherited_policy_ids: list[str]
    trust_ceiling: float


@dataclass(slots=True)
class EvaluationContext:
    agent_id: str
    session_key: str
    hook: str
    trust: EvalTrust
    time: TimeContext
    tool_name: Optional[str] = None
    tool_params: Optional[dict] = None
    message_content: Optional[str] = None
    message_to: Optional[str] = None
    channel: Optional[str] = None
    conversation_context: list[str] = field(default_factory=list)
    metadata: dict = field(default_factory=dict)
    cross_agent: Optional[CrossAgentInfo] = None


@dataclass(slots=True)
class RiskFactor:
    name: str
    weight: float
    value: float
    description: str


@dataclass(slots=True)
class RiskAssessment:
    level: str
    score: int
    factors: list[RiskFactor]


@dataclass(slots=True)
class MatchedPolicy:
    policy_id: str
    rule_id: str
    effect: dict
    controls: list[str] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {"policy_id": self.policy_id, "rule_id": self.rule_id,
                "effect": self.effect, "controls": self.controls}


@dataclass
class EvalResult:
    action: str  # allow | deny | 2fa
    reason: str
    matches: list[MatchedPolicy]
    risk: Optional[RiskAssessment] = None
    audit_only: bool = False  # action=="allow" but an audit rule matched


@dataclass
class ConditionDeps:
    """Dependencies condition evaluators draw on."""

    regex_cache: dict
    time_windows: dict
    risk: Any
    frequency_tracker: Any
    evaluators: dict = field(default_factory=dict)


@dataclass
class PolicyIndex:
    all: list[Policy]
    by_hook: dict[str, list[Policy]]
    by_agent: dict[str, list[Policy]]
    unscoped: list[Policy]  # policies with no agent scoping (apply to all)
    # Distinct policy ids, computed once at index build — status calls were
    # rebuilding this set per call.
    unique_policy_count: int = 0
