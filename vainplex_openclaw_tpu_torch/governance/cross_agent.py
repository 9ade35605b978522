"""Cross-agent trust ceilings and policy inheritance
(reference: governance/src/cross-agent.ts:28-140).

Parent↔child session graph via explicit registration (``sessions_spawn``
detection) with session-key-parse fallback; a child's effective trust is
capped at its parent's agent score; child inherits the parent's policies one
level deep, deduplicated by policy id.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Callable, Optional

from .policy_loader import policies_for
from .types import CrossAgentInfo, EvalTrust, EvaluationContext, PolicyIndex, TrustSnapshot
from .trust import TrustManager
from .util import extract_agent_id, extract_parent_session_key, is_sub_agent, score_to_tier


@dataclass
class AgentRelationship:
    parent_agent_id: str
    parent_session_key: str
    child_agent_id: str
    child_session_key: str
    created_at: float


class CrossAgentManager:
    def __init__(self, trust_manager: TrustManager, logger,
                 clock: Callable[[], float] = time.time):
        self.relationships: dict[str, AgentRelationship] = {}
        self.trust_manager = trust_manager
        self.logger = logger
        self.clock = clock

    def register_relationship(self, parent_session_key: str, child_session_key: str) -> None:
        rel = AgentRelationship(
            parent_agent_id=extract_agent_id(parent_session_key),
            parent_session_key=parent_session_key,
            child_agent_id=extract_agent_id(child_session_key),
            child_session_key=child_session_key,
            created_at=self.clock(),
        )
        self.relationships[child_session_key] = rel
        self.logger.info(f"Registered sub-agent: {rel.child_agent_id} → parent {rel.parent_agent_id}")

    def remove_relationship(self, child_session_key: str) -> None:
        self.relationships.pop(child_session_key, None)

    def get_parent(self, child_session_key: str) -> Optional[AgentRelationship]:
        explicit = self.relationships.get(child_session_key)
        if explicit is not None:
            return explicit
        if not is_sub_agent(child_session_key):
            return None
        parent_key = extract_parent_session_key(child_session_key)
        if not parent_key:
            return None
        return AgentRelationship(
            parent_agent_id=extract_agent_id(parent_key),
            parent_session_key=parent_key,
            child_agent_id=extract_agent_id(child_session_key),
            child_session_key=child_session_key,
            created_at=0.0,
        )

    def get_children(self, parent_session_key: str) -> list[AgentRelationship]:
        return [r for r in self.relationships.values()
                if r.parent_session_key == parent_session_key]

    def compute_trust_ceiling(self, session_key: str) -> float:
        parent = self.get_parent(session_key)
        if parent is None:
            return math.inf
        return self.trust_manager.get_agent_trust(parent.parent_agent_id)["score"]

    def enrich_context(self, ctx: EvaluationContext) -> EvaluationContext:
        parent = self.get_parent(ctx.session_key)
        if parent is None:
            return ctx
        ceiling = self.compute_trust_ceiling(ctx.session_key)
        capped_session = min(ctx.trust.session.score, ceiling)
        capped_agent = min(ctx.trust.agent.score, ceiling)
        ctx.trust = EvalTrust(
            agent=TrustSnapshot(capped_agent, score_to_tier(capped_agent)),
            session=TrustSnapshot(capped_session, score_to_tier(capped_session)),
        )
        ctx.cross_agent = CrossAgentInfo(
            parent_agent_id=parent.parent_agent_id,
            parent_session_key=parent.parent_session_key,
            inherited_policy_ids=[],
            trust_ceiling=ceiling,
        )
        return ctx

    def resolve_effective_policies(self, ctx: EvaluationContext, index: PolicyIndex) -> list:
        own = policies_for(index, ctx.agent_id, ctx.hook)
        parent = self.get_parent(ctx.session_key)
        if parent is None:
            return own
        inherited = policies_for(index, parent.parent_agent_id, ctx.hook)
        seen = {p["id"] for p in own}
        merged = list(own)
        for policy in inherited:
            if policy["id"] not in seen:
                merged.append(policy)
                seen.add(policy["id"])
                if ctx.cross_agent is not None:
                    ctx.cross_agent.inherited_policy_ids.append(policy["id"])
        return merged

    def graph_summary(self) -> dict:
        return {
            "agent_count": len({r.child_agent_id for r in self.relationships.values()}),
            "relationships": [vars(r) for r in self.relationships.values()],
        }
