"""GovernanceEngine: the enforcement orchestrator
(reference: governance/src/engine.ts).

Pipeline per evaluation (engine.ts:210-267): cross-agent enrich → frequency
record → risk assess → effective policies (own + inherited) → policy
evaluate → trust learning on deny (except time-based denials — night-mode
blocks must not start a trust death spiral for scheduled agents) → audit.
Tracks a running mean of evaluation µs (the reference's only continuously
measured metric, engine.ts:535-544).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..storage.journal import get_journal, journal_settings
from ..utils.stage_timer import StageTimer
from .audit import AuditTrail
from .cross_agent import CrossAgentManager
from .conditions import create_condition_evaluators
from .frequency import FrequencyTracker
from .policy_evaluator import PolicyEvaluator
from .policy_loader import build_policy_index, load_policies
from .policy_plan import PolicyPlanner, evaluate_plan
from .risk import RiskAssessor
from .trust import SessionTrustManager, TrustManager
from .types import (
    ConditionDeps,
    EvalTrust,
    EvaluationContext,
    RiskAssessment,
    TrustSnapshot,
)
from .util import current_time_context, now_us

TIME_BASED_POLICY_IDS = {"builtin-night-mode"}


@dataclass
class Verdict:
    action: str
    reason: str
    risk: Optional[RiskAssessment]
    matched_policies: list
    trust: dict
    evaluation_us: int


@dataclass
class EngineStats:
    total_evaluations: int = 0
    allow_count: int = 0
    deny_count: int = 0
    avg_evaluation_us: float = 0.0

    def to_dict(self) -> dict:
        return {
            "totalEvaluations": self.total_evaluations,
            "allowCount": self.allow_count,
            "denyCount": self.deny_count,
            "avgEvaluationUs": round(self.avg_evaluation_us, 1),
        }


class GovernanceEngine:
    def __init__(self, config: dict, workspace: str, logger,
                 clock: Callable[[], float] = time.time):
        self.config = config
        self.workspace = workspace
        self.logger = logger
        self.clock = clock

        self.regex_cache: dict = {}
        policies = load_policies(config.get("builtinPolicies", {}),
                                 config.get("policies", []), logger, self.regex_cache)
        self.policy_index = build_policy_index(policies)
        self.evaluators = create_condition_evaluators()
        self.evaluator = PolicyEvaluator()
        # Load-time compilation of the enforcement hot path. The interpretive
        # evaluator stays as the equivalence oracle; `compiledPlans: false`
        # pins an engine to it (tests/test_torch_governance.py runs both
        # and compares verdict-for-verdict).
        self.planner = (PolicyPlanner(self.policy_index, config.get("timeWindows", {}))
                        if config.get("compiledPlans", True) else None)
        self.timer = StageTimer()
        self.frequency_tracker = FrequencyTracker(clock=clock)
        self.risk_assessor = RiskAssessor(config.get("toolRiskOverrides", {}))
        self.trust_manager = TrustManager(config.get("trust", {}), workspace, logger, clock=clock)
        self.session_trust = SessionTrustManager(config.get("sessionTrust", {}),
                                                 self.trust_manager, clock=clock)
        self.cross_agent = CrossAgentManager(self.trust_manager, logger, clock=clock)
        # Shared per-workspace group-commit journal for the audit
        # trail. wall=False: the engine owns no timers and the audit trail
        # drives compaction on its legacy flush thresholds, so chaos runs
        # stay bit-reproducible (no background commit consuming fault steps).
        js = journal_settings(config)
        journal = (get_journal(workspace, js, clock=clock, wall=False,
                               logger=logger)
                   if js["enabled"] else None)
        self.journal = journal
        self.audit_trail = AuditTrail(config.get("audit", {}), workspace, logger,
                                      clock=clock, journal=journal)
        self.stats = EngineStats()
        # Enforcement flags resolved once at load — config is immutable after
        # plugin registration, and the chained dict.gets sat on every call.
        self._audit_enabled = config.get("audit", {}).get("enabled", True)
        self._trust_enabled = config.get("trust", {}).get("enabled", True)
        # TimeContext only has minute resolution, so one localtime() per
        # wall-clock second serves every evaluation in that second.
        self._time_ctx_cache: Optional[tuple] = None
        self.known_agent_ids: list[str] = []
        # Filled by the validation subsystem (output_validator) when enabled.
        self.output_validator = None

    # ── lifecycle ────────────────────────────────────────────────────

    def set_known_agents(self, agent_ids: list[str]) -> None:
        self.known_agent_ids = list(agent_ids)

    def start(self) -> None:
        self.trust_manager.load()
        for agent_id in self.known_agent_ids:
            self.trust_manager.get_agent_trust(agent_id)  # auto-creates w/ defaults
        if self.config.get("audit", {}).get("enabled", True):
            self.audit_trail.load()
        self.frequency_tracker.clear()
        self.logger.info(f"Engine started: {self.policy_count()} policies loaded")

    def stop(self) -> None:
        self.audit_trail.flush()
        self.trust_manager.flush()
        self.logger.info("Engine stopped")

    # ── context building ─────────────────────────────────────────────

    def build_context(self, hook: str, agent_id: str, session_key: str,
                      tool_name: Optional[str] = None, tool_params: Optional[dict] = None,
                      message_content: Optional[str] = None, message_to: Optional[str] = None,
                      channel: Optional[str] = None, metadata: Optional[dict] = None,
                      conversation_context: Optional[list] = None) -> EvaluationContext:
        agent = self.trust_manager.get_agent_trust(agent_id)
        session = self.session_trust.get_session_trust(session_key, agent_id)
        now_key = int(self.clock())
        cached = self._time_ctx_cache
        if cached is None or cached[0] != now_key:
            cached = (now_key,
                      current_time_context(now_key, self.config.get("timezone", "local")))
            self._time_ctx_cache = cached
        return EvaluationContext(
            agent_id=agent_id,
            session_key=session_key,
            hook=hook,
            trust=EvalTrust(
                agent=TrustSnapshot(agent["score"], agent["tier"]),
                session=TrustSnapshot(session.score, session.tier),
            ),
            time=cached[1],
            tool_name=tool_name,
            tool_params=tool_params,
            message_content=message_content,
            message_to=message_to,
            channel=channel,
            metadata=metadata or {},
            conversation_context=conversation_context or [],
        )

    # ── evaluation ───────────────────────────────────────────────────

    def evaluate(self, ctx: EvaluationContext) -> Verdict:
        start = now_us()
        try:
            verdict = self._run_pipeline(ctx, start)
        except Exception as exc:  # noqa: BLE001 — fail-open/closed per config
            self.logger.error(f"Pipeline crash: {exc}")
            return self._eval_error_verdict(exc, start)
        stats = self.stats
        stats.total_evaluations += 1
        if verdict.action == "deny":
            stats.deny_count += 1
        else:
            stats.allow_count += 1
        n = stats.total_evaluations
        stats.avg_evaluation_us = (stats.avg_evaluation_us * (n - 1)
                                   + verdict.evaluation_us) / n
        return verdict

    def _eval_error_verdict(self, exc: Exception, start: int) -> Verdict:
        fail_mode = self.config.get("failMode", "open")
        action = "allow" if fail_mode == "open" else "deny"
        return Verdict(action=action, reason=f"Governance error ({fail_mode}-fail): {exc}",
                       risk=None, matched_policies=[], trust={}, evaluation_us=now_us() - start)

    def _run_pipeline(self, ctx: EvaluationContext, start_us: int) -> Verdict:
        pc = time.perf_counter
        t0 = pc()
        ctx = self.cross_agent.enrich_context(ctx)
        t1 = pc()
        self.frequency_tracker.record(ctx.agent_id, ctx.session_key, ctx.tool_name)
        t2 = pc()
        risk = self.risk_assessor.assess(ctx, self.frequency_tracker)
        t3 = pc()
        result = self._evaluate_policies(ctx, risk)
        t4 = pc()
        elapsed = now_us() - start_us
        verdict = Verdict(
            action=result.action,
            reason=result.reason,
            risk=risk,
            matched_policies=result.matches,
            trust={"score": ctx.trust.session.score, "tier": ctx.trust.session.tier},
            evaluation_us=elapsed,
        )

        if verdict.action == "deny" and self._trust_enabled:
            time_based = any(m.policy_id in TIME_BASED_POLICY_IDS for m in result.matches
                             if m.effect.get("action") == "deny")
            if not time_based:
                self.trust_manager.record_violation(ctx.agent_id, f"Policy denial: {verdict.reason}")
                self.session_trust.apply_signal(ctx.session_key, ctx.agent_id, "policyBlock")
        t5 = pc()
        self._record_audit(ctx, verdict, risk, elapsed)
        t6 = pc()
        # One lock round-trip for the whole breakdown — the timer must not
        # tax the path it attributes.
        self.timer.add_many((("enrich", (t1 - t0) * 1000.0),
                             ("frequency", (t2 - t1) * 1000.0),
                             ("risk", (t3 - t2) * 1000.0),
                             ("evaluate", (t4 - t3) * 1000.0),
                             ("trust", (t5 - t4) * 1000.0),
                             ("audit", (t6 - t5) * 1000.0)))
        return verdict

    def _evaluate_policies(self, ctx: EvaluationContext, risk: RiskAssessment):
        if self.planner is not None:
            parent_agent_id = (ctx.cross_agent.parent_agent_id
                               if ctx.cross_agent is not None else None)
            plan, inherited = self.planner.plan_for(ctx.agent_id, ctx.hook,
                                                    parent_agent_id)
            if ctx.cross_agent is not None:
                ctx.cross_agent.inherited_policy_ids = list(inherited)
            return evaluate_plan(plan, ctx, risk, self.frequency_tracker)
        policies = self.cross_agent.resolve_effective_policies(ctx, self.policy_index)
        deps = ConditionDeps(
            regex_cache=self.regex_cache,
            time_windows=self.config.get("timeWindows", {}),
            risk=risk,
            frequency_tracker=self.frequency_tracker,
            evaluators=self.evaluators,
        )
        return self.evaluator.evaluate(ctx, policies, deps)

    def _record_audit(self, ctx: EvaluationContext, verdict: Verdict,
                      risk: RiskAssessment, elapsed_us: int) -> None:
        if not self._audit_enabled:
            return
        self.audit_trail.record(
            verdict.action, verdict.reason,
            {
                "hook": ctx.hook, "agentId": ctx.agent_id, "sessionKey": ctx.session_key,
                "channel": ctx.channel, "toolName": ctx.tool_name,
                "toolParams": ctx.tool_params, "messageContent": ctx.message_content,
                "messageTo": ctx.message_to,
            },
            {"score": ctx.trust.session.score, "tier": ctx.trust.session.tier},
            {"level": risk.level, "score": risk.score},
            verdict.matched_policies,
            elapsed_us,
        )

    # ── trust feedback (after_tool_call) ─────────────────────────────

    def record_tool_success(self, agent_id: str, session_key: str) -> None:
        if not self._trust_enabled:
            return
        self.trust_manager.record_success(agent_id)
        self.session_trust.apply_signal(session_key, agent_id, "success")

    # ── session lifecycle ────────────────────────────────────────────

    def handle_session_start(self, session_key: str, agent_id: str) -> None:
        self.session_trust.initialize_session(session_key, agent_id)

    def handle_session_end(self, session_key: str) -> None:
        self.session_trust.destroy_session(session_key)

    def register_sub_agent(self, parent_session_key: str, child_session_key: str) -> None:
        self.cross_agent.register_relationship(parent_session_key, child_session_key)

    # ── status & trust API ───────────────────────────────────────────

    def policy_count(self) -> int:
        return self.policy_index.unique_policy_count

    def get_status(self) -> dict:
        # One snapshot() instead of stages_ms()+counts(): both views come
        # from the same lock round-trip, so ms and counts attribute the
        # same traffic even while verdicts land concurrently.
        snap = self.timer.snapshot()
        pattern_reports = (self.planner.pattern_reports()
                           if self.planner is not None else [])
        return {
            "enabled": self.config.get("enabled", True),
            "policyCount": self.policy_count(),
            "trustEnabled": self.config.get("trust", {}).get("enabled", True),
            "auditEnabled": self.config.get("audit", {}).get("enabled", True),
            "failMode": self.config.get("failMode", "open"),
            "stats": self.stats.to_dict(),
            "stageMs": snap["stages_ms"],
            "stageCounts": snap["counts"],
            "stageQuantiles": snap["quantiles"],
            # Degradation must be *visible*: spilled/retained audit
            # records and flush failures ride every status read.
            "audit": self.audit_trail.stats(),
            # ReDoS screening: patterns the planner demoted to the
            # interpreter oracle. ``checked`` False = interpreter mode, no
            # planner compiled anything, so there was nothing to screen.
            "patternSafety": {"checked": self.planner is not None,
                              "unsafePatterns": pattern_reports,
                              "demoted": len(pattern_reports)},
            **({"journal": self.journal.stats()}
               if self.journal is not None else {}),
        }

    def get_trust(self, agent_id: Optional[str] = None, session_key: Optional[str] = None):
        if agent_id is None:
            return self.trust_manager.store
        agent = self.trust_manager.get_agent_trust(agent_id)
        if session_key:
            session = self.session_trust.get_session_trust(session_key, agent_id)
        else:
            session = None
        return {"agent": agent, "session": vars(session) if session else None}

    def set_trust(self, agent_id: str, score: float) -> None:
        self.trust_manager.set_score(agent_id, score)

