"""Trust: persistent per-agent scores and ephemeral per-session scores.

Reference semantics preserved exactly (governance/src/trust-manager.ts,
session-trust-manager.ts):

- score = clamp(min(ageDays·0.5, 20) + min(successes·0.1, 30) − violations·2
  + min(cleanStreak·0.3, 20) + manualAdjustment, 0, 100)
- tiers: untrusted <20 ≤ restricted <40 ≤ standard <60 ≤ trusted <80 ≤ elevated
- decay on inactivity (score·rate, floored), tier lock, score floor
- migrations: drop the misattributed "unknown" agent; backfill
  manualAdjustment for fresh agents whose default score would vanish on
  first recalculate
- session trust seeded at agentScore·seedFactor, ceiling agentScore·
  ceilingFactor, clean-streak bonus, LRU eviction above 500 sessions
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from functools import lru_cache
from pathlib import Path
from typing import Callable, Optional

from ..storage.atomic import read_json, write_json_atomic
from .util import clamp, score_to_tier


@lru_cache(maxsize=4096)
def _parse_iso_cached(text: str) -> Optional[float]:
    import calendar

    try:
        return calendar.timegm(time.strptime(text[:19], "%Y-%m-%dT%H:%M:%S"))
    except (ValueError, TypeError):
        return None

DEFAULT_WEIGHTS = {
    "agePerDay": 0.5, "ageMax": 20,
    "successPerAction": 0.1, "successMax": 30,
    "violationPenalty": -2,
    "cleanStreakPerDay": 0.3, "cleanStreakMax": 20,
}

DEFAULT_TRUST_CONFIG = {
    "defaults": {"*": 10},
    "weights": DEFAULT_WEIGHTS,
    "decay": {"enabled": True, "inactivityDays": 7, "rate": 0.9},
    "persistIntervalSeconds": 60,
    "maxHistoryPerAgent": 50,
}

MAX_SESSIONS = 500

DEFAULT_SESSION_TRUST_CONFIG = {
    "enabled": True,
    "seedFactor": 0.8,
    "ceilingFactor": 1.0,
    "signals": {
        "success": 1,
        "policyBlock": -5,
        "credentialViolation": -15,
        "cleanStreakThreshold": 10,
        "cleanStreakBonus": 2,
    },
}


def compute_score(signals: dict, weights: dict) -> float:
    base = min(signals["ageDays"] * weights["agePerDay"], weights["ageMax"])
    success = min(signals["successCount"] * weights["successPerAction"], weights["successMax"])
    violations = signals["violationCount"] * weights["violationPenalty"]
    streak = min(signals["cleanStreak"] * weights["cleanStreakPerDay"], weights["cleanStreakMax"])
    return clamp(base + success + violations + streak + signals["manualAdjustment"], 0, 100)


def _fresh_signals(manual: float = 0.0) -> dict:
    return {"successCount": 0, "violationCount": 0, "ageDays": 0,
            "cleanStreak": 0, "manualAdjustment": manual}


class TrustManager:
    """Persistent agent trust, stored at ``<workspace>/governance/trust.json``."""

    def __init__(self, config: dict, workspace: str | Path, logger,
                 clock: Callable[[], float] = time.time):
        from ..config.loader import deep_merge

        self.config = deep_merge(DEFAULT_TRUST_CONFIG, config or {})
        self.weights = self.config["weights"]
        self.path = Path(workspace) / "governance" / "trust.json"
        self.logger = logger
        self.clock = clock
        self._iso_sec = -1
        self._iso_text = ""
        self.store: dict = {"version": 1, "updated": self._iso(), "agents": {}}
        self.dirty = False

    def _iso(self) -> str:
        # Per-second cache: a policy denial re-stamps three timestamps
        # (history event, lastEvaluation, store update) on the enforcement
        # hot path, and gmtime+format was being paid for each.
        sec = int(self.clock())
        if self._iso_sec != sec:
            t = time.gmtime(sec)
            self._iso_sec = sec
            self._iso_text = (f"{t.tm_year:04d}-{t.tm_mon:02d}-{t.tm_mday:02d}T"
                              f"{t.tm_hour:02d}:{t.tm_min:02d}:{t.tm_sec:02d}Z")
        return self._iso_text

    def _parse_iso(self, text: str) -> float:
        # `created` is parsed on every _recalculate (strptime was ~14% of a
        # deny-path evaluation); the value for a given string never changes.
        parsed = _parse_iso_cached(text)
        return parsed if parsed is not None else self.clock()

    # ── lifecycle ────────────────────────────────────────────────────

    def load(self) -> None:
        data = read_json(self.path)
        if isinstance(data, dict) and isinstance(data.get("agents"), dict):
            self.store = data
            self._apply_decay()
            self._migrate_unknown_agent()
            self._migrate_default_scores()
            self._refresh_age_days()
            self.logger.info(f"Trust store loaded: {len(self.store['agents'])} agents")
        elif self.path.exists():
            self.logger.error(f"Failed to load trust store at {self.path}")

    def flush(self) -> None:
        if not self.dirty:
            return
        try:
            self.store["updated"] = self._iso()
            write_json_atomic(self.path, self.store)
            self.dirty = False
        except OSError as exc:
            self.logger.error(f"Failed to flush trust store: {exc}")

    # ── migrations & maintenance ─────────────────────────────────────

    def _refresh_age_days(self) -> None:
        now = self.clock()
        for agent in self.store["agents"].values():
            created = self._parse_iso(agent.get("created", ""))
            agent["signals"]["ageDays"] = int((now - created) // 86400)

    def _migrate_default_scores(self) -> None:
        for agent in self.store["agents"].values():
            s = agent["signals"]
            fresh = s["successCount"] == 0 and s["violationCount"] == 0 and s["cleanStreak"] == 0
            if fresh and s["manualAdjustment"] == 0 and agent["score"] > 0:
                s["manualAdjustment"] = agent["score"]
                self.dirty = True
                self.logger.info(
                    f"Trust migration: {agent['agentId']} manualAdjustment set to {agent['score']}")

    def _migrate_unknown_agent(self) -> None:
        unknown = self.store["agents"].pop("unknown", None)
        if unknown is not None:
            self.logger.warn(
                "Trust migration: removing misattributed 'unknown' agent entry")
            self.dirty = True

    def _apply_decay(self) -> None:
        decay = self.config["decay"]
        if not decay.get("enabled"):
            return
        now = self.clock()
        for agent in self.store["agents"].values():
            days_since = (now - self._parse_iso(agent.get("lastEvaluation", ""))) / 86400
            if days_since > decay["inactivityDays"]:
                agent["score"] = clamp(agent["score"] * decay["rate"], agent.get("floor") or 0, 100)
                agent["tier"] = agent.get("locked") or score_to_tier(agent["score"])
                self.dirty = True

    # ── accessors & signals ──────────────────────────────────────────

    def _resolve_default(self, agent_id: str) -> float:
        defaults = self.config["defaults"]
        if agent_id in defaults:
            return defaults[agent_id]
        return defaults.get("*", 10)

    def get_agent_trust(self, agent_id: str) -> dict:
        existing = self.store["agents"].get(agent_id)
        if existing is not None:
            return existing
        score = clamp(self._resolve_default(agent_id), 0, 100)
        agent = {
            "agentId": agent_id,
            "score": score,
            "tier": score_to_tier(score),
            "signals": _fresh_signals(manual=score),
            "history": [],
            "lastEvaluation": self._iso(),
            "created": self._iso(),
        }
        self.store["agents"][agent_id] = agent
        self.dirty = True
        return agent

    def record_success(self, agent_id: str, reason: Optional[str] = None) -> None:
        agent = self.get_agent_trust(agent_id)
        agent["signals"]["successCount"] += 1
        agent["signals"]["cleanStreak"] += 1
        self._add_event(agent, "success", 1, reason)
        self._recalculate(agent)

    def record_violation(self, agent_id: str, reason: Optional[str] = None) -> None:
        agent = self.get_agent_trust(agent_id)
        agent["signals"]["violationCount"] += 1
        agent["signals"]["cleanStreak"] = 0
        self._add_event(agent, "violation", -2, reason)
        self._recalculate(agent)

    def set_score(self, agent_id: str, score: float) -> None:
        agent = self.get_agent_trust(agent_id)
        clamped = clamp(score, agent.get("floor") or 0, 100)
        delta = clamped - agent["score"]
        current = compute_score(agent["signals"], self.weights)
        agent["signals"]["manualAdjustment"] = clamped - (current - agent["signals"]["manualAdjustment"])
        self._add_event(agent, "manual_adjustment", delta, f"Manual set to {clamped}")
        self._recalculate(agent)

    def lock_tier(self, agent_id: str, tier: str) -> None:
        agent = self.get_agent_trust(agent_id)
        agent["locked"] = tier
        agent["tier"] = tier
        self.dirty = True

    def unlock_tier(self, agent_id: str) -> None:
        agent = self.get_agent_trust(agent_id)
        agent.pop("locked", None)
        agent["tier"] = score_to_tier(agent["score"])
        self.dirty = True

    def set_floor(self, agent_id: str, floor: float) -> None:
        agent = self.get_agent_trust(agent_id)
        agent["floor"] = clamp(floor, 0, 100)
        if agent["score"] < agent["floor"]:
            agent["score"] = agent["floor"]
            agent["tier"] = agent.get("locked") or score_to_tier(agent["score"])
        self.dirty = True

    def reset_history(self, agent_id: str) -> None:
        agent = self.get_agent_trust(agent_id)
        agent["history"] = []
        agent["signals"] = _fresh_signals()
        self._recalculate(agent)

    def _add_event(self, agent: dict, type_: str, delta: float, reason: Optional[str]) -> None:
        history = agent["history"]
        history.append({"timestamp": self._iso(), "type": type_,
                        "delta": delta, "reason": reason})
        max_history = self.config["maxHistoryPerAgent"]
        if len(history) > max_history:
            # In-place trim: the slice-copy rewrote all 50 retained events on
            # every signal once an agent's history filled up.
            del history[: len(history) - max_history]

    def _recalculate(self, agent: dict) -> None:
        created = self._parse_iso(agent.get("created", ""))
        agent["signals"]["ageDays"] = int((self.clock() - created) // 86400)
        agent["score"] = compute_score(agent["signals"], self.weights)
        floor = agent.get("floor")
        if floor is not None and agent["score"] < floor:
            agent["score"] = floor
        agent["tier"] = agent.get("locked") or score_to_tier(agent["score"])
        agent["lastEvaluation"] = self._iso()
        self.dirty = True


@dataclass
class SessionTrust:
    session_id: str
    agent_id: str
    score: float
    tier: str
    clean_streak: int = 0
    created_at: float = 0.0


class SessionTrustManager:
    """Ephemeral per-session trust seeded from (and capped by) agent trust."""

    def __init__(self, config: dict, trust_manager: TrustManager,
                 clock: Callable[[], float] = time.time):
        from ..config.loader import deep_merge

        self.config = deep_merge(DEFAULT_SESSION_TRUST_CONFIG, config or {})
        self.trust_manager = trust_manager
        self.clock = clock
        self.sessions: dict[str, SessionTrust] = {}

    def _evict_if_needed(self) -> None:
        while len(self.sessions) > MAX_SESSIONS:
            oldest = min(self.sessions.values(), key=lambda s: s.created_at)
            del self.sessions[oldest.session_id]

    def initialize_session(self, session_id: str, agent_id: str) -> SessionTrust:
        agent = self.trust_manager.get_agent_trust(agent_id)
        if not self.config["enabled"]:
            st = SessionTrust(session_id, agent_id, agent["score"], agent["tier"],
                              created_at=self.clock())
        else:
            score = int(agent["score"] * self.config["seedFactor"])
            st = SessionTrust(session_id, agent_id, score, score_to_tier(score),
                              created_at=self.clock())
        self.sessions[session_id] = st
        self._evict_if_needed()
        return st

    def get_session_trust(self, session_id: str, agent_id: str) -> SessionTrust:
        existing = self.sessions.get(session_id)
        if existing is not None:
            return existing
        return self.initialize_session(session_id, agent_id)

    def apply_signal(self, session_id: str, agent_id: str, signal: str) -> SessionTrust:
        session = self.get_session_trust(session_id, agent_id)
        if not self.config["enabled"]:
            return session
        signals = self.config["signals"]
        delta = signals.get(signal, 0)
        if signal == "success":
            session.clean_streak += 1
            if session.clean_streak >= signals["cleanStreakThreshold"]:
                delta += signals["cleanStreakBonus"]
                session.clean_streak = 0
        else:
            session.clean_streak = 0
        # _cap_score directly: set_score would re-resolve the session we
        # already hold (two dict probes per policy denial).
        self._cap_score(session, agent_id, session.score + delta)
        return session

    def set_score(self, session_id: str, agent_id: str, new_score: float) -> SessionTrust:
        session = self.get_session_trust(session_id, agent_id)
        if not self.config["enabled"]:
            return session
        return self._cap_score(session, agent_id, new_score)

    def _cap_score(self, session: SessionTrust, agent_id: str, new_score: float) -> SessionTrust:
        agent = self.trust_manager.get_agent_trust(agent_id)
        ceiling = min(100, int(agent["score"] * self.config["ceilingFactor"]))
        session.score = max(0, min(new_score, ceiling))
        session.tier = score_to_tier(session.score)
        return session

    def destroy_session(self, session_id: str) -> None:
        self.sessions.pop(session_id, None)
