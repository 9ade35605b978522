"""Shared helpers (reference: governance/src/util.ts)."""

from __future__ import annotations

import re
import time as _time
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional

TRUST_TIERS = ("untrusted", "restricted", "standard", "trusted", "elevated")
RISK_LEVELS = ("low", "medium", "high", "critical")


def clamp(value: float, lo: float, hi: float) -> float:
    return max(lo, min(hi, value))


def score_to_tier(score: float) -> str:
    if score >= 80:
        return "elevated"
    if score >= 60:
        return "trusted"
    if score >= 40:
        return "standard"
    if score >= 20:
        return "restricted"
    return "untrusted"


def tier_ordinal(tier: str) -> int:
    try:
        return TRUST_TIERS.index(tier)
    except ValueError:
        return 0


def is_tier_at_least(tier: str, minimum: str) -> bool:
    return tier_ordinal(tier) >= tier_ordinal(minimum)


def is_tier_at_most(tier: str, maximum: str) -> bool:
    return tier_ordinal(tier) <= tier_ordinal(maximum)


def risk_ordinal(level: str) -> int:
    try:
        return RISK_LEVELS.index(level)
    except ValueError:
        return 0


# A regex whose meaning changes inside an alternation (numbered/named
# backreferences): combining such patterns into one (?:a)|(?:b) scan is
# unsound, so combined-pattern fast paths (audit redactor pre-screen, policy
# plan prefilter banks) must exclude them.
ALTERNATION_UNSAFE = re.compile(r"\\\d|\(\?P=")


@lru_cache(maxsize=4096)
def glob_to_regex(pattern: str) -> re.Pattern:
    # lru_cache: wildcard _match_name / sessionKey checks sit on the
    # per-evaluation hot path and were recompiling the same regex each call.
    escaped = re.escape(pattern).replace(r"\*", ".*").replace(r"\?", ".")
    return re.compile(f"^{escaped}$")


def parse_time_to_minutes(text: str) -> int:
    """``"HH:MM"`` → minutes since midnight, -1 when malformed."""
    parts = text.split(":")
    if len(parts) < 2:
        return -1
    try:
        h, m = int(parts[0]), int(parts[1])
    except ValueError:
        return -1
    if not (0 <= h <= 23 and 0 <= m <= 59):
        return -1
    return h * 60 + m


def is_in_time_range(current: int, after: int, before: int) -> bool:
    """[after, before) with midnight wrap (23:00–06:00 spans midnight)."""
    if after <= before:
        return after <= current < before
    return current >= after or current < before


@dataclass
class TimeContext:
    hour: int
    minute: int
    day_of_week: int  # 0=Sunday, matching the reference's Intl weekday map
    date: str
    timezone: str = "local"


def current_time_context(now: Optional[float] = None, timezone: str = "local") -> TimeContext:
    t = _time.localtime(now if now is not None else _time.time())
    # struct_tm: tm_wday 0=Monday … 6=Sunday → reference convention 0=Sunday
    return TimeContext(
        hour=t.tm_hour,
        minute=t.tm_min,
        day_of_week=(t.tm_wday + 1) % 7,
        date=f"{t.tm_year:04d}-{t.tm_mon:02d}-{t.tm_mday:02d}",
        timezone=timezone,
    )


def parse_agent_from_session_key(key: str) -> Optional[str]:
    """``agent:NAME`` → NAME; ``agent:NAME:subagent:CHILD:…`` → CHILD."""
    parts = key.split(":")
    if len(parts) >= 2 and parts[0] == "agent":
        if len(parts) >= 4 and parts[2] == "subagent":
            return parts[3] or None
        return parts[1] or None
    return None


def extract_agent_id(session_key: Optional[str] = None, agent_id: Optional[str] = None) -> str:
    if agent_id:
        return agent_id
    if not session_key:
        return "unknown"
    return parse_agent_from_session_key(session_key) or session_key.split(":")[0] or "unknown"


def resolve_agent_id(ctx: dict, event: Optional[dict] = None, logger=None) -> str:
    """Multi-source fallback chain; 'unresolved' (not 'unknown') at the end
    (reference: util.ts resolveAgentId — 'unknown' collected misattributed
    trust signals, hence the migration in the trust manager)."""
    if ctx.get("agent_id"):
        return ctx["agent_id"]
    for key in ("session_key", "session_id"):
        value = ctx.get(key)
        if value:
            parsed = parse_agent_from_session_key(value)
            if parsed:
                return parsed
    meta = (event or {}).get("metadata") or {}
    if isinstance(meta.get("agent_id"), str):
        return meta["agent_id"]
    if logger is not None:
        logger.debug(f"could not resolve agentId from context: {ctx.get('session_key')}")
    return "unresolved"


def is_sub_agent(session_key: Optional[str]) -> bool:
    return bool(session_key) and ":subagent:" in session_key


def extract_parent_session_key(session_key: str) -> Optional[str]:
    idx = session_key.find(":subagent:")
    return session_key[:idx] if idx != -1 else None


def extract_agent_ids(openclaw_config: dict) -> list[str]:
    """Agent ids from openclaw.json across the 4 config shapes the reference
    supports (scanner.ts:58-90): flat list, agents.list, agents.definitions,
    and named keys."""

    def names(entries: list) -> list[str]:
        out = []
        for entry in entries:
            if isinstance(entry, str):
                out.append(entry)
            elif isinstance(entry, dict):
                for key in ("id", "name"):
                    if isinstance(entry.get(key), str):
                        out.append(entry[key])
                        break
        return out

    agents = openclaw_config.get("agents")
    if isinstance(agents, list):
        return names(agents)
    if isinstance(agents, dict):
        for key in ("list", "definitions"):
            if isinstance(agents.get(key), list):
                return names(agents[key])
        meta = {"definitions", "defaults", "list"}
        return [k for k in agents if k not in meta]
    return []


def now_us() -> int:
    return round(_time.perf_counter() * 1_000_000)
