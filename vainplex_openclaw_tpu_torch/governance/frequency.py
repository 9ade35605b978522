"""Fixed-size ring buffer of recent actions for frequency windows
(reference: governance/src/frequency-tracker.ts).

The ring (capacity semantics) is kept, but counting is O(log n) via
per-scope timestamp indexes instead of scanning the window on every
evaluation — ``count`` sits on the enforcement hot path (risk assessor +
frequency conditions run it on every ``before_tool_call``).
"""

from __future__ import annotations

import time
from bisect import bisect_left
from collections import deque
from typing import Callable, Optional


class _Series:
    """Append-only sorted timestamp list with a logical head (lazy deletion)."""

    __slots__ = ("ts", "head")

    def __init__(self) -> None:
        self.ts: list[float] = []
        self.head = 0

    def add(self, t: float) -> None:
        self.ts.append(t)

    def drop_oldest(self, t: float) -> None:
        """Remove one occurrence of ``t`` from the front (ring eviction)."""
        i = bisect_left(self.ts, t, self.head)
        if i < len(self.ts) and self.ts[i] == t:
            if i == self.head:
                self.head += 1
            else:  # same-timestamp entries straddle the head; shift one up
                del self.ts[i]
        if self.head > 4096 and self.head * 2 > len(self.ts):
            del self.ts[: self.head]
            self.head = 0

    def count_since(self, cutoff: float) -> int:
        # entries AT the cutoff are in-window (matches the ring-scan's ts >= cutoff)
        return len(self.ts) - bisect_left(self.ts, cutoff, self.head)

    def empty(self) -> bool:
        return self.head >= len(self.ts)


class FrequencyTracker:
    def __init__(self, max_entries: int = 10_000, clock: Callable[[], float] = time.time):
        self._ring: deque[tuple[float, str, Optional[str]]] = deque()
        self._max = max_entries
        self._clock = clock
        self._last_ts = float("-inf")
        self._global = _Series()
        self._by_agent: dict[Optional[str], _Series] = {}
        self._by_session: dict[Optional[str], _Series] = {}

    def record(self, agent_id: str, session_key: Optional[str] = None,
               tool_name: Optional[str] = None) -> None:
        # Clamp to monotonic: a wall-clock step backwards (NTP) must not
        # break the sorted invariant the bisect indexes rely on.
        ts = self._clock()
        if ts < self._last_ts:
            ts = self._last_ts
        self._last_ts = ts
        self._ring.append((ts, agent_id, session_key))
        self._global.add(ts)
        self._by_agent.setdefault(agent_id, _Series()).add(ts)
        self._by_session.setdefault(session_key, _Series()).add(ts)
        if len(self._ring) > self._max:
            old_ts, old_agent, old_session = self._ring.popleft()
            self._global.drop_oldest(old_ts)
            for index, key in ((self._by_agent, old_agent), (self._by_session, old_session)):
                series = index.get(key)
                if series is not None:
                    series.drop_oldest(old_ts)
                    if series.empty():
                        del index[key]

    def count(self, window_seconds: float, scope: str = "agent",
              agent_id: Optional[str] = None, session_key: Optional[str] = None) -> int:
        cutoff = self._clock() - window_seconds
        if scope == "agent":
            series = self._by_agent.get(agent_id)
        elif scope == "session":
            series = self._by_session.get(session_key)
        else:
            series = self._global
        return 0 if series is None else series.count_since(cutoff)

    def clear(self) -> None:
        self._ring.clear()
        self._global = _Series()
        self._by_agent.clear()
        self._by_session.clear()
