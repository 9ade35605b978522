"""LRU hibernation bookkeeping: who is resident, who sleeps, and what waking
cost.

The part of ``LifecycleManager`` from ``vainplex_openclaw_tpu/storage/
lifecycle.py`` (stdlib only) that the model registry calls, kept here so
the port imports nothing of the JAX package. The registry pages placed
weight trees through it: versions are its string keys, the hibernate
callback drops a version's device tree, and wake latency lands in its
stats. The idle horizon, per-key timers, settings resolution, journal
shipping and segment tiering of that module have no user in the port and
are not copied. ``tests/test_torch_registry.py`` pins the copy against the
original with ``maxResident`` set and idle eviction off.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

from ..utils.stage_timer import StageTimer


class LifecycleManager:
    """LRU over at most ``max_resident`` keys. :meth:`note_traffic` stamps
    a key and returns the keys to evict; :meth:`hibernate` runs a key's
    callback outside the lock and moves it to the sleeping set, from which
    the owner re-registers it on wake."""

    def __init__(self, max_resident: int,
                 clock: Callable[[], float] = time.time):
        self.clock = clock
        self.max_resident = int(max_resident)
        self.timer = StageTimer()           # wake latency
        # ── guarded state (self._lock) ──
        self._lock = threading.Lock()
        self._resident: dict[str, float] = {}      # key -> last traffic
        # key -> hibernate callback; dropped at hibernation so a sleeping
        # key pins no closure (owners re-register on wake).
        self._owners: dict[str, Callable[[], None]] = {}
        # Sleeping markers, insertion-ordered and bounded (16×maxResident).
        self._sleep_cap = max(64, 16 * self.max_resident)
        self._sleeping: dict[str, None] = {}
        self.wakes = 0
        self.evictions = 0

    def register(self, key: str, hibernate: Callable[[], None]) -> None:
        """Register (or replace) ``key``'s hibernate callback."""
        key = str(key)
        with self._lock:
            self._owners[key] = hibernate
            self._resident.setdefault(key, self.clock())
            self._sleeping.pop(key, None)

    def note_traffic(self, key: str) -> list[str]:
        """Stamp ``key`` as just-active and return the least recently used
        keys beyond ``max_resident``, for the caller to :meth:`hibernate`
        outside the lock."""
        key = str(key)
        now = self.clock()
        with self._lock:
            self._resident[key] = now
            self._sleeping.pop(key, None)
            over = len(self._resident) - self.max_resident
            if over <= 0:
                return []
            lru = sorted((t, k) for k, t in self._resident.items()
                         if k != key)
            return [k for _t, k in lru[:over]]

    def note_wake(self, key: str, ms: float) -> None:
        key = str(key)
        with self._lock:
            self.wakes += 1
            self._sleeping.pop(key, None)
            self._resident.setdefault(key, self.clock())
        self.timer.add("wake", ms)

    def is_sleeping(self, key: str) -> bool:
        with self._lock:
            return str(key) in self._sleeping

    def resident_keys(self) -> list[str]:
        with self._lock:
            return sorted(self._resident)

    def sleeping_keys(self) -> list[str]:
        with self._lock:
            return sorted(self._sleeping)

    def hibernate(self, key: str) -> bool:
        """Run ``key``'s callback and move it to the sleeping set. A key
        that is not resident is left alone. Returns True, as the original
        does when its callbacks succeed."""
        key = str(key)
        with self._lock:
            if key not in self._resident:
                return True
            fn = self._owners.get(key)
        if fn is not None:
            fn()
        with self._lock:
            self._resident.pop(key, None)
            self._owners.pop(key, None)
            self._sleeping[key] = None
            while len(self._sleeping) > self._sleep_cap:
                del self._sleeping[next(iter(self._sleeping))]
            self.evictions += 1
        return True

    def stats(self) -> dict:
        wake_q = self.timer.snapshot(
            qs=(0.5, 0.99))["quantiles"].get("wake") or {}
        with self._lock:
            return {"maxResident": self.max_resident,
                    "resident": len(self._resident),
                    "hibernated": len(self._sleeping),
                    "wakes": self.wakes,
                    "evictions": self.evictions,
                    "wakeP50Ms": wake_q.get("p50"),
                    "wakeP99Ms": wake_q.get("p99")}
