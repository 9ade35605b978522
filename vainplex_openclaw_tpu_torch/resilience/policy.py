"""Retry/backoff policies and circuit breakers for the serving edges.

Every I/O edge in the suite (NATS publish, day-file append, Matrix poll,
plugin hook dispatch) shares the same two failure disciplines:

- ``RetryPolicy`` — bounded attempts with exponential backoff and *seeded*
  jitter. The jitter for attempt ``k`` is a pure function of ``(seed, k)``,
  so a retry schedule is reproducible in tests without freezing randomness
  globally. ``sleep`` and ``clock`` are injectable: the chaos suite runs
  thousands of simulated retries in milliseconds.
- ``CircuitBreaker`` — closed → open → half-open with a sliding
  failure-rate window. Open means *stop calling the dependency* (the
  gateway skips a degraded plugin's handlers; the NATS adapter stops
  hammering a dead broker) until ``recovery_s`` passes, then a bounded
  number of half-open probes decide between closing and re-opening.

Neither class knows what it protects; call sites own the semantics
(what counts as failure, what degraded mode looks like).

A copy of ``vainplex_openclaw_tpu/resilience/policy.py``, kept here so the
port imports nothing of the JAX package. ``CircuitBreaker.release`` is the
port's own: it hands back a half-open probe slot without a verdict on the
dependency, for an error that is not the dependency's (the hook bus's
device errors).
"""

from __future__ import annotations

import random
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Optional


@dataclass
class RetryStats:
    attempts: int = 0
    retries: int = 0
    giveups: int = 0
    last_error: Optional[str] = None

    def to_dict(self) -> dict:
        return {"attempts": self.attempts, "retries": self.retries,
                "giveups": self.giveups, "lastError": self.last_error}


class RetryPolicy:
    """Exponential backoff with seeded jitter and a per-attempt timeout hint.

    ``delay_for(attempt)`` is deterministic for a given ``seed`` — attempt 0
    is the first *retry* delay. ``attempt_timeout_s`` is advisory: sync call
    sites that own a timeout knob (e.g. the NATS submit race) pass it
    through; pure-CPU call sites ignore it (a thread-kill timeout would be
    a lie in synchronous Python).
    """

    def __init__(self, max_attempts: int = 3, base_delay_s: float = 0.25,
                 max_delay_s: float = 30.0, multiplier: float = 2.0,
                 jitter: float = 0.5, seed: int = 0,
                 attempt_timeout_s: Optional[float] = None,
                 sleep: Callable[[float], None] = time.sleep):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.max_attempts = max_attempts
        self.base_delay_s = base_delay_s
        self.max_delay_s = max_delay_s
        self.multiplier = multiplier
        self.jitter = jitter
        self.seed = seed
        self.attempt_timeout_s = attempt_timeout_s
        self.sleep = sleep
        self.stats = RetryStats()

    def delay_for(self, attempt: int) -> float:
        """Backoff before retry ``attempt`` (0-based), jittered by ±jitter
        fraction. Seeded per (seed, attempt) — not from a shared stream — so
        the schedule doesn't depend on how many other sites drew first."""
        base = min(self.base_delay_s * (self.multiplier ** attempt),
                   self.max_delay_s)
        if not self.jitter:
            return base
        # str seeds hash stably (sha512 path) regardless of PYTHONHASHSEED.
        u = random.Random(f"{self.seed}:{attempt}").uniform(-1.0, 1.0)
        return max(0.0, base * (1.0 + self.jitter * u))

    def call(self, fn: Callable[[], Any],
             retry_on: tuple = (Exception,),
             on_retry: Optional[Callable[[int, Exception], None]] = None) -> Any:
        """Run ``fn`` under the policy; re-raises the last error when the
        budget is spent. ``on_retry(attempt, exc)`` fires before each sleep."""
        for attempt in range(self.max_attempts):
            self.stats.attempts += 1
            try:
                return fn()
            except retry_on as exc:  # noqa: PERF203 — the retry IS the point
                self.stats.last_error = str(exc)
                if attempt + 1 >= self.max_attempts:
                    self.stats.giveups += 1
                    raise
                self.stats.retries += 1
                if on_retry is not None:
                    on_retry(attempt, exc)
                self.sleep(self.delay_for(attempt))
        raise AssertionError("unreachable")  # pragma: no cover


class CircuitOpenError(RuntimeError):
    """Raised by ``CircuitBreaker.call`` when the circuit rejects the call."""


class CircuitBreaker:
    """Closed/open/half-open breaker over a sliding failure-rate window.

    Trips open when, within ``window_s``, failures reach ``failure_threshold``
    AND the failure *rate* reaches ``failure_rate`` — the rate guard keeps a
    busy, mostly-healthy dependency (5 failures out of 5000 calls) from
    tripping on absolute count alone. After ``recovery_s`` the breaker
    half-opens and admits up to ``half_open_max`` probes: one success closes
    it (window cleared), one failure re-opens it and restarts the clock.

    The window is kept as per-second count buckets, not per-call records: the
    gateway consults a breaker on *every* hook handler invocation, so the
    success path must stay O(1) and memory O(window_s) no matter the call
    rate. (Window eviction is therefore 1-second granular.)
    """

    def __init__(self, failure_threshold: int = 5, failure_rate: float = 0.5,
                 window_s: float = 60.0, recovery_s: float = 30.0,
                 half_open_max: int = 1,
                 clock: Callable[[], float] = time.monotonic):
        self.failure_threshold = failure_threshold
        self.failure_rate = failure_rate
        self.window_s = window_s
        self.recovery_s = recovery_s
        self.half_open_max = half_open_max
        self.clock = clock
        self._state = "closed"
        self._buckets: deque[list] = deque()  # [second, ok_count, bad_count]
        self._opened_at = 0.0
        self._half_open_inflight = 0
        self.opens = 0
        self.rejected = 0
        self.failures = 0
        self.successes = 0
        self.last_error: Optional[str] = None

    # ── state machine ────────────────────────────────────────────────

    @property
    def state(self) -> str:
        self._maybe_half_open()
        return self._state

    def _maybe_half_open(self) -> None:
        if (self._state == "open"
                and self.clock() - self._opened_at >= self.recovery_s):
            self._state = "half-open"
            self._half_open_inflight = 0

    def _bucket(self, now: float) -> list:
        sec = int(now)
        if not self._buckets or self._buckets[-1][0] != sec:
            self._buckets.append([sec, 0, 0])
            cutoff = now - self.window_s
            while self._buckets and self._buckets[0][0] < cutoff:
                self._buckets.popleft()
        return self._buckets[-1]

    def allow(self) -> bool:
        """True when a call may proceed; counts the rejection otherwise."""
        self._maybe_half_open()
        if self._state == "closed":
            return True
        if self._state == "half-open":
            if self._half_open_inflight < self.half_open_max:
                self._half_open_inflight += 1
                return True
        self.rejected += 1
        return False

    def release(self) -> None:
        """Hand back a probe slot that ``allow()`` took, recording neither a
        success nor a failure."""
        if self._state == "half-open" and self._half_open_inflight > 0:
            self._half_open_inflight -= 1

    def record_success(self) -> None:
        self.successes += 1
        now = self.clock()
        if self._state == "half-open":
            # The dependency answered: close and forget the bad window.
            self._state = "closed"
            self._buckets.clear()
            return
        self._bucket(now)[1] += 1

    def record_failure(self, error: Optional[str] = None) -> None:
        self.failures += 1
        if error is not None:
            self.last_error = error
        now = self.clock()
        if self._state == "half-open":
            self._trip(now)
            return
        self._bucket(now)[2] += 1
        if self._state == "closed":
            bad = sum(b[2] for b in self._buckets)
            total = sum(b[1] + b[2] for b in self._buckets)
            if (bad >= self.failure_threshold
                    and total > 0 and bad / total >= self.failure_rate):
                self._trip(now)

    def _trip(self, now: float) -> None:
        self._state = "open"
        self._opened_at = now
        self.opens += 1
        self._buckets.clear()

    def call(self, fn: Callable[[], Any]) -> Any:
        if not self.allow():
            raise CircuitOpenError(
                f"circuit open ({self.failures} failures, "
                f"last: {self.last_error})")
        try:
            out = fn()
        except Exception as exc:
            self.record_failure(str(exc))
            raise
        self.record_success()
        return out

    def stats(self) -> dict:
        return {
            "state": self.state,
            "opens": self.opens,
            "rejected": self.rejected,
            "failures": self.failures,
            "successes": self.successes,
            "lastError": self.last_error,
        }
