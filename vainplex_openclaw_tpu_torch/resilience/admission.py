"""Admission control: queue-depth backpressure with fair-share shedding.

A copy of ``vainplex_openclaw_tpu/resilience/admission.py`` (stdlib only),
kept here so the port imports nothing of the JAX package. The serve batcher
uses it over its request queue. Bounded queues, visible degradation:
when the queue is saturated — measured as *queue depth*, the number of
arrived-but-unprocessed requests its owner reports via
``note_queue_depth`` — the controller sheds traffic-proportional work so
the rest keeps its latency budget.

Two thresholds give graceful, *fair* degradation:

- above ``high_watermark``: per-tenant fair-share shedding — only tenants
  whose share of recent admissions exceeds ``fair_share_factor`` × the
  equal share are shed, so a single noisy workspace can't starve quiet
  ones of their observability work;
- above ``shed_all_depth`` (= watermark × ``shed_all_factor``): every
  sheddable request is shed until the backlog drains.

All decisions are pure functions of (reported depth, recent admission
window) — no clocks, no randomness — so a seeded load run makes the same
shedding decisions every time (the SLO harness's determinism contract).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Optional

ADMISSION_DEFAULTS = {
    "highWatermark": 64,
    "shedAllFactor": 4.0,
    "fairShareFactor": 1.5,
    "windowOps": 1024,
}


class AdmissionController:
    """Queue-depth backpressure + per-tenant fair-share shedding.

    ``admit(tenant)`` is O(1): a deque append, two dict updates, and a
    couple of comparisons — it sits on the message hot path.
    """

    def __init__(self, high_watermark: int = 64, shed_all_factor: float = 4.0,
                 fair_share_factor: float = 1.5, window_ops: int = 1024):
        self.high_watermark = int(high_watermark)
        self.shed_all_depth = int(high_watermark * shed_all_factor)
        self.fair_share_factor = float(fair_share_factor)
        self._lock = threading.Lock()
        self._window: deque[str] = deque()
        self._window_max = int(window_ops)
        self._window_counts: dict[str, int] = {}
        self.queue_depth = 0
        self.max_queue_depth = 0
        self.admitted = 0
        self.shed = 0
        self.shed_by_tenant: dict[str, int] = {}

    @classmethod
    def from_config(cls, cfg: Optional[dict]) -> Optional["AdmissionController"]:
        """None (feature off, seed behavior) unless config enables it."""
        if not cfg or not cfg.get("enabled", True):
            return None
        merged = dict(ADMISSION_DEFAULTS)
        merged.update({k: v for k, v in cfg.items() if k != "enabled"})
        return cls(high_watermark=merged["highWatermark"],
                   shed_all_factor=merged["shedAllFactor"],
                   fair_share_factor=merged["fairShareFactor"],
                   window_ops=merged["windowOps"])

    # ── backpressure signal ──────────────────────────────────────────

    def note_queue_depth(self, depth: int) -> None:
        """Report the current arrived-but-unprocessed backlog. Called by
        whatever owns the ingress queue (here the serve batcher, at every
        enqueue and drain)."""
        with self._lock:
            self.queue_depth = int(depth)
            if depth > self.max_queue_depth:
                self.max_queue_depth = int(depth)

    # ── admission decision ───────────────────────────────────────────

    def _record_admit(self, tenant: str) -> None:
        self._window.append(tenant)
        self._window_counts[tenant] = self._window_counts.get(tenant, 0) + 1
        if len(self._window) > self._window_max:
            old = self._window.popleft()
            left = self._window_counts[old] - 1
            if left:
                self._window_counts[old] = left
            else:
                del self._window_counts[old]

    def _record_shed(self, tenant: str) -> None:
        self.shed += 1
        self.shed_by_tenant[tenant] = self.shed_by_tenant.get(tenant, 0) + 1

    def admit(self, tenant: str) -> bool:
        """True → run the hook's handlers; False → shed (skip them all)."""
        with self._lock:
            depth = self.queue_depth
            if depth > self.shed_all_depth:
                self._record_shed(tenant)
                return False
            if depth > self.high_watermark:
                active = len(self._window_counts)
                if active > 1:
                    fair = (len(self._window) / active) * self.fair_share_factor
                    if self._window_counts.get(tenant, 0) > fair:
                        self._record_shed(tenant)
                        return False
            self.admitted += 1
            self._record_admit(tenant)
            return True

    def stats(self) -> dict:
        with self._lock:
            return {
                "enabled": True,
                "queueDepth": self.queue_depth,
                "maxQueueDepth": self.max_queue_depth,
                "highWatermark": self.high_watermark,
                "shedAllDepth": self.shed_all_depth,
                "admitted": self.admitted,
                "shed": self.shed,
                "shedByTenant": dict(sorted(self.shed_by_tenant.items())),
            }
