"""Workspace lifecycle: snapshot shipping, segment tiering, hibernation.

The port's copy of ``vainplex_openclaw_tpu/storage/lifecycle.py`` (stdlib
only), kept here so the port imports nothing of the JAX package. The
journal (``storage/journal.py``) carries the first two pieces; this module
holds the settings they read and the eviction manager:

- **Snapshot shipping**: every ``shipEveryRecords`` committed records the
  journal compacts every stream to its legacy file and persists
  ``journal.meta.json`` (the per-stream watermarks) durably, so recovery is
  the last snapshot plus the wal tail, not the whole history.
- **Segment tiering**: segments rotated out by ``maxSegmentBytes`` are
  gzip'd into a ``cold/`` tier of bounded fanout, capped at
  ``maxColdSegments``.
- **LRU hibernation**: :class:`LifecycleManager` tracks per-workspace last
  traffic and, past ``maxResident`` (or ``idleSeconds``, when armed),
  evicts a workspace's trackers down to their journaled snapshots through
  the owners' ``hibernate()`` callbacks. The next message faults the
  workspace back in through the ordinary construction path: the wake path
  is the recovery path.

``storage.lifecycle: false`` keeps the journal's meta at rotation/close
only, deletes rotated segments and builds no eviction manager.

Fault sites: ``lifecycle.snapshot`` (a ship fails mid-flight),
``lifecycle.demote`` (a segment demotion fails mid-compress),
``lifecycle.wake`` (a wake faults before tracker construction).

One deviation: :class:`LifecycleManager` also takes a bare ``int`` for
``settings``, read as ``{"maxResident": n, "idleSeconds": 0.0}``, an LRU
cap with no idle horizon; the JAX constructor takes a dict or None only.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional, Union

from ..utils.stage_timer import StageTimer

LIFECYCLE_DEFAULTS = {
    "enabled": True,
    # Snapshot shipping: committed records between ships. Each ship is one
    # full compaction plus ONE durable meta write, the fsync amortized over
    # the whole window like the group commit it rides behind.
    "shipEveryRecords": 512,
    # Segment tiering: rotated-out segments are gzip'd under
    # <journal>/<tierDir>/<gen % tierFanout:02x>/ so no directory ever
    # holds more than ~maxColdSegments/tierFanout entries.
    "tierDir": "cold",
    "tierFanout": 16,
    "maxColdSegments": 64,
    # Hibernation: resident-workspace cap (LRU beyond it) and an optional
    # idle horizon (0 disables idle eviction; the cap alone is the default
    # policy so long-lived single-workspace gateways never self-evict).
    "maxResident": 256,
    "idleSeconds": 0.0,
}


def lifecycle_settings(config: Optional[dict],
                       default_enabled: bool = True) -> dict:
    """Resolve a plugin config's ``storage.lifecycle`` section (bool or
    dict) into full settings, the same shape discipline as
    ``journal_settings``. ``storage.lifecycle: false`` restores the journal
    without shipping or tiering and disables hibernation end to end."""
    raw = ((config or {}).get("storage") or {}).get("lifecycle",
                                                    default_enabled)
    out = dict(LIFECYCLE_DEFAULTS)
    out["enabled"] = default_enabled
    if isinstance(raw, bool):
        out["enabled"] = raw
    elif isinstance(raw, dict):
        out.update({k: v for k, v in raw.items() if k in out})
        out["enabled"] = bool(raw.get("enabled", True))
    return out


class LifecycleManager:
    """Per-gateway eviction manager: tracks workspace recency, drives the
    owners' ``hibernate()`` seams, and owns the wake/hibernate accounting
    the sitrep ``lifecycle`` collector reads.

    Owners register one hibernate callback per workspace
    (:meth:`register`); the ingest path calls :meth:`note_traffic` per
    message and evicts whatever it returns. Callbacks run OUTSIDE the
    manager lock (they flush trackers and close journals — blocking I/O
    that must never convoy the recency bookkeeping); a callback that fails
    (``OSError``, including injected faults) leaves the workspace resident
    and counted for retry — state is never dropped on a failed flush.
    """

    def __init__(self, settings: Union[dict, int, None] = None,
                 clock: Callable[[], float] = time.time, logger=None):
        if isinstance(settings, int):
            settings = {"maxResident": settings, "idleSeconds": 0.0}
        s = dict(LIFECYCLE_DEFAULTS)
        s.update(settings or {})
        self.settings = s
        self.clock = clock
        self.logger = logger
        self.max_resident = int(s.get("maxResident", 256))
        self.idle_s = float(s.get("idleSeconds", 0.0) or 0.0)
        # Aggregate stage timer: wake latency lands here directly; a
        # hibernating workspace's per-ws timer is absorbed here so its
        # snapshot/demote history survives eviction.
        self.timer = StageTimer()
        # ── guarded state (self._lock) ──
        self._lock = threading.Lock()
        self._resident: dict[str, float] = {}      # ws -> last traffic
        # ws -> owner-name -> hibernate callback. Keyed (not a list): a
        # wake RE-registers its owner's callback, and appending one per
        # wake cycle would both leak and run stale closures. Dropped
        # entirely at hibernation — owners re-register on wake — so a
        # sleeping workspace pins NO closures (the manager's own memory
        # must not be the unbounded-growth shape it exists to remove).
        self._owners: dict[str, dict[str, Callable[[], None]]] = {}
        self._timers: dict[str, StageTimer] = {}   # per-resident-ws
        # Hibernated-and-wakeable markers, insertion-ordered and BOUNDED
        # (16×maxResident): the marker only gates wake accounting and the
        # lifecycle.wake fault site, so evicting the oldest degrades an
        # ancient sleeper's wake to an unadorned first-sight construction
        # — same code path, just uncounted — instead of letting 10⁶
        # workspace-path strings accumulate forever.
        self._sleep_cap = max(64, 16 * self.max_resident)
        self._sleeping: dict[str, None] = {}
        self.wakes = 0
        self.evictions = 0
        self.hibernate_failures = 0

    # ── owner registration ───────────────────────────────────────────

    def register(self, ws: str, hibernate: Callable[[], None],
                 owner: str = "default") -> None:
        """Register (or replace) ``owner``'s hibernate callback for ``ws``.
        The owner key makes wake-time re-registration idempotent and lets
        multiple owners share ONE manager when a caller wires them that
        way; note the shipped plugins each build their own manager (cortex
        evicts per-tenant trackers, knowledge its single fact store), so
        co-eviction of a deliberately shared workspace is the caller's
        composition, not an automatic invariant."""
        ws = str(ws)
        with self._lock:
            self._owners.setdefault(ws, {})[owner] = hibernate
            self._resident.setdefault(ws, self.clock())
            self._sleeping.pop(ws, None)

    def timer_for(self, ws: str) -> StageTimer:
        """The workspace's lifecycle StageTimer (``lifecycle:<ws>`` in the
        gateway registry while resident; absorbed into the aggregate on
        hibernation so quantiles survive eviction)."""
        ws = str(ws)
        with self._lock:
            timer = self._timers.get(ws)
            if timer is None:
                timer = self._timers[ws] = StageTimer()
            return timer

    # ── recency / eviction policy ────────────────────────────────────

    def note_traffic(self, ws: str) -> list[str]:
        """Stamp ``ws`` as just-active and return the workspaces the caller
        should hibernate now (LRU beyond ``maxResident``, plus anything
        past ``idleSeconds`` when armed). Selection happens under the lock;
        the actual eviction — flushing, journal close — is the caller's, via
        :meth:`hibernate`, outside it."""
        ws = str(ws)
        now = self.clock()
        with self._lock:
            self._resident[ws] = now
            self._sleeping.pop(ws, None)
            victims = []
            if len(self._resident) > self.max_resident:
                over = len(self._resident) - self.max_resident
                lru = sorted((t, w) for w, t in self._resident.items()
                             if w != ws)
                victims += [w for _t, w in lru[:over]]
            if self.idle_s > 0:
                victims += [w for w, t in self._resident.items()
                            if w != ws and now - t > self.idle_s
                            and w not in victims]
            return victims

    def idle_victims(self) -> list[str]:
        """Workspaces past the idle horizon right now (no traffic stamp) —
        the periodic-tick entry point (knowledge maintenance)."""
        if self.idle_s <= 0:
            return []
        now = self.clock()
        with self._lock:
            return [w for w, t in self._resident.items()
                    if now - t > self.idle_s]

    def note_wake(self, ws: str, ms: float) -> None:
        ws = str(ws)
        with self._lock:
            self.wakes += 1
            self._sleeping.pop(ws, None)
            self._resident.setdefault(ws, self.clock())
        self.timer.add("wake", ms)

    def is_sleeping(self, ws: str) -> bool:
        with self._lock:
            return str(ws) in self._sleeping

    def resident_keys(self) -> list[str]:
        """Sorted resident keys — consumers that page non-workspace
        residents (the model registry pages placed param trees)
        render who is in and who is out, not just the counts."""
        with self._lock:
            return sorted(self._resident)

    def sleeping_keys(self) -> list[str]:
        with self._lock:
            return sorted(self._sleeping)

    # ── eviction execution ───────────────────────────────────────────

    def hibernate(self, ws: str) -> bool:
        """Run the workspace's hibernate callbacks. On success the ws moves
        to the sleeping set (wakeable); on any failure it stays RESIDENT —
        a failed flush must retry on the next eviction pass, never drop
        buffered state. Returns success."""
        ws = str(ws)
        with self._lock:
            owners = [fn for _name, fn in
                      sorted(self._owners.get(ws, {}).items())]
            if ws not in self._resident:
                return True
        try:
            for fn in owners:
                fn()
        except OSError as exc:
            with self._lock:
                self.hibernate_failures += 1
            if self.logger is not None:
                self.logger.warn(f"[lifecycle] hibernate {ws} failed "
                                 f"(stays resident): {exc}")
            return False
        with self._lock:
            self._resident.pop(ws, None)
            self._owners.pop(ws, None)  # owners re-register on wake
            self._sleeping[ws] = None
            while len(self._sleeping) > self._sleep_cap:
                oldest = next(iter(self._sleeping))
                del self._sleeping[oldest]
            self.evictions += 1
            timer = self._timers.pop(ws, None)
        if timer is not None:
            self.timer.absorb(timer.state())
        return True

    # ── observability ────────────────────────────────────────────────

    def stats(self) -> dict:
        snap = self.timer.snapshot(qs=(0.5, 0.99))
        wake_q = snap["quantiles"].get("wake") or {}
        with self._lock:
            resident = len(self._resident)
            sleeping = len(self._sleeping)
            wakes = self.wakes
            evictions = self.evictions
            failures = self.hibernate_failures
        return {
            "enabled": True,
            "maxResident": self.max_resident,
            "idleSeconds": self.idle_s,
            "resident": resident,
            "hibernated": sleeping,
            "wakes": wakes,
            "evictions": evictions,
            "hibernateFailures": failures,
            "wakeP50Ms": wake_q.get("p50"),
            "wakeP99Ms": wake_q.get("p99"),
        }
