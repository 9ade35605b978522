"""Maintenance: relevance decay + embeddings sync on interval timers
(reference: knowledge-engine/src/maintenance.ts:32-90 — unref'd timers; here
daemon threads, or manual ``run_*`` ticks when wall timers are off).

A copy of ``vainplex_openclaw_tpu/knowledge/maintenance.py`` with one
deviation. JAX's ``_loop`` logs a failed tick and goes on, on a daemon
thread where no caller sees it; with the local embeddings backend a sync
tick runs the encoder on the card, so a failed launch would vanish there.
The port's loop logs a plain error as JAX does, but keeps an error of the
device (``device.is_device_error``), ends that loop, and hands the error
to the plugin: :meth:`Maintenance.raise_pending` raises it once, from the
plugin's next hook, command or service stop. ``stop`` also waits for a
tick in flight.
"""

from __future__ import annotations

import threading
from typing import Optional

from ..device import is_device_error
from ..utils.stage_timer import StageTimer


class Maintenance:
    def __init__(self, fact_store, embeddings, logger,
                 decay_hours: float = 24.0, sync_minutes: float = 30.0,
                 wall_timers: bool = True, timer: Optional[StageTimer] = None,
                 lifecycle=None):
        self.fact_store = fact_store
        self.embeddings = embeddings
        self.logger = logger
        self.decay_hours = decay_hours
        self.sync_minutes = sync_minutes
        self.wall_timers = wall_timers
        self.timer = timer if timer is not None else StageTimer()
        # Idle hibernation needs a periodic probe precisely because an idle
        # store gets no traffic to piggyback on: this loop is that probe.
        self.lifecycle = lifecycle
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._synced_ids: set = set()
        self._error_lock = threading.Lock()
        self._device_error: Optional[BaseException] = None

    def run_decay(self) -> int:
        with self.timer.stage("decay"):
            pruned = self.fact_store.decay_facts()
        if pruned:
            self.logger.info(f"decay pruned {pruned} stale facts")
        return pruned

    def run_embeddings_sync(self) -> int:
        if self.embeddings is None or not self.embeddings.enabled():
            return 0
        # Reconcile prunes first (decay / maxFacts cap) so the index never
        # serves facts the store has deleted; snapshot under the store lock
        facts_now = self.fact_store.snapshot()
        current = {f.id for f in facts_now}
        dead = self._synced_ids - current
        failed_dead: set = set()
        if dead:
            if hasattr(self.embeddings, "remove"):
                # remove() returns how many ids are settled; a transient
                # failure settles fewer, and those ids retry next tick
                if self.embeddings.remove(dead) < len(dead):
                    failed_dead = dead
            else:
                self.logger.warn(f"{len(dead)} pruned facts remain in the "
                                 "embeddings backend (no remove support)")
        self._synced_ids = (self._synced_ids & current) | failed_dead
        pending = [f for f in facts_now if f.id not in self._synced_ids]
        if not pending:
            return 0
        n = self.embeddings.sync(pending)
        if n:
            self._synced_ids.update(f.id for f in pending)
        return n

    def run_hibernation(self) -> int:
        """One idle-eviction tick: hibernate every workspace the lifecycle
        manager reports past its idle horizon. Returns evictions."""
        if self.lifecycle is None:
            return 0
        n = 0
        for ws in self.lifecycle.idle_victims():
            if self.lifecycle.hibernate(ws):
                n += 1
        return n

    def _loop(self, interval_s: float, fn) -> None:
        while not self._stop.wait(interval_s):
            try:
                fn()
            except Exception as exc:  # noqa: BLE001
                if is_device_error(exc):
                    self.logger.error(f"maintenance tick failed on the "
                                      f"device, loop ended: {exc}")
                    with self._error_lock:
                        if self._device_error is None:
                            self._device_error = exc
                    return
                self.logger.error(f"maintenance tick failed: {exc}")

    def raise_pending(self) -> None:
        """Raise (once) the device error a loop kept, if any."""
        with self._error_lock:
            exc, self._device_error = self._device_error, None
        if exc is not None:
            raise exc

    def start(self) -> None:
        if not self.wall_timers:
            return
        jobs = [(self.decay_hours * 3600, self.run_decay, "ke-decay"),
                (self.sync_minutes * 60, self.run_embeddings_sync,
                 "ke-embeddings")]
        if self.lifecycle is not None and self.lifecycle.idle_s > 0:
            # Probe at half the idle horizon: an idle store sleeps at most
            # 1.5× idleSeconds past its last message.
            jobs.append((self.lifecycle.idle_s / 2, self.run_hibernation,
                         "ke-hibernate"))
        for interval, fn, name in jobs:
            t = threading.Thread(target=self._loop, args=(interval, fn),
                                 daemon=True, name=name)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        """End the loops and wait for a tick in flight, so an error of the
        device it raises is kept before :meth:`raise_pending` reads it (JAX
        only sets the event)."""
        self._stop.set()
        for t in self._threads:
            if t is not threading.current_thread():
                t.join()
        self._threads.clear()
