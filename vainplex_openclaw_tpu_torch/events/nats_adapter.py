"""NATS JetStream transport adapter (only imported when ``nats`` is present).

A copy of ``vainplex_openclaw_tpu/events/nats_adapter.py`` on the port's
``resilience.policy`` and ``events.transport``, kept here so the port
imports nothing of the JAX package; it is held to JAX's adapter through
the scripted fake client ``tests/fake_nats.py``.

Mirrors the reference client's posture (ne/src/nats-client.ts): stream
auto-create with ``<prefix>.>`` subjects and retention limits, infinite
reconnect, publish with a timeout race, failures swallowed and counted.
The asyncio NATS client is bridged onto a dedicated background loop thread
so the (synchronous) gateway hot path never blocks on the broker.

Failed events land in a bounded disconnect *outbox* (overflow drops the
oldest and counts it), the adapter schedules reconnect probes under an
exponential-backoff :class:`RetryPolicy` schedule, and a successful
reconnect replays the outbox in order. The first failure of every
``log_every`` run is logged, and everything is observable via ``stats()``.
"""

from __future__ import annotations

import asyncio
import json
import threading
import time
from collections import deque
from typing import Callable, Iterator, Optional

from ..resilience.faults import maybe_fail
from ..resilience.policy import CircuitBreaker, RetryPolicy
from .envelope import ClawEvent
from .transport import TransportStats, _SubjectFilter, parse_nats_url

OUTBOX_MAX = 1_000     # bounded: a dead broker must not grow RSS forever
LOG_EVERY = 100        # log failure #1, #101, #201, … per failure run


class NatsTransport:  # contract-tested via tests/fake_nats.py (no live broker in CI)
    def __init__(self, url: str, stream: str = "CLAW_EVENTS", prefix: str = "claw",
                 publish_timeout_s: float = 2.0, max_msgs: int = 1_000_000,
                 max_bytes: int = 1 << 30, max_age_s: float = 30 * 86400, logger=None,
                 clock: Callable[[], float] = time.time,
                 outbox_max: int = OUTBOX_MAX,
                 reconnect_policy: Optional[RetryPolicy] = None,
                 breaker: Optional[CircuitBreaker] = None):
        self.url = url
        self.stream = stream
        self.prefix = prefix
        self.publish_timeout_s = publish_timeout_s
        self.retention = {"max_msgs": max_msgs, "max_bytes": max_bytes, "max_age_s": max_age_s}
        self.logger = logger
        self.clock = clock
        self.stats = TransportStats()
        self.outbox_max = outbox_max
        # Backoff schedule only — the adapter never sleeps; delays gate when
        # the next inline reconnect probe is *allowed*, so the publish hot
        # path pays at most one failed probe per backoff window.
        self.reconnect_policy = reconnect_policy or RetryPolicy(
            max_attempts=1_000_000, base_delay_s=1.0, max_delay_s=30.0, seed=0)
        # A connected-but-failing broker (JetStream timeouts) costs a full
        # publish_timeout_s per attempt; the breaker sheds that to a local
        # enqueue after a failure run, then probes again after recovery_s.
        self.breaker = breaker or CircuitBreaker(
            failure_threshold=5, failure_rate=0.5, window_s=30.0,
            recovery_s=5.0, clock=clock)
        self._outbox: deque[tuple[str, bytes]] = deque()
        self._reconnect_attempt = 0
        self._next_reconnect_at = 0.0
        self._failure_run = 0  # consecutive publish failures (for log gating)
        self._nc = None
        self._js = None
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self._loop.run_forever, daemon=True)
        self._thread.start()

    def _submit(self, coro, timeout: Optional[float] = None):
        fut = asyncio.run_coroutine_threadsafe(coro, self._loop)
        return fut.result(timeout)

    # ── connection ───────────────────────────────────────────────────

    def connect(self) -> bool:
        ok, exc = self._connect_sync(timeout=10.0)
        if ok:
            return True
        if self.logger:
            self.logger.warn(f"nats connect failed: {exc}")
        return False

    def _connect_sync(self, timeout: float) -> tuple:
        """Connect with a bounded wait; (ok, exc). The coroutine never
        touches ``self`` — the client is installed HERE, only after a full
        in-time success, so a timed-out attempt can't race half-initialized
        state into the publish path. A connect that completes *after* the
        timeout is closed by the done-callback instead of leaking a socket
        that reconnects in the background forever."""
        fut = asyncio.run_coroutine_threadsafe(self._connect(), self._loop)
        try:
            nc, js = fut.result(timeout)
        except Exception as exc:  # noqa: BLE001
            fut.cancel()
            fut.add_done_callback(self._discard_late_connect)
            self.stats.last_error = str(exc)
            self._nc = self._js = None
            self._schedule_reconnect()
            return False, exc
        self._nc, self._js = nc, js
        self._reconnect_attempt = 0
        self._next_reconnect_at = 0.0
        return True, None

    def _discard_late_connect(self, fut) -> None:
        """Close a connection whose establishment outlived the caller's
        patience (cancellation only lands at await points, so the coroutine
        may still have succeeded)."""
        if fut.cancelled() or fut.exception() is not None:
            return
        nc, _ = fut.result()
        closer = getattr(nc, "close", None) or getattr(nc, "drain", None)
        if closer is not None:
            asyncio.run_coroutine_threadsafe(closer(), self._loop)

    async def _connect(self) -> tuple:
        import nats  # type: ignore

        opts = parse_nats_url(self.url)
        nc = await nats.connect(
            servers=[opts["servers"]],
            user=opts.get("user"),
            password=opts.get("password"),
            max_reconnect_attempts=-1,  # infinite, like the reference
        )
        try:
            js = nc.jetstream()
            await self._ensure_stream(js)
        except BaseException:
            closer = getattr(nc, "close", None) or getattr(nc, "drain", None)
            if closer is not None:
                try:
                    await closer()
                except Exception:  # noqa: BLE001
                    pass
            raise
        return nc, js

    async def _ensure_stream(self, js) -> None:
        from nats.js.api import StreamConfig  # type: ignore

        cfg = StreamConfig(
            name=self.stream,
            subjects=[f"{self.prefix}.>"],
            max_msgs=self.retention["max_msgs"],
            max_bytes=self.retention["max_bytes"],
            max_age=self.retention["max_age_s"],  # seconds; client converts to ns
        )
        try:
            await js.add_stream(cfg)
        except Exception:  # noqa: BLE001 — already exists
            pass

    def _schedule_reconnect(self) -> None:
        delay = self.reconnect_policy.delay_for(self._reconnect_attempt)
        self._reconnect_attempt += 1
        self._next_reconnect_at = self.clock() + delay

    def _maybe_reconnect(self) -> bool:
        """Inline reconnect probe, rate-limited by the backoff schedule.
        Returns True when the adapter is connected afterwards.

        The probe is bounded by ``publish_timeout_s`` — the same budget any
        publish may spend racing the broker — NOT connect()'s 10 s lifecycle
        timeout: a blackholed broker must cost the hook path at most one
        publish-sized stall per backoff window."""
        if self._js is not None:
            return True
        if self.clock() < self._next_reconnect_at:
            return False
        ok, exc = self._connect_sync(timeout=self.publish_timeout_s)
        if not ok:
            if self.logger:
                self.logger.warn(f"nats reconnect probe failed: {exc}")
            return False
        self.stats.reconnects += 1
        if self.logger:
            self.logger.info(f"nats reconnected (outbox={len(self._outbox)})")
        self.flush_outbox()
        return True

    # ── outbox ───────────────────────────────────────────────────────

    def _enqueue(self, subject: str, payload: bytes) -> None:
        if len(self._outbox) >= self.outbox_max:
            self._outbox.popleft()
            self.stats.outbox_dropped += 1
        self._outbox.append((subject, payload))

    def flush_outbox(self) -> int:
        """Replay buffered events in order; stops at the first failure
        (remaining events keep their place). Returns # replayed."""
        replayed = 0
        while self._outbox and self._js is not None:
            subject, payload = self._outbox[0]
            try:
                self._submit(self._js.publish(subject, payload),
                             timeout=self.publish_timeout_s)
            except Exception as exc:  # noqa: BLE001
                self.stats.last_error = str(exc)
                break
            self._outbox.popleft()
            replayed += 1
            self.stats.published += 1
            self.stats.replayed += 1
        return replayed

    # ── publish ──────────────────────────────────────────────────────

    def _count_failure(self, exc: Exception) -> None:
        self.stats.publish_failures += 1
        self.stats.last_error = str(exc)
        self._failure_run += 1
        # First failure of a run (and every LOG_EVERY-th after) is logged.
        if self.logger and (self._failure_run - 1) % LOG_EVERY == 0:
            self.logger.warn(
                f"nats publish failed (#{self.stats.publish_failures}, "
                f"outbox={len(self._outbox)}): {exc}")

    def publish(self, subject: str, event: ClawEvent) -> bool:
        try:
            payload = json.dumps(event.to_dict(), default=str).encode()
        except Exception as exc:  # noqa: BLE001 — never block agent operations
            # Unencodable (e.g. circular refs): counted, never raised, and
            # there is no byte payload to outbox.
            self._count_failure(exc)
            return False
        try:
            maybe_fail("transport.publish")
        except OSError as exc:
            self._count_failure(exc)
            self._enqueue(subject, payload)
            return False
        if self._js is None and not self._maybe_reconnect():
            self._count_failure(OSError("publish buffered: disconnected"))
            self._enqueue(subject, payload)
            return False
        if not self.breaker.allow():
            # Circuit open: shed the broker round-trip entirely (a timeout
            # per publish during an outage would stall the gateway's hooks).
            self._count_failure(OSError("publish buffered: circuit open"))
            self._enqueue(subject, payload)
            return False
        try:
            if self._outbox:
                # A prior failure left buffered events; keep ordering by
                # replaying them before this one. If the replay stalls,
                # publishing directly would deliver THIS event ahead of
                # older buffered ones — queue behind them instead.
                self.flush_outbox()
                if self._outbox:
                    raise OSError(self.stats.last_error or "outbox replay stalled")
            ack = self._submit(self._js.publish(subject, payload),
                               timeout=self.publish_timeout_s)
            # The PubAck's stream sequence is authoritative — stamp it like
            # MemoryTransport/FileTransport stamp seq at publish, so a
            # route-log caller reads its op's TRUE sequence without a
            # stream_info round-trip (which, on a stream shared by several
            # supervisors, could also return a peer's later sequence).
            seq = getattr(ack, "seq", None)
            if isinstance(seq, int) and seq > 0:
                event.seq = seq
            self.stats.published += 1
            self._failure_run = 0
            self.breaker.record_success()
            return True
        except Exception as exc:  # noqa: BLE001 — never block agent operations
            self._count_failure(exc)
            self.breaker.record_failure(str(exc))
            self._enqueue(subject, payload)
            return False

    # ── consume (the EventTransport seam's read half) ────────────────
    #
    # The cluster route log treats its transport as a *replayable schedule*:
    # ``fetch(subject, start_seq=watermark)`` must return exactly the events
    # past the acked watermark, in publish order, with ``event.seq`` carrying
    # the stream sequence the next watermark advances to. MemoryTransport and
    # FileTransport have this; the JetStream adapter's read half lets
    # supervisors on different machines share one schedule.

    def fetch(self, subject_filter: str = ">", start_seq: int = 0,
              batch: Optional[int] = None,
              page_size: int = 500) -> Iterator[ClawEvent]:
        """Replay stream events past ``start_seq`` whose subject matches.

        One ephemeral pull consumer per fetch, positioned at
        ``start_seq + 1`` (the NatsTraceSource pagination discipline: a
        fresh consumer per page would restart from the stream head).
        Subject filtering is client-side with the shared NATS-pattern
        matcher so a filter behaves byte-identically to MemoryTransport's.
        Events still sitting in the disconnect outbox are not yet part of
        the broker's schedule and are not returned — the caller's watermark
        semantics only ever cover *published* sequences."""
        if self._js is None and not self._maybe_reconnect():
            return
        if self._outbox:
            # Readers see through the outbox where possible: a replayed
            # prefix joins the schedule before this fetch snapshots it.
            self.flush_outbox()

        async def make_sub():
            from nats.js.api import ConsumerConfig, DeliverPolicy  # type: ignore

            cfg = ConsumerConfig(
                deliver_policy=DeliverPolicy.BY_START_SEQUENCE,
                opt_start_seq=start_seq + 1,
            )
            return await self._js.pull_subscribe("", durable=None,
                                                 stream=self.stream, config=cfg)

        async def pull(sub, n):
            msgs = await sub.fetch(n, timeout=self.publish_timeout_s)
            out = []
            for m in msgs:
                out.append((m.metadata.sequence.stream, m.subject, m.data))
                await m.ack()
            return out

        try:
            sub = self._submit(make_sub(), timeout=10.0)
        except Exception as exc:  # noqa: BLE001 — stream empty or gone
            self.stats.last_error = str(exc)
            if self.logger is not None:
                self.logger.warn(f"nats fetch: consumer create failed: {exc}")
            return
        filt = _SubjectFilter(subject_filter)
        matches = filt.matches
        yielded = 0
        import concurrent.futures as _cf

        while True:
            try:
                rows = self._submit(pull(sub, page_size),
                                    timeout=self.publish_timeout_s + 5)
            except (asyncio.TimeoutError, _cf.TimeoutError, TimeoutError):
                return  # drained: the pull timing out empty is end-of-stream
            except Exception as exc:  # noqa: BLE001
                # A broker error mid-stream is NOT end-of-stream: the
                # caller (failover redelivery) would read a truncated
                # schedule as "nothing left". Record + log so a degraded
                # redelivery is visible, never silent.
                self.stats.last_error = str(exc)
                if self.logger is not None:
                    self.logger.warn(f"nats fetch failed mid-stream after "
                                     f"{yielded} events: {exc}")
                return
            if not rows:
                return
            for seq, subject, data in rows:
                if seq <= start_seq or not matches(subject):
                    continue
                try:
                    rec = json.loads(data.decode())
                except (json.JSONDecodeError, UnicodeDecodeError):
                    continue
                if not isinstance(rec, dict):
                    continue
                event = ClawEvent.from_dict(rec)
                event.seq = seq  # stream sequence IS the watermark unit
                yield event
                yielded += 1
                if batch is not None and yielded >= batch:
                    return

    def last_sequence(self) -> int:
        """Broker-side stream sequence — the same monotone counter
        MemoryTransport/FileTransport expose, read from stream_info."""
        if self._js is None and not self._maybe_reconnect():
            return 0

        async def get():
            info = await self._js.stream_info(self.stream)
            return info.state.last_seq

        try:
            return int(self._submit(get(), timeout=5.0))
        except Exception as exc:  # noqa: BLE001
            self.stats.last_error = str(exc)
            return 0

    def event_count(self) -> int:
        if self._js is None and not self._maybe_reconnect():
            return 0

        async def get():
            info = await self._js.stream_info(self.stream)
            return info.state.messages

        try:
            return int(self._submit(get(), timeout=5.0))
        except Exception as exc:  # noqa: BLE001
            self.stats.last_error = str(exc)
            return 0

    # ── introspection ────────────────────────────────────────────────

    def stats_dict(self) -> dict:
        """Full counter snapshot (the ``transport.stats()`` callable plus
        adapter-local state the gateway status surfaces)."""
        out = self.stats.to_dict()
        out["outbox_len"] = len(self._outbox)
        out["connected"] = self._js is not None
        out["breaker"] = self.breaker.stats()
        out["next_reconnect_in_s"] = (
            round(max(0.0, self._next_reconnect_at - self.clock()), 3)
            if self._js is None else 0.0)
        return out

    def healthy(self) -> bool:
        return self._nc is not None and not self._nc.is_closed

    def drain(self) -> None:
        if self._nc is None:
            self._loop.call_soon_threadsafe(self._loop.stop)
            return
        try:
            self._submit(self._nc.drain(), timeout=5.0)
        except Exception:  # noqa: BLE001
            pass
        self._loop.call_soon_threadsafe(self._loop.stop)
