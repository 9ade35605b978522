"""JetStream-backed trace source, only imported when ``nats`` is present:
a copy of ``vainplex_openclaw_tpu/cortex/trace_analyzer/nats_source.py``."""

from __future__ import annotations

import asyncio
import json
import threading
from typing import Iterator, Optional

from .events import NormalizedEvent, normalize_event


class NatsTraceSource:
    def __init__(self, url: str, stream: str = "CLAW_EVENTS", logger=None,
                 fetch_timeout_s: float = 5.0):
        self.url = url
        self.stream = stream
        self.logger = logger
        self.fetch_timeout_s = fetch_timeout_s
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self._loop.run_forever, daemon=True)
        self._thread.start()
        self._nc = None
        self._js = None
        self._submit(self._connect(), timeout=10.0)

    def _submit(self, coro, timeout: Optional[float] = None):
        return asyncio.run_coroutine_threadsafe(coro, self._loop).result(timeout)

    async def _connect(self) -> None:
        import nats  # type: ignore

        self._nc = await nats.connect(servers=[self.url])
        self._js = self._nc.jetstream()

    def fetch(self, start_seq: int = 0, batch_size: int = 500,
              max_events: Optional[int] = None) -> Iterator[NormalizedEvent]:
        # ONE consumer per fetch(), positioned at start_seq+1 — a fresh
        # ephemeral consumer per batch would restart from the stream head
        # every pull, breaking pagination and incremental runs.
        async def make_sub():
            from nats.js.api import ConsumerConfig, DeliverPolicy  # type: ignore

            cfg = ConsumerConfig(
                deliver_policy=DeliverPolicy.BY_START_SEQUENCE,
                opt_start_seq=start_seq + 1,
            )
            return await self._js.pull_subscribe("", durable=None,
                                                 stream=self.stream, config=cfg)

        async def pull(sub, n):
            msgs = await sub.fetch(n, timeout=self.fetch_timeout_s)
            out = []
            for m in msgs:
                meta_seq = m.metadata.sequence.stream
                try:
                    raw = json.loads(m.data.decode())
                    raw["seq"] = meta_seq
                    out.append(raw)
                except json.JSONDecodeError:
                    pass
                await m.ack()
            return out

        try:
            sub = self._submit(make_sub(), timeout=10.0)
        except Exception:  # noqa: BLE001 — stream empty or past end
            return
        fetched = 0
        while True:
            want = batch_size if max_events is None else min(batch_size, max_events - fetched)
            if want <= 0:
                return
            try:
                raws = self._submit(pull(sub, want), timeout=self.fetch_timeout_s + 5)
            except Exception:  # noqa: BLE001 — drained or timed out
                return
            if not raws:
                return
            for raw in raws:
                event = normalize_event(raw, seq=raw["seq"])
                if event is not None:
                    fetched += 1
                    yield event

    def last_sequence(self) -> int:
        async def get():
            info = await self._js.stream_info(self.stream)
            return info.state.last_seq

        try:
            return self._submit(get(), timeout=5.0)
        except Exception:  # noqa: BLE001
            return 0

    def event_count(self) -> int:
        async def get():
            info = await self._js.stream_info(self.stream)
            return info.state.messages

        try:
            return self._submit(get(), timeout=5.0)
        except Exception:  # noqa: BLE001
            return 0

    def close(self) -> None:
        if self._nc is not None:
            try:
                self._submit(self._nc.drain(), timeout=5.0)
            except Exception:  # noqa: BLE001
                pass
        self._loop.call_soon_threadsafe(self._loop.stop)
