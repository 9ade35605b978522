"""Matrix room poller for TOTP codes
(reference: governance/src/matrix-poller.ts:1-40 + creds loading
hooks.ts:786-801).

Polls one Matrix room via the client-server REST API every ``interval_s``
for 6-digit codes, independent of the gateway's own Matrix sync. Network
calls go through a DI'd ``http_get`` so tests run without a homeserver and
the zero-egress environment degrades cleanly.

A copy of ``vainplex_openclaw_tpu/governance/approval/poller.py``, kept
here so the port imports nothing of the JAX package; it uses the port's own
``RetryPolicy`` and ``read_json``. ``CODE_RE`` is JAX's: any six digits at
word boundaries in an ``m.text`` body count as a code attempt, so six-digit
chatter in the room (a ticket id, a time) costs a pending batch one of its
``maxAttempts``.
"""

from __future__ import annotations

import json
import re
import threading
from collections import deque
from typing import Callable, Optional
from urllib.parse import quote

from ...resilience.policy import RetryPolicy
from ...storage.atomic import read_json

CODE_RE = re.compile(r"\b(\d{6})\b")
SEEN_CAP = 200


def load_matrix_credentials(path: str) -> Optional[dict]:
    """Secrets file format: {homeserver, accessToken, roomId, userId}."""
    creds = read_json(path)
    if not isinstance(creds, dict):
        return None
    if not all(creds.get(k) for k in ("homeserver", "accessToken", "roomId")):
        return None
    return creds


def _default_http_get(url: str, headers: dict, timeout: float = 10.0) -> dict:
    from urllib.request import Request, urlopen

    req = Request(url, headers=headers)
    with urlopen(req, timeout=timeout) as resp:  # noqa: S310 — operator-configured homeserver
        return json.loads(resp.read().decode())


class MatrixPoller:
    def __init__(self, creds: dict, on_code: Callable[[str, str], None],
                 logger, interval_s: float = 2.0,
                 http_get: Callable = _default_http_get,
                 retry: Optional[RetryPolicy] = None):
        self.creds = creds
        self.on_code = on_code
        self.logger = logger
        self.interval_s = interval_s
        self.http_get = http_get
        # Transient homeserver hiccups: a flaky poll retries with
        # short backoff *inside* the tick instead of silently losing up to
        # interval_s of approval latency per blip. The whole-tick failure
        # path still never kills the loop.
        self.retry = retry or RetryPolicy(max_attempts=3, base_delay_s=0.25,
                                          max_delay_s=2.0, seed=0)
        self.polls = 0
        self._since: Optional[str] = None
        self._seen: deque[str] = deque(maxlen=SEEN_CAP)
        self._seen_set: set[str] = set()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="matrix-2fa-poller")
        self._thread.start()
        self.logger.info("[2fa] Matrix poller started")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.poll_with_retry()
            except Exception as exc:  # noqa: BLE001 — keep polling through transient failures
                self.logger.warn(f"[2fa] Matrix poll failed: {exc}")

    def poll_with_retry(self) -> int:
        """One tick under the retry policy; raises only when the whole
        attempt budget is spent (the loop logs and keeps polling)."""
        self.polls += 1
        return self.retry.call(
            self.poll_once,
            on_retry=lambda attempt, exc: self.logger.warn(
                f"[2fa] Matrix poll failed (attempt "
                f"{attempt + 1}/{self.retry.max_attempts}, retrying): {exc}"))

    def stats(self) -> dict:
        # Failure counters live on the RetryPolicy — one source of truth:
        # a giveup IS a failed poll, and last_error covers retried blips too.
        rs = self.retry.stats
        return {"polls": self.polls, "pollFailures": rs.giveups,
                "retries": rs.retries, "lastError": rs.last_error}

    def _messages_url(self, query: str) -> str:
        base = self.creds["homeserver"].rstrip("/")
        room = quote(self.creds["roomId"], safe="")  # '!'/':' are reserved
        return f"{base}/_matrix/client/v3/rooms/{room}/messages?{query}"

    def _headers(self) -> dict:
        return {"Authorization": f"Bearer {self.creds['accessToken']}"}

    def _remember(self, event_id: str) -> None:
        if len(self._seen) == self._seen.maxlen:
            self._seen_set.discard(self._seen[0])
        self._seen.append(event_id)
        self._seen_set.add(event_id)

    def _init_sync(self) -> None:
        """Grab the room's newest pagination token so polling only ever sees
        NEW messages (reference matrix-poller.ts:91-112 — historical codes
        must not replay into fresh batches)."""
        data = self.http_get(self._messages_url("dir=b&limit=1"), self._headers())
        self._since = data.get("end")
        for event in data.get("chunk", []):
            if event.get("event_id"):
                self._remember(event["event_id"])

    def poll_once(self) -> int:
        """One forward fetch of new room messages; returns # codes dispatched.

        Protocol per the Matrix spec and the reference (matrix-poller.ts:
        118-146): paginate FORWARD (``dir=f``) from the last ``end`` token —
        with ``dir=b`` the ``start`` token only re-requests the same page,
        freezing the window so codes posted after startup are never seen.
        Event-id dedupe guards the overlap at window edges (a replayed
        invalid code would burn an attempt). Only ``m.text`` messages are
        scanned: notices/emotes/captions from bots and bridges are exactly
        the incidental 6-digit chatter (ticket ids, timestamps) that burns
        ``attemptsLeft`` for nothing and can lock a pending batch out.
        Codes are matched at word boundaries inside free text
        (``handle_2fa_code`` parity — deviation kept from the reference's
        exact-body-only matching), which subsumes exact-body codes: a bare
        6-digit body matches at the same span."""
        if self._since is None:
            self._init_sync()
            return 0
        url = self._messages_url(f"dir=f&from={quote(self._since, safe='')}&limit=10")
        data = self.http_get(url, self._headers())
        if data.get("end"):
            self._since = data["end"]
        dispatched = 0
        for event in data.get("chunk", []):
            event_id = event.get("event_id")
            if event_id:
                if event_id in self._seen_set:
                    continue
                self._remember(event_id)
            if event.get("type") != "m.room.message":
                continue
            content = event.get("content") or {}
            if content.get("msgtype") != "m.text":
                continue
            body = content.get("body") or ""
            sender = event.get("sender") or ""
            m = CODE_RE.search(body)
            if m:
                self.on_code(m.group(1), sender)
                dispatched += 1
        return dispatched
