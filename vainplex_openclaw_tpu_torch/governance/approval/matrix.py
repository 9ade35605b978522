"""Matrix notification sender for 2FA approval prompts
(reference: governance/src/hooks.ts:812-874 — posts the batched approval
message into the approvers' Matrix room; this closes the 2FA loop the
code-reading poller alone leaves open).

Speaks the client-server API directly: ``PUT
/_matrix/client/v3/rooms/{room}/send/m.room.message/{txnId}`` with a
process-unique transaction id. ``send`` retries a failed PUT once with the
SAME txn id, so Matrix-side dedup guarantees the retry can never double-post
a prompt even when the first attempt actually landed. The HTTP call goes through
a DI'd ``http_put`` so tests run against a fake homeserver and the
zero-egress environment degrades to a logged warning — fail-open: a lost
notification must never block the agent, since the TOTP code still resolves
via chat (``message_received``) or the poller.

A copy of ``vainplex_openclaw_tpu/governance/approval/matrix.py``, kept
here so the port imports nothing of the JAX package.
"""

from __future__ import annotations

import itertools
import json
import time
import urllib.parse
import uuid
from typing import Callable, Optional


def _default_http_put(url: str, headers: dict, body: dict,
                      timeout: float = 10.0) -> dict:
    from urllib.request import Request, urlopen

    req = Request(url, data=json.dumps(body).encode(), method="PUT",
                  headers={**headers, "Content-Type": "application/json"})
    with urlopen(req, timeout=timeout) as resp:  # noqa: S310 — operator-configured homeserver
        return json.loads(resp.read().decode())


class MatrixNotifier:
    """Sends m.room.message events into the approvers' room."""

    def __init__(self, creds: dict, logger,
                 http_put: Callable = _default_http_put,
                 clock: Callable[[], float] = time.time):
        self.creds = creds
        self.logger = logger
        self.http_put = http_put
        self.clock = clock
        # txn ids must be unique per access token for the device lifetime;
        # a per-instance random nonce keeps ids from colliding even when two
        # notifier instances share one token in the same process+millisecond
        # (Matrix dedup would otherwise silently swallow the second prompt).
        self._nonce = uuid.uuid4().hex[:8]
        self._seq = itertools.count()

    def _txn_id(self) -> str:
        return (f"claw2fa-{self._nonce}-{int(self.clock() * 1000)}"
                f"-{next(self._seq)}")

    def send(self, message: str, retries: int = 1) -> Optional[str]:
        """Post one text message; returns the event id, or None on failure
        (logged, never raised — notification is fail-open). A failed PUT is
        retried with the SAME txn id: if the first attempt actually reached
        the homeserver, Matrix dedup makes the retry a no-op instead of a
        duplicate prompt."""
        base = self.creds["homeserver"].rstrip("/")
        room = urllib.parse.quote(self.creds["roomId"], safe="")
        url = (f"{base}/_matrix/client/v3/rooms/{room}"
               f"/send/m.room.message/{self._txn_id()}")
        body = {"msgtype": "m.text", "body": message}
        last_exc = None
        for _ in range(1 + max(retries, 0)):
            try:
                resp = self.http_put(
                    url, {"Authorization": f"Bearer {self.creds['accessToken']}"},
                    body)
                event_id = (resp or {}).get("event_id")
                self.logger.info(f"[2fa] Matrix notification sent ({event_id})")
                return event_id
            except Exception as exc:  # noqa: BLE001 — lost prompt must not block the agent
                last_exc = exc
        self.logger.warn(f"[2fa] Matrix notification failed: {last_exc}")
        return None

    def notify_fn(self) -> Callable[[str, str, str], None]:
        """Adapter matching Approval2FA.set_notify_fn's (agent, conversation,
        message) signature."""
        return lambda agent_id, conversation_id, message: self.send(message)
