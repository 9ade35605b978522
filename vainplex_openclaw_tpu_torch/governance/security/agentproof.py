"""AgentProof partner REST reputation client
(reference: governance/src/security/agentproof-rest.ts:23-338).

Bearer key loaded from a file path at runtime (never inline config), batch
lookups, and a queued feedback-signal path with retry. HTTP goes through a
DI'd ``http_request`` so the zero-egress environment and tests stub it.

A copy of ``vainplex_openclaw_tpu/governance/security/agentproof.py``,
kept here so the port imports nothing of the JAX package. As there, it is
exported but ``GovernancePlugin`` does not wire it.
"""

from __future__ import annotations

import json
import time
from collections import deque
from pathlib import Path
from typing import Callable, Optional


def _default_http_request(method: str, url: str, headers: dict,
                          body: Optional[dict] = None, timeout: float = 10.0) -> dict:
    from urllib.request import Request, urlopen

    data = json.dumps(body).encode() if body is not None else None
    req = Request(url, data=data, method=method,
                  headers={"Content-Type": "application/json", **headers})
    with urlopen(req, timeout=timeout) as resp:  # noqa: S310 — operator-configured endpoint
        return json.loads(resp.read().decode())


class AgentProofRestClient:
    def __init__(self, config: dict, logger,
                 http_request: Callable = _default_http_request,
                 clock: Callable[[], float] = time.time,
                 max_queue: int = 500):
        self.base_url = (config.get("baseUrl") or "").rstrip("/")
        self.api_key_path = config.get("apiKeyPath")
        self.logger = logger
        self.http_request = http_request
        self.clock = clock
        self._api_key: Optional[str] = None
        self._feedback_queue: deque[dict] = deque(maxlen=max_queue)

    def _key(self) -> Optional[str]:
        if self._api_key is None and self.api_key_path:
            try:
                self._api_key = Path(self.api_key_path).read_text(encoding="utf-8").strip()
            except OSError as exc:
                self.logger.warn(f"[agentproof] api key unreadable: {exc}")
        return self._api_key

    def _headers(self) -> Optional[dict]:
        key = self._key()
        if not key:
            return None
        return {"Authorization": f"Bearer {key}"}

    def lookup(self, agent_id: str) -> Optional[dict]:
        headers = self._headers()
        if headers is None or not self.base_url:
            return None
        try:
            return self.http_request("GET", f"{self.base_url}/v1/agents/{agent_id}/reputation",
                                     headers)
        except Exception as exc:  # noqa: BLE001 — reputation reads are best-effort
            self.logger.warn(f"[agentproof] lookup failed for {agent_id}: {exc}")
            return None

    def lookup_batch(self, agent_ids: list[str]) -> dict[str, Optional[dict]]:
        headers = self._headers()
        if headers is None or not self.base_url:
            return {a: None for a in agent_ids}
        try:
            response = self.http_request("POST", f"{self.base_url}/v1/agents/reputation:batch",
                                         headers, {"agentIds": agent_ids})
            results = response.get("results", {})
            return {a: results.get(a) for a in agent_ids}
        except Exception as exc:  # noqa: BLE001
            self.logger.warn(f"[agentproof] batch lookup failed: {exc}")
            return {a: None for a in agent_ids}

    def queue_feedback(self, agent_id: str, signal: str, detail: str = "") -> None:
        self._feedback_queue.append({
            "agentId": agent_id, "signal": signal, "detail": detail,
            "ts": self.clock(),
        })

    def flush_feedback(self, max_retries: int = 2) -> int:
        """Attempt to deliver queued feedback signals; returns # delivered.
        Undelivered signals remain queued for the next flush."""
        headers = self._headers()
        if headers is None or not self.base_url:
            return 0
        delivered = 0
        while self._feedback_queue:
            signal = self._feedback_queue[0]
            sent = False
            for _ in range(max_retries):
                try:
                    self.http_request("POST", f"{self.base_url}/v1/feedback",
                                      headers, signal)
                    sent = True
                    break
                except Exception:  # noqa: BLE001
                    continue
            if not sent:
                break
            self._feedback_queue.popleft()
            delivered += 1
        return delivered

    @property
    def queued(self) -> int:
        return len(self._feedback_queue)
