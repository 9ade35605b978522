"""Approval2FA: batched TOTP human-in-the-loop for 2fa-gated tool calls
(reference: governance/src/approval-2fa.ts:47-290).

Flow: 2fa verdict → ``request()`` joins/creates the agent's pending batch →
after the batch window a notification goes out (all queued commands in one
message) → a 6-digit code arrives (``try_resolve``, via message_received or
the Matrix poller thread) → every command in the batch resolves allow; an
accepted code also opens a session-approval window (default 10 min) during
which further calls auto-approve. Cooldown after too many failed attempts;
replay protection rejects a token delta+period that was already consumed.

Concurrency model: the reference suspends a Promise on Node's single event
loop. Here each ``request()`` blocks its calling thread on a
``concurrent.futures.Future`` while timers and the code path (notifier /
poller / another gateway thread) resolve it — same observable semantics, and
the check-then-create of a batch holds one lock (the reference's "NO await
between has/set" discipline, approval-2fa.ts:89-121).

A copy of ``vainplex_openclaw_tpu/governance/approval/approval2fa.py``,
kept here so the port imports nothing of the JAX package; ``deep_merge``
is the port's own (``config/loader.py``).
"""

from __future__ import annotations

import threading
import time
import uuid
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Callable, Optional

from .totp import Totp

DEFAULT_2FA_CONFIG = {
    "enabled": True,
    "totpSecret": None,           # required
    "totpIssuer": "openclaw",
    "totpLabel": "governance",
    "approvers": [],
    "batchWindowMs": 3000,
    "timeoutSeconds": 300,
    "sessionDurationMinutes": 10,
    "maxAttempts": 3,
    "cooldownSeconds": 60,
}


def summarize_params(params: dict, limit: int = 120) -> str:
    text = ", ".join(f"{k}={v!r}" for k, v in (params or {}).items())
    return text[:limit] + ("…" if len(text) > limit else "")


@dataclass
class PendingCommand:
    tool_name: str
    params: dict
    future: Future


@dataclass
class PendingBatch:
    id: str
    agent_id: str
    conversation_id: str
    commands: list[PendingCommand] = field(default_factory=list)
    created_at: float = 0.0
    expires_at: float = 0.0
    attempts: int = 0
    closed: bool = False
    timers: list[threading.Timer] = field(default_factory=list)


class Approval2FA:
    def __init__(self, config: dict, logger, clock: Callable[[], float] = time.time,
                 wall_timers: bool = True):
        from ...config.loader import deep_merge

        self.config = deep_merge(DEFAULT_2FA_CONFIG, config or {})
        if not self.config.get("totpSecret"):
            raise ValueError("2FA requires totpSecret")
        self.logger = logger
        self.clock = clock
        self.wall_timers = wall_timers
        self.totp = Totp(self.config["totpSecret"], clock=clock)
        self.notify_fn: Optional[Callable[[str, str, str], None]] = None
        self._lock = threading.Lock()
        self._batches: dict[str, PendingBatch] = {}
        self._cooldowns: dict[str, float] = {}
        self._session_approvals: dict[str, float] = {}
        self._last_used_token: Optional[tuple[int, int]] = None

    def set_notify_fn(self, fn: Callable[[str, str, str], None]) -> None:
        self.notify_fn = fn

    # ── request path (before_tool_call, verdict == 2fa) ─────────────

    def request(self, agent_id: str, conversation_id: str, tool_name: str,
                params: dict, reason: str = "", wait: bool = True,
                wait_timeout: Optional[float] = None) -> dict:
        now = self.clock()

        with self._lock:
            # session auto-approve
            session_expiry = self._session_approvals.get(agent_id)
            if session_expiry is not None:
                if now < session_expiry:
                    remaining = int((session_expiry - now) / 60) + 1
                    self.logger.info(f"[2fa] Auto-approved {tool_name} for {agent_id} "
                                     f"(session has {remaining}min left)")
                    return {}
                del self._session_approvals[agent_id]

            # cooldown
            cd = self._cooldowns.get(agent_id)
            if cd is not None and now < cd:
                retry = int(cd - now) + 1
                return {"block": True,
                        "block_reason": f"2FA cooldown active. Retry in {retry}s "
                                        f"after too many failed attempts."}

            batch, is_new = self._get_or_create_batch(agent_id, conversation_id, now)
            future: Future = Future()
            batch.commands.append(PendingCommand(tool_name, dict(params or {}), future))

        if is_new and self.wall_timers:
            close_t = threading.Timer(self.config["batchWindowMs"] / 1000.0,
                                      self.close_batch, args=(batch,))
            timeout_t = threading.Timer(self.config["timeoutSeconds"],
                                        self.timeout_batch, args=(batch,))
            for t in (close_t, timeout_t):
                t.daemon = True
                t.start()
            batch.timers += [close_t, timeout_t]

        if not wait:
            return {"pending": True, "batch_id": batch.id}
        try:
            return future.result(timeout=wait_timeout or self.config["timeoutSeconds"] + 5)
        except Exception:  # noqa: BLE001 — waiter timeout == deny
            self.timeout_batch(batch)
            return {"block": True, "block_reason": "2FA approval timed out"}

    def _get_or_create_batch(self, agent_id: str, conversation_id: str,
                             now: float) -> tuple[PendingBatch, bool]:
        batch = self._batches.get(agent_id)
        if batch is not None and not batch.closed:
            return batch, False
        if batch is not None and batch.closed:
            # resolve orphans from the superseded batch
            for cmd in batch.commands:
                if not cmd.future.done():
                    cmd.future.set_result({"block": True,
                                           "block_reason": "2FA batch superseded by new batch"})
            self._cancel_timers(batch)
            self.logger.warn(f"[2fa] Orphaned batch {batch.id} resolved (superseded) — "
                             f"{len(batch.commands)} command(s) denied")
        new = PendingBatch(
            id=str(uuid.uuid4()), agent_id=agent_id, conversation_id=conversation_id,
            created_at=now, expires_at=now + self.config["timeoutSeconds"])
        self._batches[agent_id] = new
        return new, True

    @staticmethod
    def _cancel_timers(batch: PendingBatch) -> None:
        for t in batch.timers:
            t.cancel()
        batch.timers = []

    # ── batch lifecycle ──────────────────────────────────────────────

    def close_batch(self, batch: PendingBatch) -> None:
        with self._lock:
            if batch.closed:
                return
            batch.closed = True
            commands = list(batch.commands)
        listing = "\n".join(f"{i + 1}. {c.tool_name}: {summarize_params(c.params)}"
                            for i, c in enumerate(commands))
        timeout_min = round(self.config["timeoutSeconds"] / 60)
        session_min = self.config["sessionDurationMinutes"]
        plural = "s" if len(commands) > 1 else ""
        message = (f"🔒 APPROVAL REQUIRED ({len(commands)} command{plural})\n"
                   f"Agent: {batch.agent_id}\n{listing}\n"
                   f"Enter TOTP code ({timeout_min}min timeout)\n"
                   f"✨ One code approves ALL commands for {session_min} minutes")
        self.logger.info(f"[2fa] Batch {batch.id} closed with {len(commands)} command(s)")
        if self.notify_fn is not None:
            try:
                self.notify_fn(batch.agent_id, batch.conversation_id, message)
            except Exception as exc:  # noqa: BLE001
                self.logger.error(f"[2fa] Notification failed: {exc}")

    def timeout_batch(self, batch: PendingBatch) -> None:
        with self._lock:
            if self._batches.get(batch.agent_id) is not batch:
                return
            del self._batches[batch.agent_id]
            self._cancel_timers(batch)
            commands = list(batch.commands)
        self.logger.warn(f"[2fa] Batch {batch.id} timed out for agent {batch.agent_id}")
        for cmd in commands:
            if not cmd.future.done():
                cmd.future.set_result({"block": True, "block_reason": "2FA approval timed out"})

    # ── code path (message_received / poller) ────────────────────────

    def try_resolve(self, code: str, sender_id: str, conversation_id: str) -> dict:
        now = self.clock()
        with self._lock:
            batch = next((b for b in self._batches.values()
                          if b.conversation_id == conversation_id), None)
            if batch is None:
                return {"status": "no_pending"}
            if sender_id not in self.config["approvers"]:
                self.logger.warn(f"[2fa] Unauthorized approval attempt by {sender_id}")
                return {"status": "unauthorized"}
            cd = self._cooldowns.get(batch.agent_id)
            if cd is not None and now < cd:
                return {"status": "cooldown", "retry_after_seconds": int(cd - now) + 1}

            delta = self.totp.validate(code, window=1)
            period = self.totp.current_period()
            if delta is not None and self._last_used_token == (delta, period):
                self.logger.warn(f"[2fa] TOTP replay detected for batch {batch.id}")
                return {"status": "replay"}

            if delta is None:
                batch.attempts += 1
                if batch.attempts >= self.config["maxAttempts"]:
                    self._cooldowns[batch.agent_id] = now + self.config["cooldownSeconds"]
                    del self._batches[batch.agent_id]
                    self._cancel_timers(batch)
                    commands = list(batch.commands)
                    for cmd in commands:
                        if not cmd.future.done():
                            cmd.future.set_result({
                                "block": True,
                                "block_reason": "2FA denied: too many invalid codes"})
                    return {"status": "denied_cooldown"}
                return {"status": "invalid",
                        "attempts_left": self.config["maxAttempts"] - batch.attempts}

            # valid code: approve all, open session window
            self._last_used_token = (delta, period)
            del self._batches[batch.agent_id]
            self._cancel_timers(batch)
            self._session_approvals[batch.agent_id] = (
                now + self.config["sessionDurationMinutes"] * 60)
            commands = list(batch.commands)
        for cmd in commands:
            if not cmd.future.done():
                cmd.future.set_result({})
        self.logger.info(f"[2fa] Batch {batch.id} approved ({len(commands)} command(s)); "
                         f"session approval active")
        return {"status": "approved", "count": len(commands)}

    def try_resolve_any(self, code: str, sender_id: str) -> dict:
        """Resolve against whichever batch is pending (poller path — the
        Matrix room is not tied to a conversation id)."""
        with self._lock:
            conv_ids = [b.conversation_id for b in self._batches.values()]
        for conv in conv_ids:
            result = self.try_resolve(code, sender_id, conv)
            if result["status"] != "no_pending":
                return result
        return {"status": "no_pending"}

    def cleanup_expired(self) -> None:
        now = self.clock()
        with self._lock:
            self._cooldowns = {k: v for k, v in self._cooldowns.items() if now < v}
            self._session_approvals = {k: v for k, v in self._session_approvals.items() if now < v}

    def pending_count(self) -> int:
        with self._lock:
            return sum(len(b.commands) for b in self._batches.values())
