"""Redaction vault: placeholder ↔ original mapping, in-memory only, TTL'd
(reference: governance/src/redaction/vault.ts:26-90).

Placeholders are ``[REDACTED:<category>:<hash8>]`` (hash12 on collision).
Secrets are NEVER persisted; the vault dies with the process.

A copy of ``vainplex_openclaw_tpu/governance/redaction/vault.py``.
"""

from __future__ import annotations

import hashlib
import re
import time
from dataclasses import dataclass
from typing import Callable, Optional

DEFAULT_EXPIRY_SECONDS = 3600

PLACEHOLDER_RE = re.compile(
    r"\[REDACTED:(?:credential|pii|financial|custom):([a-f0-9]{8,12})\]")


@dataclass
class VaultEntry:
    original: str
    category: str
    placeholder: str
    hash_slice: str
    expires_at: float


class RedactionVault:
    def __init__(self, logger=None, expiry_seconds: Optional[float] = None,
                 clock: Callable[[], float] = time.time):
        self.logger = logger
        self.expiry_seconds = expiry_seconds if expiry_seconds is not None else DEFAULT_EXPIRY_SECONDS
        self.clock = clock
        self._entries: dict[str, VaultEntry] = {}      # full hash → entry
        self._hash_index: dict[str, list[str]] = {}    # hash8 → full hashes

    def store(self, original: str, category: str) -> str:
        full = hashlib.sha256(original.encode()).hexdigest()
        hash8 = full[:8]
        now = self.clock()

        existing = self._entries.get(full)
        if existing is not None and existing.expires_at > now:
            return existing.placeholder

        collision = any(
            h != full and (e := self._entries.get(h)) is not None and e.expires_at > now
            for h in self._hash_index.get(hash8, ())
        )
        hash_slice = full[:12] if collision else hash8
        placeholder = f"[REDACTED:{category}:{hash_slice}]"
        self._entries[full] = VaultEntry(original, category, placeholder, hash_slice,
                                         now + self.expiry_seconds)
        self._hash_index.setdefault(hash8, []).append(full)
        return placeholder

    def resolve(self, hash_slice: str) -> Optional[str]:
        now = self.clock()
        for entry in self._entries.values():
            if entry.hash_slice == hash_slice and entry.expires_at > now:
                return entry.original
        return None

    def resolve_placeholders(self, text: str) -> tuple[str, int]:
        """Replace every live placeholder in ``text`` with its original."""
        count = 0

        def sub(m: re.Match) -> str:
            nonlocal count
            original = self.resolve(m.group(1))
            if original is None:
                return m.group(0)  # expired/unknown: leave the placeholder
            count += 1
            return original

        return PLACEHOLDER_RE.sub(sub, text), count

    def evict_expired(self) -> int:
        now = self.clock()
        dead = [h for h, e in self._entries.items() if e.expires_at <= now]
        for h in dead:
            self._entries.pop(h)
            bucket = self._hash_index.get(h[:8])
            if bucket and h in bucket:
                bucket.remove(h)
        return len(dead)

    def size(self) -> int:
        return len(self._entries)

    def clear(self) -> None:
        self._entries.clear()
        self._hash_index.clear()
