"""TOTP (RFC 6238) on stdlib hmac/struct: SHA1, 6 digits, 30 s period —
matching the reference's otpauth configuration (approval-2fa.ts:70-77).

A copy of ``vainplex_openclaw_tpu/governance/approval/totp.py``, kept here
so the port imports nothing of the JAX package."""

from __future__ import annotations

import base64
import hashlib
import hmac
import secrets
import struct
import time
from typing import Callable, Optional


def generate_base32_secret(length: int = 20) -> str:
    return base64.b32encode(secrets.token_bytes(length)).decode().rstrip("=")


def _decode_secret(secret: str) -> bytes:
    padded = secret.upper() + "=" * (-len(secret) % 8)
    return base64.b32decode(padded)


class Totp:
    def __init__(self, secret: str, digits: int = 6, period: int = 30,
                 algorithm: str = "sha1", clock: Callable[[], float] = time.time):
        self.key = _decode_secret(secret)
        self.digits = digits
        self.period = period
        self.algorithm = algorithm
        self.clock = clock

    def _code_at(self, counter: int) -> str:
        msg = struct.pack(">Q", counter)
        digest = hmac.new(self.key, msg, getattr(hashlib, self.algorithm)).digest()
        offset = digest[-1] & 0x0F
        code = (struct.unpack(">I", digest[offset:offset + 4])[0] & 0x7FFFFFFF) % (10 ** self.digits)
        return str(code).zfill(self.digits)

    def generate(self, at: Optional[float] = None) -> str:
        t = at if at is not None else self.clock()
        return self._code_at(int(t // self.period))

    def validate(self, token: str, window: int = 1) -> Optional[int]:
        """Return the matching period delta (−window…+window) or None."""
        if not token.isdigit() or len(token) != self.digits:
            return None
        counter = int(self.clock() // self.period)
        for delta in range(-window, window + 1):
            if hmac.compare_digest(self._code_at(counter + delta), token):
                return delta
        return None

    def current_period(self) -> int:
        return int(self.clock() // self.period)
