"""Shared PRNG-backed UUID4 generation for correlation ids.

Audit records, knowledge facts, and cortex threads/decisions/commitments all
need uuid4-FORMATTED ids but none of them need capability-token entropy —
``uuid.uuid4()`` pays a urandom syscall per call (and building a
``uuid.UUID`` object just to ``str()`` it doubles the cost again). One
module-level PRNG, seeded once from ``os.urandom`` and reseeded after fork
so child processes can't replay the parent's id stream, serves all three
(previously three private copies of the same bit-twiddling).

A copy of ``vainplex_openclaw_tpu/utils/ids.py``: reseeding ``_ID_RNG`` in
both packages alike gives both the same id stream."""

from __future__ import annotations

import os
import random

_ID_RNG = random.Random(int.from_bytes(os.urandom(16), "big"))

if hasattr(os, "register_at_fork"):
    os.register_at_fork(
        after_in_child=lambda: _ID_RNG.seed(int.from_bytes(os.urandom(16), "big")))


def prng_uuid4() -> str:
    # Hand-formatted RFC-4122 v4 layout (version nibble 4, variant bits 10).
    v = _ID_RNG.getrandbits(128)
    v = (v & ~(0xF << 76) | (4 << 76)) & ~(0x3 << 62) | (0x2 << 62)
    s = f"{v:032x}"
    return f"{s[:8]}-{s[8:12]}-{s[12:16]}-{s[16:20]}-{s[20:]}"
