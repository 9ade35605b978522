"""Subject scheme: ``<prefix>.<agent>.<type>``.

A copy of ``vainplex_openclaw_tpu/events/subjects.py``, kept here so the
port imports nothing of the JAX package.
"""

from __future__ import annotations

import re

_TOKEN_SANITIZE = re.compile(r"[^A-Za-z0-9_-]")


def sanitize_token(token: str) -> str:
    return _TOKEN_SANITIZE.sub("_", token) or "unknown"


def build_subject(prefix: str, agent: str, event_type: str) -> str:
    return f"{prefix}.{sanitize_token(agent)}.{event_type}"
