"""The resumable sweep state both offline search loops share.

Counterpart of ``vainplex_openclaw_tpu/ops/search_common.py``, copied so
that the port imports nothing of the JAX package; a test holds the two
equal, and a state file written by either package resumes in the other.

:mod:`.kernel_search` (K1/K2 tile builds) and
:mod:`..parallel.plan_search` (placement plans) persist every measured
point the moment it lands, keyed by a string that encodes the point's
whole identity (candidate and every knob that changes the number), so a
killed sweep resumes from its last finished point and a rerun with other
knobs measures again instead of resuming a stale record:

- a record counts as finished only when its ``done_field`` (``"ms"`` for
  kernels, ``"rps"`` for plans) holds a value;
- an error record is not a finished point: it is measured again on
  resume, so a one-off failure never bans a candidate for good;
- writes are atomic (a temporary file, then ``os.replace``): a sweep
  killed mid-write leaves the previous state, never a truncated file.
"""

from __future__ import annotations

import json
import os


def load_state(path: "str | None") -> dict:
    """The parsed sweep state ({} when missing or invalid: an unreadable
    state file restarts the sweep, it never stops it)."""
    if not path or not os.path.exists(path):
        return {}
    try:
        with open(path, encoding="utf-8") as f:
            state = json.load(f)
        return state if isinstance(state, dict) else {}
    except (OSError, ValueError):
        return {}


def save_state(path: "str | None", state: dict) -> None:
    """Atomic write (temporary file, then replace); a None path keeps
    nothing."""
    if not path:
        return
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(state, f)
    os.replace(tmp, path)


def config_key(prefix: str, *knobs) -> str:
    """A point's key, ``prefix:k1v1k2v2…`` from ordered (name, value)
    pairs. Both sweeps build their keys here, so the written and the
    resumed identity share one format."""
    return prefix + ":" + "".join(f"{k}{v}" for k, v in knobs)


class SweepState:
    """One sweep's resumable state file.

    ``finished(pkey)`` returns the earlier record (marked ``resumed``) only
    when its ``done_field`` holds a value; an error record gives None and
    is measured again. ``record(pkey, rec)`` persists at once, without a
    ``resumed`` marker."""

    def __init__(self, path: "str | None", done_field: str = "ms"):
        self.path = path
        self.done_field = done_field
        self.state = load_state(path)

    def finished(self, pkey: str) -> "dict | None":
        prior = self.state.get(pkey)
        if prior is not None and prior.get(self.done_field) is not None:
            return {**prior, "resumed": True}
        return None

    def record(self, pkey: str, rec: dict) -> None:
        self.state[pkey] = {k: v for k, v in rec.items() if k != "resumed"}
        save_state(self.path, self.state)
