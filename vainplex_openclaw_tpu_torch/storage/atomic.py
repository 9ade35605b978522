"""Atomic JSON persistence.

A copy of ``read_json`` and ``write_json_atomic`` from
``vainplex_openclaw_tpu/storage/atomic.py`` (with the compact encoder they
share), kept here so the port imports nothing of the JAX package. Files
are written byte for byte as the JAX package writes them, so a state file
written by one package is read by the other. The fault sites are the JAX
writer's, at the same places (``resilience/faults.py``): ``file.write``
(torn-capable), ``file.fsync`` under ``durable`` and ``file.rename``; a
failed write removes its temporary file.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Optional

from ..resilience.faults import maybe_fail, write_with_faults

# the tmp-name collision guard reads the pid per write; cache it once and
# refresh it in a forked child
_PID = os.getpid()


def _refresh_pid() -> None:  # pragma: no cover — exercised via fork only
    global _PID
    _PID = os.getpid()


if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=_refresh_pid)

# The compact form encodes with the fast C encoder and falls back to the
# ``default=str`` one only for a value JSON cannot hold.
_FAST_ENCODE = json.JSONEncoder(ensure_ascii=False,
                                separators=(",", ":")).encode
_SAFE_ENCODE = json.JSONEncoder(ensure_ascii=False, separators=(",", ":"),
                                default=str).encode


def jsonl_dumps(rec: Any) -> str:
    try:
        return _FAST_ENCODE(rec)
    except (TypeError, ValueError):
        return _SAFE_ENCODE(rec)


def write_json_atomic(path: str | Path, obj: Any, indent: Optional[int] = 2,
                      durable: bool = False) -> None:
    """Write ``obj`` to a temporary file beside ``path`` and rename it over
    ``path``. ``indent=None`` writes compact JSON. ``durable=True`` fsyncs
    the temporary file before the rename and, where it can, the directory
    after it, so a machine crash cannot leave a rename that points at data
    never flushed."""
    path = Path(path)
    tmp = path.with_name(path.name + f".tmp{_PID}")
    if indent is None:
        data = jsonl_dumps(obj)
    else:
        data = json.dumps(obj, indent=indent, ensure_ascii=False, default=str)
    try:
        try:
            fh = tmp.open("w", encoding="utf-8")
        except FileNotFoundError:
            path.parent.mkdir(parents=True, exist_ok=True)
            fh = tmp.open("w", encoding="utf-8")
        with fh:
            write_with_faults("file.write", fh.write, data)
            if durable:
                fh.flush()
                maybe_fail("file.fsync")
                os.fsync(fh.fileno())
        maybe_fail("file.rename")
        os.replace(tmp, path)
    except BaseException:
        # a failed write leaves no tmp file beside the live one
        try:
            tmp.unlink()
        except OSError:
            pass
        raise
    if durable:
        try:  # the directory's fsync makes the rename itself durable
            dfd = os.open(path.parent, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:  # not supported everywhere; the file's fsync stands
            pass


def read_json(path: str | Path, default: Any = None) -> Any:
    """The JSON in ``path``, or ``default`` when it is missing or not
    JSON."""
    path = Path(path)
    try:
        return json.loads(path.read_text(encoding="utf-8"))
    except (OSError, json.JSONDecodeError):
        return default
