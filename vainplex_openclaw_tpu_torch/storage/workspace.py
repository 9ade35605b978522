"""Workspace layout conventions (reference: cortex/src/storage.ts:10-45).

State lives under ``<workspace>/memory/reboot/``; read-only workspaces are
detected so components can degrade to in-memory mode instead of crashing.

A copy of ``vainplex_openclaw_tpu/storage/workspace.py``, kept here so the
port imports nothing of the JAX package.
"""

from __future__ import annotations

import os
import time
from pathlib import Path


def reboot_dir(workspace: str | Path) -> Path:
    return Path(workspace) / "memory" / "reboot"


def is_writable(directory: str | Path) -> bool:
    directory = Path(directory)
    try:
        directory.mkdir(parents=True, exist_ok=True)
        probe = directory / f".probe-{os.getpid()}"
        probe.write_text("", encoding="utf-8")
        probe.unlink()
        return True
    except OSError:
        return False


def is_file_older_than(path: str | Path, hours: float, now: float | None = None) -> bool:
    """True when the file is missing or older than ``hours``."""
    path = Path(path)
    try:
        mtime = path.stat().st_mtime
    except OSError:
        return True
    now = now if now is not None else time.time()
    return (now - mtime) > hours * 3600.0
