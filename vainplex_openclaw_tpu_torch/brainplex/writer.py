"""Atomic config writing that NEVER overwrites existing configs
(reference: brainplex/src/writer.ts:14-45): timestamped backups before any
touch, and merge-only updates to openclaw.json plugin entries.

A copy of ``vainplex_openclaw_tpu/brainplex/writer.py``, kept here so the
port imports nothing of the JAX package; it writes through the port's own
``storage/atomic.py``."""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Callable, Optional

from ..storage.atomic import write_json_atomic
from .scanner import parse_config


def backup_path(path: Path, clock: Callable[[], float] = time.time) -> Path:
    t = time.gmtime(clock())
    stamp = (f"{t.tm_year:04d}{t.tm_mon:02d}{t.tm_mday:02d}-"
             f"{t.tm_hour:02d}{t.tm_min:02d}{t.tm_sec:02d}")
    return path.with_name(f"{path.name}.backup-{stamp}")


def write_config(path: str | Path, config: dict, dry_run: bool = False,
                 clock: Callable[[], float] = time.time) -> dict:
    """Write a plugin config; existing files are left untouched."""
    path = Path(path)
    if path.exists():
        return {"path": str(path), "action": "kept-existing"}
    if dry_run:
        return {"path": str(path), "action": "would-create"}
    write_json_atomic(path, config)
    return {"path": str(path), "action": "created"}


def update_openclaw_config(path: str | Path, plugin_entries: dict,
                           dry_run: bool = False,
                           clock: Callable[[], float] = time.time) -> dict:
    """Merge plugin pointer entries into openclaw.json (existing entries
    win), with a timestamped backup of the original first."""
    path = Path(path)
    raw = path.read_text(encoding="utf-8") if path.exists() else ""
    if raw.strip():
        try:
            existing = parse_config(raw)
            if not isinstance(existing, dict):
                raise ValueError("top-level JSON value is not an object")
        except (json.JSONDecodeError, ValueError):
            # Never merge over a config we failed to parse — a wipe here
            # would destroy the user's agents/settings.
            return {"path": str(path), "action": "error", "added": [],
                    "error": "could not parse existing openclaw.json; not modifying it"}
    else:
        existing = {}
    plugins = dict(existing.get("plugins") or {})
    added = []
    for plugin_id, entry in plugin_entries.items():
        if plugin_id not in plugins:
            plugins[plugin_id] = entry
            added.append(plugin_id)
    if not added:
        return {"path": str(path), "action": "unchanged", "added": []}
    if dry_run:
        return {"path": str(path), "action": "would-update", "added": added}
    if path.exists():
        backup = backup_path(path, clock)
        backup.write_text(raw, encoding="utf-8")
    merged = {**existing, "plugins": plugins}
    write_json_atomic(path, merged)
    return {"path": str(path), "action": "updated", "added": added}
