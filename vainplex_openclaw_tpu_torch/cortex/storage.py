"""Cortex storage conventions (reference: cortex/src/storage.ts:10-45).

State under ``<workspace>/memory/reboot/``; atomic writes; read-only
workspaces flip components to in-memory mode instead of crashing.

A copy of ``vainplex_openclaw_tpu/cortex/storage.py`` over the port's
``storage/`` and ``utils/ids.prng_uuid4``.
"""

from __future__ import annotations

import time
from functools import lru_cache
from pathlib import Path
from typing import Any

from ..storage.atomic import read_json, write_json_atomic
from ..storage.journal import peek_journal
from ..storage.workspace import is_file_older_than, is_writable, reboot_dir
from ..utils.ids import prng_uuid4

__all__ = ["ensure_reboot_dir", "is_file_older_than", "journal_barrier",
           "load_json", "load_text", "new_id", "reboot_dir", "save_json",
           "save_text"]


def journal_barrier(workspace: str | Path) -> None:
    """Read barrier for file-mediated readers: when the workspace
    persists through the group-commit journal, tracker state may still sit
    in the wal — compacting first makes the JSON files current, so readers
    (agent tools, boot context, narrative) keep their read-the-file
    convention untouched. A no-op without a journal; compaction errors are
    the journal's to count, never the reader's to crash on."""
    j = peek_journal(workspace)
    if j is not None:
        try:
            j.compact()
        except Exception:  # noqa: BLE001 — readers must stay fail-open
            pass


def ensure_reboot_dir(workspace: str | Path, logger=None) -> bool:
    ok = is_writable(reboot_dir(workspace))
    if not ok and logger is not None:
        logger.warn("Workspace not writable — running in-memory only")
    return ok


def load_json(path: str | Path, default: Any = None) -> Any:
    return read_json(path, default if default is not None else {})


def save_json(path: str | Path, obj: Any, logger=None) -> bool:
    # indent=None routes through storage.atomic's prebuilt C encoder — the
    # trackers persist on EVERY message (reference parity), and the pretty
    # printer's pure-Python _iterencode was >20% of per-message ingest
    # ("cheap persist"). Readers all json.loads; none pin layout.
    try:
        write_json_atomic(path, obj, indent=None)
        return True
    except OSError as exc:
        if logger is not None:
            logger.warn(f"save failed for {path}: {exc}")
        return False


def load_text(path: str | Path) -> str:
    try:
        return Path(path).read_text(encoding="utf-8")
    except OSError:
        return ""


def save_text(path: str | Path, text: str, logger=None) -> bool:
    try:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(path.name + ".tmp")
        tmp.write_text(text, encoding="utf-8")
        tmp.replace(path)
        return True
    except OSError as exc:
        if logger is not None:
            logger.warn(f"save failed for {path}: {exc}")
        return False


@lru_cache(maxsize=64)
def _iso_from_sec(sec: int) -> str:
    t = time.gmtime(sec)
    return (f"{t.tm_year:04d}-{t.tm_mon:02d}-{t.tm_mday:02d}T"
            f"{t.tm_hour:02d}:{t.tm_min:02d}:{t.tm_sec:02d}Z")


def iso_now(clock=time.time) -> str:
    # Per-second cache (same discipline as governance/audit.py and
    # knowledge/fact_store.py): the trackers call this several times per
    # message and gmtime+format was pure waste within one second. int() ==
    # gmtime's floor for the positive epochs every caller uses; the lru keys
    # on the second itself, so interleaved FakeClocks can't cross-pollute.
    v = clock() if callable(clock) else clock
    return _iso_from_sec(int(v))


# Tracker ids are correlation ids, not capability tokens — the shared
# PRNG-backed UUID4 drops the per-creation urandom syscall (utils/ids.py,
# one copy serving audit, knowledge, and cortex).
new_id = prng_uuid4
