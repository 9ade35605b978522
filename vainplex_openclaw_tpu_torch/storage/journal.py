"""Journal helpers the port's event log needs.

A copy of ``tail_lines`` and ``dedup_against_tail`` from
``vainplex_openclaw_tpu/storage/journal.py``, kept here so the port imports
nothing of the JAX package. The group-commit ``Journal`` itself is not
ported yet; :class:`..events.transport.FileTransport` takes any object with
its interface.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional


def tail_lines(path: str | Path, max_bytes: int = 1 << 20) -> list[bytes]:
    """Complete lines from the last ``max_bytes`` of ``path`` (no partial
    leading line unless the read covered the whole file)."""
    try:
        with Path(path).open("rb") as fh:
            fh.seek(0, 2)
            size = fh.tell()
            start = max(0, size - max_bytes)
            fh.seek(start)
            chunk = fh.read()
    except OSError:
        return []
    lines = chunk.split(b"\n")
    if start > 0:
        lines = lines[1:]  # partial leading line
    return [ln for ln in lines if ln.strip()]


def dedup_against_tail(path: str | Path,
                       batch: list[tuple[int, str, Optional[dict]]],
                       ) -> tuple[list[tuple[int, str, Optional[dict]]], int]:
    """Drop batch records already present at the tail of ``path``.

    Compaction appends in seq order, so a failed earlier attempt left a
    PREFIX of this batch as the target's suffix; exact line membership in
    the tail is a safe dedupe key (encodings are deterministic). A torn
    final line never matches, so the torn record is re-appended whole:
    duplicates over loss. Returns (kept, dropped)."""
    present = set(tail_lines(path))
    if not present:
        return batch, 0
    kept = [rec for rec in batch if rec[1].encode("utf-8") not in present]
    return kept, len(batch) - len(kept)
