"""Commitment tracker (reference: cortex/src/commitment-tracker.ts,
commitment-patterns.ts).

Detects promises ("I'll deploy it tomorrow"), marks them overdue after
``overdueDays`` (default 7), saves ``commitments.json`` behind a 15 s
debounce so chatty sessions don't thrash the disk.

A copy of ``vainplex_openclaw_tpu/cortex/commitment_tracker.py`` over the
port's ``storage.atomic.Debouncer``.
"""

from __future__ import annotations

import re
import time
from pathlib import Path
from typing import Callable, Optional

from ..storage.atomic import Debouncer
from ..utils.stage_timer import StageTimer
from .storage import ensure_reboot_dir, iso_now, load_json, new_id, reboot_dir, save_json

COMMITMENT_PATTERNS = [
    re.compile(r"\bI(?:'ll| will| am going to| can)\s+((?:\w+\s*){2,12})", re.IGNORECASE),
    re.compile(r"\b(?:ich werde|ich mach(?:e)? (?:das|es)|kümmere mich um)\s+((?:\w+\s*){1,12})",
               re.IGNORECASE),
    re.compile(r"\blet me\s+((?:\w+\s*){2,12})", re.IGNORECASE),
    re.compile(r"\bI(?:'ll| will)\s+get\s+(?:it|that|this)\s+((?:\w+\s*){1,8})", re.IGNORECASE),
]

# One combined scan screens all four patterns (same move as the
# MergedPatterns prefilter banks — all members are backref-free). A miss
# proves every finditer below would come up empty, and most traffic is a
# miss, so detect_commitments collapses to a single scan.
_COMMIT_SCREEN = re.compile(
    "|".join(f"(?i:{rx.pattern})" for rx in COMMITMENT_PATTERNS)).search

_NON_COMMITTAL = re.compile(r"^(?:think|guess|suppose|probably|maybe|see|check if)\b",
                            re.IGNORECASE)


def detect_commitments(text: str) -> list[str]:
    if _COMMIT_SCREEN(text) is None:
        return []
    out = []
    for rx in COMMITMENT_PATTERNS:
        for m in rx.finditer(text):
            what = m.group(1).strip().rstrip(".!,")
            if what and not _NON_COMMITTAL.match(what):
                out.append(what)
    return out


class CommitmentTracker:
    STREAM = "cortex:commitments"

    def __init__(self, workspace: str | Path, config: dict, logger,
                 clock: Callable[[], float] = time.time, wall_timers: bool = True,
                 timer: Optional[StageTimer] = None, journal=None):
        self.config = {"enabled": True, "overdueDays": 7, "maxCommitments": 100,
                       "debounceSeconds": 15, **(config or {})}
        self.logger = logger
        self.clock = clock
        self.timer = timer or StageTimer()
        self.path = reboot_dir(workspace) / "commitments.json"
        self.writeable = ensure_reboot_dir(workspace, logger)
        # Shared group-commit journal. The 15 s debounce cadence
        # stays either way; in journal mode a debounce fire appends the state
        # to the wal and compacts it back to commitments.json (see _save_now).
        # ``journal=None`` keeps the legacy debounced atomic write verbatim.
        self.journal = journal
        if journal is not None:
            journal.register_snapshot(self.STREAM, self.path, indent=None)
        data = load_json(self.path)
        self.commitments: list[dict] = data.get("commitments") or []
        self._dirty = False
        self._oldest_open = None  # mark_overdue watermark; None = recompute
        self._debouncer = Debouncer(self._save_now, self.config["debounceSeconds"],
                                    wall=wall_timers)

    def process_message(self, content: str, sender: str = "agent") -> None:
        if not content:
            return
        t_start = time.perf_counter()
        now = iso_now(self.clock)
        found = detect_commitments(content)
        for what in found:
            # restating an open OR overdue promise is not a new commitment —
            # it reopens the overdue one instead of duplicating it
            existing = next((c for c in self.commitments
                             if c["what"] == what and c["status"] in ("open", "overdue")),
                            None)
            if existing is not None:
                if existing["status"] == "overdue":
                    existing["status"] = "open"
                    existing["created"] = now
                    if self._oldest_open is not None and now < self._oldest_open:
                        self._oldest_open = now
                continue
            self.commitments.append({
                "id": new_id(), "what": what, "sender": sender,
                "status": "open", "created": now, "resolved": None,
            })
            if self._oldest_open is not None and now < self._oldest_open:
                self._oldest_open = now
        n_overdue = self.mark_overdue()
        if found or n_overdue:
            if len(self.commitments) > self.config["maxCommitments"]:
                self.commitments = self.commitments[-self.config["maxCommitments"]:]
            self._dirty = True
            self._debouncer.trigger()
        self.timer.add("commitments", (time.perf_counter() - t_start) * 1000.0)

    def mark_overdue(self) -> int:
        cutoff = iso_now(lambda: self.clock() - self.config["overdueDays"] * 86400)
        # Watermark fast path: the oldest open creation timestamp
        # bounds every open commitment, so while it is younger than the
        # cutoff no transition is possible and the per-message O(commitments)
        # scan is skipped. Any mutation that could add an older open record
        # resets the watermark to None (recompute on next scan).
        if self._oldest_open is not None and self._oldest_open >= cutoff:
            return 0
        n = 0
        oldest = None
        for c in self.commitments:
            if c["status"] == "open":
                if c["created"] < cutoff:
                    c["status"] = "overdue"
                    n += 1
                elif oldest is None or c["created"] < oldest:
                    oldest = c["created"]
        self._oldest_open = oldest or "~"  # "~" sorts after ISO stamps: none open
        if n:
            self._dirty = True  # direct callers rely on flush() persisting this
        return n

    def resolve(self, commitment_id: str) -> bool:
        for c in self.commitments:
            if c["id"] == commitment_id and c["status"] in ("open", "overdue"):
                c["status"] = "resolved"
                c["resolved"] = iso_now(self.clock)
                self._dirty = True
                self._debouncer.trigger()
                return True
        return False

    def open_commitments(self) -> list[dict]:
        return [c for c in self.commitments if c["status"] in ("open", "overdue")]

    def _save_now(self) -> None:
        if not self.writeable:
            return
        t0 = time.perf_counter()
        data = {"version": 1, "updated": iso_now(self.clock),
                "commitments": self.commitments}
        if self.journal is not None:
            # Commitments keep the 15 s debounce cadence in journal mode
            # (they were never the per-message bottleneck); a debounce fire
            # journals the state AND compacts it, so every reader of
            # commitments.json — including tests driving the debouncer
            # directly — sees the file current right after the save.
            ok = self.journal.append(self.STREAM, data)
            ok = self.journal.compact(self.STREAM) and ok
            if not ok:
                ok = save_json(self.path, data, self.logger)
        else:
            ok = save_json(self.path, data, self.logger)
        self.timer.add("persist", (time.perf_counter() - t0) * 1000.0)
        if ok:
            # A failed save must stay dirty so the next flush retries it —
            # clearing unconditionally would silently drop the state the old
            # always-write flush() used to recover.
            self._dirty = False

    def flush(self) -> bool:
        # Save once, iff there is anything to save: the
        # debouncer's flush already runs _save_now when work is pending, and
        # the old unconditional second _save_now() re-wrote an unchanged file
        # on every flush. _dirty covers mutations whose debounce timer
        # already fired and failed, or external mark_overdue transitions.
        self._debouncer.flush()
        if self._dirty:
            self._save_now()
        if self.journal is not None:
            return self.journal.compact(self.STREAM)
        return True
