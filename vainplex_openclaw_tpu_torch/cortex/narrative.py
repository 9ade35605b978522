"""Narrative generator — prose summary of threads/decisions to narrative.md
(reference: cortex/src/narrative-generator.ts).

A copy of ``vainplex_openclaw_tpu/cortex/narrative.py``."""

from __future__ import annotations

import time
from pathlib import Path
from typing import Callable

from .storage import iso_now, journal_barrier, load_json, reboot_dir, save_text


class NarrativeGenerator:
    def __init__(self, workspace: str | Path, logger,
                 clock: Callable[[], float] = time.time):
        self.workspace = Path(workspace)
        self.logger = logger
        self.clock = clock

    def generate(self) -> str:
        journal_barrier(self.workspace)
        rd = reboot_dir(self.workspace)
        threads_data = load_json(rd / "threads.json")
        decisions_data = load_json(rd / "decisions.json")
        threads = threads_data.get("threads") or []
        decisions = decisions_data.get("decisions") or []
        open_threads = [t for t in threads if t.get("status") == "open"]
        closed = [t for t in threads if t.get("status") == "closed"]
        mood = threads_data.get("session_mood", "neutral")

        lines = [f"# Narrative — {iso_now(self.clock)}", ""]
        if not threads and not decisions:
            lines.append("Nothing tracked yet this session.")
            return "\n".join(lines)

        summary = []
        if open_threads:
            titles = ", ".join(t["title"] for t in open_threads[:5])
            summary.append(f"Work continues on {len(open_threads)} open thread"
                           f"{'s' if len(open_threads) != 1 else ''}: {titles}.")
        if closed:
            summary.append(f"{len(closed)} thread{'s were' if len(closed) != 1 else ' was'} "
                           f"closed recently.")
        if decisions:
            last = decisions[-1]
            summary.append(f"Most recent decision: {last['what']!r}.")
        summary.append(f"The session mood reads as {mood}.")
        waiting = [t for t in open_threads if t.get("waiting_for")]
        if waiting:
            summary.append("Blocked: " + "; ".join(
                f"{t['title']} (waiting on {t['waiting_for']})" for t in waiting[:3]) + ".")
        lines.append(" ".join(summary))
        return "\n".join(lines)

    def write(self) -> bool:
        return save_text(reboot_dir(self.workspace) / "narrative.md",
                         self.generate(), self.logger)
