"""Boot context generator — writes BOOTSTRAP.md for session resume
(reference: cortex/src/boot-context.ts).

Char-budgeted (default 16k): execution mode by hour, open threads sorted
priority→recency, staleness warnings from the threads.json integrity block
(>2 h ⚠ / >8 h 🚨), hot snapshot if <1 h old, recent decisions, narrative if
<36 h old.

A copy of ``vainplex_openclaw_tpu/cortex/boot_context.py``.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Callable

from .storage import (is_file_older_than, iso_now, journal_barrier, load_json,
                      load_text, reboot_dir, save_text)

PRIORITY_ORDER = {"high": 0, "medium": 1, "low": 2}
PRIORITY_EMOJI = {"high": "🔴", "medium": "🟡", "low": "🟢"}
MOOD_EMOJI = {"frustrated": "😤", "excited": "🚀", "tense": "😬",
              "productive": "✅", "exploratory": "🤔", "neutral": "😐"}

DEFAULT_BOOT_CONFIG = {"enabled": True, "maxChars": 16_000, "maxThreads": 10,
                       "decisionDays": 3, "maxDecisions": 10}


def get_execution_mode(hour: int) -> str:
    if 6 <= hour < 12:
        return "Morning — brief, directive, efficient"
    if 12 <= hour < 18:
        return "Afternoon — execution mode"
    if 18 <= hour < 22:
        return "Evening — strategic, philosophical possible"
    return "Night — emergencies only"


class BootContextGenerator:
    def __init__(self, workspace: str | Path, config: dict, logger,
                 clock: Callable[[], float] = time.time):
        self.workspace = Path(workspace)
        self.config = {**DEFAULT_BOOT_CONFIG, **(config or {})}
        self.logger = logger
        self.clock = clock

    def _threads_data(self) -> dict:
        journal_barrier(self.workspace)  # make journaled state readable
        data = load_json(reboot_dir(self.workspace) / "threads.json")
        if isinstance(data, list):
            return {"threads": data}
        return data

    def open_threads(self) -> list[dict]:
        threads = [t for t in self._threads_data().get("threads", [])
                   if t.get("status") == "open"]
        # two stable sorts → priority asc, recency desc within priority
        threads.sort(key=lambda t: t.get("last_activity", ""), reverse=True)
        threads.sort(key=lambda t: PRIORITY_ORDER.get(t.get("priority"), 3))
        return threads[: self.config["maxThreads"]]

    def integrity_warning(self) -> str:
        integrity = self._threads_data().get("integrity") or {}
        last_ts = integrity.get("last_event_timestamp")
        if not last_ts:
            return "⚠️ No integrity data — thread tracker may not have run yet."
        try:
            import calendar

            parsed = calendar.timegm(time.strptime(last_ts[:19], "%Y-%m-%dT%H:%M:%S"))
        except (ValueError, TypeError):
            return "⚠️ Could not parse integrity timestamp."
        age_min = (self.clock() - parsed) / 60
        if age_min > 480:
            return f"🚨 STALE DATA: Thread data is {round(age_min / 60)}h old."
        if age_min > 120:
            return f"⚠️ Data staleness: Thread data is {round(age_min / 60)}h old."
        return ""

    def _hot_snapshot(self) -> str:
        path = reboot_dir(self.workspace) / "hot-snapshot.md"
        if is_file_older_than(path, 1, now=self.clock()):
            return ""
        return load_text(path).strip()[:1000]

    def _narrative(self) -> str:
        path = reboot_dir(self.workspace) / "narrative.md"
        if is_file_older_than(path, 36, now=self.clock()):
            return ""
        return load_text(path).strip()[:2000]

    def _recent_decisions(self) -> list[dict]:
        data = load_json(reboot_dir(self.workspace) / "decisions.json")
        decisions = data.get("decisions") or []
        cutoff = iso_now(lambda: self.clock() - self.config["decisionDays"] * 86400)[:10]
        return [d for d in decisions if d.get("date", "") >= cutoff][-self.config["maxDecisions"]:]

    def generate(self) -> str:
        hour = time.localtime(self.clock()).tm_hour
        data = self._threads_data()
        mood = data.get("session_mood", "neutral")
        parts = [
            f"# BOOTSTRAP — session context ({iso_now(self.clock)})",
            "",
            f"**Execution mode:** {get_execution_mode(hour)}",
            f"**Session mood:** {MOOD_EMOJI.get(mood, '😐')} {mood}",
        ]
        warning = self.integrity_warning()
        if warning:
            parts.append(f"\n{warning}")

        threads = self.open_threads()
        if threads:
            parts.append("\n## Open threads")
            for t in threads:
                emoji = PRIORITY_EMOJI.get(t.get("priority"), "🟡")
                line = f"- {emoji} **{t['title']}**"
                if t.get("waiting_for"):
                    line += f" — ⏳ waiting: {t['waiting_for']}"
                if t.get("decisions"):
                    line += f" ({len(t['decisions'])} decisions)"
                parts.append(line)

        snapshot = self._hot_snapshot()
        if snapshot:
            parts.append("\n## Hot snapshot (last conversation)")
            parts.append(snapshot)

        decisions = self._recent_decisions()
        if decisions:
            parts.append(f"\n## Decisions (last {self.config['decisionDays']} days)")
            for d in decisions:
                line = f"- {d['what']}"
                if d.get("why"):
                    line += f" — because {d['why']}"
                parts.append(line)

        narrative = self._narrative()
        if narrative:
            parts.append("\n## Narrative")
            parts.append(narrative)

        text = "\n".join(parts)
        return text[: self.config["maxChars"]]

    def write(self) -> bool:
        return save_text(reboot_dir(self.workspace) / "BOOTSTRAP.md",
                         self.generate(), self.logger)
