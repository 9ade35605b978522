"""Decision tracker (reference: cortex/src/decision-tracker.ts).

Decision-pattern matches become ``{what, why}`` records: *what* is the
50-before/100-after context window around the match, *why* is a trailing
"because/so that/weil…" clause when present. Impact inferred from
high-impact keywords; duplicates within ``dedupeWindowHours`` are dropped;
persists ``decisions.json``.

A copy of ``vainplex_openclaw_tpu/cortex/decision_tracker.py``.
"""

from __future__ import annotations

import re
import time
from pathlib import Path
from typing import Callable, Optional

from ..utils.stage_timer import StageTimer
from .patterns import _UNSET, MergedPatterns, fold_lower
from .storage import ensure_reboot_dir, iso_now, load_json, new_id, reboot_dir, save_json

_WHY_RE = re.compile(
    r"(?:because|so that|since|weil|damit|porque|parce que|因为|なぜなら|왜냐하면)\s+(.{5,120})",
    re.IGNORECASE)


class DecisionTracker:
    STREAM = "cortex:decisions"

    def __init__(self, workspace: str | Path, config: dict, patterns: MergedPatterns,
                 logger, clock: Callable[[], float] = time.time,
                 timer: Optional[StageTimer] = None, journal=None):
        self.config = {"enabled": True, "dedupeWindowHours": 24, "maxDecisions": 200,
                       **(config or {})}
        self.patterns = patterns
        self.logger = logger
        self.clock = clock
        self.timer = timer or StageTimer()
        self.path = reboot_dir(workspace) / "decisions.json"
        self.writeable = ensure_reboot_dir(workspace, logger)
        # Shared group-commit journal; None = legacy write path.
        self.journal = journal
        if journal is not None:
            journal.register_snapshot(self.STREAM, self.path, indent=None)
        data = load_json(self.path)
        self.decisions: list[dict] = data.get("decisions") or []

    def _decision_patterns(self, content: str, low=_UNSET):
        """Decision regexes that still need walking — screened through the
        shared MergedPatterns required-literal bank (one lowercase + a few
        C substring sweeps skip all members on the common no-decision
        message), or the full list in interpreter mode."""
        if not self.patterns.compiled:
            return self.patterns.decision
        if low is _UNSET:
            low = fold_lower(content)
        return self.patterns.prefilter["decision"].walk_list(low)

    def process_message(self, content: str, sender: str = "user",
                        low=_UNSET) -> None:
        if not content:
            return
        t_start = time.perf_counter()
        now = iso_now(self.clock)
        added = False
        for rx in self._decision_patterns(content, low):
            for m in rx.finditer(content):
                start = max(0, m.start() - 50)
                end = min(len(content), m.end() + 100)
                what = content[start:end].strip()
                why_match = _WHY_RE.search(content, m.end())
                why = why_match.group(1).strip() if why_match else None
                if why_match is not None and why_match.start() < end:
                    # don't repeat the why-clause inside the what window
                    what = content[start:why_match.start()].strip()
                # dedupe and impact both consider the full what+why text:
                # decisions differing only in rationale are distinct, and
                # high-impact keywords in the rationale still count
                # (reference decision-tracker.ts infers from what + why)
                full_text = f"{what} {why}" if why else what
                if self._is_duplicate(full_text):
                    continue
                self.decisions.append({
                    "id": new_id(),
                    "what": what,
                    "why": why,
                    "impact": self._infer_impact(full_text),
                    "sender": sender,
                    "date": now[:10],
                    "timestamp": now,
                })
                added = True
        self.timer.add("decisions", (time.perf_counter() - t_start) * 1000.0)
        if added:
            if len(self.decisions) > self.config["maxDecisions"]:
                self.decisions = self.decisions[-self.config["maxDecisions"]:]
            self.persist()

    def _infer_impact(self, text: str) -> str:
        return self.patterns.infer_priority(text)  # high-impact keywords → "high"

    def _is_duplicate(self, text: str) -> bool:
        """Compare the candidate's full what+why text against stored ones."""
        cutoff_ts = self.clock() - self.config["dedupeWindowHours"] * 3600
        cutoff = iso_now(lambda: cutoff_ts)
        words = {w for w in text.lower().split() if len(w) > 2}
        for d in reversed(self.decisions):
            if d["timestamp"] < cutoff:
                break
            stored = f"{d['what']} {d['why']}" if d.get("why") else d["what"]
            d_words = {w for w in stored.lower().split() if len(w) > 2}
            union = words | d_words
            if union and len(words & d_words) / len(union) > 0.6:
                return True
        return False

    def add_llm_decisions(self, decisions: list[str], sender: str = "llm") -> None:
        """Merge LLM-detected decisions the regex pass missed."""
        now = iso_now(self.clock)
        added = False
        for what in decisions:
            what = (what or "").strip()[:200]
            if not what or self._is_duplicate(what):
                continue
            self.decisions.append({
                "id": new_id(), "what": what, "why": None,
                "impact": self._infer_impact(what), "sender": sender,
                "date": now[:10], "timestamp": now,
            })
            added = True
        if added:
            self.persist()

    def recent(self, days: int, limit: int) -> list[dict]:
        cutoff = iso_now(lambda: self.clock() - days * 86400)[:10]
        return [d for d in self.decisions if d["date"] >= cutoff][-limit:]

    def persist(self) -> None:
        if not self.writeable:
            return
        t0 = time.perf_counter()
        data = {"version": 1, "updated": iso_now(self.clock),
                "decisions": self.decisions}
        if self.journal is not None:
            if not self.journal.append(self.STREAM, data):
                save_json(self.path, data, self.logger)
        else:
            save_json(self.path, data, self.logger)
        self.timer.add("persist", (time.perf_counter() - t0) * 1000.0)

    def flush(self) -> bool:
        self.persist()
        if self.journal is not None:
            return self.journal.compact(self.STREAM)
        return True
