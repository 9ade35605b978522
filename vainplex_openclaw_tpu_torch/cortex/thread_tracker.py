"""Thread tracker (reference: cortex/src/thread-tracker.ts).

Regex signal extraction (decision/close/wait/topic) → create/close/annotate
threads; fuzzy match = ≥2 significant-word title overlap; noise-topic filter;
mood detection; priority from high-impact keywords; prune closed threads
older than ``pruneDays`` and cap at ``maxThreads`` (open threads survive
first); persists ``threads.json`` v2 with an integrity block
``{last_event_timestamp, events_processed}`` consumed by boot-context
staleness warnings.

The per-message hot path is compiled: ``extract_signals`` screens each
signal category through the ``MergedPatterns`` prefilter banks (the verbatim
per-regex walk survives as ``extract_signals_interp``, the equivalence
oracle), and ``ThreadTracker`` tokenizes each text once and preselects
candidate threads through a word→thread inverted index over cached title
word-sets instead of re-lowering/splitting every title for every signal
(naive ``matches_thread`` kept as the oracle; ``compiledPatterns: false``
restores it end-to-end). Index invariants are documented in
docs/cortex-perf.md.

A copy of ``vainplex_openclaw_tpu/cortex/thread_tracker.py``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Optional

from ..utils.stage_timer import StageTimer
from .patterns import _UNSET, MergedPatterns, fold_lower
from .storage import ensure_reboot_dir, iso_now, load_json, new_id, reboot_dir, save_json


@dataclass
class ThreadSignals:
    decisions: list[str] = field(default_factory=list)
    closures: int = 0
    waits: list[str] = field(default_factory=list)
    topics: list[str] = field(default_factory=list)


def extract_signals_interp(text: str, patterns: MergedPatterns) -> ThreadSignals:
    """Per-regex interpreter walk, kept verbatim as the equivalence oracle
    for the bank-screened ``extract_signals`` (tests/test_cortex_perf_equiv.py).

    Context windows: decisions capture 50 chars before / 100 after the
    match; waits capture 80 chars forward (reference extractSignals)."""
    signals = ThreadSignals()
    for rx in patterns.decision:
        for m in rx.finditer(text):
            start = max(0, m.start() - 50)
            end = min(len(text), m.end() + 100)
            signals.decisions.append(text[start:end].strip())
    for rx in patterns.close:
        if rx.search(text):
            signals.closures += 1
    for rx in patterns.wait:
        for m in rx.finditer(text):
            end = min(len(text), m.end() + 80)
            signals.waits.append(text[m.start():end].strip())
    for rx in patterns.topic:
        for m in rx.finditer(text):
            if m.groups() and m.group(1):
                signals.topics.append(m.group(1).strip())
    return signals


def extract_signals(text: str, patterns: MergedPatterns,
                    low=_UNSET) -> ThreadSignals:
    """Bank-screened extraction: the text is lowercased ONCE and each signal
    category asks its required-literal bank "can anything here match?" before
    any per-member finditer runs — the common all-miss message pays four
    substring sweeps instead of ~40 per-pattern regex walks with all ten
    packs selected. Falls back to the interpreter when the
    patterns were built with ``compiled=False``."""
    if not patterns.compiled:
        return extract_signals_interp(text, patterns)
    if low is _UNSET:
        low = fold_lower(text)
    signals = ThreadSignals()
    pf = patterns.prefilter
    for rx in pf["decision"].walk_list(low):
        for m in rx.finditer(text):
            start = max(0, m.start() - 50)
            end = min(len(text), m.end() + 100)
            signals.decisions.append(text[start:end].strip())
    for rx in pf["close"].walk_list(low):
        if rx.search(text):
            signals.closures += 1
    for rx in pf["wait"].walk_list(low):
        for m in rx.finditer(text):
            end = min(len(text), m.end() + 80)
            signals.waits.append(text[m.start():end].strip())
    for rx in pf["topic"].walk_list(low):
        for m in rx.finditer(text):
            if m.groups() and m.group(1):
                signals.topics.append(m.group(1).strip())
    return signals


def matches_thread(title: str, text: str, min_overlap: int = 2) -> bool:
    """≥ min_overlap shared words (len>2) between thread title and text."""
    title_words = {w for w in title.lower().split() if len(w) > 2}
    text_words = {w for w in text.lower().split() if len(w) > 2}
    return len(title_words & text_words) >= min_overlap


def _sig_words(text: str) -> frozenset:
    """The exact tokenization ``matches_thread`` applies to both sides."""
    return frozenset(w for w in text.lower().split() if len(w) > 2)


class ThreadTracker:
    STREAM = "cortex:threads"

    def __init__(self, workspace: str | Path, config: dict, patterns: MergedPatterns,
                 logger, clock: Callable[[], float] = time.time,
                 timer: Optional[StageTimer] = None, journal=None):
        self.config = {"enabled": True, "pruneDays": 7, "maxThreads": 50, **(config or {})}
        self.patterns = patterns
        self.logger = logger
        self.clock = clock
        self.timer = timer or StageTimer()
        self.path = reboot_dir(workspace) / "threads.json"
        self.writeable = ensure_reboot_dir(workspace, logger)
        # Group-commit WAL: per-message persists append the full
        # state to the shared journal instead of paying an atomic rename each
        # message; registration completes any crash-interrupted compaction so
        # the load below sees the journaled state. ``journal=None`` (the
        # storage.journal:false escape hatch, and every direct construction
        # in tests) keeps the legacy write-per-message path verbatim.
        self.journal = journal
        if journal is not None:
            journal.register_snapshot(self.STREAM, self.path, indent=None)
        data = load_json(self.path)
        if isinstance(data, list):  # legacy format: bare array
            data = {"threads": data}
        self.threads: list[dict] = data.get("threads") or []
        self.session_mood: str = data.get("session_mood", "neutral")
        self.events_processed: int = (data.get("integrity") or {}).get("events_processed", 0)
        self.last_event_timestamp: str = ""
        self.dirty = False
        # Word→thread inverted index over cached title word-sets:
        # candidate threads for a text are found in O(text words) instead of
        # re-tokenizing every title per signal. Kept in lockstep by
        # create/LLM-merge (_index_thread), prune/cap (_reindex on shrink),
        # and load (here). Thread dicts are keyed by object identity — in-
        # place status/mood mutation (tests do this) never desyncs it; title
        # mutation would, and nothing in the codebase mutates titles.
        self._title_words: dict[int, frozenset] = {}
        self._by_word: dict[str, list[dict]] = {}
        self._exact_titles: dict[str, int] = {}
        self._reindex()

    # ── title index ──────────────────────────────────────────────────

    def _reindex(self) -> None:
        self._title_words.clear()
        self._by_word.clear()
        self._exact_titles.clear()
        for t in self.threads:
            self._index_thread(t)

    def _index_thread(self, t: dict) -> None:
        words = _sig_words(t["title"])
        self._title_words[id(t)] = words
        for w in words:
            self._by_word.setdefault(w, []).append(t)
        key = t["title"].lower()
        self._exact_titles[key] = self._exact_titles.get(key, 0) + 1

    def _matched_ids(self, text: str, text_words: Optional[frozenset] = None) -> set:
        """ids (object identities) of threads whose title shares ≥2
        significant words with ``text`` — the ``matches_thread`` predicate,
        answered through the index. Falls back to the naive title walk when
        the pattern registry runs in interpreter mode."""
        if not self.patterns.compiled:
            return {id(t) for t in self.threads if matches_thread(t["title"], text)}
        if text_words is None:
            text_words = _sig_words(text)
        counts: dict[int, int] = {}
        for w in text_words:
            for t in self._by_word.get(w, ()):
                k = id(t)
                counts[k] = counts.get(k, 0) + 1
        # Each title word posts once, so count == |title_words ∩ text_words|.
        return {k for k, n in counts.items() if n >= 2}

    # ── processing ───────────────────────────────────────────────────

    def process_message(self, content: str, sender: str = "user",
                        low=_UNSET) -> None:
        if not content:
            return
        pc = time.perf_counter
        t0 = pc()
        if low is _UNSET:
            # One guard scan + one lowercase copy serves extract AND mood —
            # and the plugin passes it in so DecisionTracker shares it too.
            low = fold_lower(content) if self.patterns.compiled else None
        signals = extract_signals(content, self.patterns, low)
        t1 = pc()
        mood = self.patterns.detect_mood(content, low)
        t2 = pc()
        now = iso_now(self.clock)
        self.events_processed += 1
        self.last_event_timestamp = now
        if mood != "neutral":
            self.session_mood = mood
        if len(self._title_words) != len(self.threads):
            self._reindex()  # threads list replaced/extended externally

        self._create_from_topics(signals.topics, sender, mood, now)
        # One tokenize + one index probe covers close/wait/mood — they all
        # ask "which threads does CONTENT match" (computed after topic
        # creation, like the interpreter's per-stage walks).
        matched = None
        if signals.closures or signals.waits or mood != "neutral":
            matched = self._matched_ids(content)
        if signals.closures:
            self._close_matching(matched, now)
        self._apply_decisions(signals.decisions, now)
        self._apply_waits(signals.waits, matched, now)
        self._apply_mood(mood, matched)

        self.dirty = True
        self._prune_and_cap()
        t3 = pc()
        self.persist()
        self.timer.add_many((("extract", (t1 - t0) * 1000.0),
                             ("mood", (t2 - t1) * 1000.0),
                             ("threads", (t3 - t2) * 1000.0)))

    def _exists(self, title: str) -> bool:
        if not self.patterns.compiled:
            return any(t["title"].lower() == title.lower() or matches_thread(t["title"], title)
                       for t in self.threads)
        return title.lower() in self._exact_titles or bool(self._matched_ids(title))

    def _create_from_topics(self, topics: list[str], sender: str, mood: str, now: str) -> None:
        for topic in topics:
            if self.patterns.is_noise_topic(topic) or self._exists(topic):
                continue
            t = {
                "id": new_id(), "title": topic, "status": "open",
                "priority": self.patterns.infer_priority(topic),
                "summary": f"Topic detected from {sender}", "decisions": [],
                "waiting_for": None, "mood": mood, "last_activity": now, "created": now,
            }
            self.threads.append(t)
            self._index_thread(t)

    def _close_matching(self, matched: set, now: str) -> None:
        for t in self.threads:
            if t["status"] == "open" and id(t) in matched:
                t["status"] = "closed"
                t["last_activity"] = now

    def _apply_decisions(self, decisions: list[str], now: str) -> None:
        for ctx in decisions:
            matched = self._matched_ids(ctx)
            if not matched:
                continue
            for t in self.threads:
                if t["status"] == "open" and id(t) in matched:
                    short = ctx[:100]
                    if short not in t["decisions"]:
                        t["decisions"].append(short)
                        t["last_activity"] = now

    def _apply_waits(self, waits: list[str], matched: Optional[set], now: str) -> None:
        for wait_ctx in waits:
            for t in self.threads:
                if t["status"] == "open" and id(t) in matched:
                    t["waiting_for"] = wait_ctx[:100]
                    t["last_activity"] = now

    def _apply_mood(self, mood: str, matched: Optional[set]) -> None:
        if mood == "neutral":
            return
        for t in self.threads:
            if t["status"] == "open" and id(t) in matched:
                t["mood"] = mood

    def apply_llm_analysis(self, analysis: dict) -> None:
        """Merge an LLM conversation-analysis result (threads/closures/mood)."""
        now = iso_now(self.clock)
        if len(self._title_words) != len(self.threads):
            self._reindex()
        for lt in analysis.get("threads", []):
            title = lt.get("title", "")
            if not title or self.patterns.is_noise_topic(title) or self._exists(title):
                continue
            t = {
                "id": new_id(), "title": title,
                "status": lt.get("status", "open"),
                "priority": self.patterns.infer_priority(title),
                "summary": lt.get("summary") or "LLM-detected", "decisions": [],
                "waiting_for": None, "mood": analysis.get("mood", "neutral"),
                "last_activity": now, "created": now,
            }
            self.threads.append(t)
            self._index_thread(t)
        for closure in analysis.get("closures", []):
            matched = self._matched_ids(closure)
            for t in self.threads:
                if t["status"] == "open" and id(t) in matched:
                    t["status"] = "closed"
                    t["last_activity"] = now
        mood = analysis.get("mood")
        if mood and mood != "neutral":
            self.session_mood = mood
        self.dirty = True
        self.persist()

    # ── retention & persistence ──────────────────────────────────────

    def _prune_and_cap(self) -> None:
        before = len(self.threads)
        cutoff_ts = self.clock() - self.config["pruneDays"] * 86400
        cutoff = iso_now(lambda: cutoff_ts)
        self.threads = [t for t in self.threads
                        if not (t["status"] == "closed" and t["last_activity"] < cutoff)]
        if len(self.threads) > self.config["maxThreads"]:
            open_threads = [t for t in self.threads if t["status"] == "open"]
            closed = sorted((t for t in self.threads if t["status"] == "closed"),
                            key=lambda t: t["last_activity"])
            budget = max(0, self.config["maxThreads"] - len(open_threads))
            self.threads = open_threads + closed[len(closed) - budget:]
        if len(self.threads) != before:
            self._reindex()  # both branches only ever shrink the list

    def _build_data(self) -> dict:
        return {
            "version": 2,
            "updated": iso_now(self.clock),
            "threads": self.threads,
            "integrity": {
                "last_event_timestamp": self.last_event_timestamp or iso_now(self.clock),
                "events_processed": self.events_processed,
                "source": "hooks",
            },
            "session_mood": self.session_mood,
        }

    def persist(self) -> None:
        # Write-per-message is deliberate reference parity (thread-tracker.ts
        # processMessage → persist()): threads.json must survive a crash at
        # any point — it feeds boot context. Commitments, which are lower
        # stakes, use the debounced path instead.
        if not self.writeable:
            return
        t0 = time.perf_counter()
        ok = self._save(self._build_data())
        self.timer.add("persist", (time.perf_counter() - t0) * 1000.0)
        if not ok:
            self.writeable = False
            self.logger.warn("Workspace not writable — running in-memory only")
        else:
            self.dirty = False

    def _save(self, data: dict) -> bool:
        if self.journal is not None:
            # Journal enqueue: buffered now, group-committed within the
            # bounded window, compacted back to threads.json on flush/size
            # thresholds. A failed inline commit falls back to the legacy
            # atomic write so the state never rides on a broken journal.
            if self.journal.append(self.STREAM, data):
                return True
            return save_json(self.path, data, self.logger)
        return save_json(self.path, data, self.logger)

    def flush(self) -> bool:
        if self.journal is not None:
            # Journal mode: compaction makes threads.json current even when
            # nothing is dirty here (earlier appends may still sit in the
            # wal) — flush is the read-your-writes barrier.
            if self.dirty and self.writeable:
                if self._save(self._build_data()):
                    self.dirty = False
            return self.journal.compact(self.STREAM)
        if not self.dirty:
            return True
        ok = save_json(self.path, self._build_data(), self.logger)
        if ok:
            # Mirror persist(): an unchanged file must not be re-written by
            # every later flush (the flag never cleared).
            self.dirty = False
        return ok

    # ── queries ──────────────────────────────────────────────────────

    def open_threads(self) -> list[dict]:
        return [t for t in self.threads if t["status"] == "open"]

    def counts(self) -> dict:
        open_n = len(self.open_threads())
        return {"open": open_n, "closed": len(self.threads) - open_n,
                "mood": self.session_mood, "events": self.events_processed}
