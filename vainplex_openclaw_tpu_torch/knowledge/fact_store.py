"""Fact store: subject–predicate–object triples with relevance lifecycle
(reference: knowledge-engine/src/fact-store.ts:11-264).

A copy of ``vainplex_openclaw_tpu/knowledge/fact_store.py`` on the port's
``storage.atomic``, ``storage.journal``, ``utils.ids`` and ``StageTimer``,
kept here so the port imports nothing of the JAX package. With the id RNG
seeded alike, both packages write the same ``facts.json``.

Content-dedupe boosts relevance on re-add; relevance decays on a
maintenance schedule; pruning drops the least relevant facts above the cap;
persistence is a debounced atomic write of ``facts.json`` (or a journaled
append when the workspace journal is on).

``add_fact`` dedupes through a ``(subject, predicate, object)`` index kept
in lockstep with ``self.facts``: O(1) per add instead of a scan over the
whole store. The scan survives as ``find_by_content_scan``, the oracle the
index is held against. ``query`` reads a cached lowercase haystack per
fact.
"""

from __future__ import annotations

import threading
import time
import uuid
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional

from ..storage.atomic import AtomicStorage
from ..utils.ids import prng_uuid4
from ..utils.stage_timer import StageTimer

DEFAULT_STORE_CONFIG = {
    "maxFacts": 2000,
    "writeDebounceMs": 2000,
    "relevanceBoost": 0.2,
    "decayFactor": 0.95,
    "pruneBelowRelevance": 0.05,
}

# Fact ids are storage keys, not security tokens: the shared
# process-seeded PRNG (utils/ids.py) keeps uuid4's collision math without
# a urandom syscall per fact.
_new_fact_id = prng_uuid4


@dataclass
class Fact:
    id: str
    subject: str
    predicate: str
    object: str
    source: str = "extracted-regex"
    created_at: str = ""
    last_accessed: str = ""
    relevance: float = 1.0

    def to_dict(self) -> dict:
        return {"id": self.id, "subject": self.subject, "predicate": self.predicate,
                "object": self.object, "source": self.source,
                "createdAt": self.created_at, "lastAccessed": self.last_accessed,
                "relevance": self.relevance}

    @classmethod
    def from_dict(cls, d: dict) -> "Fact":
        return cls(id=d.get("id") or str(uuid.uuid4()),
                   subject=d.get("subject", ""), predicate=d.get("predicate", ""),
                   object=d.get("object", ""), source=d.get("source", "unknown"),
                   created_at=d.get("createdAt", ""),
                   last_accessed=d.get("lastAccessed", ""),
                   relevance=float(d.get("relevance", 1.0)))

    def content_key(self) -> tuple[str, str, str]:
        return (self.subject, self.predicate, self.object)


class FactStore:
    def __init__(self, workspace: str | Path, config: Optional[dict] = None,
                 logger=None, clock: Callable[[], float] = time.time,
                 wall_timers: bool = True, timer: Optional[StageTimer] = None,
                 journal=None):
        self.config = {**DEFAULT_STORE_CONFIG, **(config or {})}
        self.logger = logger
        self.clock = clock
        self.timer = timer if timer is not None else StageTimer()
        # With the shared workspace journal the debounced facts.json save
        # is a group-committed wal append; None keeps the atomic rename.
        self.storage = AtomicStorage(Path(workspace) / "knowledge", wall=wall_timers,
                                     journal=journal, stream_prefix="knowledge")
        # Maintenance runs on a daemon thread while the gateway thread
        # ingests (RLock: add_fact's prune path re-enters).
        self._facts_lock = threading.RLock()
        self.facts: dict[str, Fact] = {}
        # (subject, predicate, object) → fact id, in lockstep with self.facts
        self._content_index: dict[tuple[str, str, str], str] = {}
        # fact id → (subject_lower, predicate_lower, "s p o" haystack_lower);
        # fields are immutable after creation, so the cache never goes stale
        self._lower: dict[str, tuple[str, str, str]] = {}
        self._iso_cache: tuple[int, str] = (-1, "")
        self.loaded = False

    def _iso(self) -> str:
        # second-resolution timestamps, cached per whole second
        now = int(self.clock())
        if self._iso_cache[0] != now:
            t = time.gmtime(now)
            self._iso_cache = (now, f"{t.tm_year:04d}-{t.tm_mon:02d}-{t.tm_mday:02d}T"
                                    f"{t.tm_hour:02d}:{t.tm_min:02d}:{t.tm_sec:02d}Z")
        return self._iso_cache[1]

    def load(self) -> None:
        with self._facts_lock:
            if self.loaded:
                return
            data = self.storage.load("facts.json")
            if isinstance(data, dict) and isinstance(data.get("facts"), list):
                self.facts = {f["id"]: Fact.from_dict(f) for f in data["facts"]
                              if f.get("id")}
                for fact in self.facts.values():
                    self._index(fact)
                if self.logger:
                    self.logger.info(f"Loaded {len(self.facts)} facts from storage")
            self.loaded = True

    def _snapshot_payload(self) -> dict:
        # The debounced supplier runs on the Debouncer's timer thread (or
        # the atexit flush): serialize under the lock, or a concurrent
        # add/decay/prune tears the fact list.
        with self._facts_lock:
            return {"version": 1, "updated": self._iso(),
                    "facts": [f.to_dict() for f in self.facts.values()]}

    def _commit(self) -> None:
        self.storage.save_debounced(
            "facts.json", self._snapshot_payload,
            delay_s=self.config["writeDebounceMs"] / 1000.0)

    def flush(self) -> None:
        if self.loaded:
            self.storage.flush_all()

    def hibernate(self) -> None:
        """Evict the store down to its journaled snapshot: flush the
        debounced save, then drop the in-RAM facts and both indexes. The
        next ``load()`` faults everything back in. The whole evict runs
        under ``_facts_lock`` (flush included), so a racing
        ``load()``/``add_fact()`` serializes entirely before or after it."""
        with self._facts_lock:
            if not self.loaded:
                return
            self.storage.flush_all()
            self.facts.clear()
            self._content_index.clear()
            self._lower.clear()
            self.loaded = False

    # ── content index ────────────────────────────────────────────────

    def _index(self, fact: Fact) -> None:
        # setdefault: where duplicate content keys are possible (an old
        # facts.json, or a fact inserted behind the store's back) the index
        # resolves to the FIRST fact in iteration order, as the scan does
        self._content_index.setdefault(fact.content_key(), fact.id)
        self._lower[fact.id] = (
            fact.subject.lower(), fact.predicate.lower(),
            f"{fact.subject} {fact.predicate} {fact.object}".lower())

    def _unindex(self, fact: Fact) -> None:
        key = fact.content_key()
        if self._content_index.get(key) == fact.id:
            del self._content_index[key]
            # fewer index entries than facts means a shadowed duplicate may
            # survive this removal and must inherit the key
            if len(self._content_index) + 1 < len(self.facts):
                for other in self.facts.values():
                    if other.id != fact.id and other.content_key() == key:
                        self._content_index[key] = other.id
                        break
        self._lower.pop(fact.id, None)

    def find_by_content_scan(self, subject: str, predicate: str,
                             object_: str) -> Optional[Fact]:
        """The O(n) dedupe scan, the oracle the index is held against."""
        with self._facts_lock:
            for fact in self.facts.values():
                if (fact.subject == subject and fact.predicate == predicate
                        and fact.object == object_):
                    return fact
            return None

    def add_fact(self, subject: str, predicate: str, object_: str,
                 source: str = "extracted-regex") -> Fact:
        if not self.loaded:
            raise RuntimeError("FactStore not loaded; call load() first")
        with self.timer.stage("ingest"), self._facts_lock:
            now = self._iso()
            existing_id = self._content_index.get((subject, predicate, object_))
            if existing_id is not None:
                fact = self.facts[existing_id]
                fact.relevance = min(1.0, fact.relevance + self.config["relevanceBoost"])
                fact.last_accessed = now
                self._commit()
                return fact
            fact = Fact(id=_new_fact_id(), subject=subject, predicate=predicate,
                        object=object_, source=source, created_at=now,
                        last_accessed=now, relevance=1.0)
            self.facts[fact.id] = fact
            self._index(fact)
            self._prune()
            self._commit()
            return fact

    def query(self, subject: Optional[str] = None, predicate: Optional[str] = None,
              text: Optional[str] = None, limit: int = 50) -> list[Fact]:
        with self.timer.stage("query"), self._facts_lock:
            out = []
            needle = (text or "").lower()
            subject_l = subject.lower() if subject else None
            predicate_l = predicate.lower() if predicate else None
            for fact in self.facts.values():
                cached = self._lower.get(fact.id)
                if cached is None:  # fact inserted behind the store's back
                    self._index(fact)
                    cached = self._lower[fact.id]
                sub_l, pred_l, haystack = cached
                if subject_l and sub_l != subject_l:
                    continue
                if predicate_l and pred_l != predicate_l:
                    continue
                if needle and needle not in haystack:
                    continue
                out.append(fact)
            # deterministic under relevance ties (created_at, then id)
            out.sort(key=lambda f: (-f.relevance, f.created_at, f.id))
            return out[:limit]

    def decay_facts(self) -> int:
        """One decay tick: relevance *= decayFactor; prune below threshold.
        An empty delta (nothing decayed, nothing pruned) writes nothing."""
        factor = self.config["decayFactor"]
        threshold = self.config["pruneBelowRelevance"]
        with self._facts_lock:
            dead = []
            for fact in self.facts.values():
                fact.relevance *= factor
                if fact.relevance < threshold:
                    dead.append(fact.id)
            for fid in dead:
                self._unindex(self.facts[fid])
                del self.facts[fid]
            if dead or (self.facts and factor != 1.0):
                self._commit()
            return len(dead)

    def _prune(self) -> None:
        cap = self.config["maxFacts"]
        if len(self.facts) <= cap:
            return
        ordered = sorted(self.facts.values(), key=lambda f: f.relevance)
        for fact in ordered[: len(self.facts) - cap]:
            self._unindex(fact)
            del self.facts[fact.id]

    def snapshot(self) -> list[Fact]:
        """Locked point-in-time list of live facts, what maintenance ticks
        iterate instead of the live dict."""
        with self._facts_lock:
            return list(self.facts.values())

    def count(self) -> int:
        return len(self.facts)
