"""Buffered daily-JSONL audit trail with ISO-27001 control derivation
(reference: governance/src/audit-trail.ts:25-230, audit-redactor.ts).

Records buffer in memory and flush at 100 records (or on the interval timer /
shutdown). Denials always carry incident-response controls A.5.24/A.5.28.
Context fields are regex-redacted before buffering — secrets must never wait
in memory either.
"""

from __future__ import annotations

import os
import re
import time
from pathlib import Path
from typing import Callable, Optional

from ..resilience.faults import maybe_fail, write_with_faults
from ..utils.ids import prng_uuid4
from ..storage.atomic import (append_jsonl, jsonl_dumps, read_jsonl,
                              repair_torn_tail)
from ..storage.journal import dedup_against_tail
from .types import MatchedPolicy
from .util import ALTERNATION_UNSAFE

FLUSH_THRESHOLD = 100
# On persistent flush failure the buffer keeps at most this many records
# (configurable via audit.maxBufferedRecords); beyond it the OLDEST are
# dropped and counted as spilled — bounded memory, no silent loss.
MAX_BUFFERED_RECORDS = 10_000

# Audit ids are correlation ids, not capability tokens — the shared
# PRNG-backed UUID4 (utils/ids.py) drops the per-record urandom syscall
# that uuid.uuid4() pays on every evaluation.
_record_id = prng_uuid4


def derive_controls(matched: list[MatchedPolicy], verdict: str) -> list[str]:
    controls = set()
    for m in matched:
        controls.update(m.controls)
    if verdict == "deny":
        controls.update(("A.5.24", "A.5.28"))
    return sorted(controls)


def create_redactor_seq(patterns: list[str]):
    """Sequential per-pattern redactor — the equivalence oracle for
    ``create_redactor`` (the JAX package's
    tests/test_governance_plan_equiv.py)."""
    compiled = []
    for p in patterns or []:
        try:
            compiled.append(re.compile(p))
        except re.error:
            continue

    def redact_value(value):
        if isinstance(value, str):
            for rx in compiled:
                value = rx.sub("[REDACTED]", value)
            return value
        if isinstance(value, dict):
            return {k: redact_value(v) for k, v in value.items()}
        if isinstance(value, list):
            return [redact_value(v) for v in value]
        return value

    return redact_value


def create_redactor(patterns: list[str]):
    """Single-pass audit scrub. With no valid patterns the redactor is the
    identity (the old tree walk copied every record for nothing). Otherwise
    strings are screened once with an alternation-combined pattern and only
    hits pay the per-pattern substitution — output stays bit-identical to the
    sequential oracle because the substitutions themselves are unchanged.
    A combined-pattern false negative would LEAK (a secret skipped), so the
    pre-filter is dropped whenever the alternation cannot be trusted: any
    pattern with backreferences, or a combination that fails to compile
    (e.g. embedded global flags)."""
    valid: list[str] = []
    compiled = []
    for p in patterns or []:
        try:
            compiled.append(re.compile(p))
            valid.append(p)
        except re.error:
            continue
    if not compiled:
        return lambda value: value

    combined = None
    if not any(ALTERNATION_UNSAFE.search(p) for p in valid):
        try:
            combined = re.compile("|".join(f"(?:{p})" for p in valid))
        except re.error:
            combined = None
    screen = combined.search if combined is not None else None

    def redact_str(value: str) -> str:
        if screen is not None and screen(value) is None:
            return value
        for rx in compiled:
            value = rx.sub("[REDACTED]", value)
        return value

    def redact_value(value):
        if isinstance(value, str):
            return redact_str(value)
        if isinstance(value, dict):
            return {k: redact_value(v) for k, v in value.items()}
        if isinstance(value, list):
            return [redact_value(v) for v in value]
        return value

    return redact_value


class AuditTrail:
    STREAM = "governance:audit"

    def __init__(self, config: dict, workspace: str | Path, logger,
                 clock: Callable[[], float] = time.time, journal=None):
        self.config = config or {}
        self.audit_dir = Path(workspace) / "governance" / "audit"
        self.logger = logger
        self.clock = clock
        # Shared group-commit journal. Records append to the wal
        # per verdict and compact into the daily JSONL files on the SAME
        # cadence the legacy path flushed (FLUSH_THRESHOLD, failure backoff,
        # spill-to-cap) — flushFailures/spilled/buffered keep their exact
        # legacy semantics, the day files stay the read path, and recovery
        # replays crash-stranded records with tail dedup. ``journal=None``
        # is the storage.journal:false escape hatch (legacy buffer+append).
        # Registered at the END of __init__: registration may immediately
        # replay crash-stranded records through _journal_sink.
        self.journal = journal
        self._journal_buffered = 0
        self._day_meta: tuple = ("", None)
        self.redact = create_redactor(self.config.get("redactPatterns", []))
        # Optional deep scrubber (wired to the redaction subsystem's
        # credential-only engine): vault resolution re-injects REAL secrets
        # into tool params before governance evaluates/audits them, so the
        # audit path must scrub independently of user redactPatterns.
        self.scrubber = None
        self.buffer: list[dict] = []
        self.today_count = 0
        self.max_buffered = int(self.config.get("maxBufferedRecords",
                                                MAX_BUFFERED_RECORDS))
        self.flush_failures = 0
        self.spilled = 0
        self.replay_deduped = 0
        self.last_flush_error: Optional[str] = None
        # Flush gate with failure backoff: after a failed flush the next
        # attempt waits for FLUSH_THRESHOLD *more* records — re-encoding the
        # whole retained buffer on every record during an outage would turn
        # a disk failure into an O(n²) CPU failure on the verdict path.
        self._next_flush_len = FLUSH_THRESHOLD
        # Per-second / per-day caches and the controls memo: every record
        # was re-running strftime, gmtime, and a sorted() over an almost
        # always identical controls set.
        self._iso_cache: tuple[int, str] = (-1, "")
        self._date_cache: tuple[int, str] = (-1, "")
        self._controls_cache: dict[tuple, list[str]] = {}
        self._day_fh = None
        self._day_name = ""
        if journal is not None:
            journal.register_append(self.STREAM, self._journal_sink)

    def _date_str(self, ts: float) -> str:
        day = int(ts // 86400)
        if self._date_cache[0] != day:
            t = time.gmtime(ts)
            self._date_cache = (day, f"{t.tm_year:04d}-{t.tm_mon:02d}-{t.tm_mday:02d}")
        return self._date_cache[1]

    def _iso_str(self, ts: float) -> str:
        sec = int(ts)
        if self._iso_cache[0] != sec:
            self._iso_cache = (sec, time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(sec)))
        return self._iso_cache[1]

    def _controls_for(self, matched: list[MatchedPolicy], verdict: str) -> list[str]:
        key = (verdict == "deny", tuple(tuple(m.controls) for m in matched))
        cached = self._controls_cache.get(key)
        if cached is None:
            if len(self._controls_cache) > 1024:
                self._controls_cache.clear()
            cached = self._controls_cache[key] = derive_controls(matched, verdict)
        return list(cached)

    def load(self) -> None:
        self.audit_dir.mkdir(parents=True, exist_ok=True)
        self.clean_old_files()
        today = self.audit_dir / f"{self._date_str(self.clock())}.jsonl"
        self.today_count = sum(1 for _ in read_jsonl(today))
        self.logger.info("Audit trail loaded")

    def record(self, verdict: str, reason: str, context: dict, trust: dict,
               risk: dict, matched: list[MatchedPolicy], evaluation_us: int) -> dict:
        now = self.clock()
        if self.scrubber is not None:
            try:
                context = self.scrubber(context)
            except Exception as exc:  # noqa: BLE001 — scrub failure must not kill auditing
                self.logger.error(f"Audit scrubber failed: {exc}")
        rec = {
            "id": _record_id(),
            "timestamp": now * 1000,
            "timestampIso": self._iso_str(now),
            "verdict": verdict,
            "reason": reason,
            "context": self.redact(context),
            "trust": trust,
            "risk": risk,
            "matchedPolicies": [m.to_dict() for m in matched],
            "evaluationUs": evaluation_us,
            "controls": self._controls_for(matched, verdict),
        }
        if self.journal is not None:
            self.today_count += 1
            # Day routed at record time (legacy grouped per flush batch):
            # replayed records land in the same file a live flush would use.
            # One meta dict per day — the journal memoizes its encoding by
            # identity — and a local pending estimate (resynced on flush)
            # spares the verdict path a lock round-trip per record.
            day = self._date_str(now)
            if self._day_meta[0] != day:
                self._day_meta = (day, {"d": day})
            if self.journal.append(self.STREAM, rec, meta=self._day_meta[1]):
                self._journal_buffered += 1
                if self._journal_buffered >= self._next_flush_len:
                    self.flush()
                return rec
            # Journal closed (record NOT accepted): the record must not
            # vanish — fall through to the legacy buffer.
            self.today_count -= 1  # the legacy path re-counts below
        self.buffer.append(rec)
        self.today_count += 1
        if len(self.buffer) >= self._next_flush_len:
            self.flush()
        return rec

    def _journal_sink(self, batch: list, dedup: bool) -> None:
        """Journal compaction: append committed records to their day files.
        ``dedup=True`` after a failed/crashed attempt — records already at a
        target's tail are skipped (at-least-once, duplicates only across a
        torn line that never fully landed)."""
        by_day: dict[str, list] = {}
        for rec in batch:
            by_day.setdefault((rec[2] or {}).get("d") or
                              self._date_str(self.clock()), []).append(rec)
        for day, records in by_day.items():
            path = self.audit_dir / f"{day}.jsonl"
            if dedup:
                records, dropped = dedup_against_tail(path, records)
                self.replay_deduped += dropped
                if not records:
                    continue
            self._append_day_text(day, "".join(raw + "\n"
                                               for _q, raw, _m in records))

    def _journal_flush_failed(self) -> None:
        """Mirror of ``_flush_failed`` for journal compaction failures: same
        counters, same bounded retention (spill-to-cap, oldest counted), same
        threshold backoff — degradation must look identical either way."""
        self.flush_failures += 1
        self.last_flush_error = (self.journal.stream_error(self.STREAM)
                                 or self.journal.last_error or "journal compact failed")
        pending = self.journal.pending_count(self.STREAM)
        self.logger.error(f"Audit flush failed (#{self.flush_failures}, "
                          f"buffered={pending}): {self.last_flush_error}")
        if self._day_fh is not None and not self._day_fh.closed:
            try:
                self._day_fh.close()
            except OSError:
                pass
        self._day_fh, self._day_name = None, ""
        self.spilled += self.journal.spill(self.STREAM, self.max_buffered)
        self._next_flush_len = (self.journal.pending_count(self.STREAM)
                                + FLUSH_THRESHOLD)

    def flush(self) -> None:
        if self.journal is not None:
            if self.journal.pending_count(self.STREAM) == 0:
                self._journal_buffered = 0
                return
            if self.journal.compact(self.STREAM):
                self._next_flush_len = FLUSH_THRESHOLD
            else:
                self._journal_flush_failed()
            self._journal_buffered = self.journal.pending_count(self.STREAM)
            return
        if not self.buffer:
            return
        try:
            # The overwhelmingly common case is a same-day batch (the cached
            # _date_str makes this check a tuple compare per record): it
            # skips the per-record regroup and reuses one open handle.
            days = {self._date_str(rec["timestamp"] / 1000) for rec in self.buffer}
            if len(days) == 1:
                self._append_day(days.pop(), self.buffer)
            else:
                by_day: dict[str, list[dict]] = {}
                for rec in self.buffer:
                    by_day.setdefault(self._date_str(rec["timestamp"] / 1000),
                                      []).append(rec)
                for day, records in by_day.items():
                    append_jsonl(self.audit_dir / f"{day}.jsonl", records)
            self.buffer = []
            self._next_flush_len = FLUSH_THRESHOLD
        except OSError as exc:
            self._flush_failed(exc)

    def _flush_failed(self, exc: OSError) -> None:
        """Durability fallback: the audit log is the governance
        pipeline's anchor, so a failed day-file write must neither crash the
        verdict path nor grow the buffer without bound nor lose records
        silently. Records are retained for the next flush attempt up to
        ``max_buffered``; beyond that the oldest are dropped AND counted.
        Delivery is at-least-once: a failure mid-batch may leave part of the
        batch on disk and rewrite it next flush (duplicates over loss)."""
        self.flush_failures += 1
        self.last_flush_error = str(exc)
        self.logger.error(f"Audit flush failed (#{self.flush_failures}, "
                          f"buffered={len(self.buffer)}): {exc}")
        # The handle may point at a half-written line or a dead fd — drop it
        # so the next attempt reopens (and tail-repairs) cleanly.
        if self._day_fh is not None and not self._day_fh.closed:
            try:
                self._day_fh.close()
            except OSError:
                pass
        self._day_fh, self._day_name = None, ""
        overflow = len(self.buffer) - self.max_buffered
        if overflow > 0:
            del self.buffer[:overflow]
            self.spilled += overflow
        self._next_flush_len = len(self.buffer) + FLUSH_THRESHOLD

    def _append_day(self, day: str, records: list[dict]) -> None:
        self._append_day_text(day,
                              "".join(jsonl_dumps(rec) + "\n" for rec in records))

    def _append_day_text(self, day: str, text: str) -> None:
        """Append via a persistent per-day handle: reopening the same daily
        file on every 100-record flush was a measurable slice of the audit
        stage. The handle rolls over when the day does, is re-opened when the
        file on disk was rotated/deleted out from under it (writing to an
        unlinked inode would silently lose audit records), and contents are
        flushed to the OS before returning (query() reads the file back).
        Shared by the legacy flush and the journal compaction sink, so both
        modes pay the SAME ``audit.append`` fault site once per day-batch."""
        path = self.audit_dir / f"{day}.jsonl"
        fh = self._day_fh
        if fh is not None and not fh.closed and self._day_name == day:
            try:
                disk = os.stat(path)
                held = os.fstat(fh.fileno())
                if (disk.st_dev, disk.st_ino) != (held.st_dev, held.st_ino):
                    fh = None  # rotated: same name, different inode
            except OSError:
                fh = None  # deleted/renamed: recreate like the seed did
        if fh is None or fh.closed or self._day_name != day:
            if self._day_fh is not None and not self._day_fh.closed:
                self._day_fh.close()
            try:
                fh = path.open("a", encoding="utf-8")
            except FileNotFoundError:
                path.parent.mkdir(parents=True, exist_ok=True)
                fh = path.open("a", encoding="utf-8")
            # A torn tail from an earlier failed write (this process or a
            # crashed predecessor) must be newline-isolated before the batch
            # lands, or the first retried record merges into it and BOTH are
            # lost. An uninspectable tail fails the flush instead — records
            # stay buffered for retry.
            if not repair_torn_tail(path):
                fh.close()
                raise OSError("audit tail unrepaired; append deferred")
            self._day_fh, self._day_name = fh, day
        write_with_faults("audit.append", fh.write, text)
        fh.flush()

    def query(self, verdict: Optional[str] = None, agent_id: Optional[str] = None,
              since_ms: Optional[float] = None, limit: int = 100) -> list[dict]:
        self.flush()
        results: list[dict] = []
        if not self.audit_dir.exists():
            return results
        for f in sorted(self.audit_dir.glob("*.jsonl"), reverse=True):
            for rec in read_jsonl(f):
                if verdict and rec.get("verdict") != verdict:
                    continue
                if agent_id and (rec.get("context") or {}).get("agentId") != agent_id:
                    continue
                if since_ms and rec.get("timestamp", 0) < since_ms:
                    continue
                results.append(rec)
            if len(results) >= limit:
                break
        results.sort(key=lambda r: r.get("timestamp", 0), reverse=True)
        return results[:limit]

    def clean_old_files(self) -> None:
        retention_days = self.config.get("retentionDays", 90)
        cutoff = self._date_str(self.clock() - retention_days * 86400)
        for f in self.audit_dir.glob("*.jsonl"):
            if f.stem < cutoff:
                try:
                    f.unlink()
                except OSError:
                    pass

    def stats(self) -> dict:
        buffered = len(self.buffer)
        if self.journal is not None:
            buffered += self.journal.pending_count(self.STREAM)
        out = {"today": self.today_count, "buffered": buffered,
               "spilled": self.spilled, "flushFailures": self.flush_failures,
               "lastFlushError": self.last_flush_error}
        if self.journal is not None:
            out["journal"] = True
            out["replayDeduped"] = self.replay_deduped
        return out
