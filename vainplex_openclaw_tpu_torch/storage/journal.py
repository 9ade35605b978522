"""Shared group-commit write-ahead journal.

A copy of ``vainplex_openclaw_tpu/storage/journal.py``, kept here so the
port imports nothing of the JAX package; it writes the same files byte for
byte, so a workspace journaled by one package replays in the other. One
append-only journal per workspace replaces a rewrite per record:

- Writers ``append()`` compact JSONL records; appends only *buffer* (a lock
  and a list op). A **group commit** drains the buffer into the open journal
  segment with a single ``write()`` and — per the ``fsync`` policy — a single
  ``fsync()`` amortized across the whole batch. Commits trigger on a batch
  threshold, a bounded wall-clock window, an explicit flush, or inline per
  record in ``fsync:"always"`` (reference-parity zero loss window).
- **Snapshot streams** (cortex trackers, knowledge facts) journal the FULL
  state per append; buffered records coalesce — only the newest state of a
  stream hits disk per commit, because replay only ever needs the last one.
- **Append streams** (audit trail, event-store day files) journal each
  record; compaction hands batches to the owner's sink, which appends them to
  the legacy on-disk representation.
- **Compaction** moves committed records into the legacy files (atomic JSON
  snapshots / daily JSONL) and advances a per-stream watermark persisted in
  ``journal.meta.json``. The legacy files stay the read path — queries,
  sitrep, and boot context never learn the journal exists.
- **Recovery**: on open, the journal replays segments through
  ``read_jsonl`` + ``repair_torn_tail`` (the torn-tail machinery),
  keeps records above each stream's watermark, and completes the compaction
  a crash interrupted when the owner registers its stream. Replay/repair
  counts (including ``JsonlReadReport`` torn/corrupt lines) are surfaced in
  ``stats()["replay"]`` — a repaired tail must be visible, never silent.

Durability semantics are **at-least-once**: a crash between a sink append
and the watermark write may re-deliver a batch, so append-stream compaction
dedupes replayed records against the target's tail
(:func:`dedup_against_tail`). The loss window is the commit window
(``windowMs``/``maxBatchRecords``), configurable to zero via
``fsync:"always"``; ``fsync:"os"`` matches the legacy paths' page-cache
durability exactly (the legacy paths never fsync).

Every consumer keeps its legacy persist path intact behind
``storage.journal: false`` — the pinned durability/equivalence oracle.
"""

from __future__ import annotations

import atexit
import gzip
import os
import threading
import time
import weakref
from pathlib import Path
from typing import Any, Callable, Optional

from ..resilience.faults import maybe_fail, write_with_faults
from ..utils.stage_timer import StageTimer
from .atomic import (JsonlReadReport, jsonl_dumps, read_json, read_jsonl,
                     repair_torn_tail, write_json_atomic)

DEFAULT_JOURNAL_SETTINGS = {
    "enabled": True,
    "dir": "journal",
    # "group": one fsync per commit batch; "always": fsync inline per append
    # (zero loss window, reference parity+); "os": never fsync — exactly the
    # page-cache durability of the legacy rename/append paths.
    "fsync": "group",
    "windowMs": 20.0,
    "maxBatchRecords": 128,
    "maxPendingRecords": 10_000,
    "compactEveryRecords": 512,
    "maxSegmentBytes": 8 * 1024 * 1024,
}

_META_NAME = "journal.meta.json"


class FencedWriteError(OSError):
    """A write stamped with a stale lease epoch. Subclasses
    OSError so owner persist paths treat it like any other failed write —
    state stays dirty/retrying — but, critically, ``append()`` RAISES it
    rather than returning False: False means "journal closed, use your
    legacy path", and routing a fenced zombie into the legacy atomic-rename
    write would reopen the exact split-brain window the fence closes."""


def journal_settings(config: Optional[dict],
                     default_enabled: bool = True) -> dict:
    """Resolve a plugin config's ``storage.journal`` section (bool or dict)
    into full settings. ``storage.journal: false`` is the escape hatch that
    restores the legacy persist path end-to-end."""
    raw = ((config or {}).get("storage") or {}).get("journal", default_enabled)
    out = dict(DEFAULT_JOURNAL_SETTINGS)
    out["enabled"] = default_enabled
    if isinstance(raw, bool):
        out["enabled"] = raw
    elif isinstance(raw, dict):
        out.update({k: v for k, v in raw.items() if k in out})
        out["enabled"] = bool(raw.get("enabled", True))
    return out


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

    Compaction appends in seq order, so a crashed/failed prior attempt left a
    PREFIX of this batch as the target's suffix — exact line membership in
    the tail is a safe dedupe key (encodings are deterministic). A torn final
    line in the target never matches (it isn't the full record), so the torn
    record is re-appended whole: duplicates-over-loss, and the isolated torn
    prefix stays countable as one corrupt line. Returns (kept, dropped)."""
    present = set(tail_lines(path))
    if not present:
        return batch, 0
    kept = [rec for rec in batch if rec[1].encode("utf-8") not in present]
    return kept, len(batch) - len(kept)


class _Stream:
    __slots__ = ("name", "kind", "path", "indent", "sink", "seq", "auto_compact",
                 "pending", "unc", "appended", "coalesced", "spilled",
                 "compactions", "compaction_failures", "dedup_needed",
                 "last_error", "key_json")

    def __init__(self, name: str, kind: str):
        self.name = name
        self.kind = kind  # "snapshot" | "append"
        self.path: Optional[Path] = None
        self.indent: Optional[int] = None
        self.sink: Optional[Callable] = None
        self.seq = 0
        self.auto_compact: Optional[int] = None
        # snapshot: Optional[(q, raw, meta)] — coalesced to the newest state.
        # append: list[(q, raw, meta)] in seq order.
        self.pending: Any = None if kind == "snapshot" else []
        self.unc: Any = None if kind == "snapshot" else []  # committed, not compacted
        self.appended = 0
        self.coalesced = 0
        self.spilled = 0
        self.compactions = 0
        self.compaction_failures = 0
        self.dedup_needed = False
        self.last_error: Optional[str] = None
        self.key_json = jsonl_dumps(name)

    def pending_count(self) -> int:
        if self.kind == "snapshot":
            return (1 if self.pending is not None else 0) + \
                   (1 if self.unc is not None else 0)
        return len(self.pending) + len(self.unc)


def _write_text_atomic(path: Path, text: str, durable: bool) -> None:
    """Tmp-then-rename write of pre-encoded JSON text — the snapshot
    compaction fast path (the state raw string IS the target file's bytes,
    re-encoding it would only burn the cycles the journal exists to save).
    Same fault sites and mkdir-on-demand discipline as write_json_atomic."""
    tmp = path.with_name(path.name + f".tmp{os.getpid()}")
    try:
        try:
            fh = tmp.open("w", encoding="utf-8")
        except FileNotFoundError:
            path.parent.mkdir(parents=True, exist_ok=True)
            fh = tmp.open("w", encoding="utf-8")
        with fh:
            write_with_faults("file.write", fh.write, text)
            if durable:
                fh.flush()
                maybe_fail("file.fsync")
                os.fsync(fh.fileno())
        maybe_fail("file.rename")
        os.replace(tmp, path)
    except BaseException:
        try:
            tmp.unlink()
        except OSError:
            pass
        raise


class Journal:
    """One append-only group-commit journal rooted at ``<workspace>/journal``.

    Thread-safe: writers share the buffer lock for O(1) enqueues; a single
    commit lock serializes segment writes/fsyncs/compactions, so concurrent
    durable writers batch behind whichever of them lands the lock first —
    classic group commit. Stage attribution (``enqueue`` / ``group_wait`` /
    ``commit`` / ``fsync`` / ``compact``) lands on the shared StageTimer with
    its quantiles."""

    def __init__(self, root: str | Path, settings: Optional[dict] = None,
                 clock: Callable[[], float] = time.time, wall: bool = True,
                 logger=None, timer: Optional[StageTimer] = None,
                 lifecycle: Optional[dict] = None,
                 lifecycle_timer: Optional[StageTimer] = None):
        s = dict(DEFAULT_JOURNAL_SETTINGS)
        s.update(settings or {})
        self.root = Path(root)
        self.settings = s
        self.clock = clock
        self.wall = wall
        self.logger = logger
        self.timer = timer or StageTimer()
        # Workspace lifecycle: resolved ``lifecycle_settings``
        # dict arms snapshot shipping (durable watermarks on a record
        # cadence) and segment tiering (rotated segments demoted to a
        # compressed cold/ tier instead of deleted). ``None`` — the
        # ``storage.lifecycle: false`` escape hatch and every direct
        # construction — keeps the plain journal's behavior: meta at
        # rotation/close only, rotated segments unlinked.
        self.lifecycle = (dict(lifecycle)
                          if lifecycle and lifecycle.get("enabled", True)
                          else None)
        self.lifecycle_timer = lifecycle_timer or StageTimer()
        self.fsync_mode = s.get("fsync", "group")
        self.window_s = float(s.get("windowMs", 20.0)) / 1000.0
        self.max_batch = int(s.get("maxBatchRecords", 128))
        self.max_pending = int(s.get("maxPendingRecords", 10_000))
        self.max_segment = int(s.get("maxSegmentBytes", 8 * 1024 * 1024))

        self._streams: dict[str, _Stream] = {}
        self._buffer_lock = threading.Lock()
        self._commit_lock = threading.RLock()
        self._pending_records = 0
        # Commit trigger: APPENDS since the last commit, not live pending
        # size — snapshot coalescing keeps pending at ~one record per
        # stream, and a trigger on pending alone would defer the write (and
        # the loss window) forever.
        self._appends_since_commit = 0
        self._timer_handle: Optional[threading.Timer] = None
        self._closed = False

        # counters (reads are torn-tolerant; all writes under a lock)
        self.commits = 0
        self.commit_failures = 0
        self.committed_records = 0
        self.fsyncs = 0
        self.fsync_failures = 0
        self.rotations = 0
        self.last_error: Optional[str] = None
        # Lifecycle counters (commit-lock side; stats() reads torn-tolerant)
        self._records_since_ship = 0
        self.ships = 0
        self.ship_failures = 0
        self.cold_demoted = 0
        self.cold_dropped = 0
        self.demote_failures = 0
        self._demote_backlog: list[Path] = []
        self._replay = {"segments": 0, "records": 0, "skipped": 0,
                        "corrupt_lines": 0, "torn_tails": 0, "read_errors": 0,
                        "deduped": 0, "cold_segments": 0}
        # recovered-but-unregistered records: stream → [(q, payload_obj, meta)]
        self._recovered: dict[str, list[tuple[int, Any, Optional[dict]]]] = {}
        self._marks: dict[str, int] = {}
        self._gen = 0
        self._fh = None
        self._wal_bytes = 0
        self._wal_tail_dirty = False
        self._meta_dirty = False
        # Lease fencing: None outside cluster mode — the check is
        # a single attribute read on the commit path, zero cost for every
        # single-process consumer. ``set_fence`` arms it.
        self.fence_path: Optional[Path] = None
        self.fence_epoch: Optional[int] = None
        self.fence_rejected = 0
        self._fenced = False
        self._open()
        _LIVE_JOURNALS.add(self)

    # ── open / recovery ──────────────────────────────────────────────

    def _seg_path(self, gen: int) -> Path:
        return self.root / f"wal.{gen:06d}.jsonl"

    def _cold_dir(self) -> Path:
        return self.root / str((self.lifecycle or {}).get("tierDir", "cold"))

    def _cold_path(self, gen: int) -> Path:
        # Bounded directory fanout: gen % tierFanout subdirectories, so no
        # single directory ever accumulates the whole tier's entries.
        fan = max(1, int((self.lifecycle or {}).get("tierFanout", 16)))
        return self._cold_dir() / f"{gen % fan:02x}" / f"wal.{gen:06d}.jsonl.gz"

    def cold_segments(self) -> list[tuple[int, Path]]:
        """(gen, path) for every cold-tier segment, oldest first."""
        out = []
        for seg in self._cold_dir().glob("*/wal.*.jsonl.gz"):
            try:
                out.append((int(seg.name.split(".")[1]), seg))
            except (ValueError, IndexError):
                continue
        out.sort()
        return out

    def _replay_record(self, w: Any) -> None:
        rep = self._replay
        if not isinstance(w, dict) or "s" not in w:
            rep["corrupt_lines"] += 1
            return
        name = str(w["s"])
        try:
            q = int(w.get("q") or 0)
        except (TypeError, ValueError):
            rep["corrupt_lines"] += 1
            return
        if q <= self._marks.get(name, 0):
            rep["skipped"] += 1
            return
        rep["records"] += 1
        self._recovered.setdefault(name, []).append(
            (q, w.get("p"), w.get("m")))

    def _rehydrate_cold(self, meta: dict, meta_present: bool) -> None:
        """Replay cold-tier segments that the on-disk meta cannot vouch for.

        A demoted segment is fully compacted by construction, and the
        rotation that demoted it wrote meta with the NEW generation — so
        whenever ``meta.gen`` exceeds a cold segment's generation, every
        record in it is at-or-below the persisted watermarks and the
        segment is skipped without even decompressing. Only a crash that
        lost the meta write (or the whole meta file) forces rehydration,
        which keeps the common-path recovery cost O(wal tail), never
        O(history) — the whole point of shipping."""
        import json as _json

        if self.lifecycle is None:
            return
        meta_gen = int(meta.get("gen", 0)) if meta_present else None
        rep = self._replay
        for gen, seg in self.cold_segments():
            if meta_gen is not None and gen < meta_gen:
                continue
            try:
                with gzip.open(seg, "rt", encoding="utf-8") as fh:
                    lines = fh.read().splitlines()
            except (OSError, EOFError) as exc:
                rep["read_errors"] += 1
                self.last_error = str(exc)
                continue
            rep["cold_segments"] += 1
            for line in lines:
                if not line.strip():
                    continue
                try:
                    self._replay_record(_json.loads(line))
                except (ValueError, TypeError):
                    rep["corrupt_lines"] += 1

    def _open(self) -> None:
        self.root.mkdir(parents=True, exist_ok=True)
        meta_present = (self.root / _META_NAME).exists()
        meta = read_json(self.root / _META_NAME, {}) or {}
        self._marks = {str(k): int(v)
                       for k, v in (meta.get("watermarks") or {}).items()}
        # Cold tier first: demoted segments carry strictly older gens than
        # any live wal segment, so their surviving records (stale-meta
        # crash recovery only) must enter the recovered lists first.
        self._rehydrate_cold(meta, meta_present)
        segs = sorted(self.root.glob("wal.*.jsonl"))
        rep = self._replay
        for i, seg in enumerate(segs):
            report = JsonlReadReport()
            for w in read_jsonl(seg, report=report):
                self._replay_record(w)
            rep["segments"] += 1
            rep["corrupt_lines"] += report.corrupt_lines
            if report.read_error is not None:
                rep["read_errors"] += 1
            if report.torn_tail is not None:
                # A writer died mid-append. Newline-isolate the tear so our
                # own appends can't merge into it ; the torn
                # record was never durable — it stays lost, but COUNTED.
                rep["torn_tails"] += 1
                if i == len(segs) - 1:
                    repair_torn_tail(seg)
        for recs in self._recovered.values():
            recs.sort(key=lambda r: r[0])
        if segs:
            try:
                self._gen = int(segs[-1].name.split(".")[1])
            except (IndexError, ValueError):
                self._gen = int(meta.get("gen", 0))
        else:
            self._gen = int(meta.get("gen", 0))
        path = self._seg_path(self._gen)
        self._fh = path.open("a", encoding="utf-8")
        try:
            self._wal_bytes = path.stat().st_size
        except OSError:
            self._wal_bytes = 0

    # ── lease fencing ──────────────────────────────────────

    def set_fence(self, path: str | Path, epoch: int) -> None:
        """Arm epoch fencing: this journal instance writes on behalf of
        lease ``epoch``; ``path`` is the workspace's fence file, rewritten
        (atomically, durably) by the cluster supervisor each time ownership
        moves. Every commit re-reads it BEFORE touching the wal, so a
        zombie owner — a worker the supervisor failed over away from but
        that is still running — has its batches dropped-and-counted at the
        journal boundary instead of interleaving writes with the new
        owner's. The check is commit-time, not append-time: appends only
        buffer, and the commit is the instant a record would otherwise
        become durable."""
        with self._commit_lock:
            self.fence_path = Path(path)
            self.fence_epoch = int(epoch)
            self._fenced = False

    def _fence_ok(self) -> bool:
        """Commit-lock held. True while this instance's epoch is current.
        A missing/unreadable fence file reads as "no newer owner": the
        supervisor writes the fence before the new owner opens the
        workspace, so absence means ownership never moved."""
        if self.fence_epoch is None:
            return True
        current = read_json(self.fence_path, None)
        if not isinstance(current, dict):
            return True
        try:
            return int(current.get("epoch", 0)) <= self.fence_epoch
        except (TypeError, ValueError):
            return True

    def fenced(self) -> bool:
        return self._fenced

    # ── stream registration ──────────────────────────────────────────

    def register_snapshot(self, name: str, path: str | Path,
                          indent: Optional[int] = None) -> _Stream:
        """Register a full-state stream compacting to ``path`` (atomic JSON,
        encoded with ``indent`` — ``None`` = the compact C-encoder bytes the
        legacy cortex persisters write). Completes any crash-interrupted
        compaction from recovered records before returning, so the caller's
        subsequent file load sees the journaled state.

        Registration holds the commit lock end to end and inserts into
        ``_streams`` under the buffer lock (commit-before-buffer, the
        package order): lazy registration happens on first save, which a
        debounce timer thread can drive while another owner's commit is
        draining ``_streams.values()`` — an unguarded dict insert there is
        a "dict changed size during iteration" crash in the group-commit
        path (found by graftlint GL-LOCK-GUARD)."""
        with self._commit_lock:
            st = self._streams.get(name)
            if st is None:
                st = _Stream(name, "snapshot")
                with self._buffer_lock:
                    self._streams[name] = st
            st.path = Path(path)
            st.indent = indent
            self._adopt_recovered(st)
            return st

    def register_append(self, name: str, sink: Callable,
                        auto_compact: Optional[int] = None) -> _Stream:
        """Register a record stream. ``sink(batch, dedup)`` appends
        ``[(seq, raw_line, meta), …]`` to the legacy representation and
        raises ``OSError`` on failure; with ``dedup=True`` a prior attempt
        may have partially landed and the sink must skip records already at
        the target's tail (``dedup_against_tail``). ``auto_compact`` (record
        count) lets the journal compact the stream inline once enough
        committed records accumulate; ``None`` leaves cadence entirely to
        the owner (the audit trail mirrors its legacy flush thresholds).
        Locking: same discipline as ``register_snapshot``."""
        with self._commit_lock:
            st = self._streams.get(name)
            if st is None:
                st = _Stream(name, "append")
                with self._buffer_lock:
                    self._streams[name] = st
            st.sink = sink
            st.auto_compact = auto_compact
            self._adopt_recovered(st)
            return st

    def _adopt_recovered(self, st: _Stream) -> None:
        recs = self._recovered.pop(st.name, None)
        mark = self._marks.get(st.name, 0)
        if recs:
            top = recs[-1][0]
            # Re-encode parsed payloads: jsonl_dumps(json.loads(x)) is
            # byte-identical for records this module encoded (compact
            # separators, insertion-ordered dicts, ensure_ascii=False).
            if st.kind == "snapshot":
                q, payload, meta = recs[-1]
                st.unc = (q, jsonl_dumps(payload), meta)
            else:
                st.unc = [(q, jsonl_dumps(p), m) for q, p, m in recs]
                st.dedup_needed = True  # the crash may have landed a prefix
            st.seq = max(st.seq, top)
            self._compact_streams([st])
        st.seq = max(st.seq, mark)

    # ── hot path ─────────────────────────────────────────────────────

    def append(self, name: str, obj: Any = None, *, raw: Optional[str] = None,
               meta: Optional[dict] = None) -> bool:
        """Enqueue one record. Returns True once the record is ACCEPTED —
        buffered (``fsync:"group"``/``"os"``: durability follows within the
        commit window) or durably committed (``fsync:"always"``). A failed
        inline commit still returns True: the record stays pending and
        retries on the next commit trigger (the failure is counted in
        ``commitFailures``). False only when the journal is closed and the
        record was NOT accepted — callers fall back to their legacy write;
        any other contract would make them double-write records the journal
        still holds."""
        if self._closed:
            return False  # callers fall back to their legacy write path
        if self._fenced:
            # Torn-tolerant scalar read; the authoritative check ran under
            # the commit lock. Raising (not returning False) keeps the
            # caller OFF its legacy write path — see FencedWriteError.
            raise FencedWriteError(
                f"journal fenced: lease epoch {self.fence_epoch} is stale")
        st = self._streams[name]
        pc = time.perf_counter
        t0 = pc()
        if raw is None:
            raw = jsonl_dumps(obj)
        with self._buffer_lock:
            st.seq += 1
            rec = (st.seq, raw, meta)
            if st.kind == "snapshot":
                if st.pending is not None:
                    st.coalesced += 1
                else:
                    self._pending_records += 1
                st.pending = rec
            else:
                st.pending.append(rec)
                self._pending_records += 1
                # Backstop bound (the owner's spill() is the policy lever):
                # drop oldest *pending* only — committed records belong to
                # the commit-lock side and are trimmed via spill().
                overflow = len(st.pending) - self.max_pending
                if overflow > 0:
                    del st.pending[:overflow]
                    self._pending_records -= overflow
                    st.spilled += overflow
            st.appended += 1
            self._appends_since_commit += 1
            n = self._appends_since_commit
            need_timer = (self.wall and self.window_s > 0
                          and self.fsync_mode != "always"
                          and n < self.max_batch
                          and self._timer_handle is None)
            if need_timer:
                t = threading.Timer(self.window_s, self._window_fire)
                t.daemon = True
                self._timer_handle = t
                t.start()
        self.timer.add("enqueue", (pc() - t0) * 1000.0)
        if self.fsync_mode == "always" or n >= self.max_batch:
            self.commit()  # failure retains pending + counts; record accepted
        return True

    def _window_fire(self) -> None:
        with self._buffer_lock:
            self._timer_handle = None
        try:
            self.commit()
        except Exception as exc:  # noqa: BLE001 — timer threads must not die loudly
            self.last_error = str(exc)

    # ── group commit ─────────────────────────────────────────────────

    def _drain_pending(self) -> list[tuple[_Stream, Any]]:
        drained: list[tuple[_Stream, Any]] = []
        with self._buffer_lock:
            if self._timer_handle is not None:
                self._timer_handle.cancel()
                self._timer_handle = None
            for st in self._streams.values():
                if st.kind == "snapshot":
                    if st.pending is not None:
                        drained.append((st, st.pending))
                        st.pending = None
                elif st.pending:
                    drained.append((st, st.pending))
                    st.pending = []
            self._pending_records = 0
            self._appends_since_commit = 0
        return drained

    def _restore_pending(self, drained: list[tuple[_Stream, Any]]) -> None:
        """A failed segment write must not lose the batch: put records back
        in front of anything enqueued meanwhile (newer snapshot states
        supersede the restored one — they coalesce, never regress)."""
        with self._buffer_lock:
            for st, recs in drained:
                if st.kind == "snapshot":
                    if st.pending is None:
                        st.pending = recs
                        self._pending_records += 1
                    else:
                        st.coalesced += 1  # newer state arrived mid-commit
                else:
                    st.pending[:0] = recs
                    self._pending_records += len(recs)

    def commit(self) -> bool:
        """Group commit: drain every stream's buffer, write the batch to the
        open segment in ONE ``write()``, fsync once per policy. Concurrent
        committers serialize on the commit lock — the wait is the classic
        group-commit ``group_wait``, and the winner's batch carries every
        record buffered while the previous fsync ran."""
        if self._closed:
            return False
        pc = time.perf_counter
        t0 = pc()
        acquired = self._commit_lock.acquire(blocking=False)
        if not acquired:
            self._commit_lock.acquire()
            self.timer.add("group_wait", (pc() - t0) * 1000.0)
        try:
            # Re-check under the lock: a timer-fired commit can pass the
            # entry check, then lose the commit lock to close(), which
            # closes _fh before we run — writing would raise ValueError
            # (not OSError) past the restore handler and drop the batch.
            # close() sets _closed before it takes the lock to close _fh,
            # so this check under the same lock is race-free; the pending
            # records stay buffered for callers' legacy fallbacks.
            if self._closed:
                return False
            if self.fence_epoch is not None and not self._fence_ok():
                # Ownership moved while records sat in the buffer: drop the
                # whole batch, counted, and latch — nothing stamped with
                # this instance's stale epoch may ever reach the wal or the
                # legacy files (the new owner already replayed/owns both).
                self._fenced = True
                drained = self._drain_pending()
                dropped = sum(1 if st.kind == "snapshot" else len(recs)
                              for st, recs in drained)
                self.fence_rejected += dropped
                self.last_error = (f"fenced: {dropped} stale-epoch record(s) "
                                   f"rejected at commit")
                if self.logger is not None:
                    self.logger.warn(
                        f"journal FENCED (epoch {self.fence_epoch} stale): "
                        f"{dropped} record(s) rejected, writes disabled")
                return False
            drained = self._drain_pending()
            if not drained:
                return True
            t1 = pc()
            lines = []
            nrec = 0
            # Callers reuse one meta dict per day (audit/events) — memoizing
            # its encoding by identity collapses ~batch-size tiny encodes to
            # one per distinct meta.
            meta_memo: dict[int, str] = {}
            for st, recs in drained:
                if st.kind == "snapshot":
                    recs = [recs]
                for q, raw, meta in recs:
                    nrec += 1
                    if meta is None:
                        lines.append(f'{{"s":{st.key_json},"q":{q},"p":{raw}}}\n')
                    else:
                        m = meta_memo.get(id(meta))
                        if m is None:
                            m = meta_memo[id(meta)] = jsonl_dumps(meta)
                        lines.append(f'{{"s":{st.key_json},"q":{q},'
                                     f'"m":{m},"p":{raw}}}\n')
            data = "".join(lines)
            try:
                if self._wal_tail_dirty:
                    if not repair_torn_tail(self._seg_path(self._gen)):
                        raise OSError("journal tail unrepaired; commit deferred")
                    self._wal_tail_dirty = False
                write_with_faults("journal.append", self._fh.write, data)
                self._fh.flush()
            except (OSError, ValueError) as exc:
                # ValueError = write on a closed handle (belt-and-braces:
                # the _closed re-check above makes it unreachable, but a
                # dropped-batch bug must not ride on that proof).
                self.commit_failures += 1
                self.last_error = str(exc)
                self._wal_tail_dirty = True  # a prefix may have landed
                self._restore_pending(drained)
                return False
            self.timer.add("commit", (pc() - t1) * 1000.0)
            if self.fsync_mode != "os":
                t2 = pc()
                try:
                    maybe_fail("journal.fsync")
                    os.fsync(self._fh.fileno())
                    self.fsyncs += 1
                except OSError as exc:
                    # Data reached the OS (write+flush succeeded); durability
                    # is degraded, not lost — count it, keep going.
                    self.fsync_failures += 1
                    self.last_error = str(exc)
                self.timer.add("fsync", (pc() - t2) * 1000.0)
            self._wal_bytes += len(data.encode("utf-8"))
            self.commits += 1
            self.committed_records += nrec
            self._records_since_ship += nrec
            auto = []
            for st, recs in drained:
                if st.kind == "snapshot":
                    st.unc = recs
                else:
                    st.unc.extend(recs)
                    if (st.auto_compact is not None
                            and len(st.unc) >= st.auto_compact):
                        auto.append(st)
            if auto:
                self._compact_streams(auto)
            if self._wal_bytes > self.max_segment:
                self.compact()  # full compaction enables rotation
            if (self.lifecycle is not None and not self._fenced
                    and self._records_since_ship
                    >= int(self.lifecycle.get("shipEveryRecords", 512))):
                self._ship_locked()
            return True
        finally:
            self._commit_lock.release()

    # ── compaction ───────────────────────────────────────────────────

    def compact(self, stream: Optional[str] = None) -> bool:
        """Commit pending records, then move committed records into the
        legacy files (the read path) and advance watermarks. With
        ``stream=None`` compacts everything and rotates the segment once it
        outgrows ``maxSegmentBytes`` — a fully-compacted journal's old
        segments carry no unreplayed state and are deleted."""
        ok = self.commit()
        with self._commit_lock:
            if stream is None:
                targets = list(self._streams.values())
            else:
                targets = [self._streams[stream]]
            ok = self._compact_streams(targets) and ok
            if stream is None and self._wal_bytes > self.max_segment:
                self._maybe_rotate()
        return ok

    def _compact_streams(self, targets: list[_Stream]) -> bool:
        ok = True
        pc = time.perf_counter
        with self._commit_lock:
            if self._fenced:
                # A fenced instance must not touch the legacy files either:
                # its committed-but-uncompacted records were already
                # replayed by the new owner at open, and compacting them
                # here would race the new owner's own compactions.
                return False
            for st in targets:
                if st.kind == "snapshot":
                    if st.unc is None:
                        continue
                    q, raw, _meta = st.unc
                    t0 = pc()
                    try:
                        if st.indent is None:
                            _write_text_atomic(st.path, raw,
                                               durable=self.fsync_mode != "os")
                        else:
                            import json as _json
                            write_json_atomic(st.path, _json.loads(raw),
                                              indent=st.indent,
                                              durable=self.fsync_mode != "os")
                        st.unc = None
                        st.compactions += 1
                        self._marks[st.name] = max(
                            self._marks.get(st.name, 0), q)
                        self._meta_dirty = True
                    except OSError as exc:
                        st.compaction_failures += 1
                        st.last_error = str(exc)
                        self.last_error = str(exc)
                        ok = False
                    self.timer.add("compact", (pc() - t0) * 1000.0)
                else:
                    if not st.unc:
                        continue
                    batch = st.unc
                    t0 = pc()
                    try:
                        st.sink(batch, st.dedup_needed)
                        st.unc = []
                        st.dedup_needed = False
                        st.compactions += 1
                        self._marks[st.name] = max(
                            self._marks.get(st.name, 0), batch[-1][0])
                        self._meta_dirty = True
                    except OSError as exc:
                        st.compaction_failures += 1
                        st.last_error = str(exc)
                        self.last_error = str(exc)
                        # The sink may have landed a prefix — the retry must
                        # dedupe against the target tail, not double-append.
                        st.dedup_needed = True
                        ok = False
                    self.timer.add("compact", (pc() - t0) * 1000.0)
        return ok

    def _write_meta(self, durable: bool = False) -> None:
        """Persist watermarks. Deliberately rare (rotation, close, snapshot
        ship) and un-fsynced by default: a stale meta file only means
        recovery re-replays records the last compactions already delivered —
        snapshot replay is idempotent and append replay tail-dedupes — so
        correctness never rides on this write, and paying an fsync per
        compaction for it measurably taxed the audit hot path (profiled: 2
        of the 3 fsyncs per flush were meta). A snapshot SHIP
        passes ``durable=True``: the fsync there is amortized over
        ``shipEveryRecords`` commits and is exactly what makes recovery
        start from the shipped watermark after kill -9."""
        try:
            write_json_atomic(self.root / _META_NAME,
                              {"version": 1, "gen": self._gen,
                               "watermarks": dict(self._marks)},
                              indent=None, durable=durable)
            self._meta_dirty = False
        except OSError as exc:
            # Stale watermarks only mean extra (deduped) replay next open.
            self.last_error = str(exc)

    # ── lifecycle: snapshot shipping + segment tiering ────

    def _ship_locked(self) -> bool:
        """Commit-lock held. One snapshot ship: compact every stream to its
        legacy file, retry any backlogged demotions, then persist the
        watermarks DURABLY. After this returns True, recovery replays only
        the wal records committed since — history before the ship is paid
        for exactly once, here, off the per-record hot path."""
        if self._fenced or self._closed:
            return False
        pc = time.perf_counter
        t0 = pc()
        try:
            maybe_fail("lifecycle.snapshot")
        except OSError as exc:
            self.ship_failures += 1
            self.last_error = str(exc)
            return False
        ok = self._compact_streams(list(self._streams.values()))
        self._retry_demotes()
        if ok:
            if self._wal_bytes > 0:
                # Rotate the shipped prefix out of the live wal: without
                # this, recovery still READS (and skips) every pre-ship
                # record — O(history) parse cost with an O(tail) replay.
                # Rotation demotes the old segment cold and writes the
                # durable meta with the new gen, so the cold copy is
                # provably skippable at the next open.
                self._maybe_rotate()
            if self._meta_dirty:
                self._write_meta(durable=True)
            ok = not self._meta_dirty
        if ok:
            self.ships += 1
            self._records_since_ship = 0
        else:
            self.ship_failures += 1
        self.lifecycle_timer.add("snapshot", (pc() - t0) * 1000.0)
        return ok

    def ship_snapshot(self) -> bool:
        """Commit + ship now (the hibernate path and tests call this; the
        steady-state cadence is ``shipEveryRecords`` inside commit). On a
        legacy journal (no lifecycle) this degrades to a plain compaction —
        the escape hatch must not grow a durable-meta side channel."""
        ok = self.commit()
        if self.lifecycle is None:
            return self.compact() and ok
        with self._commit_lock:
            return self._ship_locked() and ok

    def _demote_segment(self, seg: Path) -> bool:
        """Commit-lock held. Compress one fully-compacted rotated segment
        into the cold tier and drop the plain copy. A failure (fault site
        ``lifecycle.demote``, disk trouble) leaves the plain segment in
        place on the retry backlog — cold demotion is a space optimization
        and must never be able to lose the only copy of a segment."""
        pc = time.perf_counter
        t0 = pc()
        try:
            gen = int(seg.name.split(".")[1])
        except (ValueError, IndexError):
            return False
        dst = self._cold_path(gen)
        tmp = dst.with_name(dst.name + f".tmp{os.getpid()}")
        try:
            maybe_fail("lifecycle.demote")
            dst.parent.mkdir(parents=True, exist_ok=True)
            data = seg.read_bytes()
            t_comp = pc()
            with gzip.open(tmp, "wb", compresslevel=6) as fh:
                fh.write(data)
            self.lifecycle_timer.add("compress", (pc() - t_comp) * 1000.0)
            os.replace(tmp, dst)
            seg.unlink()
        except OSError as exc:
            try:
                tmp.unlink()
            except OSError:
                pass
            self.demote_failures += 1
            self.last_error = str(exc)
            if seg not in self._demote_backlog:
                self._demote_backlog.append(seg)
            self.lifecycle_timer.add("demote", (pc() - t0) * 1000.0)
            return False
        if seg in self._demote_backlog:
            self._demote_backlog.remove(seg)
        self.cold_demoted += 1
        self.lifecycle_timer.add("demote", (pc() - t0) * 1000.0)
        return True

    def _retry_demotes(self) -> None:
        """Commit-lock held. Re-attempt backlogged demotions (each retry is
        its own ``lifecycle.demote`` fault-site step)."""
        for seg in list(self._demote_backlog):
            if not seg.exists():
                self._demote_backlog.remove(seg)
                continue
            self._demote_segment(seg)

    def _cap_cold_tier(self) -> None:
        """Commit-lock held. Enforce ``maxColdSegments``: the oldest cold
        segments beyond the cap are unlinked — dropped AND counted, the
        bounded-disk contract."""
        cap = max(0, int(self.lifecycle.get("maxColdSegments", 64)))
        cold = self.cold_segments()
        for _gen, seg in cold[:max(0, len(cold) - cap)]:
            try:
                seg.unlink()
                self.cold_dropped += 1
            except OSError as exc:
                self.last_error = str(exc)

    def _maybe_rotate(self) -> None:
        """Start a fresh segment once everything is compacted; the old
        segments hold only records at-or-below the watermarks."""
        with self._buffer_lock:
            clean = self._pending_records == 0
        if not clean:
            return
        for st in self._streams.values():
            if (st.unc if st.kind == "append" else
                    ([st.unc] if st.unc is not None else [])):
                return
        if self._recovered:
            return  # unregistered streams still live in the old segments
        old_gen = self._gen
        try:
            self._fh.close()
            self._gen += 1
            self._fh = self._seg_path(self._gen).open("a", encoding="utf-8")
        except OSError as exc:
            self.last_error = str(exc)
            self._fh = self._seg_path(old_gen).open("a", encoding="utf-8")
            self._gen = old_gen
            return
        self._wal_bytes = 0
        self.rotations += 1
        self._meta_dirty = True
        # Meta BEFORE demotion: once meta carries the new gen, every cold
        # segment (gen < meta.gen) is provably covered by the persisted
        # watermarks and recovery skips it without decompressing.
        self._write_meta(durable=self.lifecycle is not None)
        for seg in sorted(self.root.glob("wal.*.jsonl")):
            try:
                if int(seg.name.split(".")[1]) >= self._gen:
                    continue
            except (ValueError, IndexError):
                continue
            if self.lifecycle is not None:
                # Tiering: demote instead of delete — compressed
                # history with bounded fanout; failures go to the backlog.
                self._demote_segment(seg)
            else:
                try:
                    seg.unlink()
                except OSError:
                    continue
        if self.lifecycle is not None:
            self._cap_cold_tier()

    # ── owner-driven accounting ──────────────────────────────────────

    def pending_count(self, name: str) -> int:
        st = self._streams.get(name)
        if st is None:
            return len(self._recovered.get(name, []))
        with self._buffer_lock:
            return st.pending_count()

    def pending_payloads(self, name: str) -> list[Any]:
        """Parsed payloads of every not-yet-compacted record of an append
        stream, oldest first (seq recovery: a consumer must not re-issue
        sequence numbers still queued in the wal)."""
        import json as _json
        st = self._streams.get(name)
        if st is None:
            return [p for _q, p, _m in self._recovered.get(name, [])]
        with self._buffer_lock:
            raws = [raw for _q, raw, _m in st.unc] + \
                   [raw for _q, raw, _m in st.pending]
        out = []
        for raw in raws:
            try:
                out.append(_json.loads(raw))
            except (ValueError, TypeError):
                continue
        return out

    def _spill_locked(self, st: _Stream, overflow: int) -> int:
        """Drop the OLDEST records (buffer-lock held). Spilled committed
        records advance the watermark so replay can't resurrect them —
        dropped AND counted, never silently reborn."""
        dropped = 0
        while dropped < overflow and st.unc:
            q, _raw, _m = st.unc.pop(0)
            self._marks[st.name] = max(self._marks.get(st.name, 0), q)
            self._meta_dirty = True
            dropped += 1
        while dropped < overflow and st.pending:
            st.pending.pop(0)
            self._pending_records -= 1
            dropped += 1
        st.spilled += dropped
        return dropped

    def spill(self, name: str, keep: int) -> int:
        """Trim an append stream to ``keep`` records, oldest-first (the
        audit trail's bounded-buffer fallback rides this). Returns the
        number dropped-and-counted."""
        st = self._streams[name]
        # Commit-lock first (same order as commit→_drain_pending): _spill
        # drops committed ``unc`` records that compaction also touches.
        with self._commit_lock, self._buffer_lock:
            overflow = st.pending_count() - keep
            if overflow <= 0:
                return 0
            return self._spill_locked(st, overflow)

    def stream_error(self, name: str) -> Optional[str]:
        st = self._streams.get(name)
        return st.last_error if st is not None else None

    # ── lifecycle / stats ────────────────────────────────────────────

    def flush(self) -> bool:
        return self.compact()

    def close(self) -> None:
        if self._closed:
            return
        try:
            # A deleted workspace (TemporaryDirectory cleanup beat us to it)
            # must not be resurrected by a final compaction/meta write —
            # there is nothing left worth persisting into.
            if self.root.exists() and not self._fenced:
                # A fenced instance skips the farewell compaction AND the
                # meta write: the new owner holds both files now. The
                # fence may also be DISCOVERED by this very compaction's
                # commit — hence the re-check before touching meta.
                self.compact()
                with self._commit_lock:
                    if self._meta_dirty and not self._fenced:
                        # Lifecycle journals close DURABLY: a hibernated
                        # workspace's wake must start from this watermark
                        # even across a kill -9 (wake IS recovery).
                        self._write_meta(durable=self.lifecycle is not None)
        finally:
            self._closed = True
            with self._buffer_lock:
                if self._timer_handle is not None:
                    self._timer_handle.cancel()
                    self._timer_handle = None
            # Under the commit lock: a window-fire commit still in flight on
            # the timer thread must finish its write before the handle dies
            # beneath it (graftlint GL-LOCK-GUARD on _fh).
            with self._commit_lock:
                try:
                    self._fh.close()
                except OSError:
                    pass
            _LIVE_JOURNALS.discard(self)
            _registry_discard(self)

    def drop_pending(self) -> int:
        """Discard every buffered (uncommitted) record WITHOUT committing —
        the cluster takeover barrier. A partition-style failover
        leaves the old owner's un-acked effects in this buffer; the
        supervisor redelivers those ops to the new owner, so committing
        them at takeover would double-apply. Committed records are not
        touched (compact them after). Returns the number discarded."""
        with self._commit_lock:
            drained = self._drain_pending()
            return sum(1 if st.kind == "snapshot" else len(recs)
                       for st, recs in drained)

    def abandon(self) -> None:
        """Simulate process death (cluster failover tests): drop
        every buffered record, release the wal fd, write NOTHING — no final
        commit, no compaction, no meta. What the next opener recovers is
        exactly what a kill -9 would have left: the committed wal prefix.
        The registry treats an abandoned journal as closed, so the next
        ``get_journal`` on the workspace opens a fresh instance and replays."""
        if self._closed:
            return
        self._closed = True
        with self._buffer_lock:
            if self._timer_handle is not None:
                self._timer_handle.cancel()
                self._timer_handle = None
        with self._commit_lock:
            try:
                self._fh.close()
            except OSError:
                pass
        _LIVE_JOURNALS.discard(self)
        _registry_discard(self)

    def stats(self) -> dict:
        with self._buffer_lock:
            pending = self._pending_records
            streams = {}
            unc_total = 0
            for st in self._streams.values():
                unc = (len(st.unc) if st.kind == "append"
                       else (1 if st.unc is not None else 0))
                unc_total += unc
                streams[st.name] = {
                    "kind": st.kind, "seq": st.seq,
                    "pending": st.pending_count(),
                    "uncompacted": unc,
                    "appended": st.appended, "coalesced": st.coalesced,
                    "spilled": st.spilled, "compactions": st.compactions,
                    "compactionFailures": st.compaction_failures,
                    "watermark": self._marks.get(st.name, 0),
                    "lastError": st.last_error,
                }
        commits = self.commits
        return {
            "enabled": True,
            "fsync": self.fsync_mode,
            "pendingRecords": pending,
            "uncompactedRecords": unc_total,
            "commits": commits,
            "commitFailures": self.commit_failures,
            "committedRecords": self.committed_records,
            "avgGroupSize": round(self.committed_records / commits, 2) if commits else 0.0,
            "fsyncs": self.fsyncs,
            "fsyncFailures": self.fsync_failures,
            "spilled": sum(s["spilled"] for s in streams.values()),
            "compactions": sum(s["compactions"] for s in streams.values()),
            "compactionFailures": sum(s["compactionFailures"]
                                      for s in streams.values()),
            "rotations": self.rotations,
            "fenced": self._fenced,
            "fenceEpoch": self.fence_epoch,
            "fencedRecords": self.fence_rejected,
            "walBytes": self._wal_bytes,
            "segment": self._gen,
            "lastError": self.last_error,
            "replay": dict(self._replay),
            "streams": streams,
            "lifecycle": self._lifecycle_stats(),
        }

    def _lifecycle_stats(self) -> Optional[dict]:
        """Shipping/tiering counters (None on a legacy journal). Runs
        outside the locks — every read here is a torn-tolerant scalar or a
        directory listing, and stats() must not convoy the commit path."""
        if self.lifecycle is None:
            return None
        cold = self.cold_segments()
        cold_bytes = 0
        for _gen, seg in cold:
            try:
                cold_bytes += seg.stat().st_size
            except OSError:
                continue
        return {
            "ships": self.ships,
            "shipFailures": self.ship_failures,
            "recordsSinceShip": self._records_since_ship,
            "shipEveryRecords": int(self.lifecycle.get("shipEveryRecords",
                                                       512)),
            "coldSegments": len(cold),
            "coldBytes": cold_bytes,
            "coldDemoted": self.cold_demoted,
            "coldDropped": self.cold_dropped,
            "demoteBacklog": len(self._demote_backlog),
            "demoteFailures": self.demote_failures,
        }


# ── registry: one shared journal per workspace ──────────────────────

_REGISTRY: dict[str, Journal] = {}
_REGISTRY_LOCK = threading.Lock()
_LIVE_JOURNALS: "weakref.WeakSet[Journal]" = weakref.WeakSet()


def _registry_discard(j: Journal) -> None:
    """Drop a closed/abandoned journal from the registry so it can be
    garbage-collected. Hibernation closes one journal per
    evicted workspace — at 10⁵ cold workspaces, pinning every closed
    instance (streams, timers, settings) in this dict is the exact
    unbounded-RSS shape the lifecycle work removes. ``get_journal``
    already treats closed entries as absent, so this changes reachability
    only, never lookup semantics."""
    with _REGISTRY_LOCK:
        for key in [k for k, v in _REGISTRY.items() if v is j]:
            del _REGISTRY[key]


def get_journal(workspace: str | Path, settings: Optional[dict] = None,
                clock: Callable[[], float] = time.time, wall: bool = True,
                logger=None, lifecycle: Optional[dict] = None,
                lifecycle_timer: Optional[StageTimer] = None
                ) -> Optional[Journal]:
    """The shared per-workspace journal: cortex, knowledge, governance, and
    the event store all group-commit through ONE segment writer (that is the
    whole point — one fsync covers everyone's records). First creator's
    clock/wall/settings win; returns None when the journal directory cannot
    be opened (read-only workspace — consumers fall back to their legacy
    paths, exactly like ``ensure_reboot_dir``)."""
    s = dict(DEFAULT_JOURNAL_SETTINGS)
    s.update(settings or {})
    root = Path(workspace) / str(s.get("dir", "journal"))
    try:
        key = str(root.resolve())
    except OSError:
        key = str(root)
    with _REGISTRY_LOCK:
        j = _REGISTRY.get(key)
        if j is not None and not j._closed:
            # Wall timers are an UPGRADE, never a downgrade: whichever
            # plugin runs with real timers enables the bounded commit
            # window for every co-owner (governance always asks wall=False
            # so its chaos runs stay deterministic when it is alone —
            # production gateways load cortex/events with wall=True and the
            # shared instance gets the 20 ms window either way).
            if wall and not j.wall:
                j.wall = True
            return j
        try:
            j = Journal(root, s, clock=clock, wall=wall, logger=logger,
                        lifecycle=lifecycle, lifecycle_timer=lifecycle_timer)
        except OSError as exc:
            if logger is not None:
                logger.warn(f"journal unavailable at {root}: {exc}")
            return None
        _REGISTRY[key] = j
        return j


def peek_journal(workspace: str | Path,
                 dirname: str = "journal") -> Optional[Journal]:
    """The workspace's already-open journal, or None — never creates one.
    File-mediated readers (cortex agent tools, boot context, narrative) call
    this as a read barrier: compacting before the read makes the legacy JSON
    files current without the reader ever parsing wal records."""
    root = Path(workspace) / dirname
    try:
        key = str(root.resolve())
    except OSError:
        key = str(root)
    with _REGISTRY_LOCK:
        j = _REGISTRY.get(key)
        return j if j is not None and not j._closed else None


def reset_journals() -> None:
    """Close every registered journal (tests). Snapshot-then-close: each
    close now discards itself from the registry (under the registry lock),
    so closing while holding it would deadlock."""
    with _REGISTRY_LOCK:
        journals = list(_REGISTRY.values())
        _REGISTRY.clear()
    for j in journals:
        try:
            j.close()
        except Exception:  # noqa: BLE001
            pass


@atexit.register
def _close_live_journals() -> None:  # pragma: no cover — exit path
    for j in list(_LIVE_JOURNALS):
        try:
            j.close()
        except Exception:  # noqa: BLE001 — interpreter is going down
            pass
