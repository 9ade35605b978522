"""Atomic JSON persistence.

A copy of ``read_json``, ``write_json_atomic``, the JSONL helpers
(``append_jsonl``, ``read_jsonl`` with its ``JsonlReadReport``,
``repair_torn_tail``), ``Debouncer``, ``AtomicStorage`` and
``daily_jsonl_name`` from
``vainplex_openclaw_tpu/storage/atomic.py``, kept here so the port imports
nothing of the JAX package. Files are written byte for byte as the JAX
package writes them, so a file written by one package is read by the
other. The fault sites are the JAX writer's, at the same places
(``resilience/faults.py``): ``file.write`` (torn-capable), ``file.fsync``
under ``durable`` and ``file.rename``; a failed write removes its
temporary file. ``append_jsonl`` writes through ``file.append``
(torn-capable).
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time
import weakref
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Iterator, Optional

from ..resilience.faults import maybe_fail, write_with_faults

# the tmp-name collision guard reads the pid per write; cache it once and
# refresh it in a forked child
_PID = os.getpid()


def _refresh_pid() -> None:  # pragma: no cover — exercised via fork only
    global _PID
    _PID = os.getpid()


if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=_refresh_pid)

# The compact form encodes with the fast C encoder and falls back to the
# ``default=str`` one only for a value JSON cannot hold.
_FAST_ENCODE = json.JSONEncoder(ensure_ascii=False,
                                separators=(",", ":")).encode
_SAFE_ENCODE = json.JSONEncoder(ensure_ascii=False, separators=(",", ":"),
                                default=str).encode


def jsonl_dumps(rec: Any) -> str:
    try:
        return _FAST_ENCODE(rec)
    except (TypeError, ValueError):
        return _SAFE_ENCODE(rec)


def write_json_atomic(path: str | Path, obj: Any, indent: Optional[int] = 2,
                      durable: bool = False) -> None:
    """Write ``obj`` to a temporary file beside ``path`` and rename it over
    ``path``. ``indent=None`` writes compact JSON. ``durable=True`` fsyncs
    the temporary file before the rename and, where it can, the directory
    after it, so a machine crash cannot leave a rename that points at data
    never flushed."""
    path = Path(path)
    tmp = path.with_name(path.name + f".tmp{_PID}")
    if indent is None:
        data = jsonl_dumps(obj)
    else:
        data = json.dumps(obj, indent=indent, ensure_ascii=False, default=str)
    try:
        try:
            fh = tmp.open("w", encoding="utf-8")
        except FileNotFoundError:
            path.parent.mkdir(parents=True, exist_ok=True)
            fh = tmp.open("w", encoding="utf-8")
        with fh:
            write_with_faults("file.write", fh.write, data)
            if durable:
                fh.flush()
                maybe_fail("file.fsync")
                os.fsync(fh.fileno())
        maybe_fail("file.rename")
        os.replace(tmp, path)
    except BaseException:
        # a failed write leaves no tmp file beside the live one
        try:
            tmp.unlink()
        except OSError:
            pass
        raise
    if durable:
        try:  # the directory's fsync makes the rename itself durable
            dfd = os.open(path.parent, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:  # not supported everywhere; the file's fsync stands
            pass


def read_json(path: str | Path, default: Any = None) -> Any:
    """The JSON in ``path``, or ``default`` when it is missing or not
    JSON."""
    path = Path(path)
    try:
        return json.loads(path.read_text(encoding="utf-8"))
    except (OSError, json.JSONDecodeError):
        return default


def append_jsonl(path: str | Path, records: list[Any]) -> None:
    """Append one compact JSON line per record, in one ``write()``."""
    path = Path(path)
    payload = "".join(jsonl_dumps(rec) + "\n" for rec in records)
    try:
        fh = path.open("a", encoding="utf-8")
    except FileNotFoundError:
        path.parent.mkdir(parents=True, exist_ok=True)
        fh = path.open("a", encoding="utf-8")
    with fh:
        write_with_faults("file.append", fh.write, payload)


@dataclass
class JsonlReadReport:
    """Filled by ``read_jsonl`` when passed: what the reader skipped.
    ``torn_tail`` is the unparseable final line *without* a trailing newline
    (a writer died mid-append); corrupt lines are complete lines that fail
    to parse; ``read_error`` records a file that could not be opened at all,
    so an unreadable log is never taken for an empty one."""

    records: int = 0
    corrupt_lines: int = 0
    torn_tail: Optional[str] = None
    read_error: Optional[str] = None


def read_jsonl(path: str | Path,
               report: Optional[JsonlReadReport] = None) -> Iterator[Any]:
    """Yield parseable records. A torn final line (no trailing newline, not
    valid JSON) is reported through ``report``, not taken for mid-file
    corruption; a *parseable* unterminated tail is a complete record that
    lost its newline, and is yielded.

    A missing file reads as empty. Any other open failure is recorded on
    ``report`` and swallowed, or re-raised when no report was passed."""
    path = Path(path)
    try:
        fh = path.open("rb")
    except FileNotFoundError:
        return
    except OSError as exc:
        if report is None:
            raise
        report.read_error = str(exc)
        return
    # streamed: only the FINAL line can lack its newline, so the tail case
    # is told per line without buffering the file
    with fh:
        for raw in fh:
            if not raw.strip():
                continue
            terminated = raw.endswith(b"\n")
            try:
                rec = json.loads(raw)
            except (json.JSONDecodeError, UnicodeDecodeError):
                if report is None:
                    continue
                if terminated:
                    report.corrupt_lines += 1
                else:
                    report.torn_tail = raw.decode("utf-8", errors="replace")
                continue
            if report is not None:
                report.records += 1
            yield rec


def repair_torn_tail(path: str | Path) -> bool:
    """Newline-terminate a torn final line, so the next append cannot join
    a good record onto the partial one. The isolated prefix then reads as
    ONE corrupt line. Every writer here emits a line (or batch) in one
    ``write()``, so a partial final line is always a tear, never a live
    writer that will finish it.

    Returns True when appending is safe (repaired, already terminated, or
    no file); False when the tail could not be inspected."""
    try:
        with Path(path).open("rb+") as fh:
            fh.seek(0, 2)
            if fh.tell() > 0:
                fh.seek(-1, 2)
                if fh.read(1) != b"\n":
                    fh.write(b"\n")
    except FileNotFoundError:
        return True  # nothing to repair
    except OSError:
        return False
    return True


# Debouncers with pending work at interpreter exit used to lose it: the
# daemon timer thread dies with the process. One atexit hook flushes every
# live debouncer (weakly referenced — registration must not keep dead
# stores alive); flush failures are swallowed, exit paths can't raise.
_LIVE_DEBOUNCERS: "weakref.WeakSet[Debouncer]" = weakref.WeakSet()


@atexit.register
def _flush_live_debouncers() -> None:  # pragma: no cover — exercised manually
    for deb in list(_LIVE_DEBOUNCERS):
        try:
            deb.flush()
        except Exception:  # noqa: BLE001 — interpreter is going down
            pass


class Debouncer:
    """Trailing-edge debounce with an explicit ``flush`` for shutdown paths.

    ``wall=False`` (tests) never starts a timer thread; callers drive it via
    ``flush()``. With ``wall=True`` a daemon timer fires after ``delay_s``.
    ``stop()`` cancels the timer and flushes pending work; pending work also
    flushes at interpreter exit (a 15 s save debounce must not turn a clean
    shutdown into silent data loss).
    """

    def __init__(self, fn: Callable[[], None], delay_s: float, wall: bool = True):
        self._fn = fn
        self._delay = delay_s
        self._wall = wall
        self._timer: Optional[threading.Timer] = None
        self._pending = False
        self._lock = threading.Lock()
        _LIVE_DEBOUNCERS.add(self)

    def trigger(self) -> None:
        with self._lock:
            self._pending = True
            if not self._wall:
                return
            if self._timer is not None:
                self._timer.cancel()
            self._timer = threading.Timer(self._delay, self.flush)
            self._timer.daemon = True
            self._timer.start()

    def flush(self) -> None:
        with self._lock:
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None
            if not self._pending:
                return
            self._pending = False
        self._fn()

    def stop(self) -> None:
        """Shutdown: cancel any armed timer and flush pending work."""
        self.flush()
        _LIVE_DEBOUNCERS.discard(self)

    @property
    def pending(self) -> bool:
        return self._pending


class AtomicStorage:
    """Directory-rooted JSON store with per-key debounced persistence.

    With a ``journal`` every save becomes a group-committed wal
    append instead of an atomic rename; ``flush_all``/``stop`` compact the
    journaled state back to the JSON files, and ``load`` registers the
    stream first so a crash-interrupted compaction completes before the
    read. ``journal=None`` is the legacy path, byte-for-byte."""

    def __init__(self, root: str | Path, wall: bool = True, journal=None,
                 stream_prefix: Optional[str] = None):
        self.root = Path(root)
        self._wall = wall
        self._debouncers: dict[str, Debouncer] = {}
        self._journal = journal
        self._stream_prefix = stream_prefix or f"store:{self.root.name}"
        self._streams: dict[str, str] = {}

    def path(self, name: str) -> Path:
        return self.root / name

    def _stream(self, name: str) -> str:
        stream = self._streams.get(name)
        if stream is None:
            stream = self._streams[name] = f"{self._stream_prefix}:{name}"
            # indent=2: compaction must reproduce the exact bytes the legacy
            # pretty-printed save wrote (the equivalence suites diff files).
            self._journal.register_snapshot(stream, self.path(name), indent=2)
        return stream

    def save(self, name: str, obj: Any) -> None:
        if self._journal is not None:
            if self._journal.append(self._stream(name), obj):
                return
        write_json_atomic(self.path(name), obj)

    def load(self, name: str, default: Any = None) -> Any:
        if self._journal is not None:
            self._stream(name)  # registration completes pending compaction
        return read_json(self.path(name), default)

    def save_debounced(self, name: str, supplier: Callable[[], Any], delay_s: float = 15.0) -> None:
        deb = self._debouncers.get(name)
        if deb is None:
            deb = Debouncer(lambda: self.save(name, supplier()), delay_s, wall=self._wall)
            self._debouncers[name] = deb
        deb.trigger()

    def flush_all(self) -> None:
        for deb in self._debouncers.values():
            deb.flush()
        if self._journal is not None:
            for stream in self._streams.values():
                self._journal.compact(stream)

    def stop(self) -> None:
        for deb in self._debouncers.values():
            deb.stop()
        if self._journal is not None:
            for stream in self._streams.values():
                self._journal.compact(stream)


def daily_jsonl_name(ts: Optional[float] = None) -> str:
    """``YYYY-MM-DD.jsonl`` file name for daily logs (UTC)."""
    t = time.gmtime(ts if ts is not None else time.time())
    return f"{t.tm_year:04d}-{t.tm_mon:02d}-{t.tm_mday:02d}.jsonl"
