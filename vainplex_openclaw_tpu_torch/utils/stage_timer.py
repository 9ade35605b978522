"""Lightweight wall-clock stage breakdown for multi-stage pipelines.

A copy of ``vainplex_openclaw_tpu/utils/stage_timer.py`` (stdlib only), kept
here so the port imports nothing of the JAX package. Name stages, wrap them
in ``stage()``, read the breakdown as a dict. Overhead is two
``perf_counter`` calls per stage — nothing here may tax the path it is
measuring.

Latency *distributions* ride the same budget: every ``add()``
also increments one bucket of a log2 histogram (a ``math.frexp`` call plus
a list increment — no allocation, no sort, no reservoir), so status
surfaces and the SLO harness can read p50/p95/p99 per stage instead of
only means. ``snapshot()`` returns everything — accumulated ms, counts,
quantiles — under ONE lock round-trip, replacing the torn
``stages_ms()``-then-``counts()`` read pattern on status paths.

**Spans and the process span log.** ``StageTimer.stage()`` returns a
:class:`Span`: one interval of work on a thread, which adds its
milliseconds to the timer's stage when it ends. :func:`span` makes one
without a stage. Tracing is on exactly while a torch profiler records
(``torch.profiler.profile``, read through the profiler's own Python-level
flag); there is no switch of its own. While it is on, every span also

- lands in :data:`SPANS`, a bounded in-memory log (the newest
  ``SPAN_LOG_CAPACITY`` records): name, start and end on
  ``time.perf_counter``, thread, id (request, batch or call), parent id,
  rows, and the thread's CPU seconds inside the span
  (``time.thread_time``), so wall − CPU is the time it did not run
  (waiting on a lock, the card or the interpreter lock);
- is entered as a profiler range named ``openclaw.<name>`` on its
  thread (torch's ``_RecordFunctionFast``; see ``_profiler_range``).

So an operator who runs the served path under ``torch.profiler`` gets
the program's spans (``openclaw.wait``, ``openclaw.batch``,
``openclaw.tokenize``, ``openclaw.launch``, ``openclaw.sync``,
``openclaw.keep_logits``, …) as ranges on the profiler's own timeline,
on the thread that ran them and above the kernels they launched, in
``prof.events()`` and in ``export_chrome_trace``; and
``SPANS.between(t0, t1)`` gives the records of any stretch of that run,
with the request ids the traces cannot carry. A request's intervals
(its ``queue`` and ``wake``, the seam's ``extract``), which no thread
runs from start to end, land in the log alone (``SpanLog.add``). With no
profiler a stage costs a ``StageTimer.add`` and two clock reads, as it
always has, and a span without a stage one read of the flag.
"""

from __future__ import annotations

import collections
import itertools
import math
import sys
import threading
import time
from typing import Callable, Iterable, NamedTuple, Optional

# Log2 histogram geometry. Bucket ``i`` covers [2^(e-1), 2^e) milliseconds
# with e = i + _HIST_MIN_EXP; bucket 0 additionally absorbs everything
# below ~0.5 µs (including 0 and negative clock skew), the top bucket
# everything above ~2^20 ms (~17.5 min). 33 ints per stage, fixed.
_HIST_MIN_EXP = -11
_HIST_MAX_EXP = 21
HIST_BUCKETS = _HIST_MAX_EXP - _HIST_MIN_EXP + 1
_HIST_TOP = HIST_BUCKETS - 1
_frexp = math.frexp  # bound once: the lookup is visible on the hot path


def _bucket_of(ms: float) -> int:
    """O(1) bucket index for a duration in ms (frexp, no log call)."""
    if ms <= 0.0:
        return 0
    e = _frexp(ms)[1]  # ms ∈ [2^(e-1), 2^e)
    if e <= _HIST_MIN_EXP:
        return 0
    if e > _HIST_MAX_EXP:
        return _HIST_TOP
    return e - _HIST_MIN_EXP


def _bucket_bounds(idx: int) -> tuple[float, float]:
    """[lo, hi) in ms covered by bucket ``idx`` (bucket 0 starts at 0)."""
    e = idx + _HIST_MIN_EXP
    lo = 0.0 if idx == 0 else 2.0 ** (e - 1)
    return lo, 2.0 ** e


def quantile_label(q: float) -> str:
    """0.5 → 'p50', 0.99 → 'p99', 0.999 → 'p99.9'."""
    pct = q * 100.0
    return f"p{pct:g}"


def estimate_quantiles(hist: list, qs: Iterable[float],
                       precision: int = 4) -> dict:
    """Bounded-error quantile estimates from one log2 histogram.

    For each q the estimate lands in the bucket holding the rank-
    ``floor(q*(n-1))`` sample (numpy's ``percentile(..., method='lower')``
    rank rule) and interpolates linearly inside it, so for samples inside
    the histogram range (~0.5 µs … ~2^21 ms ≈ 35 min) the estimate is
    always within one bucket of the true sample quantile: at most a
    factor of 2 off, in practice far closer (pinned by the property
    suite in tests against ``numpy.percentile``). Samples OUTSIDE the
    range clamp into the edge buckets, so a quantile landing there is
    reported as the edge bucket's value — a >35-minute hang reads as
    "≥ the top bucket", not its true magnitude.
    """
    n = sum(hist)
    out: dict[str, float] = {}
    if n == 0:
        return {quantile_label(q): 0.0 for q in qs}
    for q in qs:
        rank = int(q * (n - 1))  # 0-based index of the target order stat
        cum = 0
        idx = HIST_BUCKETS - 1
        for i, c in enumerate(hist):
            if cum + c > rank:
                idx = i
                break
            cum += c
        lo, hi = _bucket_bounds(idx)
        inside = hist[idx] or 1
        frac = (rank - cum + 0.5) / inside
        out[quantile_label(q)] = round(lo + frac * (hi - lo), precision)
    return out


DEFAULT_QUANTILES = (0.5, 0.95, 0.99)


class StageTimer:
    """Accumulates per-stage wall-clock milliseconds in stage-entry order.

    Re-entering a stage name accumulates (a stage split across code paths
    still reads as one line in the breakdown). ``clock`` is injectable for
    tests; it must be a monotonic seconds counter. Accumulation is guarded
    by a lock: the knowledge plugin shares one timer between the serve
    thread and the maintenance daemon, and an unguarded read-modify-write
    would silently drop updates from the attribution it exists to provide.

    Every sample also lands in a per-stage log2 latency histogram, read
    back through ``quantiles()`` / ``snapshot()``.
    """

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self._clock = clock
        self._lock = threading.Lock()
        self._ms: dict[str, float] = {}
        self._counts: dict[str, int] = {}
        self._hist: dict[str, list] = {}

    def stage(self, name: str, id: Optional[int] = None,
              parent: Optional[int] = None,
              n: Optional[int] = None) -> "Span":
        """Time one stage: a :class:`Span` on this timer's clock, used as
        ``with timer.stage(name):`` or chained with ``Span.then``."""
        return Span(name, self, id, parent, n, self._clock)

    def add(self, name: str, ms: float) -> None:
        # ``_bucket_of`` inlined (one frexp, outside the lock): this is
        # THE hot path — ≤5% histogram overhead on the compiled edges is
        # an acceptance bound.
        # ``add_many`` calls the helper; the add-vs-add_many histogram
        # equality test pins the two against drift.
        if ms > 0.0:
            e = _frexp(ms)[1]
            idx = (0 if e <= _HIST_MIN_EXP
                   else _HIST_TOP if e > _HIST_MAX_EXP
                   else e - _HIST_MIN_EXP)
        else:
            idx = 0
        with self._lock:
            self._ms[name] = self._ms.get(name, 0.0) + ms
            self._counts[name] = self._counts.get(name, 0) + 1
            try:
                self._hist[name][idx] += 1
            except KeyError:  # first sample for this stage
                self._hist[name] = hist = [0] * HIST_BUCKETS
                hist[idx] += 1

    # ``record`` is another name for the same operation: two
    # perf_counter calls (in ``stage``) + one bucket increment.
    record = add

    def add_many(self, items) -> None:
        """Accumulate several (name, ms) pairs under one lock round-trip —
        for per-request pipelines (governance enforcement) where six
        separate acquisitions would tax the path being attributed."""
        with self._lock:
            for name, ms in items:
                self._ms[name] = self._ms.get(name, 0.0) + ms
                self._counts[name] = self._counts.get(name, 0) + 1
                idx = _bucket_of(ms)
                try:
                    self._hist[name][idx] += 1
                except KeyError:
                    self._hist[name] = hist = [0] * HIST_BUCKETS
                    hist[idx] += 1

    def stages_ms(self, precision: int = 2) -> dict:
        """Fresh {stage: rounded ms} dict in stage-entry order."""
        with self._lock:
            return {k: round(v, precision) for k, v in self._ms.items()}

    def counts(self) -> dict:
        """Fresh {stage: entries} dict in stage-entry order — accumulated ms
        alone can't distinguish one slow call from many fast ones (the
        knowledge engine's ingest/search attribution needs per-call cost)."""
        with self._lock:
            return dict(self._counts)

    def total_ms(self) -> float:
        with self._lock:
            return sum(self._ms.values())

    def quantiles(self, qs: Iterable[float] = DEFAULT_QUANTILES,
                  precision: int = 4) -> dict:
        """{stage: {"p50": ms, ...}} bounded-error latency estimates from
        the log2 histograms (see ``estimate_quantiles`` for the bound)."""
        qs = tuple(qs)  # a one-shot iterator must serve every stage
        with self._lock:
            hists = {k: list(h) for k, h in self._hist.items()}
        return {k: estimate_quantiles(h, qs, precision) for k, h in hists.items()}

    def state(self) -> dict:
        """Mergeable (and picklable) raw state: accumulated ms, counts and
        the log2 histograms themselves. This is the cross-worker aggregation
        seam: a cluster worker ships ``state()`` over a pipe and
        the supervisor ``absorb()``s it — histograms add bucket-wise, so the
        merged quantiles are exactly what one timer observing all workers'
        samples would have estimated (unlike merging the already-estimated
        per-worker quantiles, which has no defensible semantics)."""
        with self._lock:
            return {"ms": dict(self._ms), "counts": dict(self._counts),
                    "hist": {k: list(h) for k, h in self._hist.items()}}

    def absorb(self, state: dict) -> None:
        """Merge another timer's ``state()`` into this one (bucket-wise)."""
        ms, counts, hist = state["ms"], state["counts"], state["hist"]
        with self._lock:
            for k, v in ms.items():
                self._ms[k] = self._ms.get(k, 0.0) + v
            for k, v in counts.items():
                self._counts[k] = self._counts.get(k, 0) + v
            for k, h in hist.items():
                mine = self._hist.get(k)
                if mine is None:
                    self._hist[k] = list(h)
                else:
                    for i, c in enumerate(h):
                        mine[i] += c

    def snapshot(self, precision: int = 2,
                 qs: Iterable[float] = DEFAULT_QUANTILES) -> dict:
        """Consistent one-lock view for status surfaces:
        ``{"stages_ms", "counts", "total_ms", "quantiles"}``.

        Status paths that used to call ``stages_ms()`` then ``counts()``
        back-to-back could observe a sample that landed between the two
        reads — ms and counts attributing different traffic. Quantile
        estimation happens on copies, outside the lock."""
        qs = tuple(qs)
        with self._lock:
            raw_ms = dict(self._ms)
            counts = dict(self._counts)
            hists = {k: list(h) for k, h in self._hist.items()}
        return {
            "stages_ms": {k: round(v, precision) for k, v in raw_ms.items()},
            "counts": counts,
            "total_ms": round(sum(raw_ms.values()), precision),
            "quantiles": {k: estimate_quantiles(h, qs)
                          for k, h in hists.items()},
        }


# ── spans ────────────────────────────────────────────────────────────

SPAN_LOG_CAPACITY = 1 << 20


def tracing() -> bool:
    """True while a torch profiler records: the profiler's Python-level
    flag. No profiler can record before torch's profiler module is
    imported, so this module imports nothing of torch."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and prof._is_profiler_enabled


class SpanRecord(NamedTuple):
    name: str
    t0: float            # time.perf_counter seconds
    t1: float
    thread: int          # threading.get_ident() of the thread that logged it
    id: Optional[int]    # the request, batch or call id
    parent: Optional[int]
    n: Optional[int]     # rows the span worked on
    cpu_s: Optional[float]  # the thread's CPU seconds inside (serving spans)


class SpanLog:
    """The bounded log of span records, newest kept. A ``deque`` with a
    ``maxlen``: its appends, its copy and its ``clear`` are each one step
    under the interpreter lock, so no lock of its own, which the serving
    thread would otherwise queue on behind every session's ``wake``."""

    def __init__(self, capacity: int = SPAN_LOG_CAPACITY):
        self._records: collections.deque = collections.deque(maxlen=capacity)

    def add(self, name: str, t0: float, t1: float, id: Optional[int] = None,
            parent: Optional[int] = None, n: Optional[int] = None,
            cpu_s: Optional[float] = None) -> None:
        self._records.append(
            (name, t0, t1, threading.get_ident(), id, parent, n, cpu_s))

    def between(self, t0: float, t1: float) -> list:
        """The records lying inside ``[t0, t1]``, in the order logged."""
        return [SpanRecord._make(r) for r in list(self._records)
                if r[1] >= t0 and r[2] <= t1]

    def clear(self) -> None:
        self._records.clear()

    def __len__(self) -> int:
        return len(self._records)


SPANS = SpanLog()
_ids = itertools.count(1)


def new_id() -> int:
    """A fresh id for a request, batch or call, unique in the process."""
    return next(_ids)


def _profiler_range(name: str):
    """A profiler range named ``name`` on the calling thread: torch's
    ``_RecordFunctionFast``. It records the range ``record_function``
    does, but ``record_function`` enters and leaves through the op
    dispatcher, which hands the interpreter lock to any thread waiting for
    it at both ends: on the collector, with its sessions waiting, that
    would add the very off-CPU time the spans measure."""
    from torch._C._profiler import _RecordFunctionFast

    return _RecordFunctionFast(name)


class Span:
    """One interval of work on a serving thread, started at construction
    and ended by :meth:`end`, by leaving its ``with`` block, or by
    :meth:`then`, which starts the next span at the same instant. Adds its
    ms to ``timer`` under ``name`` when given (``StageTimer.stage``
    returns one); while tracing, is a profiler range and a log record with
    the thread's CPU seconds (``cpu=False``: none, for a span whose parts
    tile it, so that its CPU time is theirs summed and no read of the CPU
    clock falls between its ends and theirs)."""

    __slots__ = ("name", "timer", "id", "parent", "n", "t0", "_clock",
                 "_range", "_cpu0")

    def __init__(self, name: str, timer: Optional[StageTimer] = None,
                 id: Optional[int] = None, parent: Optional[int] = None,
                 n: Optional[int] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 cpu: bool = True):
        self.name, self.timer, self.id, self.parent, self.n = \
            name, timer, id, parent, n
        self._clock = clock
        traced = tracing()
        self._arm(traced, cpu)
        if traced:
            # entered before the start is read: a name's first range
            # costs tens of µs more than the next
            self._range.__enter__()
        self.t0 = clock()

    def _arm(self, traced: bool, cpu: bool) -> None:
        """Ready the span to start: while tracing, its profiler range made
        and the thread's CPU clock read (a system call, µs on some hosts),
        so that only entering the range lies between the start and the end
        of the span before it."""
        self._range = _profiler_range("openclaw." + self.name) \
            if traced else None
        self._cpu0 = time.thread_time() if traced and cpu else None

    def _stop(self, cpu1: Optional[float]) -> tuple:
        """Read the end and leave the range: (t1, CPU seconds or None)."""
        cpu_s = None if self._cpu0 is None else cpu1 - self._cpu0
        t1 = self._clock()
        if self._range is not None:
            self._range.__exit__(None, None, None)
        return t1, cpu_s

    @property
    def traced(self) -> bool:
        """Whether this span lands in the log (tracing was on at start)."""
        return self._range is not None

    def end(self, timed: bool = True) -> float:
        """Close the span; returns its end on ``clock``. ``timed=False``
        leaves its stage out (a step that failed is no sample of it)."""
        t1, cpu_s = self._stop(
            None if self._cpu0 is None else time.thread_time())
        self._record(t1, cpu_s, timed)
        self._close()
        return t1

    def then(self, name: str) -> "Span":
        """Close this span and start ``name`` (same timer, ids, rows and
        clock) where it ended: no gap between the two stages, one read of
        the CPU clock for both, and the next profiler range opens right as
        this one closes, before either's bookkeeping."""
        traced = self._range is not None
        nxt = Span.__new__(Span)
        nxt.name, nxt.timer, nxt.id, nxt.parent, nxt.n, nxt._clock = \
            name, self.timer, self.id, self.parent, self.n, self._clock
        nxt._arm(traced, True)
        t1, cpu_s = self._stop(nxt._cpu0)
        nxt.t0 = t1
        if traced:
            nxt._range.__enter__()
        self._record(t1, cpu_s, True)
        self._close()
        return nxt

    def _close(self) -> None:
        """Ended: a later ``end`` records nothing (an error handler may
        end a span that a chain has already closed)."""
        self._range = self.timer = self._cpu0 = None

    def _record(self, t1: float, cpu_s: Optional[float],
                timed: bool) -> None:
        if self._range is not None:
            SPANS.add(self.name, self.t0, t1, self.id, self.parent, self.n,
                      cpu_s)
        if timed and self.timer is not None:
            self.timer.add(self.name, (t1 - self.t0) * 1e3)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        self.end()


class _NoSpan:
    """What :func:`span` hands back with no stage and no profiler."""

    traced = False

    def end(self, timed: bool = True) -> None:
        return None

    def then(self, name: str) -> "_NoSpan":
        return self

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None


_NO_SPAN = _NoSpan()


def span(name: str, id: Optional[int] = None, parent: Optional[int] = None,
         n: Optional[int] = None, cpu: bool = True):
    """A :class:`Span` without a stage: while tracing, a profiler range and
    a log record; otherwise a shared no-op."""
    if not tracing():
        return _NO_SPAN
    return Span(name, None, id, parent, n, cpu=cpu)
