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
"""

from __future__ import annotations

import math
import threading
import time
from contextlib import contextmanager
from typing import Callable, Iterable

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

    @contextmanager
    def stage(self, name: str):
        t0 = self._clock()
        try:
            yield
        finally:
            self.add(name, (self._clock() - t0) * 1000.0)

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
