"""Deterministic, seed-driven fault injection for the port's writers.

A copy of ``vainplex_openclaw_tpu/resilience/faults.py`` under the same
names, kept here so the port imports nothing of the JAX package. Each
interesting I/O edge is a named *fault site* that consults the installed
plan before it does the real work. The port's sites are the JAX package's
at the same places:

- ``"file.write"`` (torn-capable), ``"file.fsync"`` and ``"file.rename"``
  in :func:`..storage.atomic.write_json_atomic`, the writer of the trace
  analyzer's report and state files;
- ``"checkpoint.write"`` (after the npz is written, before any rename) and
  ``"checkpoint.rename"`` (between the manifest's rename and the npz's) in
  :func:`..models.checkpoint.save_checkpoint`;
- ``"file.append"`` (torn-capable) in
  :func:`..storage.atomic.append_jsonl`;
- ``"transport.publish"`` in both event transports (torn-capable in
  ``FileTransport``'s day-file write), ``"transport.fetch"`` where
  ``FileTransport`` re-reads a file, and ``"transport.compact"``
  (torn-capable) where it compacts a journal batch
  (:mod:`..events.transport`);
- ``"journal.append"`` (torn-capable) and ``"journal.fsync"`` where the
  group commit writes a segment, ``"lifecycle.snapshot"`` and
  ``"lifecycle.demote"`` where it ships and tiers, and the ``file.*``
  sites where compaction rewrites a snapshot stream
  (:mod:`..storage.journal`);
- ``"audit.append"`` (torn-capable) where the audit trail appends a day
  file (:mod:`..governance.audit`);
- ``"clock"``, the default site of :func:`wrap_clock`, a time source whose
  chosen ticks raise.

A plan decides failures from ``(seed, site, per-site call index)`` only, so
a chaos run is bit-reproducible: the same seed gives the same faults on the
same calls, whatever the interleaving across sites.

Fault modes:

- ``"error"``: the site raises :class:`FaultError` (an ``OSError``, so an
  ``except OSError`` recovery path takes it like a real failure);
- ``"torn"``: a write site that routes through :func:`write_with_faults`
  writes a deterministic prefix of its payload and then raises.

:func:`install_plan` takes any object with ``decide(site)`` and
``torn_cut(site, nbytes)`` (checked by duck typing, never by an import), so
one JAX ``FaultPlan`` installed in both packages drives one per-site
schedule over every writer of a process that runs both. Without a plan each
hook is one module-global ``None`` check.
"""

from __future__ import annotations

import random
import threading
from contextlib import contextmanager
from dataclasses import dataclass
from fnmatch import fnmatchcase
from typing import Callable, Optional


class FaultError(OSError):
    """An injected fault. An ``OSError``, so recovery paths that catch
    ``OSError`` treat it as the failure it simulates."""


@dataclass(frozen=True)
class FaultSpec:
    """One rule: fail calls to sites matching ``site`` (an fnmatch pattern
    such as ``"file.*"``) on the given 1-based ``steps`` and/or at a seeded
    probabilistic ``rate``."""

    site: str
    steps: tuple = ()
    rate: float = 0.0
    mode: str = "error"  # "error" | "torn"
    message: str = "injected fault"


class FaultPlan:
    """A seeded schedule of faults over named sites. ``fired`` maps a site
    to the count of faults it injected."""

    def __init__(self, specs: list, seed: int = 0):
        self.seed = seed
        self.specs = list(specs)
        self.fired: dict[str, int] = {}
        self._calls: dict[str, int] = {}
        self._rngs: dict[str, random.Random] = {}
        # sites are hit from several threads; the schedule stays
        # deterministic per site, not per thread
        self._lock = threading.Lock()

    def _rng(self, site: str) -> random.Random:
        rng = self._rngs.get(site)
        if rng is None:
            # a str seed takes the stable sha512 path (PYTHONHASHSEED-proof)
            rng = self._rngs[site] = random.Random(f"{self.seed}:{site}")
        return rng

    def decide(self, site: str) -> Optional[FaultSpec]:
        """Consume one call step at ``site`` and return the spec to apply,
        if any. Each call draws at most one uniform variate per matching
        rate spec, in spec order: the draw sequence is part of the
        contract."""
        with self._lock:
            idx = self._calls.get(site, 0) + 1
            self._calls[site] = idx
            hit: Optional[FaultSpec] = None
            for spec in self.specs:
                if not fnmatchcase(site, spec.site):
                    continue
                if idx in spec.steps:
                    hit = hit or spec
                elif spec.rate and self._rng(site).random() < spec.rate:
                    hit = hit or spec
            if hit is not None:
                self.fired[site] = self.fired.get(site, 0) + 1
            return hit

    def torn_cut(self, site: str, nbytes: int) -> int:
        """The deterministic cut point of a torn write of ``nbytes``."""
        if nbytes <= 1:
            return 0
        with self._lock:
            return self._rng(f"{site}#cut").randrange(nbytes)

    def calls(self, site: str) -> int:
        with self._lock:
            return self._calls.get(site, 0)

    def total_fired(self) -> int:
        with self._lock:
            return sum(self.fired.values())


_ACTIVE = None


def install_plan(plan):
    """Install ``plan``: this package's :class:`FaultPlan` or any object
    with ``decide(site)`` and ``torn_cut(site, nbytes)``, such as the JAX
    package's plan. Anything else raises ``TypeError``."""
    global _ACTIVE
    if not (callable(getattr(plan, "decide", None))
            and callable(getattr(plan, "torn_cut", None))):
        raise TypeError(f"a fault plan needs decide(site) and "
                        f"torn_cut(site, nbytes); got {type(plan).__name__}")
    _ACTIVE = plan
    return plan


def clear_plan() -> None:
    global _ACTIVE
    _ACTIVE = None


def active_plan():
    return _ACTIVE


@contextmanager
def installed(plan):
    """``with installed(FaultPlan([...], seed=7)) as plan: ...``"""
    install_plan(plan)
    try:
        yield plan
    finally:
        clear_plan()


def maybe_fail(site: str) -> None:
    """The hook of a site: nothing without a plan; raises
    :class:`FaultError` when the plan schedules a fault here (a torn spec
    is a plain error at a site that does not write through
    :func:`write_with_faults`)."""
    plan = _ACTIVE
    if plan is None:
        return
    spec = plan.decide(site)
    if spec is not None:
        raise FaultError(f"[fault:{site}] {spec.message}")


def write_with_faults(site: str, write: Callable, data) -> None:
    """The hook of a write site: on a ``"torn"`` spec a deterministic
    prefix of ``data`` is written before the raise."""
    plan = _ACTIVE
    if plan is None:
        write(data)
        return
    spec = plan.decide(site)
    if spec is None:
        write(data)
        return
    if spec.mode == "torn":
        cut = plan.torn_cut(site, len(data))
        if cut:
            write(data[:cut])
        raise FaultError(f"[fault:{site}] torn write at byte {cut}/{len(data)}")
    raise FaultError(f"[fault:{site}] {spec.message}")


def wrap_clock(clock: Callable[[], float], site: str = "clock"):
    """A clock that consults the plan: chosen ticks raise (a time source can
    fail too — NTP death, VM pause detection). Sites that cache per-second
    state must survive it."""

    def faulty_clock() -> float:
        maybe_fail(site)
        return clock()

    return faulty_clock
