"""The build-and-launch witness: no kernel build in a timed phase.

Counterpart of ``vainplex_openclaw_tpu/analysis/witness.py::
RetraceWitness``, with the same method names. JAX pins that a stream of
same-bucket calls compiles no new program. The port never traces: what it
must not repeat at serve time is an ``nvcc`` build (``ops/_build.builds``
counts the processes :func:`~..ops._build.build` starts). So a "trace"
here is a build, and :meth:`RetraceWitness.probe` watches an object's
``builds`` count where JAX watches a jitted callable's compile cache.

Beside the builds the witness reads the kernels' launch counters
(:func:`launch_counters`: K1's ``flash_attention.launches``, K2's
``stats_launches`` and K3's ``similarity.launches``), so that a timed
phase can pin its launches to a formula, such as steps × rounds
(:meth:`RetraceWitness.launched`). Launches never count against a build
budget. The lock-order and protocol witnesses of the JAX module
are framework tools that import no JAX and are not copied.
"""

from __future__ import annotations

from typing import Callable, Optional


def launch_counters() -> dict:
    """``{name: getter}`` of each kernel's launch count."""
    from ..ops import flash_attention as fa
    from ..ops import similarity as sim

    return {"k1": lambda: fa.launches, "k2": lambda: fa.stats_launches,
            "k3": lambda: sim.launches}


class RetraceWitness:
    """Counts builds per name so that a timed phase can pin zero.

    - :meth:`probe` watches an object's ``builds`` attribute (the
      ``ops._build`` module, or a stand-in in a test);
    - :meth:`attach_counter` takes any other build counter as a getter;
    - :meth:`attach_launches` reads launch counters (default: every
      kernel's, from :func:`launch_counters`), which the build budget
      ignores.

    :meth:`baseline` snapshots every count; :meth:`assert_budget` then
    fails when a build count grew past the budget, and raises on a name
    nothing instrumented (a pin on a typo would pass forever)."""

    def __init__(self):
        self._counters: dict = {}   # name -> getter of a build count
        self._launches: dict = {}   # name -> getter of a launch count
        self._base: dict = {}       # name -> count at the last baseline()
        self._launch_base: dict = {}

    @classmethod
    def armed(cls) -> "RetraceWitness":
        """A witness over ``ops._build``'s builds (as ``"builds"``) and
        every kernel's launches."""
        from ..ops import _build

        witness = cls()
        witness.probe("builds", _build)
        witness.attach_launches()
        return witness

    # ── instrumentation ──────────────────────────────────────────────

    def probe(self, name: str, cache) -> None:
        """Watch ``cache.builds``; raises ``TypeError`` when ``cache`` has
        no such count (an unarmed probe would count nothing)."""
        if not isinstance(getattr(cache, "builds", None), int):
            raise TypeError(f"{cache!r} exposes no integer builds count")
        self._counters[name] = lambda: cache.builds

    def attach_counter(self, name: str, getter: Callable[[], int]) -> None:
        """Take an external build counter (``lambda: module.builds``)."""
        self._counters[name] = getter

    def attach_launches(self, counters: Optional[dict] = None) -> None:
        """Read launch counters ``{name: getter}`` (default: K1, K2, K3)."""
        self._launches.update(counters or launch_counters())

    # ── readings ─────────────────────────────────────────────────────

    def traces(self, name: str) -> int:
        """The build count of ``name`` now (0 for an unknown name)."""
        getter = self._counters.get(name)
        return int(getter()) if getter is not None else 0

    def names(self) -> list:
        return sorted(self._counters)

    def launched(self, name: str) -> int:
        """Launches of ``name`` since the last :meth:`baseline`."""
        getter = self._launches.get(name)
        if getter is None:
            raise KeyError(f"no launch counter {name!r} (have: "
                           f"{sorted(self._launches)})")
        return int(getter()) - self._launch_base.get(name, 0)

    # ── assertions ───────────────────────────────────────────────────

    def baseline(self) -> dict:
        """Snapshot every count; budgets and launches are read relative
        to it (call after the warm-up, before the timed phase)."""
        self._base = {n: self.traces(n) for n in self.names()}
        self._launch_base = {n: int(g()) for n, g in self._launches.items()}
        return dict(self._base)

    def assert_budget(self, budget: int = 0,
                      name: Optional[str] = None) -> None:
        """Every build count (or just ``name``'s) grew by at most
        ``budget`` since :meth:`baseline`; 0 pins no build at all."""
        if name is not None and name not in self._counters:
            raise KeyError(
                f"{name!r} was never instrumented (have: {self.names()}) — "
                f"this assertion would pass unconditionally")
        names = [name] if name is not None else self.names()
        over = [f"{n}: {self.traces(n) - self._base.get(n, 0)} new builds "
                f"(budget {budget})" for n in names
                if self.traces(n) - self._base.get(n, 0) > budget]
        if over:
            raise AssertionError(
                "build budget exceeded — a timed phase built a kernel: "
                + "; ".join(over))

    def assert_no_retrace(self, name: Optional[str] = None) -> None:
        self.assert_budget(0, name)
