"""Runtime witnesses: the build-and-launch, protocol and lock-order
witnesses, the dynamic halves of the static passes.

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
budget.

:class:`ProtocolWitness` is a copy of the JAX module's, under the same
name: it records the cluster's grant/recover/deliver/release/handoff
event sequence of a real run (the port's ``ClusterSupervisor`` and its
workers) and asserts the protocol's order invariants over it: grants
advance the epoch strictly, traffic never precedes recovery at the
granted epoch, and a handoff never regrants before the release barrier
returned.

:class:`LockOrderWitness` is the JAX module's too, under the same name: the
dynamic half of the lock-order pass (:mod:`.lock_order`). The static graph
sees lexical ``with`` nesting inside one class; it cannot see a
``StageTimer`` lock taken inside a ``FactStore`` critical section, or any
order that only materialises through callbacks. Wrap the locks of
interest, run the real workload (the cluster storms drive every serving
edge concurrently, on the card too), and every acquisition made while
holding another wrapped lock records a directed edge with the first
observing thread. :meth:`LockOrderWitness.cycles` then answers whether two
threads could have deadlocked on an inverted order, even if the run
happened to schedule around it: an acyclic witnessed order is the
schedule-independent property a storm that never deadlocks cannot show.

Wrapped locks proxy ``acquire``/``release``/context-manager use, including
the non-blocking probe (``acquire(blocking=False)``) the journal's group
wait uses; re-entrant acquisition of the same wrapped lock (RLock) records
no self-edge. A lock handed to a ``threading.Condition`` before it was
wrapped stays raw inside the condition: wrap it before the condition is
built, or leave that class out. Overhead is one thread-local list op per
acquire/release plus a dict insert on first-seen edges; nothing imports
this module at serving time.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional


class _WitnessedLock:
    """Proxy recording acquisition order into its witness."""

    __slots__ = ("_name", "_lock", "_witness")

    def __init__(self, name: str, lock, witness: "LockOrderWitness"):
        self._name = name
        self._lock = lock
        self._witness = witness

    def acquire(self, *args, **kwargs):
        got = self._lock.acquire(*args, **kwargs)
        if got:
            self._witness._note_acquire(self._name)
        return got

    def release(self):
        self._witness._note_release(self._name)
        return self._lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._lock.locked()


class LockOrderWitness:
    """Records per-thread acquisition stacks and the edge set they imply."""

    def __init__(self):
        self._tls = threading.local()
        self._edges: dict = {}   # (outer, inner) -> (thread_name, seq)
        self._seq = 0
        self._mutex = threading.Lock()

    def wrap(self, name: str, lock) -> _WitnessedLock:
        return _WitnessedLock(name, lock, self)

    def wrap_attr(self, obj, attr: str, name: Optional[str] = None):
        """Replace ``obj.attr`` with a witnessed proxy in place:
        ``witness.wrap_attr(journal, "_commit_lock", "Journal._commit_lock")``."""
        label = name or f"{type(obj).__name__}.{attr}"
        wrapped = self.wrap(label, getattr(obj, attr))
        setattr(obj, attr, wrapped)
        return wrapped

    # ── recording ────────────────────────────────────────────────────

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _note_acquire(self, name: str) -> None:
        stack = self._stack()
        if name in stack:
            # Re-entrant acquire (RLock): the thread already OWNS this lock,
            # so this acquire can never block — recording edges from the
            # locks taken in between (A → B → A again) would manufacture a
            # cycle out of a schedule that cannot deadlock.
            stack.append(name)
            return
        if stack:
            with self._mutex:
                for h in stack:
                    if (h, name) not in self._edges:
                        self._seq += 1
                        self._edges[(h, name)] = (
                            threading.current_thread().name, self._seq)
        stack.append(name)

    def _note_release(self, name: str) -> None:
        stack = self._stack()
        # release() order is the caller's business; drop the NEWEST hold of
        # this name (matching RLock semantics).
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == name:
                del stack[i]
                return

    # ── reporting ────────────────────────────────────────────────────

    def edges(self) -> dict:
        with self._mutex:
            return dict(self._edges)

    def cycles(self) -> list:
        """Elementary cycles in the witnessed order graph (each as a node
        list ``[a, b, …, a]``); empty list = acquisition order is a DAG.
        Shares the DFS with the static pass (lock_order.elementary_cycles)
        so the two halves can never drift on what counts as a cycle."""
        from .lock_order import elementary_cycles
        graph: dict = {}
        for a, b in self.edges():
            graph.setdefault(a, set()).add(b)
        return elementary_cycles(graph)

    def assert_acyclic(self) -> None:
        cycles = self.cycles()
        if cycles:
            pretty = "; ".join(" -> ".join(c) for c in cycles)
            raise AssertionError(
                f"lock acquisition order has cycles: {pretty} "
                f"(edges: {sorted(self.edges())})")


def launch_counters() -> dict:
    """``{name: getter}`` of each kernel's launch count."""
    from ..ops import flash_attention as fa
    from ..ops import similarity as sim

    return {"k1": lambda: fa.launches, "k2": lambda: fa.stats_launches,
            "k3": lambda: sim.launches}


class ProtocolWitness:
    """Records the cluster's protocol event sequence and answers whether
    the dynamic order honored the protocol's order invariants.

    Wrap with :meth:`arm_supervisor` (leases + every current worker handle
    + the handoff entry point); call it again after membership changes
    that build new handles (a second supervisor generation). Recording is
    append-only and lock-cheap: test and storm freight, which nothing
    imports at serving time.

    Events recorded (each ``(kind, ws, info)``):

    - ``grant``    — LeaseTable.grant returned ``info["epoch"]``
    - ``recover``  — a worker's add_workspace(ws, epoch) returned
    - ``deliver``  — a worker finished delivering ``info["seq"]``
    - ``release``  — release_workspace(ws) returned (barrier success)
    - ``handoff``/``handoff-end`` — the supervisor's handoff window
    """

    def __init__(self):
        self._mutex = threading.Lock()
        self.events: list = []

    def note(self, kind: str, ws, **info) -> None:
        with self._mutex:
            self.events.append((kind, str(ws) if ws is not None else None,
                                info))

    # ── arming ───────────────────────────────────────────────────────

    def _wrap(self, obj, attr, record):
        fn = getattr(obj, attr)
        if getattr(fn, "_proto_witnessed", False):
            return

        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            record(out, *args, **kwargs)
            return out

        wrapped._proto_witnessed = True
        wrapped.__wrapped__ = fn
        setattr(obj, attr, wrapped)

    def arm_supervisor(self, sup) -> None:
        """Wrap the supervisor's lease grants, handoff window, and every
        CURRENT worker handle's protocol methods. Idempotent per object;
        re-call after adding workers or adopting a new generation."""
        self._wrap(sup.leases, "grant",
                   lambda epoch, ws, wid: self.note("grant", ws,
                                                    epoch=epoch, owner=wid))
        fn = sup.handoff
        if not getattr(fn, "_proto_witnessed", False):
            def handoff(ws, *a, _fn=fn, **kw):
                self.note("handoff", ws)
                try:
                    return _fn(ws, *a, **kw)
                finally:
                    self.note("handoff-end", ws)
            handoff._proto_witnessed = True
            handoff.__wrapped__ = fn
            sup.handoff = handoff
        for state in sup.workers().values():
            self.arm_worker(state.handle)

    def arm_worker(self, handle) -> None:
        self._wrap(handle, "add_workspace",
                   lambda out, ws, epoch: self.note("recover", ws,
                                                    epoch=epoch))
        self._wrap(handle, "deliver",
                   lambda out, seq, op: self.note(
                       "deliver", op.get("ws"), seq=seq,
                       content=op.get("content"),
                       worker=handle.worker_id))
        self._wrap(handle, "release_workspace",
                   lambda out, ws: self.note("release", ws))

    # ── the order rules ──────────────────────────────────────────────

    def violations(self) -> list:
        """Order-invariant breaches over the recorded sequence, each a
        ``(invariant, message)`` pair; empty list = the dynamic schedule
        honored the table."""
        with self._mutex:
            events = list(self.events)
        out: list = []
        last_epoch: dict = {}        # ws -> last granted epoch
        recovered_at: dict = {}      # ws -> epoch recovery last returned for
        # Handoff windows are tracked PER WORKSPACE (a depth count plus a
        # released-in-window mark), not as one LIFO stack: concurrent
        # handoffs of different workspaces interleave their events, and a
        # shared stack would attribute ws A's release to whichever window
        # happened to be on top.
        open_windows: dict = {}      # ws -> open handoff window depth
        released: set = set()        # ws whose open window saw its release
        for kind, ws, info in events:
            if kind == "grant":
                epoch = info.get("epoch")
                prev = last_epoch.get(ws)
                if prev is not None and epoch <= prev:
                    out.append((
                        "epoch-monotonic",
                        f"grant({ws}) returned epoch {epoch} after {prev} — "
                        f"epochs must advance strictly"))
                last_epoch[ws] = epoch
                if open_windows.get(ws, 0) > 0 and ws not in released:
                    out.append((
                        "barrier-before-regrant",
                        f"handoff({ws}) regranted before the release "
                        f"barrier returned"))
            elif kind == "recover":
                recovered_at[ws] = info.get("epoch")
            elif kind == "deliver":
                if ws in last_epoch \
                        and recovered_at.get(ws) != last_epoch[ws]:
                    out.append((
                        "fence-before-traffic",
                        f"deliver({ws}, seq={info.get('seq')}) before "
                        f"recovery at epoch {last_epoch[ws]} returned "
                        f"(recovered at {recovered_at.get(ws)})"))
            elif kind == "release":
                if open_windows.get(ws, 0) > 0:
                    released.add(ws)
            elif kind == "handoff":
                open_windows[ws] = open_windows.get(ws, 0) + 1
                released.discard(ws)
            elif kind == "handoff-end":
                depth = open_windows.get(ws, 0)
                if depth <= 1:
                    open_windows.pop(ws, None)
                else:
                    open_windows[ws] = depth - 1
                released.discard(ws)
        return out

    def assert_clean(self) -> None:
        violations = self.violations()
        if violations:
            pretty = "; ".join(f"[{inv}] {msg}" for inv, msg in violations)
            raise AssertionError(f"protocol order violated: {pretty}")


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
