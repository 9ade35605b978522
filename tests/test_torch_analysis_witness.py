"""The port's ``LockOrderWitness`` against the JAX package's.

The same threaded schedules go through both witnesses and must give
equal ``edges()`` (with each edge's first thread and order) and
``cycles()``: JAX's seeded A→B / B→A inversion, a consistent order, RLock
re-entry with and without a lock taken in between, and the non-blocking
probe. Then each package's ``Journal`` under its own witness records the
commit→buffer edge and no cycle, as JAX's
``test_journal_locks_witnessed_acyclic`` asserts; and the port's
``chip_smoke.py`` lock-order check fails a cycle and a witness that never
saw the group commit.
"""

from __future__ import annotations

import threading

import pytest

# the bounds module puts the repository root on the path for chip_smoke
import test_torch_chip_smoke_bounds  # noqa: F401

import chip_smoke  # noqa: E402
from vainplex_openclaw_tpu.analysis import witness as jax_witness
from vainplex_openclaw_tpu.storage import journal as jax_journal
from vainplex_openclaw_tpu_torch.analysis import witness
from vainplex_openclaw_tpu_torch.storage import journal


def inversion(w):
    """Two threads, serialized by an event, take A then B and B then A:
    no deadlock this run, but the order is inverted."""
    a = w.wrap("A", threading.Lock())
    b = w.wrap("B", threading.Lock())
    first_done = threading.Event()

    def t1():
        with a:
            with b:
                pass
        first_done.set()

    def t2():
        first_done.wait(5)
        with b:
            with a:
                pass

    th1 = threading.Thread(target=t1, name="t1")
    th2 = threading.Thread(target=t2, name="t2")
    th1.start(); th2.start(); th1.join(5); th2.join(5)


def consistent(w):
    a = w.wrap("A", threading.Lock())
    b = w.wrap("B", threading.Lock())
    for _ in range(3):
        with a:
            with b:
                pass


def rlock_reentry(w):
    r = w.wrap("R", threading.RLock())
    with r:
        with r:
            pass


def rlock_interleaved(w):
    a = w.wrap("A", threading.RLock())
    b = w.wrap("B", threading.Lock())
    with a:
        with b:
            with a:
                pass


def nonblocking_probe(w):
    lk = w.wrap("L", threading.Lock())
    assert lk.acquire(blocking=False)
    lk.release()
    lk.acquire()
    assert not lk.acquire(blocking=False)  # held: the probe fails
    lk.release()


def three_threads(w):
    """A chain A→B, B→C from one thread each and C→A from a third, in
    turn: one cycle through all three locks."""
    locks = {n: w.wrap(n, threading.Lock()) for n in "ABC"}
    turns = [threading.Event() for _ in range(3)]

    def run(i, outer, inner):
        if i:
            turns[i - 1].wait(5)
        with locks[outer]:
            with locks[inner]:
                pass
        turns[i].set()

    threads = [threading.Thread(target=run, args=(i, o, n), name=f"t{i}")
               for i, (o, n) in enumerate(("AB", "BC", "CA"))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(5)


SCHEDULES = {"inversion": inversion, "consistent": consistent,
             "rlock_reentry": rlock_reentry,
             "rlock_interleaved": rlock_interleaved,
             "nonblocking_probe": nonblocking_probe,
             "three_threads": three_threads}
WANT = {"inversion": ({("A", "B"), ("B", "A")}, [["A", "B", "A"]]),
        "consistent": ({("A", "B")}, []),
        "rlock_reentry": (set(), []),
        "rlock_interleaved": ({("A", "B")}, []),
        "nonblocking_probe": (set(), []),
        "three_threads": ({("A", "B"), ("B", "C"), ("C", "A")},
                          [["A", "B", "C", "A"]])}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_gives_jax_s_edges_and_cycles(name):
    out = []
    for mod in (witness, jax_witness):
        w = mod.LockOrderWitness()
        SCHEDULES[name](w)
        out.append((w.edges(), w.cycles()))
    (edges, cycles), (jax_edges, jax_cycles) = out
    assert edges == jax_edges and cycles == jax_cycles
    assert (set(edges), cycles) == WANT[name]
    w = witness.LockOrderWitness()
    SCHEDULES[name](w)
    if cycles:
        with pytest.raises(AssertionError, match="has cycles"):
            w.assert_acyclic()
    else:
        w.assert_acyclic()


def journal_run(mod, path):
    """JAX's journal case: a snapshot stream and an append stream, 20
    appends each, commit, spill, compact, close."""
    w = (witness if mod is journal else jax_witness).LockOrderWitness()
    j = mod.Journal(path / "journal", {"windowMs": 0}, wall=False)
    w.wrap_attr(j, "_commit_lock", "Journal._commit_lock")
    w.wrap_attr(j, "_buffer_lock", "Journal._buffer_lock")
    j.register_snapshot("s", path / "s.json", indent=2)
    sunk: list = []
    j.register_append("a", lambda batch, dedup: sunk.extend(batch))
    for i in range(20):
        j.append("s", {"i": i})
        j.append("a", {"i": i})
    j.commit()
    j.spill("a", keep=5)
    j.compact()
    j.close()
    return w


def test_journal_locks_witnessed_acyclic(tmp_path):
    got = journal_run(journal, tmp_path / "port")
    want = journal_run(jax_journal, tmp_path / "jax")
    assert ("Journal._commit_lock", "Journal._buffer_lock") in got.edges()
    assert set(got.edges()) == set(want.edges())
    got.assert_acyclic()


def test_chip_smoke_lock_check_fails_a_cycle_and_a_blind_witness():
    w = witness.LockOrderWitness()
    inversion(w)
    with pytest.raises(chip_smoke.SmokeFailure, match="cycles"):
        chip_smoke.check_lock_order(w, "storm")
    w = witness.LockOrderWitness()
    consistent(w)
    with pytest.raises(chip_smoke.SmokeFailure, match="no .* edge"):
        chip_smoke.check_lock_order(w, "storm")
    w = witness.LockOrderWitness()
    outer = w.wrap("Journal._commit_lock", threading.RLock())
    inner = w.wrap("Journal._buffer_lock", threading.Lock())
    with outer:
        with inner:
            pass
    assert chip_smoke.check_lock_order(w, "storm") == {
        "edges": 1, "cycles": [],
        "edge_list": [["Journal._commit_lock", "Journal._buffer_lock"]]}
