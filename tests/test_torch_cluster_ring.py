"""The port's ring, lease table and journal fencing against the JAX
package's: JAX's ``tests/test_cluster_ring.py`` cases on the port's
``HashRing``, ``LeaseTable`` and ``Journal``, with each placement, epoch
and recovered table held equal to what the JAX package gives for the same
inputs; and the port's ``ProtocolWitness`` against JAX's on recorded
sequences that break each order rule."""

from __future__ import annotations

import json
import random

import pytest

from vainplex_openclaw_tpu.analysis import witness as jax_witness
from vainplex_openclaw_tpu.cluster import ring as jax_ring
from vainplex_openclaw_tpu_torch.analysis import witness
from vainplex_openclaw_tpu_torch.cluster import ring
from vainplex_openclaw_tpu_torch.storage.atomic import (read_json,
                                                        write_json_atomic)
from vainplex_openclaw_tpu_torch.storage.journal import (FencedWriteError,
                                                         Journal)

KEYS = [f"tenant{i}" for i in range(200)]


class FakeClock:
    def __init__(self, t: float = 1_700_000_000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def ring_of(mod, members, vnodes=ring.DEFAULT_VNODES):
    r = mod.HashRing(vnodes)
    for w in members:
        r.add(w)
    return r


# ── the ring ────────────────────────────────────────────────────────


@pytest.mark.parametrize("vnodes", [1, 64, 160])
def test_points_and_assignment_equal_jax(vnodes):
    for label in ("w0#0", "w1#159", "tenant7", "ümlaut", ""):
        assert ring._point(label) == jax_ring._point(label)
    members = ("w0", "w1", "w2", "w3")
    got, want = ring_of(ring, members, vnodes), ring_of(jax_ring, members,
                                                       vnodes)
    assert got._points == want._points
    assert got.assignment(KEYS) == want.assignment(KEYS)
    assert got.shares(KEYS) == want.shares(KEYS)


def test_same_assignment_across_insertion_orders():
    a = ring_of(ring, ("w0", "w1", "w2", "w3"))
    b = ring_of(ring, ("w3", "w1", "w0", "w2"))
    assert a.assignment(KEYS) == b.assignment(KEYS)
    first = a.assignment(KEYS)
    a.remove("w1")
    a.add("w1")
    assert a.assignment(KEYS) == first
    two = ring_of(ring, ("w0", "w1"), vnodes=64)
    assert set(two.assignment(KEYS[:32]).values()) == {"w0", "w1"}


def test_removal_and_addition_move_only_their_keys():
    r = ring_of(ring, ("w0", "w1", "w2", "w3"))
    before = r.assignment(KEYS)
    r.remove("w2")
    after = r.assignment(KEYS)
    for key in KEYS:
        if before[key] != "w2":
            assert after[key] == before[key], key
        else:
            assert after[key] != "w2"
    r3 = ring_of(ring, ("w0", "w1", "w2"))
    before = r3.assignment(KEYS)
    r3.add("w9")
    moved = [k for k in KEYS if r3.owner(k) != before[k]]
    assert moved and all(r3.owner(k) == "w9" for k in moved)
    assert len(moved) < len(KEYS) * 0.5


def test_bounded_load_placement_equals_jax():
    placed = []
    for mod in (ring, jax_ring):
        r = ring_of(mod, ("w0", "w1", "w2", "w3"))
        loads: dict = {}
        seq = []
        for key in KEYS:
            owner = r.owner(key, loads, 58)  # 1.15 * 200 / 4
            loads[owner] = loads.get(owner, 0) + 1
            seq.append(owner)
        assert max(loads.values()) <= 58
        placed.append(seq)
    assert placed[0] == placed[1]
    both = ring_of(ring, ("w0", "w1"))
    assert both.owner("k", {"w0": 5, "w1": 5}, 5) == ring_of(
        jax_ring, ("w0", "w1")).owner("k", {"w0": 5, "w1": 5}, 5)
    with pytest.raises(LookupError):
        ring.HashRing().owner("k")
    with pytest.raises(ValueError):
        ring.HashRing(0)


# ── the lease table ─────────────────────────────────────────────────


def test_epochs_fence_files_and_reopen(tmp_path):
    clock = FakeClock()
    table = ring.LeaseTable(tmp_path / "cluster", clock=clock)
    ws_a, ws_b = str(tmp_path / "a"), str(tmp_path / "b")
    assert table.epoch(ws_a) == 0
    assert table.grant(ws_a, "w0") == 1
    assert table.grant(ws_b, "w1") == 1
    assert table.grant(ws_a, "w1") == 2
    assert table.owner(ws_a) == "w1"
    assert ring.LeaseTable.read_fence(ws_a) == {
        "epoch": 2, "owner": "w1", "grantedAt": clock.t}
    assert table.owned_by("w1") == sorted([ws_a, ws_b])
    table.close()
    reopened = ring.LeaseTable(tmp_path / "cluster", clock=clock)
    assert reopened.snapshot() == {ws_a: {"owner": "w1", "epoch": 2},
                                   ws_b: {"owner": "w1", "epoch": 1}}
    assert reopened.grant(ws_a, "w0") == 3
    reopened.close()
    # the JAX package reads the port's lease journal and fence the same way
    jax_table = jax_ring.LeaseTable(tmp_path / "cluster", clock=clock)
    assert jax_table.snapshot()[ws_a] == {"owner": "w0", "epoch": 3}
    assert jax_ring.LeaseTable.read_fence(ws_a)["epoch"] == 3
    jax_table.close()


def grant_history(seed: int, n: int = 12) -> list:
    rng = random.Random(seed)
    return [(f"ws{rng.randrange(4)}", f"w{rng.randrange(3)}")
            for _ in range(n)]


def crash_point(mod, root, history, crash_after: int, compact_every=None):
    """JAX's adoption crash-point property: grants up to ``crash_after``,
    then kill -9 (``Journal.abandon``); the reopened table and the next
    grant's epoch."""
    clock = FakeClock()
    table = mod.LeaseTable(root / "cluster", clock=clock)
    oracle = {}
    for i, (ws_key, worker) in enumerate(history[:crash_after]):
        ws = str(root / ws_key)
        oracle[ws_key] = {"owner": worker, "epoch": table.grant(ws, worker)}
        if compact_every and (i + 1) % compact_every == 0:
            table.journal.compact()
    table.journal.abandon()
    recovered = mod.LeaseTable(root / "cluster", clock=clock)
    snap = {ws.rsplit("/", 1)[-1]: lease
            for ws, lease in recovered.snapshot().items()}
    nxt = recovered.grant(str(root / "ws0"), "w9")
    recovered.close()
    return snap, oracle, nxt


@pytest.mark.parametrize("seed,compact_every", [(7, None), (11, 3)])
def test_every_crash_point_recovers_the_oracle_as_jax(tmp_path, seed,
                                                      compact_every):
    history = grant_history(seed)
    for k in range(len(history) + 1):
        got = crash_point(ring, tmp_path / f"port{k}", history, k,
                          compact_every)
        want = crash_point(jax_ring, tmp_path / f"jax{k}", history, k,
                           compact_every)
        assert got == want, k
        assert got[0] == got[1], f"crash point {k}"


def test_lease_fault_site_raises_before_the_fence(tmp_path):
    from vainplex_openclaw_tpu_torch.resilience.faults import (FaultPlan,
                                                               FaultSpec,
                                                               installed)

    table = ring.LeaseTable(tmp_path / "cluster", clock=FakeClock())
    ws = str(tmp_path / "t0")
    with installed(FaultPlan([FaultSpec("cluster.lease", steps=(1,))])):
        with pytest.raises(OSError):
            table.grant(ws, "w0")
    assert ring.LeaseTable.read_fence(ws) is None
    assert table.grant(ws, "w0") == 2  # the lease committed, the fence not
    assert ring.LeaseTable.read_fence(ws)["epoch"] == 2
    table.close()


# ── journal fencing (the stale-writer race) ─────────────────────────


def fenced_journal(ws, epoch):
    j = Journal(ws / "journal", {"windowMs": 0.0})
    j.register_snapshot("cortex:threads", ws / "threads.json", indent=None)
    j.set_fence(ws / ring.FENCE_FILE, epoch)
    return j


def test_stale_epoch_commit_rejected_and_counted(tmp_path):
    ws = tmp_path / "tenant0"
    ws.mkdir()
    write_json_atomic(ws / ring.FENCE_FILE, {"epoch": 1, "owner": "w0"})
    zombie = fenced_journal(ws, 1)
    assert zombie.append("cortex:threads", {"threads": ["mine"]})
    assert zombie.commit() and zombie.compact()
    owned = (ws / "threads.json").read_bytes()
    write_json_atomic(ws / ring.FENCE_FILE, {"epoch": 2, "owner": "w1"})
    assert zombie.append("cortex:threads", {"threads": ["stale write"]})
    assert zombie.commit() is False
    stats = zombie.stats()
    assert stats["fenced"] is True and stats["fencedRecords"] == 1
    assert (ws / "threads.json").read_bytes() == owned
    assert "stale write" not in (ws / "journal" /
                                 "wal.000000.jsonl").read_text()
    with pytest.raises(FencedWriteError):
        zombie.append("cortex:threads", {"threads": ["again"]})


def test_fenced_close_writes_nothing(tmp_path):
    ws = tmp_path / "tenant2"
    ws.mkdir()
    write_json_atomic(ws / ring.FENCE_FILE, {"epoch": 1, "owner": "w0"})
    zombie = fenced_journal(ws, 1)
    zombie.append("cortex:threads", {"threads": ["pre"]})
    zombie.commit()
    zombie.compact()
    meta = read_json(ws / "journal" / "journal.meta.json", None)
    write_json_atomic(ws / ring.FENCE_FILE, {"epoch": 2, "owner": "w1"})
    zombie.append("cortex:threads", {"threads": ["late"]})
    zombie.close()
    assert read_json(ws / "journal" / "journal.meta.json", None) == meta
    assert json.loads((ws / "threads.json").read_text()) == {
        "threads": ["pre"]}


def test_missing_fence_file_means_unfenced(tmp_path):
    ws = tmp_path / "tenant4"
    ws.mkdir()
    j = fenced_journal(ws, 1)
    j.append("cortex:threads", {"threads": ["fresh"]})
    assert j.commit()
    j.close()
    assert json.loads((ws / "threads.json").read_text()) == {
        "threads": ["fresh"]}


# ── the protocol witness ────────────────────────────────────────────


PROTOCOL_SEQUENCES = {
    "clean": [("grant", "a", {"epoch": 1}), ("recover", "a", {"epoch": 1}),
              ("deliver", "a", {"seq": 1}), ("handoff", "a", {}),
              ("release", "a", {}), ("grant", "a", {"epoch": 2}),
              ("recover", "a", {"epoch": 2}), ("handoff-end", "a", {})],
    "epoch_backwards": [("grant", "a", {"epoch": 2}),
                        ("grant", "a", {"epoch": 2})],
    "traffic_before_recovery": [("grant", "a", {"epoch": 1}),
                                ("recover", "a", {"epoch": 1}),
                                ("grant", "a", {"epoch": 2}),
                                ("deliver", "a", {"seq": 9})],
    "regrant_before_release": [("grant", "a", {"epoch": 1}),
                               ("handoff", "a", {}),
                               ("grant", "a", {"epoch": 2}),
                               ("handoff-end", "a", {})],
    "interleaved_windows": [("handoff", "a", {}), ("handoff", "b", {}),
                            ("release", "b", {}), ("grant", "a",
                                                   {"epoch": 3}),
                            ("handoff-end", "b", {}),
                            ("handoff-end", "a", {})],
}


@pytest.mark.parametrize("name", sorted(PROTOCOL_SEQUENCES))
def test_protocol_witness_equals_jax(name):
    out = []
    for mod in (witness, jax_witness):
        w = mod.ProtocolWitness()
        for kind, ws, info in PROTOCOL_SEQUENCES[name]:
            w.note(kind, ws, **info)
        out.append(w.violations())
    assert out[0] == out[1]
    assert (out[0] == []) == (name == "clean")
    if name != "clean":
        with pytest.raises(AssertionError, match="protocol order violated"):
            w = witness.ProtocolWitness()
            w.events = [(k, ws, i) for k, ws, i in PROTOCOL_SEQUENCES[name]]
            w.assert_clean()
