"""The port's group-commit ``Journal`` against the JAX package's.

One seeded script of appends to a snapshot stream and an append stream,
commits, compactions, spills, ``drop_pending``, snapshot ships with
rotation into the cold tier, closes and reopens, ``abandon`` and a replay,
and last a fence that a newer epoch takes over, runs on both ``Journal``
classes in fresh directories with one virtual clock. After every step the
two ``stats()`` must be equal, and at the end the two file trees must be
byte-equal. The gzip header of a cold segment carries the wall clock's
second (``gzip.open`` stamps ``mtime``), so those four bytes are zeroed
before the comparison; every other byte is compared. The same script runs
again under one seeded ``FaultPlan`` on the ``journal.*``, ``file.*`` and
``lifecycle.*`` sites, a fresh plan of the same seed installed in each
package for its own run.
"""

from __future__ import annotations

import json
import random
from pathlib import Path

import pytest

from helpers import FakeClock
from vainplex_openclaw_tpu.resilience import faults as jax_faults
from vainplex_openclaw_tpu.storage import journal as jax_journal
from vainplex_openclaw_tpu_torch.resilience import faults as port_faults
from vainplex_openclaw_tpu_torch.storage import journal as port_journal

SETTINGS = {"fsync": "group", "maxBatchRecords": 6, "maxPendingRecords": 40,
            "maxSegmentBytes": 1500}
LIFECYCLE = {"enabled": True, "shipEveryRecords": 24, "tierDir": "cold",
             "tierFanout": 4, "maxColdSegments": 3}


def script(seed: int, n: int = 160) -> list:
    rng = random.Random(seed)
    ops = []
    for i in range(n):
        r = rng.random()
        if r < 0.34:
            ops.append(("snap", i))
        elif r < 0.70:
            ops.append(("audit", i, rng.random() < 0.5))
        elif r < 0.77:
            ops.append(("commit",))
        elif r < 0.83:
            ops.append(("compact",))
        elif r < 0.86:
            ops.append(("spill", rng.randrange(4)))
        elif r < 0.89:
            ops.append(("drop_pending",))
        elif r < 0.92:
            ops.append(("ship",))
        elif r < 0.96:
            ops.append(("reopen",))
        else:
            ops.append(("abandon",))
    # the fence: a newer owner's epoch lands while records are buffered
    ops += [("audit", n, False), ("fence",), ("audit", n + 1, True),
            ("commit",), ("audit", n + 2, False), ("close",)]
    return ops


class Run:
    """One package's journal driven by the script."""

    def __init__(self, jmod, fmod, root: Path, clock):
        self.jmod, self.fmod, self.root, self.clock = jmod, fmod, root, clock
        self.day = {"day": "2026-10-18"}
        self.journal = None
        self.open()

    def sink(self, batch, dedup):
        path = self.root / "audit" / "2026-10-18.jsonl"
        if dedup:
            batch, _ = self.jmod.dedup_against_tail(path, batch)
        if not batch:
            return
        path.parent.mkdir(parents=True, exist_ok=True)
        with path.open("a", encoding="utf-8") as fh:
            self.fmod.write_with_faults(
                "file.append", fh.write,
                "".join(raw + "\n" for _q, raw, _m in batch))

    def open(self):
        j = self.jmod.Journal(self.root / "journal", SETTINGS,
                              clock=self.clock, wall=False,
                              lifecycle=LIFECYCLE)
        j.register_snapshot("threads", self.root / "state" / "threads.json")
        j.register_append("audit", self.sink)
        self.journal = j

    def step(self, op):
        j = self.journal
        kind = op[0]
        if kind == "snap":
            i = op[1]
            return j.append("threads", {"i": i, "title": f"thread → {i} é",
                                        "open": list(range(i % 5))})
        if kind == "audit":
            _, i, with_meta = op
            return j.append("audit", {"seq": i, "msg": f"record {i} ✓"},
                            meta=self.day if with_meta else None)
        if kind == "commit":
            return j.commit()
        if kind == "compact":
            return j.compact()
        if kind == "spill":
            return j.spill("audit", op[1])
        if kind == "drop_pending":
            return j.drop_pending()
        if kind == "ship":
            return j.ship_snapshot()
        if kind == "reopen":
            j.close()
            self.open()
            return self.journal.stats()["replay"]
        if kind == "abandon":
            j.abandon()
            self.open()
            return self.journal.stats()["replay"]
        if kind == "fence":
            fence = self.root / "cluster.fence.json"
            j.set_fence(fence, 5)
            fence.write_text(json.dumps({"epoch": 6}))
            return j.fenced()
        if kind == "close":
            j.close()
            return j.fenced()
        raise AssertionError(op)

    def drive(self, ops) -> list:
        out = []
        for op in ops:
            try:
                res = ("ok", self.step(op))
            except OSError as exc:  # a fault, or the fence's refusal
                res = ("raised", type(exc).__name__, str(exc))
            self.clock.advance(0.25)
            stats = json.dumps(self.journal.stats(), sort_keys=True)
            out.append((op, res, stats.replace(str(self.root), "<root>")))
        return out


def tree(root: Path) -> dict:
    out = {}
    for path in sorted(root.rglob("*")):
        if path.is_file():
            data = path.read_bytes()
            if path.name.endswith(".gz") and len(data) >= 8:
                data = data[:4] + b"\0\0\0\0" + data[8:]  # gzip mtime
            out[str(path.relative_to(root))] = data
    return out


def run_side(jmod, fmod, root: Path, ops, plan):
    root.mkdir()
    if plan is not None:
        fmod.install_plan(plan)
    try:
        steps = Run(jmod, fmod, root, FakeClock()).drive(ops)
    finally:
        fmod.clear_plan()
    return steps, tree(root), dict(plan.fired) if plan is not None else {}


def fault_plan(mod, seed: int):
    return mod.FaultPlan([
        mod.FaultSpec("journal.append", rate=0.08, mode="torn"),
        mod.FaultSpec("journal.fsync", rate=0.05),
        mod.FaultSpec("file.*", rate=0.07, mode="torn"),
        mod.FaultSpec("lifecycle.*", rate=0.15)], seed=seed)


@pytest.mark.parametrize("faulted", [False, True], ids=["clean", "faults"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_journal_script_matches_jax(tmp_path, seed, faulted):
    ops = script(seed)
    want_steps, want_tree, want_fired = run_side(
        jax_journal, jax_faults, tmp_path / "jax", ops,
        fault_plan(jax_faults, seed) if faulted else None)
    got_steps, got_tree, got_fired = run_side(
        port_journal, port_faults, tmp_path / "port", ops,
        fault_plan(port_faults, seed) if faulted else None)
    for got, want in zip(got_steps, want_steps):
        assert got == want
    assert len(got_steps) == len(want_steps)
    assert sorted(got_tree) == sorted(want_tree)
    for name in want_tree:
        assert got_tree[name] == want_tree[name], name
    # the script reached what it is meant to reach
    final = json.loads(want_steps[-1][2])
    assert final["fenced"] and final["fencedRecords"] >= 1
    assert any(op[0] == "audit" and res[0] == "raised"
               and res[1] == "FencedWriteError"
               for op, res, _ in want_steps)
    assert final["rotations"] >= 1 or any(
        json.loads(s)["rotations"] for _, _, s in want_steps)
    assert any(name.startswith("journal/cold/") for name in want_tree)
    assert "state/threads.json" in want_tree
    assert "audit/2026-10-18.jsonl" in want_tree
    replays = [json.loads(s)["replay"] for op, _, s in want_steps
               if op[0] in ("reopen", "abandon")]
    assert replays and any(r["segments"] for r in replays)
    assert got_fired == want_fired
    if faulted:
        assert len(want_fired) >= 4
        for prefix in ("journal.", "file.", "lifecycle."):
            assert any(site.startswith(prefix) for site in want_fired)


def test_journal_module_surface_matches_jax():
    names = ("Journal", "FencedWriteError", "DEFAULT_JOURNAL_SETTINGS",
             "journal_settings", "get_journal", "peek_journal",
             "reset_journals", "tail_lines", "dedup_against_tail")
    for name in names:
        assert hasattr(port_journal, name), name
    assert port_journal.DEFAULT_JOURNAL_SETTINGS == \
        jax_journal.DEFAULT_JOURNAL_SETTINGS
    assert issubclass(port_journal.FencedWriteError, OSError)
    for cfg in (None, {}, {"storage": {"journal": False}},
                {"storage": {"journal": {"fsync": "always", "windowMs": 0}}},
                {"storage": {"journal": {"enabled": False, "dir": "j2"}}}):
        for default in (True, False):
            assert port_journal.journal_settings(cfg, default) == \
                jax_journal.journal_settings(cfg, default)


def test_registry_shares_and_reopens(tmp_path):
    ws = tmp_path / "ws"
    ws.mkdir()
    try:
        a = port_journal.get_journal(ws, wall=False)
        assert port_journal.get_journal(ws) is a and a.wall  # upgrade only
        assert port_journal.peek_journal(ws) is a
        a.close()
        assert port_journal.peek_journal(ws) is None
        b = port_journal.get_journal(ws, wall=False)
        assert b is not a and not b._closed
    finally:
        port_journal.reset_journals()
    assert port_journal.peek_journal(ws) is None
