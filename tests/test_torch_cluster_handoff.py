"""The port's planned handoff and supervisor adoption against the JAX
package's: JAX's ``tests/test_cluster_handoff.py`` storms (handoffs mid
storm, with a kill, each pre-grant fault, a fence-write fault at the
regrant, a resume fault past it) and its two-supervisor adoption (with a
crash in the second generation, and the first generation's fenced zombie
write), each run through both packages from one seed with equal
duration-free summaries, and each converging to the never-moved oracle's
tenant bytes."""

from __future__ import annotations

from pathlib import Path

import pytest

from test_torch_cluster_failover import (JAX, JOURNAL_CFG, KILL_STEP, N_OPS,
                                         PORT, SEED, SetClock, both,
                                         build_ops, check_protocol,
                                         flush_cluster, lock_witness,
                                         run_storm, tenant_state,
                                         verdict_check, zombie_write)

HANDOFF_STEPS = (60, 120)


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    """The never-moved, never-killed storm of the port."""
    return run_storm(PORT, tmp_path_factory.mktemp("oracle"))


def test_handoff_mid_storm_equals_jax_with_zero_replay(tmp_path, oracle):
    moved, want = both(tmp_path, "move", handoff_steps=HANDOFF_STEPS)
    assert moved == want
    assert len(moved["handoffs"]) == len(HANDOFF_STEPS)
    for h in moved["handoffs"]:
        assert h["replayedRecords"] == 0 and h["redelivered"] == 0
        assert h["from"] != h["to"]
    assert moved["handoffAborts"] == 0 and moved["fencedRecords"] == 0
    assert moved["membership"]["dead"] == []
    verdict_check(moved, build_ops(PORT, SEED, tmp_path))
    assert moved["state"] == oracle["state"]
    assert len([ws for ws, lease in moved["leases"].items()
                if lease["epoch"] > 1]) == len(HANDOFF_STEPS)


def test_handoff_plus_worker_kill_equals_jax(tmp_path, oracle):
    got, want = both(tmp_path, "both", handoff_steps=HANDOFF_STEPS,
                     kill_step=KILL_STEP)
    assert got == want
    assert len(got["failovers"]) == 1 and len(got["handoffs"]) >= 1
    verdict_check(got, build_ops(PORT, SEED, tmp_path))
    assert got["fencedRecords"] == 0
    assert got["state"] == oracle["state"]


@pytest.mark.parametrize("site", ["cluster.handoff.drain",
                                  "cluster.handoff.barrier",
                                  "cluster.handoff.regrant"])
def test_pre_grant_fault_aborts_cleanly_as_jax(tmp_path, oracle, site):
    got, want = both(tmp_path, "abort", handoff_steps=(60,),
                     fault_specs=(((site,), {"steps": (1,)}),))
    assert got == want
    assert got["fired"].get(site) == 1
    assert got["handoffAborts"] == 1 and got["handoffs"] == []
    assert all(lease["epoch"] == 1 for lease in got["leases"].values())
    verdict_check(got, build_ops(PORT, SEED, tmp_path))
    assert got["state"] == oracle["state"]


def test_fence_write_fault_at_regrant_falls_back_as_jax(tmp_path, oracle):
    """``cluster.lease`` on the handoff's grant (lease call 9, after the 8
    first-sight grants): the supervisor grants back to the source."""
    got, want = both(tmp_path, "fence", handoff_steps=(60,),
                     fault_specs=((("cluster.lease",), {"steps": (9,)}),))
    assert got == want
    assert got["fired"].get("cluster.lease") == 1
    assert got["handoffAborts"] == 1 and got["handoffs"] == []
    assert got["fencedRecords"] == 0
    assert len([ws for ws, lease in got["leases"].items()
                if lease["epoch"] > 1]) == 1
    verdict_check(got, build_ops(PORT, SEED, tmp_path))
    assert got["state"] == oracle["state"]


def test_resume_fault_past_the_regrant_is_retried_as_jax(tmp_path, oracle):
    got, want = both(tmp_path, "resume", handoff_steps=(60,),
                     fault_specs=((("cluster.handoff.resume",),
                                   {"steps": (1,)}),))
    assert got == want
    assert got["fired"].get("cluster.handoff.resume") == 1
    assert got["handoffAborts"] == 0 and len(got["handoffs"]) == 1
    assert got["handoffs"][0]["replayedRecords"] == 0
    verdict_check(got, build_ops(PORT, SEED, tmp_path))
    assert got["state"] == oracle["state"]


def test_handoff_storm_is_bit_identical_per_seed(tmp_path):
    a = run_storm(PORT, tmp_path / "a", handoff_steps=HANDOFF_STEPS)
    b = run_storm(PORT, tmp_path / "b", handoff_steps=HANDOFF_STEPS)
    assert a == b


# ── two supervisor generations ──────────────────────────────────────

SPLIT = 90


def two_generations(pkg, root: Path, kill_step=None) -> dict:
    """Generation A serves the first half and its machine dies (every
    worker crashes); generation B adopts the root and the shared route log
    and serves the rest."""
    pkg.reset_journals()
    clock = SetClock()
    results: dict[int, dict] = {}

    def note(op, obs):
        results[op.get("i")] = obs

    transport = pkg.MemoryTransport(clock=clock)
    ops = build_ops(pkg, SEED, root)
    cfg = {"workers": 3, "ackEveryOps": 6, "deterministicIds": True,
           "ackWatermarkEvery": 1}
    sup_a = pkg.ClusterSupervisor(
        root, cfg, clock=clock, wall_timers=False, settable_clock=clock,
        journal_cfg=JOURNAL_CFG, transport=transport, on_result=note)
    plan = pkg.FaultPlan([pkg.FaultSpec("journal.fsync", rate=0.05)],
                         seed=SEED)
    with pkg.installed(plan):
        for op in ops[:SPLIT]:
            sup_a.submit(op)
            sup_a.tick()
        sup_a.drain()
        before = {Path(ws).name: lease["epoch"]
                  for ws, lease in sup_a.leases.snapshot().items()}
        for state in sup_a.workers().values():
            state.handle.crash()
        sup_a.leases.close()
        sup_b = pkg.ClusterSupervisor(
            root, dict(cfg, workerPrefix="b"), clock=clock,
            wall_timers=False, settable_clock=clock, journal_cfg=JOURNAL_CFG,
            transport=transport, on_result=note, adopt=True)
        locks = lock_witness(sup_b)
        proto = pkg.ProtocolWitness()
        proto.arm_supervisor(sup_b)
        for op in ops[SPLIT:]:
            sup_b.submit(op)
            sup_b.tick()
            if kill_step is not None and op["i"] == kill_step:
                live = sup_b.stats()["membership"]["live"]
                sup_b.workers()[live[0]].handle.crash()
                sup_b.tick()
        flush_cluster(sup_b)
    stats = sup_b.stats()
    summary = {
        "results": {i: results.get(i) for i in range(N_OPS)},
        "fired": dict(plan.fired),
        "leasesBefore": before,
        "leases": {Path(ws).name: lease
                   for ws, lease in stats["leases"].items()},
        "adoption": [{k: v for k, v in f.items() if k not in
                      ("durationMs", "at")}
                     for f in stats["failovers"]
                     if f["worker"] == "(adopted)"],
        "membership": stats["membership"],
        "fencedRecords": stats["fencedRecords"],
        "redelivered": stats["redelivered"],
        "state": tenant_state(root),
    }
    sup_b.stop()
    locks.assert_acyclic()
    check_protocol(proto)
    pkg.reset_journals()
    return summary


def test_adoption_equals_jax_and_converges(tmp_path, oracle):
    got = two_generations(PORT, tmp_path / "port" / "two")
    assert got == two_generations(JAX, tmp_path / "jax" / "two")
    verdict_check(got, build_ops(PORT, SEED, tmp_path))
    assert len(got["adoption"]) == 1
    assert got["adoption"][0]["workspacesMoved"] == len(got["leasesBefore"])
    for ws, lease in got["leases"].items():
        assert lease["owner"].startswith("b")
        assert lease["epoch"] == got["leasesBefore"][ws] + 1
    assert got["state"] == oracle["state"]
    # generation A's surviving writer holds the old epoch: fenced
    name, lease = sorted(got["leases"].items())[0]
    zombies = [zombie_write(pkg, tmp_path / key / "two" / "tenants" / name,
                            lease["epoch"] - 1)
               for pkg, key in ((PORT, "port"), (JAX, "jax"))]
    assert zombies[0] == zombies[1]
    assert zombies[0]["committed"] is False
    assert zombies[0]["fencedRecords"] == 1 and zombies[0]["untouched"]
    assert zombies[0]["fence"] == lease["epoch"]


def test_adoption_with_a_crash_in_the_second_generation_equals_jax(
        tmp_path, oracle):
    got = two_generations(PORT, tmp_path / "port", kill_step=120)
    assert got == two_generations(JAX, tmp_path / "jax", kill_step=120)
    verdict_check(got, build_ops(PORT, SEED, tmp_path))
    assert len(got["membership"]["dead"]) == 1
    assert got["state"] == oracle["state"]
