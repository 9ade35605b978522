"""The port's interleaving explorer against the JAX package's.

The port's explorer drives the port's own ``ClusterSupervisor``,
``InProcessWorker``, ``LeaseTable`` and ``Journal``; JAX's drives JAX's.
For each of the 7 ``EXPLORER_CONFIGS`` both enumerate the same schedule
strings; an exhaustive sweep of every configuration runs once per side
(one shared fixture each, as JAX's repo gate shares its run) and finds no
violation on either; each of the four injected protocol bugs goes red on
both sides with the same schedules and invariants, and a violation
replays from its schedule string. The port's ``ack-without-commit``
mutation must patch the attributes the port's worker has, or the red
would prove nothing: that is pinned too.
"""

from __future__ import annotations

import re

import pytest

from vainplex_openclaw_tpu.analysis import explore as j_explore
from vainplex_openclaw_tpu.analysis import proto_table as j_pt
from vainplex_openclaw_tpu_torch.analysis import explore as p_explore
from vainplex_openclaw_tpu_torch.analysis import proto_table as p_pt

MUTATIONS = [("frozen-epoch", "failover-crash"),
             ("skip-fence-write", "failover-crash"),
             ("ack-without-commit", "failover-crash"),
             ("skip-barrier", "handoff")]


def norm(violations) -> list:
    """Violations without the temporary roots each run makes."""
    return sorted((*v[:-1], re.sub(r"\S+/tenants/", "<root>/tenants/",
                                   v[-1])) for v in violations)


@pytest.mark.parametrize("name", [c.name for c in j_pt.EXPLORER_CONFIGS])
def test_schedules_equal_jax_s(name):
    got = p_explore.schedules(p_pt.explorer_config(name))
    assert got == j_explore.schedules(j_pt.explorer_config(name))
    assert len(set(got)) == len(got)


def test_the_universe_is_jax_s_77():
    assert sum(len(p_explore.schedules(c))
               for c in p_pt.EXPLORER_CONFIGS) == 77 == sum(
        len(j_explore.schedules(c)) for c in j_pt.EXPLORER_CONFIGS)


@pytest.fixture(scope="module")
def sweeps():
    """Every configuration, exhaustively, once per side."""
    return {"port": p_explore.run(), "jax": j_explore.run()}


def test_clean_sweep_on_both_sides(sweeps):
    for side in ("port", "jax"):
        findings, executed = sweeps[side]
        assert executed == 77, side
        assert findings == [], [f.render() for f in findings]


@pytest.mark.parametrize("mutation,config", MUTATIONS)
def test_each_mutation_goes_red_on_both_sides(tmp_path, mutation, config):
    got = p_explore.run_config(config, base_dir=tmp_path, mutation=mutation)
    want = j_explore.run_config(config, base_dir=tmp_path, mutation=mutation)
    assert got["violations"] and want["violations"], mutation
    assert got["schedules"] == want["schedules"]
    assert {(s, inv) for s, inv, _m in got["violations"]} == {
        (s, inv) for s, inv, _m in want["violations"]}


def test_violation_replays_from_its_string(tmp_path):
    report = p_explore.run_config("failover-crash", base_dir=tmp_path,
                                  mutation="skip-fence-write")
    schedule, invariant, _msg = report["violations"][0]
    first = p_explore.run_schedule("failover-crash", schedule,
                                   base_dir=tmp_path,
                                   mutation="skip-fence-write")
    second = p_explore.run_schedule("failover-crash", schedule,
                                    base_dir=tmp_path,
                                    mutation="skip-fence-write")
    assert first and norm(first) == norm(second)
    assert invariant in [inv for inv, _m in first]
    assert norm(first) == norm(j_explore.run_schedule(
        "failover-crash", schedule, base_dir=tmp_path,
        mutation="skip-fence-write"))
    findings, executed = p_explore.run(
        configs=(p_pt.explorer_config("failover-crash"),),
        mutation="skip-fence-write")
    assert executed == 4 and findings
    assert all(f.rule == "GL-PROTO-SCHED" and f.path.startswith(
        "vainplex_openclaw_tpu_torch/") for f in findings)
    assert "replay: failover-crash@" in findings[0].message


def test_ack_mutation_patches_the_port_s_worker(tmp_path):
    """The mutated ack reaches the port's worker: it resets every list the
    port's _ack keeps per seq, and the acked seqs leave with no commit."""
    cfg = p_pt.explorer_config("failover-crash")
    run = p_explore._ScheduleRun(cfg, tmp_path, mutation="ack-without-commit")
    try:
        run.step("a0")
        run.step("a1")     # ack_every=2: the boundary acks here
        handles = [s.handle for s in run.sup.workers().values()]
        owner = next(h for h in handles if h.shard)
        for attr in ("_since_ack", "_since_ack_ws", "_released_early",
                     "_touched"):
            assert hasattr(owner, attr) and not getattr(owner, attr), attr
        assert owner.acked == 2
        # the journal still holds both records uncommitted: no wal yet
        assert run._durable_contents(next(iter(owner.shard))) == {}
    finally:
        run.finish()
