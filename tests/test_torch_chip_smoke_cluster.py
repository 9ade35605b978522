"""``chip_smoke.py``'s cluster phase, its legs run here on the CPU at a
small size: the chaos storm through the port's ``ClusterSupervisor`` with
the fleet armed (and the same storm with no kill and no retire, whose
tenant files it must equal), process workers with a real SIGKILL, and two
workers that own a replica batcher each. Each storm's locks are under the
port's ``LockOrderWitness``: acyclic, with the lease journal's
commit→buffer edge. The CPU's plain attention counts
no launches, so the kernels' counts are the card's check. Controls: an
oracle that disagrees on one text, and a storm whose tenant files differ,
must each fail the phase."""

from __future__ import annotations

import pytest

# the bounds module puts the repository root on the path for chip_smoke
from test_torch_chip_smoke_bounds import one_torch_thread  # noqa: F401

import chip_smoke  # noqa: E402
from vainplex_openclaw_tpu_torch.models import serve

SMALL = {"n_storm": 120, "n_process": 48, "kill_after": 24, "n_serve": 8}


def test_cluster_ops_are_seeded_and_carry_every_kind(tmp_path):
    ops = chip_smoke.cluster_ops(chip_smoke.CLUSTER_OPS,
                                 chip_smoke.CLUSTER_SEED, str(tmp_path))
    assert ops == chip_smoke.cluster_ops(chip_smoke.CLUSTER_OPS,
                                         chip_smoke.CLUSTER_SEED,
                                         str(tmp_path))
    assert {op["kind"] for op in ops} == {
        "msg_in", "msg_out", "tool_ok", "tool_denied", "tool_secret"}
    assert {op["wsKey"] for op in ops} == {
        f"tenant{t}" for t in range(chip_smoke.CLUSTER_TENANTS)}
    assert [op["i"] for op in ops] == list(range(chip_smoke.CLUSTER_OPS))


def test_cluster_legs_on_the_cpu(tmp_path, monkeypatch, openclaw_home,
                                 one_torch_thread):
    """The process leg's workers start as on the card, with ``spawn``
    (``mp_context``'s rule once CUDA is initialised)."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    try:
        legs = chip_smoke.cluster_legs("cpu", str(tmp_path), **SMALL)
    finally:
        serve.close_batchers()
    storm = legs["storm"]
    assert [c["chaos"] for c in storm["chaos"]] == [
        "kill", "retire_replica", "retire_worker"]
    assert len(storm["failovers"]) == 1 and storm["denials"] > 0
    assert storm["redactions"] > 0 and storm["route_faults"] == 1
    assert storm["served"] == SMALL["n_storm"] and storm["batches"] > 0
    assert storm["routed"] == storm["served"] + storm["redelivered"]
    assert storm["launches"] is None
    assert storm["route_ms"] > 0 and storm["recover_ms"] > 0
    assert storm["tenant_files"] == legs["host_storm"]["tenant_files"]
    for leg in (storm, legs["host_storm"]):   # the port's lock witness
        assert leg["lock_order"]["cycles"] == [] \
            and list(chip_smoke.JOURNAL_LOCK_EDGE) in \
            leg["lock_order"]["edge_list"]
    assert legs["host_storm"]["chaos"] == []
    process = legs["process"]
    assert process["victim"] is not None and process["failover_ms"] >= 0
    assert process["served"] == SMALL["n_process"]
    assert {"cluster", "governance", "cortex"} <= set(
        process["merged_edge_kinds"])
    serve_leg = legs["worker_serve"]
    assert serve_leg["batches"] > 0
    assert serve_leg["scopes"] == ["wa@<root>/wa", "wb@<root>/wb"]


def test_a_wrong_oracle_fails_the_storm(tmp_path, openclaw_home,
                                        one_torch_thread):
    n = 48
    ops = chip_smoke.cluster_ops(n, chip_smoke.CLUSTER_SEED, str(tmp_path))
    oracle = chip_smoke.one_shot_oracle({op["content"] for op in ops},
                                        device="cpu")
    text = ops[5]["content"]
    oracle[text] = "not the verdict"
    try:
        with pytest.raises(chip_smoke.SmokeFailure,
                           match="verdict_mismatches"):
            chip_smoke.cluster_storm("cpu", str(tmp_path / "s"), n,
                                     chip_smoke.CLUSTER_SEED, oracle,
                                     chaos=False)
    finally:
        serve.close_batchers()


def test_differing_tenant_files_fail_the_phase(tmp_path, monkeypatch,
                                               openclaw_home,
                                               one_torch_thread):
    """The CPU storm's tenant files with one tracker file changed: the
    legs must name it."""
    real = chip_smoke.cluster_tenant_files

    def files(root):
        out = real(root)
        if root.endswith("host"):
            key = sorted(out)[0]
            out[key] = out[key] + b" "
        return out

    monkeypatch.setattr(chip_smoke, "cluster_tenant_files", files)
    try:
        with pytest.raises(chip_smoke.SmokeFailure, match="tenant files"):
            chip_smoke.cluster_legs("cpu", str(tmp_path), n_storm=60,
                                    n_process=0, kill_after=0, n_serve=0)
    finally:
        serve.close_batchers()
