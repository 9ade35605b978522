"""The port's SLO harness (``run_slo_report``) against the JAX package's.

- ``mode="sim"``: the whole report equal to JAX's as sorted JSON at seeds
  11 and 12, with admission and without (the regression contract the JAX
  suite pins bit for bit).
- ``mode="wall"`` without admission, one gateway and ``workers=2`` (the
  port's ``ClusterSupervisor``): the verdict accounting, the workload
  digest, the hook counts and the stage counts equal JAX's (latencies and
  the journals' wall-windowed commits are the host's and differ);
  ``slo_stage_records`` reads the report as JAX's does.
- The five-plugin gateway (``_build_gateway``) loads JAX's plugins and
  configs; with ``device=None`` and no card it raises at load, where JAX's
  has no device to ask for.
"""

from __future__ import annotations

import json

import pytest
import torch

from test_torch_chip_smoke_bounds import one_torch_thread  # noqa: F401
import vainplex_openclaw_tpu.slo as jax_slo
from vainplex_openclaw_tpu.slo import harness as jax_harness
import vainplex_openclaw_tpu_torch.slo as port_slo
from vainplex_openclaw_tpu_torch.device import DeviceError
from vainplex_openclaw_tpu_torch.slo import harness


@pytest.mark.parametrize("seed", [11, 12])
@pytest.mark.parametrize("admission", [True, False])
def test_sim_report_equals_jax_s(seed, admission, openclaw_home,
                                 one_torch_thread):
    kw = dict(seed=seed, n_ops=260, tenants=4, saturation=2.0, mode="sim",
              admission=admission)
    got = harness.run_slo_report(device="cpu", **kw)
    want = jax_harness.run_slo_report(**kw)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert got["verdicts"]["losses"] == 0
    assert (got["admission"].get("shed", 0) > 0) == admission


def same_counts(got: dict, want: dict, wall_journals: bool = False) -> None:
    """Equal counts; with ``wall_journals`` (a wall-clock run's journals
    may group their commits in wall-clock windows) the journal edges'
    commit and fsync counts are the host's and are left out."""
    for key in ("verdicts", "workload", "hook_stats", "stage_counts"):
        a, b = got[key], want[key]
        if key == "stage_counts" and wall_journals:
            a, b = ({k: v for k, v in d.items() if not k.startswith("journal:")}
                    for d in (a, b))
            assert set(got[key]) == set(want[key])
        assert a == b, key
    assert got["e2e"]["count"] == want["e2e"]["count"]
    assert got["verdicts"]["losses"] == 0
    assert got["verdicts"]["false_blocks"] == 0


def test_wall_report_counts_equal_jax_s(openclaw_home, one_torch_thread):
    kw = dict(seed=3, n_ops=240, tenants=3, saturation=1.0, mode="wall",
              admission=False)
    got = harness.run_slo_report(device="cpu", **kw)
    want = jax_harness.run_slo_report(**kw)
    same_counts(got, want, wall_journals=True)
    assert set(got["stages"]) == set(want["stages"])
    assert port_slo.slo_stage_records(got) == [
        {**rec, **{q: got["stages"][rec["edge"]][rec["stage"]][q]
                   for q in got["stages"][rec["edge"]][rec["stage"]]}}
        for rec in jax_slo.slo_stage_records(got)]
    assert [r["metric"] for r in port_slo.slo_stage_records(got)] == \
        ["slo_stage_quantiles"] * sum(len(s) for s in got["stages"].values())


def test_workers_report_counts_equal_jax_s(openclaw_home, one_torch_thread):
    kw = dict(seed=5, n_ops=200, tenants=4, saturation=1.0, mode="wall",
              admission=False, workers=2)
    got = harness.run_slo_report(device="cpu", **kw)
    want = jax_harness.run_slo_report(**kw)
    same_counts(got, want, wall_journals=True)
    assert got["workers"] == want["workers"] == 2
    assert got["ingress_shed"] == want["ingress_shed"] == 0
    assert got["cluster"]["workers"] == want["cluster"]["workers"]


@pytest.mark.parametrize("kw", [
    {"mode": "live"}, {"n_ops": 0}, {"saturation": 0.0}, {"tenants": 0},
    {"workers": 2, "mode": "sim"}])
def test_argument_errors_are_jax_s(kw):
    with pytest.raises(ValueError) as got:
        harness.run_slo_report(device="cpu", **kw)
    with pytest.raises(ValueError) as want:
        jax_harness.run_slo_report(**kw)
    assert str(got.value) == str(want.value)


def test_exports_are_jax_s():
    assert set(jax_slo.__all__) <= set(port_slo.__all__)
    assert set(port_slo.__all__) - set(jax_slo.__all__) == \
        {"generate_serve_texts"}


def test_the_five_plugin_gateway(tmp_path, openclaw_home, monkeypatch):
    clock = harness._SimClock()
    gw, sitrep = harness._build_gateway(tmp_path, 3, clock, True, 16,
                                        device="cpu")
    jgw, _ = jax_harness._build_gateway(tmp_path / "jax", 3, clock, True, 16)
    assert sorted(gw.plugins) == sorted(jgw.plugins) == [
        "cortex", "eventstore", "governance", "knowledge-engine", "sitrep"]
    assert {k: p.api.plugin_config for k, p in gw.plugins.items()} == \
        {k: p.api.plugin_config for k, p in jgw.plugins.items()}
    assert gw.admission.stats() == jgw.admission.stats()
    assert harness._tenant_ctx(tmp_path, 2) == \
        jax_harness._tenant_ctx(tmp_path, 2)
    gw.stop()
    jgw.stop()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceError):
        harness._build_gateway(tmp_path / "card", 3, clock, True, 16)
