"""The port's adversarial packs and ReDoS attack synthesis against the JAX
package's.

- ``run_adversarial_report`` in sim mode, one case per pack (each with
  its no-attack control) and all five together with the sitrep state
  file: the report equal to JAX's as sorted JSON, the state file's bytes
  equal, ``read_adversarial_state`` equal.
- ``run_redos_stage_gate`` (wall clock, so its p99s are the host's): the
  same keys, budget and storm verdicts (0 lost, 0 false blocks).
- The attack synthesis: ``worst_case_inputs`` and ``stress_inputs`` over
  every shipped pattern and the demoted corpus, ``shipped_patterns``,
  ``_redos_probes``, the merged workloads' digests, ``unicode_pressure``
  and a ``FenceArena`` under the same zombie ops.
"""

from __future__ import annotations

import json

import pytest

from test_torch_chip_smoke_bounds import one_torch_thread  # noqa: F401
from vainplex_openclaw_tpu.analysis import _builtin_policies as jax_builtins
from vainplex_openclaw_tpu.analysis import redos as jax_redos
from vainplex_openclaw_tpu.slo import adversarial as jax_adv
from vainplex_openclaw_tpu.slo.workload import workload_digest
from vainplex_openclaw_tpu_torch.analysis import _builtin_policies
from vainplex_openclaw_tpu_torch.analysis import redos
from vainplex_openclaw_tpu_torch.slo import adversarial as adv

PACKS = adv.ADVERSARIAL_DEFAULTS["packs"]


def test_tables_are_jax_s():
    assert adv.ADVERSARIAL_DEFAULTS == jax_adv.ADVERSARIAL_DEFAULTS
    assert adv.DEMOTED_PATTERN_CORPUS == jax_adv.DEMOTED_PATTERN_CORPUS
    assert sorted(adv.PACK_GENERATORS) == sorted(jax_adv.PACK_GENERATORS)
    assert adv.adversarial_config({"pumpLength": 9}) == \
        jax_adv.adversarial_config({"pumpLength": 9})
    assert [json.dumps(p, sort_keys=True) for p in _builtin_policies()] == \
        [json.dumps(p, sort_keys=True) for p in jax_builtins()]


@pytest.mark.parametrize("pack", PACKS)
def test_each_pack_s_sim_report_equals_jax_s(pack, openclaw_home,
                                             one_torch_thread):
    kw = dict(seed=3, n_ops=160, tenants=4, packs=(pack,))
    got = adv.run_adversarial_report(device="cpu", **kw)
    want = jax_adv.run_adversarial_report(**kw)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert got["adversarial"]["survived"]
    assert got["adversarial"]["byPack"][pack] > 0


def test_all_packs_with_the_state_file(tmp_path, openclaw_home,
                                       one_torch_thread):
    kw = dict(seed=8, n_ops=200, tenants=3, saturation=1.5,
              config={"megaMessageBytes": 1 << 14, "zwjFloodLen": 32})
    got = adv.run_adversarial_report(device="cpu", workspace=tmp_path / "p",
                                     **kw)
    want = jax_adv.run_adversarial_report(workspace=tmp_path / "j", **kw)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert (tmp_path / "p" / ".adversarial.json").read_bytes() == \
        (tmp_path / "j" / ".adversarial.json").read_bytes()
    assert adv.read_adversarial_state(tmp_path / "p") == \
        jax_adv.read_adversarial_state(tmp_path / "j")
    assert got["adversarial"]["fence"]["leaked"] == 0
    assert got["adversarial"]["unicode"]["ops"] > 0


def test_redos_stage_gate_matches_jax_s_verdicts(openclaw_home,
                                                 one_torch_thread):
    kw = dict(seed=2, n_ops=120, tenants=3)
    got = adv.run_redos_stage_gate(device="cpu", **kw)
    want = jax_adv.run_redos_stage_gate(**kw)
    assert sorted(got) == sorted(want)
    for key in ("metric", "seed", "budgetFactor", "stormVerdictLosses",
                "stormFalseBlocks"):
        assert got[key] == want[key], key
    assert sorted(got["factors"]) == sorted(want["factors"])
    assert got["stormVerdictLosses"] == got["stormFalseBlocks"] == 0


def test_attack_synthesis_is_jax_s():
    shipped = adv.shipped_patterns()
    assert shipped == jax_adv.shipped_patterns()
    for pattern, flags in shipped + [(p, 0) for p in
                                     adv.DEMOTED_PATTERN_CORPUS]:
        for pump in (8, 48):
            assert redos.worst_case_inputs(pattern, flags, pump=pump) == \
                jax_redos.worst_case_inputs(pattern, flags, pump=pump)
            assert redos.stress_inputs(pattern, flags, pump=pump) == \
                jax_redos.stress_inputs(pattern, flags, pump=pump)
    for pattern in adv.DEMOTED_PATTERN_CORPUS:
        assert redos.worst_case_inputs(pattern)
    cfg = adv.adversarial_config()
    assert adv._redos_probes(cfg) == jax_adv._redos_probes(cfg)


@pytest.mark.parametrize("seed", [0, 4])
def test_merged_workloads_are_jax_s(seed):
    cfg = {"megaMessageBytes": 1 << 12}
    for packs in (None, ("tenant_skew", "fence_thrash"), ()):
        got = adv.generate_adversarial_workload(seed, 300, 5, packs=packs,
                                                config=cfg)
        want = jax_adv.generate_adversarial_workload(seed, 300, 5,
                                                     packs=packs, config=cfg)
        assert [op.to_tuple() for op in got] == \
            [op.to_tuple() for op in want]
        assert workload_digest(got) == workload_digest(want)
        assert adv.unicode_pressure(got, 64) == \
            jax_adv.unicode_pressure(want, 64)
    with pytest.raises(ValueError) as a:
        adv.generate_adversarial_workload(0, 10, 2, packs=("nope",))
    with pytest.raises(ValueError) as b:
        jax_adv.generate_adversarial_workload(0, 10, 2, packs=("nope",))
    assert str(a.value) == str(b.value)


def test_fence_arena_rejects_every_zombie_as_jax_s(tmp_path):
    ops = [op for op in adv.generate_adversarial_workload(
        6, 400, 3, packs=("fence_thrash",)) if op.kind == "zombie_write"]
    got = adv.FenceArena(tmp_path / "p")
    want = jax_adv.FenceArena(tmp_path / "j")
    for op in ops:
        got.handle(op)
        want.handle(op)
    assert got.stats() == want.stats()
    assert got.stats()["rejected"] == len(ops) > 0
    assert got.stats()["anomalies"] == []
