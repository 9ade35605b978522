"""The port's placement search against the JAX package's.

``vainplex_openclaw_tpu_torch/parallel/plan_search.py`` sweeps
sketch-legal plans through the unchanged port batcher and embeddings
backend; winners land in ``parallel/plan_table.json``. Held to JAX here:

- ``sketch_check`` and ``enumerate_candidates`` (ids, rejections, and each
  candidate's table JSON through ``entry_from_plan``) for every family at
  (1, 1), (2, 1), (2, 4) and (3, 2);
- ``spec_to_json``/``spec_from_json`` round trips, giving JAX's JSON for a
  ``PartitionSpec``;
- ``validate_plan_table`` findings on malformed tables and on both
  shipped tables;
- the search loop's gates (JAX's cases) with a fake ``measure_candidate``,
  and one real search on the CPU grid.

Tolerance: bit-equal throughout (ids, JSON, findings, gate outcomes).
"""

from __future__ import annotations

import json

import pytest
from jax.sharding import PartitionSpec as P

from vainplex_openclaw_tpu.parallel import plan as jax_plan
from vainplex_openclaw_tpu.parallel import plan_search as jax_ps
from vainplex_openclaw_tpu_torch.parallel import plan, plan_search as ps
from vainplex_openclaw_tpu_torch.parallel.mesh import cached_mesh

SHAPES = ((1, 1), (2, 1), (2, 4), (3, 2))
FAMILIES = tuple(jax_plan.PLAN_TABLE)


def _all_rep():
    return tuple((site, "rep") for site, _, _ in ps._ENCODER_SITES)


def _megatron():
    return (("qkv", "col"), ("o", "row"), ("w1", "col"), ("w2", "row"),
            ("embed", "col"))


def _entry(bucket_min=1, gather="replicated"):
    p = ps._candidate_plan("encoder_validator", _all_rep(), bucket_min,
                           gather)
    return ps.entry_from_plan(p, {"rps": 200.0, "candidate": "allrep"},
                              {"rps": 100.0}, 0)


# ── sketches and candidates, against JAX ─────────────────────────────


def test_sketch_tables_equal_jax():
    assert ps._ENCODER_SITES == jax_ps._ENCODER_SITES
    assert set(ps.SKETCHES) == set(jax_ps.SKETCHES)
    for family, sketch in ps.SKETCHES.items():
        assert sketch.__dict__ == jax_ps.SKETCHES[family].__dict__
    assert {k: v for k, v in ps.PLAN_SEARCH_DEFAULTS.items()
            if k not in ("device", "repeatDevice")} == \
        jax_ps.PLAN_SEARCH_DEFAULTS


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("family", FAMILIES)
def test_sketch_check_equals_jax(family, shape):
    assignments = ps._assignments(family, shape)
    assert assignments == jax_ps._assignments(family, shape)
    for a in assignments:
        assert ps.sketch_check(family, a, shape) == \
            jax_ps.sketch_check(family, a, shape)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("family", FAMILIES)
def test_enumerate_candidates_ids_and_json_equal_jax(family, shape):
    cands, rejected = ps.enumerate_candidates(family, shape, (1, 2, 4))
    jcands, jrejected = jax_ps.enumerate_candidates(family, shape, (1, 2, 4))
    assert rejected == jrejected
    assert [c.cand_id for c in cands] == [c.cand_id for c in jcands]
    assert cands[0].plan is plan.PLAN_TABLE[family]
    rec = {"rps": 2.0, "candidate": "x"}
    for c, j in zip(cands, jcands):
        assert (c.assignment, c.collectives) == (j.assignment, j.collectives)
        assert ps.entry_from_plan(c.plan, rec, {"rps": 1.0}, 3,
                                  c.collectives) == \
            jax_ps.entry_from_plan(j.plan, rec, {"rps": 1.0}, 3,
                                   j.collectives)
        assert (c.plan.source, c.plan.description) == \
            (j.plan.source, j.plan.description)


def test_megatron_space_size_as_jax():
    cands, rejected = ps.enumerate_candidates("encoder_validator", (2, 4))
    assert len(rejected) == 24 and len(cands) == 1 + 8 * 3 * 2 - 1
    assert ps.sketch_check("encoder_validator", _megatron(), (2, 4)) == \
        (True, "", [("psum", "qkv->o"), ("psum", "w1->w2"),
                    ("all_gather", "embed")])


# ── specs and the table gate ─────────────────────────────────────────


@pytest.mark.parametrize("spec", [(), (None,), ("dp",), (None, "tp"),
                                  ("tp", None), ("ep", None, None),
                                  (("dp", "sp"), None), ("dp", "sp")])
def test_spec_json_round_trips_as_jax(spec):
    js = plan.spec_to_json(spec)
    assert js == jax_plan.spec_to_json(P(*spec))
    assert plan.spec_from_json(js) == spec
    assert tuple(jax_plan.spec_from_json(js)) == spec
    assert json.loads(json.dumps(js)) == js


@pytest.mark.parametrize("bad", ["x", [1], [[]], [["dp", 2]]])
def test_spec_from_json_refuses_as_jax(bad):
    with pytest.raises(ValueError):
        plan.spec_from_json(bad)
    with pytest.raises(ValueError):
        jax_plan.spec_from_json(bad)


TABLES = (
    {"schema": "nope", "entries": {"cpu:2x1:encoder_validator": None}},
    {"schema": "plan-table-v1", "entries": {}},
    {"schema": "plan-table-v1", "entries": {"justonekey": {}}},
    {"schema": "plan-table-v1", "entries": {"cpu:2x1:nonexistent": {}}},
    {"schema": "plan-table-v1",
     "entries": {"cpu:n8:encoder_validator": {"rules": [["", []]],
                                              "axes": ["dp"],
                                              "data_spec": []}}},
    {"schema": "plan-table-v1",
     "entries": {"cpu:n8:encoder_validator": {"mesh_shape": [3, 1]}}},
    {"schema": "plan-table-v1",
     "entries": {"cpu:2x1:encoder_validator": {"mesh_shape": [2, 1]}}},
    {"schema": "plan-table-v1",
     "entries": {"cpu:what:encoder_validator": {}}},
    {"schema": "plan-table-v1",
     "entries": {"cuda:8:encoder_validator": "ENTRY"}},
    {"schema": "plan-table-v1",
     "entries": {"cuda:1x1:encoder_validator": "BAD_BM"}},
    {"schema": "plan-table-v1",
     "entries": {"cuda:1x1:encoder_validator": "BAD_COLL"}},
    "not a table",
)


@pytest.mark.parametrize("table", TABLES, ids=range(len(TABLES)))
def test_validate_plan_table_findings_equal_jax(table):
    if isinstance(table, dict):
        table = json.loads(json.dumps(table))
        for key, ent in table["entries"].items():
            if ent == "ENTRY":
                table["entries"][key] = _entry()
            elif ent == "BAD_BM":
                table["entries"][key] = dict(_entry(), bucket_min=3)
            elif ent == "BAD_COLL":
                table["entries"][key] = dict(_entry(),
                                             collectives=[["gossip", "x"]])
    findings = ps.validate_plan_table(table)
    assert findings and findings == jax_ps.validate_plan_table(table)


def test_shipped_tables_are_gate_clean_in_both_packages():
    for path in (plan.PLAN_TABLE_PATH, jax_plan.PLAN_TABLE_PATH):
        with open(path, encoding="utf-8") as f:
            table = json.load(f)
        assert ps.validate_plan_table(table) == \
            jax_ps.validate_plan_table(table) == []


def test_entry_round_trips_through_the_loader():
    p = ps._candidate_plan("encoder_validator", _megatron(), 2, "sharded")
    ent = ps.entry_from_plan(p, {"rps": 321.0, "candidate": "m"},
                             {"rps": 300.0}, 7)
    assert plan.plan_entry_problems(ent) == []
    back = plan._plan_from_entry("encoder_validator",
                                 "cpu:2x4:encoder_validator", ent)
    assert (back.rules, back.data_spec, back.axes) == \
        (p.rules, p.data_spec, p.axes)
    assert (back.bucket_min, back.gather, back.source) == \
        (2, "sharded", "searched")


def test_to_table_merges_and_writes(tmp_path):
    results = {
        "sweeps": {"cuda:1x1:encoder_validator": {"improved": True,
                                                  "entry": _entry()},
                   "cuda:2x1:encoder_validator": {"improved": False}},
        "factorizations": {"cuda:n2:encoder_validator": {
            "mesh_shape": [2, 1], "rps": 5.0, "source": "s"}}}
    base = {"entries": {"cpu:4x2:encoder_validator": _entry()},
            "provenance": {"note": "kept"}}
    table = ps.to_table(results, base_table=base)
    assert table["entries"] == jax_ps.to_table(results,
                                               base_table=base)["entries"]
    assert "cuda:2x1:encoder_validator" not in table["entries"]
    assert table["provenance"]["note"] == "kept"
    assert ps.validate_plan_table(table) == []
    path = str(tmp_path / "t.json")
    ps.write_table(table, path)
    assert json.loads(open(path).read()) == table


# ── the search loop ──────────────────────────────────────────────────


class _FakeMeasure:
    """measure_candidate stand-in: a record per plan, no serving."""

    def __init__(self, fn):
        self.fn = fn
        self.calls = []

    def __call__(self, family, plan_, mesh_shape, scfg, fixtures,
                 clock=None):
        self.calls.append((family, tuple(mesh_shape), plan_.source,
                           plan_.gather))
        rec = {"family": family, "mesh_shape": list(mesh_shape)}
        rec.update(self.fn(plan_))
        rec["elapsed_s"] = 0.0
        return rec


_SETTINGS = {"families": ("encoder_validator",), "shapes": ((2, 1),),
             "bucketMins": (1, 2), "requests": 3, "device": "cpu"}
_KEY = "cpu:2x1:encoder_validator"


@pytest.fixture
def stub_oracle(monkeypatch):
    monkeypatch.setattr(
        "vainplex_openclaw_tpu_torch.models.serve.make_local_call_llm",
        lambda **_kw: (lambda _text: "ok"))


def _run(fake, monkeypatch, state_path=None, settings=None, **kw):
    monkeypatch.setattr(ps, "measure_candidate", fake)
    return ps.search(dict(_SETTINGS, **(settings or {})),
                     state_path=state_path, **kw)


@pytest.mark.parametrize("cand_rec,improved", [
    ({"rps": 104.0, "mismatches": 0, "retraces": 0}, False),
    ({"rps": 200.0, "mismatches": 1, "retraces": 0}, False),
    ({"rps": 200.0, "mismatches": 0, "retraces": 1}, False),
    ({"rps": 200.0, "mismatches": 0, "retraces": 0}, True)])
def test_gate_rejects_sub_margin_mismatch_and_build(cand_rec, improved,
                                                    monkeypatch,
                                                    stub_oracle):
    fake = _FakeMeasure(lambda p: {"rps": 100.0, "mismatches": 0,
                                   "retraces": 0}
                        if p.source == "handwritten" else dict(cand_rec))
    res = _run(fake, monkeypatch)["sweeps"][_KEY]
    assert res["improved"] is improved
    if improved:
        assert res["entry"]["baseline_rps"] == 100.0
        assert res["entry"]["rps"] == 200.0
    else:
        assert "entry" not in res and res["best"] is res["baseline"]


def test_gate_picks_fastest_clean_winner(monkeypatch, stub_oracle):
    fake = _FakeMeasure(lambda p: {
        "rps": {"handwritten": 100.0}.get(
            p.source, 150.0 if p.bucket_min == 1 else 200.0),
        "mismatches": 0, "retraces": 0})
    res = _run(fake, monkeypatch)["sweeps"][_KEY]
    assert res["improved"] and res["best"]["rps"] == 200.0
    assert res["entry"]["bucket_min"] == 2


def test_error_candidate_is_data_not_fatal(monkeypatch, stub_oracle):
    fake = _FakeMeasure(lambda p: {"rps": 100.0, "mismatches": 0,
                                   "retraces": 0}
                        if p.source == "handwritten" else {"error": "boom"})
    res = _run(fake, monkeypatch)["sweeps"][_KEY]
    assert res["improved"] is False
    assert sum(c.get("error") == "boom" for c in res["candidates"]) == 2
    assert len(res["candidates"]) == 3  # the incumbent, bm1 and bm2


def test_resume_skips_finished_points(monkeypatch, stub_oracle, tmp_path):
    state = str(tmp_path / "state.json")

    def clean(p):
        return {"rps": 100.0, "mismatches": 0, "retraces": 0}

    fake1 = _FakeMeasure(clean)
    r1 = _run(fake1, monkeypatch, state_path=state)
    assert len(fake1.calls) == 4  # a discarded warm-up + 3 candidates
    assert {g for *_, g in fake1.calls} == {"replicated"}
    fake2 = _FakeMeasure(clean)
    r2 = _run(fake2, monkeypatch, state_path=state)
    assert fake2.calls == []
    assert [c["rps"] for c in r2["sweeps"][_KEY]["candidates"]] == \
        [c["rps"] for c in r1["sweeps"][_KEY]["candidates"]]
    assert all(c.get("resumed") for c in r2["sweeps"][_KEY]["candidates"])


def test_error_records_remeasure_on_resume(monkeypatch, stub_oracle,
                                           tmp_path):
    state_path = tmp_path / "state.json"

    def clean(p):
        return {"rps": 100.0, "mismatches": 0, "retraces": 0}

    _run(_FakeMeasure(clean), monkeypatch, state_path=str(state_path))
    state = json.loads(state_path.read_text())
    victim = next(k for k in state if "|bm2|replicated" in k)
    state[victim] = {"family": "encoder_validator", "mesh_shape": [2, 1],
                     "error": "transient"}
    state_path.write_text(json.dumps(state))
    fake = _FakeMeasure(clean)
    r = _run(fake, monkeypatch, state_path=str(state_path))
    assert len(fake.calls) == 2  # the warm-up and the poisoned point
    assert all(c.get("rps") == 100.0
               for c in r["sweeps"][_KEY]["candidates"])


def test_budget_skips_are_partial_not_fatal(monkeypatch, stub_oracle):
    ticks = {"t": 0.0}

    def slow_clock():
        ticks["t"] += 10.0
        return ticks["t"]

    fake = _FakeMeasure(lambda p: {"rps": 100.0, "mismatches": 0,
                                   "retraces": 0})
    res = _run(fake, monkeypatch, settings={"budgetS": 1.0},
               clock=slow_clock)["sweeps"][_KEY]
    assert res["partial"] and res["skipped_candidates"] >= 1
    assert res["baseline"] is not None


@pytest.mark.parametrize("family", ["encoder_validator",
                                    "embeddings_forward"])
def test_the_port_sweeps_only_the_incumbents_gather(family, monkeypatch,
                                                    stub_oracle):
    """A plan's gather changes no output path in the port, so no two
    timed candidates differ only in their gather: each takes the
    incumbent's, and the sweep is JAX's with the other mode left out."""
    fake = _FakeMeasure(lambda p: {"rps": 100.0, "mismatches": 0,
                                   "retraces": 0})
    res = _run(fake, monkeypatch, settings={
        "families": (family,), "bucketMins": (1, 2, 4)})
    incumbent = plan.PLAN_TABLE[family].gather
    assert {g for *_, g in fake.calls} == {incumbent}
    (sweep,) = res["sweeps"].values()
    ids = [c["candidate"] for c in sweep["candidates"][1:]]
    shape = tuple(sweep["mesh_shape"])
    want, _ = jax_ps.enumerate_candidates(family, shape, (1, 2, 4))
    assert ids == [c.cand_id for c in want[1:]
                   if c.cand_id.endswith("|" + incumbent)]


def test_the_same_gate_outcome_as_jax(monkeypatch, stub_oracle):
    """The same fake through both loops: the same sweep and the same
    table rows (factorizations included)."""
    def rec(p):
        return {"rps": {"handwritten": 100.0}.get(
            p.source, 120.0 if p.bucket_min == 2 else 101.0),
            "mismatches": 0, "retraces": 0}

    settings = {"families": ("encoder_validator",),
                "shapes": ((2, 1), (1, 2)), "bucketMins": (1, 2),
                "requests": 3}
    monkeypatch.setattr(
        "vainplex_openclaw_tpu.models.serve.make_local_call_llm",
        lambda **_kw: (lambda _text: "ok"))
    got = _run(_FakeMeasure(rec), monkeypatch,
               settings=dict(settings, device="cpu"))
    monkeypatch.setattr(jax_ps, "measure_candidate", _FakeMeasure(rec))
    want = jax_ps.search(settings)
    assert got["sweeps"].keys() == want["sweeps"].keys()
    for key, res in got["sweeps"].items():
        assert res["improved"] == want["sweeps"][key]["improved"]
        assert res.get("entry") == want["sweeps"][key].get("entry")
    assert got["factorizations"] == want["factorizations"]
    assert ps.to_table(got)["entries"] == jax_ps.to_table(want)["entries"]


def test_a_real_search_on_the_cpu_grid():
    """Both families through the port batcher and embeddings backend at
    (1, 1) and (2, 1): every candidate holds the oracle, builds nothing
    and launches no kernel (the plain version runs on the CPU)."""
    res = ps.search({"device": "cpu", "shapes": ((1, 1), (2, 1)),
                     "requests": 6, "concurrency": 3, "bucketMins": (1,),
                     "facts": 10, "queries": 3})
    assert set(res["sweeps"]) == {
        "cpu:1x1:encoder_validator", "cpu:2x1:encoder_validator",
        "cpu:1:embeddings_forward", "cpu:2:embeddings_forward"}
    for key, sweep in res["sweeps"].items():
        assert sweep["sketch_rejected"] == (1 if "embeddings" in key else 0)
        for c in sweep["candidates"]:
            assert "error" not in c, (key, c)
            assert c["mismatches"] == 0 and c["retraces"] == 0, (key, c)
            assert c["k1_launches"] == c["k1_expected"] == 0
    assert ps.validate_plan_table(ps.to_table(res, base_table={
        "entries": {"cpu:n8:encoder_validator": {"mesh_shape": [8, 1]}}})) \
        == []


@pytest.mark.parametrize("family,axes,shape,want", [
    ("encoder_validator", ("dp", "tp"), (2, 2), ("k1", 2 * 2 * 2)),
    ("encoder_validator", ("dp", "tp"), (1, 8), ("k1", 2 * 1 * 4)),
    ("encoder_validator", ("dp", "tp"), (3, 1), ("k1", 2 * 3)),
    ("embeddings_forward", ("dp",), (4,), ("k1", 2 * 4)),
    ("encoder_validator_moe", ("dp", "ep"), (2, 2), ("k1", 2 * 2)),
    ("encoder_validator_pp", ("pp",), (2,), ("k1", 2 * 4)),
    ("encoder_validator_long", ("dp", "sp"), (2, 4), ("k2", 2 * 2 * 16)),
])
def test_launches_per_forward_hand_counts(family, axes, shape, want):
    """The mesh phases' formulas at n_layers = 2, n_heads = 4."""
    from vainplex_openclaw_tpu_torch.models.encoder import EncoderConfig

    cfg = EncoderConfig(vocab_size=64, seq_len=16, d_model=32, n_heads=4,
                        n_layers=2, d_ff=64)
    mesh = cached_mesh(shape, axes, "cpu")
    assert ps.launches_per_forward(plan.PLAN_TABLE[family], mesh, cfg) == \
        want
    rep = ps._candidate_plan("encoder_validator", _all_rep(), 1,
                             "replicated")
    assert ps.launches_per_forward(
        rep, cached_mesh((2, 2), ("dp", "tp"), "cpu"), cfg) == ("k1", 4)
