"""The port's searched plan table against the JAX package's.

``vainplex_openclaw_tpu_torch/parallel/plan.py`` resolves every mesh
family override > searched table > hand-written, as the JAX package does,
through its own ``parallel/plan_table.json``, whose ``cpu:`` rows are
JAX's copied verbatim. On the CPU the two packages must then resolve the
same plan (key, source, rules, ``bucket_min``, gather, runner) and the
same auto grid shape, warn and fall back alike on malformed and stale
tables, obey ``searchedPlans: false`` and ``OPENCLAW_SEARCHED_PLANS=0``
alike, and serve the JAX oracle's verdicts with the table active at
(1, 1), (2, 1), (2, 4) and (3, 2) (the twin of JAX's
``TestSearchedPlanParity``). Tolerances: tables, keys and plans
bit-equal; verdicts identical.
"""

from __future__ import annotations

import hashlib
import json
import warnings

import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from test_serve_batching import seeded_texts, serve_all
from vainplex_openclaw_tpu.governance.validation.llm_validator import (
    build_prompt)
from vainplex_openclaw_tpu.models import serve as jax_serve
from vainplex_openclaw_tpu.parallel import plan as jax_plan
from vainplex_openclaw_tpu.parallel.mesh import cached_mesh as jax_mesh
from vainplex_openclaw_tpu_torch.models import batching, serve
from vainplex_openclaw_tpu_torch.parallel import plan, plan_search as ps
from vainplex_openclaw_tpu_torch.parallel.mesh import cached_mesh


def both_meshes(shape, axes):
    return cached_mesh(tuple(shape), tuple(axes), "cpu"), \
        jax_mesh(tuple(shape), tuple(axes))


def same_plan(got, want):
    assert got.family == want.family
    assert got.rules == tuple((pat, tuple(spec)) for pat, spec in want.rules)
    assert got.data_spec == tuple(want.data_spec)
    for name in ("axes", "bucket_min", "gather", "source", "table_key",
                 "runner", "microbatches", "description"):
        assert getattr(got, name) == getattr(want, name), name


@pytest.fixture
def clear_tables():
    plan.clear_plan_table_cache()
    jax_plan.clear_plan_table_cache()
    yield
    plan.clear_plan_table_cache()
    jax_plan.clear_plan_table_cache()


@pytest.fixture
def isolated_table(monkeypatch, tmp_path, clear_tables):
    """OPENCLAW_PLAN_TABLE (one name for both packages) at a scratch
    file."""
    path = tmp_path / "plan_table.json"
    monkeypatch.setenv(plan.PLAN_TABLE_ENV, str(path))
    return path


def write_table(path, entries):
    path.write_text(json.dumps({"schema": plan.PLAN_TABLE_SCHEMA,
                                "entries": entries}))
    plan.clear_plan_table_cache()
    jax_plan.clear_plan_table_cache()


def entry(bucket_min=1, gather="replicated"):
    p = ps._candidate_plan("encoder_validator",
                           tuple((s, "rep") for s, _, _ in ps._ENCODER_SITES),
                           bucket_min, gather)
    return ps.entry_from_plan(p, {"rps": 200.0, "candidate": "allrep"},
                              {"rps": 100.0}, 0)


def shipped(path):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def shape_keys():
    for key in shipped(jax_plan.PLAN_TABLE_PATH)["entries"]:
        dev, shape_s, family = key.split(":")
        if not shape_s.startswith("n"):
            yield key


# ── the table and its constants ──────────────────────────────────────


def test_constants_equal_jax():
    for name in ("PLAN_TABLE_SCHEMA", "PLAN_TABLE_ENV", "SEARCHED_PLANS_ENV",
                 "GATHER_MODES", "COLLECTIVE_KINDS", "RUNNERS"):
        assert getattr(plan, name) == getattr(jax_plan, name), name
    assert plan.PLAN_TABLE_PATH != jax_plan.PLAN_TABLE_PATH
    assert plan.PLAN_TABLE_PATH.endswith(
        "vainplex_openclaw_tpu_torch/parallel/plan_table.json")


def test_copied_cpu_rows_equal_jax():
    port, ref = shipped(plan.PLAN_TABLE_PATH), \
        shipped(jax_plan.PLAN_TABLE_PATH)
    cpu = {k: v for k, v in port["entries"].items() if k.startswith("cpu:")}
    assert cpu == ref["entries"]
    assert "copied verbatim" in port["provenance"]["cpu_rows"]
    assert port["schema"] == ref["schema"]


def test_cuda_rows_come_from_a_one_card_run():
    """Only the H100's own rows: (1, 1) and (1,), never a grid that
    repeats the card."""
    port = shipped(plan.PLAN_TABLE_PATH)
    cuda = [k for k in port["entries"] if k.startswith("cuda:")]
    for key in cuda:
        assert key.split(":")[1] in ("1x1", "1"), key
    prov = port["provenance"]
    if cuda:
        assert "H100" in prov["cuda_rows"] and "W" in prov["cuda_rows"]


# ── resolution on the shipped table, against JAX ─────────────────────


@pytest.mark.parametrize("key", list(shape_keys()))
def test_shipped_rows_resolve_as_jax(key, clear_tables):
    _dev, shape_s, family = key.split(":")
    shape = tuple(int(x) for x in shape_s.split("x"))
    if int(np.prod(shape)) > 8:
        pytest.skip("more than the 8 CPU grid entries")
    axes = tuple(shipped(jax_plan.PLAN_TABLE_PATH)["entries"][key]["axes"])
    mesh, jmesh = both_meshes(shape, axes)
    got = plan.serving_plan(family, mesh)
    same_plan(got, jax_plan.serving_plan(family, jmesh))
    assert got.source == "searched" and got.table_key == key
    assert plan.searched_plan(family, mesh) == got
    same_plan(plan.serving_plan(family, mesh, searched=False),
              jax_plan.serving_plan(family, jmesh, searched=False))
    prov, jprov = plan.plan_provenance(family, mesh), \
        jax_plan.plan_provenance(family, jmesh)
    assert (prov["plan_table_key"], prov["plan_source"]) == \
        (jprov["plan_table_key"], jprov["plan_source"]) == (key, "searched")
    with open(plan.PLAN_TABLE_PATH, "rb") as f:
        assert prov["plan_table_hash"] == \
            hashlib.sha256(f.read()).hexdigest()[:12]


@pytest.mark.parametrize("shape", [(1, 8), (1, 2), (8,)])
def test_rows_the_table_lacks_serve_hand_written_as_jax(shape, clear_tables):
    family, axes = ("encoder_validator", ("dp", "tp")) if len(shape) == 2 \
        else ("encoder_validator_pp", ("pp",))
    mesh, jmesh = both_meshes(shape, axes)
    same_plan(plan.serving_plan(family, mesh),
              jax_plan.serving_plan(family, jmesh))
    assert plan.serving_plan(family, mesh).source == "handwritten"


@pytest.mark.parametrize("n", range(1, 9))
def test_preferred_mesh_shape_equals_jax(n, clear_tables):
    assert plan.preferred_mesh_shape(n, device="cpu") == \
        jax_plan.preferred_mesh_shape(n)
    assert plan.preferred_mesh_shape(8, device="cpu") == (8, 1)


def test_plan_override_wins_and_restores(clear_tables):
    mesh, jmesh = both_meshes((2, 1), ("dp", "tp"))
    probe = plan.ShardingPlan(family="encoder_validator", rules=(("", ()),),
                              data_spec=("dp",), axes=("dp",),
                              source="override-probe")
    jprobe = jax_plan.ShardingPlan(family="encoder_validator",
                                   rules=(("", P()),), data_spec=P("dp"),
                                   axes=("dp",), source="override-probe")
    with plan.plan_override("encoder_validator", probe), \
            jax_plan.plan_override("encoder_validator", jprobe):
        assert plan.serving_plan("encoder_validator", mesh) is probe
        assert plan.resolve_plan("encoder_validator", mesh) is probe
        same_plan(plan.serving_plan("encoder_validator", mesh),
                  jax_plan.serving_plan("encoder_validator", jmesh))
    same_plan(plan.serving_plan("encoder_validator", mesh),
              jax_plan.serving_plan("encoder_validator", jmesh))
    assert plan.resolve_plan("encoder_validator").source == "handwritten"


def test_the_auto_grid_is_jax_shape_on_eight_cpus(clear_tables):
    for axes, family in ((["dp", "tp"], "encoder_validator"),
                         (["dp", "sp"], "encoder_validator_long"),
                         (["dp"], "embeddings_forward")):
        cfg = dict(serve.SERVE_DEFAULTS, meshServing=True, meshAxes=axes,
                   planFamily=family)
        got = serve._resolve_mesh(cfg, serve.resolve_device("cpu"))
        want = jax_serve._resolve_mesh({**jax_serve.SERVE_DEFAULTS, **cfg})
        assert got.shape == dict(want.shape)
    assert got.shape == {"dp": 8}


# ── escape hatches and loud fallbacks ────────────────────────────────


def test_searched_plans_false_and_the_process_switch(monkeypatch,
                                                     clear_tables):
    mesh = cached_mesh((2, 4), ("dp", "tp"), "cpu")
    base = dict(serve.SERVE_DEFAULTS, meshServing=True)
    dev = serve.resolve_device("cpu")
    assert serve._resolve_mesh(base, dev).shape == {"dp": 8, "tp": 1}
    off = dict(base, searchedPlans=False)
    assert serve._resolve_mesh(off, dev).shape == {"dp": 2, "tp": 4}
    assert dict(jax_serve._resolve_mesh(
        {**jax_serve.SERVE_DEFAULTS, **off}).shape) == {"dp": 2, "tp": 4}
    b = batching.ContinuousBatcher(autostart=False, device="cpu", mesh=mesh,
                                   searched_plans=False)
    assert plan.resolve_plan(b.plan_family, mesh,
                             searched=b.searched_plans).source == \
        "handwritten"
    b.close()
    assert plan.serving_plan("encoder_validator", mesh).source == "searched"
    monkeypatch.setenv(plan.SEARCHED_PLANS_ENV, "0")
    assert not plan.searched_plans_enabled()
    for searched in (None, True):
        assert plan.serving_plan("encoder_validator", mesh,
                                 searched).source == "handwritten"
    assert serve._resolve_mesh(base, dev).shape == {"dp": 2, "tp": 4}


def test_missing_table_serves_hand_written(isolated_table):
    mesh, jmesh = both_meshes((2, 1), ("dp", "tp"))
    assert plan.load_plan_table() == jax_plan.load_plan_table() == {}
    assert plan.plan_table_hash() is None
    same_plan(plan.serving_plan("encoder_validator", mesh),
              jax_plan.serving_plan("encoder_validator", jmesh))


def test_env_table_is_read_once_until_cleared(isolated_table):
    mesh = cached_mesh((2, 1), ("dp", "tp"), "cpu")
    key = plan.plan_table_key(mesh, "encoder_validator")
    assert key == jax_plan.plan_table_key(jax_mesh((2, 1), ("dp", "tp")),
                                          "encoder_validator")
    write_table(isolated_table, {key: entry()})
    assert plan.load_plan_table()["_path"] == str(isolated_table)
    first = plan.plan_table_hash()
    assert first == jax_plan.plan_table_hash()
    assert plan.serving_plan("encoder_validator", mesh).table_key == key
    isolated_table.write_text(json.dumps({"schema": plan.PLAN_TABLE_SCHEMA,
                                          "entries": {key: entry(2)}}))
    assert plan.plan_table_hash() == first
    plan.clear_plan_table_cache()
    assert plan.plan_table_hash() != first
    assert plan.serving_plan("encoder_validator", mesh).bucket_min == 2


def test_unreadable_table_warns_and_falls_back(isolated_table):
    isolated_table.write_text("{not json at all")
    with pytest.warns(RuntimeWarning, match="unreadable"):
        assert plan.load_plan_table() == {}
    with pytest.warns(RuntimeWarning, match="unreadable"):
        assert jax_plan.load_plan_table() == {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        assert plan.serving_plan(
            "encoder_validator",
            cached_mesh((2, 1), ("dp", "tp"), "cpu")).source == "handwritten"


def test_wrong_schema_warns_and_falls_back(isolated_table):
    isolated_table.write_text(json.dumps({"schema": "plan-table-v0",
                                          "entries": {}}))
    with pytest.warns(RuntimeWarning, match="hand-written rules"):
        assert plan.load_plan_table() == {}
    with pytest.warns(RuntimeWarning, match="hand-written rules"):
        assert jax_plan.load_plan_table() == {}


@pytest.mark.parametrize("bad", ["malformed", "stale_axes"])
def test_unusable_row_warns_and_falls_back_as_jax(bad, isolated_table):
    mesh, jmesh = both_meshes((2, 1), ("dp", "tp"))
    key = plan.plan_table_key(mesh, "encoder_validator")
    ent = {"rules": []} if bad == "malformed" else \
        dict(entry(), axes=["dp", "tp", "pp"])
    write_table(isolated_table, {key: ent})
    with pytest.warns(RuntimeWarning, match="unusable") as got:
        p = plan.serving_plan("encoder_validator", mesh)
    with pytest.warns(RuntimeWarning, match="unusable") as want:
        jp = jax_plan.serving_plan("encoder_validator", jmesh)
    assert p.source == jp.source == "handwritten"
    assert str(got[0].message) == str(want[0].message)


def test_stale_factorization_warns_as_jax(isolated_table):
    write_table(isolated_table, {"cpu:n8:encoder_validator":
                                 {"mesh_shape": [2, 2], "rps": 1.0}})
    with pytest.warns(RuntimeWarning, match="default factorization") as got:
        assert plan.preferred_mesh_shape(8, device="cpu") is None
    with pytest.warns(RuntimeWarning, match="default factorization") as want:
        assert jax_plan.preferred_mesh_shape(8) is None
    assert str(got[0].message) == str(want[0].message)
    assert plan.preferred_mesh_shape(4, device="cpu") is None


def test_cuda_rows_never_drive_a_cpu_grid(isolated_table):
    write_table(isolated_table, {"cuda:2x1:encoder_validator": entry(4),
                                 "cuda:n8:encoder_validator":
                                     {"mesh_shape": [2, 4]}})
    mesh = cached_mesh((2, 1), ("dp", "tp"), "cpu")
    assert plan.serving_plan("encoder_validator", mesh).source == \
        "handwritten"
    assert plan.preferred_mesh_shape(8, device="cpu") is None
    assert plan.preferred_mesh_shape(8, device="cuda") == (2, 4)


# ── the consumers ────────────────────────────────────────────────────


def test_restore_places_by_the_plan_jax_restores_with(tmp_path,
                                                      clear_tables):
    """A family name resolves through serving_plan without the mesh (the
    hand-written plan, or an active override), as JAX's restore does."""
    import torch

    from vainplex_openclaw_tpu_torch.models import checkpoint as ckpt
    from vainplex_openclaw_tpu_torch.models.pretrained import (
        load_pretrained)

    cfg, params = load_pretrained(device="cpu")
    host = {k: v for k, v in params.items()}
    ckpt.save_checkpoint(str(tmp_path), host, step=1)
    mesh = cached_mesh((2, 4), ("dp", "tp"), "cpu")
    placed = ckpt.restore_checkpoint(str(tmp_path), like=host, mesh=mesh,
                                     plan="encoder_validator")
    assert placed.plan is plan.PLAN_TABLE["encoder_validator"]
    searched = plan.serving_plan("encoder_validator", mesh)
    with plan.plan_override("encoder_validator", searched):
        placed = ckpt.restore_checkpoint(str(tmp_path), like=host,
                                         mesh=mesh, plan="encoder_validator")
    assert placed.plan is searched
    gathered = placed.gather()
    assert torch.equal(gathered["embed"]["tok"], host["embed"]["tok"])


@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_embeddings_bucket_is_the_searched_bucket_as_jax(n, clear_tables):
    for dp in (1, 2):
        mesh, jmesh = both_meshes((dp,), ("dp",))
        assert plan.serve_bucket(n, mesh, plan="embeddings_forward") == \
            jax_plan.serve_bucket(n, jmesh, plan="embeddings_forward")
        assert plan.resolve_plan("embeddings_forward", mesh).source == \
            "searched"


class TestSearchedPlanParity:
    """Verdicts with the shipped table active, where every shape below
    resolves a searched row, equal to the JAX one-shot oracle's."""

    @pytest.mark.parametrize("shape", ((1, 1), (2, 1), (2, 4), (3, 2)))
    def test_verdict_parity(self, shape, clear_tables):
        call = jax_serve.make_local_call_llm(
            serve_cfg={"continuousBatching": False}, force=True)
        texts = seeded_texts(9, seed=sum(shape) + 40)
        ref = [call(build_prompt(t, [])) for t in texts]
        mesh = cached_mesh(shape, ("dp", "tp"), "cpu")
        resolved = plan.serving_plan("encoder_validator", mesh)
        assert resolved.source == "searched"
        b = batching.ContinuousBatcher(max_batch=4, window_ms=0.0,
                                       autostart=False, device="cpu",
                                       mesh=mesh)
        try:
            assert serve_all(b, texts) == ref
        finally:
            b.close()
