"""The port's mesh-serving plans and the dp×tp validator against JAX.

The port places each family's weights per its rule table, keyed by grid
position (``parallel.plan.Placement``), and its ``forward`` runner writes
out what GSPMD derives (``parallel/sharded_forward.py``). Each is held
against the JAX package's mesh path over the conftest's 8 virtual CPU
devices, the port's grid repeating ``cpu``, on JAX's ``init_params``
weights carried across and token batches from a numpy seed:

- ``serve_forward`` of ``encoder_validator`` at dp×tp in {1x1, 2x1, 1x2,
  2x2, 1x4, 1x8} (1x8 cuts each of the 4 heads over two columns; JAX's
  GSPMD computes the unsplit answer there, and so does the port, by
  gathering a head's columns first): fp32 within 1e-5 of JAX and of the
  single-device forward, bf16 with the severity argmax equal and logits
  within 5e-2;
- ``embeddings_forward`` over dp and ``arena_scores`` at dp in {1, 2, 4,
  8}; the rule tables, the rule-table check (the port's
  ``analysis.sharding.validate_rule_table``, which the plans arm, against
  JAX's), rule matching and ``restore_checkpoint`` onto
  every plan, gathered back bit for bit;
- verdict strings through ``make_local_call_llm`` on the dp×tp family equal
  JAX's mesh serve on the same checkpoint, and through the real gateway
  with the port's ``call_llm`` injected for the default ``meshServing``
  config;
- placement keyed by grid position: a grid that repeats one device holds
  as many distinct shards as it has positions.

The pipeline and expert-parallel families have their own files
(``test_torch_pipeline.py``, ``test_torch_expert_parallel.py``).
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from helpers import make_gateway
from test_serve_batching import seeded_texts
from vainplex_openclaw_tpu.analysis import sharding as jax_sharding
from vainplex_openclaw_tpu.governance.validation.llm_validator import (
    build_prompt)
from vainplex_openclaw_tpu.models import EncoderConfig as JaxConfig
from vainplex_openclaw_tpu.models import checkpoint as jax_ckpt
from vainplex_openclaw_tpu.models import init_params as jax_init_params
from vainplex_openclaw_tpu.models import serve as jax_serve
from vainplex_openclaw_tpu.models.data import synthetic_examples
from vainplex_openclaw_tpu.parallel import plan as jax_plan
from vainplex_openclaw_tpu.parallel.mesh import make_mesh as jax_make_mesh
from vainplex_openclaw_tpu.parallel.pipeline import (
    stack_stage_params as jax_stack)
from vainplex_openclaw_tpu_torch.analysis import sharding as port_sharding
from vainplex_openclaw_tpu_torch.models import batching, serve
from vainplex_openclaw_tpu_torch.models import checkpoint as port_ckpt
from vainplex_openclaw_tpu_torch.models.encoder import (
    EncoderConfig, flatten_tree, forward, params_from_numpy)
from vainplex_openclaw_tpu_torch.parallel import plan
from vainplex_openclaw_tpu_torch.parallel import sharded_forward
from vainplex_openclaw_tpu_torch.parallel.mesh import cached_mesh, make_mesh

HEADS = ("severity", "keep", "mood", "embedding")
TP_SHAPES = [(1, 1), (2, 1), (1, 2), (2, 2), (1, 4), (1, 8)]
SHAPE_IDS = ["x".join(map(str, s)) for s in TP_SHAPES]


def jax_cfg(dtype: str, **over) -> JaxConfig:
    """The JAX suite's small serving model (4 heads of 16)."""
    base = dict(vocab_size=512, seq_len=32, d_model=64, n_heads=4,
                n_layers=2, d_ff=128, attn_impl="flash",
                dtype=jnp.float32 if dtype == "float32" else jnp.bfloat16)
    base.update(over)
    return JaxConfig(**base)


def port_cfg(jcfg: JaxConfig) -> EncoderConfig:
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(EncoderConfig)}
    fields["dtype"] = jnp.dtype(jcfg.dtype).name
    return EncoderConfig(**fields)


_weights: dict = {}


def weights(dtype: str, **over):
    """(jax cfg, jax tree, port cfg, port tree on the CPU), memoized."""
    key = (dtype, tuple(sorted(over.items())))
    if key not in _weights:
        jcfg = jax_cfg(dtype, **over)
        jp = jax_init_params(jax.random.PRNGKey(0), jcfg)
        cfg = port_cfg(jcfg)
        _weights[key] = (jcfg, jp, cfg, params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jp), cfg, "cpu", cast=True))
    return _weights[key]


def tokens(B: int, L: int, seed: int = 0) -> np.ndarray:
    """Ragged rows (the last one fully padded) of ids in [2, 512)."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, L + 1, size=B)
    lengths[0], lengths[-1] = L, 0
    tok = rng.integers(2, 512, size=(B, L))
    tok[:, 0] = 1
    tok[np.arange(L)[None, :] >= lengths[:, None]] = 0
    return tok.astype(np.int32)


def as_numpy(out: dict) -> dict:
    return {h: (out[h].float().numpy() if isinstance(out[h], torch.Tensor)
                else np.asarray(out[h], np.float32)) for h in HEADS}


def max_err(a: dict, b: dict) -> float:
    return max(float(np.abs(a[h] - b[h]).max()) for h in HEADS)


def port_mesh_forward(params, tok, cfg, family, axes, shape):
    mesh = make_mesh(axes=axes, shape=shape, device="cpu")
    with torch.inference_mode():
        return plan.serve_forward(plan.place_params(params, mesh, family),
                                  plan.place_tokens(tok, mesh, family),
                                  cfg, mesh, family)


def jax_mesh_forward(jp, tok, jcfg, family, axes, shape):
    mesh = jax_make_mesh(math.prod(shape), axes=axes, shape=shape)
    fam = jax_plan.PLAN_TABLE[family]
    placed = jax_plan.sharded_params(("test", family, shape, str(jcfg)), jp,
                                     mesh, fam)
    return jax_plan.serve_forward(placed, jax_plan.place_tokens(tok, mesh, fam),
                                  jcfg, mesh, fam)


# ── the dp×tp forward ────────────────────────────────────────────────────

@pytest.mark.parametrize("shape", TP_SHAPES, ids=SHAPE_IDS)
def test_encoder_validator_fp32_matches_jax_and_dense(shape):
    jcfg, jp, cfg, params = weights("float32")
    tok = tokens(8, 32, seed=1)
    got = as_numpy(port_mesh_forward(params, tok, cfg, "encoder_validator",
                                     ("dp", "tp"), shape))
    want = as_numpy(jax_mesh_forward(jp, jnp.asarray(tok), jcfg,
                                     "encoder_validator", ("dp", "tp"), shape))
    with torch.inference_mode():
        dense = as_numpy(forward(params, torch.from_numpy(tok), cfg))
    assert all(np.isfinite(got[h]).all() for h in HEADS)
    assert max_err(got, want) <= 1e-5
    assert max_err(got, dense) <= 1e-5


@pytest.mark.parametrize("shape", TP_SHAPES, ids=SHAPE_IDS)
def test_encoder_validator_bf16_argmax_and_logits(shape):
    jcfg, jp, cfg, params = weights("bfloat16")
    tok = tokens(8, 32, seed=2)
    got = as_numpy(port_mesh_forward(params, tok, cfg, "encoder_validator",
                                     ("dp", "tp"), shape))
    want = as_numpy(jax_mesh_forward(jp, jnp.asarray(tok), jcfg,
                                     "encoder_validator", ("dp", "tp"), shape))
    assert (got["severity"].argmax(-1) == want["severity"].argmax(-1)).all()
    assert max_err(got, want) <= 5e-2


@pytest.mark.parametrize("shape,per_layer", [
    ((1, 1), 1), ((2, 1), 2), ((1, 2), 2), ((2, 2), 4), ((1, 4), 4),
    ((1, 8), 4)], ids=SHAPE_IDS)
def test_attention_runs_once_per_shard(shape, per_layer, monkeypatch):
    """``attend`` (K1 on the card) once per layer, dp row and column that
    holds whole heads: dp × min(tp, heads) a layer."""
    _, _, cfg, params = weights("float32")
    calls = []
    real = sharded_forward.attend

    def spy(q, *a, **kw):
        calls.append(q.shape[1])
        return real(q, *a, **kw)

    monkeypatch.setattr(sharded_forward, "attend", spy)
    monkeypatch.setattr("vainplex_openclaw_tpu_torch.models.encoder.attend",
                        spy)
    port_mesh_forward(params, tokens(8, 32), cfg, "encoder_validator",
                      ("dp", "tp"), shape)
    assert len(calls) == cfg.n_layers * per_layer
    assert set(calls) == {cfg.n_heads // min(shape[1], cfg.n_heads)}


def test_dropping_one_attn_o_partial_is_visible(monkeypatch):
    """The negative control the card runs: the attn/o psum replaced by one
    column's partial product moves the fp32 logits far past 1e-5."""
    _, _, cfg, params = weights("float32")
    tok = tokens(8, 32, seed=3)
    good = as_numpy(port_mesh_forward(params, tok, cfg, "encoder_validator",
                                      ("dp", "tp"), (2, 2)))
    real = sharded_forward.psum

    def drop(parts, device, site):
        return parts[0].to(device) if site == "attn/o" else \
            real(parts, device, site)

    monkeypatch.setattr(sharded_forward, "psum", drop)
    bad = as_numpy(port_mesh_forward(params, tok, cfg, "encoder_validator",
                                     ("dp", "tp"), (2, 2)))
    assert max_err(good, bad) > 1e-3


def test_repeated_device_grid_holds_distinct_shards():
    """Placement is keyed by grid position: tp=2 over one repeated device
    holds two different column blocks of ``attn/q``, each with the shape
    a card of its own would hold, and serves the unsplit answer."""
    _, _, cfg, params = weights("float32")
    mesh = make_mesh(axes=("dp", "tp"), shape=(1, 2), devices=["cpu"] * 2)
    placed = plan.place_params(params, mesh, "encoder_validator")
    q = [t["blocks"][0]["attn"]["q"] for t in placed.trees[0]]
    assert [tuple(x.shape) for x in q] == [(64, 32)] * 2
    assert not torch.equal(q[0], q[1])
    torch.testing.assert_close(torch.cat(q, dim=1),
                               params["blocks"][0]["attn"]["q"], rtol=0,
                               atol=0)
    tok = tokens(4, 32, seed=4)
    with torch.inference_mode():
        got = plan.serve_forward(placed,
                                 plan.place_tokens(tok, mesh,
                                                   "encoder_validator"),
                                 cfg, mesh, "encoder_validator")
        want = forward(params, torch.from_numpy(tok), cfg)
    assert max_err(as_numpy(got), as_numpy(want)) <= 1e-5


def test_placement_refuses_a_split_that_does_not_divide():
    _, _, cfg, params = weights("float32")
    mesh = make_mesh(axes=("dp", "tp"), shape=(1, 3), device="cpu")
    with pytest.raises(ValueError, match="does not split over tp=3"):
        plan.place_params(params, mesh, "encoder_validator")


# ── the data-parallel embeddings family and the arena ────────────────────

@pytest.mark.parametrize("dp", [1, 2, 4, 8])
def test_embeddings_forward_matches_jax(dp):
    jcfg, jp, cfg, params = weights("float32")
    tok = tokens(8, 32, seed=5)
    got = as_numpy(port_mesh_forward(params, tok, cfg, "embeddings_forward",
                                     ("dp",), (dp,)))
    want = as_numpy(jax_mesh_forward(jp, jnp.asarray(tok), jcfg,
                                     "embeddings_forward", ("dp",), (dp,)))
    assert max_err(got, want) <= 1e-5


@pytest.mark.parametrize("dp", [1, 2, 4, 8])
def test_arena_scores_match_jax(dp):
    rng = np.random.default_rng(dp)
    size, dim = 37, 24
    rows = -(-size // dp) * dp
    arena = np.zeros((rows, dim), np.float32)
    arena[:size] = rng.standard_normal((size, dim))
    q = rng.standard_normal(dim).astype(np.float32)
    mesh = make_mesh(axes=("dp",), shape=(dp,), device="cpu")
    placed = plan.place_rows(arena, mesh)
    assert [tuple(c.shape) for c in placed] == [(rows // dp, dim)] * dp
    got = plan.arena_scores(placed, torch.from_numpy(q), mesh).numpy()
    jmesh = jax_make_mesh(dp, axes=("dp",), shape=(dp,))
    want = np.asarray(jax_plan.arena_scores(
        jax.device_put(arena, jax.sharding.NamedSharding(
            jmesh, jax.sharding.PartitionSpec("dp", None))), q, jmesh))
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got[:size], arena[:size] @ q, atol=1e-5)
    assert (got[size:] == 0).all()
    np.testing.assert_array_equal(
        plan.arena_scores(torch.from_numpy(arena), q, mesh).numpy(), got)


# ── rule tables, matching and the armed check ────────────────────────────

def test_plan_table_equals_jax():
    assert set(plan.PLAN_TABLE) == set(jax_plan.PLAN_TABLE)
    assert plan.RUNNERS == jax_plan.RUNNERS
    for family, want in jax_plan.PLAN_TABLE.items():
        got = plan.resolve_plan(family)
        assert got.rules == tuple((pat, tuple(spec))
                                  for pat, spec in want.rules), family
        assert got.data_spec == tuple(want.data_spec)
        assert (got.axes, got.runner, got.microbatches, got.bucket_min,
                got.gather) == (want.axes, want.runner, want.microbatches,
                                want.bucket_min, want.gather)
    for name in ("ENCODER_VALIDATOR_RULES", "EMBEDDINGS_FORWARD_RULES",
                 "ENCODER_VALIDATOR_PP_RULES", "ENCODER_VALIDATOR_LONG_RULES",
                 "MOE_EP_RULES"):
        assert getattr(plan, name) == tuple(
            (pat, tuple(spec)) for pat, spec in getattr(jax_plan, name))


def path_sets():
    """(name, port tree, JAX tree) for the dense, MoE and stacked trees."""
    out = []
    for name, over in (("dense", {}), ("moe", {"n_experts": 4})):
        _, jp, _, params = weights("float32", **over)
        out.append((name, params, jp))
        out.append((name + "_stacked",
                    {**params, "blocks": plan.prepare_params(
                        plan.PLAN_TABLE["encoder_validator_pp"], params,
                        make_mesh(axes=("pp",), shape=(2,),
                                  device="cpu"))["blocks"]},
                    {**jp, "blocks": jax_stack(jp["blocks"], 2)}))
    return out


def flat_specs(tree) -> dict:
    out: dict = {}
    plan.map_tree(lambda key, spec: out.__setitem__(key, spec), tree)
    return out


def test_param_path_keys_equal_jax():
    for name, params, jp in path_sets():
        assert plan.param_path_keys(params) == \
            jax_plan.param_path_keys(jp), name


BAD_TABLES = [
    (("attn/q$", ()), ("nope$", ()), ("", ())),          # a dead rule
    (("", ()), ("attn/q$", (None, "tp"))),               # shadowed
    (("blocks/", ("pp",)), ("blocks/0/", ()), ("", ())),  # shadowed prefix
]


@pytest.mark.parametrize("table", [p.rules for p in plan.PLAN_TABLE.values()]
                         + BAD_TABLES)
def test_validate_rule_table_copy_equals_jax(table):
    for name, params, _ in path_sets():
        paths = plan.param_path_keys(params)
        for regex in (True, False):
            assert port_sharding.validate_rule_table(
                table, paths, regex=regex) == \
                jax_sharding.validate_rule_table(table, paths, regex=regex), \
                (name, regex)


@pytest.mark.parametrize("family", sorted(plan.PLAN_TABLE))
def test_match_partition_rules_equals_jax(family):
    p = plan.PLAN_TABLE[family]
    moe = "moe" in family
    for name, params, jp in path_sets():
        if ("moe" in name) != moe or ("stacked" in name) != (
                p.runner == "pipeline"):
            continue
        got = flat_specs(plan.match_partition_rules(p.rules, params))
        jspecs = jax_plan.match_partition_rules(
            jax_plan.PLAN_TABLE[family].rules, jp)
        want = {jax_ckpt._path_key(path): tuple(spec) for path, spec in
                jax.tree_util.tree_flatten_with_path(
                    jspecs, is_leaf=lambda x: isinstance(
                        x, jax.sharding.PartitionSpec))[0]}
        assert got == want, name


def test_unmatched_leaf_raises():
    with pytest.raises(ValueError, match="no partition rule matches"):
        plan.match_partition_rules((("attn/", ()),),
                                   {"embed": {"tok": torch.zeros(4, 4)}})
    # scalars and one-element leaves never partition
    assert plan.match_partition_rules(
        (("x", ("tp",)),), {"x": torch.zeros(1), "y": [torch.zeros(())]}) \
        == {"x": (), "y": [()]}


def test_mesh_missing_an_axis_raises():
    _, _, _, params = weights("float32")
    with pytest.raises(ValueError, match="needs mesh axes"):
        plan.plan_shardings(plan.PLAN_TABLE["encoder_validator"], params,
                            make_mesh(axes=("dp", "sp"), shape=(2, 4),
                                      device="cpu"))


# ── restore onto a mesh ──────────────────────────────────────────────────

RESTORE_CASES = [
    ("encoder_validator", ("dp", "tp"), (2, 4), {}),
    ("embeddings_forward", ("dp",), (4,), {}),
    ("encoder_validator_pp", ("pp",), (2,), {}),
    ("encoder_validator_long", ("dp", "sp"), (2, 4), {}),
    ("encoder_validator_moe", ("dp", "ep"), (2, 4), {"n_experts": 4}),
    ("embeddings_forward_moe", ("dp", "ep"), (1, 2), {"n_experts": 4}),
]


@pytest.mark.parametrize("case", RESTORE_CASES, ids=[c[0] for c in
                                                      RESTORE_CASES])
def test_restore_checkpoint_onto_each_plan_gathers_bit_equal(case, tmp_path):
    family, axes, shape, over = case
    _, _, _, params = weights("bfloat16", **over)
    d = str(tmp_path / "ckpt")
    port_ckpt.save_checkpoint(d, params, step=3)
    mesh = make_mesh(axes=axes, shape=shape, device="cpu")
    meshless = port_ckpt.restore_checkpoint(d, like=params)
    placed = port_ckpt.restore_checkpoint(d, like=params, mesh=mesh,
                                          plan=family)
    assert isinstance(placed, plan.Placement)
    want = flatten_tree(plan.prepare_params(placed.plan, meshless, mesh))
    got = flatten_tree(placed.gather())
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert torch.equal(got[key], want[key]), key
    if family == "encoder_validator_pp":
        assert got["blocks/attn/q"].shape[:2] == (2, 1)
    with pytest.raises(ValueError, match="without a plan"):
        port_ckpt.restore_checkpoint(d, like=params, mesh=mesh)


# ── verdicts through the serve seam ──────────────────────────────────────

@pytest.fixture
def tp_ckpt(tmp_path):
    """A random-init bf16 checkpoint written by the JAX package's writer."""
    d = str(tmp_path / "ckpt")
    bench.write_serving_checkpoint(d, jax_cfg("bfloat16", seq_len=64), seed=0)
    yield d
    serve.close_batchers()
    jax_serve.close_batchers()


@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (2, 4)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_dp_tp_verdicts_equal_jax_mesh_serve(tp_ckpt, shape):
    scfg = {"meshServing": True, "meshShape": list(shape), "windowMs": 0.0,
            "searchedPlans": False}
    jax_call = jax_serve.make_local_call_llm(checkpoint_dir=tp_ckpt,
                                             force=True, serve_cfg=scfg)
    call = serve.make_local_call_llm(tp_ckpt, device="cpu", serve_cfg=scfg)
    texts = [t for t, _ in synthetic_examples(8, seed=6)] + \
        seeded_texts(6, seed=6)
    prompts = [build_prompt(t, []) for t in texts]
    assert [call(p) for p in prompts] == [jax_call(p) for p in prompts]
    stats = call.batcher.stats()
    assert stats["mesh"] == jax_call.batcher.stats()["mesh"] == \
        f"{shape[0]}x{shape[1]}"
    assert stats["meshRuns"]["forward"] == stats["batches"]
    for stage in ("shard", "prefill", "gather"):
        assert stats["stages"]["counts"][stage] >= 1, stage


def test_batched_dp_tp_mesh_equals_meshless_batches(tp_ckpt):
    """Mixed-size batches stepped at once on a 2x4 grid: the verdicts of
    the meshless batcher, each batch bucketed to a dp multiple."""
    kw = dict(max_batch=5, window_ms=0.0, autostart=False, device="cpu")
    meshy = batching.ContinuousBatcher(
        tp_ckpt, mesh=cached_mesh((2, 4), ("dp", "tp"), "cpu"), **kw)
    plain = batching.ContinuousBatcher(tp_ckpt, **kw)
    texts = seeded_texts(13, seed=8)
    got = [meshy.enqueue(t) for t in texts]
    want = [plain.enqueue(t) for t in texts]
    assert meshy.drain() == plain.drain() == len(texts)
    assert [t.result for t in got] == [t.result for t in want]
    assert meshy.stats()["batches"] == 3 and "moe" not in meshy.stats()


class TestGatewayDefaultMeshConfig:
    """The port's ``call_llm`` with ``meshServing: true`` (the default
    dp×tp family on the auto grid) injected into the real GovernancePlugin
    decides as the JAX local path with the same serve config does."""

    META = {"agent_id": "main", "session_key": "agent:main",
            "channel_id": "twitter"}

    def load(self, workspace, call_llm, lcfg):
        from vainplex_openclaw_tpu.governance import GovernancePlugin

        gw, _ = make_gateway()
        plugin = GovernancePlugin(workspace=str(workspace), clock=gw.clock,
                                  call_llm=call_llm)
        gw.load(plugin, plugin_config={
            "enabled": True, "builtinPolicies": {},
            "validation": {"enabled": True, "llmValidator": lcfg}})
        gw.start()
        return gw, plugin

    def test_injected_mesh_call_matches_jax_mesh_local_path(self, tmp_path,
                                                           openclaw_home):
        pool = synthetic_examples(200, seed=12)
        texts = [t for sev in range(4)
                 for t in [t for t, lab in pool if lab["severity"] == sev][:4]]
        texts += seeded_texts(4, seed=12)
        (tmp_path / "a").mkdir()
        (tmp_path / "b").mkdir()
        scfg = {"meshServing": True, "windowMs": 0.0}
        try:
            port_call = serve.make_local_call_llm(device="cpu",
                                                  serve_cfg=scfg)
            # the searched cpu:n8 factorization, as the JAX batcher's
            assert port_call.batcher.stats()["mesh"] == "8x1"
            gw_port, _ = self.load(tmp_path / "a", port_call,
                                   {"enabled": True, "failMode": "closed"})
            got = [(d.blocked, d.content, d.block_reason) for d in
                   (gw_port.message_sending(t, dict(self.META))
                    for t in texts)]
            gw_jax, plugin = self.load(tmp_path / "b", None, {
                "enabled": True, "local": True, "failMode": "closed",
                "serve": scfg})
            jax_batcher = \
                plugin.engine.output_validator.llm_validator.call_llm.batcher
            assert jax_batcher.stats()["mesh"] == "8x1"
            want = [(d.blocked, d.content, d.block_reason) for d in
                    (gw_jax.message_sending(t, dict(self.META))
                     for t in texts)]
            served = (port_call.batcher.stats()["served"],
                      jax_batcher.stats()["served"])
            gw_port.stop()
            gw_jax.stop()
        finally:
            serve.close_batchers()
            jax_serve.close_batchers()
        assert got == want
        assert served[0] == served[1] > 0
        assert any(blocked for blocked, _, _ in got)


# ── the embeddings backend on a mesh ─────────────────────────────────────

EMBED_CASES = [("embeddings_forward", ("dp",), (4,), {}),
               ("embeddings_forward", ("dp",), (8,), {}),
               ("embeddings_forward_moe", ("dp", "ep"), (1, 2),
                {"n_experts": 4}),
               ("embeddings_forward_moe", ("dp", "ep"), (2, 4),
                {"n_experts": 4})]


@pytest.mark.parametrize("case", EMBED_CASES,
                         ids=[f"{c[0]}_{'x'.join(map(str, c[2]))}"
                              for c in EMBED_CASES])
def test_local_embeddings_on_a_mesh_equal_jax(case, tmp_path):
    """Search ids (top 5, fp32 checkpoint) of the port's mesh backend equal
    the JAX mesh backend's, before and after mutations; each mutation
    commits the arena to the mesh again (one more ``shard`` stage)."""
    from vainplex_openclaw_tpu.core.api import list_logger
    from vainplex_openclaw_tpu.knowledge import embeddings as jax_emb
    from vainplex_openclaw_tpu.knowledge.fact_store import Fact
    from vainplex_openclaw_tpu.parallel.mesh import (
        cached_mesh as jax_cached_mesh)
    from vainplex_openclaw_tpu_torch.knowledge import embeddings as port_emb

    family, axes, shape, over = case
    d = str(tmp_path / "ckpt")
    bench.write_serving_checkpoint(d, jax_cfg("float32", **over), seed=1)
    port = port_emb.LocalEmbeddings(
        list_logger(), checkpoint_dir=d, device="cpu", plan_family=family,
        mesh=cached_mesh(shape, axes, "cpu"))
    ref = jax_emb.LocalEmbeddings(
        list_logger(), checkpoint_dir=d, plan_family=family,
        mesh=jax_cached_mesh(shape, axes))
    texts = seeded_texts(30, seed=16)
    facts = [Fact(id=f"f{i}", subject=f"service {i % 7}", predicate="emits",
                  object=t, source="test", created_at="2026")
             for i, t in enumerate(texts)]
    queries = seeded_texts(5, seed=17) + ["service 3 emits"]

    def ids(hits):
        return [h["id"] for h in hits]

    for e in (port, ref):
        e.sync(facts[:20])
    assert [ids(port.search(q, k=5)) for q in queries] == \
        [ids(ref.search(q, k=5)) for q in queries]
    shards = port.timer.counts()["shard"]
    for e in (port, ref):
        e.remove(["f3", "f11"])
        e.sync(facts[20:])
    assert [ids(port.search(q, k=5)) for q in queries] == \
        [ids(ref.search(q, k=5)) for q in queries]
    assert port.timer.counts()["shard"] == shards + 1
    assert port.count() == ref.count() == 28


def test_unknown_family_under_mesh_serving_raises_at_construction():
    with pytest.raises(KeyError, match="no sharding plan"):
        serve.make_local_call_llm(device="cpu", serve_cfg={
            "meshServing": True, "planFamily": "no_such_family"})
