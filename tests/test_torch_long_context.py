"""The port's long-context family against the JAX package.

``forward_long`` (ring attention over a (dp, sp) grid of CPU entries) is
held against the JAX ``forward_long`` with ``attn_impl="flash"`` (the
Pallas kernel in stats mode, run by its interpreter, over the 8 virtual CPU
devices) and against the port's own dense ``forward``, on JAX's
``init_params`` weights carried across: fp32 to 1e-5; bf16 with the
severity argmax equal and logits within 5e-2. The serve family
``encoder_validator_long`` is driven through ``make_local_call_llm`` and
its verdict strings are held against the JAX one-shot oracle on the same
checkpoint.
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
from test_serve_batching import seeded_texts
from vainplex_openclaw_tpu.governance.validation.llm_validator import (
    build_prompt)
from vainplex_openclaw_tpu.models import EncoderConfig as JaxConfig
from vainplex_openclaw_tpu.models import init_params as jax_init_params
from vainplex_openclaw_tpu.models import serve as jax_serve
from vainplex_openclaw_tpu.models.long_context import (
    forward_long as jax_forward_long)
from vainplex_openclaw_tpu.parallel.mesh import make_mesh as jax_make_mesh
from vainplex_openclaw_tpu_torch.models import batching, serve
from vainplex_openclaw_tpu_torch.models.encoder import (
    EncoderConfig, flatten_tree, forward, init_params, param_shapes,
    params_from_numpy)
from vainplex_openclaw_tpu_torch.models.long_context import (
    forward_long, long_context_config)
from vainplex_openclaw_tpu_torch.models.tokenizer import encode_texts
from vainplex_openclaw_tpu_torch.ops import flash_attention as fa
from vainplex_openclaw_tpu_torch.parallel import plan
from vainplex_openclaw_tpu_torch.parallel.mesh import cached_mesh, make_mesh

HEADS = ("severity", "keep", "mood", "embedding")
MESHES = [(2, 4), (1, 8), (4, 2), (1, 1)]
LONG_SERVE = {"meshServing": True, "meshShape": [2, 4],
              "meshAxes": ["dp", "sp"],
              "planFamily": "encoder_validator_long",
              "longContext": {"thresholdTokens": 8}}


def small_cfg(dtype: str) -> JaxConfig:
    """The JAX suite's long-family model (``test_big_model_serving.py``)."""
    return JaxConfig(vocab_size=512, seq_len=64, d_model=64, n_heads=4,
                     n_layers=2, d_ff=128, attn_impl="flash",
                     dtype=jnp.float32 if dtype == "float32" else jnp.bfloat16)


def port_cfg(jcfg: JaxConfig) -> EncoderConfig:
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(EncoderConfig)}
    fields["dtype"] = jnp.dtype(jcfg.dtype).name
    return EncoderConfig(**fields)


def tokens(B: int, L: int, seed: int = 0) -> np.ndarray:
    """Ragged rows (one fully padded) of ids in [2, 512), BOS first."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, L + 1, size=B)
    lengths[0] = L
    lengths[-1] = 0
    tok = rng.integers(2, 512, size=(B, L))
    tok[:, 0] = 1
    tok[np.arange(L)[None, :] >= lengths[:, None]] = 0
    return tok.astype(np.int32)


_weights: dict = {}


def weights(dtype: str):
    """(jax cfg, jax fp32 tree, port cfg, port tree on the CPU)."""
    if dtype not in _weights:
        jcfg = small_cfg(dtype)
        jp = jax_init_params(jax.random.PRNGKey(0), jcfg)
        cfg = port_cfg(jcfg)
        tree = jax.tree_util.tree_map(np.asarray, jp)
        _weights[dtype] = (jcfg, jp, cfg,
                           params_from_numpy(tree, cfg, "cpu", cast=True))
    return _weights[dtype]


def max_err(a: dict, b: dict) -> float:
    return max(float(np.abs(np.asarray(a[h], np.float32)
                            - np.asarray(b[h], np.float32)).max())
               for h in HEADS)


def as_numpy(out: dict) -> dict:
    return {h: (out[h].float().numpy() if isinstance(out[h], torch.Tensor)
                else np.asarray(out[h], np.float32)) for h in HEADS}


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_forward_long_fp32_matches_jax_and_dense(shape):
    jcfg, jp, cfg, params = weights("float32")
    tok = tokens(4, 64, seed=1)
    mesh = make_mesh(axes=("dp", "sp"), shape=shape, device="cpu")
    with torch.inference_mode():
        got = as_numpy(forward_long(params, tok, cfg, mesh))
        dense = as_numpy(forward(params, torch.from_numpy(tok), cfg))
    want = as_numpy(jax_forward_long(
        jp, jnp.asarray(tok), jcfg,
        jax_make_mesh(math.prod(shape), axes=("dp", "sp"), shape=shape)))
    assert all(np.isfinite(got[h]).all() for h in HEADS)
    assert max_err(got, want) <= 1e-5
    assert max_err(got, dense) <= 1e-5


@pytest.mark.parametrize("shape", [(2, 4), (1, 8)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_forward_long_bf16_argmax_and_logits(shape):
    jcfg, jp, cfg, params = weights("bfloat16")
    tok = tokens(8, 64, seed=2)
    mesh = make_mesh(axes=("dp", "sp"), shape=shape, device="cpu")
    with torch.inference_mode():
        got = as_numpy(forward_long(params, tok, cfg, mesh))
        dense = as_numpy(forward(params, torch.from_numpy(tok), cfg))
    want = as_numpy(jax_forward_long(
        jp, jnp.asarray(tok), jcfg,
        jax_make_mesh(math.prod(shape), axes=("dp", "sp"), shape=shape)))
    for ref in (want, dense):
        assert (got["severity"].argmax(-1) == ref["severity"].argmax(-1)).all()
        assert max_err(got, ref) <= 5e-2


def test_forward_long_runs_the_stats_path_per_shard_and_rotation(monkeypatch):
    """Every block's attention goes through ``flash_attention`` in stats
    mode: n_layers × dp × sp² calls per forward (the K2 launches on the
    card)."""
    _, _, cfg, params = weights("float32")
    calls = []
    real = fa.flash_attention

    def spy(*a, **kw):
        calls.append(kw.get("return_stats", False))
        return real(*a, **kw)

    monkeypatch.setattr(
        "vainplex_openclaw_tpu_torch.parallel.ring_attention.flash_attention",
        spy)
    mesh = make_mesh(axes=("dp", "sp"), shape=(2, 4), device="cpu")
    with torch.inference_mode():
        forward_long(params, tokens(4, 64), cfg, mesh)
    assert len(calls) == cfg.n_layers * 2 * 4 * 4 and all(calls)


def test_fully_padded_row_stays_finite():
    _, _, cfg, params = weights("bfloat16")
    tok = encode_texts(["the deploy failed", "x", "", "retry stalled"],
                       cfg.seq_len, cfg.vocab_size)
    tok[2, :] = 0
    mesh = make_mesh(axes=("dp", "sp"), shape=(2, 4), device="cpu")
    with torch.inference_mode():
        out = forward_long(params, tok, cfg, mesh)
    for h in HEADS:
        assert torch.isfinite(out[h].float()).all(), h


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_long_refuses_moe_and_unsplittable_inputs(dtype):
    """MoE blocks serve on the long path (they raised before): at (2, 4)
    over (dp, sp), against the JAX ``forward_long`` on the same 4-expert
    weights, fp32 logits and ``moe_aux`` (each layer's sums psummed over dp
    and sp before the loss) within 1e-5; bf16 with the severity argmax
    equal and logits within 1e-1 (near-tie routing, ROADMAP Queue 3). A
    batch that does not split over dp still raises."""
    jcfg = dataclasses.replace(small_cfg(dtype), n_experts=4)
    jp = jax_init_params(jax.random.PRNGKey(4), jcfg)
    cfg = port_cfg(jcfg)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg,
                               "cpu", cast=True)
    tok = tokens(8, 64, seed=6)
    mesh = make_mesh(axes=("dp", "sp"), shape=(2, 4), device="cpu")
    with torch.inference_mode():
        out = forward_long(params, tok, cfg, mesh)
    jout = jax_forward_long(jp, jnp.asarray(tok), jcfg,
                            jax_make_mesh(8, axes=("dp", "sp"), shape=(2, 4)))
    got, want = as_numpy(out), as_numpy(jout)
    assert all(np.isfinite(got[h]).all() for h in HEADS)
    aux_err = abs(float(out["moe_aux"]) - float(jout["moe_aux"]))
    if dtype == "float32":
        assert max_err(got, want) <= 1e-5
        assert float(out["moe_aux"]) > 0 and aux_err <= 1e-5
    else:
        assert (got["severity"].argmax(-1)
                == want["severity"].argmax(-1)).all()
        assert max_err(got, want) <= 1e-1
    with pytest.raises(ValueError, match="does not split"):
        forward_long(params, tokens(3, 64), cfg, mesh)


def test_long_context_config_is_the_repos_model():
    for L in (2048, 16384):
        want = bench.long_context_config(L)
        got = long_context_config(L)
        assert port_cfg(dataclasses.replace(want, attn_impl="auto")) == got
    assert long_context_config(16384).attn_impl == "auto"


# ── init_params ──────────────────────────────────────────────────────────

def test_init_params_shapes_and_scales():
    cfg = long_context_config(256)
    tree = init_params(cfg, torch.Generator().manual_seed(0))
    flat = flatten_tree(tree)
    assert {k: tuple(v.shape) for k, v in flat.items()} == param_shapes(cfg)
    jflat = flatten_tree(jax.tree_util.tree_map(
        np.asarray, jax_init_params(jax.random.PRNGKey(0),
                                    small_cfg("float32"))))
    assert set(flatten_tree(init_params(
        port_cfg(small_cfg("float32")),
        torch.Generator().manual_seed(0)))) == set(jflat)
    for key, leaf in flat.items():
        assert leaf.dtype == torch.float32 and leaf.device.type == "cpu"
        if key.endswith("/scale"):
            assert (leaf == 1).all()
            continue
        want = 0.02 if key.startswith("embed/") else 1 / math.sqrt(
            leaf.shape[0])
        assert abs(float(leaf.std()) - want) / want < 0.1, key
    again = flatten_tree(init_params(cfg, torch.Generator().manual_seed(0)))
    assert all(torch.equal(flat[k], again[k]) for k in flat)
    other = flatten_tree(init_params(cfg, torch.Generator().manual_seed(1)))
    assert not torch.equal(flat["embed/tok"], other["embed/tok"])


# ── the serve family ─────────────────────────────────────────────────────

LONG_TEXTS = [f"the deploy failed with code {i} and the retry stalled while "
              f"throughput regressed badly across every shard"
              for i in range(3)]
SHORT_TEXTS = ["ok", "fine", "done"]


@pytest.fixture
def long_ckpt(tmp_path, request):
    """A random-init checkpoint written by the JAX package's own writer."""
    attn_impl = getattr(request, "param", "auto")
    jcfg = dataclasses.replace(small_cfg("bfloat16"), attn_impl=attn_impl)
    d = str(tmp_path / "ckpt")
    bench.write_serving_checkpoint(d, jcfg, seed=0)
    yield d
    serve.close_batchers()
    jax_serve.close_batchers()


@pytest.mark.parametrize("long_ckpt", ["auto", "dense"], indirect=True)
def test_long_family_verdicts_equal_jax_oneshot(long_ckpt):
    """Long rows route to the ring program, short rows to the dense twin;
    every verdict string equals the JAX one-shot oracle's."""
    oracle = jax_serve.make_local_call_llm(
        checkpoint_dir=long_ckpt, force=True,
        serve_cfg={"continuousBatching": False})
    call = serve.make_local_call_llm(long_ckpt, device="cpu", serve_cfg={
        "windowMs": 0.0, **LONG_SERVE})
    texts = LONG_TEXTS + SHORT_TEXTS + seeded_texts(10, seed=4)
    for text in texts:
        prompt = build_prompt(text, [])
        assert call(prompt) == oracle(prompt)
    stats = call.batcher.stats()
    assert stats["mesh"] == "2x4"
    assert stats["longRouted"] >= len(LONG_TEXTS)
    assert stats["longRouted"] < stats["served"] == len(texts)
    snap = stats["stages"]
    for stage in ("queue", "batch", "shard", "prefill", "gather", "decode"):
        assert snap["counts"][stage] >= 1, stage


def test_long_family_serves_moe_checkpoints_like_jax(tmp_path):
    """An MoE checkpoint under the long family: long rows through the MoE
    ring, short rows through the ``forward``-runner twin; verdicts equal the
    JAX one-shot oracle's and the batcher reports the MoE aux."""
    jcfg = dataclasses.replace(small_cfg("float32"), n_experts=4)
    d = str(tmp_path / "moe")
    bench.write_serving_checkpoint(d, jcfg, seed=3)
    try:
        oracle = jax_serve.make_local_call_llm(
            checkpoint_dir=d, force=True,
            serve_cfg={"continuousBatching": False})
        call = serve.make_local_call_llm(d, device="cpu", serve_cfg={
            "windowMs": 0.0, **LONG_SERVE})
        texts = LONG_TEXTS + SHORT_TEXTS + seeded_texts(6, seed=8)
        for text in texts:
            prompt = build_prompt(text, [])
            assert call(prompt) == oracle(prompt)
        stats = call.batcher.stats()
        assert len(LONG_TEXTS) <= stats["longRouted"] < len(texts)
        assert stats["moe"]["batches"] == len(texts)
        assert stats["moe"]["auxMean"] > 0
    finally:
        serve.close_batchers()
        jax_serve.close_batchers()


def test_long_family_mixed_batches_equal_jax_oneshot(long_ckpt):
    """Mixed batches stepped at once: each splits into a long and a short
    sub-batch, each bucketed on its own."""
    oracle = jax_serve.make_local_call_llm(
        checkpoint_dir=long_ckpt, force=True,
        serve_cfg={"continuousBatching": False})
    batcher = batching.ContinuousBatcher(
        long_ckpt, max_batch=8, window_ms=0.0, autostart=False,
        device="cpu", mesh=cached_mesh((2, 4), ("dp", "sp"), "cpu"),
        plan_family="encoder_validator_long", long_threshold=8)
    texts = (LONG_TEXTS + SHORT_TEXTS) * 2 + seeded_texts(7, seed=5)
    tickets = [batcher.enqueue(t) for t in texts]
    assert batcher.drain() == len(texts)
    assert [t.result for t in tickets] == \
        [oracle(build_prompt(t, [])) for t in texts]
    stats = batcher.stats()
    tok = encode_texts(texts, 64, 512)
    assert stats["longRouted"] == int(((tok > 0).sum(axis=1) >= 8).sum())
    assert stats["meshRuns"]["long"] >= 1 and stats["meshRuns"]["forward"] >= 1


def test_mesh_key_equals_jax():
    for scfg in ({}, {"meshServing": True},
                 dict(LONG_SERVE), dict(LONG_SERVE, meshShape=None),
                 dict(LONG_SERVE, longContext={"thresholdTokens": 7}),
                 dict(LONG_SERVE, searchedPlans=False)):
        assert serve._mesh_key(scfg) == jax_serve._mesh_key(scfg)


def test_batchers_keyed_on_plan_family_and_threshold(long_ckpt):
    base = {"windowMs": 0.0}
    plain = serve.make_local_call_llm(long_ckpt, device="cpu",
                                      serve_cfg=dict(base))
    long_fam = serve.make_local_call_llm(long_ckpt, device="cpu",
                                         serve_cfg=dict(base, **LONG_SERVE))
    again = serve.make_local_call_llm(long_ckpt, device="cpu",
                                      serve_cfg=dict(base, **LONG_SERVE))
    thresh = serve.make_local_call_llm(long_ckpt, device="cpu", serve_cfg=dict(
        base, **dict(LONG_SERVE, longContext={"thresholdTokens": 7})))
    assert plain.batcher is not long_fam.batcher
    assert long_fam.batcher is again.batcher
    assert long_fam.batcher is not thresh.batcher
    assert (long_fam.batcher.long_threshold, thresh.batcher.long_threshold) \
        == (8, 7)
    assert plain.batcher.mesh is None
    assert long_fam.batcher.mesh.shape == {"dp": 2, "sp": 4}


def test_auto_mesh_shape_takes_every_cpu_entry(long_ckpt):
    call = serve.make_local_call_llm(long_ckpt, device="cpu", serve_cfg=dict(
        LONG_SERVE, meshShape=None, windowMs=0.0))
    # JAX's shape: the searched cpu:n8 factorization of the default family
    # (asked whatever planFamily is), not _factor(8) = (2, 4)
    assert call.batcher.mesh.shape == {"dp": 8, "sp": 1}
    jax_mesh = jax_serve._resolve_mesh(
        {**jax_serve.SERVE_DEFAULTS, **LONG_SERVE, "meshShape": None})
    assert dict(jax_mesh.shape) == call.batcher.mesh.shape
    assert call(build_prompt(LONG_TEXTS[0], []))


@pytest.mark.parametrize("scfg", [
    {"meshServing": True},
    {"meshServing": True, "planFamily": "encoder_validator_pp",
     "meshAxes": ["pp"], "meshShape": [2]},
    {"meshServing": True, "planFamily": "encoder_validator_moe",
     "meshAxes": ["dp", "ep"]},
    {"planFamily": "encoder_validator_long"}])
def test_other_mesh_families_still_raise(scfg, long_ckpt):
    """The other families serve this (dense) checkpoint now, with verdicts
    equal to the JAX one-shot oracle: dp×tp on the auto grid, the
    pipeline over two stages, and a plan family without meshServing on
    one device. The MoE family still raises, loudly, as the JAX mesh path
    does: its expert rules match no leaf of a dense tree."""
    call = serve.make_local_call_llm(long_ckpt, device="cpu",
                                     serve_cfg=dict(scfg, windowMs=0.0))
    prompts = [build_prompt(t, []) for t in LONG_TEXTS + SHORT_TEXTS]
    if scfg.get("planFamily") == "encoder_validator_moe":
        with pytest.raises(ValueError, match="rule-table validation"):
            call(prompts[0])
        return
    oracle = jax_serve.make_local_call_llm(
        checkpoint_dir=long_ckpt, force=True,
        serve_cfg={"continuousBatching": False})
    assert [call(p) for p in prompts] == [oracle(p) for p in prompts]
    assert (call.batcher.mesh is None) == (not scfg.get("meshServing"))


def test_mesh_needs_its_axes(long_ckpt):
    with pytest.raises(ValueError, match="needs mesh axes"):
        serve.make_local_call_llm(long_ckpt, device="cpu", serve_cfg=dict(
            LONG_SERVE, meshAxes=["dp", "tp"]))
    plan.clear_plan_caches()
