"""The port's encoder forward against the JAX ``forward``.

Two legs, each for ``attn_impl="dense"`` and ``"flash"`` pinned on BOTH
sides (the JAX package's own ``"auto"`` picks dense on the CPU; its
``"flash"`` runs the Pallas kernel under the interpreter):

- fp32: the shipped weights restored in fp32 with no cast and
  ``dtype=float32``; every logit and the embedding within 1e-5. This leg
  is what catches semantic faults (tanh GELU, RMSNorm eps placement, the
  pooling clamp), since bf16 noise would hide them;
- bf16: the shipped inference tree; argmax equal on every row, logits
  within 5e-2.

Inputs are token ids from seeded texts, including an all-pad row (the
batcher's zero-pad rows: every key masked, pooled over nothing).
"""

from __future__ import annotations

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vainplex_openclaw_tpu.models import EncoderConfig as JaxConfig
from vainplex_openclaw_tpu.models import forward as jax_forward
from vainplex_openclaw_tpu.models import init_params
from vainplex_openclaw_tpu.models import pretrained as jax_pretrained
from vainplex_openclaw_tpu.models.checkpoint import restore_checkpoint
from vainplex_openclaw_tpu.models.data import synthetic_split
from vainplex_openclaw_tpu.models.encoder import _rmsnorm as jax_rmsnorm
from vainplex_openclaw_tpu.models.encoder import (
    stack_blocks as jax_stack_blocks)
from vainplex_openclaw_tpu_torch.models import encoder as port_encoder
from vainplex_openclaw_tpu_torch.models import pretrained as port_pretrained
from vainplex_openclaw_tpu_torch.models.encoder import (
    EncoderConfig, forward, params_from_numpy)
from vainplex_openclaw_tpu_torch.models.tokenizer import encode_texts

HEADS = ("severity", "keep", "mood", "embedding")


def eval_texts(n=None):
    _, evals = synthetic_split(4096, 512, seed=0)
    return evals if n is None else evals[:n]


def tokens_with_pad_row(n, seq_len=64, vocab=2048):
    toks = encode_texts([t for t, _ in eval_texts(n - 1)], seq_len, vocab)
    return np.concatenate([toks, np.zeros((1, seq_len), np.int32)])


def to_numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port_cfg(jcfg, **over) -> EncoderConfig:
    d = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    d["dtype"] = jnp.dtype(jcfg.dtype).name
    d.update(over)
    return EncoderConfig(**d)


def run_both(jparams, jcfg, tokens, impl, dtype_name):
    jc = dataclasses.replace(jcfg, attn_impl=impl,
                             dtype=getattr(jnp, dtype_name))
    want = jax_forward(jparams, jnp.asarray(tokens), jc)
    pc = port_cfg(jc)
    params = params_from_numpy(to_numpy_tree(jparams), pc, "cpu")
    got = forward(params, torch.from_numpy(tokens), pc)
    return ({h: got[h].float().numpy() for h in HEADS},
            {h: np.asarray(want[h], np.float32) for h in HEADS})


@pytest.fixture(scope="module")
def shipped_fp32():
    cfg, _ = jax_pretrained.load_pretrained()
    like = init_params(jax.random.PRNGKey(0), cfg)
    return cfg, restore_checkpoint(jax_pretrained.DEFAULT_DIR, like=like)


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_fp32_leg_shipped_weights(shipped_fp32, impl):
    jcfg, params = shipped_fp32
    tokens = tokens_with_pad_row(16)
    got, want = run_both(params, jcfg, tokens, impl, "float32")
    for h in HEADS:
        np.testing.assert_allclose(got[h], want[h], atol=1e-5, rtol=0,
                                   err_msg=h)
        assert np.isfinite(got[h]).all()


@pytest.mark.parametrize("impl,n", [("dense", 512), ("flash", 32)])
def test_bf16_leg_shipped_inference_tree(impl, n):
    jcfg, jparams = jax_pretrained.load_pretrained()
    tokens = tokens_with_pad_row(n)
    got, want = run_both(jparams, jcfg, tokens, impl, "bfloat16")
    for h in ("severity", "keep", "mood"):
        assert (got[h].argmax(-1) == want[h].argmax(-1)).all(), h
        np.testing.assert_allclose(got[h], want[h], atol=5e-2, rtol=0,
                                   err_msg=h)
    np.testing.assert_allclose(got["embedding"], want["embedding"],
                               atol=5e-2, rtol=0)


def test_heldout_accuracy_equals_shipped_eval():
    port_pretrained.clear_cache()
    cfg, params = port_pretrained.load_pretrained(device="cpu")
    with open(os.path.join(port_pretrained.DEFAULT_DIR, "config.json"),
              encoding="utf-8") as f:
        recorded = json.load(f)["eval"]
    examples = eval_texts()
    correct = {h: 0 for h in ("severity", "keep", "mood")}
    for start in range(0, len(examples), 64):
        chunk = examples[start:start + 64]
        toks = encode_texts([t for t, _ in chunk], cfg.seq_len,
                            cfg.vocab_size)
        out = forward(params, torch.from_numpy(toks), cfg)
        for h in correct:
            labels = torch.tensor([lab[h] for _, lab in chunk])
            correct[h] += int((out[h].argmax(-1) == labels).sum())
    for h, c in correct.items():
        assert c / len(examples) == recorded[f"{h}_accuracy"] == 1.0, h


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_random_init_small_config(impl):
    jcfg = JaxConfig(vocab_size=512, seq_len=64, d_model=32, n_heads=2,
                     n_layers=2, d_ff=64, dtype=jnp.float32)
    params = init_params(jax.random.PRNGKey(3), jcfg)
    tokens = tokens_with_pad_row(8, vocab=512)
    got, want = run_both(params, jcfg, tokens, impl, "float32")
    for h in HEADS:
        np.testing.assert_allclose(got[h], want[h], atol=1e-5, rtol=0,
                                   err_msg=h)


# tests/test_encoder.py:12's config: d_model 32 over 4 heads, head dim 8
DH8_CFG = JaxConfig(vocab_size=256, seq_len=32, d_model=32, n_heads=4,
                    n_layers=3, d_ff=64)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_head_dim_8_config_matches_jax(dtype_name):
    """The port's ``forward`` with its default ``attn_impl="auto"`` (the
    kernel's wrapper) at head dim 8, on JAX's ``init_params`` weights,
    against JAX's ``forward`` through its Pallas kernel (interpreter):
    fp32 within 1e-5; bf16 (the inference cast) argmax equal and logits
    within 5e-2. The wrapper once refused Dh 8."""
    dt = getattr(jnp, dtype_name)
    jc = dataclasses.replace(DH8_CFG, attn_impl="flash", dtype=dt)
    jparams = init_params(jax.random.PRNGKey(0), jc)
    tokens = encode_texts(["tool call failed: connection refused",
                           "we decided to ship v2 tomorrow", ""],
                          jc.seq_len, jc.vocab_size)
    cast = dtype_name == "bfloat16"
    if cast:
        from vainplex_openclaw_tpu.models import cast_params

        jparams = cast_params(jparams, dt)
    want = jax_forward(jparams, jnp.asarray(tokens), jc)
    pc = port_cfg(jc, attn_impl="auto")
    params = params_from_numpy(to_numpy_tree(jparams), pc, "cpu", cast=cast)
    got = forward(params, torch.from_numpy(tokens), pc)
    for h in HEADS:
        g = got[h].float().numpy()
        w = np.asarray(want[h], np.float32)
        assert np.isfinite(g).all(), h
        if cast and h != "embedding":
            assert (g.argmax(-1) == w.argmax(-1)).all(), h
        np.testing.assert_allclose(g, w, atol=1e-5 if not cast else 5e-2,
                                   rtol=0, err_msg=h)


def test_auto_is_flash_on_the_cpu():
    _, params = port_pretrained.load_pretrained(device="cpu")
    cfg = port_pretrained.load_pretrained(device="cpu")[0]
    toks = torch.from_numpy(tokens_with_pad_row(8))
    auto = forward(params, toks, cfg)
    flash = forward(params, toks, dataclasses.replace(cfg, attn_impl="flash"))
    for h in HEADS:
        assert torch.equal(auto[h], flash[h]), h


def test_unknown_impl_and_moe_raise():
    cfg, params = port_pretrained.load_pretrained(device="cpu")
    toks = torch.from_numpy(tokens_with_pad_row(2))
    with pytest.raises(ValueError, match="attn_impl"):
        forward(params, toks, dataclasses.replace(cfg, attn_impl="ring"))
    # an MoE config over a dense parameter tree
    with pytest.raises(ValueError, match="moe"):
        forward(params, toks, dataclasses.replace(cfg, n_experts=2))


def test_scan_blocks_runs_the_same_loop():
    """``stack_blocks`` gives JAX's stacked tree bit for bit; ``forward``
    under ``scan_blocks`` on it equals the per-layer loop bit for bit (and
    JAX's scanned forward within 1e-5 in fp32); a per-layer list under
    ``scan_blocks`` raises JAX's ``ValueError`` in both packages."""
    jcfg = JaxConfig(vocab_size=512, seq_len=64, d_model=32, n_heads=2,
                     n_layers=3, d_ff=64, dtype=jnp.float32)
    jparams = init_params(jax.random.PRNGKey(5), jcfg)
    cfg = port_cfg(jcfg)
    params = params_from_numpy(to_numpy_tree(jparams), cfg, "cpu", cast=False)
    stacked = port_encoder.stack_blocks(params)
    jstacked = jax_stack_blocks(jparams)
    got = port_encoder.flatten_tree(stacked["blocks"])
    want = port_encoder.flatten_tree(to_numpy_tree(jstacked["blocks"]))
    assert got.keys() == want.keys()
    for k, v in got.items():
        assert tuple(v.shape) == want[k].shape == (3,) + want[k].shape[1:]
        assert np.array_equal(v.numpy(), want[k]), k
    toks = torch.from_numpy(tokens_with_pad_row(4, vocab=512))
    scan = dataclasses.replace(cfg, scan_blocks=True)
    a = forward(params, toks, cfg)
    b = forward(stacked, toks, scan)
    jout = jax_forward(jstacked, jnp.asarray(toks.numpy()),
                       dataclasses.replace(jcfg, scan_blocks=True))
    for h in HEADS + ("moe_aux",):
        assert torch.equal(a[h], b[h]), h
        np.testing.assert_allclose(b[h].numpy(), np.asarray(jout[h]),
                                   atol=1e-5, rtol=0, err_msg=h)
    for fwd, tree, c in ((forward, params, scan),
                         (jax_forward, jparams,
                          dataclasses.replace(jcfg, scan_blocks=True))):
        with pytest.raises(ValueError, match="stack_blocks"):
            fwd(tree, toks if fwd is forward else jnp.asarray(toks.numpy()),
                c)


def test_all_pad_row_pools_to_zero_logits():
    """Denominator clamped ≥ 1: an all-pad row pools to 0, so its logits
    are exactly 0 and its embedding 0 — finite, never NaN."""
    cfg, params = port_pretrained.load_pretrained(device="cpu")
    out = forward(params, torch.zeros((2, cfg.seq_len), dtype=torch.int32),
                  cfg)
    for h in ("severity", "keep", "mood", "embedding"):
        assert torch.equal(out[h], torch.zeros_like(out[h])), h
    assert float(out["moe_aux"]) == 0.0


class TestForwardTraps:
    """Each numeric trap against the JAX expression it mirrors."""

    def test_gelu_is_the_tanh_form(self):
        x = np.linspace(-6, 6, 1001, dtype=np.float32)
        want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
        got = F.gelu(torch.from_numpy(x), approximate="tanh").numpy()
        np.testing.assert_allclose(got, want, atol=1e-6)
        erf = F.gelu(torch.from_numpy(x)).numpy()
        assert np.abs(erf - want).max() > 1e-4  # the default would differ

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_rmsnorm_fp32_with_eps_inside_rsqrt(self, dtype):
        rng = np.random.default_rng(0)
        x = (rng.standard_normal((4, 8, 64)) * 1e-3).astype(np.float32)
        scale = rng.standard_normal(64).astype(np.float32)
        jx = jnp.asarray(x).astype(getattr(jnp, dtype))
        want = np.asarray(jax_rmsnorm(jx, jnp.asarray(scale)), np.float32)
        tx = torch.from_numpy(x).to(getattr(torch, dtype))
        got = port_encoder._rmsnorm(tx, torch.from_numpy(scale))
        assert got.dtype == tx.dtype
        np.testing.assert_allclose(got.float().numpy(), want,
                                   atol=1e-6 if dtype == "float32" else 2e-2)

    def test_dense_rounds_scores_to_bf16_flash_does_not(self):
        """On bf16 activations the two implementations differ only by
        the dense path's rounding of q·kᵀ before the softmax: close, not
        equal."""
        cfg, params = port_pretrained.load_pretrained(device="cpu")
        toks = torch.from_numpy(tokens_with_pad_row(16))
        dense = forward(params, toks,
                        dataclasses.replace(cfg, attn_impl="dense"))
        flash = forward(params, toks, cfg)
        diff = float((dense["severity"] - flash["severity"]).abs().max())
        assert 0.0 < diff < 5e-2
