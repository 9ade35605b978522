"""The port's mixture-of-experts FFN and MoE encoder against the JAX package.

- ``moe_ffn_parts`` (out, route_sum, prob_sum, count) against the JAX
  function on the same inputs and weights, fp32 within 1e-5, with and
  without a valid-token mask; the masked-aux regressions of
  ``tests/test_moe_pipeline.py::TestMoEMask`` on the port.
- The MoE encoder (the ``__graft_entry__`` MoE widths: d_model 64, 4 heads,
  2 layers, d_ff 128, seq 32, vocab 512, 4 experts): forward fp32 within
  1e-5 and ``moe_aux`` equal to 1e-6; bf16 (the inference cast, gate
  included) with the severity argmax equal and logits within 1e-1 (not the
  dense model's 5e-2: a freshly initialized router is near uniform, so a
  token whose top two router probabilities are within bf16 noise may go to
  another expert on each side; measured 0.077 on one of 68 logits); one-step
  gradients against ``jax.grad(loss_fn)``, every leaf within 1e-5 of
  max(1, max |g|).
- A checkpoint the port writes for that model, served on one device
  through ``make_local_call_llm``: verdicts equal to the JAX one-shot
  oracle on the same checkpoint.

Weights are the JAX ``init_params`` carried across as numpy arrays; inputs
come from numpy seeds.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vainplex_openclaw_tpu.models import EncoderConfig as JaxConfig
from vainplex_openclaw_tpu.models import checkpoint as jax_ckpt
from vainplex_openclaw_tpu.models import forward as jax_forward
from vainplex_openclaw_tpu.models import init_params as jax_init_params
from vainplex_openclaw_tpu.models import moe as jax_moe
from vainplex_openclaw_tpu.models import pretrained as jax_pretrained
from vainplex_openclaw_tpu.models import serve as jax_serve
from vainplex_openclaw_tpu.models import train as jax_train
from vainplex_openclaw_tpu.models.data import synthetic_examples
from vainplex_openclaw_tpu_torch.models import moe
from vainplex_openclaw_tpu_torch.models import pretrained as port_pretrained
from vainplex_openclaw_tpu_torch.models import serve as port_serve
from vainplex_openclaw_tpu_torch.models import train
from vainplex_openclaw_tpu_torch.models.data import TextClassificationData
from vainplex_openclaw_tpu_torch.models.encoder import (
    EncoderConfig, flatten_tree, forward, init_params, param_shapes,
    params_from_numpy)
from vainplex_openclaw_tpu_torch.models.tokenizer import encode_texts

CPU = torch.device("cpu")
HEADS = ("severity", "keep", "mood", "embedding")
JCFG = JaxConfig(vocab_size=512, seq_len=32, d_model=64, n_heads=4,
                 n_layers=2, d_ff=128, n_experts=4, dtype=jnp.float32)


def port_cfg(jcfg, **over) -> EncoderConfig:
    d = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    d["dtype"] = jnp.dtype(jcfg.dtype).name
    d.update(over)
    return EncoderConfig(**d)


def to_numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_flat(tree) -> dict:
    return {jax_ckpt._path_key(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def jparams():
    return to_numpy_tree(jax_init_params(jax.random.PRNGKey(3), JCFG))


def texts(n: int, seed: int = 1) -> list:
    return [t for t, _ in synthetic_examples(n, seed=seed)]


def tokens(n: int, seed: int = 1) -> np.ndarray:
    toks = encode_texts(texts(n - 1, seed), JCFG.seq_len, JCFG.vocab_size)
    return np.concatenate([toks, np.zeros((1, JCFG.seq_len), np.int32)])


# ── the FFN ─────────────────────────────────────────────────────────


def ffn_inputs(seed, B=3, T=16, D=32, F=64, E=4, masked=True):
    cfg = moe.MoEConfig(d_model=D, d_ff=F, n_experts=E)
    p = to_numpy_tree(jax_moe.init_moe_params(jax.random.PRNGKey(seed),
                                              jax_moe.MoEConfig(D, F, E)))
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    mask = None
    if masked:
        mask = np.arange(T)[None, :] < rng.integers(0, T + 1, size=B)[:, None]
    return cfg, p, x, mask


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_moe_ffn_parts_match_jax(seed, masked):
    cfg, p, x, mask = ffn_inputs(seed, masked=masked)
    want = jax_moe.moe_ffn_parts(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
        jax_moe.MoEConfig(cfg.d_model, cfg.d_ff, cfg.n_experts),
        None if mask is None else jnp.asarray(mask))
    got = moe.moe_ffn_parts(
        torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()},
        cfg, None if mask is None else torch.from_numpy(mask))
    for name, g, w in zip(("out", "route_sum", "prob_sum", "count"), got,
                          want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5, err_msg=name)
    _, aux_w = jax_moe.moe_ffn(jnp.asarray(x), {k: jnp.asarray(v) for k, v
                                                in p.items()},
                               jax_moe.MoEConfig(cfg.d_model, cfg.d_ff,
                                                 cfg.n_experts),
                               None if mask is None else jnp.asarray(mask))
    _, aux = moe.moe_ffn(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v
                                               in p.items()}, cfg,
                         None if mask is None else torch.from_numpy(mask))
    assert abs(float(aux) - float(aux_w)) <= 1e-6


def test_moe_ffn_bf16_gate_is_upcast():
    """The inference cast makes the gate bf16; the router still runs in
    fp32, as JAX promotes it."""
    cfg, p, x, mask = ffn_inputs(4)
    tp = {k: torch.from_numpy(v).bfloat16() for k, v in p.items()}
    out, *_ = moe.moe_ffn_parts(torch.from_numpy(x).bfloat16(), tp, cfg,
                                torch.from_numpy(mask))
    want, *_ = jax_moe.moe_ffn_parts(
        jnp.asarray(x, jnp.bfloat16),
        {k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()},
        jax_moe.MoEConfig(cfg.d_model, cfg.d_ff, cfg.n_experts),
        jnp.asarray(mask))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want, np.float32), atol=5e-2)


class TestMoEMask:
    """The port pinned on ``tests/test_moe_pipeline.py::TestMoEMask``: the
    aux loss ignores padding tokens."""

    def setup_method(self):
        self.cfg = moe.MoEConfig(d_model=32, d_ff=64, n_experts=4)
        self.params = moe.init_moe_params(self.cfg,
                                          torch.Generator().manual_seed(0))
        self.rng = np.random.default_rng(0)

    def real(self, *shape):
        return torch.from_numpy(self.rng.standard_normal(shape)
                                .astype(np.float32))

    def test_masked_aux_equals_unpadded_aux(self):
        real = self.real(2, 8, 32)
        padded = torch.cat([real, torch.zeros(2, 24, 32)], dim=1)
        mask = torch.cat([torch.ones(2, 8, dtype=torch.bool),
                          torch.zeros(2, 24, dtype=torch.bool)], dim=1)
        _, aux_masked = moe.moe_ffn(padded, self.params, self.cfg, mask)
        _, aux_real = moe.moe_ffn(real, self.params, self.cfg)
        np.testing.assert_allclose(float(aux_masked), float(aux_real),
                                   rtol=1e-5)

    def test_pad_heavy_batch_does_not_dilute_aux(self):
        real = self.real(1, 4, 32)
        padded = torch.cat([real, torch.zeros(1, 124, 32)], dim=1)
        mask = torch.cat([torch.ones(1, 4, dtype=torch.bool),
                          torch.zeros(1, 124, dtype=torch.bool)], dim=1)
        _, aux_no_mask = moe.moe_ffn(padded, self.params, self.cfg)
        _, aux_masked = moe.moe_ffn(padded, self.params, self.cfg, mask)
        assert not np.isclose(float(aux_no_mask), float(aux_masked))

    def test_all_pad_shard_is_finite(self):
        _, aux = moe.moe_ffn(torch.zeros(1, 8, 32), self.params, self.cfg,
                             torch.zeros(1, 8, dtype=torch.bool))
        assert np.isfinite(float(aux))


def test_init_params_shapes_and_scales():
    cfg = port_cfg(JCFG)
    tree = init_params(cfg, torch.Generator().manual_seed(0))
    flat = flatten_tree(tree)
    assert {k: tuple(v.shape) for k, v in flat.items()} == param_shapes(cfg)
    assert {k for k in flat if "/moe/" in k} == {
        f"blocks/{i}/moe/{n}" for i in range(2) for n in ("gate", "w1", "w2")}
    assert not any("/mlp/" in k for k in flat)
    assert set(param_shapes(cfg)) == set(jax_flat(
        jax_init_params(jax.random.PRNGKey(0), JCFG)))
    gate, w1 = flat["blocks/0/moe/gate"], flat["blocks/0/moe/w1"]
    assert abs(float(gate.std()) - 0.02) < 0.004
    assert abs(float(w1.std()) - 1 / np.sqrt(64)) < 0.01


# ── the encoder ─────────────────────────────────────────────────────


@pytest.mark.parametrize("impl", ["flash", "dense"])
def test_moe_encoder_fp32_leg(jparams, impl):
    jcfg = dataclasses.replace(JCFG, attn_impl=impl)
    tok = tokens(9)
    want = jax_forward(jax.tree_util.tree_map(jnp.asarray, jparams),
                       jnp.asarray(tok), jcfg)
    cfg = port_cfg(jcfg)
    got = forward(params_from_numpy(jparams, cfg, CPU), torch.from_numpy(tok),
                  cfg)
    for h in HEADS:
        np.testing.assert_allclose(got[h].numpy(), np.asarray(want[h]),
                                   rtol=0, atol=1e-5, err_msg=h)
    assert float(want["moe_aux"]) > 0
    assert abs(float(got["moe_aux"]) - float(want["moe_aux"])) <= 1e-6


@pytest.mark.parametrize("impl", ["flash", "dense"])
def test_moe_encoder_bf16_leg(jparams, impl):
    jcfg = dataclasses.replace(JCFG, attn_impl=impl, dtype=jnp.bfloat16)
    tok = tokens(17)
    from vainplex_openclaw_tpu.models import cast_params

    want = jax_forward(cast_params(jax.tree_util.tree_map(jnp.asarray,
                                                          jparams)),
                       jnp.asarray(tok), jcfg)
    cfg = port_cfg(jcfg)
    params = params_from_numpy(jparams, cfg, CPU, cast=True)
    assert params["blocks"][0]["moe"]["gate"].dtype == torch.bfloat16
    got = forward(params, torch.from_numpy(tok), cfg)
    assert np.array_equal(got["severity"].argmax(-1).numpy(),
                          np.asarray(want["severity"]).argmax(-1))
    for h in HEADS:
        np.testing.assert_allclose(got[h].float().numpy(),
                                   np.asarray(want[h], np.float32),
                                   atol=1e-1, err_msg=h)
    assert abs(float(got["moe_aux"]) - float(want["moe_aux"])) <= 5e-2


@pytest.mark.parametrize("impl", ["flash", "dense"])
def test_moe_encoder_grads_match_jax(jparams, impl):
    jcfg = dataclasses.replace(JCFG, attn_impl=impl)
    data = TextClassificationData(synthetic_examples(24, seed=2), 8,
                                  seq_len=JCFG.seq_len,
                                  vocab_size=JCFG.vocab_size)
    batch = next(data.epoch(0))
    want = jax_flat(jax.grad(jax_train.loss_fn)(
        jax.tree_util.tree_map(jnp.asarray, jparams),
        {k: jnp.asarray(v) for k, v in batch.items()}, jcfg))
    cfg = port_cfg(jcfg)
    state = train.init_state(params_from_numpy(jparams, cfg, CPU, cast=False),
                             train.make_optimizer())
    train.loss_fn(state.params, train.batch_to(batch, CPU), cfg).backward()
    for key, p in flatten_tree(state.params).items():
        g = p.grad.numpy() if p.grad is not None else np.zeros(p.shape)
        scale = max(1.0, float(np.abs(want[key]).max()))
        assert float(np.abs(g - want[key]).max()) / scale <= 1e-5, key
    gate_grad = state.params["blocks"][0]["moe"]["gate"].grad
    assert gate_grad is not None and float(gate_grad.abs().max()) > 0


def test_moe_training_lowers_the_loss(jparams):
    cfg = port_cfg(JCFG)
    state = train.init_state(params_from_numpy(jparams, cfg, CPU, cast=False),
                             train.make_optimizer(lr=1e-3))
    data = TextClassificationData(synthetic_examples(64, seed=4), 16,
                                  seq_len=cfg.seq_len,
                                  vocab_size=cfg.vocab_size)
    losses = []
    for epoch in range(3):
        for batch in data.epoch(epoch):
            state, loss = train.train_step(state, batch, cfg)
            losses.append(float(loss))
    assert losses[-1] < losses[0]
    out = forward(state.params, torch.from_numpy(tokens(4)), cfg)
    assert np.isfinite(float(out["moe_aux"]))


# ── serving an MoE checkpoint on one device ─────────────────────────


def test_moe_checkpoint_serves_like_the_jax_oracle(jparams, tmp_path):
    cfg = port_cfg(JCFG, dtype="float32")
    ckpt = str(tmp_path / "moe")
    port_pretrained.write_pretrained(ckpt, cfg, jparams)
    prompts = [f"MESSAGE:\n{t}\n\nIdentify issues" for t in texts(24, 9)]
    jax_pretrained.clear_cache()
    oracle = jax_serve.make_local_call_llm(
        ckpt, serve_cfg={"continuousBatching": False})
    want = [oracle(p) for p in prompts]
    try:
        oneshot = port_serve.make_local_call_llm(
            ckpt, serve_cfg={"continuousBatching": False}, device="cpu")
        batched = port_serve.make_local_call_llm(
            ckpt, serve_cfg={"windowMs": 0.0, "maxBatch": 8}, device="cpu")
        assert [oneshot(p) for p in prompts] == want
        assert [batched(p) for p in prompts] == want
        assert len(set(want)) > 1  # more than one verdict to agree on
    finally:
        port_serve.close_batchers()
        port_pretrained.clear_cache()
        jax_pretrained.clear_cache()
