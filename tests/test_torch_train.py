"""Training in the port against the JAX package's training path.

- The attention Function (``_Flash``, K1 and K2 modes):
  gradients against ``jax.vjp`` through the JAX ``flash_attention(...,
  interpret=True)``, whose custom VJP recomputes the block densely, with
  prefix and hole masks, a fully masked row and causal attention, under one
  seeded cotangent. fp32 within 1e-5 of max(1, max |g|); bf16 within 1.5e-2
  of it (the bf16 cotangents of the products round at other points than
  XLA's). A control: a backward that rounds the scores to bf16 before the
  fp32 softmax, as ``_dense_stats_ref`` reads, misses JAX's bf16 stats
  gradients by more than 0.1, since XLA keeps that product in fp32.
- One-step encoder gradients against ``jax.grad(loss_fn)`` for
  ``attn_impl`` "flash" and "dense" (fp32: every leaf within 1e-5 of
  max(1, max |g|)).
- AdamW against ``optax.adamw`` fed the same gradients (params within
  1e-6), apart from the gradients, since Adam turns a 1e-8 difference in a
  near-zero gradient into an update of order lr.
- A 5-step fp32 loss trajectory against the JAX ``train_step`` (1e-5
  relative), identical data batches, ``evaluate`` parity, bit-exact
  interrupt + resume, the refusal of a dataset smaller than one batch,
  TrainState checkpoints crossing both ways bit for bit, and
  ``train_and_ship`` writing a checkpoint the JAX loader reads.

Inputs come from numpy seeds; weights from the JAX ``init_params`` carried
across as numpy arrays.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vainplex_openclaw_tpu.models import EncoderConfig as JaxConfig
from vainplex_openclaw_tpu.models import checkpoint as jax_ckpt
from vainplex_openclaw_tpu.models import data as jax_data
from vainplex_openclaw_tpu.models import init_params as jax_init_params
from vainplex_openclaw_tpu.models import pretrained as jax_pretrained
from vainplex_openclaw_tpu.models import train as jax_train
from vainplex_openclaw_tpu.ops.flash_attention import (
    flash_attention as jax_flash_attention)
from vainplex_openclaw_tpu_torch.models import checkpoint as port_ckpt
from vainplex_openclaw_tpu_torch.models import data as port_data
from vainplex_openclaw_tpu_torch.models import pretrained as port_pretrained
from vainplex_openclaw_tpu_torch.models import train
from vainplex_openclaw_tpu_torch.models.encoder import (
    EncoderConfig, flatten_tree, forward, params_from_numpy, unflatten_tree)
from vainplex_openclaw_tpu_torch.ops import _build
from vainplex_openclaw_tpu_torch.ops import flash_attention as fa
from test_torch_chip_smoke_bounds import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
JCFG = JaxConfig(vocab_size=512, seq_len=32, d_model=64, n_heads=4,
                 n_layers=2, d_ff=128, dtype=jnp.float32, attn_impl="dense")
GRAD_TOL = {"float32": 1e-5, "bfloat16": 1.5e-2}


def port_cfg(jcfg, **over) -> EncoderConfig:
    d = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    d["dtype"] = jnp.dtype(jcfg.dtype).name
    d.update(over)
    return EncoderConfig(**d)


PCFG = port_cfg(JCFG)


def to_numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_flat(tree) -> dict:
    return {jax_ckpt._path_key(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def port_flat(tree) -> dict:
    out = {}
    for k, v in flatten_tree(tree).items():
        if isinstance(v, torch.Tensor):
            v = v.detach().float().numpy() if v.dtype == torch.bfloat16 \
                else v.detach().numpy()
        out[k] = np.asarray(v)
    return out


def rel_err(got: np.ndarray, want: np.ndarray) -> float:
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    return float(np.abs(np.asarray(got, np.float32) - want).max()) / scale


def dataset(n=48, batch=8, seed=7, lib=port_data):
    return lib.TextClassificationData(
        lib.synthetic_examples(n, seed=seed), batch_size=batch,
        seq_len=JCFG.seq_len, vocab_size=JCFG.vocab_size)


def jax_params(seed=0, jcfg=JCFG):
    return jax_init_params(jax.random.PRNGKey(seed), jcfg)


def port_state(jparams, cfg=PCFG):
    init = params_from_numpy(to_numpy_tree(jparams), cfg, CPU, cast=False)
    return train.init_state(init, train.make_optimizer())


@pytest.fixture
def no_kernel_build(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a CPU call touched the kernel build")

    monkeypatch.setattr(_build, "load_library", refuse)
    monkeypatch.setattr(_build, "build", refuse)


# ── the attention Functions ─────────────────────────────────────────

# (name, B, H, L, Dh, mask kind, causal); L stays a multiple of 8, so the
# JAX wrapper pads no key and a fully masked row averages the same keys.
GRAD_CASES = [
    ("no_mask", 2, 2, 32, 16, None, False),
    ("prefix_and_empty_row", 3, 2, 32, 16, "prefix", False),
    ("holes", 2, 2, 40, 32, "holes", False),
    ("causal", 2, 2, 32, 16, None, True),
    ("causal_prefix", 3, 2, 24, 16, "prefix", True),
]


def grad_inputs(seed, B, H, L, Dh, mask_kind):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, L, Dh)).astype(np.float32)
               for _ in range(3))
    if mask_kind is None:
        mask = None
    elif mask_kind == "prefix":
        mask = np.arange(L)[None, :] < np.array([L, L // 3, 0][:B])[:, None]
    else:
        mask = rng.random((B, L)) < 0.5
        mask[:, 0] = False
    cot = [rng.standard_normal(s).astype(np.float32)
           for s in ((B, H, L, Dh), (B, H, L), (B, H, L))]
    return q, k, v, mask, cot


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stats", [False, True], ids=["k1", "k2"])
@pytest.mark.parametrize("case", GRAD_CASES, ids=[c[0] for c in GRAD_CASES])
def test_function_grads_match_jax_custom_vjp(case, stats, dtype,
                                             no_kernel_build):
    name, B, H, L, Dh, mask_kind, causal = case
    q, k, v, mask, cot = grad_inputs(len(name) + Dh, B, H, L, Dh, mask_kind)
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)
    jmask = None if mask is None else jnp.asarray(mask)

    def f(q_, k_, v_):
        return jax_flash_attention(q_, k_, v_, jmask, causal=causal,
                                   interpret=True, return_stats=stats)

    _, vjp = jax.vjp(f, *(jnp.asarray(x, jdt) for x in (q, k, v)))
    jcot = tuple(jnp.asarray(c) for c in cot) if stats \
        else jnp.asarray(cot[0], jdt)
    want = vjp(jcot)

    leaves = [torch.from_numpy(x).to(tdt).requires_grad_() for x in (q, k, v)]
    tmask = None if mask is None else torch.from_numpy(mask)
    out = fa.flash_attention(*leaves, tmask, causal=causal,
                             return_stats=stats)
    tcot = tuple(torch.from_numpy(c) for c in cot) if stats \
        else torch.from_numpy(cot[0]).to(tdt)
    got = torch.autograd.grad(out, leaves, tcot)
    for name_, g, w in zip("qkv", got, want):
        assert g.dtype == tdt
        err = rel_err(g.float().numpy(), np.asarray(w, np.float32))
        assert err <= GRAD_TOL[dtype], (name_, err)


@pytest.mark.parametrize("case", [GRAD_CASES[0], GRAD_CASES[2]],
                         ids=["no_mask", "holes"])
def test_rounded_scores_backward_misses_jax(case, monkeypatch,
                                            no_kernel_build):
    """The control: differentiate bf16-rounded scores in stats mode, and
    the gradients leave the tolerance the port's backward meets."""
    name, B, H, L, Dh, mask_kind, causal = case
    q, k, v, mask, cot = grad_inputs(len(name) + Dh, B, H, L, Dh, mask_kind)
    jmask = None if mask is None else jnp.asarray(mask)
    _, vjp = jax.vjp(lambda *a: jax_flash_attention(
        *a, jmask, causal=causal, interpret=True, return_stats=True),
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    want = vjp(tuple(jnp.asarray(c) for c in cot))

    def rounded(q_, k_, v_, bias, causal_, return_stats):
        s = (q_ @ k_.transpose(-1, -2)).float() / np.sqrt(Dh) \
            + bias[:, None, None, :]
        m = s.amax(dim=-1)
        p = torch.exp(s - m[..., None])
        return (p.to(v_.dtype) @ v_).float(), m, p.sum(dim=-1)

    monkeypatch.setattr(fa, "_plain", rounded)
    leaves = [torch.from_numpy(x).bfloat16().requires_grad_()
              for x in (q, k, v)]
    out = fa._Flash.apply(*leaves, fa._bias(
        None if mask is None else torch.from_numpy(mask), B, L, CPU), causal,
        True)
    got = torch.autograd.grad(out, leaves,
                              tuple(torch.from_numpy(c) for c in cot))
    worst = max(rel_err(g.float().numpy(), np.asarray(w, np.float32))
                for g, w in zip(got, want))
    assert worst > 0.1


def test_function_under_inference_mode_saves_nothing(no_kernel_build):
    q, k, v, mask, _ = grad_inputs(1, 2, 2, 32, 16, "prefix")
    args = [torch.from_numpy(x) for x in (q, k, v)]
    with torch.inference_mode():
        out = fa.flash_attention(*args, torch.from_numpy(mask))
    assert out.grad_fn is None and not out.requires_grad
    assert torch.equal(out, fa.flash_attention_reference(
        *args, torch.from_numpy(mask)))


def test_backward_adds_no_launch_and_builds_nothing(no_kernel_build):
    """Only a CUDA forward counts; the CPU forward and every backward run
    no kernel."""
    fa.launches = fa.stats_launches = 0
    q, k, v, mask, cot = grad_inputs(2, 2, 2, 32, 16, "prefix")
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*leaves, torch.from_numpy(mask))
    out.backward(torch.from_numpy(cot[0]))
    acc, m, l = fa.flash_attention(*leaves, torch.from_numpy(mask),
                                   return_stats=True)
    (acc.sum() + m.sum() + l.sum()).backward()
    assert fa.launches == 0 and fa.stats_launches == 0
    assert all(t.grad is not None and bool(t.grad.abs().sum() > 0)
               for t in leaves)


# ── the encoder's gradients ─────────────────────────────────────────


@pytest.mark.parametrize("impl", ["flash", "dense"])
def test_one_step_grads_match_jax(impl):
    jcfg = dataclasses.replace(JCFG, attn_impl=impl)
    jp = jax_params()
    batch = next(dataset(lib=jax_data).epoch(0))
    want = jax_flat(jax.grad(jax_train.loss_fn)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg))
    state = port_state(jp, port_cfg(jcfg))
    loss = train.loss_fn(state.params, train.batch_to(batch, CPU),
                         port_cfg(jcfg))
    loss.backward()
    got = {k: (p.grad.numpy() if p.grad is not None
               else np.zeros(p.shape, np.float32))
           for k, p in flatten_tree(state.params).items()}
    assert set(got) == set(want)
    for key in want:
        assert rel_err(got[key], want[key]) <= 1e-5, key


def test_every_attention_projection_gets_a_gradient():
    """The fault a kernel without autograd would hide: attention q, k, v
    must learn through the flash path (on the card the forward is K1)."""
    cfg = dataclasses.replace(PCFG, attn_impl="flash")
    state = port_state(jax_params(), cfg)
    batch = next(dataset().epoch(0))
    train.loss_fn(state.params, train.batch_to(batch, CPU), cfg).backward()
    for block in state.params["blocks"]:
        for name in ("q", "k", "v", "o"):
            g = block["attn"][name].grad
            assert g is not None and float(g.abs().max()) > 0, name


# ── the optimizer ───────────────────────────────────────────────────


def test_adamw_matches_optax_on_the_same_grads():
    rng = np.random.default_rng(3)
    shapes = {"w": (16, 8), "b": (8,), "untouched": (4, 4)}
    init = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
    opt = optax.adamw(3e-4, weight_decay=0.01)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = opt.init(jparams)
    leaves = {k: torch.from_numpy(v.copy()).requires_grad_()
              for k, v in init.items()}
    topt = train.make_optimizer()(list(leaves.values()))
    for step in range(5):
        grads = {k: (rng.standard_normal(s) * 10.0 ** -rng.integers(0, 8))
                 .astype(np.float32) for k, s in shapes.items()}
        grads["untouched"] = np.zeros(shapes["untouched"], np.float32)
        updates, jstate = opt.update({k: jnp.asarray(g) for k, g in
                                      grads.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in leaves.items():
            p.grad = torch.from_numpy(grads[k])
        topt.step()
        for k in shapes:
            np.testing.assert_allclose(leaves[k].detach().numpy(),
                                       np.asarray(jparams[k]), rtol=0,
                                       atol=1e-6, err_msg=f"{k} step {step}")
    # the zero-gradient leaf was decayed, as optax decays it
    assert not np.array_equal(leaves["untouched"].detach().numpy(),
                              init["untouched"])


def test_unreached_leaf_is_decayed_like_optax():
    """``heads/embed_proj`` gets no gradient from the loss; a train step
    still decays it, as optax's zero gradient does."""
    jp = jax_params()
    state = port_state(jp)
    before = state.params["heads"]["embed_proj"].detach().clone()
    state, _ = train.train_step(state, next(dataset().epoch(0)), PCFG)
    after = state.params["heads"]["embed_proj"].detach()
    np.testing.assert_allclose(after.numpy(), before.numpy() * (1 - 3e-4 * 0.01),
                               rtol=1e-7)


# ── the loop ────────────────────────────────────────────────────────


def test_five_step_loss_trajectory_matches_jax():
    jp = jax_params()
    opt = jax_train.make_optimizer()
    jstate = jax_train.init_state(jp, opt)
    state = port_state(jp)
    for i, batch in enumerate(dataset().epoch(0)):
        if i == 5:
            break
        jstate, jloss = jax_train.train_step(
            jstate, {k: jnp.asarray(v) for k, v in batch.items()}, JCFG, opt)
        state, loss = train.train_step(state, batch, PCFG)
        assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss)), i
    assert state.step == int(jstate.step) == 5


@pytest.mark.parametrize("seed", [0, 5])
def test_data_batches_equal_jax(seed):
    assert port_data.synthetic_examples(64, seed) == \
        jax_data.synthetic_examples(64, seed)
    assert port_data.synthetic_split(40, 24, seed) == \
        jax_data.synthetic_split(40, 24, seed)
    port, ref = (dataset(n=53, seed=seed, lib=lib)
                 for lib in (port_data, jax_data))
    for epoch in (0, 3):
        got, want = list(port.epoch(epoch)), list(ref.epoch(epoch))
        assert len(got) == len(want) == 6
        for a, b in zip(got, want):
            assert a.keys() == b.keys()
            assert all(np.array_equal(a[k], b[k]) for k in a)
    for (a, na), (b, nb) in zip(port.eval_batches(), ref.eval_batches()):
        assert na == nb and all(np.array_equal(a[k], b[k]) for k in a)


def test_evaluate_matches_jax():
    jp = jax_params()
    state = port_state(jp)
    data = dataset(n=30)
    got = train.evaluate(state.params, data, PCFG)
    want = jax_train.evaluate(jp, dataset(n=30, lib=jax_data), JCFG)
    assert got["n_examples"] == want["n_examples"] == 30
    for h in ("severity", "keep", "mood"):
        assert got[f"{h}_accuracy"] == want[f"{h}_accuracy"]
        assert abs(got[f"{h}_loss"] - want[f"{h}_loss"]) <= \
            1e-5 * want[f"{h}_loss"]


def _bits_equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


def test_interrupted_resume_equals_uninterrupted(tmp_path):
    """Train to 5 into a checkpoint dir, then resume the same dir to 11:
    identical to one run to 11, bit for bit (the mid-epoch resume skips
    the batches already consumed)."""
    jp = jax_params()
    whole = train.train_loop(port_state(jp), dataset(), PCFG, total_steps=11)
    ckpt = str(tmp_path / "ck")
    first = train.train_loop(port_state(jp), dataset(), PCFG, total_steps=5,
                             ckpt_dir=ckpt)
    assert first.step == 5 and port_ckpt.latest_step(ckpt) == 5
    resumed = train.train_loop(port_state(jp), dataset(), PCFG,
                               total_steps=11, ckpt_dir=ckpt)
    assert resumed.step == 11 and port_ckpt.latest_step(ckpt) == 11
    assert _bits_equal(port_flat(whole.to_tree()),
                       port_flat(resumed.to_tree()))


def test_dataset_smaller_than_batch_raises():
    with pytest.raises(ValueError, match="cannot fill one batch"):
        train.train_loop(port_state(jax_params()), dataset(n=4, batch=8),
                         PCFG, total_steps=3)


def test_loop_logs_loss_and_eval_and_saves_on_schedule(tmp_path):
    lines = []
    data = dataset()
    state = train.train_loop(port_state(jax_params()), data, PCFG,
                             total_steps=8, ckpt_dir=str(tmp_path),
                             save_every=3, eval_data=data, log=lines.append)
    assert state.step == 8
    assert port_ckpt.all_steps(str(tmp_path)) == [3, 6, 8]
    assert lines and "loss=" in lines[-1] and "eval sev=" in lines[-1]


# ── TrainState checkpoints across the packages ──────────────────────


def test_train_state_crosses_from_jax_bit_for_bit(tmp_path):
    jp = jax_params()
    like = port_state(jp)  # before train_step donates jp's buffers
    opt = jax_train.make_optimizer()
    jstate = jax_train.init_state(jp, opt)
    for batch in list(dataset(lib=jax_data).epoch(0))[:3]:
        jstate, _ = jax_train.train_step(
            jstate, {k: jnp.asarray(v) for k, v in batch.items()}, JCFG, opt)
    jax_ckpt.save_checkpoint(str(tmp_path), jstate)
    restored = train.restore_state(str(tmp_path), like)
    assert restored.step == 3
    assert _bits_equal(port_flat(restored.to_tree()), jax_flat(jstate))
    # and it trains on: one more step on each side agrees
    batch = list(dataset().epoch(0))[3]
    jstate, jloss = jax_train.train_step(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}, JCFG, opt)
    restored, loss = train.train_step(restored, batch, PCFG)
    assert abs(float(loss) - float(jloss)) <= 1e-5 * float(jloss)


@pytest.mark.parametrize("steps", [0, 3])
def test_train_state_crosses_to_jax_bit_for_bit(tmp_path, steps):
    jp = jax_params()
    state = port_state(jp)
    for batch in list(dataset().epoch(0))[:steps]:
        state, _ = train.train_step(state, batch, PCFG)
    train.save_state(str(tmp_path), state)
    opt = jax_train.make_optimizer()
    like = jax_train.init_state(jp, opt)
    jstate = jax_ckpt.restore_checkpoint(str(tmp_path), like=like)
    assert int(jstate.step) == steps
    assert _bits_equal(jax_flat(jstate), port_flat(state.to_tree()))
    keys = set(jax_flat(jstate))
    assert {"step", "opt_state/0/count", "params/embed/tok",
            "opt_state/0/mu/embed/tok", "opt_state/0/nu/embed/tok"} <= keys


@pytest.mark.parametrize("fault", ["missing", "extra"])
def test_restore_rejects_missing_and_extra_leaves(tmp_path, fault):
    state = port_state(jax_params())
    tree = state.to_tree()
    if fault == "missing":
        del tree["opt_state"][0]["count"]
    else:
        tree["opt_state"][0]["other"] = np.zeros(2, np.float32)
    port_ckpt.save_checkpoint(str(tmp_path), tree, step=0)
    with pytest.raises(KeyError, match=fault):
        train.restore_state(str(tmp_path), state)


# ── train_and_ship ──────────────────────────────────────────────────


def _dir_digest(path: str) -> dict:
    out = {}
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name), "rb") as f:
            out[name] = hashlib.sha256(f.read()).hexdigest()
    return out


def test_train_and_ship_writes_what_the_jax_loader_reads(tmp_path,
                                                        one_torch_thread):
    shipped_before = _dir_digest(port_pretrained.DEFAULT_DIR)
    with pytest.raises(TypeError):
        port_pretrained.train_and_ship()  # out_dir is required
    with pytest.raises(ValueError, match="shipped"):
        port_pretrained.train_and_ship(port_pretrained.DEFAULT_DIR,
                                       device="cpu")
    if not torch.cuda.is_available():  # device=None means the card
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_pretrained.train_and_ship(str(tmp_path / "no_card"))
    out = str(tmp_path / "tiny")
    # one epoch of the recipe (64 of its 600 steps) already clears the bar
    metrics = port_pretrained.train_and_ship(out, total_steps=64,
                                             device="cpu")
    assert _dir_digest(port_pretrained.DEFAULT_DIR) == shipped_before
    assert port_ckpt.all_steps(out) == [64]
    assert metrics["keep_accuracy"] >= 0.9
    assert metrics["severity_accuracy"] >= 0.9
    with open(os.path.join(out, "config.json"), encoding="utf-8") as f:
        meta = json.load(f)
    assert meta["eval"] == pytest.approx(
        {k: float(v) for k, v in metrics.items()})
    assert meta["eval"]["n_examples"] == 512
    prov = meta["provenance"]
    assert prov["trained_by"].endswith("pretrained.py:train_and_ship")
    assert prov["trained_by"].startswith("vainplex_openclaw_tpu_torch/")
    assert "noun-disjoint" in prov["heldout_protocol"]
    assert prov["total_steps"] == 64 and prov["batch_size"] == 64
    # float16 params only, no optimizer state
    flat = port_ckpt.read_checkpoint(out)
    assert all(k.startswith(("embed/", "blocks/", "final_norm/", "heads/"))
               and v.dtype == np.float16 for k, v in flat.items())

    # the JAX loader reads it, and the JAX evaluation clears the same bar
    jax_pretrained.clear_cache()
    jcfg, jparams = jax_pretrained.load_pretrained(out)
    assert jcfg == jax_pretrained.TINY_CONFIG
    heldout = jax_data.TextClassificationData(
        jax_data.synthetic_split(4608 - 512, 512, seed=0)[1], 64,
        seq_len=jcfg.seq_len, vocab_size=jcfg.vocab_size)
    jax_metrics = jax_train.evaluate(jparams, heldout, jcfg)
    for h in ("severity", "keep", "mood"):
        # the JAX loader casts to bf16 and runs its dense attention: the
        # argmax agrees on all but a few of 512 rows
        assert abs(jax_metrics[f"{h}_accuracy"] -
                   metrics[f"{h}_accuracy"]) <= 4 / 512, h
    assert jax_metrics["keep_accuracy"] >= 0.9
    assert jax_metrics["severity_accuracy"] >= 0.9
    jax_pretrained.clear_cache()


def test_shipped_checkpoint_trains_on_from_its_weights():
    """The shipped fp32 masters (float16 on disk) train on in the port: a
    step from them moves every leaf and lowers nothing to NaN."""
    cfg, _ = port_pretrained.load_pretrained(device="cpu")
    flat = {k: torch.as_tensor(v).float() for k, v in
            port_ckpt.read_checkpoint(port_pretrained.DEFAULT_DIR).items()}
    state = train.init_state(unflatten_tree(flat), train.make_optimizer())
    data = port_data.TextClassificationData(
        port_data.synthetic_examples(64, seed=3), 64, seq_len=cfg.seq_len,
        vocab_size=cfg.vocab_size)
    state, loss = train.train_step(state, next(data.epoch(0)), cfg)
    assert np.isfinite(float(loss))
    moved = [k for k, v in flatten_tree(state.params).items()
             if not torch.equal(v.detach(), flat[k])]
    assert len(moved) == len(flat)
    with torch.no_grad():
        out = forward(state.params, torch.zeros((1, cfg.seq_len),
                                                dtype=torch.int32), cfg)
    assert all(bool(torch.isfinite(out[h]).all()) for h in out)
