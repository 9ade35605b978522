"""The port's device grid, sharding plan and ring attention against JAX.

``vainplex_openclaw_tpu_torch.parallel`` is single-controller: a ``Mesh``
is a grid of ``torch.device`` entries (``cpu`` repeated here, the
counterpart of the JAX suite's 8 virtual CPU devices), and
``ring_attention_local`` takes every shard of one ring at once. Each ring
is held against the JAX ``ring_attention`` over a JAX mesh of the same
shape (``impl="flash"``: the Pallas kernel in stats mode, run by its
interpreter) and against ``dense_attention_reference``, on inputs made from
a numpy seed: fp32 to 1e-5, bf16 to 5e-2 against the fp32 oracle.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vainplex_openclaw_tpu.parallel import mesh as jax_mesh
from vainplex_openclaw_tpu.parallel import plan as jax_plan
from vainplex_openclaw_tpu.parallel.ring_attention import (
    dense_attention_reference as jax_dense,
    ring_attention as jax_ring)
from vainplex_openclaw_tpu_torch.models.encoder import (
    EncoderConfig, forward, init_params)
from vainplex_openclaw_tpu_torch.ops import flash_attention as fa
from vainplex_openclaw_tpu_torch.parallel import plan
from vainplex_openclaw_tpu_torch.parallel.mesh import (
    CPU_MESH_DEVICES, Mesh, _factor, cached_mesh, make_mesh)
from vainplex_openclaw_tpu_torch.parallel.ring_attention import (
    NEG_INF, dense_attention_reference, ring_attention, ring_attention_local)

CPU = torch.device("cpu")


def qkv(seed, B=4, H=2, L=32, Dh=16, lengths=None):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, L, Dh)).astype(np.float32)
               for _ in range(3))
    lengths = [L] * B if lengths is None else lengths
    mask = np.arange(L)[None, :] < np.asarray(lengths)[:, None]
    return q, k, v, mask


def torch_mesh(shape):
    return make_mesh(axes=("dp", "sp"), shape=shape, device="cpu")


def jax_ring_mesh(shape):
    return jax_mesh.make_mesh(int(np.prod(shape)), axes=("dp", "sp"),
                              shape=shape)


# ── the device grid ──────────────────────────────────────────────────────

@pytest.mark.parametrize("n", range(1, 33))
def test_factor_equals_jax(n):
    assert _factor(n) == jax_mesh._factor(n)


@pytest.mark.parametrize("axes,shape", [
    (("dp", "tp"), None), (("dp",), None), (("dp", "sp"), (2, 4)),
    (("dp", "sp"), (1, 8)), (("dp", "tp", "sp"), None)])
def test_make_mesh_shapes_equal_jax(axes, shape):
    got = make_mesh(axes=axes, shape=shape, device="cpu")
    want = jax_mesh.make_mesh(axes=axes, shape=shape)
    assert got.shape == dict(want.shape)
    assert got.size == want.size == CPU_MESH_DEVICES
    assert set(got.devices) == {CPU}


def test_mesh_is_hashable_and_cached():
    a = cached_mesh((2, 4), ("dp", "sp"), "cpu")
    assert a is cached_mesh((2, 4), ("dp", "sp"), "cpu")
    assert a == torch_mesh((2, 4)) and hash(a) == hash(torch_mesh((2, 4)))
    assert a != torch_mesh((4, 2))
    assert {a: 1}[torch_mesh((2, 4))] == 1


def test_mesh_grid_and_device_index():
    meta = torch.device("meta")
    m = Mesh((CPU, meta, CPU, meta), (2, 2), ("dp", "sp"))
    assert m.grid("dp", "sp") == [[CPU, torch.device("meta")]] * 2
    assert m.device(dp=1, sp=1) == torch.device("meta")
    assert m.distinct_devices() == (CPU, torch.device("meta"))
    with pytest.raises(IndexError):
        m.device(sp=2)
    with pytest.raises(ValueError, match="lack"):
        m.grid("dp", "tp")
    three = make_mesh(axes=("dp", "tp", "sp"), shape=(2, 2, 2), device="cpu")
    with pytest.raises(ValueError, match="not spanned"):
        three.grid("dp", "sp")


def test_make_mesh_refuses_more_devices_than_the_pool():
    with pytest.raises(ValueError, match="requested 9 devices, have 8"):
        make_mesh(axes=("dp", "sp"), shape=(3, 3), device="cpu")
    with pytest.raises(ValueError, match="requested 4 devices, have 2"):
        make_mesh(axes=("dp", "sp"), shape=(1, 4), devices=["cpu", "cpu"])


def test_explicit_devices_may_repeat():
    m = make_mesh(axes=("dp", "sp"), shape=(1, 4), devices=["cpu"] * 4)
    assert m.devices == (CPU,) * 4 and m.shape == {"dp": 1, "sp": 4}


@pytest.mark.parametrize("bad", [
    dict(devices=(CPU,) * 4, dims=(2, 4), axis_names=("dp", "sp")),
    dict(devices=(CPU,) * 4, dims=(4,), axis_names=("dp", "sp")),
    dict(devices=(CPU,) * 4, dims=(2, 2), axis_names=("dp", "dp"))])
def test_mesh_rejects_inconsistent_grids(bad):
    with pytest.raises(ValueError):
        Mesh(**bad)


def test_cuda_mesh_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(axes=("dp", "sp"), shape=(1, 1))


# ── the sharding plan ────────────────────────────────────────────────────

def test_long_plan_equals_jax():
    got = plan.resolve_plan("encoder_validator_long")
    want = jax_plan.PLAN_TABLE["encoder_validator_long"]
    for name in ("family", "axes", "runner", "gather", "bucket_min",
                 "microbatches", "source"):
        assert getattr(got, name) == getattr(want, name), name
    assert got.data_spec == tuple(want.data_spec)
    assert [spec for _, spec in got.rules] == \
        [tuple(spec) for _, spec in want.rules] == [()]
    short, jshort = plan.short_path_plan(got), jax_plan.short_path_plan(want)
    assert (short.runner, short.gather, short.data_spec) == \
        (jshort.runner, jshort.gather, tuple(jshort.data_spec))
    assert short.description == jshort.description
    assert plan.short_path_plan(short) is short
    assert plan.resolve_plan(got) is got


@pytest.mark.parametrize("family", [
    "encoder_validator", "embeddings_forward", "encoder_validator_pp",
    "encoder_validator_moe", "embeddings_forward_moe"])
def test_unported_families_raise(family):
    """Once unported, each family now resolves to the JAX plan and serves:
    its mesh forward on a grid of its axes equals the single-device
    forward (fp32, 1e-5)."""
    got, want = plan.resolve_plan(family), jax_plan.PLAN_TABLE[family]
    for name in ("family", "axes", "runner", "gather", "bucket_min",
                 "microbatches", "source", "description"):
        assert getattr(got, name) == getattr(want, name), name
    assert got.data_spec == tuple(want.data_spec)
    assert [(pat, spec) for pat, spec in got.rules] == \
        [(pat, tuple(spec)) for pat, spec in want.rules]
    cfg = EncoderConfig(vocab_size=512, seq_len=16, d_model=64, n_heads=4,
                        n_layers=2, d_ff=128, dtype="float32",
                        n_experts=4 if "moe" in family else 0)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    mesh = make_mesh(axes=got.axes, shape=(2,) * len(got.axes),
                     device="cpu")
    tok = np.random.default_rng(1).integers(0, 512, size=(4, 16))
    with torch.inference_mode():
        out = plan.serve_forward(
            plan.place_params(params, mesh, family),
            plan.place_tokens(tok, mesh, family), cfg, mesh, family)
        ref = forward(params, torch.from_numpy(tok), cfg)
    for head in ("severity", "keep", "mood", "embedding", "moe_aux"):
        torch.testing.assert_close(out[head], ref[head], atol=1e-5, rtol=0)


def test_unknown_family_raises_key_error():
    with pytest.raises(KeyError):
        plan.resolve_plan("no_such_family")


@pytest.mark.parametrize("shape", [(1, 1), (2, 4), (1, 8), (4, 2), (8, 1)])
@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 13, 32])
def test_serve_bucket_equals_jax(shape, n):
    got = plan.serve_bucket(n, torch_mesh(shape),
                            plan="encoder_validator_long")
    want = jax_plan.serve_bucket(n, jax_ring_mesh(shape),
                                 plan="encoder_validator_long")
    assert got == want


def test_place_tokens_splits_batch_over_dp_and_sequence_over_sp():
    mesh = torch_mesh((2, 4))
    tokens = np.arange(4 * 32, dtype=np.int32).reshape(4, 32)
    shards = plan.place_tokens(tokens, mesh, "encoder_validator_long")
    assert len(shards) == 2 and all(len(r) == 4 for r in shards)
    for i in range(2):
        for j in range(4):
            np.testing.assert_array_equal(
                shards[i][j].numpy(), tokens[2 * i:2 * i + 2, 8 * j:8 * j + 8])
    short = plan.short_path_plan(plan.resolve_plan("encoder_validator_long"))
    rows = plan.place_tokens(tokens, mesh, short)
    assert [len(r) for r in rows] == [1, 1]
    np.testing.assert_array_equal(rows[1][0].numpy(), tokens[2:])
    with pytest.raises(ValueError, match="serve_bucket"):
        plan.place_tokens(tokens[:3], mesh, "encoder_validator_long")


def test_sharded_params_cached_per_key_mesh_and_params():
    plan.clear_plan_caches()
    mesh = torch_mesh((2, 4))
    params = {"a": torch.ones(2), "b": [torch.zeros(1)]}
    placed = plan.sharded_params("k", params, mesh, "encoder_validator_long")
    # keyed by grid position, one tree per (dp row, sp column)
    assert [len(row) for row in placed.trees] == [4, 4]
    assert placed.grid == [[CPU] * 4] * 2
    # replicated leaves already on their device are shared, not copied
    assert all(t["a"] is params["a"] for row in placed.trees for t in row)
    assert plan.sharded_params("k", params, mesh,
                               "encoder_validator_long") is placed
    reloaded = {"a": torch.ones(2), "b": [torch.zeros(1)]}
    assert plan.sharded_params("k", reloaded, mesh,
                               "encoder_validator_long") is not placed
    assert plan.drop_sharded_params("k") == 1
    assert plan.drop_sharded_params("k") == 0


# ── ring attention against JAX ───────────────────────────────────────────

RING_CASES = [
    # (name, mesh shape, B, L, per-row valid lengths)
    ("full_2x4", (2, 4), 4, 32, None),
    ("padding_2x4", (2, 4), 4, 32, [32, 17, 7, 25]),
    ("sp_only_1x8", (1, 8), 2, 64, [64, 40]),
    ("unaligned_120_2x4", (2, 4), 4, 120, [120, 77, 30, 101]),
    ("fully_masked_row_2x4", (2, 4), 4, 32, [32, 0, 9, 0]),
]


@pytest.mark.parametrize("impl", ["flash", "dense"])
@pytest.mark.parametrize("case", RING_CASES, ids=[c[0] for c in RING_CASES])
def test_ring_matches_jax_ring_and_dense_reference(case, impl):
    name, shape, B, L, lengths = case
    q, k, v, mask = qkv(len(name), B=B, L=L, lengths=lengths)
    out = ring_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                         torch.from_numpy(mask), torch_mesh(shape), impl=impl)
    assert out.dtype == torch.float32 and tuple(out.shape) == q.shape
    got = out.numpy()
    assert np.isfinite(got).all()
    want_ring = np.asarray(jax_ring(
        *(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(mask),
        jax_ring_mesh(shape), impl="flash"))
    want_dense = np.asarray(jax_dense(*(jnp.asarray(x) for x in (q, k, v)),
                                      jnp.asarray(mask)))
    valid = mask.any(axis=1)[:, None, None, None]
    np.testing.assert_allclose(got * valid, want_ring * valid, atol=1e-5)
    np.testing.assert_allclose(got * valid, want_dense * valid, atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 4), (1, 8)])
def test_causal_ring_goes_dense_and_stays_exact(shape, monkeypatch):
    q, k, v, mask = qkv(2, B=2 * shape[0], L=32)
    calls = []
    monkeypatch.setattr(
        "vainplex_openclaw_tpu_torch.parallel.ring_attention.flash_attention",
        lambda *a, **kw: calls.append(1))
    out = ring_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                         torch.from_numpy(mask), torch_mesh(shape),
                         causal=True, impl="flash")
    assert calls == []  # the kernel's causal mask is block-local
    want = np.asarray(jax_ring(*(jnp.asarray(x) for x in (q, k, v)),
                               jnp.asarray(mask), jax_ring_mesh(shape),
                               causal=True, impl="flash"))
    np.testing.assert_allclose(out.numpy(), want, atol=1e-5)
    ref = dense_attention_reference(*(torch.from_numpy(x) for x in (q, k, v)),
                                    torch.from_numpy(mask), causal=True)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-5)


def test_ring_bf16_against_fp32_oracle():
    q, k, v, mask = qkv(5, B=2, L=64)
    out = ring_attention(*(torch.from_numpy(x).to(torch.bfloat16)
                           for x in (q, k, v)),
                         torch.from_numpy(mask), torch_mesh((1, 8)),
                         impl="flash")
    assert out.dtype == torch.bfloat16
    want = np.asarray(jax_dense(*(jnp.asarray(x) for x in (q, k, v)),
                                jnp.asarray(mask)))
    np.testing.assert_allclose(out.float().numpy(), want, atol=5e-2)


def test_dense_attention_reference_equals_jax():
    q, k, v, mask = qkv(3, L=24, lengths=[24, 5, 0, 13])
    for causal in (False, True):
        got = dense_attention_reference(
            *(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(mask),
            causal=causal)
        want = np.asarray(jax_dense(*(jnp.asarray(x) for x in (q, k, v)),
                                    jnp.asarray(mask), causal=causal))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_flash_ring_calls_the_stats_kernel_once_per_shard_and_rotation(
        monkeypatch):
    """sp query shards × sp rotations: the count ``forward_long`` launches
    per layer and dp row on the card."""
    seen = []
    real = fa.flash_attention

    def spy(q, k, v, kv_mask=None, **kw):
        seen.append((kw.get("return_stats"), k.data_ptr()))
        return real(q, k, v, kv_mask, **kw)

    monkeypatch.setattr(
        "vainplex_openclaw_tpu_torch.parallel.ring_attention.flash_attention",
        spy)
    q, k, v, mask = qkv(4, B=2, L=32)
    ring_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                   torch.from_numpy(mask), torch_mesh((2, 4)), impl="flash")
    assert len(seen) == 2 * 4 * 4
    assert all(stats for stats, _ in seen)


def test_rotation_order():
    """After i rotations shard j holds the block that started on shard
    (j - i) mod sp: with one-hot values per block, each query shard's
    accumulation order is visible through a causal mask that admits only
    keys of earlier blocks."""
    sp, Lb = 4, 2
    q = torch.zeros((1, 1, sp * Lb, 16))
    k = torch.zeros_like(q)
    v = torch.zeros_like(q)
    for blk in range(sp):
        v[..., blk * Lb:(blk + 1) * Lb, blk] = 1.0
    mask = torch.ones((1, sp * Lb), dtype=torch.bool)
    out = ring_attention(q, k, v, mask, torch_mesh((1, sp)), causal=True)
    for blk in range(sp):
        row = out[0, 0, blk * Lb + Lb - 1, :sp]
        # a row attends uniformly to every key up to itself
        want = torch.zeros(sp)
        want[:blk] = Lb
        want[blk] = Lb
        want = want / want.sum()
        torch.testing.assert_close(row, want)


def test_fully_masked_carry_stays_finite_through_every_rotation():
    """m starts at -1e30 and l at 0; a row with no valid key anywhere
    merges -1e30 partials each rotation and comes out finite."""
    q, k, v, mask = qkv(7, B=2, L=32, lengths=[0, 0])
    qs, ks, vs = ([torch.from_numpy(x)[:, :, 8 * j:8 * j + 8].contiguous()
                   for j in range(4)] for x in (q, k, v))
    masks = [torch.from_numpy(mask)[:, 8 * j:8 * j + 8] for j in range(4)]
    outs = ring_attention_local(qs, ks, vs, masks, [CPU] * 4, impl="flash")
    assert all(torch.isfinite(o).all() for o in outs)
    assert NEG_INF == -1e30


def test_ring_rejects_mismatched_shards():
    x = torch.zeros((1, 1, 8, 16))
    m = torch.ones((1, 8), dtype=torch.bool)
    with pytest.raises(ValueError, match="one q, k, v"):
        ring_attention_local([x, x], [x], [x], [m], [CPU])
    with pytest.raises(ValueError, match="impl"):
        ring_attention_local([x], [x], [x], [m], [CPU], impl="ring")
    with pytest.raises(ValueError, match="does not split"):
        ring_attention(x, x, x, m, torch_mesh((2, 4)))


def test_plan_dataclass_is_frozen():
    p = plan.resolve_plan("encoder_validator_long")
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.runner = "forward"
