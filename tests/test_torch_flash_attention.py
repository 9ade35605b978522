"""The port's attention module against the JAX Pallas kernel.

``vainplex_openclaw_tpu_torch.ops.flash_attention`` on CPU tensors computes
the kernel's plain version; here it is held against the JAX package's
``flash_attention(..., interpret=True)`` (the Pallas kernel run by its
interpreter) on the same inputs, made from a numpy seed. Tolerances: fp32
1e-5, bf16 3e-2 (the JAX suite's own bf16 bound). Only rows with at least
one valid key are compared — a fully masked row's JAX value depends on the
TPU's block padding — and every row must be finite. The CUDA kernel itself
is held against the same plain version on the card by ``chip_smoke.py``.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vainplex_openclaw_tpu.ops import flash_attention as jax_fa
from vainplex_openclaw_tpu.ops.flash_attention import (
    flash_attention as jax_flash_attention)
from vainplex_openclaw_tpu.parallel import mesh as jax_mesh
from vainplex_openclaw_tpu.parallel.ring_attention import (
    ring_attention as jax_ring)
from vainplex_openclaw_tpu_torch.ops import _build
from vainplex_openclaw_tpu_torch.ops import flash_attention as fa
from vainplex_openclaw_tpu_torch.parallel.mesh import make_mesh
from vainplex_openclaw_tpu_torch.parallel.ring_attention import ring_attention

TOL = {"float32": 1e-5, "bfloat16": 3e-2}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}

# (name, B, H, Lq, Lk, Dh, valid key counts per batch row or None, causal)
CASES = [
    ("full_mask", 2, 4, 64, 64, 32, None, False),
    ("padding_mask", 2, 4, 64, 64, 32, [64, 37], False),
    ("causal", 2, 4, 64, 64, 32, None, True),
    ("causal_padding", 2, 2, 48, 48, 16, [48, 20], True),
    ("cross_length", 2, 4, 32, 64, 32, None, False),
    ("cross_length_masked", 2, 2, 40, 72, 16, [72, 9], False),
    ("unaligned_100", 2, 2, 100, 100, 16, [100, 41], False),
    ("fully_masked_rows", 4, 4, 64, 64, 16, [64, 20, 0, 0], False),
    ("head_dim_16", 2, 4, 64, 64, 16, [64, 30], False),
    ("head_dim_64", 2, 2, 64, 64, 64, [64, 50], False),
    # Dh 8 is a compiled width; Dh 24 runs zero-padded to 32 on the card
    ("head_dim_8_masked", 2, 4, 64, 64, 8, [64, 23], False),
    ("head_dim_8_ragged", 3, 2, 100, 72, 8, [72, 9, 0], False),
    ("head_dim_8_causal", 2, 2, 48, 48, 8, [48, 20], True),
    ("head_dim_24_masked", 2, 2, 64, 64, 24, [64, 30], False),
    ("head_dim_24_ragged", 3, 2, 100, 72, 24, [72, 41, 0], False),
    ("head_dim_24_causal", 2, 2, 48, 48, 24, None, True),
]


def make_inputs(seed, B, H, Lq, Lk, Dh, lengths):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Lq, Dh)).astype(np.float32)
    k = rng.standard_normal((B, H, Lk, Dh)).astype(np.float32)
    v = rng.standard_normal((B, H, Lk, Dh)).astype(np.float32)
    mask = None if lengths is None else \
        np.arange(Lk)[None, :] < np.asarray(lengths)[:, None]
    return q, k, v, mask


def valid_rows(mask, B, Lq, Lk, causal):
    """[B, 1, Lq, 1]: rows that see at least one valid key."""
    m = np.ones((B, Lk), bool) if mask is None else mask
    if causal:
        seen = np.cumsum(m, axis=1)[:, :Lq] > 0
    else:
        seen = np.broadcast_to(m.any(axis=1, keepdims=True), (B, Lq))
    return seen[:, None, :, None]


@pytest.fixture
def no_kernel_build(monkeypatch):
    """A CPU call must never reach the kernel library."""
    def refuse(*a, **kw):
        raise AssertionError("CPU path touched the kernel build")

    monkeypatch.setattr(_build, "load_library", refuse)
    monkeypatch.setattr(_build, "build", refuse)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_version_matches_pallas_interpreter(case, dtype, no_kernel_build):
    name, B, H, Lq, Lk, Dh, lengths, causal = case
    q, k, v, mask = make_inputs(len(name) * 7 + Dh, B, H, Lq, Lk, Dh, lengths)
    tdt, jdt = DTYPES[dtype]
    ref = jax_flash_attention(
        *(jnp.asarray(x).astype(jdt) for x in (q, k, v)),
        None if mask is None else jnp.asarray(mask), causal=causal,
        interpret=True)
    before = fa.launches
    out = fa.flash_attention(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
        None if mask is None else torch.from_numpy(mask), causal=causal)
    assert fa.launches == before  # the CPU path launches nothing
    assert out.dtype == tdt and tuple(out.shape) == (B, H, Lq, Dh)
    got = out.float().numpy()
    assert np.isfinite(got).all()
    rows = valid_rows(mask, B, Lq, Lk, causal)
    want = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(got * rows, want * rows, atol=TOL[dtype],
                               rtol=0)


def test_reference_equals_cpu_wrapper(no_kernel_build):
    q, k, v, mask = make_inputs(3, 2, 4, 64, 64, 16, [64, 11])
    args = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)]
    m = torch.from_numpy(mask)
    assert torch.equal(fa.flash_attention(*args, m),
                       fa.flash_attention_reference(*args, m))


def test_fully_masked_row_averages_values():
    """Every score at -1e30 → every p = exp(0) = 1: the row is the mean of
    V, finite, where -inf would give NaN."""
    q, k, v, _ = make_inputs(5, 1, 2, 8, 8, 16, None)
    mask = torch.zeros((1, 8), dtype=torch.bool)
    out = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), mask)
    np.testing.assert_allclose(out.numpy(),
                               np.broadcast_to(v.mean(axis=2, keepdims=True),
                                               out.shape), atol=1e-6)


def test_bias_row_is_finite_neg_1e30():
    mask = torch.tensor([[True, False, True]])
    bias = fa._bias(mask, 1, 3, torch.device("cpu"))
    assert bias.dtype == torch.float32
    assert bias.tolist() == [[0.0, float(np.float32(-1e30)), 0.0]]
    assert torch.isfinite(bias).all()


@pytest.mark.parametrize("bad", [
    "causal_lengths", "head_dim", "dtype", "mixed_dtype", "non_contiguous",
    "mask_shape", "rank", "empty"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    q = torch.zeros((2, 2, 8, 16))
    k = torch.zeros((2, 2, 8, 16))
    v = torch.zeros((2, 2, 8, 16))
    mask, causal = None, False
    if bad == "causal_lengths":
        k = v = torch.zeros((2, 2, 12, 16))
        causal = True
    elif bad == "head_dim":  # k and v at another head dim than q
        k = v = torch.zeros((2, 2, 8, 129))
    elif bad == "dtype":
        q = k = v = torch.zeros((2, 2, 8, 16), dtype=torch.float16)
    elif bad == "mixed_dtype":
        k = k.to(torch.bfloat16)
    elif bad == "non_contiguous":
        q = torch.zeros((2, 8, 2, 16)).transpose(1, 2)
    elif bad == "mask_shape":
        mask = torch.ones((2, 9), dtype=torch.bool)
    elif bad == "rank":
        q = torch.zeros((2, 8, 16))
    elif bad == "empty":
        k = v = torch.zeros((2, 2, 0, 16))
    with pytest.raises((ValueError, TypeError)):
        fa.flash_attention(q, k, v, mask, causal=causal)


def test_non_cpu_non_cuda_device_raises():
    q = torch.zeros((1, 1, 8, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention(q, q, q)


def test_build_is_lazy_and_keyed_by_source_hash():
    """Importing the module builds nothing; the library name carries a
    hash of the source and flags, under the repository's build/ folder."""
    path = _build.library_path("flash_attention")
    assert path.startswith(_build.BUILD_DIR)
    assert _build.BUILD_DIR.endswith("build/torch_kernels")
    assert path == _build.library_path("flash_attention")
    assert "-gencode" in _build.NVCC_FLAGS and \
        "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert not _build._libs  # nothing loaded on the CPU


# ── stats mode (kernel K2) ─────────────────────────────────────────────

def stats_errors(got, want, rows):
    """(max |Δm|, max |Δl|/l, max |Δacc|/l) over ``rows``: m as an absolute
    difference; l and the unnormalized acc relative to the plain l, since
    both grow with the key count."""
    (acc, m, l), (acc_w, m_w, l_w) = got, want
    r = rows[..., 0]
    scale = np.maximum(l_w, 1e-30)
    em = np.abs(m - m_w)[r].max()
    el = (np.abs(l - l_w) / scale)[r].max()
    ea = (np.abs(acc - acc_w).max(axis=-1) / scale)[r].max()
    return em, el, ea


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_stats_plain_version_matches_pallas_interpreter(case, dtype,
                                                        no_kernel_build):
    """K2's plain version against the Pallas kernel in stats mode: m, l and
    acc on every row with a valid key, fp32 to 1e-5 and bf16 to 3e-2."""
    name, B, H, Lq, Lk, Dh, lengths, causal = case
    q, k, v, mask = make_inputs(len(name) * 11 + Dh, B, H, Lq, Lk, Dh,
                                lengths)
    tdt, jdt = DTYPES[dtype]
    ref = jax_flash_attention(
        *(jnp.asarray(x).astype(jdt) for x in (q, k, v)),
        None if mask is None else jnp.asarray(mask), causal=causal,
        interpret=True, return_stats=True)
    before = (fa.launches, fa.stats_launches)
    acc, m, l = fa.flash_attention(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
        None if mask is None else torch.from_numpy(mask), causal=causal,
        return_stats=True)
    assert (fa.launches, fa.stats_launches) == before
    assert acc.dtype == m.dtype == l.dtype == torch.float32
    assert tuple(acc.shape) == (B, H, Lq, Dh)
    assert tuple(m.shape) == tuple(l.shape) == (B, H, Lq)
    got = tuple(t.numpy() for t in (acc, m, l))
    assert all(np.isfinite(t).all() for t in got)
    want = tuple(np.asarray(t, dtype=np.float32) for t in ref)
    rows = np.broadcast_to(valid_rows(mask, B, Lq, Lk, causal), (B, H, Lq, 1))
    em, el, ea = stats_errors(got, want, rows)
    assert max(em, el, ea) <= TOL[dtype], (em, el, ea)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stats_reconstruct_the_normalized_output(dtype, no_kernel_build):
    """acc / max(l, 1e-30) in q's dtype is K1's output, bit for bit."""
    q, k, v, mask = make_inputs(9, 3, 2, 100, 100, 32, [100, 41, 0])
    tdt = DTYPES[dtype][0]
    args = [torch.from_numpy(x).to(tdt) for x in (q, k, v)]
    m_ = torch.from_numpy(mask)
    acc, _, l = fa.flash_attention(*args, m_, return_stats=True)
    out = fa.flash_attention(*args, m_)
    assert torch.equal((acc / l.clamp_min(1e-30)[..., None]).to(tdt), out)


def test_stats_reference_equals_cpu_wrapper(no_kernel_build):
    q, k, v, mask = make_inputs(4, 2, 4, 64, 80, 16, [80, 13])
    args = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)]
    m_ = torch.from_numpy(mask)
    for a, b in zip(fa.flash_attention(*args, m_, return_stats=True),
                    fa.flash_attention_stats_reference(*args, m_)):
        assert torch.equal(a, b)


def test_stats_l_matches_dense_log_sum_exp(no_kernel_build):
    """m is the row max of the scaled scores and l the softmax denominator
    (the JAX suite's ``test_return_stats_reconstructs_output`` oracle)."""
    q, k, v, mask = make_inputs(6, 2, 2, 48, 48, 16, [48, 30])
    acc, m, l = fa.flash_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(mask),
        return_stats=True)
    scores = np.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(16)
    scores = np.where(mask[:, None, None, :], scores, -1e30)
    mm = scores.max(-1)
    np.testing.assert_allclose(l.numpy(),
                               np.exp(scores - mm[..., None]).sum(-1),
                               rtol=1e-5)
    np.testing.assert_allclose(m.numpy(), mm, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_rows_without_a_valid_key_follow_the_dense_reference(
        dtype, no_kernel_build):
    """A causal row that sees no valid key scores -1e30 on every key, so the
    JAX package's dense reference (``_dense_stats_ref``) gives it m = -1e30,
    l = Lk and acc = the sum of V over every key. The port's plain version,
    which the card holds K1 and K2 to on every row, gives the same. The
    Pallas kernel skips the key blocks after such a row's query block and
    averages fewer keys; no served configuration is causal."""
    B, H, L, Dh = 3, 2, 48, 16
    q, k, v, _ = make_inputs(12, B, H, L, L, Dh, None)
    mask = np.ones((B, L), bool)
    mask[1, :20] = False  # rows 0..19 of batch element 1 see no valid key
    mask[2] = False       # every row of batch element 2
    tdt, jdt = DTYPES[dtype]
    args = [torch.from_numpy(x).to(tdt) for x in (q, k, v)]
    m_ = torch.from_numpy(mask)
    out = fa.flash_attention(*args, m_, causal=True)
    got = tuple(t.numpy() for t in fa.flash_attention(
        *args, m_, causal=True, return_stats=True))
    bias = jnp.where(jnp.asarray(mask), 0.0, jax_fa.NEG_INF)[:, None, :]
    want = tuple(np.asarray(t, dtype=np.float32) for t in jax_fa._dense_stats_ref(
        *(jnp.asarray(x).astype(jdt) for x in (q, k, v)), bias, True))
    empty = ~valid_rows(mask, B, L, L, True)[:, 0, :, 0]
    assert empty.sum() == 20 + L
    rows = np.broadcast_to(empty[:, None, :, None], (B, H, L, 1))
    r = rows[..., 0]
    assert (got[1][r] == np.float32(-1e30)).all()
    assert (want[1][r] == np.float32(-1e30)).all()
    assert (got[2][r] == L).all() and (want[2][r] == L).all()
    assert max(stats_errors(got, want, rows)) <= TOL[dtype]
    v_mean = args[2].float().numpy().mean(axis=2, keepdims=True)
    np.testing.assert_allclose(
        out.float().numpy() * rows, np.broadcast_to(v_mean, out.shape) * rows,
        atol=TOL[dtype], rtol=0)


def test_stats_fully_masked_row_counts_real_keys(no_kernel_build):
    """A row whose every key is masked: m = -1e30 (finite), every p = 1,
    and l = the number of real keys. The JAX wrapper pads Lk = 100 to its
    8-aligned block (104) with masked keys and counts those too, so its l
    is 104; no verdict sees this, since the batcher drops such rows."""
    q, k, v, _ = make_inputs(8, 2, 2, 100, 100, 16, None)
    mask = np.arange(100)[None, :] < np.array([[100], [0]])
    acc, m, l = fa.flash_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(mask),
        return_stats=True)
    assert torch.isfinite(acc).all() and torch.isfinite(m).all()
    assert (m[1] == np.float32(-1e30)).all()
    assert (l[1] == 100.0).all()
    np.testing.assert_allclose(acc[1].numpy(),
                               np.broadcast_to(v[1].sum(axis=1, keepdims=True),
                                               acc[1].shape), rtol=1e-5)
    _, _, l_jax = jax_flash_attention(
        *(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(mask),
        interpret=True, return_stats=True)
    assert (np.asarray(l_jax)[1] == 104.0).all()


# ── head dims: compiled widths, the padded route, the wide library ──


def test_kernel_head_dim_is_the_next_compiled_width():
    """Up to 128 the next compiled width of the dtype (bf16 compiles no
    Dh 8: wgmma's k-depth is 16); above it the next multiple of 128, the
    width the wide library runs, in both."""
    assert fa.COMPILED_HEAD_DIMS == {"bfloat16": (16, 32, 64, 128),
                                     "float32": (8, 16, 32, 64, 128)}
    small = (1, 7, 8, 9, 16, 24, 33, 100, 128)
    assert [fa.kernel_head_dim(d, torch.float32) for d in small] == \
        [8, 8, 8, 16, 16, 32, 64, 128, 128]
    assert [fa.kernel_head_dim(d, torch.bfloat16) for d in small] == \
        [16, 16, 16, 16, 16, 32, 64, 128, 128]
    assert fa.kernel_head_dim(8, "bfloat16") == 16
    assert fa.kernel_head_dim(8, "float32") == 8
    for dtype in (torch.float32, torch.bfloat16):
        assert [fa.kernel_head_dim(d, dtype)
                for d in (129, 200, 256, 257, 300, 384)] \
            == [256, 256, 256, 384, 384, 384]


@pytest.mark.parametrize("Dh", [3, 8, 12, 24, 48, 96])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_padded_route_leaves_every_output_unchanged(Dh, dtype):
    """What a launch at an uncompiled Dh computes, on the CPU: q, k and v
    zero-padded to the next compiled width with the real Dh's scale give
    the unpadded acc (its first Dh columns), m and l, and the padded acc
    columns are 0."""
    q, k, v, mask = make_inputs(Dh, 2, 2, 40, 56, Dh, [56, 13])
    tdt = DTYPES[dtype][0]
    args = [torch.from_numpy(x).to(tdt) for x in (q, k, v)]
    bias = fa._bias(torch.from_numpy(mask), 2, 56, torch.device("cpu"))
    width = fa.kernel_head_dim(Dh, tdt)
    padded = [fa._pad_head_dim(t, width) for t in args]
    assert all(t.shape[-1] == width and t.is_contiguous() for t in padded)
    acc, m, l = fa._stats(*args, bias, False)
    acc_p, m_p, l_p = fa._stats(*padded, bias, False,
                                scale=1.0 / math.sqrt(Dh))
    assert torch.equal(m_p, m) and torch.equal(l_p, l)
    assert torch.equal(acc_p[..., :Dh], acc)
    assert not acc_p[..., Dh:].any()


def test_head_dim_above_128_is_refused_where_jax_computes_it(
        no_kernel_build):
    """The deviation this test pinned is repaired: where the JAX kernel
    takes Dh 129 (through the interpreter), the port's wrapper computes it
    too, in both modes, instead of refusing it."""
    q, k, v, mask = make_inputs(129, 1, 1, 8, 8, 129, [8])
    args = [torch.from_numpy(x) for x in (q, k, v)]
    for stats in (False, True):
        want = jax_flash_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                   jnp.asarray(mask), interpret=True,
                                   return_stats=stats)
        got = fa.flash_attention(*args, torch.from_numpy(mask),
                                 return_stats=stats)
        for g, w in zip(got if stats else (got,), want if stats else (want,)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                       rtol=0)


# (Dh, B, H, L, valid keys per batch row): L a multiple of the JAX block, so
# no padded key counts in JAX's l; the last row of each case fully masked
WIDE_CASES = [(129, 3, 2, 64, [64, 23, 0]), (256, 3, 2, 64, [64, 40, 0]),
              (300, 2, 2, 64, [17, 0])]
WIDE_TOL = {"float32": 1e-5, "bfloat16": 5e-2}


@pytest.mark.parametrize("return_stats", [False, True],
                         ids=["normalized", "stats"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", WIDE_CASES, ids=lambda c: f"dh{c[0]}")
def test_wide_head_dims_match_pallas_interpreter(case, dtype, return_stats,
                                                 no_kernel_build):
    """Head dims above 128, the wrapper on the CPU against JAX's
    ``flash_attention(..., interpret=True)`` on every row, a masked and a
    fully masked one included: K1's output, or K2's acc, m and l; fp32
    within 1e-5, bf16 within 5e-2."""
    Dh, B, H, L, lengths = case
    q, k, v, mask = make_inputs(Dh + 1, B, H, L, L, Dh, lengths)
    tdt, jdt = DTYPES[dtype]
    want = jax_flash_attention(
        *(jnp.asarray(x).astype(jdt) for x in (q, k, v)), jnp.asarray(mask),
        interpret=True, return_stats=return_stats)
    got = fa.flash_attention(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
        torch.from_numpy(mask), return_stats=return_stats)
    got, want = (got, want) if return_stats else ((got,), (want,))
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        g = g.float().numpy()
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, np.asarray(w.astype(jnp.float32)),
                                   atol=WIDE_TOL[dtype], rtol=0)
    if return_stats:  # the fully masked row: m = -1e30, l = the L keys
        assert (got[1][-1].numpy() == np.float32(-1e30)).all()
        assert (got[2][-1].numpy() == L).all()


class _WideLib:
    """The wide library's C entry points, recording each call."""

    def __init__(self):
        self.calls = []

    def flash_attention_fwd(self, *args):
        self.calls.append(("k1", args))
        return 0

    def flash_attention_stats_fwd(self, *args):
        self.calls.append(("k2", args))
        return 0


@pytest.mark.parametrize("return_stats", [False, True])
def test_wide_launch_is_one_launch_of_the_wide_library(monkeypatch,
                                                       return_stats):
    """A launch at Dh 129 loads the wide library, passes the head dim
    padded to 256 and the scale of 129, calls the kernel once and counts
    one launch; tiles other than the wide kernels' own raise."""
    lib = _WideLib()
    loads = []

    def load_library(name, tiles=None, defines=()):
        loads.append((name, tiles, tuple(defines)))
        return lib

    monkeypatch.setattr(_build, "load_library", load_library)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    q, k, v, mask = make_inputs(5, 2, 2, 40, 72, 129, [72, 9])
    args = [torch.from_numpy(x) for x in (q, k, v)]
    bias = fa._bias(torch.from_numpy(mask), 2, 72, torch.device("cpu"))
    before = (fa.launches, fa.stats_launches)
    out = fa._launch(*args, bias, False, return_stats)
    assert loads == [("flash_attention", None, _build.WIDE_DEFINES)]
    assert [c[0] for c in lib.calls] == ["k2" if return_stats else "k1"]
    assert list(lib.calls[0][1][-9:-4]) == [2, 2, 40, 72, 256]  # B..Dh
    assert lib.calls[0][1][-2] == pytest.approx(1 / math.sqrt(129))
    after = (fa.launches, fa.stats_launches)
    assert after == ((before[0], before[1] + 1) if return_stats
                     else (before[0] + 1, before[1]))
    first = out[0] if return_stats else out
    assert first.shape[-1] == 129
    with pytest.raises(ValueError, match="own tiles"):
        fa._launch(*args, bias, False, return_stats, tiles=(128, 64))


def _host_tensor(ptr: int, shape: tuple, dtype) -> torch.Tensor:
    """A CPU tensor over the memory at ``ptr`` (a launch's argument)."""
    n = math.prod(shape)
    nbytes = n * torch.tensor([], dtype=dtype).element_size()
    buf = (ctypes.c_char * nbytes).from_address(ptr)
    return torch.frombuffer(buf, dtype=dtype, count=n).view(shape)


class _PlainLib:
    """The default library's C entry points computing the kernel's
    function with the plain version on the memory they are handed: q, k
    and v at the head dim and scale the launch passes, as the card's
    kernel reads them."""

    def __init__(self):
        self.calls = []

    def _inputs(self, args):
        q, k, v, bias = args[:4]
        B, H, Lq, Lk, Dh, dtype, causal, scale = args[-9:-1]
        tdt = {0: torch.float32, 1: torch.bfloat16}[dtype]
        self.calls.append((Dh, dtype, scale))
        return ([_host_tensor(q, (B, H, Lq, Dh), tdt),
                 _host_tensor(k, (B, H, Lk, Dh), tdt),
                 _host_tensor(v, (B, H, Lk, Dh), tdt),
                 _host_tensor(bias, (B, Lk), torch.float32)],
                (B, H, Lq, Dh), tdt, bool(causal), scale)

    def flash_attention_fwd(self, *args):
        (q, k, v, bias), shape, tdt, causal, scale = self._inputs(args)
        acc, _, l = fa._stats(q, k, v, bias, causal, scale=scale)
        _host_tensor(args[4], shape, tdt).copy_(
            (acc / l.clamp_min(1e-30)).to(tdt))
        return 0

    def flash_attention_stats_fwd(self, *args):
        (q, k, v, bias), shape, _, causal, scale = self._inputs(args)
        acc, m, l = fa._stats(q, k, v, bias, causal, scale=scale)
        _host_tensor(args[4], shape, torch.float32).copy_(acc)
        _host_tensor(args[5], shape[:3], torch.float32).copy_(m[..., 0])
        _host_tensor(args[6], shape[:3], torch.float32).copy_(l[..., 0])
        return 0


@pytest.mark.parametrize("return_stats", [False, True],
                         ids=["normalized", "stats"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_dim_8_launch_matches_pallas_interpreter(monkeypatch, dtype,
                                                      return_stats):
    """A launch at Dh 8 runs at 16 in bf16 (q, k and v zero-padded, the
    scale of 8, the padded columns sliced away) and at 8 in fp32. Its
    output, computed from the memory the launch hands the library, equals
    JAX's ``flash_attention(..., interpret=True)`` on every row, a masked
    and a fully masked one included (L a multiple of the JAX block, so no
    padded key counts in JAX's l): fp32 within 1e-5, bf16 within 5e-2."""
    lib = _PlainLib()
    monkeypatch.setattr(_build, "load_library",
                        lambda name, tiles=None, defines=(): lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(fa, "launch_tiles", lambda Lq, Lk, dt: (64, 64))
    B, H, L = 3, 2, 64
    q, k, v, mask = make_inputs(808, B, H, L, L, 8, [64, 23, 0])
    tdt, jdt = DTYPES[dtype]
    bias = fa._bias(torch.from_numpy(mask), B, L, torch.device("cpu"))
    got = fa._launch(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                     bias, False, return_stats)
    want = jax_flash_attention(
        *(jnp.asarray(x).astype(jdt) for x in (q, k, v)), jnp.asarray(mask),
        interpret=True, return_stats=return_stats)
    width = 16 if dtype == "bfloat16" else 8
    assert lib.calls == [(width, fa._DTYPE_CODES[tdt],
                          pytest.approx(1 / math.sqrt(8)))]
    got, want = (got, want) if return_stats else ((got,), (want,))
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        g = g.float().numpy()
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, np.asarray(w.astype(jnp.float32)),
                                   atol=WIDE_TOL[dtype], rtol=0)
    if return_stats:  # the fully masked row: m = -1e30, l = the L keys
        assert (got[1][-1].numpy() == np.float32(-1e30)).all()
        assert (got[2][-1].numpy() == L).all()


@pytest.mark.parametrize("return_stats", [False, True])
def test_flash_gradient_at_head_dim_8_matches_jax_vjp(return_stats,
                                                      no_kernel_build):
    """``_Flash``'s backward at Dh 8 (fp32, a masked and a fully masked
    row) against the JAX custom VJP (``_flash_norm_bwd`` /
    ``_flash_stats_bwd``) on the same cotangents: 1e-5."""
    q, k, v, mask = make_inputs(88, 3, 2, 40, 40, 8, [40, 17, 0])
    rng = np.random.default_rng(89)
    if return_stats:
        cots = (rng.standard_normal((3, 2, 40, 8)).astype(np.float32),
                rng.standard_normal((3, 2, 40)).astype(np.float32),
                rng.standard_normal((3, 2, 40)).astype(np.float32))
    else:
        cots = (rng.standard_normal((3, 2, 40, 8)).astype(np.float32),)

    def jax_loss(q, k, v):
        out = jax_flash_attention(q, k, v, jnp.asarray(mask),
                                  interpret=True, return_stats=return_stats)
        outs = out if return_stats else (out,)
        return sum((o * jnp.asarray(c)).sum() for o, c in zip(outs, cots))

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    args = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*args, torch.from_numpy(mask),
                             return_stats=return_stats)
    outs = out if return_stats else (out,)
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cots)
        ).backward()
    for t, w in zip(args, want):
        assert t.grad is not None and t.grad.abs().max() > 0
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0)


def test_ring_flash_at_head_dim_8_matches_jax_ring(no_kernel_build):
    """``ring_attention(impl="flash")`` at Dh 8 on (2, 4) over (dp, sp),
    the shape of ``__graft_entry__``'s ring+flash leg (fp32, L = 64),
    against JAX's ring on the same grid: 1e-5 on rows with a valid key."""
    shape = (2, 4)
    q, k, v, mask = make_inputs(17, 4, 2, 64, 64, 8, [64, 40, 33, 0])
    out = ring_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                         torch.from_numpy(mask),
                         make_mesh(axes=("dp", "sp"), shape=shape,
                                   device="cpu"), impl="flash")
    want = jax_ring(*(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(mask),
                    jax_mesh.make_mesh(8, axes=("dp", "sp"), shape=shape),
                    impl="flash")
    valid = mask.any(axis=1)[:, None, None, None]
    assert np.isfinite(out.numpy()).all()
    np.testing.assert_allclose(out.numpy() * valid, np.asarray(want) * valid,
                               atol=1e-5, rtol=0)
