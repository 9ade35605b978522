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

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vainplex_openclaw_tpu.ops.flash_attention import (
    flash_attention as jax_flash_attention)
from vainplex_openclaw_tpu_torch.ops import _build
from vainplex_openclaw_tpu_torch.ops import flash_attention as fa

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
    elif bad == "head_dim":
        q = k = v = torch.zeros((2, 2, 8, 24))
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
