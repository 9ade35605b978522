"""Exact attention: the hand-written CUDA kernel and its plain version.

Counterpart of ``vainplex_openclaw_tpu/ops/flash_attention.py::
flash_attention`` in normalized mode. The same layout and semantics:

- q ``[B, H, Lq, Dh]``, k and v ``[B, H, Lk, Dh]``, bf16 or fp32;
- an optional ``kv_mask`` ``[B, Lk]`` bool, turned into one fp32 bias row
  per batch element (0 for a valid key, ``-1e30`` for a masked one, never
  ``-inf``) that every head shares;
- scores ``(q·kᵀ in fp32) * 1/√Dh + bias``; under ``causal`` a key after the
  query gets ``-1e30`` in place of its score;
- an online softmax with running max, sum and accumulator in fp32, ``p``
  rounded to v's dtype before the PV product, and
  ``out = acc / max(l, 1e-30)`` in q's dtype.

A fully masked row (every zero-pad row the batcher adds) has every score at
``-1e30``: each ``p`` is ``exp(0) = 1`` and the row averages V. It stays
finite; with ``-inf`` it would be NaN.

On a CPU tensor :func:`flash_attention` computes the plain version
(:func:`flash_attention_reference`). On a CUDA tensor it launches the kernel
in ``csrc/flash_attention.cu`` and adds one to :data:`launches`; if the
library cannot be built or loaded, or the launch fails, it raises. There is
no fallback from the kernel to the plain version. The TPU block table
(``default_block``) has no counterpart: the kernel's tiles are its own
compile-time constants, and it masks its own ragged edge instead of padding.
"""

from __future__ import annotations

import math
import threading
from typing import Optional

import torch

NEG_INF = -1e30
SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches since the last reset. Only the CUDA branch of
# ``flash_attention`` adds to it; tools set it to 0 before a run they read.
launches = 0
_launch_lock = threading.Lock()


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           kv_mask: Optional[torch.Tensor], causal: bool) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention expects q, k, v as [B, H, L, Dh]")
    B, H, Lq, Dh = q.shape
    if k.shape != v.shape or k.shape[:2] != (B, H) or k.shape[3] != Dh:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    Lk = k.shape[2]
    if Lq == 0 or Lk == 0:
        raise ValueError("flash_attention needs Lq ≥ 1 and Lk ≥ 1")
    if causal and Lq != Lk:
        raise ValueError("causal flash attention requires Lq == Lk")
    if Dh not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {Dh} not in {SUPPORTED_HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype of bf16 or fp32, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous (call .contiguous() "
                         "after a head transpose)")
    if kv_mask is not None and tuple(kv_mask.shape) != (B, Lk):
        raise ValueError(f"kv_mask must be [B, Lk] = {(B, Lk)}, got "
                         f"{tuple(kv_mask.shape)}")


def _bias(kv_mask: Optional[torch.Tensor], B: int, Lk: int,
          device: torch.device) -> torch.Tensor:
    """[B, Lk] fp32: 0 where the key is valid, NEG_INF where it is masked."""
    if kv_mask is None:
        return torch.zeros((B, Lk), dtype=torch.float32, device=device)
    valid = kv_mask.to(device=device, dtype=torch.bool)
    return torch.where(valid, 0.0, NEG_INF).to(torch.float32).contiguous()


def _reference(q, k, v, bias, causal: bool) -> torch.Tensor:
    Dh = q.shape[-1]
    s = (q.float() @ k.float().transpose(-1, -2)) * (1.0 / math.sqrt(Dh))
    s = s + bias[:, None, None, :]
    if causal:
        Lq, Lk = q.shape[2], k.shape[2]
        keep = torch.ones((Lq, Lk), dtype=torch.bool, device=q.device).tril()
        s = torch.where(keep, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = p.to(v.dtype).float() @ v.float()
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              kv_mask: Optional[torch.Tensor] = None, *,
                              causal: bool = False) -> torch.Tensor:
    """The plain PyTorch version of the kernel: one dense pass with the
    kernel's arithmetic (fp32 scores and softmax, ``p`` rounded to v's dtype
    before PV). The CPU path and the tests use it; on the card only checks
    that hold the kernel against it do."""
    _check(q, k, v, kv_mask, causal)
    B, Lk = q.shape[0], k.shape[2]
    return _reference(q, k, v, _bias(kv_mask, B, Lk, q.device), causal)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_mask: Optional[torch.Tensor] = None, *,
                    causal: bool = False) -> torch.Tensor:
    """q ``[B, H, Lq, Dh]``, k and v ``[B, H, Lk, Dh]``, kv_mask ``[B, Lk]``
    bool or None → ``[B, H, Lq, Dh]`` in q's dtype. CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise."""
    global launches
    _check(q, k, v, kv_mask, causal)
    B, H, Lq, Dh = q.shape
    Lk = k.shape[2]
    bias = _bias(kv_mask, B, Lk, q.device)
    if q.device.type == "cpu":
        return _reference(q, k, v, bias, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    from ._build import load_library

    lib = load_library("flash_attention")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            out.data_ptr(), B, H, Lq, Lk, Dh, _DTYPE_CODES[q.dtype],
            int(causal), stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: CUDA error {err} "
            f"({lib.kernel_error_string(err).decode()})")
    with _launch_lock:
        launches += 1
    return out
