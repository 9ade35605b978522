"""Exact attention: the hand-written CUDA kernels and their plain version.

Counterpart of ``vainplex_openclaw_tpu/ops/flash_attention.py::
flash_attention`` in both modes. The same layout and semantics:

- q ``[B, H, Lq, Dh]``, k and v ``[B, H, Lk, Dh]``, bf16 or fp32;
- an optional ``kv_mask`` ``[B, Lk]`` bool, turned into one fp32 bias row
  per batch element (0 for a valid key, ``-1e30`` for a masked one, never
  ``-inf``) that every head shares;
- scores ``(q·kᵀ in fp32) * 1/√Dh + bias``; under ``causal`` a key after the
  query gets ``-1e30`` in place of its score;
- an online softmax with running max, sum and accumulator in fp32, and
  ``p`` rounded to v's dtype before the PV product;
- normalized mode (kernel K1): ``out = acc / max(l, 1e-30)`` in q's dtype;
- stats mode (``return_stats=True``, kernel K2): the tuple ``(acc, m, l)``,
  the unnormalized fp32 accumulator ``[B, H, Lq, Dh]`` and the running max
  and unclamped sum ``[B, H, Lq]`` in fp32, which ring attention merges
  across rotations.

A fully masked row (every zero-pad row the batcher adds) has every score at
``-1e30``: each ``p`` is ``exp(0) = 1`` and the row averages V. It stays
finite (m is ``-1e30``); with ``-inf`` it would be NaN. Its ``l`` counts the
real keys. The JAX wrapper pads a ragged Lk to its block multiple with
masked keys and counts those too; no verdict can see the difference, since
only fully masked rows differ and the batcher drops them.

On a CPU tensor :func:`flash_attention` computes the plain version
(:func:`flash_attention_reference`, :func:`flash_attention_stats_reference`).
On a CUDA tensor it launches the kernel in ``csrc/flash_attention.cu`` and
adds one to :data:`launches` (K1) or :data:`stats_launches` (K2); if the
library cannot be built or loaded, or the launch fails, it raises. There is
no fallback from the kernel to the plain version. The library picks its
kernel by dtype alone: bf16 runs on the tensor cores
(``csrc/flash_attention_mma.cuh``), fp32 on a scalar walk of the CUDA cores
(a tensor-core fp32 path would be TF32). The kernel masks its own ragged
edge instead of padding.

The block table. The bf16 kernel's tiles (query rows by key columns) are
compile-time constants, so each tile is a library of its own
(``_build.tile_defines``). As JAX's wrapper takes ``block_q`` and
``block_k`` from ``default_block``, a launch takes its tiles from the
checked-in table ``flash_block_table.json`` (rows
``cuda:<dtype>:<pow2 bucket of L>``, written by ``kernel_search``), read
once and cached, or from ``block_q``/``block_k`` given to
:func:`flash_attention`. A bucket without a row runs the compiled default
64×64, the library built without defines. The JAX table's TPU rows (and
its 512/1024 heuristic) mean nothing for this kernel and are not read. A
row whose tiles do not build or launch raises; it never falls back to the
plain version. On the CPU the plain version runs and no table is read.
Under ``causal`` it skips key tiles wholly after a query tile unless a row
of that tile has no valid key, so such a row averages V over every key, as
the plain version does.

Both modes are differentiable, as the JAX package's custom VJPs make them
(``_flash_norm``, ``_flash_stats``). Both go through one
``torch.autograd.Function`` (:class:`_Flash`) whose forward is the kernel on CUDA and the plain version on the CPU, and
whose backward is the vector-Jacobian product of the plain version,
recomputed densely, as JAX's backward differentiates ``_dense_stats_ref``.
Its fp32 scores are what XLA computes there too: under ``jit`` the bf16
q·kᵀ einsum followed by a cast to fp32 becomes one product with an fp32
result, never rounded to bf16 (a backward that rounds the scores first
misses JAX's bf16 gradients by more than 0.1 of their scale in stats
mode, where an argmax picks m; ``tests/test_torch_train.py`` holds this one
to 1.5e-2 and the rounding one as a control). There is no backward
kernel, as the JAX
package has none. The bias gets no gradient. Only a forward adds to the
launch counts; under ``torch.inference_mode()`` or ``torch.no_grad()``
nothing is saved for a backward.
"""

from __future__ import annotations

import functools
import json
import math
import os
import threading
from typing import Optional

import torch

from ..device import backend_family
from ._build import DEFAULT_TILES
from .similarity import pow2_bucket

NEG_INF = -1e30
SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches since the last reset: K1 (normalized) and K2 (stats).
# Only the CUDA branch of ``flash_attention`` adds to them; tools set them
# to 0 before a run they read.
launches = 0
stats_launches = 0
_launch_lock = threading.Lock()

# ── the block table (JAX ``ops/flash_attention.py:43-128``) ────────────

TABLE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "flash_block_table.json")
TABLE_ENV = "OPENCLAW_FLASH_BLOCK_TABLE"


@functools.lru_cache(maxsize=8)
def load_block_table(path: "str | None" = None) -> dict:
    """The parsed block table ({} when missing or invalid: the compiled
    default then runs every bucket). Cached per path, so no launch reads
    the disk."""
    p = path or os.environ.get(TABLE_ENV) or TABLE_PATH
    try:
        with open(p, encoding="utf-8") as f:
            table = json.load(f)
    except (OSError, ValueError):
        return {}
    entries = table.get("entries") if isinstance(table, dict) else None
    return table if isinstance(entries, dict) else {}


def clear_table_cache() -> None:
    """Drop the cached table and tile lookups (after a rewrite, or a
    change of ``TABLE_ENV``)."""
    load_block_table.cache_clear()
    launch_tiles.cache_clear()


def table_key(L: int, dtype: str = "bfloat16",
              family: "str | None" = None) -> str:
    """The one key format: ``family:dtype:pow2 bucket of L``. The search
    writes and the launch reads through it."""
    return f"{family or backend_family()}:{dtype}:{pow2_bucket(max(L, 1))}"


def table_entry(L: int, dtype: str = "bfloat16",
                family: "str | None" = None,
                path: "str | None" = None) -> "dict | None":
    """The table's row for (family, dtype, pow2 bucket of L), or None when
    there is none or its blocks are not positive multiples of 8 (JAX's
    test; a row that passes it but that the kernel cannot take raises at
    the launch)."""
    entries = load_block_table(path).get("entries", {})
    ent = entries.get(table_key(L, dtype, family))
    if not isinstance(ent, dict):
        return None
    bq, bk = ent.get("block_q"), ent.get("block_k")
    if not (isinstance(bq, int) and isinstance(bk, int)
            and bq >= 8 and bk >= 8 and bq % 8 == 0 and bk % 8 == 0):
        return None
    return ent


def default_block(L: int, dtype: str = "bfloat16", side: str = "q",
                  family: "str | None" = None) -> int:
    """The tile of one attention side at length L: the table's row, else
    the kernel's compiled default (64 either side)."""
    ent = table_entry(L, dtype, family)
    if ent is not None:
        return ent["block_q"] if side == "q" else ent["block_k"]
    return DEFAULT_TILES[0] if side == "q" else DEFAULT_TILES[1]


@functools.lru_cache(maxsize=256)
def launch_tiles(Lq: int, Lk: int, dtype: str) -> tuple:
    """(block_q, block_k) a CUDA launch at (Lq, Lk, dtype) runs:
    ``default_block`` of the ``cuda`` family, as JAX's wrapper takes
    ``block_q`` from Lq and ``block_k`` from Lk. Cached per shape."""
    return (default_block(Lq, dtype, "q", "cuda"),
            default_block(Lk, dtype, "k", "cuda"))


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


def _stats(q, k, v, bias, causal: bool):
    """(acc, m, l) in one dense pass: the quantities of the JAX package's
    ``_dense_stats_ref`` with the kernel's precision (fp32 scores and
    accumulator, as the Pallas kernel's ``preferred_element_type``)."""
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
    return acc, m, l


def _reference(q, k, v, bias, causal: bool) -> torch.Tensor:
    acc, _, l = _stats(q, k, v, bias, causal)
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


def _plain(q, k, v, bias, causal: bool, return_stats: bool):
    if return_stats:
        acc, m, l = _stats(q, k, v, bias, causal)
        return acc, m[..., 0], l[..., 0]
    return _reference(q, k, v, bias, causal)


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              kv_mask: Optional[torch.Tensor] = None, *,
                              causal: bool = False) -> torch.Tensor:
    """The plain PyTorch version of K1: one dense pass with the kernel's
    arithmetic (fp32 scores and softmax, ``p`` rounded to v's dtype before
    PV). The CPU path and the tests use it; on the card only checks that
    hold the kernel against it do."""
    _check(q, k, v, kv_mask, causal)
    return _plain(q, k, v, _bias(kv_mask, q.shape[0], k.shape[2], q.device),
                  causal, False)


def flash_attention_stats_reference(q: torch.Tensor, k: torch.Tensor,
                                    v: torch.Tensor,
                                    kv_mask: Optional[torch.Tensor] = None,
                                    *, causal: bool = False):
    """The plain PyTorch version of K2: ``(acc, m, l)``, acc fp32
    ``[B, H, Lq, Dh]`` unnormalized, m and l fp32 ``[B, H, Lq]``, l
    unclamped."""
    _check(q, k, v, kv_mask, causal)
    return _plain(q, k, v, _bias(kv_mask, q.shape[0], k.shape[2], q.device),
                  causal, True)


def _launch(q, k, v, bias, causal: bool, return_stats: bool,
            tiles: Optional[tuple] = None):
    """K1 (or K2 with ``return_stats``) on CUDA tensors at ``tiles`` (None:
    the block table's); adds one to its count once the launch is
    accepted, or raises."""
    global launches, stats_launches
    from ._build import load_library

    B, H, Lq, Dh = q.shape
    Lk = k.shape[2]
    if tiles is None:
        tiles = launch_tiles(Lq, Lk, str(q.dtype).replace("torch.", ""))
    lib = load_library("flash_attention", tiles=tiles)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if return_stats:
            acc = torch.empty((B, H, Lq, Dh), dtype=torch.float32,
                              device=q.device)
            m = torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
            l = torch.empty_like(m)
            err = lib.flash_attention_stats_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                acc.data_ptr(), m.data_ptr(), l.data_ptr(), B, H, Lq, Lk, Dh,
                _DTYPE_CODES[q.dtype], int(causal), stream)
        else:
            out = torch.empty_like(q)
            err = lib.flash_attention_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                out.data_ptr(), B, H, Lq, Lk, Dh, _DTYPE_CODES[q.dtype],
                int(causal), stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: CUDA error {err} "
            f"({lib.kernel_error_string(err).decode()})")
    with _launch_lock:
        if return_stats:
            stats_launches += 1
        else:
            launches += 1
    return (acc, m, l) if return_stats else out


def _forward(q, k, v, bias, causal: bool, return_stats: bool,
             tiles: Optional[tuple] = None):
    """The plain version on CPU tensors, the kernel on CUDA tensors."""
    if q.device.type == "cuda":
        return _launch(q, k, v, bias, causal, return_stats, tiles)
    return _plain(q, k, v, bias, causal, return_stats)


class _Flash(torch.autograd.Function):
    """K1 (or K2 with ``return_stats``) forward, dense-recompute backward
    (JAX ``_flash_norm_bwd`` / ``_flash_stats_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal, return_stats, tiles=None):
        ctx.causal, ctx.return_stats = causal, return_stats
        ctx.save_for_backward(q, k, v, bias)
        return _forward(q, k, v, bias, causal, return_stats, tiles)

    @staticmethod
    def backward(ctx, *grads):
        """dq, dk, dv: the plain version recomputed densely and
        differentiated by autograd against ``grads``."""
        q, k, v, bias = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            outs = _plain(*qkv, bias, ctx.causal, ctx.return_stats)
            dqkv = torch.autograd.grad(
                outs, qkv, grads if ctx.return_stats else grads[0])
        return (*dqkv, None, None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_mask: Optional[torch.Tensor] = None, *,
                    causal: bool = False, return_stats: bool = False,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None):
    """q ``[B, H, Lq, Dh]``, k and v ``[B, H, Lk, Dh]``, kv_mask ``[B, Lk]``
    bool or None → ``[B, H, Lq, Dh]`` in q's dtype, or with
    ``return_stats`` the tuple ``(acc, m, l)`` (see the module docstring).
    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise, at ``block_q`` × ``block_k`` where given and each other side
    from the block table. Differentiable in q, k and v on both."""
    _check(q, k, v, kv_mask, causal)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    tiles = None
    if block_q is not None or block_k is not None:
        dt = str(q.dtype).replace("torch.", "")
        table = launch_tiles(q.shape[2], k.shape[2], dt) \
            if q.device.type == "cuda" else DEFAULT_TILES
        tiles = (block_q or table[0], block_k or table[1])
    bias = _bias(kv_mask, q.shape[0], k.shape[2], q.device)
    return _Flash.apply(q, k, v, bias, causal, return_stats, tiles)
