"""Ring attention: sequence-parallel exact attention over an ``sp`` axis.

Counterpart of ``vainplex_openclaw_tpu/parallel/ring_attention.py``. The
sequence is cut into ``sp`` shards, each on its own grid device, and
attention is exact: the K/V shards rotate around the ring while every query
shard folds each block into a numerically stable online softmax (an
m/l/acc carry in fp32). No device holds more than an ``L/sp × L/sp`` block
of scores.

The port is single-controller, so :func:`ring_attention_local` takes every
shard of one ring at once (the JAX function is the per-device body inside
``shard_map``) and keeps its rotation order: after ``i`` rotations, shard
``j`` holds the block that started on shard ``(j − i) mod sp``. A rotation
is ``.to(next_device, non_blocking=True)`` along the ring; on a repeated
device (a ring laid over one card) it is a no-op.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from ..ops.flash_attention import flash_attention
from .mesh import Mesh

NEG_INF = -1e30  # finite: keeps fully masked rows NaN-free through exp()


def _rotate(xs: list, devices: Sequence[torch.device]) -> list:
    """Shard j's block moves to shard j + 1 (mod sp)."""
    n = len(xs)
    return [xs[(j - 1) % n].to(devices[j], non_blocking=True)
            for j in range(n)]


def ring_attention_local(qs: Sequence[torch.Tensor],
                         ks: Sequence[torch.Tensor],
                         vs: Sequence[torch.Tensor],
                         kv_masks: Sequence[torch.Tensor],
                         devices: Sequence[torch.device], *,
                         causal: bool = False,
                         scale: Optional[float] = None,
                         impl: str = "auto") -> list:
    """One ring's attention. ``qs[j]`` ``[B, H, Lq, Dh]`` is query shard j
    on ``devices[j]``; ``ks[j]``/``vs[j]`` ``[B, H, Lk, Dh]`` and
    ``kv_masks[j]`` ``[B, Lk]`` bool are the key/value shard that starts
    there. Returns the output shards, each in its q's dtype.

    ``impl``: how each rotation's local block is computed. ``"flash"``
    (and ``"auto"``, as everywhere in the port) calls ``flash_attention``
    in stats mode (kernel K2 on a CUDA tensor, its plain version on a CPU
    one) and merges its partials into the carry in fp32. ``"dense"`` keeps
    the score matrix (q·kᵀ in the input dtype, then fp32). Causal or
    custom-scale calls always go dense: the kernel's causal mask is
    block-local and its scale is 1/√Dh."""
    sp = len(qs)
    if not (len(ks) == len(vs) == len(kv_masks) == len(devices) == sp):
        raise ValueError("ring_attention_local: one q, k, v, mask and "
                         "device per shard")
    B, H, Lq, Dh = qs[0].shape
    Lk = ks[0].shape[2]
    if impl == "auto":
        impl = "flash"
    if impl not in ("flash", "dense"):
        raise ValueError(f"unknown ring attention impl {impl!r}")
    use_flash = impl == "flash" and not causal and scale is None
    scale = scale if scale is not None else 1.0 / math.sqrt(Dh)

    def attend_dense(carry, q, k, v, kv_mask, j, src):
        m, l, acc = carry
        scores = (q @ k.transpose(-1, -2)).float() * scale
        keep = kv_mask[:, None, None, :]
        if causal:
            q_pos = j * Lq + torch.arange(Lq, device=q.device)
            k_pos = src * Lk + torch.arange(Lk, device=q.device)
            keep = keep & (q_pos[:, None] >= k_pos[None, :])[None, None]
        scores = torch.where(keep, scores, NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        p = torch.exp(scores - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + (p.to(v.dtype) @ v).float()
        return m_new, l, acc

    def attend_flash(carry, q, k, v, kv_mask, j, src):
        m, l, acc = carry
        # The kernel returns its unnormalized fp32 accumulator and softmax
        # partials, so the cross-rotation merge stays in fp32.
        acc_i, m_i, l_i = flash_attention(q, k, v, kv_mask,
                                          return_stats=True)
        m_new = torch.maximum(m, m_i)
        corr = torch.exp(m - m_new)
        corr_i = torch.exp(m_i - m_new)
        l = l * corr + l_i * corr_i
        acc = acc * corr[..., None] + acc_i * corr_i[..., None]
        return m_new, l, acc

    attend = attend_flash if use_flash else attend_dense
    carries = [(torch.full((B, H, Lq), NEG_INF, dtype=torch.float32,
                           device=q.device),
                torch.zeros((B, H, Lq), dtype=torch.float32, device=q.device),
                torch.zeros((B, H, Lq, Dh), dtype=torch.float32,
                            device=q.device)) for q in qs]
    ks, vs, kv_masks = list(ks), list(vs), list(kv_masks)
    for i in range(sp):
        if i:
            ks = _rotate(ks, devices)
            vs = _rotate(vs, devices)
            kv_masks = _rotate(kv_masks, devices)
        for j in range(sp):
            carries[j] = attend(carries[j], qs[j], ks[j], vs[j], kv_masks[j],
                                j, (j - i) % sp)
    return [(acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)
            for (_, l, acc), q in zip(carries, qs)]


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv_mask: torch.Tensor, mesh: Mesh, *, dp_axis: str = "dp",
                   sp_axis: str = "sp", causal: bool = False,
                   impl: str = "auto") -> torch.Tensor:
    """Sharded exact attention on the mesh: q, k, v ``[B, H, L, Dh]`` are
    cut along the batch over ``dp_axis`` and along the sequence over
    ``sp_axis``, kv_mask ``[B, L]`` likewise; each dp row runs one ring.
    Returns ``[B, H, L, Dh]`` in q's dtype on the mesh's first device."""
    grid = mesh.grid(dp_axis, sp_axis)
    dp, sp = len(grid), len(grid[0])
    B, L = q.shape[0], q.shape[2]
    if B % dp or L % sp:
        raise ValueError(f"[B={B}, L={L}] does not split over dp={dp}, "
                         f"sp={sp}")
    rows = []
    for i, (qb, kb, vb, mb) in enumerate(zip(
            q.chunk(dp, 0), k.chunk(dp, 0), v.chunk(dp, 0),
            kv_mask.chunk(dp, 0))):
        devs = grid[i]

        def shards(x, dim):
            return [s.to(d).contiguous()
                    for s, d in zip(x.chunk(sp, dim), devs)]

        outs = ring_attention_local(shards(qb, 2), shards(kb, 2),
                                    shards(vb, 2), shards(mb, 1), devs,
                                    causal=causal, impl=impl)
        rows.append(torch.cat([o.to(mesh.devices[0]) for o in outs], dim=2))
    return torch.cat(rows, dim=0)


def dense_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, kv_mask: torch.Tensor, *,
                              causal: bool = False) -> torch.Tensor:
    """Single-device exact attention, for parity tests and small inputs."""
    Dh, L = q.shape[-1], q.shape[2]
    scores = (q @ k.transpose(-1, -2)).float() / math.sqrt(Dh)
    keep = kv_mask[:, None, None, :]
    if causal:
        pos = torch.arange(L, device=q.device)
        keep = keep & (pos[:, None] >= pos[None, :])[None, None]
    scores = torch.where(keep, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return probs @ v
