"""GPipe-style pipeline parallelism over a ``pp`` grid.

Counterpart of ``vainplex_openclaw_tpu/parallel/pipeline.py``. Layers are
stacked into S stages (:func:`stack_stage_params`, leaves lead
``[S, L/S]``); a batch is split into M microbatches that flow through the
stages in the (M + S − 1)-step wavefront: stage s processes microbatch m at
step t = m + s, and after each step every stage's state hops to the next
stage (``.to(next device, non_blocking=True)``; a no-op on a repeated
device). The JAX body runs every stage at every step inside ``shard_map``
and masks the idle ones; this single-controller loop skips them, which
gives the same output with M × S stage calls instead of (M + S − 1) × S.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch


def _stack(trees: list, n_stages: int):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees], n_stages) for k in first}
    arr = torch.stack(trees)                                   # [L, ...]
    return arr.reshape((n_stages, len(trees) // n_stages) + arr.shape[1:])


def stack_stage_params(block_params: list, n_stages: int):
    """``[L blocks]`` (trees of dicts) → one tree whose leaves lead
    ``[S, L/S]``."""
    L = len(block_params)
    if L % n_stages:
        raise ValueError(f"{L} layers not divisible into {n_stages} stages")
    return _stack(list(block_params), n_stages)


def pipeline_apply(stage_params: Sequence, x: torch.Tensor,
                   stage_fn: Callable, devices: Sequence[torch.device], *,
                   n_microbatches: int) -> torch.Tensor:
    """Run x ``[B, ...]`` through every stage → ``[B, ...]`` on the last
    stage's device. ``stage_params[s]`` is stage s's tree on
    ``devices[s]``; ``stage_fn(params, x)`` applies one stage to a
    microbatch."""
    S, M = len(devices), n_microbatches
    B = x.shape[0]
    if B % M:
        raise ValueError(f"batch {B} not divisible into {M} microbatches")
    micro = x.chunk(M, dim=0)
    state: list = [None] * S
    out: list = [None] * M
    for t in range(M + S - 1):
        if t < M:  # stage 0 injects microbatch t
            state[0] = micro[t].to(devices[0], non_blocking=True)
        for s in range(S):  # only the stages on the wavefront compute
            state[s] = stage_fn(stage_params[s], state[s]) \
                if s <= t < s + M else None
        if t >= S - 1:  # the last stage emits microbatch t - (S - 1)
            out[t - (S - 1)] = state[S - 1]
        if t < M + S - 2:  # the hop s → s + 1; none after the final step
            state = [None] + [None if h is None
                              else h.to(devices[i + 1], non_blocking=True)
                              for i, h in enumerate(state[:-1])]
    return torch.cat(out, dim=0)
