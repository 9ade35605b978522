"""Pipeline-parallel serving forward for the ``encoder_validator_pp`` family.

Counterpart of ``vainplex_openclaw_tpu/models/pipeline_serve.py``. The
checkpoint's layer stack is stacked into S = |pp| stages before placement
(``parallel.plan.prepare_params``), so each stage's placed tree holds its
L/S blocks; the batch runs the GPipe wavefront of
``parallel.pipeline.pipeline_apply`` with the plan's microbatch count.
Embedding, final norm, pooling and the heads run outside the wavefront on
the first stage's device, as ``encoder.forward`` computes them; only the
blocks ride the pipeline. As in the JAX module the hopped state is one
tensor: the padding mask rides as an extra activation channel (0/1 is
exact in bf16, ``> 0.5`` recovers it), and ``moe_aux`` is 0: this family
serves dense layer stacks. Every block's attention is ``attend`` (kernel
K1 on a CUDA tensor) on one microbatch: n_layers × M launches a forward.
"""

from __future__ import annotations

import torch

from ..parallel.pipeline import pipeline_apply
from ..parallel.plan import Placement, map_tree
from .encoder import EncoderConfig, _block, embed, pool_outputs


def pp_serve_forward(placement: Placement, shards: list,
                     cfg: EncoderConfig, mesh, plan) -> dict:
    """The pipeline plan's mesh forward: ``shards[0][0]`` the bucketed
    tokens on the first stage (``plan.place_tokens``; the batch is floored
    at ``plan.microbatches`` by ``serve_bucket``) → the outputs of
    ``encoder.forward`` on the first stage's device."""
    stages = placement.grid[0]
    trees = placement.trees[0]
    D = cfg.d_model
    tokens = shards[0][0]
    mask = tokens > 0
    x = embed(trees[0], tokens, cfg)

    def stage(local: dict, state: torch.Tensor) -> torch.Tensor:
        """One stage's blocks (leaves ``[1, L/S, ...]``) on a microbatch
        whose last channel is the padding mask."""
        x = state[..., :D]
        mask = state[..., D] > 0.5
        for i in range(local["attn"]["q"].shape[1]):
            x, _aux = _block(x, map_tree(lambda k, a: a[0, i], local), cfg,
                             mask)
        return torch.cat([x, state[..., D:]], dim=-1)

    state = torch.cat([x, mask.to(x.dtype)[..., None]], dim=-1)
    state = pipeline_apply([t["blocks"] for t in trees], state, stage,
                           stages, n_microbatches=int(plan.microbatches))
    return pool_outputs(state[..., :D].to(stages[0], non_blocking=True),
                        mask, trees[0])


def clear_pp_caches() -> None:
    """Kept for the JAX module's API: the JAX package memoizes one jitted
    stage program per config, while the port builds its stage callable
    per call, so there is nothing to drop."""
