"""Mixture-of-experts FFN on one device.

Counterpart of ``vainplex_openclaw_tpu/models/moe.py``. A learned router
picks the top-1 expert of each token; every expert is a (w1, w2) GELU MLP,
stacked along a leading E axis. Dispatch is the reference's dense one:
every expert runs on every token and the one-hot route zeroes the rest, so
the einsums below are plain products outside any kernel. The steps are
separate functions (:func:`moe_route`, :func:`moe_combine`,
:func:`moe_sums`) so that the expert-parallel runner
(``parallel/sharded_forward.py``) can run :func:`moe_combine` per ep shard
over its E/ep experts and sum the fp32 partials before the gate value and
the cast, as the JAX einsum over a sharded E axis does.

Numerics that must match the JAX module:

- the router runs in fp32: ``x.float() @ gate``, with the gate upcast (the
  JAX ``cast_params`` casts it to the activation dtype and JAX promotes the
  product to fp32; torch refuses fp32 @ bf16, so it is upcast here);
- ties in the router's argmax go to the first maximum in both frameworks;
- GELU is the tanh form;
- the combine runs in fp32 over the one-hot route, times the top-1 gate
  value (straight-through, so the router stays differentiable), then casts
  to the activation dtype;
- the load-balance sums count valid tokens only, over ``max(count, 1)``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class MoEConfig:
    d_model: int = 256
    d_ff: int = 512
    n_experts: int = 4


def moe_shapes(cfg: MoEConfig) -> dict:
    """``{leaf: shape}`` of one block's ``moe`` subtree."""
    return {"gate": (cfg.d_model, cfg.n_experts),
            "w1": (cfg.n_experts, cfg.d_model, cfg.d_ff),
            "w2": (cfg.n_experts, cfg.d_ff, cfg.d_model)}


def moe_init_std(leaf: str, shape: tuple) -> float:
    """The JAX ``init_moe_params`` scales: gate 0.02, each expert matrix
    1/√fan_in."""
    return 0.02 if leaf == "gate" else 1.0 / math.sqrt(shape[-2])


def init_moe_params(cfg: MoEConfig, generator: torch.Generator) -> dict:
    """Random fp32 ``{gate, w1, w2}`` on the CPU with the JAX shapes and
    scales (another generator, so other values)."""
    return {name: torch.randn(shape, generator=generator,
                              dtype=torch.float32) * moe_init_std(name, shape)
            for name, shape in moe_shapes(cfg).items()}


def moe_route(x: torch.Tensor, gate: torch.Tensor, n_experts: int):
    """The fp32 router on x ``[B, T, D]`` → ``(probs, route, gate_val)``:
    softmax probabilities and the one-hot top-1 route ``[B, T, E]``, and
    the top-1 probability ``[B, T, 1]``."""
    logits = x.float() @ gate.float()                               # [B,T,E]
    probs = torch.softmax(logits, dim=-1)
    route = F.one_hot(probs.argmax(dim=-1), n_experts).float()      # [B,T,E]
    gate_val = (probs * route).sum(dim=-1, keepdim=True)            # [B,T,1]
    return probs, route, gate_val


def moe_combine(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                route: torch.Tensor) -> torch.Tensor:
    """The dense dispatch of the experts in ``w1`` ``[E', D, F]`` and
    ``w2`` ``[E', F, D]`` over x ``[B, T, D]``, combined by ``route``
    ``[B, T, E']`` in fp32 → ``[B, T, D]`` fp32. An expert-parallel shard
    passes its own experts and their columns of the route; the shards'
    results sum to the whole combine."""
    dt = x.dtype
    h = torch.einsum("btd,edf->ebtf", x, w1.to(dt))
    h = F.gelu(h, approximate="tanh")
    y = torch.einsum("ebtf,efd->ebtd", h, w2.to(dt))
    return torch.einsum("ebtd,bte->btd", y.float(), route)


def moe_sums(probs: torch.Tensor, route: torch.Tensor,
             mask: Optional[torch.Tensor]):
    """``(route_sum [E], prob_sum [E], token_count)`` over the valid
    tokens, the load-balance loss's inputs."""
    m = torch.ones(route.shape[:2], dtype=torch.float32,
                   device=route.device) if mask is None else mask.float()
    route_sum = (route * m[:, :, None]).sum(dim=(0, 1))
    prob_sum = (probs * m[:, :, None]).sum(dim=(0, 1))
    return route_sum, prob_sum, m.sum()


def moe_ffn_parts(x: torch.Tensor, p: dict, cfg: MoEConfig,
                  mask: Optional[torch.Tensor] = None):
    """x ``[B, T, D]``, mask ``[B, T]`` valid tokens or None →
    ``(out [B, T, D], route_sum [E], prob_sum [E], token_count)``."""
    probs, route, gate_val = moe_route(x, p["gate"], cfg.n_experts)
    out = moe_combine(x, p["w1"], p["w2"], route)
    out = (out * gate_val).to(x.dtype)
    return (out, *moe_sums(probs, route, mask))


def load_balance_loss(route_sum: torch.Tensor, prob_sum: torch.Tensor,
                      count: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Switch-style aux from per-expert sums over ``count`` tokens."""
    denom = count.clamp_min(1.0)
    return n_experts * ((route_sum / denom) * (prob_sum / denom)).sum()


def moe_ffn(x: torch.Tensor, p: dict, cfg: MoEConfig,
            mask: Optional[torch.Tensor] = None):
    """x ``[B, T, D]`` → ``(out [B, T, D], aux load-balance loss)``."""
    out, route_sum, prob_sum, count = moe_ffn_parts(x, p, cfg, mask)
    return out, load_balance_loss(route_sum, prob_sum, count, cfg.n_experts)


def moe_sharding_rules(ep_axis: str = "ep") -> list:
    """``mesh.shard_params`` rules of the JAX package (substring patterns
    over the JAX key rendering) placing the expert axis on ``ep_axis``;
    the serving plans use ``parallel.plan.MOE_EP_RULES``."""
    return [("'w1'", (ep_axis, None, None)), ("'w2'", (ep_axis, None, None)),
            ("gate", ())]
