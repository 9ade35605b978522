"""Mixture-of-experts FFN on one device.

Counterpart of ``vainplex_openclaw_tpu/models/moe.py`` without its
expert-parallel rule table (``moe_sharding_rules`` waits for the
expert-parallel serving family). A learned router picks the top-1 expert of
each token; every expert is a (w1, w2) GELU MLP, stacked along a leading E
axis. Dispatch is the reference's dense one: every expert runs on every
token and the one-hot route zeroes the rest, so the einsums below are plain
products outside any kernel.

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


def moe_ffn_parts(x: torch.Tensor, p: dict, cfg: MoEConfig,
                  mask: Optional[torch.Tensor] = None):
    """x ``[B, T, D]``, mask ``[B, T]`` valid tokens or None →
    ``(out [B, T, D], route_sum [E], prob_sum [E], token_count)``."""
    dt = x.dtype
    logits = x.float() @ p["gate"].float()                          # [B,T,E]
    probs = torch.softmax(logits, dim=-1)
    route = F.one_hot(probs.argmax(dim=-1), cfg.n_experts).float()  # [B,T,E]
    gate_val = (probs * route).sum(dim=-1, keepdim=True)            # [B,T,1]
    h = torch.einsum("btd,edf->ebtf", x, p["w1"].to(dt))
    h = F.gelu(h, approximate="tanh")
    y = torch.einsum("ebtf,efd->ebtd", h, p["w2"].to(dt))
    out = torch.einsum("ebtd,bte->btd", y.float(), route)
    out = (out * gate_val).to(dt)
    m = torch.ones(x.shape[:2], dtype=torch.float32, device=x.device) \
        if mask is None else mask.float()
    route_sum = (route * m[:, :, None]).sum(dim=(0, 1))
    prob_sum = (probs * m[:, :, None]).sum(dim=(0, 1))
    return out, route_sum, prob_sum, m.sum()


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
