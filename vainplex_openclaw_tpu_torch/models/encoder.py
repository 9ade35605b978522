"""CortexEncoder forward in PyTorch.

Counterpart of ``vainplex_openclaw_tpu/models/encoder.py``: the same
configuration, the same parameter tree and the same dense forward. The
parameters are a nested dict of tensors laid out as the JAX tree is
(``embed/tok``, ``blocks[i]/attn/q``, …), with matrices kept in JAX's
``[in, out]`` layout so every projection is ``x @ w``.

Numerics that must match the JAX forward, each pinned by a test:

- GELU is the tanh form (``jax.nn.gelu``'s default);
- RMSNorm runs in fp32 with eps 1e-6 inside the rsqrt, then casts back;
- the embedding gather, the positional add and the residual adds run in
  the activation dtype;
- pooling is fp32 over ``tokens > 0`` with the denominator clamped ≥ 1, the
  heads are fp32, and the embedding is divided by ``norm + 1e-6``;
- ``attn_impl="dense"`` rounds q·kᵀ to the activation dtype before the
  fp32 softmax, as the JAX dense path does; ``"flash"`` does not (the
  kernel keeps scores in fp32). ``"auto"`` is ``"flash"`` on every device:
  the card's main path is the kernel.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.flash_attention import flash_attention

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}
_KEEP_FP32 = frozenset({"norm1", "norm2", "final_norm", "heads"})


@dataclass(frozen=True)
class EncoderConfig:
    vocab_size: int = 8192
    seq_len: int = 128
    d_model: int = 256
    n_heads: int = 8
    n_layers: int = 4
    d_ff: int = 1024
    n_severity: int = 4   # info | low | medium | high-critical
    n_mood: int = 5       # frustrated | neutral | satisfied | urgent | confused
    dtype: str = "bfloat16"  # activation dtype by name (a key of DTYPES)
    attn_impl: str = "auto"  # "auto" | "flash" | "dense"
    n_experts: int = 0       # > 0 (MoE FFN) is not ported yet
    moe_aux_weight: float = 0.01
    # Accepted for config parity: the JAX package scans stacked blocks to
    # shorten its trace. PyTorch runs eagerly, so the same loop runs.
    scan_blocks: bool = False

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]


def param_shapes(cfg: EncoderConfig) -> dict:
    """``{path_key: shape}`` of the dense parameter tree, as the JAX
    ``init_params`` lays it out."""
    if cfg.n_experts > 0:
        raise NotImplementedError("MoE encoder blocks are not ported yet")
    D, F_ = cfg.d_model, cfg.d_ff
    shapes = {"embed/tok": (cfg.vocab_size, D), "embed/pos": (cfg.seq_len, D),
              "final_norm/scale": (D,),
              "heads/severity": (D, cfg.n_severity), "heads/keep": (D, 2),
              "heads/mood": (D, cfg.n_mood), "heads/embed_proj": (D, D)}
    for i in range(cfg.n_layers):
        for name in ("q", "k", "v", "o"):
            shapes[f"blocks/{i}/attn/{name}"] = (D, D)
        shapes[f"blocks/{i}/norm1/scale"] = (D,)
        shapes[f"blocks/{i}/norm2/scale"] = (D,)
        shapes[f"blocks/{i}/mlp/w1"] = (D, F_)
        shapes[f"blocks/{i}/mlp/w2"] = (F_, D)
    return shapes


def flatten_tree(tree, prefix: str = "") -> dict:
    """Nested dicts and lists → ``{path_key: leaf}`` with JAX-style keys."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    flat = {}
    for k, v in items:
        flat.update(flatten_tree(v, f"{prefix}/{k}" if prefix else str(k)))
    return flat


def unflatten_tree(flat: dict) -> dict:
    """``{path_key: leaf}`` → the nested tree; ``blocks`` becomes a list."""
    tree: dict = {}
    for key, leaf in flat.items():
        node = tree
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf
    if "blocks" in tree:
        blocks = tree["blocks"]
        tree["blocks"] = [blocks[str(i)] for i in range(len(blocks))]
    return tree


def _to_tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        # an ml_dtypes array from JAX: move the bits, never through float
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def params_from_numpy(tree: dict, cfg: EncoderConfig,
                      device: "str | torch.device",
                      cast: bool = True) -> dict:
    """The JAX parameter tree (leaves as numpy arrays, ``ml_dtypes`` bf16
    included, or CPU tensors) → the port's tree on ``device``. Every leaf
    must be present with its ``init_params`` shape. ``cast=True`` applies
    the JAX ``cast_params`` rule: every leaf becomes ``cfg.dtype`` except
    those under ``norm1``, ``norm2``, ``final_norm`` and ``heads``, which
    keep their dtype."""
    flat = flatten_tree(tree)
    want = param_shapes(cfg)
    missing, extra = sorted(set(want) - set(flat)), sorted(set(flat) - set(want))
    if missing or extra:
        raise KeyError(f"parameter tree mismatch: missing {missing[:5]}, "
                       f"extra {extra[:5]}")
    out = {}
    for key, leaf in flat.items():
        t = _to_tensor(leaf)
        if tuple(t.shape) != want[key]:
            raise ValueError(f"{key}: shape {tuple(t.shape)} != {want[key]}")
        if cast and not (set(key.split("/")) & _KEEP_FP32):
            t = t.to(cfg.torch_dtype)
        out[key] = t.to(device)
    return unflatten_tree(out)


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    rms = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + 1e-6)
    return (x32 * rms * scale).to(x.dtype)


def _attention(x: torch.Tensor, p: dict, n_heads: int, mask: torch.Tensor,
               impl: str) -> torch.Tensor:
    B, L, D = x.shape
    H, Dh = n_heads, D // n_heads
    dt = x.dtype

    def heads(w):
        return (x @ w.to(dt)).reshape(B, L, H, Dh).transpose(1, 2).contiguous()

    q, k, v = heads(p["q"]), heads(p["k"]), heads(p["v"])
    if impl == "auto":
        impl = "flash"
    if impl == "flash":
        out = flash_attention(q, k, v, mask)
    elif impl == "dense":
        scores = torch.einsum("bhqd,bhkd->bhqk", q, k).float() / math.sqrt(Dh)
        scores = torch.where(mask[:, None, None, :], scores, -1e30)
        probs = torch.softmax(scores, dim=-1).to(dt)
        out = torch.einsum("bhqk,bhkd->bhqd", probs, v)
    else:
        raise ValueError(f"unknown attn_impl {impl!r}")
    out = out.transpose(1, 2).reshape(B, L, D)
    return out @ p["o"].to(dt)


def _block(x: torch.Tensor, p: dict, n_heads: int, mask: torch.Tensor,
           impl: str) -> torch.Tensor:
    x = x + _attention(_rmsnorm(x, p["norm1"]["scale"]), p["attn"], n_heads,
                       mask, impl)
    h = _rmsnorm(x, p["norm2"]["scale"])
    dt = x.dtype
    h = F.gelu(h @ p["mlp"]["w1"].to(dt), approximate="tanh") \
        @ p["mlp"]["w2"].to(dt)
    return x + h


def forward(params: dict, tokens: torch.Tensor, cfg: EncoderConfig) -> dict:
    """tokens ``[B, L]`` int on the parameters' device →
    ``{severity, keep, mood}`` fp32 logits, the unit-norm pooled
    ``embedding`` and ``moe_aux`` (0 for the dense MLP)."""
    if cfg.n_experts > 0:
        raise NotImplementedError("MoE encoder blocks are not ported yet")
    tokens = tokens.long()
    mask = tokens > 0
    dt = cfg.torch_dtype
    x = params["embed"]["tok"].to(dt)[tokens] \
        + params["embed"]["pos"].to(dt)[None, :, :]
    for p in params["blocks"]:
        x = _block(x, p, cfg.n_heads, mask, cfg.attn_impl)
    x = _rmsnorm(x, params["final_norm"]["scale"])
    denom = mask.sum(dim=1, keepdim=True).clamp_min(1).float()
    pooled = (x.float() * mask[:, :, None]).sum(dim=1) / denom
    heads = params["heads"]
    emb = pooled @ heads["embed_proj"]
    return {
        "severity": pooled @ heads["severity"],
        "keep": pooled @ heads["keep"],
        "mood": pooled @ heads["mood"],
        "embedding": emb / (torch.linalg.vector_norm(
            emb, dim=-1, keepdim=True) + 1e-6),
        "moe_aux": torch.zeros((), dtype=torch.float32, device=x.device),
    }
