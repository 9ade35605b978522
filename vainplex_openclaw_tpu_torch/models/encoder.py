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
  the card's main path is the kernel;
- with ``n_experts > 0`` each block's FFN is the mixture of experts of
  ``models/moe.py`` and ``moe_aux`` sums its load-balance loss over layers.

The forward is differentiable: every parameter is cast to the activation
dtype where it is used, so a training step keeps fp32 masters.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.flash_attention import flash_attention
from . import prng
from .moe import (MoEConfig, load_balance_loss, moe_ffn_parts, moe_init_std,
                  moe_shapes)

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
    n_experts: int = 0       # 0 = dense MLP; > 0 = MoE FFN (models/moe.py)
    moe_aux_weight: float = 0.01
    # The JAX package scans stacked blocks to shorten its trace; here
    # ``forward`` then takes the stacked tree (:func:`stack_blocks`) and
    # loops over its leading axis, and refuses a per-layer list as JAX does.
    scan_blocks: bool = False

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    @property
    def moe(self) -> MoEConfig:
        return MoEConfig(self.d_model, self.d_ff, self.n_experts)


def param_shapes(cfg: EncoderConfig) -> dict:
    """``{path_key: shape}`` of the parameter tree, as the JAX
    ``init_params`` lays it out: ``blocks/i/mlp/{w1,w2}``, or with
    ``n_experts > 0`` ``blocks/i/moe/{gate,w1,w2}``."""
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
        if cfg.n_experts > 0:
            for name, shape in moe_shapes(cfg.moe).items():
                shapes[f"blocks/{i}/moe/{name}"] = shape
        else:
            shapes[f"blocks/{i}/mlp/w1"] = (D, F_)
            shapes[f"blocks/{i}/mlp/w2"] = (F_, D)
    return shapes


def init_params(cfg: EncoderConfig, generator: torch.Generator) -> dict:
    """A random fp32 parameter tree on the CPU with the JAX
    ``init_params`` shapes and scales: embeddings ``N(0, 0.02²)``, every
    matrix ``N(0, 1/fan_in)``, norm scales 1, and the MoE leaves as
    ``models/moe.py`` scales them. The values are not JAX's
    (another generator); the parity tests carry JAX's weights across with
    :func:`params_from_numpy` instead."""
    flat = {}
    for key, shape in param_shapes(cfg).items():
        if key.endswith("/scale"):
            flat[key] = torch.ones(shape, dtype=torch.float32)
            continue
        if key.startswith("embed/"):
            std = 0.02
        elif "/moe/" in key:
            std = moe_init_std(key.rsplit("/", 1)[1], shape)
        else:
            std = 1.0 / math.sqrt(shape[0])
        flat[key] = torch.randn(shape, generator=generator,
                                dtype=torch.float32) * std
    return unflatten_tree(flat)


def init_params_from_seed(cfg: EncoderConfig, seed: int) -> dict:
    """The fp32 tree the JAX package's ``init_params(PRNGKey(seed), cfg)``
    draws, as CPU tensors: the same keys in the same order
    (``split(key, 6 + 8 n_layers)``: the embeddings, the four heads, then
    per layer q, k, v, o and the MLP's w1, w2, or one key that
    ``init_moe_params`` splits in three for gate, w1, w2), each leaf
    ``normal(key, shape) * scale`` in float32 (``models/prng.py``). The
    draws are JAX's within 1e-6 per unit normal. The fallbacks that run
    without a checkpoint use it, as JAX seeds ``PRNGKey`` there; training
    from scratch draws from a ``torch.Generator`` (:func:`init_params`)."""
    keys = iter(prng.split(prng.prng_key(seed), 6 + cfg.n_layers * 8))

    def draw(key, shape, scale):
        return torch.from_numpy(prng.normal(key, shape) * np.float32(scale))

    flat = {}
    for name in ("embed/tok", "embed/pos", "heads/severity", "heads/keep",
                 "heads/mood", "heads/embed_proj"):
        shape = param_shapes(cfg)[name]
        scale = 0.02 if name.startswith("embed/") else 1 / math.sqrt(shape[0])
        flat[name] = draw(next(keys), shape, scale)
    flat["final_norm/scale"] = torch.ones(cfg.d_model)
    for i in range(cfg.n_layers):
        for name in ("q", "k", "v", "o"):
            flat[f"blocks/{i}/attn/{name}"] = draw(
                next(keys), (cfg.d_model, cfg.d_model),
                1 / math.sqrt(cfg.d_model))
        for name in ("norm1", "norm2"):
            flat[f"blocks/{i}/{name}/scale"] = torch.ones(cfg.d_model)
        if cfg.n_experts > 0:
            sub = prng.split(next(keys), 3)
            for key, (name, shape) in zip(sub, moe_shapes(cfg.moe).items()):
                flat[f"blocks/{i}/moe/{name}"] = draw(
                    key, shape, moe_init_std(name, shape))
        else:
            for name, shape in (("w1", (cfg.d_model, cfg.d_ff)),
                                ("w2", (cfg.d_ff, cfg.d_model))):
                flat[f"blocks/{i}/mlp/{name}"] = draw(
                    next(keys), shape, 1 / math.sqrt(shape[0]))
    return unflatten_tree(flat)


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
    blocks = tree.get("blocks")
    if isinstance(blocks, dict) and all(k.isdigit() for k in blocks):
        # a per-layer list; a stacked stage tree keeps its dict
        tree["blocks"] = [blocks[str(i)] for i in range(len(blocks))]
    return tree


def stack_blocks(params: dict) -> dict:
    """The per-layer ``blocks`` list stacked into one tree whose leaves
    lead ``[n_layers]``: the layout ``forward`` takes under
    ``cfg.scan_blocks``. Every block must have the same leaves and shapes."""
    blocks = params["blocks"]

    def stack(nodes):
        if isinstance(nodes[0], dict):
            return {k: stack([n[k] for n in nodes]) for k in nodes[0]}
        return torch.stack(nodes)

    return {**params, "blocks": stack(list(blocks))}


def _layer(stacked, i: int):
    """Layer ``i`` of a stacked block tree."""
    if isinstance(stacked, dict):
        return {k: _layer(v, i) for k, v in stacked.items()}
    return stacked[i]


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


def _split_heads(x: torch.Tensor, w: torch.Tensor,
                 n_heads: int) -> torch.Tensor:
    """``[B, L, D] @ w`` (``w`` ``[D, H·Dh]``) → contiguous
    ``[B, H, L, Dh]``."""
    B, L, _ = x.shape
    return (x @ w.to(x.dtype)).reshape(B, L, n_heads, -1) \
        .transpose(1, 2).contiguous()


def _merge_heads(out: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``[B, H, L, Dh]`` → ``[B, L, D] @ w``."""
    B, H, L, Dh = out.shape
    return out.transpose(1, 2).reshape(B, L, H * Dh) @ w.to(out.dtype)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           mask: torch.Tensor, impl: str) -> torch.Tensor:
    """Attention over ``[B, H, L, Dh]`` heads with the ``[B, L]`` key
    mask: the kernel (``"flash"``, and ``"auto"``) or the dense scores."""
    if impl == "auto":
        impl = "flash"
    if impl == "flash":
        return flash_attention(q, k, v, mask)
    if impl == "dense":
        scores = torch.einsum("bhqd,bhkd->bhqk", q, k).float() \
            / math.sqrt(q.shape[-1])
        scores = torch.where(mask[:, None, None, :], scores, -1e30)
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        return torch.einsum("bhqk,bhkd->bhqd", probs, v)
    raise ValueError(f"unknown attn_impl {impl!r}")


def _attention(x: torch.Tensor, p: dict, n_heads: int, mask: torch.Tensor,
               impl: str) -> torch.Tensor:
    q, k, v = (_split_heads(x, p[n], n_heads) for n in ("q", "k", "v"))
    return _merge_heads(attend(q, k, v, mask, impl), p["o"])


def _mlp(x: torch.Tensor, p: dict) -> torch.Tensor:
    """The block's second half: ``x + gelu(norm2(x) @ w1) @ w2``."""
    h = _rmsnorm(x, p["norm2"]["scale"])
    dt = x.dtype
    return x + F.gelu(h @ p["mlp"]["w1"].to(dt), approximate="tanh") \
        @ p["mlp"]["w2"].to(dt)


def attention_half(x: torch.Tensor, p: dict, cfg: EncoderConfig,
                   mask: torch.Tensor) -> torch.Tensor:
    """The block's first half: ``x + attn(norm1(x))``."""
    return x + _attention(_rmsnorm(x, p["norm1"]["scale"]), p["attn"],
                          cfg.n_heads, mask, cfg.attn_impl)


def ffn_half(x: torch.Tensor, p: dict, cfg: EncoderConfig,
             mask: torch.Tensor):
    """The block's second half → ``(x, sums)``: the MoE FFN's
    load-balance sums ``(route_sum, prob_sum, count)``, or None for the
    dense MLP."""
    if cfg.n_experts > 0:
        if "moe" not in p:
            raise ValueError(f"n_experts={cfg.n_experts} but the block has "
                             "no moe leaves (a dense parameter tree)")
        y, *sums = moe_ffn_parts(_rmsnorm(x, p["norm2"]["scale"]), p["moe"],
                                 cfg.moe, mask)
        return x + y, tuple(sums)
    return _mlp(x, p), None


def block_aux(sums, cfg: EncoderConfig, device) -> torch.Tensor:
    """One block's load-balance loss from :func:`ffn_half`'s sums; 0 for
    the dense MLP."""
    if sums is None:
        return torch.zeros((), dtype=torch.float32, device=device)
    return load_balance_loss(*sums, cfg.n_experts)


def _block(x: torch.Tensor, p: dict, cfg: EncoderConfig,
           mask: torch.Tensor):
    """One block → ``(x, aux)``: the MoE load-balance loss, or 0 for the
    dense MLP."""
    x, sums = ffn_half(attention_half(x, p, cfg, mask), p, cfg, mask)
    return x, block_aux(sums, cfg, x.device)


def embed(params: dict, tokens: torch.Tensor, cfg: EncoderConfig,
          offset: int = 0) -> torch.Tensor:
    """tokens ``[B, L]`` → the token embedding plus positions ``offset ..
    offset + L`` of the positional table, in the activation dtype."""
    dt = cfg.torch_dtype
    L = tokens.shape[1]
    return params["embed"]["tok"].to(dt)[tokens.long()] \
        + params["embed"]["pos"].to(dt)[offset:offset + L][None, :, :]


def pool_outputs(x: torch.Tensor, mask: torch.Tensor, params: dict,
                 moe_aux: "torch.Tensor | None" = None) -> dict:
    """The final norm, the fp32 mean over the valid tokens (the
    denominator clamped ≥ 1) and the heads."""
    x = _rmsnorm(x, params["final_norm"]["scale"])
    denom = mask.sum(dim=1, keepdim=True).clamp_min(1).float()
    pooled = (x.float() * mask[:, :, None]).sum(dim=1) / denom
    return _outputs(pooled, params["heads"], moe_aux)


def _outputs(pooled: torch.Tensor, heads: dict,
             moe_aux: "torch.Tensor | None" = None) -> dict:
    """The fp32 heads on the pooled ``[B, D]`` vector."""
    emb = pooled @ heads["embed_proj"]
    return {
        "severity": pooled @ heads["severity"],
        "keep": pooled @ heads["keep"],
        "mood": pooled @ heads["mood"],
        "embedding": emb / (torch.linalg.vector_norm(
            emb, dim=-1, keepdim=True) + 1e-6),
        "moe_aux": moe_aux if moe_aux is not None else torch.zeros(
            (), dtype=torch.float32, device=pooled.device),
    }


def forward(params: dict, tokens: torch.Tensor, cfg: EncoderConfig) -> dict:
    """tokens ``[B, L]`` int on the parameters' device →
    ``{severity, keep, mood}`` fp32 logits, the unit-norm pooled
    ``embedding`` and ``moe_aux`` (the MoE load-balance loss summed over
    layers; 0 for the dense MLP). Under ``cfg.scan_blocks`` the blocks are
    the stacked tree of :func:`stack_blocks`, run layer by layer."""
    blocks = params["blocks"]
    if cfg.scan_blocks:
        if not isinstance(blocks, dict):
            raise ValueError(
                "cfg.scan_blocks=True requires stacked block params — pass "
                "the tree through models.stack_blocks(params) first")
        n = next(iter(flatten_tree(blocks).values())).shape[0]
        blocks = [_layer(blocks, i) for i in range(n)]
    mask = tokens > 0
    x = embed(params, tokens, cfg)
    moe_aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p in blocks:
        x, aux = _block(x, p, cfg, mask)
        moe_aux = moe_aux + aux
    return pool_outputs(x, mask, params, moe_aux)
