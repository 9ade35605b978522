"""The ``forward`` runner of the mesh plans: the encoder forward per grid row.

The JAX package serves these plans with one jitted forward whose
collectives GSPMD derives from the rule table. The port writes them out.
Each dp row of the placement (``plan.Placement``) serves its rows of the
batch; within a row, the column axis holds what the rules split:

- ``embed/tok`` and ``embed/pos`` split over d_model: each column looks up
  its columns, and the pieces are concatenated (an all-gather), which is
  bit-equal to the whole lookup;
- ``attn/q``, ``attn/k``, ``attn/v`` column-split and ``attn/o``
  row-split (Megatron): each column projects its heads and runs
  ``attend`` on them (kernel K1 on a CUDA tensor), and the partial
  products of ``attn/o`` are summed (a psum) before the residual. Where a
  column holds part of a head only (tp above the head count), the columns
  of one head are gathered onto the first of them, which runs the head;
- ``mlp/w1`` column-split and ``mlp/w2`` row-split: GELU per column and a
  psum of the ``w2`` partials;
- ``moe/w1`` and ``moe/w2`` split over the expert axis: the router runs
  once on the row's first column, each column runs the dense dispatch of
  its E/ep experts (``moe.moe_combine``), and the fp32 partial combines
  are summed before the top-1 gate value and the cast, as the JAX einsum
  over a sharded expert axis does.

Everything else (norms, the router, the heads, and any half-block whose
leaves the rules replicate) runs once per row, on the row's first column,
where the activations live, through the same functions as
``encoder.forward``. Each row of an MoE model returns its per-layer
load-balance sums, and :func:`forward_placed` takes the loss over the
whole batch. A layout the rules give that this runner does not derive
raises ``NotImplementedError``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models.encoder import (_rmsnorm, attend, attention_half, block_aux,
                              embed, ffn_half, pool_outputs)
from ..models.moe import moe_combine, moe_route, moe_sums
from .plan import Placement, gather_rows, plan_axes

# The split the runner derives for each leaf it may find split over the
# column axis c: "col" (None, c), "row" (c, None), "expert" (c, None, None).
_SPLITS = {"embed/tok": "col", "embed/pos": "col", "attn/q": "col",
           "attn/k": "col", "attn/v": "col", "attn/o": "row",
           "mlp/w1": "col", "mlp/w2": "row", "moe/w1": "expert",
           "moe/w2": "expert"}


def psum(parts: list, device: torch.device, site: str) -> torch.Tensor:
    """The sum of the per-column partials ``parts`` on ``device``, in
    column order. ``site`` names the collective (``"attn/o"``,
    ``"mlp/w2"``, ``"moe/combine"``)."""
    total = parts[0].to(device, non_blocking=True)
    for part in parts[1:]:
        total = total + part.to(device, non_blocking=True)
    return total


def _gather_cols(parts: list, device: torch.device) -> torch.Tensor:
    """The all-gather of column pieces along the last dimension."""
    return torch.cat([p.to(device, non_blocking=True) for p in parts],
                     dim=-1)


def layout(placement: Placement) -> dict:
    """``{"embed", "attn", "mlp", "moe"}`` → whether the column axis
    splits that part, read off the placed specs; raises on a spec this
    runner does not derive."""
    col = plan_axes(placement.plan)[1]
    want = {"col": (None, col), "row": (col, None),
            "expert": (col, None, None)}
    seen: dict = {}
    for key, spec in placement.specs.items():
        part = next((p for p in _SPLITS if key.endswith(p)), None)
        is_split = col is not None and col in spec
        if is_split and (part is None or spec != want[_SPLITS[part]]):
            raise NotImplementedError(
                f"the forward runner does not derive {key!r} with spec "
                f"{spec} over the column axis {col!r}")
        if part is not None:
            seen.setdefault(part.split("/")[0], set()).add(is_split)
    for part, flags in seen.items():
        if len(flags) > 1:
            raise NotImplementedError(
                f"the rules split some {part!r} leaves over {col!r} and "
                "not others")
    return {part: flags == {True} for part, flags in seen.items()}


def _tp_attention(h: torch.Tensor, blocks: list, devs: list,
                  mask: torch.Tensor, cfg) -> torch.Tensor:
    """Megatron attention over the row's columns; ``h`` is the normed
    input on the first column. Returns the psum of the ``attn/o``
    partials there."""
    tp, D, H = len(devs), cfg.d_model, cfg.n_heads
    Dh, width = D // H, D // tp
    if D % tp or (width % Dh and Dh % width):
        raise ValueError(f"tp={tp} cuts d_model {D} ({H} heads of {Dh}) "
                         "into pieces that neither hold whole heads nor "
                         "divide one")
    per = max(1, Dh // width)  # columns that share one head
    home, dt = devs[0], h.dtype
    hs = [h.to(d, non_blocking=True) for d in devs]
    proj = {n: [x @ b["attn"][n].to(dt) for x, b in zip(hs, blocks)]
            for n in ("q", "k", "v")}
    outs: list = [None] * tp
    for first in range(0, tp, per):
        owner = devs[first]
        q, k, v = (proj[n][first] if per == 1 else
                   _gather_cols(proj[n][first:first + per], owner)
                   for n in ("q", "k", "v"))
        B, L, cols = q.shape
        q, k, v = (t.reshape(B, L, cols // Dh, Dh).transpose(1, 2)
                   .contiguous() for t in (q, k, v))
        out = attend(q, k, v, mask.to(owner, non_blocking=True),
                     cfg.attn_impl)
        out = out.transpose(1, 2).reshape(B, L, cols)
        for i in range(per):
            outs[first + i] = out[..., i * width:(i + 1) * width].to(
                devs[first + i], non_blocking=True)
    return psum([o @ b["attn"]["o"].to(dt) for o, b in zip(outs, blocks)],
                home, "attn/o")


def _tp_mlp(h: torch.Tensor, blocks: list, devs: list) -> torch.Tensor:
    dt = h.dtype
    return psum([F.gelu(h.to(d, non_blocking=True) @ b["mlp"]["w1"].to(dt),
                        approximate="tanh") @ b["mlp"]["w2"].to(dt)
                 for d, b in zip(devs, blocks)], devs[0], "mlp/w2")


def _ep_ffn(x: torch.Tensor, blocks: list, devs: list, mask: torch.Tensor,
            cfg):
    """The block's second half with the experts split over the row's
    columns → ``(x, (route_sum, prob_sum, count))``: the router on the
    first column, each column's combine over its experts, and the fp32
    partials summed before the gate value and the cast."""
    h = _rmsnorm(x, blocks[0]["norm2"]["scale"])
    probs, route, gate_val = moe_route(h, blocks[0]["moe"]["gate"],
                                       cfg.n_experts)
    local = cfg.n_experts // len(devs)
    combined = psum([
        moe_combine(h.to(d, non_blocking=True), b["moe"]["w1"],
                    b["moe"]["w2"],
                    route[..., j * local:(j + 1) * local].to(
                        d, non_blocking=True))
        for j, (d, b) in enumerate(zip(devs, blocks))],
        devs[0], "moe/combine")
    return x + (combined * gate_val).to(h.dtype), moe_sums(probs, route, mask)


def forward_row(trees: list, tokens: torch.Tensor, devs: list, cfg,
                split: dict) -> tuple:
    """The encoder forward of one dp row: ``trees[j]`` the placed tree of
    column j on ``devs[j]``, ``tokens`` ``[B, L]`` on ``devs[0]`` →
    ``(outputs, sums)``: the batched outputs of ``encoder.forward`` on
    ``devs[0]`` and each MoE layer's load-balance sums. A block that the
    rules leave whole runs as ``encoder.forward`` runs it."""
    mask = tokens > 0
    if split.get("embed", False):
        x = _gather_cols([embed(t, tokens.to(d, non_blocking=True), cfg)
                          for t, d in zip(trees, devs)], devs[0])
    else:
        x = embed(trees[0], tokens, cfg)
    parts = []
    for layer in range(cfg.n_layers):
        blocks = [t["blocks"][layer] for t in trees]
        b0 = blocks[0]
        if split.get("attn", False):
            x = x + _tp_attention(_rmsnorm(x, b0["norm1"]["scale"]), blocks,
                                  devs, mask, cfg)
        else:
            x = attention_half(x, b0, cfg, mask)
        if split.get("moe", False):
            x, sums = _ep_ffn(x, blocks, devs, mask, cfg)
        elif split.get("mlp", False):
            x, sums = x + _tp_mlp(_rmsnorm(x, b0["norm2"]["scale"]), blocks,
                                  devs), None
        else:
            x, sums = ffn_half(x, b0, cfg, mask)
        if sums is not None:
            parts.append(sums)
    return pool_outputs(x, mask, trees[0]), parts


def whole_batch_aux(row_parts: list, cfg, device: torch.device):
    """The MoE load-balance loss of the whole batch from each dp row's
    per-layer sums: each layer's sums are added over the rows before its
    loss, which is not linear in them, as the JAX mesh forward computes
    it over the global batch."""
    aux = block_aux(None, cfg, device)
    for layer in zip(*row_parts):
        aux = aux + block_aux(tuple(sum(s[k].to(device) for s in layer)
                                    for k in range(3)), cfg, device)
    return aux


def forward_placed(placement: Placement, shards: list, cfg) -> dict:
    """The mesh forward of a ``"forward"`` plan: ``shards[i][0]`` the
    tokens of dp row i (``plan.place_tokens``) → the outputs of
    ``encoder.forward`` on the mesh's first device."""
    split = layout(placement)
    rows = [forward_row(trees, row[0], devs, cfg, split)
            for trees, row, devs in zip(placement.trees, shards,
                                        placement.grid)]
    home = placement.mesh.devices[0]
    out = gather_rows([o for o, _ in rows], home)
    out["moe_aux"] = whole_batch_aux([p for _, p in rows], cfg, home)
    return out
