"""Long-context path for the encoder: the sequence-parallel forward.

Counterpart of ``vainplex_openclaw_tpu/models/long_context.py``.
:func:`forward_long` computes what ``models.encoder.forward`` computes, cut
over a (dp, sp) :class:`~..parallel.mesh.Mesh`: each dp row takes a slice
of the batch, each sp column a slice of the sequence, and every block's
attention is ring attention (``parallel/ring_attention.py``), so no device
holds the full L×L scores or the full sequence of activations. Positions
come from the positional table sliced per sp shard. The masked mean-pool is
a sum over the sp shards of each row, gathered on the row's first device,
where the heads run. Rows run one after another from this one process; on
distinct cards their kernels overlap, since nothing here synchronises.

An MoE block runs its FFN on each shard (``encoder.ffn_half``), and each
layer's load-balance sums are added over every dp row and sp column before
the loss, as the JAX forward psums them over (dp, sp): the loss is not
linear in the sums, so ``moe_aux`` is the whole batch's
(``sharded_forward.whole_batch_aux``).
"""

from __future__ import annotations

import dataclasses

from ..parallel.mesh import Mesh
from ..parallel.plan import (PLAN_TABLE, Placement, gather_rows,
                             place_params, split_tokens)
from ..parallel.ring_attention import ring_attention_local
from ..parallel.sharded_forward import whole_batch_aux
from .encoder import (EncoderConfig, _merge_heads, _outputs, _rmsnorm,
                      _split_heads, embed, ffn_half)


def long_context_config(L: int) -> EncoderConfig:
    """The repository's long-context model (``bench.py``'s
    ``long_context_config``): a deliberately narrow encoder at sequence
    length ``L``. ``attn_impl`` stays ``"auto"`` (the kernels), where the
    JAX sweep pins ``"dense"`` to keep its CPU runs off the Pallas
    interpreter."""
    return EncoderConfig(vocab_size=512, seq_len=L, d_model=32, n_heads=2,
                         n_layers=2, d_ff=64)


def _forward_row(ps: list, tokens: list, devices: list,
                 cfg: EncoderConfig) -> tuple:
    """One dp row: ``tokens[j]`` ``[B, L/sp]`` and the placed tree
    ``ps[j]`` on ``devices[j]`` → ``(outputs, parts)``: the row's outputs
    on ``devices[0]`` and ``parts[j]``, sp column j's load-balance sums of
    each MoE layer."""
    L_loc = tokens[0].shape[1]
    masks = [t > 0 for t in tokens]
    parts: list = [[] for _ in ps]
    xs = [embed(p, t, cfg, offset=j * L_loc)
          for j, (p, t) in enumerate(zip(ps, tokens))]
    for layer in range(cfg.n_layers):
        blocks = [p["blocks"][layer] for p in ps]
        hs = [_rmsnorm(x, b["norm1"]["scale"]) for x, b in zip(xs, blocks)]
        qkv = [[_split_heads(h, b["attn"][n], cfg.n_heads)
                for h, b in zip(hs, blocks)] for n in ("q", "k", "v")]
        outs = ring_attention_local(*qkv, masks, devices,
                                    impl=cfg.attn_impl)
        halves = [ffn_half(x + _merge_heads(o, b["attn"]["o"]), b, cfg, m)
                  for x, o, b, m in zip(xs, outs, blocks, masks)]
        xs = [x for x, _ in halves]
        if cfg.n_experts > 0:
            for col, (_, sums) in zip(parts, halves):
                col.append(sums)
    head = devices[0]
    pooled = count = None
    for x, m, p in zip(xs, masks, ps):
        x = _rmsnorm(x, p["final_norm"]["scale"])
        local = (x.float() * m[:, :, None]).sum(dim=1).to(head)
        n = m.sum(dim=1).to(head)
        pooled = local if pooled is None else pooled + local
        count = n if count is None else count + n
    pooled = pooled / count.clamp_min(1)[:, None].float()
    return _outputs(pooled, ps[0]["heads"]), parts


def forward_long_placed(params: Placement, shards: list,
                        cfg: EncoderConfig, mesh: Mesh, *,
                        dp_axis: str = "dp", sp_axis: str = "sp") -> dict:
    """:func:`forward_long` on inputs already on the mesh: ``params`` is
    the placement of the family's replicated rules
    (``parallel.plan.sharded_params``), ``shards[i][j]`` the token block of
    dp row i and sp column j on its grid device
    (``parallel.plan.place_tokens``). ``moe_aux`` is the load-balance
    loss of the whole batch, on the mesh's first device."""
    grid = mesh.grid(dp_axis, sp_axis)
    rows = [_forward_row(trees, row, devs, cfg)
            for trees, row, devs in zip(params.trees, shards, grid)]
    home = mesh.devices[0]
    out = gather_rows([o for o, _ in rows], home)
    out["moe_aux"] = whole_batch_aux([col for _, cols in rows
                                      for col in cols], cfg, home)
    return out


def forward_long(params: dict, tokens, cfg: EncoderConfig, mesh: Mesh, *,
                 dp_axis: str = "dp", sp_axis: str = "sp") -> dict:
    """tokens ``[B, L]`` int (B divisible by dp, L by sp) → the outputs of
    ``encoder.forward`` (``severity``, ``keep``, ``mood``, ``embedding``,
    ``moe_aux``) on the mesh's first device, with the batch split over dp
    and the sequence over sp."""
    grid = mesh.grid(dp_axis, sp_axis)
    plan = dataclasses.replace(PLAN_TABLE["encoder_validator_long"],
                               axes=(dp_axis, sp_axis),
                               data_spec=(dp_axis, sp_axis))
    placed = place_params(params, mesh, plan)
    return forward_long_placed(placed, split_tokens(tokens, grid, True), cfg,
                               mesh, dp_axis=dp_axis, sp_axis=sp_axis)
