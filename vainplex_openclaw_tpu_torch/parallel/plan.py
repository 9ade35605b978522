"""Sharding plans for mesh serving: the subset the long-context family needs.

Counterpart of ``vainplex_openclaw_tpu/parallel/plan.py``. A plan names how
a servable family's weights and token batch lie on a :class:`~.mesh.Mesh`
and which program serves it (``runner``). A partition spec is a tuple with
one entry per tensor dimension, an axis name or ``None``; ``()`` is fully
replicated (JAX's ``P()``).

Ported here: :class:`ShardingPlan`, the ``encoder_validator_long`` family
(replicated weights, tokens over ``(dp, sp)``, ring attention) and its
short-path twin, :func:`resolve_plan`, :func:`serve_bucket`,
:func:`sharded_params` (one copy of the tree per distinct device),
:func:`place_tokens` and :func:`serve_forward` for the runners ``"long"``
and ``"forward"`` (the latter for fully replicated rules only). The
tensor-parallel, pipeline and expert-parallel families raise
``NotImplementedError``. The JAX package's searched plan table has no
``cuda:`` rows, so resolution returns the hand-written plan, as the JAX
``serving_plan`` does on a table miss.
"""

from __future__ import annotations

import dataclasses
import threading
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.similarity import pow2_bucket
from .mesh import Mesh

RUNNERS = ("forward", "pipeline", "long")

# Ring-attention long-context validator: weights fully replicated (the
# collective budget is spent on the sequence axis, not the weights);
# tokens shard [batch → dp, length → sp].
ENCODER_VALIDATOR_LONG_RULES = (("", ()),)


@dataclass(frozen=True)
class ShardingPlan:
    """One servable family's placement contract.

    ``rules``: ((regex, spec), …) over "/"-joined parameter paths, first
    match wins. ``data_spec``: how the token batch shards. ``axes``: the
    mesh axes the plan's specs name. ``bucket_min``: pow2 floor for
    :func:`serve_bucket`. ``gather``: how outputs leave the mesh.
    ``runner``: ``"forward"`` (the dense encoder forward per dp group) or
    ``"long"`` (``models/long_context.forward_long`` over ``axes`` =
    (dp, sp)). ``source``/``table_key`` are provenance."""

    family: str
    rules: tuple
    data_spec: tuple
    axes: tuple
    description: str = ""
    bucket_min: int = 1
    gather: str = "replicated"
    source: str = "handwritten"
    table_key: str = ""
    runner: str = "forward"
    microbatches: int = 0


PLAN_TABLE: dict = {
    "encoder_validator_long": ShardingPlan(
        family="encoder_validator_long",
        rules=ENCODER_VALIDATOR_LONG_RULES,
        data_spec=("dp", "sp"),
        axes=("dp", "sp"),
        description="stage-3 validator encoder, long-context: replicated "
                    "weights, tokens over (dp, sp), ring attention with "
                    "O(L/sp) activation memory per device",
        gather="sharded",
        runner="long"),
}

# Families of the JAX plan table that the port does not serve yet.
UNPORTED_FAMILIES = ("encoder_validator", "embeddings_forward",
                     "encoder_validator_pp", "encoder_validator_moe",
                     "embeddings_forward_moe")


def resolve_plan(family, mesh: "Mesh | None" = None,
                 searched: "bool | None" = None) -> ShardingPlan:
    """The plan ``family`` serves on: a :class:`ShardingPlan` passes
    through; a family name returns its hand-written plan. ``mesh`` and
    ``searched`` are accepted for the JAX signature; no searched table row
    exists for a CUDA grid, so both resolve to the hand-written plan."""
    if isinstance(family, ShardingPlan):
        return family
    plan = PLAN_TABLE.get(family)
    if plan is not None:
        return plan
    if family in UNPORTED_FAMILIES:
        raise NotImplementedError(
            f"plan family {family!r} is not ported yet")
    raise KeyError(f"no sharding plan for family {family!r} — known: "
                   f"{sorted(PLAN_TABLE)}")


def short_path_plan(plan: ShardingPlan) -> ShardingPlan:
    """The short-request twin of a long-context plan: the same family and
    weight rules (one placed tree serves both), the dense ``forward``
    runner, batch over dp only. Other plans pass through."""
    if plan.runner != "long":
        return plan
    return dataclasses.replace(
        plan, runner="forward", data_spec=(plan.axes[0],),
        gather="replicated",
        description=(plan.description + " [short path]").strip())


def check_servable(plan: ShardingPlan, mesh: Mesh) -> None:
    """Raise unless the port can serve ``plan`` on ``mesh``: the mesh
    declares the plan's axes, the runner is ported, the rules replicate."""
    missing = [a for a in plan.axes if a not in mesh.shape]
    if missing:
        raise ValueError(f"plan {plan.family!r} needs mesh axes {missing} "
                         f"but the mesh declares {mesh.axis_names}")
    if plan.runner not in ("forward", "long"):
        raise NotImplementedError(f"runner {plan.runner!r} is not ported yet")
    if any(spec != () for _, spec in plan.rules):
        raise NotImplementedError(
            f"plan {plan.family!r} shards weights; only fully replicated "
            "rules are ported")


_sharded_params: dict = {}
_sharded_lock = threading.Lock()


def sharded_params(key, params: dict, mesh: Mesh, family) -> dict:
    """``{device: tree}``: the parameter tree copied once onto every
    distinct device of ``mesh`` (the ported rules replicate every leaf).
    Cached per (key, mesh, plan); a hit needs the same ``params`` object,
    so a reloaded checkpoint is placed anew."""
    plan = resolve_plan(family, mesh)
    check_servable(plan, mesh)
    ck = (key, mesh, plan)
    with _sharded_lock:
        hit = _sharded_params.get(ck)
    if hit is not None and hit[0] is params:
        return hit[1]
    placed = {dev: tree_to(params, dev) for dev in mesh.distinct_devices()}
    with _sharded_lock:
        hit = _sharded_params.get(ck)
        if hit is not None and hit[0] is params:
            return hit[1]
        _sharded_params[ck] = (params, placed)
    return placed


def tree_to(tree, device: torch.device):
    """A parameter tree with every leaf on ``device`` (leaves already there
    are shared, not copied)."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


def drop_sharded_params(key) -> int:
    """Evict every cached placement of ``key``; returns entries dropped."""
    with _sharded_lock:
        victims = [ck for ck in _sharded_params if ck[0] == key]
        for ck in victims:
            del _sharded_params[ck]
    return len(victims)


def clear_plan_caches() -> None:
    with _sharded_lock:
        _sharded_params.clear()


def serve_bucket(n: int, mesh: Mesh, dp_axis: str = "dp",
                 plan=None) -> int:
    """Batch bucket for a mesh: the pow2 bucket, floored at the plan's
    ``bucket_min`` (and microbatch count) when a plan is given, rounded up
    to a dp multiple so every shard holds at least one row."""
    b = pow2_bucket(max(n, 1))
    if plan is not None:
        p = resolve_plan(plan, mesh)
        b = max(b, p.bucket_min, p.microbatches or 1)
    dp = mesh.shape.get(dp_axis, 1)
    return -(-b // dp) * dp


def place_tokens(tokens, mesh: Mesh, family) -> list:
    """Split a (bucketed) token batch by the plan's data spec: the batch
    over the first plan axis (dp) and, when the spec names it, the
    sequence over the second (sp). Returns ``shards[i][j]``, the block of
    dp row i and sp column j on its grid device; with a batch-only spec
    each dp row holds one block, on the row's first device (the sp
    replicas of a replicated computation run once)."""
    plan = resolve_plan(family, mesh)
    grid = mesh.grid(*plan.axes)
    seq_split = len(plan.data_spec) > 1 and plan.data_spec[1] == plan.axes[1]
    return split_tokens(tokens, grid, seq_split)


def split_tokens(tokens, grid: list, seq_split: bool) -> list:
    """``tokens`` ``[B, L]`` (numpy or tensor) cut into ``[dp][sp]`` blocks
    on the devices of ``grid`` (``[dp][1]`` when not ``seq_split``)."""
    if not isinstance(tokens, torch.Tensor):
        tokens = torch.from_numpy(np.ascontiguousarray(tokens))
    B, L = tokens.shape
    dp, sp = len(grid), len(grid[0])
    if B % dp:
        raise ValueError(f"batch {B} does not split over dp={dp} "
                         "(bucket it with serve_bucket)")
    if seq_split and L % sp:
        raise ValueError(f"sequence {L} does not split over sp={sp}")
    rows = tokens.chunk(dp, dim=0)
    if not seq_split:
        return [[r.contiguous().to(grid[i][0], non_blocking=True)]
                for i, r in enumerate(rows)]
    return [[blk.contiguous().to(grid[i][j], non_blocking=True)
             for j, blk in enumerate(r.chunk(sp, dim=1))]
            for i, r in enumerate(rows)]


def serve_forward(params: dict, shards: list, cfg, mesh: Mesh,
                  family) -> dict:
    """The mesh forward for the serve path, dispatched on the plan's
    runner: ``"long"`` runs ring attention over (dp, sp); ``"forward"``
    runs the dense forward once per dp row. ``params`` comes from
    :func:`sharded_params`, ``shards`` from :func:`place_tokens`. Outputs
    are gathered along the batch on the mesh's first device."""
    plan = resolve_plan(family, mesh)
    check_servable(plan, mesh)
    if plan.runner == "long":
        from ..models.long_context import forward_long_placed

        return forward_long_placed(params, shards, cfg, mesh,
                                   dp_axis=plan.axes[0],
                                   sp_axis=plan.axes[1])
    from ..models.encoder import forward

    grid = mesh.grid(*plan.axes)
    outs = [forward(params[grid[i][0]], row[0], cfg)
            for i, row in enumerate(shards)]
    return gather_rows(outs, mesh.devices[0])


def gather_rows(outs: list, device: torch.device) -> dict:
    """Concatenate per-dp-row output dicts along the batch on ``device``;
    the batch-less ``moe_aux`` is taken from the first row."""
    gathered = {name: torch.cat([o[name].to(device) for o in outs])
                for name in outs[0] if name != "moe_aux"}
    gathered["moe_aux"] = outs[0]["moe_aux"].to(device)
    return gathered
