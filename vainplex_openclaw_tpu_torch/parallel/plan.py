"""Sharding plans for mesh serving: rule tables, placement and dispatch.

Counterpart of ``vainplex_openclaw_tpu/parallel/plan.py``. A plan names how
a servable family's weights and token batch lie on a :class:`~.mesh.Mesh`
and which program serves it (``runner``). A partition spec is a tuple with
one entry per tensor dimension, an axis name or ``None``; ``()`` is fully
replicated (JAX's ``P()``).

Every family of the JAX ``PLAN_TABLE`` is here with its rule table.
:func:`plan_shardings` arms the rule-table check
(``analysis/sharding.py``'s ``validate_rule_table``, as JAX's does) at every
placement, so a dead rule, such as the MoE rules over a dense checkpoint,
fails loudly. The port has no GSPMD: :func:`place_params` cuts every leaf
by its spec for each position of the plan's grid (:func:`plan_grid`) and
keys the placement by grid position, so a grid that repeats one device
holds as many distinct shards as a grid of distinct devices would. The
runners write out what GSPMD derives from the rules:
``parallel/sharded_forward.py`` (``"forward"``: dp rows, Megatron tensor
parallel, expert parallel), ``models/pipeline_serve.py`` (``"pipeline"``)
and ``models/long_context.py`` (``"long"``).

Searched plans. The hand-written tables are the fallback and the
equivalence oracle; the preferred plan per (device family, grid shape,
family) comes from the checked-in ``parallel/plan_table.json``, written by
the placement search (``parallel/plan_search.py``). Its ``cpu:`` rows are
the JAX package's, copied verbatim, so that on the CPU both packages
resolve the same plan and the same auto grid shape; its ``cuda:`` rows
come from the H100. :func:`serving_plan` resolves override > searched >
hand-written: a row that exists, parses and fits the mesh wins; anything
malformed or stale falls back with a ``RuntimeWarning``.
``OPENCLAW_PLAN_TABLE`` names another table and ``OPENCLAW_SEARCHED_PLANS=0``
(or ``serve.searchedPlans: false`` per config) serves the hand-written
rules. A plan's ``gather`` is resolved and kept as JAX keeps it; the
port's runners bring the outputs to the mesh's first device under either
mode.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import threading
import warnings
from contextlib import contextmanager
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ..device import backend_family
from ..ops.similarity import pow2_bucket
from .mesh import Mesh

RUNNERS = ("forward", "pipeline", "long")

# ── rule tables: (regex over "/"-joined parameter paths, spec) ──────────

# Stage-3 validator, Megatron tensor parallel: q, k, v and the MLP expand
# column-split over tp, the output projection and the MLP contract
# row-split (one sum of partials per half-block), embeddings split over
# d_model; norms and heads fall through to the catch-all.
ENCODER_VALIDATOR_RULES = (
    ("attn/q$", (None, "tp")),
    ("attn/k$", (None, "tp")),
    ("attn/v$", (None, "tp")),
    ("attn/o$", ("tp", None)),
    ("mlp/w1$", (None, "tp")),
    ("mlp/w2$", ("tp", None)),
    ("embed/tok$", (None, "tp")),
    ("embed/pos$", (None, "tp")),
    ("", ()),
)

# Knowledge embeddings, data parallel: weights replicated, batch and arena
# rows over dp.
EMBEDDINGS_FORWARD_RULES = (("", ()),)

# Pipeline parallel: written against the stacked stage tree
# (``pipeline.stack_stage_params``: block leaves lead [S, L/S] and their
# paths lose the layer index), the stage axis over pp.
ENCODER_VALIDATOR_PP_RULES = (
    ("blocks/", ("pp",)),
    ("", ()),
)

# Ring-attention long-context validator: weights replicated; tokens over
# (dp, sp).
ENCODER_VALIDATOR_LONG_RULES = (("", ()),)

# Expert-parallel MoE (validator and embeddings): the expert axis of the
# [E, D, F] and [E, F, D] expert stacks over ep, the router replicated.
MOE_EP_RULES = (
    ("moe/gate$", ()),
    ("moe/w1$", ("ep", None, None)),
    ("moe/w2$", ("ep", None, None)),
    ("", ()),
)


@dataclass(frozen=True)
class ShardingPlan:
    """One servable family's placement contract.

    ``rules``: ((regex, spec), …) over "/"-joined parameter paths, first
    match wins. ``data_spec``: how the token batch shards. ``axes``: the
    mesh axes the plan's specs name. ``bucket_min``: pow2 floor for
    :func:`serve_bucket`. ``gather``: how outputs leave the mesh.
    ``runner``: ``"forward"`` (``sharded_forward.forward_placed``),
    ``"pipeline"`` (the GPipe wavefront over ``axes[0]`` with
    ``microbatches`` microbatches) or ``"long"`` (ring attention over
    ``axes`` = (dp, sp)). ``source``/``table_key`` are provenance."""

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
    "encoder_validator": ShardingPlan(
        family="encoder_validator",
        rules=ENCODER_VALIDATOR_RULES,
        data_spec=("dp",),
        axes=("dp", "tp"),
        description="stage-3 validator encoder: batch over dp, Megatron "
                    "tensor-parallel weights over tp"),
    "embeddings_forward": ShardingPlan(
        family="embeddings_forward",
        rules=EMBEDDINGS_FORWARD_RULES,
        data_spec=("dp",),
        axes=("dp",),
        description="knowledge embeddings: replicated weights, batch and "
                    "arena rows over dp"),
    "encoder_validator_pp": ShardingPlan(
        family="encoder_validator_pp",
        rules=ENCODER_VALIDATOR_PP_RULES,
        data_spec=(),
        axes=("pp",),
        description="stage-3 validator encoder, pipeline-parallel: "
                    "stacked stages over pp, GPipe wavefront with 4 "
                    "microbatches (serve_bucket floored at the count)",
        bucket_min=4,
        runner="pipeline",
        microbatches=4),
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
    "encoder_validator_moe": ShardingPlan(
        family="encoder_validator_moe",
        rules=MOE_EP_RULES,
        data_spec=("dp",),
        axes=("dp", "ep"),
        description="stage-3 validator encoder, expert-parallel MoE: "
                    "expert matrices over ep, batch over dp, load-balance "
                    "aux surfaced in serve stats"),
    "embeddings_forward_moe": ShardingPlan(
        family="embeddings_forward_moe",
        rules=MOE_EP_RULES,
        data_spec=("dp",),
        axes=("dp", "ep"),
        description="knowledge embeddings, expert-parallel MoE: expert "
                    "matrices over ep, batch and arena rows over dp"),
}


# ── the searched plan table (JAX ``parallel/plan.py:255-622``) ──────────

PLAN_TABLE_SCHEMA = "plan-table-v1"
PLAN_TABLE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "plan_table.json")
PLAN_TABLE_ENV = "OPENCLAW_PLAN_TABLE"
SEARCHED_PLANS_ENV = "OPENCLAW_SEARCHED_PLANS"

GATHER_MODES = ("replicated", "sharded")

# The collectives a table row's ``collectives`` may name (the placement
# search's sketch grammar).
COLLECTIVE_KINDS = ("psum", "all_gather", "ppermute", "all_to_all",
                    "reduce_scatter")


def searched_plans_enabled() -> bool:
    """The process-wide switch: ``OPENCLAW_SEARCHED_PLANS=0`` serves every
    family on the hand-written rules; a config passes ``searched=False``
    instead."""
    return os.environ.get(SEARCHED_PLANS_ENV, "1") != "0"


@lru_cache(maxsize=8)
def load_plan_table(path: "str | None" = None) -> dict:
    """The parsed searched-plan table ({} when missing or invalid: the
    hand-written rules then own every key). Cached per path, so no batch
    reads the disk. A table that exists but cannot be used warns with a
    ``RuntimeWarning`` and never raises."""
    p = path or os.environ.get(PLAN_TABLE_ENV) or PLAN_TABLE_PATH
    if not os.path.exists(p):
        return {}
    try:
        with open(p, "rb") as f:
            raw = f.read()
        table = json.loads(raw.decode("utf-8"))
    except (OSError, ValueError) as exc:
        warnings.warn(
            f"searched plan table {p} unreadable ({exc}) — serving on "
            f"hand-written rules", RuntimeWarning, stacklevel=2)
        return {}
    entries = table.get("entries") if isinstance(table, dict) else None
    if not isinstance(table, dict) \
            or table.get("schema") != PLAN_TABLE_SCHEMA \
            or not isinstance(entries, dict):
        warnings.warn(
            f"searched plan table {p} has schema "
            f"{table.get('schema') if isinstance(table, dict) else None!r} "
            f"(want {PLAN_TABLE_SCHEMA!r}) — serving on hand-written rules",
            RuntimeWarning, stacklevel=2)
        return {}
    table["_path"] = p
    table["_hash"] = hashlib.sha256(raw).hexdigest()[:12]
    return table


def clear_plan_table_cache() -> None:
    """Drop the cached table (after a rewrite or a change of the env)."""
    load_plan_table.cache_clear()


def plan_table_hash(path: "str | None" = None) -> "str | None":
    """sha256[:12] of the loaded table file (None when none loads)."""
    return load_plan_table(path).get("_hash")


def plan_table_key(mesh: Mesh, family: str,
                   device_family: "str | None" = None) -> str:
    """The one key format, ``device_family:shape:family`` (shape as
    ``2x4`` in axis order; the device family of the mesh's first entry by
    default). The search writes and :func:`serving_plan` reads through
    it."""
    shape = "x".join(str(mesh.shape[a]) for a in mesh.axis_names)
    return (f"{device_family or backend_family(mesh.devices[0])}:{shape}:"
            f"{family}")


def spec_to_json(spec: tuple) -> list:
    """The JSON of a spec: per dimension an axis name, null, or a list of
    axis names (``(None, "tp")`` → ``[null, "tp"]``, ``()`` → ``[]``), as
    JAX serializes a ``PartitionSpec``."""
    out = []
    for part in spec:
        if part is None:
            out.append(None)
        elif isinstance(part, (tuple, list)):
            out.append([str(x) for x in part])
        else:
            out.append(str(part))
    return out


def spec_from_json(obj) -> tuple:
    """Inverse of :func:`spec_to_json`; raises ``ValueError`` on anything
    that is not a serialized spec."""
    if not isinstance(obj, list):
        raise ValueError(f"spec is not a list: {obj!r}")
    parts = []
    for part in obj:
        if part is None:
            parts.append(None)
        elif isinstance(part, str):
            parts.append(part)
        elif isinstance(part, list) and part \
                and all(isinstance(x, str) for x in part):
            parts.append(tuple(part))
        else:
            raise ValueError(f"bad spec element {part!r}")
    return tuple(parts)


def _spec_axes(spec: tuple) -> set:
    axes: set = set()
    for part in spec:
        if part is None:
            continue
        if isinstance(part, (tuple, list)):
            axes.update(str(x) for x in part)
        else:
            axes.add(str(part))
    return axes


def plan_entry_problems(ent) -> list:
    """Schema problems of one table row (empty: usable). The loader's
    fallback and ``plan_search.validate_plan_table`` share it, so both
    agree on what malformed means."""
    if not isinstance(ent, dict):
        return ["entry is not an object"]
    problems = []
    if "mesh_shape" in ent:
        # a factorization row (device-count key): a shape, no rules
        ms = ent["mesh_shape"]
        if not (isinstance(ms, list) and ms
                and all(isinstance(x, int) and x >= 1 for x in ms)):
            problems.append(f"mesh_shape {ms!r} is not a list of ints ≥ 1")
        return problems
    rules = ent.get("rules")
    if not isinstance(rules, list) or not rules:
        problems.append("no rules")
        return problems
    for i, r in enumerate(rules):
        if not (isinstance(r, list) and len(r) == 2
                and isinstance(r[0], str)):
            problems.append(f"rule {i} is not [pattern, spec]")
            continue
        try:
            re.compile(r[0])
        except re.error as exc:
            problems.append(f"rule {i} pattern {r[0]!r} bad regex: {exc}")
        try:
            spec_from_json(r[1])
        except ValueError as exc:
            problems.append(f"rule {i}: {exc}")
    if isinstance(rules[-1], list) and len(rules[-1]) == 2 \
            and rules[-1][0] != "":
        problems.append('last rule is not the ("", …) catch-all — an '
                        'unmatched leaf would raise at placement')
    axes = ent.get("axes")
    if not (isinstance(axes, list) and axes
            and all(isinstance(a, str) for a in axes)):
        problems.append(f"axes {axes!r} is not a list of axis names")
        axes = []
    try:
        data_spec = spec_from_json(ent.get("data_spec", []))
    except ValueError as exc:
        problems.append(f"data_spec: {exc}")
        data_spec = ()
    named: set = _spec_axes(data_spec)
    for r in rules:
        if isinstance(r, list) and len(r) == 2:
            try:
                named |= _spec_axes(spec_from_json(r[1]))
            except ValueError:
                pass
    undeclared = sorted(named - set(axes))
    if undeclared:
        problems.append(f"specs name axes {undeclared} outside the "
                        f"entry's axes {axes}")
    bm = ent.get("bucket_min", 1)
    if not (isinstance(bm, int) and 1 <= bm <= 1024
            and (bm & (bm - 1)) == 0):
        problems.append(f"bucket_min {bm!r} is not a pow2 in [1, 1024]")
    gather = ent.get("gather", "replicated")
    if gather not in GATHER_MODES:
        problems.append(f"gather {gather!r} not in {GATHER_MODES}")
    runner = ent.get("runner", "forward")
    if runner not in RUNNERS:
        problems.append(f"runner {runner!r} not in {RUNNERS}")
    mb = ent.get("microbatches", 0)
    if not (isinstance(mb, int) and 0 <= mb <= 1024
            and (mb == 0 or (mb & (mb - 1)) == 0)):
        problems.append(f"microbatches {mb!r} is not 0 or a pow2 in "
                        f"[1, 1024]")
        mb = 0
    if runner == "pipeline" and not mb:
        problems.append("pipeline runner without a microbatches count")
    colls = ent.get("collectives")
    if colls is not None:
        if not isinstance(colls, list) or any(
                not (isinstance(c, list) and len(c) == 2
                     and isinstance(c[0], str) and isinstance(c[1], str)
                     and c[0] in COLLECTIVE_KINDS) for c in colls):
            problems.append(
                f"collectives {colls!r} is not a list of [kind, site] "
                f"rows with kind in {COLLECTIVE_KINDS}")
    return problems


def _plan_from_entry(family: str, key: str, ent: dict) -> ShardingPlan:
    """A ShardingPlan from a row that passed :func:`plan_entry_problems`."""
    rules = tuple((pat, spec_from_json(spec)) for pat, spec in ent["rules"])
    return ShardingPlan(
        family=family,
        rules=rules,
        data_spec=spec_from_json(ent.get("data_spec", [])),
        axes=tuple(ent["axes"]),
        description=str(ent.get("source", "searched plan")),
        bucket_min=int(ent.get("bucket_min", 1)),
        gather=str(ent.get("gather", "replicated")),
        source="searched",
        table_key=key,
        runner=str(ent.get("runner", "forward")),
        microbatches=int(ent.get("microbatches", 0)))


def searched_plan(family: str, mesh: Mesh,
                  path: "str | None" = None) -> "ShardingPlan | None":
    """The searched plan for (device family, grid shape, family), or None
    when no usable row exists. A malformed or stale row (schema problems,
    axes the mesh does not declare) warns and gives None: the caller then
    serves on the hand-written rules."""
    entries = load_plan_table(path).get("entries") or {}
    key = plan_table_key(mesh, family)
    ent = entries.get(key)
    if ent is None:
        return None
    problems = plan_entry_problems(ent)
    if not problems:
        plan = _plan_from_entry(family, key, ent)
        missing = [a for a in plan.axes if a not in mesh.shape]
        if not missing:
            return plan
        problems = [f"plan needs mesh axes {missing} but the mesh "
                    f"declares {tuple(mesh.shape)}"]
    warnings.warn(
        f"searched plan {key} unusable ({'; '.join(problems)}) — falling "
        f"back to hand-written {family!r} rules", RuntimeWarning,
        stacklevel=2)
    return None


def preferred_mesh_shape(n_devices: int, family: str = "encoder_validator",
                         path: "str | None" = None,
                         device=None) -> "tuple | None":
    """The searched dp×tp factorization for a device count (key
    ``device_family:nN:family``, the family of ``device``), or None: the
    caller's default (``parallel/mesh._factor``). A shape whose product is
    not N is stale and warns."""
    entries = load_plan_table(path).get("entries") or {}
    key = f"{backend_family(device)}:n{int(n_devices)}:{family}"
    ent = entries.get(key)
    if ent is None:
        return None
    problems = plan_entry_problems(ent)
    ms = ent.get("mesh_shape") if isinstance(ent, dict) else None
    if not problems and int(np.prod(ms)) != int(n_devices):
        problems = [f"mesh_shape {ms} is not a factorization of "
                    f"{n_devices} devices"]
    if problems:
        warnings.warn(
            f"searched factorization {key} unusable "
            f"({'; '.join(problems)}) — using the default factorization",
            RuntimeWarning, stacklevel=2)
        return None
    return tuple(ms)


# ── resolution: override > searched > hand-written ─────────────────────

_plan_overrides: dict = {}


@contextmanager
def plan_override(family: str, plan: ShardingPlan):
    """Serve ``family`` on ``plan`` inside the block: the placement
    search's measurement seam (candidates flow through the unchanged
    batcher and embeddings backend) and a test seam. The search is serial;
    overrides are not a concurrency surface."""
    prev = _plan_overrides.get(family)
    _plan_overrides[family] = plan
    try:
        yield plan
    finally:
        if prev is None:
            _plan_overrides.pop(family, None)
        else:
            _plan_overrides[family] = prev


def serving_plan(family: str, mesh: "Mesh | None" = None,
                 searched: "bool | None" = None) -> ShardingPlan:
    """The plan a family serves on: an active :func:`plan_override`; else,
    given a mesh and unless ``searched`` is False or
    ``OPENCLAW_SEARCHED_PLANS=0`` (which wins even over ``searched=True``),
    the searched table's usable row; else the hand-written plan."""
    override = _plan_overrides.get(family)
    if override is not None:
        return override
    base = PLAN_TABLE.get(family)
    if base is None:
        raise KeyError(f"no sharding plan for family {family!r} — known: "
                       f"{sorted(PLAN_TABLE)}")
    use = searched_plans_enabled() and \
        (True if searched is None else bool(searched))
    if not use or mesh is None:
        return base
    plan = searched_plan(family, mesh)
    return plan if plan is not None else base


def resolve_plan(family, mesh: "Mesh | None" = None,
                 searched: "bool | None" = None) -> ShardingPlan:
    """:func:`serving_plan`, passing an already resolved
    :class:`ShardingPlan` through unchanged: the one resolution seam of
    every plan-consuming helper below."""
    if isinstance(family, ShardingPlan):
        return family
    return serving_plan(family, mesh, searched)


def plan_provenance(family, mesh: Mesh,
                    searched: "bool | None" = None) -> dict:
    """Which table key governs (mesh, family), the loaded table's hash,
    and whether the plan serving is ``searched`` or ``handwritten``."""
    fam = family.family if isinstance(family, ShardingPlan) else family
    plan = resolve_plan(family, mesh, searched)
    return {
        "plan_table_key": plan_table_key(mesh, fam),
        "plan_table_hash": plan_table_hash(),
        "plan_source": plan.source,
    }


def short_path_plan(plan: ShardingPlan) -> ShardingPlan:
    """The short-request twin of a long-context plan: the same family and
    weight rules, the ``forward`` runner, batch over dp only. Other plans
    pass through."""
    if plan.runner != "long":
        return plan
    return dataclasses.replace(
        plan, runner="forward", data_spec=(plan.axes[0],),
        gather="replicated",
        description=(plan.description + " [short path]").strip())


def check_servable(plan: ShardingPlan, mesh: Mesh) -> None:
    """Raise unless ``mesh`` declares every axis of ``plan`` and its
    runner is known."""
    missing = [a for a in plan.axes if a not in mesh.shape]
    if missing:
        raise ValueError(f"plan {plan.family!r} needs mesh axes {missing} "
                         f"but the mesh declares {mesh.axis_names}")
    if plan.runner not in RUNNERS:
        raise ValueError(f"runner {plan.runner!r} not in {RUNNERS}")


# ── parameter paths and rule matching ──────────────────────────────────


def _path_key(path) -> str:
    """"/"-joined key of one tree path (dict keys and list indices), the
    rendering checkpoints use for their leaf names."""
    return "/".join(str(p) for p in path)


def param_path_keys(params) -> list:
    """"/"-joined path of every leaf, in the JAX flatten order (dict keys
    sorted, lists by index)."""
    keys: list = []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, path + (i,))
        else:
            keys.append(_path_key(path))

    walk(params, ())
    return keys


def map_tree(fn, tree, path: tuple = ()):
    """``fn(path_key, leaf)`` over every leaf of a tree of dicts and lists
    (a tuple is a leaf: a spec), in the tree's structure."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_tree(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(_path_key(path), tree)


def match_partition_rules(rules, params):
    """The tree of specs for ``params`` by first-match-wins regex rules.
    Scalars and one-element leaves never partition; a leaf no rule
    matches raises (close a table with the ``("", ())`` catch-all)."""

    def spec(key: str, leaf) -> tuple:
        shape = tuple(getattr(leaf, "shape", ()))
        if len(shape) == 0 or int(np.prod(shape)) == 1:
            return ()
        for pattern, s in rules:
            if re.search(pattern, key):
                return tuple(s)
        raise ValueError(f"no partition rule matches param {key!r}")

    return map_tree(spec, params)


def plan_shardings(plan: ShardingPlan, params, mesh: Mesh):
    """The tree of specs for ``params`` on ``mesh`` per the plan, with the
    rule-table check armed: every rule must win on at least one real
    parameter path, so a dead or shadowed rule fails the placement instead
    of silently replicating what it should shard. The mesh must declare
    every axis the plan names."""
    missing = [a for a in plan.axes if a not in mesh.shape]
    if missing:
        raise ValueError(
            f"plan {plan.family!r} needs mesh axes {missing} but the mesh "
            f"declares {mesh.axis_names}")
    from ..analysis.sharding import validate_rule_table

    problems = validate_rule_table(plan.rules, param_path_keys(params),
                                   regex=True)
    if problems:
        raise ValueError(
            f"sharding plan {plan.family!r} failed rule-table validation: "
            + "; ".join(problems))
    return match_partition_rules(plan.rules, params)


def prepare_params(plan: ShardingPlan, params, mesh: Mesh):
    """The host-side transform a runner needs before placement: the
    pipeline's rules are written against the stacked stage tree, so the
    per-layer ``blocks`` list is stacked into |pp| stages (raising when
    n_layers does not divide). Other runners, and a tree already stacked,
    pass through."""
    if plan.runner != "pipeline":
        return params
    blocks = params.get("blocks") if isinstance(params, dict) else None
    if not isinstance(blocks, (list, tuple)):
        return params
    from .pipeline import stack_stage_params

    return {**params,
            "blocks": stack_stage_params(list(blocks),
                                         mesh.shape[plan.axes[0]])}


# ── placement keyed by grid position ───────────────────────────────────


def plan_axes(plan: ShardingPlan) -> tuple:
    """(row axis, column axis) of the plan's grid, either None: dp rows
    and a model column (tp, ep, sp) for two-axis plans; one row of stages
    for the pipeline; dp rows alone otherwise."""
    if len(plan.axes) >= 2:
        return plan.axes[0], plan.axes[1]
    if plan.runner == "pipeline":
        return None, plan.axes[0]
    return plan.axes[0], None


def plan_grid(plan: ShardingPlan, mesh: Mesh) -> list:
    """``[row][col]`` devices of ``plan`` on ``mesh``."""
    return mesh.grid(*plan_axes(plan))


@dataclass(frozen=True, eq=False)
class Placement:
    """A parameter tree placed per a plan: ``trees[i][j]`` is the tree of
    grid position (row i, column j) on ``grid[i][j]``, each leaf cut by its
    spec in ``specs`` (``{path_key: spec}``). Two positions on one device
    hold their own shards; a replicated leaf already on its device is
    shared, not copied (:func:`trainable` copies it per position)."""

    plan: ShardingPlan
    mesh: Mesh
    grid: list
    trees: list
    specs: dict

    def positions(self):
        """``(i, j, tree)`` of every grid position, in grid order."""
        for i, row in enumerate(self.trees):
            for j, tree in enumerate(row):
                yield i, j, tree

    def map(self, fn) -> "Placement":
        """The same placement with every leaf replaced by ``fn(leaf)``."""
        return dataclasses.replace(self, trees=[
            [map_tree(lambda _k, leaf: fn(leaf), t) for t in row]
            for row in self.trees])

    def cut(self, key: str, whole: torch.Tensor, i: int,
            j: int) -> torch.Tensor:
        """The block of the whole leaf ``whole`` (at ``key``) that grid
        position (i, j) holds, on that position's device."""
        return _shard(key, whole, self.specs[key],
                      _index(self.plan, self.grid, i, j), self.grid[i][j])

    def gather(self, device: "str | torch.device" = "cpu"):
        """The whole (prepared) tree on ``device``: every leaf's shards
        concatenated back along the dimensions its spec splits."""
        row_axis, col_axis = plan_axes(self.plan)
        flats = [[_flat(t) for t in row] for row in self.trees]

        def whole(key: str, _leaf):
            spec = self.specs[key]

            def cat(parts, axis):
                if axis is not None and axis in spec:
                    return torch.cat(parts, dim=spec.index(axis))
                return parts[0]

            rows = [cat([f[key].to(device) for f in row], col_axis)
                    for row in flats]
            return cat(rows, row_axis)

        return map_tree(whole, self.trees[0][0])


def _flat(tree) -> dict:
    leaves: dict = {}
    map_tree(lambda key, leaf: leaves.__setitem__(key, leaf), tree)
    return leaves


def _shard(key: str, leaf: torch.Tensor, spec: tuple, index: dict,
           device: torch.device) -> torch.Tensor:
    """``leaf``'s block at ``index`` (``{axis: (i, n)}``) on ``device``."""
    for dim, axis in enumerate(spec):
        i, n = index.get(axis, (0, 1))
        if axis is None or n == 1:
            continue
        size = leaf.shape[dim]
        if size % n:
            raise ValueError(f"{key}: dimension {dim} of size {size} does "
                             f"not split over {axis}={n}")
        leaf = leaf.narrow(dim, i * (size // n), size // n)
    return leaf.contiguous().to(device, non_blocking=True)


def _index(plan: ShardingPlan, grid: list, i: int, j: int) -> dict:
    """``{axis: (index, size)}`` of grid position (i, j) along the plan's
    row and column axes."""
    row_axis, col_axis = plan_axes(plan)
    return {row_axis: (i, len(grid)), col_axis: (j, len(grid[i]))}


def place_params(params, mesh: Mesh, family) -> Placement:
    """Place the host tree ``params`` on ``mesh`` per the plan of
    ``family`` (uncached; :func:`sharded_params` caches)."""
    plan = resolve_plan(family, mesh)
    check_servable(plan, mesh)
    prepared = prepare_params(plan, params, mesh)
    spec_tree = plan_shardings(plan, prepared, mesh)
    specs = _flat(spec_tree)
    grid = plan_grid(plan, mesh)
    trees = []
    for i, row in enumerate(grid):
        trees.append([])
        for j, dev in enumerate(row):
            index = _index(plan, grid, i, j)
            trees[-1].append(map_tree(
                lambda key, leaf: _shard(key, leaf, specs[key], index, dev),
                prepared))
    return Placement(plan, mesh, grid, trees, specs)


def trainable(placement: Placement) -> Placement:
    """The placement to train: at every grid position, fp32 leaves of its
    own that require grad, cloned even where two positions share a device
    or a replicated leaf, so that each position's gradient lands on its own
    copy and the cross-copy sum (``sharded_train.all_reduce_grads``) is
    what adds them, on one card as on many."""
    return placement.map(
        lambda leaf: leaf.detach().to(torch.float32).clone()
        .requires_grad_())


_sharded_params: dict = {}
_sharded_lock = threading.Lock()


def sharded_params(key, params, mesh: Mesh, family) -> Placement:
    """:func:`place_params`, cached per (key, mesh, plan). A hit needs the
    same ``params`` object, so a reloaded checkpoint is placed anew;
    placement runs outside the lock."""
    plan = resolve_plan(family, mesh)
    ck = (key, mesh, plan)
    with _sharded_lock:
        hit = _sharded_params.get(ck)
    if hit is not None and hit[0] is params:
        return hit[1]
    placed = place_params(params, mesh, plan)
    with _sharded_lock:
        hit = _sharded_params.get(ck)
        if hit is not None and hit[0] is params:
            return hit[1]
        _sharded_params[ck] = (params, placed)
    return placed


def drop_sharded_params(key) -> int:
    """Evict every cached placement of ``key``; returns entries dropped."""
    with _sharded_lock:
        victims = [ck for ck in _sharded_params if ck[0] == key]
        for ck in victims:
            del _sharded_params[ck]
    return len(victims)


def clear_plan_caches() -> None:
    """Drop every cached placement."""
    with _sharded_lock:
        _sharded_params.clear()


# ── batches ────────────────────────────────────────────────────────────


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
    """Split a (bucketed) token batch by the plan's data spec:
    ``shards[i][j]``, the block of grid row i and column j on its device
    when the spec splits the sequence over the column axis (sp), else
    ``shards[i][0]``, row i's rows on the row's first device (dp rows; the
    pipeline's whole batch on its first stage)."""
    plan = resolve_plan(family, mesh)
    grid = plan_grid(plan, mesh)
    seq_split = len(plan.data_spec) > 1 and plan.data_spec[1] == plan.axes[1]
    return split_tokens(tokens, grid, seq_split)


def split_tokens(tokens, grid: list, seq_split: bool) -> list:
    """``tokens`` ``[B, L]`` (numpy or tensor) cut into ``[row][col]``
    blocks on the devices of ``grid`` (``[row][1]`` when not
    ``seq_split``)."""
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


# ── dispatch and gather ────────────────────────────────────────────────


def serve_forward(params: Placement, shards: list, cfg, mesh: Mesh,
                  family="encoder_validator") -> dict:
    """The mesh forward for the serve path, dispatched on the plan's
    runner. ``params`` comes from :func:`sharded_params`, ``shards`` from
    :func:`place_tokens`; outputs are gathered along the batch on the
    mesh's first device."""
    plan = resolve_plan(family, mesh)
    check_servable(plan, mesh)
    if plan.runner == "pipeline":
        from ..models.pipeline_serve import pp_serve_forward

        return pp_serve_forward(params, shards, cfg, mesh, plan)
    if plan.runner == "long":
        from ..models.long_context import forward_long_placed

        return forward_long_placed(params, shards, cfg, mesh,
                                   dp_axis=plan.axes[0],
                                   sp_axis=plan.axes[1])
    from .sharded_forward import forward_placed

    return forward_placed(params, shards, cfg)


def gather_rows(outs: list, device: torch.device) -> dict:
    """Concatenate per-dp-row output dicts along the batch on ``device``;
    the batch-less ``moe_aux`` is the first row's (the ``forward`` runner
    replaces it with the loss of the whole batch)."""
    gathered = {name: torch.cat([o[name].to(device) for o in outs])
                for name in outs[0] if name != "moe_aux"}
    gathered["moe_aux"] = outs[0]["moe_aux"].to(device)
    return gathered


# ── the arena for embeddings search ────────────────────────────────────


def place_rows(rows, mesh: Mesh, dp_axis: str = "dp") -> list:
    """``rows`` ``[N, D]`` (N a dp multiple; numpy or tensor) cut over dp:
    chunk i on the first device of dp row i."""
    if not isinstance(rows, torch.Tensor):
        rows = torch.from_numpy(np.ascontiguousarray(rows))
    dp = mesh.shape.get(dp_axis, 1)
    if rows.shape[0] % dp:
        raise ValueError(f"{rows.shape[0]} rows do not split over dp={dp}")
    return [chunk.contiguous().to(mesh.device(**{dp_axis: i}),
                                  non_blocking=True)
            for i, chunk in enumerate(rows.chunk(dp, dim=0))]


def arena_scores(arena, q, mesh: Mesh, dp_axis: str = "dp") -> torch.Tensor:
    """Data-parallel cosine scores ``arena [N, D] @ q [D]``: each dp row
    scores its chunk (``arena`` from :func:`place_rows`, or a whole
    tensor, cut here) against the replicated query, and the scores are
    gathered on the mesh's first device. Callers pad N to a dp multiple;
    zero rows score 0.0 and are sliced away."""
    if isinstance(arena, (torch.Tensor, np.ndarray)):
        arena = place_rows(arena, mesh, dp_axis)
    if not isinstance(q, torch.Tensor):
        q = torch.from_numpy(np.ascontiguousarray(q))
    home = mesh.devices[0]
    return torch.cat([(chunk @ q.to(chunk.device, non_blocking=True))
                      .to(home) for chunk in arena])
