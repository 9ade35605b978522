"""Training over a mesh: the forward of a trainable placement and the
gradient all-reduce across its copies.

The JAX package trains on a mesh with the same ``train_step`` it runs on one
device: GSPMD derives the collectives of the backward from the placed
params. The port writes them out. A training state on a mesh holds a
:func:`~.plan.trainable` placement: every grid position owns fp32 leaves
that require grad. The loss runs the ``forward`` runner
(``sharded_forward.forward_placed``), and autograd gives each position's
leaves the gradient of the part of the loss it computed:

- dp rows: each row's copies see only that row's examples;
- columns of a row: norms, the router and the heads run on the row's first
  column only, so the other columns' copies of them get no gradient, and
  each tp or ep shard gets the gradient of its own block.

:func:`all_reduce_grads` then gives every copy the gradient of the whole
loss. First, a leaf the loss did not reach gets a zero gradient (as optax
gives it one; torch's AdamW would skip it). Then, for each leaf, the
positions that hold the same block (the same index along every axis its
spec splits) form a group: their gradients are summed in grid order on the
group's first device and the sum is written back to every copy. So a leaf
split over tp sums over dp rows only, and a replicated leaf over the whole
grid. One AdamW over every position's leaves then keeps the copies
bit-equal: they start equal and get equal gradients, and AdamW is
elementwise.

On the card each tp column (or, under ep, each dp row) runs ``attend`` on
its heads: kernel K1 forward, n_layers × dp × min(tp, n_heads) launches a
step under dp×tp and n_layers × dp under dp×ep. Its backward is the
dense-recompute VJP of the plain version (``ops/flash_attention.py``).
"""

from __future__ import annotations

import torch

from ..models.encoder import flatten_tree
from .plan import Placement, place_tokens, plan_axes
from .sharded_forward import forward_placed, psum


def forward_mesh(placement: Placement, tokens: torch.Tensor, cfg) -> dict:
    """The outputs of ``encoder.forward`` for ``tokens`` ``[B, L]`` (B a dp
    multiple), computed on the placement's grid and gathered on the mesh's
    first device. Only a ``forward``-runner plan trains."""
    plan = placement.plan
    if plan.runner != "forward":
        raise ValueError(f"plan {plan.family!r} runs the {plan.runner!r} "
                         "runner; training runs the 'forward' runner only")
    shards = place_tokens(tokens, placement.mesh, plan)
    return forward_placed(placement, shards, cfg)


def leaves(placement: Placement) -> list:
    """Every position's leaves, in grid order (the optimizer's list)."""
    return [p for _, _, tree in placement.positions()
            for p in flatten_tree(tree).values()]


def copy_groups(placement: Placement) -> dict:
    """``{path_key: [[(i, j), ...], ...]}``: for each leaf, the groups of
    grid positions that hold the same block of it, in grid order."""
    row_axis, col_axis = plan_axes(placement.plan)
    out = {}
    for key, spec in placement.specs.items():
        groups: dict = {}
        for i, j, _ in placement.positions():
            block = (i if row_axis is not None and row_axis in spec else None,
                     j if col_axis is not None and col_axis in spec else None)
            groups.setdefault(block, []).append((i, j))
        out[key] = list(groups.values())
    return out


def _flats(placement: Placement) -> list:
    return [[flatten_tree(t) for t in row] for row in placement.trees]


def fill_missing_grads(placement: Placement) -> None:
    """A zero gradient for every leaf the loss did not reach."""
    for p in leaves(placement):
        if p.grad is None:
            p.grad = torch.zeros_like(p)


def all_reduce_grads(placement: Placement) -> None:
    """Give every copy of every leaf the sum of its group's gradients
    (:func:`copy_groups`), after :func:`fill_missing_grads`."""
    fill_missing_grads(placement)
    flats = _flats(placement)
    with torch.no_grad():
        for key, groups in copy_groups(placement).items():
            for group in groups:
                if len(group) == 1:
                    continue
                copies = [flats[i][j][key] for i, j in group]
                total = psum([p.grad for p in copies], copies[0].device,
                             f"grad/{key}")
                for p in copies:
                    p.grad.copy_(total, non_blocking=True)


def unequal_copies(placement: Placement, of=lambda p: p) -> list:
    """The leaves whose copies within a group are not bit-equal (of
    ``of(leaf)``: the leaf itself by default, or e.g. its gradient)."""
    flats = _flats(placement)
    bad = []
    for key, groups in copy_groups(placement).items():
        for group in groups:
            first = of(flats[group[0][0]][group[0][1]][key])
            if any(not torch.equal(of(flats[i][j][key]).to(first.device),
                                   first) for i, j in group[1:]):
                bad.append(key)
                break
    return bad
