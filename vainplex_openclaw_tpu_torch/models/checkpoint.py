"""Checkpoint reader and writer for the JAX package's npz + manifest format.

The layout is ``vainplex_openclaw_tpu/models/checkpoint.py``'s: a
checkpoint is ``step-<n>.npz`` (every parameter leaf as a host array, keyed
by its tree path such as ``blocks/0/attn/q``) beside
``step-<n>.manifest.json``, which records each leaf's true dtype. The JAX
writer stores ``ml_dtypes`` leaves (bfloat16) as same-itemsize ``uint``
views, because ``np.savez`` cannot hold them. The port has no ``ml_dtypes``:
a leaf the manifest marks ``bfloat16`` comes back as a CPU
``torch.bfloat16`` tensor with the same bits. Every other leaf comes back as
the numpy array the file holds, cast to its manifest dtype.

:func:`save_checkpoint` writes the same layout as the JAX writer: bf16
leaves as ``uint16`` views with ``bfloat16`` in the manifest, the manifest
renamed into place before the npz (``latest_step`` keys on the npz, so a
visible step always has its dtypes), each through a temporary file, and
steps beyond ``keep`` pruned oldest first.

:func:`restore_checkpoint` refuses a checkpoint whose leaves are not
exactly those of its ``like`` template, as the JAX restore does, and with a
mesh and a plan places the restored tree per the plan's rules. A
training state is a tree like any other here: ``models/train.py`` lays it
out in the JAX package's keys (``TrainState.to_tree``).
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Optional, Union

import numpy as np
import torch

from .encoder import flatten_tree, unflatten_tree

_STEP_RE = re.compile(r"^step-(\d+)\.npz$")

Leaf = Union[np.ndarray, torch.Tensor]


def all_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for f in os.listdir(ckpt_dir)
                  if (m := _STEP_RE.match(f)))


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def _apply_dtype(arr: np.ndarray, name: Optional[str]) -> Leaf:
    if name is None or name == str(arr.dtype):
        return arr
    if name == "bfloat16":
        if arr.dtype.itemsize != 2:
            raise ValueError(f"bfloat16 leaf stored as {arr.dtype}")
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    try:
        want = np.dtype(name)
    except TypeError as exc:
        raise ValueError(f"checkpoint dtype {name!r} is not readable "
                         "without ml_dtypes") from exc
    if want.itemsize != arr.dtype.itemsize:
        raise ValueError(f"leaf stored as {arr.dtype} cannot be viewed "
                         f"as {name}")
    return arr.view(want)


def read_checkpoint(ckpt_dir: str, step: Optional[int] = None) -> dict:
    """``{path_key: leaf}`` for the checkpoint at ``step`` (default: the
    latest) in ``ckpt_dir``, with the manifest's dtypes applied."""
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step-{step}.npz")
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    with open(os.path.join(ckpt_dir, f"step-{step}.manifest.json"),
              encoding="utf-8") as f:
        dtypes = json.load(f).get("dtypes", {})
    return {k: _apply_dtype(a, dtypes.get(k)) for k, a in arrays.items()}


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(array as stored, true dtype name) for one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.uint16).numpy().copy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save_checkpoint(ckpt_dir: str, tree, step: int, keep: int = 3,
                    metadata: Optional[dict] = None) -> str:
    """Write ``tree`` (nested dicts and lists of tensors or arrays) as
    ``step-<step>.npz`` + manifest, atomically; returns the npz path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays: dict = {}
    dtypes: dict = {}
    for key, leaf in flatten_tree(tree).items():
        arrays[key], dtypes[key] = _to_numpy(leaf)
    final = os.path.join(ckpt_dir, f"step-{step}.npz")
    manifest = {"step": step, "n_leaves": len(arrays),
                "leaves": sorted(arrays), "dtypes": dtypes,
                "metadata": metadata or {}}
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".npz.tmp")
    mfd, mtmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".json.tmp")
    try:
        try:
            with os.fdopen(mfd, "w") as f:
                mfd = None  # the file object owns it now
                json.dump(manifest, f)
            with os.fdopen(fd, "wb") as f:
                fd = None
                np.savez(f, **arrays)
        finally:
            for leaked in (fd, mfd):
                if leaked is not None:
                    os.close(leaked)
        os.replace(mtmp, os.path.join(ckpt_dir,
                                      f"step-{step}.manifest.json"))
        os.replace(tmp, final)
    except BaseException:
        for t in (tmp, mtmp):
            if os.path.exists(t):
                os.unlink(t)
        raise
    for old in all_steps(ckpt_dir)[:-keep] if keep else []:
        os.unlink(os.path.join(ckpt_dir, f"step-{old}.npz"))
        mpath = os.path.join(ckpt_dir, f"step-{old}.manifest.json")
        if os.path.exists(mpath):
            os.unlink(mpath)
    return final


def _as_like(leaf, like):
    """A restored leaf in the dtype (and, for a tensor, on the device) of
    its ``like`` leaf."""
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(leaf).to(device=like.device, dtype=like.dtype)
    want = np.asarray(like).dtype
    arr = leaf.float().numpy() if isinstance(leaf, torch.Tensor) else leaf
    return np.asarray(arr).astype(want)


def restore_checkpoint(ckpt_dir: str, like, step: Optional[int] = None,
                       mesh=None, plan=None):
    """The checkpoint at ``step`` (default: the latest) in the structure of
    ``like``, a tree whose tensor leaves say the dtype and device of each
    restored leaf. A leaf missing from the checkpoint, or a leaf ``like``
    does not have, raises ``KeyError``.

    Resharding on load: with ``mesh`` (a ``parallel.mesh.Mesh``) and
    ``plan`` (a ``ShardingPlan`` or a family name) the restored tree is
    placed per the plan's rules and a ``parallel.plan.Placement`` comes
    back (a family name goes through ``serving_plan`` without the mesh, as
    in JAX: an active ``plan_override``, else the hand-written plan); a
    pipeline plan's tree is stacked into stages on the host first
    (``prepare_params``). The rule-table check is armed, and a mesh without
    a plan raises. ``Placement.gather()`` gives back the meshless restore
    (stacked, for a pipeline plan) bit for bit."""
    if mesh is not None and plan is None:
        raise ValueError("restore_checkpoint: mesh given without a plan")
    flat = read_checkpoint(ckpt_dir, step)
    template = flatten_tree(like)
    missing = sorted(set(template) - set(flat))
    extra = sorted(set(flat) - set(template))
    if missing:
        raise KeyError(f"checkpoint in {ckpt_dir} is missing leaves "
                       f"{missing[:5]}")
    if extra:
        raise KeyError(f"checkpoint in {ckpt_dir} has extra leaves "
                       f"{extra[:5]}")
    tree = unflatten_tree({k: _as_like(flat[k], template[k])
                           for k in template})
    if mesh is None:
        return tree
    from ..parallel.plan import place_params, serving_plan

    if isinstance(plan, str):
        # as JAX's restore: resolved without the mesh, so an active
        # plan_override or the hand-written plan places the tree
        plan = serving_plan(plan)
    return place_params(tree, mesh, plan)
