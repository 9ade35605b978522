"""Checkpoint reader for the JAX package's npz + manifest format.

The layout is ``vainplex_openclaw_tpu/models/checkpoint.py``'s: a
checkpoint is ``step-<n>.npz`` (every parameter leaf as a host array, keyed
by its tree path such as ``blocks/0/attn/q``) beside
``step-<n>.manifest.json``, which records each leaf's true dtype. The JAX
writer stores ``ml_dtypes`` leaves (bfloat16) as same-itemsize ``uint``
views, because ``np.savez`` cannot hold them. The port has no ``ml_dtypes``:
a leaf the manifest marks ``bfloat16`` comes back as a CPU
``torch.bfloat16`` tensor with the same bits. Every other leaf comes back as
the numpy array the file holds, cast to its manifest dtype.

Only the read half is ported here; writing comes with the training slice.
"""

from __future__ import annotations

import json
import os
import re
from typing import Optional, Union

import numpy as np
import torch

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


def read_checkpoint(ckpt_dir: str) -> dict:
    """``{path_key: leaf}`` for the latest checkpoint in ``ckpt_dir``, with
    the manifest's dtypes applied."""
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
