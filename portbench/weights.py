"""The weights a cell serves, loaded by the benchmark and handed to both
the program (as a checkpoint directory) and the reference (as a flat
``{path: float32 array}`` dict).

A configuration's ``weights`` key names a shipped checkpoint,
``{"checkpoint": "<dir>"}``, read by path from the checkout: its newest
``step-<n>.npz``. The benchmark serves no weights it draws itself: a
configuration comes with a checkpoint of its published size.
"""

from __future__ import annotations

import glob
import os
import re

from .reference.encoder import load_npz


def newest_npz(ckpt_dir: str) -> str:
    steps = [(int(m.group(1)), p) for p in glob.glob(
        os.path.join(ckpt_dir, "step-*.npz"))
        if (m := re.search(r"step-(\d+)\.npz$", p))]
    if not steps:
        raise FileNotFoundError(f"no step-<n>.npz in {ckpt_dir}")
    return max(steps)[1]


class Weights:
    """``.dir`` for the program, ``.arrays`` for the reference."""

    def __init__(self, root: str, config: dict):
        src = config["weights"]
        if "checkpoint" not in src:
            raise ValueError(f"unknown weights source {sorted(src)}")
        self.dir = os.path.join(root, src["checkpoint"])
        self.arrays = load_npz(newest_npz(self.dir))
