"""A single-controller device grid with named axes.

Counterpart of ``vainplex_openclaw_tpu/parallel/mesh.py``. The JAX mesh is
driven by one process through ``shard_map``; the port keeps that shape. A
:class:`Mesh` is a grid of ``torch.device`` entries with axis names: one
Python process places each shard on its grid entry and launches the work
there, and data moves between entries with ``.to(device)``. No
``torch.distributed`` process group is involved.

On the CPU the grid repeats ``cpu`` (the counterpart of the JAX test
suite's virtual CPU devices). On CUDA, :func:`make_mesh` takes distinct
visible cards and raises when the shape asks for more; an explicit
``devices=[...]`` may repeat a card, so the ring's rotate-and-merge can run
on one card.

Axis convention: ``dp`` (batch), ``tp`` (model), ``sp`` (sequence).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional, Sequence

import torch

from ..device import DeviceLike, resolve_device

# Grid entries a CPU mesh offers when asked for "all devices": the JAX
# suite's XLA_FLAGS=--xla_force_host_platform_device_count=8.
CPU_MESH_DEVICES = 8


@dataclass(frozen=True)
class Mesh:
    """``devices``: the grid flattened row-major over ``axis_names``, whose
    sizes are ``dims``. Frozen and hashable, so caches can key on it;
    two meshes over the same grid compare equal."""

    devices: tuple
    dims: tuple
    axis_names: tuple

    def __post_init__(self):
        if len(self.dims) != len(self.axis_names):
            raise ValueError(f"dims {self.dims} and axes {self.axis_names} "
                             "differ in length")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis name in {self.axis_names}")
        if math.prod(self.dims) != len(self.devices):
            raise ValueError(f"{len(self.devices)} devices do not fill a "
                             f"{self.dims} grid")

    @property
    def shape(self) -> dict:
        """``{axis: size}`` in axis order, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return len(self.devices)

    def device(self, **index: int) -> torch.device:
        """The grid entry at ``axis=i`` for every axis (missing axes: 0)."""
        flat = 0
        for axis, dim in zip(self.axis_names, self.dims):
            i = index.get(axis, 0)
            if not 0 <= i < dim:
                raise IndexError(f"{axis}={i} outside size {dim}")
            flat = flat * dim + i
        return self.devices[flat]

    def distinct_devices(self) -> tuple:
        """Every device of the grid once, in grid order."""
        return tuple(dict.fromkeys(self.devices))

    def grid(self, row_axis: Optional[str], col_axis: Optional[str]) -> list:
        """``[[device]]`` indexed ``[row][col]`` over two axes, either of
        which may be None (one row, or one column); every other axis must
        have size 1."""
        shape = self.shape
        for axis in (row_axis, col_axis):
            if axis is not None and axis not in shape:
                raise ValueError(f"mesh axes {self.axis_names} lack {axis!r}")
        extra = {a: s for a, s in shape.items()
                 if a not in (row_axis, col_axis) and s != 1}
        if extra:
            raise ValueError(f"axes {sorted(extra)} of size > 1 are not "
                             f"spanned by ({row_axis}, {col_axis})")

        def at(i: int, j: int) -> torch.device:
            index = {}
            if row_axis is not None:
                index[row_axis] = i
            if col_axis is not None:
                index[col_axis] = j
            return self.device(**index)

        return [[at(i, j) for j in range(shape.get(col_axis, 1))]
                for i in range(shape.get(row_axis, 1))]


def _factor(n: int) -> tuple[int, int]:
    """Split n into (dp, tp) with tp the largest power-of-two divisor ≤ sqrt(n)."""
    tp = 1
    for cand in (2, 4, 8, 16):
        if n % cand == 0 and cand * cand <= n * 2:
            tp = cand
    return n // tp, tp


def available_devices(device: DeviceLike = None) -> list:
    """The grid entries a mesh on ``device``'s type may use: every visible
    card for CUDA (``None`` means CUDA and raises without a card), or
    :data:`CPU_MESH_DEVICES` repeats of ``cpu``."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [torch.device("cpu")] * CPU_MESH_DEVICES
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` → ``cuda:<current>``, so grid entries equal the devices
    that tensors placed on them report."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_devices: Optional[int] = None,
              axes: Sequence[str] = ("dp", "tp"),
              shape: Optional[Sequence[int]] = None, *,
              device: DeviceLike = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over the first ``n_devices`` of :func:`available_devices`
    (default: all of them), or over ``devices`` as given (entries may
    repeat). ``shape`` defaults as in the JAX package: one axis takes every
    device, two axes split them by :func:`_factor`, more axes pad with 1."""
    if devices is not None:
        pool = [_indexed(resolve_device(d)) for d in devices]
    else:
        pool = available_devices(device)
    if n_devices is None:
        n = math.prod(shape) if shape is not None else len(pool)
    else:
        n = int(n_devices)
    if n > len(pool):
        raise ValueError(f"requested {n} devices, have {len(pool)}")
    if shape is None:
        if len(axes) == 1:
            shape = (n,)
        elif len(axes) == 2:
            shape = _factor(n)
        else:
            shape = _factor(n) + (1,) * (len(axes) - 2)
    return Mesh(tuple(pool[:n]), tuple(int(s) for s in shape), tuple(axes))


@lru_cache(maxsize=8)
def cached_mesh(shape: tuple, axes: tuple = ("dp", "tp"),
                device: str = "cuda") -> Mesh:
    """Memoized mesh for serving: every caller asking for the same
    (shape, axes, device type) shares one Mesh object."""
    return make_mesh(n_devices=math.prod(shape), axes=tuple(axes),
                     shape=tuple(shape), device=device)
