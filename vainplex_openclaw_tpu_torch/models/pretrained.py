"""The shipped tiny triage checkpoint, loaded for inference in PyTorch.

Counterpart of ``vainplex_openclaw_tpu/models/pretrained.py``'s loader
half. The weights are the JAX package's own file,
``vainplex_openclaw_tpu/models/pretrained/triage-tiny``, found by path from
this file: reading a data file is not an import. The restore order is the
JAX one: float16 on disk → float32 (what ``restore_checkpoint`` does
through its fp32 template) → the ``cast_params`` rule, so the big matrices
are bf16 and ``norm1``, ``norm2``, ``final_norm`` and ``heads`` stay fp32.
:func:`write_pretrained` writes a checkpoint in the same layout
(``config.json`` + step npz), which both packages load. Training and
shipping stay in the JAX package for now.
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import asdict
from typing import Optional

import torch

from ..device import DeviceLike, resolve_device
from .checkpoint import latest_step, read_checkpoint, save_checkpoint
from .encoder import DTYPES, EncoderConfig, params_from_numpy, unflatten_tree

TINY_CONFIG = EncoderConfig(vocab_size=2048, seq_len=64, d_model=64,
                            n_heads=4, n_layers=2, d_ff=256)

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(_REPO_ROOT, "vainplex_openclaw_tpu", "models",
                           "pretrained", "triage-tiny")

_cache: dict = {}
_cache_lock = threading.Lock()


def config_to_manifest(cfg: EncoderConfig) -> dict:
    """The ``config`` object of ``config.json``: every field, the dtype by
    name."""
    return asdict(cfg)


def write_pretrained(ckpt_dir: str, cfg: EncoderConfig, params: dict,
                     step: int = 1) -> None:
    """Write ``params`` as step ``step`` and ``config.json``
    (``{"config": ..., "eval": {}}``) into ``ckpt_dir``: the layout
    :func:`load_pretrained` and the JAX ``load_pretrained`` read."""
    save_checkpoint(ckpt_dir, params, step=step)
    tmp = os.path.join(ckpt_dir, "config.json.tmp")
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump({"config": config_to_manifest(cfg), "eval": {}}, f)
    os.replace(tmp, os.path.join(ckpt_dir, "config.json"))


def config_from_manifest(d: dict) -> EncoderConfig:
    d = dict(d)
    if d.get("dtype") not in DTYPES:
        raise ValueError(f"unsupported checkpoint dtype {d.get('dtype')!r}")
    return EncoderConfig(**d)


def available(ckpt_dir: Optional[str] = None) -> bool:
    """True when a shipped checkpoint exists (without paying a model load)."""
    d = ckpt_dir or DEFAULT_DIR
    return os.path.isfile(os.path.join(d, "config.json")) and \
        latest_step(d) is not None


def load_pretrained(ckpt_dir: Optional[str] = None,
                    device: DeviceLike = None):
    """``(cfg, params)`` from the checkpoint on ``device`` (default: the
    card, raising when there is none), or None when no checkpoint is
    there. Cached per (directory, device)."""
    dev = resolve_device(device)
    d = os.path.abspath(ckpt_dir or DEFAULT_DIR)
    key = (d, str(dev))
    with _cache_lock:
        if key in _cache:
            return _cache[key]
        if not available(d):
            _cache[key] = None
            return None
        with open(os.path.join(d, "config.json"), encoding="utf-8") as f:
            cfg = config_from_manifest(json.load(f)["config"])
        flat = {k: torch.as_tensor(v).to(torch.float32)
                for k, v in read_checkpoint(d).items()}
        params = params_from_numpy(unflatten_tree(flat), cfg, dev, cast=True)
        _cache[key] = (cfg, params)
        return _cache[key]


def clear_cache() -> None:
    with _cache_lock:
        _cache.clear()
