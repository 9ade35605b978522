"""The shipped tiny triage checkpoint, loaded for inference in PyTorch.

Counterpart of ``vainplex_openclaw_tpu/models/pretrained.py``'s loader
half. The weights are the JAX package's own file,
``vainplex_openclaw_tpu/models/pretrained/triage-tiny``, found by path from
this file: reading a data file is not an import. The restore order is the
JAX one: float16 on disk → float32 (what ``restore_checkpoint`` does
through its fp32 template) → the ``cast_params`` rule, so the big matrices
are bf16 and ``norm1``, ``norm2``, ``final_norm`` and ``heads`` stay fp32.
:func:`write_pretrained` writes a checkpoint in the same layout
(``config.json`` + step npz), which both packages load.

:func:`train_and_ship` is the JAX recipe (``train_and_ship`` in the JAX
module) run by the port: ``TINY_CONFIG`` trained from a seeded init on the
noun-disjoint synthetic split, shipped as float16 params only, and
evaluated on the held-out split after the float16 round trip. Its
``out_dir`` has no default: the port never writes into the JAX package's
shipped directory.
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import asdict
from typing import Optional

import torch

from ..device import DeviceLike, resolve_device
from .checkpoint import (latest_step, read_checkpoint, restore_checkpoint,
                         save_checkpoint)
from .encoder import (DTYPES, EncoderConfig, flatten_tree, init_params,
                      params_from_numpy, unflatten_tree)

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


def train_and_ship(out_dir: str, total_steps: int = 600,
                   n_examples: int = 4608, batch_size: int = 64,
                   seed: int = 0, log=None, device: DeviceLike = None) -> dict:
    """Train ``TINY_CONFIG`` on ``device`` (default: the card) with the JAX
    recipe, write its float16 params as ``step-<total_steps>.npz`` and
    ``config.json`` (with ``eval`` and ``provenance``) into ``out_dir``, and
    return the held-out metrics, measured after the float16 round trip:
    what a user loads is what was measured."""
    from .data import TextClassificationData, synthetic_split
    from .train import evaluate, init_state, make_optimizer, train_loop

    dev = resolve_device(device)
    if os.path.abspath(out_dir) == os.path.abspath(DEFAULT_DIR):
        raise ValueError("train_and_ship never writes over the shipped "
                         "checkpoint; pick another out_dir")
    cfg = TINY_CONFIG
    n_eval = max(batch_size, n_examples // 9)
    # noun-disjoint: no eval text can repeat a training text
    train_examples, eval_examples = synthetic_split(n_examples - n_eval,
                                                    n_eval, seed=seed)
    train_data = TextClassificationData(train_examples, batch_size,
                                        seq_len=cfg.seq_len,
                                        vocab_size=cfg.vocab_size, seed=seed)
    heldout = TextClassificationData(eval_examples, batch_size,
                                     seq_len=cfg.seq_len,
                                     vocab_size=cfg.vocab_size, seed=seed)
    init = params_from_numpy(
        init_params(cfg, torch.Generator().manual_seed(seed)), cfg, dev,
        cast=False)
    state = train_loop(init_state(init, make_optimizer()), train_data, cfg,
                       total_steps=total_steps, log=log)

    shipped = {k: v.detach().to(torch.float16).cpu()
               for k, v in flatten_tree(state.params).items()}
    os.makedirs(out_dir, exist_ok=True)
    save_checkpoint(out_dir, unflatten_tree(shipped), step=state.step,
                    keep=1)
    restored = restore_checkpoint(out_dir, like=state.params)
    metrics = evaluate(restored, heldout, cfg)
    meta = {
        "config": config_to_manifest(cfg),
        "eval": {k: float(v) for k, v in metrics.items()},
        "provenance": {
            "corpus": f"synthetic_split(n_train={n_examples - n_eval}, "
                      f"n_eval={n_eval}, seed={seed})",
            "heldout": n_eval,
            "heldout_protocol": "noun-disjoint: eval nouns never appear in "
                                "any training text (same 16 templates)",
            "total_steps": total_steps,
            "batch_size": batch_size,
            "trained_by": "vainplex_openclaw_tpu_torch/models/pretrained.py"
                          ":train_and_ship",
            "device": str(dev),
        },
    }
    tmp = os.path.join(out_dir, "config.json.tmp")
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(meta, f, indent=1)
    os.replace(tmp, os.path.join(out_dir, "config.json"))
    clear_cache()
    return metrics
