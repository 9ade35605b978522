"""Training step and loop for the CortexEncoder (multi-head classification).

Counterpart of ``vainplex_openclaw_tpu/models/train.py``:

- the loss is three fp32 cross-entropies (severity, keep, mood) plus
  ``moe_aux_weight · moe_aux``;
- the optimizer is AdamW over every parameter in one group, betas (0.9,
  0.999), eps 1e-8, decay on every leaf, embeddings and norm scales
  included, as ``optax.adamw`` decays them. Torch applies the decay as
  ``p·(1 − lr·wd)`` before the Adam step and optax adds ``wd·p`` to the
  update; the two are the same algebra;
- training keeps fp32 masters: the forward casts each parameter to the
  activation dtype where it is used, and nothing goes through the
  inference cast of ``params_from_numpy(cast=True)``;
- :func:`train_loop` is resumable from ``ckpt_dir``: the batch order is
  keyed by (seed, epoch) and a restored state skips the batches its epoch
  already consumed, so interrupt + resume equals an uninterrupted run bit
  for bit on the CPU;
- a state is checkpointed (:func:`save_state`, :func:`restore_state`)
  under the keys the JAX package gives its ``TrainState`` with an
  ``optax.adamw`` state: ``params/...``, ``opt_state/0/count`` (int32),
  ``opt_state/0/mu/...``, ``opt_state/0/nu/...`` and ``step`` (int32), so
  a training state crosses between the packages in both directions.

On the card, attention runs kernel K1 forward and its dense-recompute
backward (``ops/flash_attention.py``). The port's optimizer lives inside
the state: ``TrainState.opt_state`` is the ``torch.optim.AdamW`` over the
state's parameters, and a step updates both in place.

The same names train on a mesh, as the JAX ``train_step`` does over
GSPMD-placed params: give :func:`init_state` a ``parallel.plan.Placement``
(``place_params`` or ``restore_checkpoint(..., mesh=, plan=)`` of a
``forward``-runner family: ``encoder_validator`` for dp×tp,
``encoder_validator_moe`` for dp×ep) and every position gets fp32 leaves of
its own (``plan.trainable``). A step runs the sharded forward, sums the
gradients across copies (``parallel/sharded_train.py``) and steps one AdamW
over every copy. A checkpoint of such a state holds the gathered tree in
the same keys, and :func:`restore_state` cuts it back onto the positions.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel import sharded_train
from ..parallel.plan import Placement, trainable
from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
from .encoder import EncoderConfig, flatten_tree, forward, unflatten_tree

HEADS = ("severity", "keep", "mood")


class TrainState(NamedTuple):
    """``params`` (fp32 leaf tensors that require grad, or a trainable
    ``Placement`` of them), ``opt_state`` (the AdamW over them) and
    ``step`` (steps taken)."""

    params: "dict | Placement"
    opt_state: torch.optim.Optimizer
    step: int

    def _slot(self, name: str):
        """``fn(p)``: AdamW's ``name`` moment of ``p``, zeros before the
        optimizer's first step (as optax initializes them)."""
        state = self.opt_state.state

        def slot(p: torch.Tensor) -> torch.Tensor:
            s = state.get(p)
            return s[name] if s else torch.zeros_like(p)

        return slot

    def to_tree(self) -> dict:
        """The JAX ``TrainState`` layout: ``params``, ``opt_state[0]`` with
        optax's ``count``, ``mu`` (AdamW's ``exp_avg``) and ``nu``
        (``exp_avg_sq``), and ``step``. A placement's leaves and moments
        are gathered whole onto the CPU."""
        counts = [int(s["step"]) for s in self.opt_state.state.values()
                  if s]
        mu, nu = self._slot("exp_avg"), self._slot("exp_avg_sq")
        if isinstance(self.params, Placement):
            params = self.params.gather()
            mu, nu = (self.params.map(f).gather() for f in (mu, nu))
        else:
            params = self.params
            flat = flatten_tree(params)
            mu, nu = (unflatten_tree({k: f(p) for k, p in flat.items()})
                      for f in (mu, nu))
        return {"params": params,
                "opt_state": [{"count": np.asarray(counts[0] if counts else 0,
                                                   np.int32),
                               "mu": mu, "nu": nu}],
                "step": np.asarray(self.step, np.int32)}

    def load_flat(self, flat: dict) -> "TrainState":
        """This state with its parameters and AdamW moments overwritten in
        place from ``{path_key: leaf}`` in :meth:`to_tree`'s keys (whole
        leaves in this state's dtypes; a placement cuts each by its spec
        for every position), and its step taken from ``flat``."""
        count = int(flat["opt_state/0/count"])
        state = self.opt_state.state
        with torch.no_grad():
            for key, p, local in _slots(self.params):
                p.copy_(local(flat[f"params/{key}"]))
                state.pop(p, None)
                if count:
                    state[p] = {
                        "step": torch.tensor(float(count),
                                             dtype=torch.float32),
                        "exp_avg": local(flat[f"opt_state/0/mu/{key}"]),
                        "exp_avg_sq": local(flat[f"opt_state/0/nu/{key}"])}
        return self._replace(step=int(flat["step"]))


def _slots(params) -> list:
    """``(path_key, leaf, local)`` for every leaf of the state, where
    ``local(whole)`` is a fresh tensor with the part of the whole leaf that
    this leaf holds, on its device."""
    if isinstance(params, Placement):
        return [(key, p, lambda w, key=key, i=i, j=j:
                 params.cut(key, w, i, j).clone())
                for i, j, tree in params.positions()
                for key, p in flatten_tree(tree).items()]
    return [(key, p, lambda w, p=p: w.to(p.device).clone())
            for key, p in flatten_tree(params).items()]


def make_optimizer(lr: float = 3e-4,
                   weight_decay: float = 0.01) -> Callable:
    """``optax.adamw(lr, weight_decay=weight_decay)``'s torch counterpart:
    a factory that builds the AdamW over a list of parameters."""
    return functools.partial(torch.optim.AdamW, lr=lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=weight_decay)


def init_state(params: "dict | Placement", optimizer: Callable) -> TrainState:
    """Step 0: fp32 copies of ``params`` (on their device) as leaves that
    require grad, and a fresh optimizer over them. A placement gets such
    copies at every grid position (``plan.trainable``), and one optimizer
    over all of them."""
    if isinstance(params, Placement):
        placed = trainable(params)
        return TrainState(placed, optimizer(sharded_train.leaves(placed)), 0)
    leaves = {k: v.detach().to(torch.float32).clone().requires_grad_()
              for k, v in flatten_tree(params).items()}
    return TrainState(unflatten_tree(leaves),
                      optimizer(list(leaves.values())), 0)


def save_state(ckpt_dir: str, state: TrainState, keep: int = 3) -> str:
    """Checkpoint ``state`` at its step in the JAX ``TrainState`` keys."""
    return save_checkpoint(ckpt_dir, state.to_tree(), state.step, keep=keep)


def restore_state(ckpt_dir: str, like: TrainState,
                  step: Optional[int] = None) -> TrainState:
    """The checkpointed state at ``step`` (default: the latest) loaded into
    ``like``'s parameters and optimizer in place; a missing or extra leaf
    raises ``KeyError``."""
    tree = restore_checkpoint(ckpt_dir, like=like.to_tree(), step=step)
    return like.load_flat(flatten_tree(tree))


def params_device(params: "dict | Placement") -> torch.device:
    """Where a batch goes and the outputs land: the parameters' device, or
    a placement's first mesh device."""
    if isinstance(params, Placement):
        return params.mesh.devices[0]
    return next(iter(flatten_tree(params).values())).device


def _forward(params: "dict | Placement", tokens: torch.Tensor,
             cfg: EncoderConfig) -> dict:
    if isinstance(params, Placement):
        return sharded_train.forward_mesh(params, tokens, cfg)
    return forward(params, tokens, cfg)


def batch_to(batch: dict, device: torch.device) -> dict:
    """A numpy batch (``tokens`` and the three label arrays) as tensors on
    ``device``."""
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in batch.items()}


def loss_fn(params: dict, batch: dict, cfg: EncoderConfig) -> torch.Tensor:
    """Three fp32 cross-entropies plus ``moe_aux_weight · moe_aux``;
    ``batch`` holds tensors on :func:`params_device`. On a placement the
    forward runs sharded over its grid."""
    out = _forward(params, batch["tokens"], cfg)
    losses = [F.cross_entropy(out[h].float(), batch[h].long())
              for h in HEADS]
    return sum(losses) + cfg.moe_aux_weight * out["moe_aux"]


def train_step(state: TrainState, batch: dict,
               cfg: EncoderConfig) -> tuple:
    """One AdamW step on a numpy ``batch``; updates the state's parameters
    and optimizer in place and returns ``(state with step + 1, loss)``.
    On a placement the copies' gradients are summed before the step. The
    loss stays a device tensor: reading it waits for the device."""
    opt = state.opt_state
    opt.zero_grad(set_to_none=True)
    loss = loss_fn(state.params, batch_to(batch, params_device(state.params)),
                   cfg)
    loss.backward()
    if isinstance(state.params, Placement):
        sharded_train.all_reduce_grads(state.params)
    else:
        # A leaf the loss does not reach (heads/embed_proj) has no grad, and
        # AdamW would skip it; optax gives it a zero grad and still decays it.
        for p in flatten_tree(state.params).values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    opt.step()
    return state._replace(step=state.step + 1), loss.detach()


def _eval_step(params: dict, batch: dict, cfg: EncoderConfig) -> dict:
    """Per example: ``<head>_correct`` (int) and ``<head>_loss`` (fp32)."""
    with torch.no_grad():
        out = _forward(params, batch["tokens"], cfg)
        metrics = {}
        for h in HEADS:
            logits, labels = out[h].float(), batch[h].long()
            metrics[f"{h}_correct"] = (logits.argmax(-1) == labels).int()
            metrics[f"{h}_loss"] = F.cross_entropy(logits, labels,
                                                   reduction="none")
    return metrics


def evaluate(params: dict, data, cfg: EncoderConfig) -> dict:
    """Accuracy and mean loss per head over ``data.eval_batches()``; the
    wrapped duplicates of the last batch are left out through ``n_valid``."""
    device = params_device(params)
    totals: dict = {}
    n_total = 0
    for batch, n_valid in data.eval_batches():
        m = _eval_step(params, batch_to(batch, device), cfg)
        for k, v in m.items():
            totals[k] = totals.get(k, 0.0) + float(v[:n_valid].sum())
        n_total += n_valid
    out = {}
    for h in HEADS:
        out[f"{h}_accuracy"] = totals[f"{h}_correct"] / max(n_total, 1)
        out[f"{h}_loss"] = totals[f"{h}_loss"] / max(n_total, 1)
    out["n_examples"] = n_total
    return out


def train_loop(state: TrainState, data, cfg: EncoderConfig, *,
               total_steps: int, ckpt_dir: Optional[str] = None,
               save_every: int = 100, eval_data=None,
               log=None) -> TrainState:
    """Resumable training: restores the latest checkpoint in ``ckpt_dir``
    (if any) and runs until ``state.step == total_steps``, checkpointing
    every ``save_every`` steps and at the end."""
    if len(data) < data.batch_size:
        # drop-remainder batching would yield no batch at all, and the loop
        # below would never advance
        raise ValueError(
            f"dataset of {len(data)} examples cannot fill one batch of "
            f"{data.batch_size} (drop-remainder); shrink batch_size or add data")
    if ckpt_dir and latest_step(ckpt_dir) is not None:
        state = restore_state(ckpt_dir, state)
    steps_per_epoch = max(len(data) // data.batch_size, 1)
    loss = None
    while state.step < total_steps:
        epoch, offset = divmod(state.step, steps_per_epoch)
        for i, batch in enumerate(data.epoch(epoch)):
            if i < offset:  # resume mid-epoch: skip consumed batches
                continue
            state, loss = train_step(state, batch, cfg)
            if ckpt_dir and state.step % save_every == 0:
                save_state(ckpt_dir, state)
            if state.step >= total_steps:
                break
        if log is not None:
            msg = f"step {state.step}: loss={float(loss):.4f}"
            if eval_data is not None:
                ev = evaluate(state.params, eval_data, cfg)
                msg += (f" | eval sev={ev['severity_accuracy']:.2f}"
                        f" keep={ev['keep_accuracy']:.2f}"
                        f" mood={ev['mood_accuracy']:.2f}")
            log(msg)
    if ckpt_dir:
        save_state(ckpt_dir, state)
    return state
