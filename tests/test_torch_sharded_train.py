"""Sharded training in the port against the JAX package's GSPMD train step.

The JAX package trains on a mesh with its one ``train_step`` over
GSPMD-placed params (``__graft_entry__.py`` legs 1, 1b and 3). The port
gives ``train.init_state`` a placement, and every grid position owns fp32
leaves (``plan.trainable``); a step runs the ``forward`` runner and sums the
gradients across copies (``parallel/sharded_train.py``). Both packages get
the mesh shape explicitly (JAX's automatic shape comes from its plan table),
JAX's ``init_params`` weights carried across as numpy arrays and the same
numpy batches:

- dp×tp with the graft's dense config (d_model 128, 8 heads) in fp32 at
  (2, 4) and (4, 2), batch 8, and dp×ep with the graft's MoE widths (4
  experts) at (2, 2) and (1, 2): the loss within 1e-5 of JAX's, every
  gathered gradient within 1e-5 and ``moe_aux`` within 1e-5; the params
  after one step within 1e-5 of JAX's on every element whose JAX gradient
  exceeds 1e-6, and within 1e-6 of ``optax.adamw`` fed the port's gathered
  gradients on every element. (Adam's first step moves a parameter by
  lr·g/(|g| + 1e-8): at |g| ~ 1e-8 a gradient difference of 1e-9, below
  fp32 noise, moves it by ~3e-5, so a bound on every element against a
  step of other arithmetic would test the noise, not the step.)
- copies stay bit-equal after 3 steps; without the cross-copy sum the
  gradients miss JAX's by more than 1e-3 (the control);
- checkpoints cross both ways: a JAX save of a sharded state restores onto
  the port's placement leaf for leaf, a port save restores onto JAX's
  sharded template with the template's sharding, and the port's restore
  then step is bit-exact; ``train_loop`` on a mesh resumes bit-exact;
- K1's call count per step is n_layers × dp × min(tp, n_heads) (dp×tp)
  and n_layers × dp (dp×ep);
- GPipe: autograd through ``pipeline_apply`` (2·S blocks of tanh(h @ w),
  x of [8, 32], 4 microbatches) equals the sequential gradient and JAX's
  within 1e-5.
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from vainplex_openclaw_tpu.models import EncoderConfig as JaxConfig
from vainplex_openclaw_tpu.models import checkpoint as jax_ckpt
from vainplex_openclaw_tpu.models import forward as jax_forward
from vainplex_openclaw_tpu.models import init_params as jax_init_params
from vainplex_openclaw_tpu.models import train as jax_train
from vainplex_openclaw_tpu.models.moe import moe_sharding_rules
from vainplex_openclaw_tpu.parallel.mesh import make_mesh as jax_make_mesh
from vainplex_openclaw_tpu.parallel.mesh import shard_params
from vainplex_openclaw_tpu.parallel.pipeline import (
    pipeline_apply as jax_pipeline_apply)
from vainplex_openclaw_tpu.parallel.pipeline import (
    stack_stage_params as jax_stack_stage_params)
from vainplex_openclaw_tpu_torch.models import encoder as port_encoder
from vainplex_openclaw_tpu_torch.models import train
from vainplex_openclaw_tpu_torch.models.data import (
    TextClassificationData, synthetic_examples)
from vainplex_openclaw_tpu_torch.models.encoder import (
    EncoderConfig, flatten_tree, params_from_numpy)
from vainplex_openclaw_tpu_torch.parallel import plan, sharded_train
from vainplex_openclaw_tpu_torch.parallel.mesh import make_mesh
from vainplex_openclaw_tpu_torch.parallel.pipeline import (
    pipeline_apply, stack_stage_params)

# __graft_entry__.py:106-108 (dp×tp) and :233-234 (dp×ep, 4 experts)
DENSE = JaxConfig(d_model=128, n_heads=8, n_layers=2, d_ff=256, seq_len=64,
                  vocab_size=1024, dtype=jnp.float32)
MOE = JaxConfig(d_model=64, n_heads=4, n_layers=2, d_ff=128, seq_len=32,
                vocab_size=512, n_experts=4, dtype=jnp.float32)
# the graft's Megatron rules (:113-117), over JAX key strings
TP_RULES = [("'q'", P(None, "tp")), ("'k'", P(None, "tp")),
            ("'v'", P(None, "tp")), ("'o'", P("tp", None)),
            ("w1", P(None, "tp")), ("w2", P("tp", None)),
            ("tok", P(None, "tp")), ("pos", P(None, "tp"))]
CASES = {  # id: (jax cfg, port family, axes, shape, jax rules)
    "tp_2x4": (DENSE, "encoder_validator", ("dp", "tp"), (2, 4), TP_RULES),
    "tp_4x2": (DENSE, "encoder_validator", ("dp", "tp"), (4, 2), TP_RULES),
    "ep_2x2": (MOE, "encoder_validator_moe", ("dp", "ep"), (2, 2),
               moe_sharding_rules("ep")),
    "ep_1x2": (MOE, "encoder_validator_moe", ("dp", "ep"), (1, 2),
               moe_sharding_rules("ep")),
}
BATCH = 8
TOL = 1e-5


def port_cfg(jcfg: JaxConfig) -> EncoderConfig:
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(EncoderConfig)}
    fields["dtype"] = jnp.dtype(jcfg.dtype).name
    return EncoderConfig(**fields)


def batches(jcfg: JaxConfig, n: int = 3) -> list:
    data = TextClassificationData(synthetic_examples(64, seed=5), BATCH,
                                  seq_len=jcfg.seq_len,
                                  vocab_size=jcfg.vocab_size, seed=5)
    return list(data.epoch(0))[:n]


def jax_flat(tree) -> dict:
    return {jax_ckpt._path_key(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def port_flat(tree) -> dict:
    """Copies of the leaves (a gathered replicated leaf is the live
    tensor of the first position)."""
    return {k: np.array(v.detach().cpu().numpy() if isinstance(
        v, torch.Tensor) else v) for k, v in flatten_tree(tree).items()}


class Case:
    """One mesh case in both packages, from the same JAX weights."""

    def __init__(self, case_id: str, seed: int = 0):
        jcfg, family, axes, shape, rules = CASES[case_id]
        self.jcfg, self.cfg, self.family = jcfg, port_cfg(jcfg), family
        self.jmesh = jax_make_mesh(math.prod(shape), axes=axes, shape=shape)
        self.mesh = make_mesh(axes=axes, shape=shape, device="cpu")
        self.rules = rules
        jp = jax_init_params(jax.random.PRNGKey(seed), jcfg)
        self.host = jax.tree_util.tree_map(np.asarray, jp)
        self.batches = batches(jcfg)

    def jax_params(self):
        jp = jax.tree_util.tree_map(jnp.asarray, self.host)
        return jax.device_put(jp, shard_params(jp, self.jmesh, self.rules))

    def jax_batch(self, batch: dict) -> dict:
        sharding = NamedSharding(self.jmesh, P("dp"))
        return {k: jax.device_put(jnp.asarray(v), sharding)
                for k, v in batch.items()}

    def jax_state(self):
        opt = jax_train.make_optimizer()
        return jax_train.init_state(self.jax_params(), opt), opt

    def host_tree(self, seed=None) -> dict:
        host = self.host if seed is None else jax.tree_util.tree_map(
            np.asarray, jax_init_params(jax.random.PRNGKey(seed), self.jcfg))
        return params_from_numpy(host, self.cfg, "cpu", cast=False)

    def port_state(self, seed=None) -> train.TrainState:
        placed = plan.place_params(self.host_tree(seed), self.mesh,
                                   self.family)
        return train.init_state(placed, train.make_optimizer())


_jax_grads_cache: dict = {}


def jax_loss_and_grads(case_id: str):
    """JAX's GSPMD loss, gradients and ``moe_aux`` for the case's first
    batch (memoized: JAX compiles once per case)."""
    if case_id not in _jax_grads_cache:
        c = Case(case_id)
        params, batch = c.jax_params(), c.jax_batch(c.batches[0])
        loss, grads = jax.jit(jax.value_and_grad(jax_train.loss_fn),
                              static_argnums=2)(params, batch, c.jcfg)
        aux = jax.jit(lambda p, t: jax_forward(p, t, c.jcfg)["moe_aux"])(
            params, batch["tokens"])
        _jax_grads_cache[case_id] = (float(loss), jax_flat(grads), float(aux))
    return _jax_grads_cache[case_id]


def port_loss_and_grads(c: Case, reduce: bool = True):
    state = c.port_state()
    batch = train.batch_to(c.batches[0], torch.device("cpu"))
    out = train._forward(state.params, batch["tokens"], c.cfg)
    loss = train.loss_fn(state.params, batch, c.cfg)
    loss.backward()
    if reduce:
        sharded_train.all_reduce_grads(state.params)
    else:  # the control: each copy keeps its own part of the gradient
        sharded_train.fill_missing_grads(state.params)
    grads = port_flat(state.params.map(lambda p: p.grad).gather())
    return float(loss.detach()), grads, float(out["moe_aux"].detach()), state


# ── one step against JAX's GSPMD step ───────────────────────────────


@pytest.mark.parametrize("case_id", list(CASES))
def test_loss_and_grads_match_jax_gspmd(case_id):
    c = Case(case_id)
    jloss, jgrads, jaux = jax_loss_and_grads(case_id)
    loss, grads, aux, _ = port_loss_and_grads(c)
    assert abs(loss - jloss) <= TOL
    assert abs(aux - jaux) <= TOL
    if c.cfg.n_experts:
        assert aux > 0
    assert grads.keys() == jgrads.keys()
    for k, g in grads.items():
        assert np.abs(g - jgrads[k]).max() <= TOL, k


@pytest.mark.parametrize("case_id", ["tp_2x4", "ep_2x2"])
def test_params_after_one_step_match_jax_and_optax(case_id):
    c = Case(case_id)
    jstate, opt = c.jax_state()
    jgrads = jax_loss_and_grads(case_id)[1]
    jstate, jloss = jax_train.train_step(jstate, c.jax_batch(c.batches[0]),
                                         c.jcfg, opt)
    state = c.port_state()
    before = port_flat(state.params.gather())
    state, loss = train.train_step(state, c.batches[0], c.cfg)
    grads = port_flat(state.params.map(lambda p: p.grad).gather())
    after = port_flat(state.params.gather())
    assert state.step == int(jstate.step) == 1
    assert abs(float(loss) - float(jloss)) <= TOL
    want = jax_flat(jstate.params)
    for k, v in after.items():
        conditioned = np.abs(jgrads[k]) > 1e-6
        assert np.abs(v - want[k])[conditioned].max(initial=0.0) <= TOL, k
    # AdamW per copy is optax's AdamW on the gathered gradient
    adamw = optax.adamw(3e-4, weight_decay=0.01)
    p0 = {k: jnp.asarray(v) for k, v in before.items()}
    updates, _ = adamw.update({k: jnp.asarray(v) for k, v in grads.items()},
                              adamw.init(p0), p0)
    ref = optax.apply_updates(p0, updates)
    for k, v in after.items():
        assert np.abs(v - np.asarray(ref[k])).max() <= 1e-6, k


def test_skipping_the_cross_copy_sum_misses_jax():
    """The control: each copy's own part of the gradient, gathered without
    the sum, misses JAX's by far more than the bound."""
    c = Case("tp_2x4")
    jgrads = jax_loss_and_grads("tp_2x4")[1]
    _, grads, _, _ = port_loss_and_grads(c, reduce=False)
    worst = max(float(np.abs(g - jgrads[k]).max()) for k, g in grads.items())
    assert worst > 1e-3


@pytest.mark.parametrize("case_id", ["tp_2x4", "ep_2x2"])
def test_copies_stay_bit_equal_after_three_steps(case_id):
    c = Case(case_id)
    state = c.port_state()
    groups = sharded_train.copy_groups(state.params)
    assert any(len(g) > 1 for gs in groups.values() for g in gs)
    for batch in c.batches:
        state, _ = train.train_step(state, batch, c.cfg)
    assert state.step == 3
    assert sharded_train.unequal_copies(state.params) == []
    assert sharded_train.unequal_copies(state.params,
                                        lambda p: p.grad) == []
    moments = state.opt_state.state
    assert sharded_train.unequal_copies(
        state.params, lambda p: moments[p]["exp_avg_sq"]) == []


def test_trainable_placement_owns_every_copy():
    c = Case("tp_2x4")
    placed = plan.place_params(c.host_tree(), c.mesh, c.family)
    scale = [t["final_norm"]["scale"] for _, _, t in placed.positions()]
    assert len({s.data_ptr() for s in scale}) == 1  # served: one shared leaf
    owned = plan.trainable(placed)
    leaves = sharded_train.leaves(owned)
    assert len(leaves) == 8 * len(placed.specs)
    assert len({p.data_ptr() for p in leaves}) == len(leaves)
    assert all(p.is_leaf and p.requires_grad and p.dtype == torch.float32
               for p in leaves)
    assert all(np.array_equal(a, b) for a, b in zip(
        port_flat(owned.gather()).values(),
        port_flat(placed.gather()).values()))


@pytest.mark.parametrize("family,axes", [
    ("encoder_validator_pp", ("pp",)),
    ("encoder_validator_long", ("dp", "sp"))])
def test_training_runs_the_forward_runner_only(family, axes):
    c = Case("tp_2x4")
    mesh = make_mesh(axes=axes, shape=(2,) if len(axes) == 1 else (2, 2),
                     device="cpu")
    state = train.init_state(plan.place_params(c.host_tree(), mesh, family),
                             train.make_optimizer())
    with pytest.raises(ValueError, match="'forward' runner"):
        train.train_step(state, c.batches[0], c.cfg)


# ── K1 per step ─────────────────────────────────────────────────────


@pytest.mark.parametrize("case_id,shape,want", [
    ("tp_2x4", (2, 4), lambda cfg, dp, tp: cfg.n_layers * dp * min(
        tp, cfg.n_heads)),
    ("tp_4x2", (4, 2), lambda cfg, dp, tp: cfg.n_layers * dp * min(
        tp, cfg.n_heads)),
    ("ep_2x2", (2, 2), lambda cfg, dp, ep: cfg.n_layers * dp)])
def test_attention_calls_per_step_follow_the_formula(case_id, shape, want,
                                                     monkeypatch):
    """Each tp column (each dp row under ep) runs ``attend`` on its heads:
    on the card one K1 launch each, and none in the backward."""
    c = Case(case_id)
    calls = []
    real = port_encoder.flash_attention

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(port_encoder, "flash_attention", spy)
    state = c.port_state()
    train.train_step(state, c.batches[0], c.cfg)
    assert len(calls) == want(c.cfg, *shape)


# ── checkpoints of a sharded state ──────────────────────────────────


def test_jax_sharded_save_restores_onto_the_port_placement(tmp_path):
    c = Case("tp_2x4")
    jstate, opt = c.jax_state()
    jstate, _ = jax_train.train_step(jstate, c.jax_batch(c.batches[0]),
                                     c.jcfg, opt)
    jax_ckpt.save_checkpoint(str(tmp_path), jstate)
    restored = train.restore_state(str(tmp_path), c.port_state(seed=9))
    assert restored.step == 1
    got, want = port_flat(restored.to_tree()), jax_flat(jstate)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert np.array_equal(got[k], v), k
    # every position holds its own cut of the whole leaf
    q = want["params/blocks/0/attn/q"]
    for i, j, tree in restored.params.positions():
        np.testing.assert_array_equal(
            tree["blocks"][0]["attn"]["q"].detach().numpy(),
            q[:, j * 32:(j + 1) * 32])
    assert sharded_train.unequal_copies(restored.params) == []


def test_port_sharded_save_restores_onto_jax_sharded_template(tmp_path):
    c = Case("tp_2x4")
    state = c.port_state()
    for batch in c.batches[:2]:
        state, _ = train.train_step(state, batch, c.cfg)
    train.save_state(str(tmp_path), state)
    opt = jax_train.make_optimizer()
    like = jax_train.init_state(jax.device_put(
        jax_init_params(jax.random.PRNGKey(42), c.jcfg),
        shard_params(c.jax_params(), c.jmesh, c.rules)), opt)
    back = jax_ckpt.restore_checkpoint(str(tmp_path), like=like)
    assert int(back.step) == 2
    got, want = jax_flat(back), port_flat(state.to_tree())
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert np.array_equal(got[k], v), k
    assert back.params["blocks"][0]["attn"]["q"].sharding.spec == \
        P(None, "tp")


@pytest.mark.parametrize("case_id", ["tp_2x4", "ep_2x2"])
def test_restore_then_step_is_bit_exact(tmp_path, case_id):
    c = Case(case_id)
    state = c.port_state()
    state, _ = train.train_step(state, c.batches[0], c.cfg)
    train.save_state(str(tmp_path), state)
    restored = train.restore_state(str(tmp_path), c.port_state(seed=9))
    a, loss_a = train.train_step(state, c.batches[1], c.cfg)
    b, loss_b = train.train_step(restored, c.batches[1], c.cfg)
    assert float(loss_a) == float(loss_b)
    got, want = port_flat(b.to_tree()), port_flat(a.to_tree())
    assert all(np.array_equal(got[k], want[k]) for k in want)


def test_train_loop_on_a_mesh_resumes_bit_exact(tmp_path):
    """``train_loop`` and ``evaluate`` take a placed state: interrupt at 2
    and resume to 3 equals one run to 3, and the mesh's evaluation equals
    the single-device one."""
    c = Case("ep_1x2")
    data = TextClassificationData(synthetic_examples(32, seed=5), BATCH,
                                  seq_len=c.cfg.seq_len,
                                  vocab_size=c.cfg.vocab_size, seed=5)
    whole = train.train_loop(c.port_state(), data, c.cfg, total_steps=3)
    ckpt = str(tmp_path / "ck")
    train.train_loop(c.port_state(), data, c.cfg, total_steps=2,
                     ckpt_dir=ckpt)
    resumed = train.train_loop(c.port_state(), data, c.cfg, total_steps=3,
                               ckpt_dir=ckpt)
    got, want = port_flat(resumed.to_tree()), port_flat(whole.to_tree())
    assert resumed.step == 3 and all(np.array_equal(got[k], want[k])
                                     for k in want)
    single = train.init_state(resumed.params.gather(),
                              train.make_optimizer())
    on_mesh = train.evaluate(resumed.params, data, c.cfg)
    alone = train.evaluate(single.params, data, c.cfg)
    for h in ("severity", "keep", "mood"):
        assert on_mesh[f"{h}_accuracy"] == alone[f"{h}_accuracy"]
        assert abs(on_mesh[f"{h}_loss"] - alone[f"{h}_loss"]) <= TOL


# ── pipeline gradients ──────────────────────────────────────────────


@pytest.mark.parametrize("n_stages", [2, 4])
def test_pipeline_grads_match_sequential_and_jax(n_stages):
    """``__graft_entry__.py:250-271``: D=32, 2·S blocks of tanh(h @ w), x
    of [8, 32], 4 microbatches; the loss is mean(out²)."""
    D, M = 32, 4
    rng = np.random.default_rng(3)
    ws = [(rng.standard_normal((D, D)) / np.sqrt(D)).astype(np.float32)
          for _ in range(2 * n_stages)]
    x_np = rng.standard_normal((8, D)).astype(np.float32)

    def stage_fn(local, h):
        for i in range(local["w"].shape[0]):
            h = torch.tanh(h @ local["w"][i])
        return h

    w = torch.tensor(np.stack(ws), requires_grad=True)
    stacked = stack_stage_params([{"w": w[i]} for i in range(len(ws))],
                                 n_stages)
    out = pipeline_apply([{"w": stacked["w"][s]} for s in range(n_stages)],
                         torch.from_numpy(x_np), stage_fn,
                         [torch.device("cpu")] * n_stages, n_microbatches=M)
    (out ** 2).mean().backward()
    got = w.grad.numpy()

    w_seq = torch.tensor(np.stack(ws), requires_grad=True)
    h = torch.from_numpy(x_np)
    for i in range(len(ws)):
        h = torch.tanh(h @ w_seq[i])
    (h ** 2).mean().backward()
    np.testing.assert_allclose(got, w_seq.grad.numpy(), atol=TOL, rtol=0)

    jmesh = jax_make_mesh(n_stages, axes=("pp",), shape=(n_stages,))
    jstacked = jax_stack_stage_params([{"w": jnp.asarray(a)} for a in ws],
                                      n_stages)

    def jax_stage(local, h):
        for i in range(local["w"].shape[0]):
            h = jnp.tanh(h @ local["w"][i])
        return h

    jgrad = jax.grad(lambda s: (jax_pipeline_apply(
        s, jnp.asarray(x_np), jax_stage, jmesh, n_microbatches=M) ** 2
    ).mean())(jstacked)["w"]
    np.testing.assert_allclose(got, np.asarray(jgrad).reshape(got.shape),
                               atol=TOL, rtol=0)
