"""The port's graft entry points against ``__graft_entry__.py``.

``vainplex_openclaw_tpu_torch.graft_entry`` is the twin of the JAX
package's ``entry()`` and ``dryrun_multichip(n)``. On the CPU
(``device="cpu"``, grids that repeat ``cpu``) and against the JAX
functions on the conftest's 8 virtual CPU devices:

- ``entry()``: the tokens bit-equal to JAX's; ``fn`` on JAX's entry
  weights against JAX's ``fn``: bf16 argmax equal and logits within 5e-2,
  fp32 (the same config at ``dtype=float32``) within 1e-5;
- ``dryrun_multichip(n)`` completes at n = 2, 4 and 8 and prints JAX's
  labels in JAX's order;
- at n = 8, JAX's ``_dryrun_impl(8)`` runs in this process and its own
  draws reach the port through ``init``: the numpy batches are equal (JAX's
  ``_make_batch`` on the same generator), the dp×tp and MoE losses within
  2e-2 of JAX's printed values (bf16 activations), the pipeline loss
  within 1e-4 (fp32), the held-out keep loss before training within 1e-2,
  and it falls over the 30 steps in both;
- an fp32 copy of leg 1c, JAX's side driven by JAX's own functions here:
  the keep loss after 30 sharded steps within 1e-4 of JAX's;
- without a card and without ``device="cpu"`` both entry points raise.
"""

from __future__ import annotations

import dataclasses
import math
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from vainplex_openclaw_tpu.models import EncoderConfig as JaxConfig
from vainplex_openclaw_tpu.models import forward as jax_forward
from vainplex_openclaw_tpu.models import init_params as jax_init_params
from vainplex_openclaw_tpu.models import train as jax_train
from vainplex_openclaw_tpu.models.data import (
    TextClassificationData as JaxData)
from vainplex_openclaw_tpu.parallel.mesh import make_mesh as jax_make_mesh
from vainplex_openclaw_tpu.parallel.mesh import shard_params
from vainplex_openclaw_tpu_torch import graft_entry
from vainplex_openclaw_tpu_torch.models import train
from vainplex_openclaw_tpu_torch.models.encoder import (
    EncoderConfig, forward, params_from_numpy)
from vainplex_openclaw_tpu_torch.parallel import plan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import __graft_entry__ as jax_graft  # noqa: E402

HEADS = ("severity", "keep", "mood", "embedding")
# the graft's Megatron rules (__graft_entry__.py:111-116)
TP_RULES = [("'q'", P(None, "tp")), ("'k'", P(None, "tp")),
            ("'v'", P(None, "tp")), ("'o'", P("tp", None)),
            ("w1", P(None, "tp")), ("w2", P("tp", None)),
            ("tok", P(None, "tp")), ("pos", P(None, "tp"))]


def jax_cfg(cfg: EncoderConfig) -> JaxConfig:
    """The JAX config of a port config (same fields, the dtype by name)."""
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
              if f.name in {g.name for g in dataclasses.fields(JaxConfig)}}
    fields["dtype"] = getattr(jnp, cfg.dtype)
    return JaxConfig(**fields)


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_draws(name: str, arg):
    """What ``_dryrun_impl`` draws with ``jax.random`` under ``name`` (the
    ``init`` seam of ``graft_entry``), as numpy."""
    if name.startswith("params:"):
        seed = int(name.split(":")[1])
        return numpy_tree(jax_init_params(jax.random.PRNGKey(seed),
                                          jax_cfg(arg)))
    if name == "ring_qkv":
        keys = jax.random.split(jax.random.PRNGKey(11), 3)
        return np.stack([np.asarray(jax.random.normal(k, arg[1:],
                                                      jnp.float32))
                         for k in keys])
    if name == "pipeline_blocks":
        n2, D, _ = arg
        keys = jax.random.split(jax.random.PRNGKey(3), n2)
        return np.stack([np.asarray(jax.random.normal(k, (D, D)))
                         / np.sqrt(D) for k in keys])
    if name == "pipeline_x":
        return np.asarray(jax.random.normal(jax.random.PRNGKey(4), arg))
    raise KeyError(name)


def skeleton(line: str) -> str:
    """A dryrun line with every number masked: its labels in order."""
    return re.sub(r"\d+(\.\d+)?", "#", line)


# ── entry() ──────────────────────────────────────────────────────────────


@pytest.fixture(scope="module")
def jax_entry():
    fn, (params, tokens) = jax_graft.entry()
    return fn, params, tokens


def test_entry_tokens_equal_jax(jax_entry):
    _, _, jtokens = jax_entry
    _, (_, tokens) = graft_entry.entry("cpu")
    assert tokens.dtype == torch.int32 and tokens.device.type == "cpu"
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(jtokens))


@pytest.mark.parametrize("dtype_name", ["bfloat16", "float32"])
def test_entry_fn_on_jax_weights_matches_jax(jax_entry, dtype_name):
    """bf16: ``fn`` on JAX's own entry weights against JAX's ``fn``; fp32:
    the same forward at ``dtype=float32`` on JAX's
    ``init_params(PRNGKey(0))`` uncast, against JAX's ``forward``."""
    jfn, jparams, jtokens = jax_entry
    fn, (params, tokens) = graft_entry.entry("cpu")
    assert params["blocks"][0]["attn"]["q"].dtype == torch.bfloat16
    cfg = EncoderConfig(dtype=dtype_name)
    if dtype_name == "float32":
        jc = jax_cfg(cfg)
        jparams = jax_init_params(jax.random.PRNGKey(0), jc)
        want = jax_forward(jparams, jnp.asarray(jtokens), jc)

        def fn(params, tokens):
            return forward(params, tokens, cfg)
    else:
        want = jfn(jparams, jtokens)
    got = fn(params_from_numpy(numpy_tree(jparams), cfg, "cpu",
                               cast=False), tokens)
    for h in HEADS:
        g = got[h].float().numpy()
        w = np.asarray(want[h], np.float32)
        assert g.shape == w.shape and np.isfinite(g).all(), h
        if dtype_name == "bfloat16" and h != "embedding":
            assert (g.argmax(-1) == w.argmax(-1)).all(), h
        np.testing.assert_allclose(
            g, w, atol=1e-5 if dtype_name == "float32" else 5e-2, rtol=0,
            err_msg=h)


# ── dryrun_multichip(n) ──────────────────────────────────────────────────


@pytest.fixture(scope="module")
def jax_dryrun_8():
    """JAX's ``_dryrun_impl(8)`` in this process: its printed line."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jax_graft._dryrun_impl(8)
    lines = [ln for ln in buf.getvalue().splitlines()
             if ln.startswith("dryrun_multichip ok")]
    assert len(lines) == 1
    return lines[0]


@pytest.fixture(scope="module")
def port_dryrun_8():
    return graft_entry.dryrun_multichip(8, "cpu", init=jax_draws)


def jax_numbers(line: str) -> dict:
    """The numbers of JAX's printed line."""
    def num(pattern):
        return float(re.search(pattern, line).group(1))

    return {"dp_tp_loss": num(r"tp\d+ train loss=([\d.]+)"),
            "moe_loss": num(r"moe\(\d+\) train loss=([\d.]+)"),
            "pp_loss": num(r"pipeline loss=([\d.]+)"),
            "keep_loss": [num(r"keep loss ([\d.]+)→"),
                          num(r"keep loss [\d.]+→([\d.]+)")]}


@pytest.mark.parametrize("n", [2, 4, 8])
def test_dryrun_completes_with_jax_labels(n, jax_dryrun_8, capsys):
    report = graft_entry.dryrun_multichip(n, "cpu")
    printed = capsys.readouterr().out.strip().splitlines()
    assert printed == [report["line"]]
    assert report["n_devices"] == n and report["grid"] == "cpu"
    assert skeleton(report["line"]) == skeleton(jax_dryrun_8)
    assert report["line"].startswith(f"dryrun_multichip ok ({n} devices): ")
    assert list(report["legs"]) == [
        "dp_tp_train", "checkpoint", "heldout", "ring_forward", "ring_flash",
        "moe_train", "pipeline", "serve_plan", "serve_pp", "serve_ep"]
    assert report["legs"]["heldout"]["steps"] == graft_entry.TRAIN_STEPS
    # the CPU runs the plain versions: no kernel launch anywhere
    assert all(leg["k1_launches"] == leg["k2_launches"] == 0
               for leg in report["legs"].values())
    dp, tp = report["legs"]["dp_tp_train"]["mesh"]
    assert dp * tp == n
    dp_sp, sp = report["legs"]["ring_forward"]["mesh"]
    assert report["legs"]["ring_flash"]["expected"] == \
        {"k1": 0, "k2": dp_sp * sp ** 2}


def test_dryrun_draws_equal_jax_make_batch(port_dryrun_8):
    rng = np.random.default_rng(0)
    jcfg = JaxConfig(**graft_entry.DENSE)
    want = {"batch": jax_graft._make_batch(rng, jcfg, 4),
            "batch2": jax_graft._make_batch(rng, jcfg, 4),
            "ring_tokens": rng.integers(1, jcfg.vocab_size,
                                        (2, jcfg.seq_len), dtype=np.int32),
            "ring_lengths": rng.integers(32, 65, (2,)),
            "moe_batch": jax_graft._make_batch(
                rng, JaxConfig(**graft_entry.MOE, n_experts=4), 4)}
    got = port_dryrun_8["draws"]
    assert got.keys() == want.keys()
    for name, w in want.items():
        g = got[name]
        if isinstance(w, dict):
            assert g.keys() == w.keys()
            for k in w:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k], err_msg=name)
        else:
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_dryrun_numbers_match_jax_on_jax_draws(port_dryrun_8, jax_dryrun_8):
    want = jax_numbers(jax_dryrun_8)
    legs = port_dryrun_8["legs"]
    assert abs(legs["dp_tp_train"]["loss"] - want["dp_tp_loss"]) <= 2e-2
    assert abs(legs["moe_train"]["loss"] - want["moe_loss"]) <= 2e-2
    assert abs(legs["pipeline"]["loss"] - want["pp_loss"]) <= 1e-4
    keep = legs["heldout"]["keep_loss"]
    assert abs(keep[0] - want["keep_loss"][0]) <= 1e-2
    assert keep[1] < keep[0] and want["keep_loss"][1] < want["keep_loss"][0]
    assert legs["ring_flash"]["max_abs_err"] <= graft_entry.RING_TOL
    assert legs["ring_flash"]["shape"] == [2, 2, 64, 8]
    assert skeleton(port_dryrun_8["line"]) == skeleton(jax_dryrun_8)


def test_heldout_leg_fp32_matches_jax_after_30_steps():
    """Leg 1c in fp32 from JAX's ``init_params(PRNGKey(0))`` on (2, 4),
    JAX's side driven by its own ``train_step``/``evaluate`` over its
    GSPMD placement: the held-out keep loss before and after 30 sharded
    steps within 1e-4."""
    cfg = EncoderConfig(**graft_entry.DENSE, dtype="float32")
    jc = jax_cfg(cfg)
    B = 4
    jparams = jax_init_params(jax.random.PRNGKey(0), jc)
    host = numpy_tree(jparams)

    jmesh = jax_make_mesh(8, axes=("dp", "tp"), shape=(2, 4))
    opt = jax_train.make_optimizer()
    jstate = jax_train.init_state(
        jax.device_put(jparams, shard_params(jparams, jmesh, TP_RULES)), opt)
    n_train = max(128, 4 * B)
    from vainplex_openclaw_tpu.models.data import synthetic_examples

    examples = synthetic_examples(n_train + 32, seed=5)
    kw = dict(batch_size=B, seq_len=jc.seq_len, vocab_size=jc.vocab_size,
              seed=5)
    jtrain, jheld = JaxData(examples[:n_train], **kw), \
        JaxData(examples[n_train:], **kw)
    jev0 = jax_train.evaluate(jstate.params, jheld, jc)
    sharding = NamedSharding(jmesh, P("dp"))
    done = 0
    for ep in range(30):
        for b in jtrain.epoch(ep):
            b = {k: jax.device_put(v, sharding) for k, v in b.items()}
            jstate, _ = jax_train.train_step(jstate, b, jc, opt)
            done += 1
            if done >= 30:
                break
        if done >= 30:
            break
    jev1 = jax_train.evaluate(jstate.params, jheld, jc)

    mesh = graft_entry.grid(8, ("dp", "tp"), device="cpu")
    state = train.init_state(plan.place_params(
        params_from_numpy(host, cfg, "cpu", cast=False), mesh,
        "encoder_validator"), train.make_optimizer())
    _, ev0, ev1, steps = graft_entry.leg_heldout(state, cfg, B)
    assert steps == 30
    assert abs(ev0["keep_loss"] - jev0["keep_loss"]) <= 1e-4
    assert abs(ev1["keep_loss"] - jev1["keep_loss"]) <= 1e-4
    assert ev1["keep_loss"] < ev0["keep_loss"]


def test_expected_launches_follow_the_runner_formulas(port_dryrun_8):
    """At 8 positions each leg records beside its counted launches the
    formula's: K1 n_layers × dp × min(tp, heads) per dense step, n_layers
    × dp per MoE step, eval batches twice, n_layers per single-device
    reference forward; K2 n_layers × dp × sp² in the ring forward and
    dp × sp² in the ring+flash leg."""
    want = {leg: r["expected"] for leg, r in port_dryrun_8["legs"].items()}
    step = 2 * 2 * 4
    assert want["dp_tp_train"] == {"k1": step, "k2": 0}
    assert want["checkpoint"] == {"k1": 2 * step, "k2": 0}
    assert want["heldout"] == {"k1": (30 + 2 * 8) * step, "k2": 0}
    assert want["ring_forward"] == {"k1": 0, "k2": 2 * 2 * 4 ** 2}
    assert want["ring_flash"] == {"k1": 0, "k2": 2 * 4 ** 2}
    assert want["moe_train"] == {"k1": 2 * 2, "k2": 0}
    assert want["pipeline"] == {"k1": 0, "k2": 0}
    assert want["serve_pp"] == {"k1": 4 + 4 * 4, "k2": 0}
    assert want["serve_ep"] == {"k1": 2 + 2 * 2 + 2 * 2, "k2": 0}
    assert want["serve_plan"]["k1"] == 2 + step + 2 * 8
    assert sum(w["k1"] for w in want.values()) == 852
    assert sum(w["k2"] for w in want.values()) == 64 + 32


def test_jax_keystr_renders_like_jax():
    params = jax_init_params(jax.random.PRNGKey(0),
                             JaxConfig(**graft_entry.MOE, n_experts=2))
    want = sorted(jax.tree_util.keystr(p) for p, _ in
                  jax.tree_util.tree_flatten_with_path(params)[0])
    port = graft_entry.draw_params(
        None, 0, EncoderConfig(**graft_entry.MOE, n_experts=2))
    got = sorted(graft_entry.jax_keystr(k)
                 for k in plan.param_path_keys(port))
    assert got == want


def test_a_failed_check_raises_assertion_error(monkeypatch):
    """A check that fails raises ``AssertionError`` by an explicit raise:
    the ring+flash leg held to a tolerance of 0."""
    monkeypatch.setattr(graft_entry, "RING_TOL", 0.0)
    mesh = graft_entry.grid(2, ("dp", "sp"), device="cpu")
    q = torch.randn(2, 2, 32, 8)
    mask = torch.ones(2, 32, dtype=torch.bool)
    with pytest.raises(AssertionError, match="ring\\+flash parity"):
        graft_entry.leg_ring_flash(mesh, q, q * 0.5, q * 2, mask)


def test_entry_points_need_a_card_or_the_cpu_by_name():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.dryrun_multichip(2)
    assert math.isfinite(float(graft_entry.entry("cpu")[1][0]["embed"]["tok"]
                               .float().abs().max()))
