"""The port's GPipe pipeline and the ``encoder_validator_pp`` family.

- ``stack_stage_params`` equals the JAX function (shapes, values, the
  refusal of an uneven split); ``pipeline_apply`` (the single-controller
  wavefront over a ``cpu`` grid, idle steps skipped) equals the sequential
  stack and the JAX ``pipeline_apply`` over the virtual CPU devices, at the
  JAX suite's (stages, microbatches) pairs;
- ``serve_forward`` of the pipeline family at pp in {1, 2} with 4
  microbatches, and a 4-layer model at pp = 4 (as
  ``tests/test_moe_pipeline.py`` runs it), against the JAX mesh path: fp32
  within 1e-5, bf16 with the severity argmax equal and logits within 5e-2;
  attention once per layer and microbatch (n_layers × M K1 launches on
  the card);
- verdicts through ``make_local_call_llm`` equal to JAX's pipeline serve
  on the same checkpoint, with ``microbatch`` charged M times a batch.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from test_serve_batching import seeded_texts
from test_torch_mesh_families import (HEADS, as_numpy, jax_cfg,
                                      jax_mesh_forward, max_err,
                                      port_mesh_forward, tokens, weights)
from vainplex_openclaw_tpu.governance.validation.llm_validator import (
    build_prompt)
from vainplex_openclaw_tpu.models import serve as jax_serve
from vainplex_openclaw_tpu.models.data import synthetic_examples
from vainplex_openclaw_tpu.parallel import pipeline as jax_pipeline
from vainplex_openclaw_tpu.parallel import plan as jax_plan
from vainplex_openclaw_tpu.parallel.mesh import cached_mesh as jax_cached_mesh
from vainplex_openclaw_tpu.parallel.mesh import make_mesh as jax_make_mesh
from vainplex_openclaw_tpu_torch.models import checkpoint as port_ckpt
from vainplex_openclaw_tpu_torch.models import encoder, serve
from vainplex_openclaw_tpu_torch.models.encoder import forward
from vainplex_openclaw_tpu_torch.ops.similarity import pad_rows
from vainplex_openclaw_tpu_torch.parallel import plan
from vainplex_openclaw_tpu_torch.parallel.mesh import cached_mesh
from vainplex_openclaw_tpu_torch.parallel.pipeline import (
    pipeline_apply, stack_stage_params)

CPU = torch.device("cpu")


def mlp_blocks(n_layers: int = 8, D: int = 16):
    rng = np.random.default_rng(0)
    blocks = [{"w": (rng.standard_normal((D, D)) / np.sqrt(D))
               .astype(np.float32)} for _ in range(n_layers)]
    x = rng.standard_normal((8, D)).astype(np.float32)
    ref = x
    for b in blocks:
        ref = np.tanh(ref @ b["w"])
    return blocks, x, ref


def torch_stage(local, x):
    for i in range(local["w"].shape[1]):
        x = torch.tanh(x @ local["w"][0, i])
    return x


def jax_stage(local, x):
    for i in range(local["w"].shape[0]):
        x = jnp.tanh(x @ local["w"][i])
    return x


def test_stack_stage_params_equals_jax():
    blocks, _, _ = mlp_blocks(4)
    nested = [{"attn": {"q": b["w"]}, "s": b["w"][0]} for b in blocks]
    got = stack_stage_params([{"attn": {"q": torch.from_numpy(b["attn"]["q"])},
                               "s": torch.from_numpy(b["s"])} for b in nested],
                             2)
    want = jax_pipeline.stack_stage_params(nested, 2)
    assert tuple(got["attn"]["q"].shape) == (2, 2, 16, 16)
    np.testing.assert_array_equal(got["attn"]["q"].numpy(),
                                  np.asarray(want["attn"]["q"]))
    np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))
    with pytest.raises(ValueError, match="not divisible"):
        stack_stage_params([{"w": torch.zeros(1)}] * 4, 3)


@pytest.mark.parametrize("n_stages,n_micro", [(2, 4), (4, 2), (4, 8), (8, 4)])
def test_pipeline_apply_matches_sequential_and_jax(n_stages, n_micro):
    blocks, x, ref = mlp_blocks(8)
    stacked = stack_stage_params(
        [{"w": torch.from_numpy(b["w"])} for b in blocks], n_stages)
    stages = [{"w": stacked["w"][s:s + 1]} for s in range(n_stages)]
    out = pipeline_apply(stages, torch.from_numpy(x), torch_stage,
                         [CPU] * n_stages, n_microbatches=n_micro)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
    mesh = jax_make_mesh(n_stages, axes=("pp",), shape=(n_stages,))
    want = jax_pipeline.pipeline_apply(
        jax_pipeline.stack_stage_params(blocks, n_stages), jnp.asarray(x),
        jax_stage, mesh, n_microbatches=n_micro)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5)


def test_pipeline_apply_skips_idle_steps_and_hops_in_order():
    """Stage s sees microbatch m at step t = m + s: M × S stage calls, and
    each stage receives its microbatches in order from the stage before."""
    seen = []

    def stage(params, x):
        seen.append((params, int(x[0, 0])))
        return x + 1

    S, M = 3, 4
    x = torch.arange(M, dtype=torch.float32).repeat_interleave(2)[:, None] \
        * 10
    out = pipeline_apply(list(range(S)), x, stage, [CPU] * S,
                         n_microbatches=M)
    assert len(seen) == S * M
    for s in range(S):
        assert [v for p, v in seen if p == s] == \
            [10 * m + s for m in range(M)]
    torch.testing.assert_close(out, x + S)
    with pytest.raises(ValueError, match="microbatches"):
        pipeline_apply([0], x[:7], stage, [CPU], n_microbatches=4)


# ── the serve family ─────────────────────────────────────────────────────

PP_CASES = [(1, {}), (2, {}), (4, {"n_layers": 4})]
PP_IDS = ["pp1", "pp2", "pp4_4layers"]


@pytest.mark.parametrize("pp,over", PP_CASES, ids=PP_IDS)
def test_pp_serve_forward_fp32_matches_jax_and_dense(pp, over):
    jcfg, jp, cfg, params = weights("float32", **over)
    tok = tokens(8, 32, seed=7)
    got = as_numpy(port_mesh_forward(params, tok, cfg,
                                     "encoder_validator_pp", ("pp",), (pp,)))
    want = as_numpy(jax_mesh_forward(jp, jnp.asarray(tok), jcfg,
                                     "encoder_validator_pp", ("pp",), (pp,)))
    with torch.inference_mode():
        dense = as_numpy(forward(params, torch.from_numpy(tok), cfg))
    assert max_err(got, want) <= 1e-5
    assert max_err(got, dense) <= 1e-5


@pytest.mark.parametrize("pp,over", PP_CASES, ids=PP_IDS)
def test_pp_serve_forward_bf16_argmax_and_logits(pp, over):
    jcfg, jp, cfg, params = weights("bfloat16", **over)
    tok = tokens(8, 32, seed=8)
    got = as_numpy(port_mesh_forward(params, tok, cfg,
                                     "encoder_validator_pp", ("pp",), (pp,)))
    want = as_numpy(jax_mesh_forward(jp, jnp.asarray(tok), jcfg,
                                     "encoder_validator_pp", ("pp",), (pp,)))
    assert (got["severity"].argmax(-1) == want["severity"].argmax(-1)).all()
    assert max_err(got, want) <= 5e-2


def test_pp_moe_aux_is_zero_and_attention_runs_per_microbatch(monkeypatch):
    _, _, cfg, params = weights("float32", n_layers=4)
    calls = []
    real_attend = encoder.attend

    def spy(q, *a, **kw):
        calls.append(q.shape[0])
        return real_attend(q, *a, **kw)

    monkeypatch.setattr(encoder, "attend", spy)
    out = port_mesh_forward(params, tokens(8, 32), cfg,
                            "encoder_validator_pp", ("pp",), (2,))
    # the plan that served: the searched cpu:2 row (2 microbatches), as
    # JAX resolves it
    M = plan.serving_plan("encoder_validator_pp",
                          cached_mesh((2,), ("pp",), "cpu")).microbatches
    assert M == jax_plan.serving_plan(
        "encoder_validator_pp", jax_cached_mesh((2,), ("pp",))).microbatches
    assert len(calls) == cfg.n_layers * M and set(calls) == {8 // M}
    assert float(out["moe_aux"]) == 0.0


@pytest.mark.parametrize("n", [1, 3, 4, 5, 9])
@pytest.mark.parametrize("pp", [1, 2, 4])
def test_serve_bucket_floors_at_microbatches_as_jax(n, pp):
    mesh, jmesh = cached_mesh((pp,), ("pp",), "cpu"), \
        jax_cached_mesh((pp,), ("pp",))
    # the family resolves the searched cpu rows (pp = 2 floors at its 2
    # microbatches, pp = 4 at 4), as in JAX
    got = plan.serve_bucket(n, mesh, plan="encoder_validator_pp")
    assert got == jax_plan.serve_bucket(n, jmesh,
                                        plan="encoder_validator_pp")
    # the hand-written plan floors at its 4 microbatches
    hand = plan.serve_bucket(n, mesh,
                             plan=plan.PLAN_TABLE["encoder_validator_pp"])
    want = jax_plan.serve_bucket(n, jmesh, plan=jax_plan.PLAN_TABLE[
        "encoder_validator_pp"])
    assert hand == want and hand % 4 == 0


def test_pp_refuses_layers_that_do_not_divide():
    _, _, cfg, params = weights("float32")
    mesh = cached_mesh((4,), ("pp",), "cpu")
    assert cfg.n_layers == 2
    with pytest.raises(ValueError, match="not divisible into 4 stages"):
        plan.place_params(params, mesh, "encoder_validator_pp")


@pytest.fixture
def pp_ckpt(tmp_path):
    d = str(tmp_path / "ckpt")
    bench.write_serving_checkpoint(
        d, jax_cfg("bfloat16", seq_len=64, n_layers=4), seed=0)
    yield d
    serve.close_batchers()
    jax_serve.close_batchers()


@pytest.mark.parametrize("pp", [2, 4])
def test_pp_verdicts_equal_jax_pipeline_serve(pp_ckpt, pp):
    scfg = {"meshServing": True, "meshShape": [pp], "meshAxes": ["pp"],
            "planFamily": "encoder_validator_pp", "windowMs": 0.0,
            "searchedPlans": False}
    jax_call = jax_serve.make_local_call_llm(checkpoint_dir=pp_ckpt,
                                             force=True, serve_cfg=scfg)
    call = serve.make_local_call_llm(pp_ckpt, device="cpu", serve_cfg=scfg)
    texts = [t for t, _ in synthetic_examples(6, seed=9)] + \
        seeded_texts(4, seed=9)
    prompts = [build_prompt(t, []) for t in texts]
    assert [call(p) for p in prompts] == [jax_call(p) for p in prompts]
    stats = call.batcher.stats()
    assert stats["mesh"] == str(pp)
    assert stats["meshRuns"]["pipeline"] == stats["batches"]
    counts = stats["stages"]["counts"]
    assert counts["microbatch"] == 4 * stats["batches"] == \
        jax_call.batcher.timer.snapshot()["counts"]["microbatch"]
    assert math.isclose(stats["stages"]["stages_ms"]["microbatch"],
                        stats["stages"]["stages_ms"]["prefill"],
                        rel_tol=1e-9)


def test_pp_restore_then_serve_equals_flat_forward(tmp_path):
    """A pipeline restore stacks on the host, places the stages and serves
    what the flat tree computes."""
    _, _, cfg, params = weights("float32", n_layers=4)
    d = str(tmp_path / "ckpt")
    port_ckpt.save_checkpoint(d, params, step=1)
    mesh = cached_mesh((4,), ("pp",), "cpu")
    placed = port_ckpt.restore_checkpoint(d, like=params, mesh=mesh,
                                          plan="encoder_validator_pp")
    assert [tuple(t["blocks"]["attn"]["q"].shape) for t in placed.trees[0]] \
        == [(1, 1, 64, 64)] * 4
    tok = tokens(3, 32, seed=10)
    padded = pad_rows(tok, plan.serve_bucket(3, mesh,
                                             plan="encoder_validator_pp"))
    assert len(padded) == 4
    with torch.inference_mode():
        out = plan.serve_forward(
            placed, plan.place_tokens(padded, mesh, "encoder_validator_pp"),
            cfg, mesh, "encoder_validator_pp")
        want = forward(params, torch.from_numpy(tok), cfg)
    for h in HEADS:
        torch.testing.assert_close(out[h][:3], want[h], atol=1e-5, rtol=0)
