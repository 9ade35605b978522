"""The port's expert-parallel MoE families against the JAX package.

- ``encoder_validator_moe`` and ``embeddings_forward_moe`` at (dp, ep) =
  (2, 4) (as ``tests/test_moe_pipeline.py`` shards the FFN) and at (1, 2)
  and (4, 1), on the repository's MoE encoder (``__graft_entry__``'s
  widths, 4 experts) against the JAX mesh path: fp32 within 1e-5 with
  ``moe_aux`` within 1e-5; bf16 with the severity argmax equal and logits
  within 1e-1 (a fresh router is near uniform: a token whose top two
  router probabilities tie within bf16 noise may pick another expert);
- the expert split of the dense dispatch: per-shard combines summed in
  fp32 equal the whole combine, and ``moe_ffn`` is the composition of the
  split steps bit for bit;
- the batcher's ``stats()["moe"]`` at dp > 1 and ep > 1 equals JAX's
  within 1e-5 (fp32), because the ``forward`` runner sums each layer's
  load-balance sums over the dp rows before the loss, which is not linear
  in them;
- a plan family without ``meshServing`` serves single-device, as the JAX
  batcher does; a dense checkpoint under an MoE family fails the
  rule-table check loudly; ``create_embeddings`` builds the MoE family's
  (dp, ep) grid and searches as the JAX backend does.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from test_serve_batching import seeded_texts
from test_torch_mesh_families import (as_numpy, jax_cfg, jax_mesh_forward,
                                      max_err, port_mesh_forward, tokens,
                                      weights)
from vainplex_openclaw_tpu.governance.validation.llm_validator import (
    build_prompt)
from vainplex_openclaw_tpu.models import batching as jax_batching
from vainplex_openclaw_tpu.models import moe as jax_moe
from vainplex_openclaw_tpu.models import serve as jax_serve
from vainplex_openclaw_tpu.models.data import synthetic_examples
from vainplex_openclaw_tpu.parallel.mesh import cached_mesh as jax_cached_mesh
from vainplex_openclaw_tpu_torch.models import batching, moe, serve
from vainplex_openclaw_tpu_torch.models.encoder import EncoderConfig
from vainplex_openclaw_tpu_torch.parallel import plan, sharded_forward
from vainplex_openclaw_tpu_torch.parallel.mesh import cached_mesh, make_mesh

MOE = {"n_experts": 4}
EP_CASES = [(2, 4), (1, 2), (4, 1)]
EP_IDS = ["2x4", "1x2", "4x1"]
FAMILIES = ["encoder_validator_moe", "embeddings_forward_moe"]


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("shape", EP_CASES, ids=EP_IDS)
def test_moe_families_fp32_match_jax(family, shape):
    jcfg, jp, cfg, params = weights("float32", **MOE)
    tok = tokens(8, 32, seed=11)
    out = port_mesh_forward(params, tok, cfg, family, ("dp", "ep"), shape)
    jout = jax_mesh_forward(jp, jnp.asarray(tok), jcfg, family,
                            ("dp", "ep"), shape)
    assert max_err(as_numpy(out), as_numpy(jout)) <= 1e-5
    assert abs(float(out["moe_aux"]) - float(jout["moe_aux"])) <= 1e-5


@pytest.mark.parametrize("family", FAMILIES)
def test_moe_families_bf16_argmax_and_logits(family):
    jcfg, jp, cfg, params = weights("bfloat16", **MOE)
    tok = tokens(8, 32, seed=12)
    got = as_numpy(port_mesh_forward(params, tok, cfg, family, ("dp", "ep"),
                                     (2, 4)))
    want = as_numpy(jax_mesh_forward(jp, jnp.asarray(tok), jcfg, family,
                                     ("dp", "ep"), (2, 4)))
    assert (got["severity"].argmax(-1) == want["severity"].argmax(-1)).all()
    assert max_err(got, want) <= 1e-1


def test_expert_shards_hold_their_experts():
    _, _, _, params = weights("float32", **MOE)
    mesh = make_mesh(axes=("dp", "ep"), shape=(2, 2), device="cpu")
    placed = plan.place_params(params, mesh, "encoder_validator_moe")
    for row in placed.trees:
        for j, tree in enumerate(row):
            w1 = tree["blocks"][1]["moe"]["w1"]
            assert torch.equal(w1, params["blocks"][1]["moe"]["w1"][2 * j:
                                                                    2 * j + 2])
            assert tree["blocks"][1]["moe"]["gate"] is \
                params["blocks"][1]["moe"]["gate"]


def test_moe_ffn_is_the_split_steps_and_expert_shards_sum_exactly():
    cfg = moe.MoEConfig(d_model=32, d_ff=64, n_experts=4)
    p = moe.init_moe_params(cfg, torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 16, 32)).astype(np.float32))
    mask = torch.arange(16)[None, :] < torch.tensor([[16], [9]])
    out, rs, ps, n = moe.moe_ffn_parts(x, p, cfg, mask)
    probs, route, gate_val = moe.moe_route(x, p["gate"], 4)
    whole = moe.moe_combine(x, p["w1"], p["w2"], route)
    assert torch.equal(out, (whole * gate_val).to(x.dtype))
    for got, want in zip(moe.moe_sums(probs, route, mask), (rs, ps, n)):
        assert torch.equal(got, want)
    split = sum(moe.moe_combine(x, p["w1"][j:j + 2], p["w2"][j:j + 2],
                                route[..., j:j + 2]) for j in (0, 2))
    assert torch.equal(split, whole)  # one nonzero term per token
    assert moe.moe_sharding_rules("ep") == [
        (pat, tuple(spec)) for pat, spec in jax_moe.moe_sharding_rules("ep")]


def test_gather_rows_takes_the_loss_over_the_summed_batch():
    """The aux repair: two rows' per-layer sums are added before the
    loss; the first row's own loss differs. ``gather_rows`` concatenates
    the batched outputs, and the ``forward`` runner puts the loss of the
    whole batch in ``moe_aux``."""
    rng = np.random.default_rng(3)
    cfg = EncoderConfig(n_experts=4)

    def row():
        return [(torch.from_numpy(rng.random(4).astype(np.float32)),
                 torch.from_numpy(rng.random(4).astype(np.float32)),
                 torch.tensor(float(rng.integers(1, 9))))
                for _ in range(2)]

    rows = [row(), row()]
    got = sharded_forward.whole_batch_aux(rows, cfg, torch.device("cpu"))
    want = sum(moe.load_balance_loss(a[0] + b[0], a[1] + b[1], a[2] + b[2], 4)
               for a, b in zip(*rows))
    first = sum(moe.load_balance_loss(*p, 4) for p in rows[0])
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert abs(float(got) - float(first)) > 1e-3
    gathered = plan.gather_rows(
        [{"severity": torch.full((1, 4), float(i)), "moe_aux": torch.zeros(())}
         for i in range(2)], torch.device("cpu"))
    assert tuple(gathered["severity"].shape) == (2, 4)
    assert gathered["severity"][:, 0].tolist() == [0.0, 1.0]


# ── the serve seam ───────────────────────────────────────────────────────

@pytest.fixture
def moe_ckpt(tmp_path):
    """The repository's MoE encoder, fp32, written by the JAX writer."""
    d = str(tmp_path / "ckpt")
    bench.write_serving_checkpoint(d, jax_cfg("float32", **MOE), seed=0)
    yield d
    serve.close_batchers()
    jax_serve.close_batchers()


@pytest.mark.parametrize("shape", [(2, 4), (2, 2)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_moe_stats_equal_jax_at_dp_and_ep(moe_ckpt, shape):
    kw = dict(max_batch=6, window_ms=0.0, autostart=False,
              plan_family="encoder_validator_moe")
    port = batching.ContinuousBatcher(
        moe_ckpt, device="cpu",
        mesh=cached_mesh(shape, ("dp", "ep"), "cpu"), **kw)
    ref = jax_batching.ContinuousBatcher(
        moe_ckpt, mesh=jax_cached_mesh(shape, ("dp", "ep")),
        searched_plans=False, **kw)
    texts = [t for t, _ in synthetic_examples(9, seed=13)] + \
        seeded_texts(8, seed=13)
    got = [port.enqueue(t) for t in texts]
    want = [ref.enqueue(t) for t in texts]
    assert port.drain() == ref.drain() == len(texts)
    assert [t.result for t in got] == [t.result for t in want]
    a, b = port.stats()["moe"], ref.stats()["moe"]
    assert a["batches"] == b["batches"] == 3
    for key in ("auxLast", "auxMean"):
        assert abs(a[key] - b[key]) <= 1e-5, key
    assert port.stats()["mesh"] == f"{shape[0]}x{shape[1]}"


def test_moe_verdicts_through_make_local_call_llm_equal_jax(moe_ckpt):
    scfg = {"meshServing": True, "meshShape": [2, 4],
            "meshAxes": ["dp", "ep"], "planFamily": "encoder_validator_moe",
            "windowMs": 0.0, "searchedPlans": False}
    jax_call = jax_serve.make_local_call_llm(checkpoint_dir=moe_ckpt,
                                             force=True, serve_cfg=scfg)
    call = serve.make_local_call_llm(moe_ckpt, device="cpu", serve_cfg=scfg)
    prompts = [build_prompt(t, []) for t in seeded_texts(8, seed=14)]
    assert [call(p) for p in prompts] == [jax_call(p) for p in prompts]
    assert call.batcher.stats()["moe"]["batches"] == len(prompts)


def test_plan_family_without_mesh_serves_single_device(moe_ckpt):
    """Repair: ``planFamily`` alone is not read without ``meshServing``,
    as in the JAX batcher: the MoE checkpoint serves on one device."""
    scfg = {"planFamily": "encoder_validator_moe", "windowMs": 0.0}
    jax_call = jax_serve.make_local_call_llm(checkpoint_dir=moe_ckpt,
                                             force=True, serve_cfg=scfg)
    call = serve.make_local_call_llm(moe_ckpt, device="cpu", serve_cfg=scfg)
    assert call.batcher.mesh is None
    prompts = [build_prompt(t, []) for t in seeded_texts(6, seed=15)]
    assert [call(p) for p in prompts] == [jax_call(p) for p in prompts]
    assert "moe" not in call.batcher.stats()


def test_dense_checkpoint_under_moe_family_fails_rule_table_check(tmp_path):
    d = str(tmp_path / "dense")
    bench.write_serving_checkpoint(d, jax_cfg("bfloat16"), seed=0)
    try:
        call = serve.make_local_call_llm(d, device="cpu", serve_cfg={
            "meshServing": True, "meshShape": [2, 4],
            "meshAxes": ["dp", "ep"], "planFamily": "encoder_validator_moe",
            "windowMs": 0.0})
        with pytest.raises(ValueError, match="rule-table validation"):
            call(build_prompt("the deploy failed", []))
    finally:
        serve.close_batchers()
    _, _, _, params = weights("float32")
    with pytest.raises(ValueError, match="matches zero param paths"):
        plan.place_params(params, make_mesh(axes=("dp", "ep"), shape=(1, 2),
                                            device="cpu"),
                          "embeddings_forward_moe")


def test_create_embeddings_serves_the_moe_family_as_jax(moe_ckpt):
    """``create_embeddings`` with ``meshServing`` and the MoE family over
    (dp, ep): the same grid and the same search ids as the JAX backend
    built from the same config."""
    from vainplex_openclaw_tpu.core.api import list_logger
    from vainplex_openclaw_tpu.knowledge import embeddings as jax_emb
    from vainplex_openclaw_tpu.knowledge.fact_store import Fact
    from vainplex_openclaw_tpu_torch.knowledge import embeddings as port_emb

    config = {"backend": "local", "meshServing": True,
              "planFamily": "embeddings_forward_moe",
              "meshAxes": ["dp", "ep"], "meshShape": [2, 4],
              "checkpointDir": moe_ckpt}
    port = port_emb.create_embeddings(config, list_logger(), device="cpu")
    ref = jax_emb.create_embeddings(config, list_logger())
    assert port._mesh.shape == dict(ref._mesh.shape) == {"dp": 2, "ep": 4}
    facts = [Fact(id=f"f{i}", subject=f"host {i % 5}", predicate="runs-on",
                  object=t, source="test", created_at="2026")
             for i, t in enumerate(seeded_texts(18, seed=18))]
    assert port.sync(facts) == ref.sync(facts) == len(facts)
    for q in seeded_texts(4, seed=19):
        assert [h["id"] for h in port.search(q, k=5)] == \
            [h["id"] for h in ref.search(q, k=5)]
