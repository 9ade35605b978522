"""The port's numpy copy of JAX's key derivation against ``jax.random``.

- ``PRNGKey``, ``split`` and ``bits`` at seeds 0, 7 and 11: the same uint32
  words (threefry2x32, ``jax_threefry_partitionable`` on);
- ``normal``: within 1e-6 of JAX's per unit draw (Giles' float32
  ``erfinv``, as XLA's; the two differ by the rounding of ``log1p`` and
  ``sqrt``);
- ``init_params_from_seed``: the whole ``EncoderConfig()`` tree of
  ``init_params(PRNGKey(seed))`` at seeds 7 and 11 within 1e-6 times each
  leaf's scale, and an MoE tree;
- without a checkpoint, ``local_triage`` (JAX's ``PRNGKey(7)`` fallback)
  decides as JAX's wherever JAX's keep margin clears the bf16 bound, with
  the keep logits within it, and ``LocalEmbeddings`` (``PRNGKey(seed)``)
  returns JAX's search ids.
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_triage_embeddings import (QUERIES, make_fact,
                                          seeded_findings)
from vainplex_openclaw_tpu.core.api import list_logger
from vainplex_openclaw_tpu.cortex.trace_analyzer import classifier as jax_cls
from vainplex_openclaw_tpu.knowledge import embeddings as jax_emb
from vainplex_openclaw_tpu.models import encoder as jax_enc
from vainplex_openclaw_tpu.models import pretrained as jax_pretrained
from vainplex_openclaw_tpu.models.tokenizer import encode_texts
from vainplex_openclaw_tpu.ops.similarity import pad_rows, pow2_bucket
from vainplex_openclaw_tpu_torch.cortex.trace_analyzer import classifier
from vainplex_openclaw_tpu_torch.knowledge import embeddings as port_emb
from vainplex_openclaw_tpu_torch.models import prng
from vainplex_openclaw_tpu_torch.models import pretrained as port_pretrained
from vainplex_openclaw_tpu_torch.models.encoder import (
    EncoderConfig, flatten_tree, init_params_from_seed)

SEEDS = (0, 7, 11)
NORMAL_TOL = 1e-6    # per N(0, 1) draw
BF16_TOL = 5e-2      # the bf16 leg's logit bound


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain versions run many small tensor ops, which stall on a
    thread pool when test workers share the cores: one thread keeps this
    file's time its own."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def fresh_caches():
    jax_pretrained.clear_cache()
    port_pretrained.clear_cache()
    yield
    jax_pretrained.clear_cache()
    port_pretrained.clear_cache()


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_bits_equal_jax(seed):
    key = jax.random.PRNGKey(seed)
    ours = prng.prng_key(seed)
    assert (np.asarray(key) == ours).all()
    assert (np.asarray(jax.random.split(key, 38)) == prng.split(ours, 38)).all()
    for shape in ((5,), (7, 33), (2, 3, 4)):
        assert (np.asarray(jax.random.bits(key, shape))
                == prng.random_bits(ours, shape)).all()


def test_seed_words_wrap_like_jax():
    for seed in (-7, 2 ** 31 + 3, 2 ** 32 + 9):
        assert (np.asarray(jax.random.PRNGKey(seed))
                == prng.prng_key(seed)).all()


@pytest.mark.parametrize("seed", SEEDS)
def test_normals_within_1e_6_of_jax(seed):
    key = jax.random.PRNGKey(seed)
    shape = (256, 1000)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    np.testing.assert_array_equal(
        prng.uniform(prng.prng_key(seed), shape, lo, 1.0),
        np.asarray(jax.random.uniform(key, shape, jnp.float32, lo, 1.0)))
    np.testing.assert_allclose(prng.normal(prng.prng_key(seed), shape),
                               np.asarray(jax.random.normal(key, shape)),
                               atol=NORMAL_TOL, rtol=0)


def leaf_scale(key: str, shape: tuple) -> float:
    """The factor ``init_params`` multiplies a leaf's unit normals by."""
    if key.endswith("/scale"):
        return 1.0
    if key.startswith("embed/") or key.endswith("/gate"):
        return 0.02
    return 1 / math.sqrt(shape[-2])


def assert_tree_is_jax(jcfg, seed: int) -> None:
    want = flatten_tree(jax.tree_util.tree_map(
        np.asarray, jax_enc.init_params(jax.random.PRNGKey(seed), jcfg)))
    cfg = EncoderConfig(**{f.name: getattr(jcfg, f.name)
                           for f in dataclasses.fields(EncoderConfig)
                           if f.name not in ("dtype",)})
    got = flatten_tree(init_params_from_seed(cfg, seed))
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key].numpy()
        assert g.dtype == np.float32 and g.shape == w.shape, key
        np.testing.assert_allclose(g, w, rtol=0, err_msg=key,
                                   atol=NORMAL_TOL * leaf_scale(key, w.shape))


@pytest.mark.parametrize("seed", (7, 11))
def test_default_encoder_tree_equals_jax(seed):
    assert_tree_is_jax(jax_enc.EncoderConfig(), seed)


def test_moe_tree_equals_jax():
    assert_tree_is_jax(jax_enc.EncoderConfig(
        vocab_size=512, seq_len=32, d_model=64, n_heads=4, n_layers=2,
        d_ff=128, n_experts=4), 3)


def test_no_checkpoint_triage_decides_like_jax(tmp_path):
    """Both fallbacks run ``EncoderConfig()`` in bf16 from ``PRNGKey(7)``.
    The keep logits agree within the bf16 bound, and so do the decisions
    wherever JAX's keep margin exceeds it; at random init a few findings
    sit closer to a tie than bf16 resolves (JAX's own dense and flash
    paths split on them)."""
    findings = seeded_findings(64, 5)
    empty = str(tmp_path)
    want = jax_cls.local_triage(findings, "critical", checkpoint_dir=empty)
    got = classifier.local_triage(findings, "critical", checkpoint_dir=empty,
                                  device="cpu")
    ours = classifier.keep_logits(findings, empty, device="cpu").numpy()
    cfg = jax_enc.EncoderConfig()
    params = jax_enc.cast_params(
        jax_enc.init_params(jax.random.PRNGKey(7), cfg), cfg.dtype)
    texts = [classifier.finding_text(f) for f in findings]
    tokens = pad_rows(encode_texts(texts, cfg.seq_len, cfg.vocab_size),
                      pow2_bucket(len(texts)))
    theirs = np.asarray(jax_enc.forward(params, tokens, cfg)["keep"],
                        np.float32)[:len(texts)]
    assert np.abs(ours - theirs).max() <= BF16_TOL
    floor = [classifier.SEVERITY_RANK.get(f.severity, 2)
             >= classifier.SEVERITY_RANK["critical"] for f in findings]
    assert [bool(k) or f for k, f in zip(theirs.argmax(-1), floor)] == want
    clear = (np.abs(theirs[:, 1] - theirs[:, 0]) > BF16_TOL) | floor
    assert clear.sum() >= 0.9 * len(findings)
    assert [g for g, c in zip(got, clear) if c] == \
        [w for w, c in zip(want, clear) if c]


def test_no_checkpoint_embeddings_search_like_jax(tmp_path):
    port = port_emb.LocalEmbeddings(list_logger(), checkpoint_dir=str(tmp_path),
                                    device="cpu")
    ref = jax_emb.LocalEmbeddings(list_logger(), checkpoint_dir=str(tmp_path))
    facts = [make_fact(i) for i in range(40)]
    assert port.sync(facts) == ref.sync(facts)
    for q in QUERIES:
        assert [h["id"] for h in port.search(q, 5)] == \
            [h["id"] for h in ref.search(q, 5)], q
