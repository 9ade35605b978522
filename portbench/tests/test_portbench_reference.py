"""The plain reference against the port at device="cpu" and tiny sizes,
and its frozen copies against the program's text handling."""

import numpy as np
import pytest
import torch

from portbench.reference import text as T
from portbench.reference.encoder import Reference, load_npz
from portbench.traffic import generator as G
from portbench.weights import newest_npz

TINY = {"vocab_size": 64, "seq_len": 24, "d_model": 16, "n_heads": 2,
        "n_layers": 2, "d_ff": 32, "n_severity": 4, "n_mood": 5}


def seeded_weights(model: dict, seed: int) -> dict:
    """Random weights of the dense encoder at the encoder's initial scales
    (embeddings N(0, 0.02²), matrices and heads N(0, 1/fan_in), norm
    scales 1), in the checkpoint's keys."""
    D, F = model["d_model"], model["d_ff"]
    shapes = {"embed/tok": (model["vocab_size"], D),
              "embed/pos": (model["seq_len"], D),
              "heads/severity": (D, model["n_severity"]),
              "heads/keep": (D, 2), "heads/mood": (D, model["n_mood"]),
              "heads/embed_proj": (D, D)}
    for i in range(model["n_layers"]):
        for name in ("q", "k", "v", "o"):
            shapes[f"blocks/{i}/attn/{name}"] = (D, D)
        shapes[f"blocks/{i}/mlp/w1"] = (D, F)
        shapes[f"blocks/{i}/mlp/w2"] = (F, D)
    rng = np.random.default_rng(seed)
    out = {k: (rng.standard_normal(shape) * (
        0.02 if k.startswith("embed/") else shape[0] ** -0.5))
        .astype(np.float32) for k, shape in shapes.items()}
    for key in ["final_norm/scale"] + [
            f"blocks/{i}/{n}/scale" for i in range(model["n_layers"])
            for n in ("norm1", "norm2")]:
        out[key] = np.ones(D, np.float32)
    return out


def port_logits(weights: dict, model: dict, tokens: np.ndarray,
                dtype: str) -> dict:
    from vainplex_openclaw_tpu_torch.models.encoder import (
        EncoderConfig, forward, params_from_numpy, unflatten_tree)

    cfg = EncoderConfig(**{**model, "dtype": dtype})
    params = params_from_numpy(
        unflatten_tree({k: torch.from_numpy(v) for k, v in weights.items()}),
        cfg, "cpu", cast=True)
    with torch.inference_mode():
        return forward(params, torch.from_numpy(tokens), cfg)


def tiny_tokens(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    texts = [G.text_of(int(k), rng) for k in rng.integers(2, 30, size=n)]
    return T.encode_texts(texts, TINY["seq_len"], TINY["vocab_size"])


@pytest.mark.parametrize("head", ["severity", "keep", "mood"])
def test_reference_matches_the_port_in_fp32(head):
    weights = seeded_weights(TINY, 3)
    tokens = tiny_tokens(40, 1)
    want = port_logits(weights, TINY, tokens, "float32")[head]
    got = Reference(weights, TINY).logits(tokens, head)
    assert torch.allclose(got, want, atol=2e-5, rtol=1e-5)


def test_blocked_attention_equals_one_block():
    weights = seeded_weights(TINY, 4)
    tokens = tiny_tokens(24, 2)
    whole = Reference(weights, TINY).logits(tokens, "severity")
    blocked = Reference(weights, TINY, score_budget=64).logits(
        tokens, "severity", token_budget=40)
    assert torch.allclose(whole, blocked, atol=1e-5, rtol=1e-5)


def test_shipped_checkpoint_bf16_port_near_the_reference():
    from vainplex_openclaw_tpu_torch.models.pretrained import DEFAULT_DIR

    model = {"vocab_size": 2048, "seq_len": 64, "d_model": 64,
             "n_heads": 4, "n_layers": 2, "d_ff": 256}
    weights = load_npz(newest_npz(DEFAULT_DIR))
    texts = G.generate({"texts": "chat", "pool": 256, "sizes": {
        "lognormal": {"median": 98, "sigma": 1.0}, "min": 3, "max": 4096}}, 7)
    tokens = T.encode_texts(texts, 64, 2048)
    got = port_logits(weights, model, tokens, "bfloat16")["severity"]
    want = Reference(weights, model).logits(tokens, "severity")
    # bf16 body against fp32: within a tenth of a logit on this model
    assert float((got - want).abs().max()) < 0.1


def test_frozen_copies_match_the_program():
    from vainplex_openclaw_tpu_torch.cortex.trace_analyzer.classifier import \
        finding_text
    from vainplex_openclaw_tpu_torch.models.batching import render_verdict
    from vainplex_openclaw_tpu_torch.models.serve import _extract_message
    from vainplex_openclaw_tpu_torch.models.tokenizer import encode_texts

    texts = G.generate({"texts": "chat", "pool": 64, "sizes": {
        "lognormal": {"median": 98, "sigma": 1.0}, "min": 3, "max": 4096}}, 9)
    texts += ["héllo wörld $x #y @z a/b.c-d", "", "line one\n\nline two"]
    assert (T.encode_texts(texts, 64, 2048)
            == encode_texts(texts, 64, 2048)).all()
    for t in texts:
        prompt = T.as_prompt(t)
        assert T.extract_message(prompt) == _extract_message(prompt)
        assert T.real_tokens(t, 64) == int(
            (T.encode_texts([t], 64, 2048) > 0).sum())
    for c in range(4):
        assert T.render_verdict(c) == render_verdict(c)
    calls = G.generate({"texts": "findings", "pool": 1,
                        "sizes": {"loguniform": [20, 21]}}, 2)
    for f in calls[0]:
        assert T.finding_text(f) == finding_text(f)


def test_control_rounds_to_fp8():
    weights = seeded_weights(TINY, 5)
    tokens = tiny_tokens(64, 3)
    ref = Reference(weights, TINY).logits(tokens, "severity")
    low = Reference(weights, TINY, precision="fp8").logits(tokens,
                                                           "severity")
    err = float((low - ref).abs().max())
    assert 1e-3 < err < 1.0

