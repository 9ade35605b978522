"""The comparison that decides ``correct`` has to fail: the control (the
reference one precision below the configuration's bfloat16) and an answer
altered where the program produces it."""

import json
import os

import torch

from portbench import run as R
from portbench.reference import text as T
from portbench.reference.encoder import Reference, load_npz
from portbench.spec import ROOT, Spec
from portbench.traffic import generator as G
from portbench.weights import newest_npz

CHECKPOINT = os.path.join("vainplex_openclaw_tpu", "models", "pretrained",
                          "triage-tiny")

MODEL = {"vocab_size": 2048, "seq_len": 64, "d_model": 64, "n_heads": 4,
         "n_layers": 2, "d_ff": 256}
SEEDS = (3, 1_000_003, 2**31 + 99)


def limits(cell: str) -> dict:
    with open(os.path.join(ROOT, "portbench", "limits", cell + ".json")) as f:
        return json.load(f)


def references():
    weights = load_npz(newest_npz(os.path.join(ROOT, CHECKPOINT)))
    return (Reference(weights, MODEL),
            Reference(weights, MODEL, precision="fp8"))


def test_control_fails_the_verdict_gap():
    """At 2,048 chat messages a seed, fp8 puts first a class whose fp32
    logit lies further below the best than the limit allows."""
    with open(os.path.join(ROOT, "portbench", "traffic",
                           "stage3_chat.json")) as f:
        mix = {**json.load(f), "pool": 2048}
    limit = limits("triage_tiny.stage3_chat")["verdict_gap"]["limit"]
    ref, low = references()
    for seed in SEEDS:
        tokens = T.encode_texts(G.generate(mix, seed), 64, 2048)
        want = ref.logits(tokens, "severity")
        cls = low.logits(tokens, "severity").argmax(dim=1)
        gap = float((want.max(dim=1).values
                     - want.gather(1, cls[:, None])[:, 0]).max())
        assert gap > limit, (seed, gap, limit)


def test_control_fails_the_keep_logits():
    limit = limits("triage_tiny.bulk_triage")["keep_logit_err"]["limit"]
    ref, low = references()
    for seed in SEEDS:
        calls = G.generate({"texts": "findings", "pool": 1,
                            "sizes": {"loguniform": [2048, 2049]}}, seed)
        tokens = T.encode_texts([T.finding_text(f) for f in calls[0]], 64,
                                2048)
        err = float((low.logits(tokens, "keep")
                     - ref.logits(tokens, "keep")).abs().max())
        assert err > limit, (seed, err, limit)


def test_altered_verdict_is_not_correct(bench_copy, monkeypatch):
    """A verdict altered where the batcher renders it: one class up."""
    from vainplex_openclaw_tpu_torch.models import batching

    real = batching.render_verdict
    monkeypatch.setattr(batching, "render_verdict",
                        lambda c: real((int(c) + 1) % 4))
    root, _ = bench_copy
    result = R.execute(Spec(root), "triage_tiny.stage3_chat", 11, 1.0,
                       False, device="cpu")
    assert result["correct"] is False
    assert result["checks"]["verdict_gap"]["value"] \
        > result["checks"]["verdict_gap"]["limit"]


def test_altered_keep_logits_are_not_correct(bench_copy, monkeypatch):
    """Keep logits altered where the forward produces them: the two
    classes swapped."""
    from vainplex_openclaw_tpu_torch.cortex.trace_analyzer import classifier

    real = classifier.forward

    def swapped(params, tokens, cfg):
        out = dict(real(params, tokens, cfg))
        out["keep"] = torch.flip(out["keep"], dims=[-1])
        return out

    monkeypatch.setattr(classifier, "forward", swapped)
    root, _ = bench_copy
    result = R.execute(Spec(root), "triage_tiny.bulk_triage", 12, 1.0,
                       False, device="cpu")
    assert result["correct"] is False


def test_failed_requests_are_not_correct(bench_copy, monkeypatch):
    """Answers that never come: every third request raises."""
    from vainplex_openclaw_tpu_torch.models import batching

    real, calls = batching.ContinuousBatcher.submit, {"n": 0}

    def flaky(self, text, *args, **kwargs):
        calls["n"] += 1
        if calls["n"] % 3 == 0:
            raise RuntimeError("planted fault")
        return real(self, text, *args, **kwargs)

    monkeypatch.setattr(batching.ContinuousBatcher, "submit", flaky)
    root, _ = bench_copy
    result = R.execute(Spec(root), "triage_tiny.stage3_chat", 13, 1.0,
                       False, device="cpu")
    assert result["correct"] is False and result["failed"] > 0


def test_fault_on_a_repeated_call_is_not_correct(bench_copy, monkeypatch):
    """Keep logits altered only from a call's third time on (a stale cache
    or a reused buffer would show so): every occurrence of a sampled call
    is compared, not only its first in the window."""
    from vainplex_openclaw_tpu_torch.cortex.trace_analyzer import classifier

    real, seen = classifier.keep_logits, {}

    def stale(findings, *args, **kwargs):
        seen[id(findings)] = seen.get(id(findings), 0) + 1
        out = real(findings, *args, **kwargs)
        return out + 1.0 if seen[id(findings)] >= 3 else out

    monkeypatch.setattr(classifier, "keep_logits", stale)
    root, _ = bench_copy
    result = R.execute(Spec(root), "triage_tiny.bulk_triage", 14, 1.0,
                       False, device="cpu")
    assert max(seen.values()) >= 3
    assert result["correct"] is False
    assert result["checks"]["keep_logit_err"]["value"] >= 0.99


def test_control_run_comes_out_not_correct(bench_copy):
    """The control through the run's own gate: ``execute`` with
    ``control`` holds the fp8 reference's numbers to the same limits."""
    root, edit = bench_copy

    def larger(t):
        t.update(pool=2, sizes={"loguniform": [1024, 1025]})
        t["check"]["sample"] = 2048

    edit("portbench/traffic/bulk_triage.json", larger)
    result = R.execute(Spec(root), "triage_tiny.bulk_triage", SEEDS[0], 1.0,
                       False, device="cpu", control=True)
    assert result["correct"] is True
    assert result["_control"]["correct"] is False
    c = result["_control"]["checks"]["keep_logit_err"]
    assert c["value"] > c["limit"]
