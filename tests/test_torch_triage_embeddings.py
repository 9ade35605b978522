"""The port's ``local_triage`` and embeddings against the JAX package.

- ``local_triage`` on the shipped checkpoint: decisions identical to the
  JAX function on the ``tests/test_pretrained.py`` fixtures and on 64
  seeded findings, at ``min_severity`` "critical" (the model decides
  alone) and "medium" (the rule floor joins in).
- ``LocalEmbeddings``: over the ``tests/test_knowledge_perf_equiv.py``
  corpora (randomized sync / remove / search sequences, arena growth past
  64 rows) the search ids are identical to the JAX backend's in fp32 (the
  shipped weights written as an fp32 checkpoint, loaded by both) and the
  top-1 ids are identical in bf16 (the shipped checkpoint as it ships);
  the ``tests/test_pretrained.py`` semantic case ranks the failure fact
  first on both.
- A ``KnowledgeEnginePlugin`` from the JAX package driven through a gateway
  with the port's embeddings swapped in by attribute (``plugin.embeddings``
  and ``plugin.maintenance.embeddings``), so no JAX file changes.
- The Chroma half (a copy of jax-free code): payloads, endpoints and
  delete semantics equal to JAX's.
"""

from __future__ import annotations

import dataclasses
import random

import numpy as np
import pytest
import torch

from vainplex_openclaw_tpu.core.api import list_logger
from vainplex_openclaw_tpu.cortex.trace_analyzer import classifier as jax_cls
from vainplex_openclaw_tpu.cortex.trace_analyzer.signals import FailureSignal
from vainplex_openclaw_tpu.knowledge import KnowledgeEnginePlugin
from vainplex_openclaw_tpu.knowledge import embeddings as jax_emb
from vainplex_openclaw_tpu.knowledge.fact_store import Fact
from vainplex_openclaw_tpu.models import pretrained as jax_pretrained
from vainplex_openclaw_tpu_torch.cortex.trace_analyzer import classifier
from vainplex_openclaw_tpu_torch.knowledge import embeddings as port_emb
from vainplex_openclaw_tpu_torch.models import checkpoint as port_ckpt
from vainplex_openclaw_tpu_torch.models import pretrained as port_pretrained
from vainplex_openclaw_tpu_torch.models.encoder import unflatten_tree

from helpers import make_gateway

SEVERITIES = ("info", "low", "medium", "high", "critical")
_SUMMARIES = (
    "error: deployment {n} exceeded progress deadline",
    "tool {n} failed: connection refused after {i} retries",
    "thanks, {n} works perfectly now",
    "looks good, merging {n}",
    "reading file {n} ({i} bytes)",
    "permission denied writing to {n}",
    "you already tried {n} three times, stop repeating yourself",
    "what does the {n} flag do again?",
)
_NOUNS = ("deploy", "cache", "billing-job", "ingress", "webhook", "auth")


@pytest.fixture(autouse=True)
def fresh_caches():
    jax_pretrained.clear_cache()
    port_pretrained.clear_cache()
    yield
    jax_pretrained.clear_cache()
    port_pretrained.clear_cache()


def finding(summary, severity="info", evidence=()):
    return FailureSignal(signal="tool_failure", severity=severity,
                         chain_id="c1", agent="a", session="s", ts=0.0,
                         summary=summary, evidence=list(evidence))


def seeded_findings(n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        text = _SUMMARIES[rng.integers(len(_SUMMARIES))].format(
            n=_NOUNS[rng.integers(len(_NOUNS))], i=int(rng.integers(2, 500)))
        evidence = [f"exit {int(rng.integers(0, 3))}"] \
            if rng.random() < 0.5 else []
        out.append(finding(text, SEVERITIES[rng.integers(5)], evidence))
    return out


# ── local_triage ────────────────────────────────────────────────────


def test_trained_keep_head_decides_like_jax():
    failure = finding("error: deployment exceeded progress deadline")
    noise = finding("thanks, cache works perfectly now")
    got = classifier.local_triage([failure, noise], min_severity="critical",
                                  device="cpu")
    assert got == jax_cls.local_triage([failure, noise],
                                       min_severity="critical")
    assert got == [True, False]


@pytest.mark.parametrize("min_severity", ["critical", "medium"])
@pytest.mark.parametrize("seed", [0, 1])
def test_seeded_findings_decide_like_jax(seed, min_severity):
    findings = seeded_findings(64, seed)
    got = classifier.local_triage(findings, min_severity=min_severity,
                                  device="cpu")
    want = jax_cls.local_triage(findings, min_severity=min_severity)
    assert got == want
    if min_severity == "critical":
        assert 0 < sum(got) < len(got)  # the model keeps some, drops some


def test_keep_logits_give_the_model_decisions_of_jax():
    """Above every rule severity the decisions are the keep head's argmax
    alone: the same from ``keep_logits`` as from both ``local_triage``s."""
    findings = [dataclasses.replace(f, severity="info")
                for f in seeded_findings(64, 2)]
    logits = classifier.keep_logits(findings, device="cpu")
    assert logits.shape == (64, 2) and logits.dtype == torch.float32
    model = [bool(k) for k in logits.argmax(dim=-1).tolist()]
    assert model == classifier.local_triage(findings, "critical",
                                            device="cpu")
    assert model == jax_cls.local_triage(findings, min_severity="critical")
    assert 0 < sum(model) < len(model)


def test_rule_floor_keeps_severe_findings_and_empty_is_empty():
    noise = finding("thanks, cache works perfectly now", severity="high")
    assert classifier.local_triage([noise], min_severity="high",
                                   device="cpu") == [True]
    assert classifier.local_triage([], device="cpu") == []
    assert classifier.SEVERITY_RANK == jax_cls.SEVERITY_RANK


def test_triage_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        classifier.local_triage([finding("x")])


def test_triage_without_checkpoint_uses_the_seeded_init(tmp_path):
    findings = seeded_findings(5, 3)
    got = classifier.local_triage(findings, min_severity="critical",
                                  checkpoint_dir=str(tmp_path), device="cpu")
    again = classifier.local_triage(findings, min_severity="critical",
                                    checkpoint_dir=str(tmp_path),
                                    device="cpu")
    assert got == again and len(got) == 5


# ── LocalEmbeddings ─────────────────────────────────────────────────


def make_fact(i: int) -> Fact:
    words = ["deploy", "cluster", "kubernetes", "coffee", "redis", "latency"]
    return Fact(id=f"f{i}", subject=f"svc{i % 7} {words[i % 6]}",
                predicate="emits", object=f"signal {i} {words[(i * 3) % 6]}")


QUERIES = ["kubernetes deploy status", "redis latency spike",
           "coffee in the cluster", "signal 3"]


@pytest.fixture(scope="module")
def fp32_checkpoint(tmp_path_factory):
    """The shipped weights as an fp32 checkpoint both packages load
    without the bf16 inference cast."""
    path = str(tmp_path_factory.mktemp("tiny_fp32"))
    flat = {k: torch.as_tensor(v).float() for k, v in
            port_ckpt.read_checkpoint(port_pretrained.DEFAULT_DIR).items()}
    cfg = dataclasses.replace(port_pretrained.TINY_CONFIG, dtype="float32")
    port_pretrained.write_pretrained(path, cfg, unflatten_tree(flat))
    return path


def pair(checkpoint_dir=None):
    return (port_emb.LocalEmbeddings(list_logger(),
                                     checkpoint_dir=checkpoint_dir,
                                     device="cpu"),
            jax_emb.LocalEmbeddings(list_logger(),
                                    checkpoint_dir=checkpoint_dir))


def ids(hits):
    return [h["id"] for h in hits]


@pytest.mark.parametrize("seed", range(4))
def test_randomized_sequences_search_like_jax_fp32(fp32_checkpoint, seed):
    port, ref = pair(fp32_checkpoint)
    rng = random.Random(seed)
    pool = [make_fact(i) for i in range(40)]
    for _ in range(14):
        op = rng.random()
        if op < 0.5:
            batch = rng.sample(pool, k=rng.randint(1, 9))
            assert port.sync(batch) == ref.sync(batch)
        elif op < 0.7:
            dead = [f"f{rng.randrange(50)}" for _ in range(rng.randint(1, 6))]
            assert port.remove(dead) == ref.remove(dead)
        else:
            q, k = rng.choice(QUERIES), rng.randint(1, 8)
            got, want = port.search(q, k=k), ref.search(q, k=k)
            assert ids(got) == ids(want)
            assert [h["document"] for h in got] == \
                [h["document"] for h in want]
            np.testing.assert_allclose([h["score"] for h in got],
                                       [h["score"] for h in want], atol=1e-5)
        assert port.count() == ref.count()
        assert sorted(port._ids) == sorted(ref._ids)
    for q in QUERIES:
        assert ids(port.search(q, k=5)) == ids(ref.search(q, k=5))


def test_arena_growth_searches_like_jax_fp32(fp32_checkpoint):
    port, ref = pair(fp32_checkpoint)
    for lo in range(0, 96, 16):
        batch = [make_fact(i) for i in range(lo, lo + 16)]
        port.sync(batch)
        ref.sync(batch)
    assert port.count() == 96 and len(port._arena) >= 96
    for q in QUERIES:
        assert ids(port.search(q, k=10)) == ids(ref.search(q, k=10))
    port.remove([f"f{i}" for i in range(0, 96, 3)])
    ref.remove([f"f{i}" for i in range(0, 96, 3)])
    for q in QUERIES:
        assert ids(port.search(q, k=12)) == ids(ref.search(q, k=12))


def test_vectors_match_jax_fp32(fp32_checkpoint):
    port, ref = pair(fp32_checkpoint)
    docs = [port_emb.fact_document(make_fact(i)) for i in range(13)]
    np.testing.assert_allclose(port._embed(docs), ref._embed(docs),
                               atol=1e-5)


def test_shipped_bf16_top1_like_jax():
    port, ref = pair()
    facts = [make_fact(i) for i in range(40)]
    port.sync(facts)
    ref.sync(facts)
    for q in QUERIES + ["deploy failed", "latency signal 17"]:
        assert ids(port.search(q, k=1)) == ids(ref.search(q, k=1)), q
    port_vecs = port._embed(QUERIES)
    ref_vecs = ref._embed(QUERIES)
    np.testing.assert_allclose(port_vecs, ref_vecs, atol=5e-2)


def test_semantic_retrieval_beats_bag_of_tokens():
    """``tests/test_pretrained.py``'s case: the query shares no token with
    the failure fact; only the trained half ranks it first."""
    class F:
        def __init__(self, id, s, p, o):
            self.id, self.subject, self.predicate, self.object = id, s, p, o
            self.source, self.created_at = "test", "2026-01-01"

    port, ref = pair()
    facts = [F("f1", "deploy", "failed-with", "connection refused"),
             F("f2", "team", "enjoyed", "lunch menu")]
    port.sync(facts)
    ref.sync(facts)
    q = "error: build exceeded progress deadline"
    got = port.search(q, k=2)
    assert ids(got) == ids(ref.search(q, k=2)) == ["f1", "f2"]
    assert got[0]["score"] > got[1]["score"]


def test_query_cache_sees_post_sync_index():
    port, _ = pair()
    port.sync([make_fact(i) for i in range(8)])
    q = "fresh kubernetes deployment signal"
    first = port.search(q, k=4)
    hits = port.query_cache_hits
    port.sync([Fact(id="fresh1", subject="fresh kubernetes",
                    predicate="emits", object="deployment signal")])
    second = port.search(q, k=4)
    assert port.query_cache_hits == hits + 1
    assert "fresh1" in ids(second) and second != first
    port.remove(["fresh1"])
    assert "fresh1" not in ids(port.search(q, k=4))
    assert {"sync", "search"} <= set(port.timer.counts())


def test_create_embeddings_backends():
    log = list_logger()
    assert isinstance(port_emb.create_embeddings({"backend": "chroma"}, log),
                      port_emb.ChromaEmbeddings)
    local = port_emb.create_embeddings({}, log, device="cpu")
    assert isinstance(local, port_emb.LocalEmbeddings)
    assert port_emb.create_embeddings({"backend": "other"}, log) is None
    # meshServing: the dp family over every CPU grid entry, search ids
    # equal to the meshless backend's
    meshy = port_emb.create_embeddings({"meshServing": True}, log,
                                       device="cpu")
    assert meshy._mesh.shape == {"dp": 8}
    facts = [Fact(id=f"f{i}", subject=f"service {i}", predicate="runs-on",
                  object=("k8s" if i % 2 else "the deploy failed"),
                  source="test", created_at="2026") for i in range(11)]
    assert meshy.sync(facts) == local.sync(facts) == len(facts)
    for q in ("deploy failed", "service 3 runs on k8s"):
        assert ids(meshy.search(q, k=4)) == ids(local.search(q, k=4))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            port_emb.create_embeddings({}, log)


@pytest.mark.parametrize("endpoint", [
    "http://chroma:8000/api/v2/collections/{name}/upsert",
    "http://chroma:8000//custom"])
def test_chroma_half_equals_jax(endpoint):
    facts = [Fact(id=f"f{i}", subject=f"s{i}", predicate="runs-on",
                  object="k8s", source="test", created_at="2026") for i in
             range(3)]
    assert port_emb.construct_chroma_payload(facts) == \
        jax_emb.construct_chroma_payload(facts)
    calls = {"port": [], "jax": []}
    cfg = {"enabled": True, "endpoint": endpoint, "collectionName": "kb"}
    port = port_emb.ChromaEmbeddings(
        cfg, list_logger(), lambda u, p: calls["port"].append((u, p)))
    ref = jax_emb.ChromaEmbeddings(
        cfg, list_logger(), lambda u, p: calls["jax"].append((u, p)))
    assert port.sync(facts) == ref.sync(facts)
    assert port.remove(["f2", "f1"]) == ref.remove(["f2", "f1"])
    assert calls["port"] == calls["jax"]


# ── through the knowledge plugin ────────────────────────────────────

MESSAGES = ("Contact anna@example.org at Acme GmbH about the launch",
            "anna is our CTO", "Talk to bob@corp.io about Postgres 16",
            "Reach bob@corp.io today", "deploy failed: connection refused")


def drive_plugin(workspace, swap):
    gw, _ = make_gateway()
    plugin = KnowledgeEnginePlugin(workspace=str(workspace), clock=gw.clock,
                                   wall_timers=False)
    gw.load(plugin, plugin_config={"enabled": True})
    gw.start()
    if swap:
        emb = port_emb.LocalEmbeddings(list_logger(), timer=plugin.timer,
                                       device="cpu")
        plugin.embeddings = emb
        plugin.maintenance.embeddings = emb
    for text in MESSAGES:
        gw.message_received(text, {"session_key": "s"})
    synced = plugin.maintenance.run_embeddings_sync()
    # fact ids are random per store: compare the documents
    top = {q: [h["document"] for h in plugin.embeddings.search(q, k=1)]
           for q in ("who is the CTO", "postgres", "deploy error")}
    status = plugin.status_text("anna")
    gw.stop()
    return plugin, synced, top, status


def test_knowledge_plugin_serves_the_port_embeddings(tmp_path, openclaw_home):
    plugin, synced, top, status = drive_plugin(tmp_path / "port", swap=True)
    _, synced_ref, top_ref, _ = drive_plugin(tmp_path / "ref", swap=False)
    assert isinstance(plugin.embeddings, port_emb.LocalEmbeddings)
    assert synced == synced_ref > 0
    assert plugin.embeddings.count() == synced
    assert top == top_ref
    assert "semantic:" in status
    assert plugin.stats()["queryCache"]["misses"] >= 3
