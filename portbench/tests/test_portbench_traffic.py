"""The one traffic generator: seeded, the same sizes for every seed, and
the distributions each mix states."""

import json
import os
import statistics

import numpy as np
import pytest

from portbench.reference import text as T
from portbench.traffic import generator as G

TRAFFIC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "traffic")


def mix(name: str) -> dict:
    with open(os.path.join(TRAFFIC, name + ".json")) as f:
        return json.load(f)


# A mix of the ``words`` kind (``text_of``), which no cell uses yet.
WORDS = {"texts": "words", "pool": 256, "sizes": {"loguniform": [2, 16383]}}


def small(name: str, pool: int) -> dict:
    m = dict(WORDS) if name == "words" else mix(name)
    m["pool"] = pool
    return m


@pytest.mark.parametrize("name,pool", [("stage3_chat", 256),
                                       ("words", 16),
                                       ("bulk_triage", 4)])
def test_same_seed_same_traffic(name, pool):
    m = small(name, pool)
    if name == "bulk_triage":
        m["sizes"] = {"loguniform": [10, 40]}
    a, b = G.generate(m, 2**31 + 7), G.generate(m, 2**31 + 7)
    c = G.generate(m, 2**31 + 8)
    assert a == b
    assert a != c


@pytest.mark.parametrize("name,pool", [("stage3_chat", 512),
                                       ("words", 32)])
def test_every_seed_gets_the_same_sizes(name, pool):
    m = small(name, pool)
    kind = m["texts"]
    count = (lambda t: len(t.split())) if kind == "chat" \
        else (lambda t: T.real_tokens(t, 1 << 20))
    sizes = [sorted(count(t) for t in G.generate(m, s)) for s in (1, 99)]
    assert sizes[0] == sizes[1]


def test_chat_lengths_are_lognormal_with_the_sourced_mean():
    """Median 98 words at sigma 1 gives a mean of 161 words, 214.5 tokens
    at the assumed 0.75 words a token (the mix's source and assumptions)."""
    m = mix("stage3_chat")
    assert m["source"] and m["assumed"]
    grid = G.quantile_grid(m["sizes"], 4096)
    assert grid.min() >= 3 and grid.max() <= 4096
    assert statistics.median(grid.tolist()) == 98
    assert abs(grid.mean() / 0.75 - 214.5) < 2
    # sigma 1: the quartiles sit at 98 e^(±0.674)
    q1, _, q3 = statistics.quantiles(grid.tolist(), n=4)
    assert abs(q1 - 98 * np.exp(-0.6745)) <= 1
    assert abs(q3 - 98 * np.exp(0.6745)) <= 1
    texts = G.generate(small("stage3_chat", 64), 5)
    grid64 = G.quantile_grid(mix("stage3_chat")["sizes"], 64)
    assert sorted(len(t.split()) for t in texts) == sorted(grid64.tolist())


def test_words_read_as_their_sizes():
    got = sorted(T.real_tokens(t, 1 << 20)
                 for t in G.generate(small("words", 8), 3))
    assert got == sorted(G.quantile_grid(WORDS["sizes"], 8).tolist())


def test_text_of_reads_as_its_token_count():
    rng = np.random.default_rng(0)
    for n in (2, 3, 64, 1000):
        assert T.real_tokens(G.text_of(n, rng), 1 << 20) == n


def test_bulk_call_sizes_log_uniform():
    assert mix("bulk_triage")["source"] and mix("bulk_triage")["assumed"]
    grid = G.quantile_grid(mix("bulk_triage")["sizes"], 16)
    assert grid.min() >= 1000 and grid.max() <= 16000
    logs = np.log(grid)
    # evenly spaced in log: constant ratio between neighbours
    ratios = np.diff(logs)
    assert np.allclose(ratios, ratios.mean(), atol=2e-3)
    calls = G.generate({**mix("bulk_triage"), "pool": 2,
                        "sizes": {"loguniform": [30, 60]}}, 11)
    findings = [f for c in calls for f in c]
    assert all(f.signal == "tool_failure" for f in findings)
    with_exit = sum(bool(f.evidence) for f in findings)
    assert 0 < with_exit < len(findings)


def test_negative_and_huge_seeds():
    m = small("stage3_chat", 8)
    assert G.generate(m, -1) == G.generate(m, 2**64 - 1)
    assert len(G.generate(m, 2**70)) == 8
