"""``chip_smoke.py``'s knowledge_slo phase, its legs run here on the CPU at
a small size (a fact cap of 96 in place of 2000, 60 more ops, 8 queries):
the knowledge run twice on the CPU held together by the phase's own
check, and ``run_slo_report``'s legs at 300 ops with the sim report at
the phase's size. The CPU's plain attention counts no launches, so K1's
count is held through its formula here and counted on the card. Controls,
each of which must fail the check: a dropped fact, a changed fact file,
a dropped event, a changed sync count, a changed /knowledge fact line, a
swapped search order, a hit the CPU scores far below its own, a K1 count
off by one; a lost denial and a sim report that differs."""

from __future__ import annotations

import copy

import pytest

# the bounds module puts the repository root on the path for chip_smoke
from test_torch_chip_smoke_bounds import one_torch_thread  # noqa: F401

import chip_smoke  # noqa: E402
from vainplex_openclaw_tpu_torch.knowledge import plugin as knowledge_plugin
from vainplex_openclaw_tpu_torch.models.pretrained import TINY_CONFIG

SMALL = {"more_ops": 60, "n_queries": 8, "n_thread": 4}
CAP = 96


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The small knowledge run twice on the CPU, as the phase's card and
    host runs."""
    root = tmp_path_factory.mktemp("knowledge")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OPENCLAW_HOME", str(root / "home"))
        mp.setitem(knowledge_plugin.DEFAULTS["storage"], "maxFacts", CAP)
        import torch

        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            card = chip_smoke.knowledge_run("cpu", str(root / "card"),
                                            **SMALL)
            host = chip_smoke.knowledge_run("cpu", str(root / "host"),
                                            **SMALL)
        finally:
            torch.set_num_threads(threads)
    return card, host


def test_the_knowledge_runs_hold(runs):
    card, host = runs
    held = chip_smoke.knowledge_check(card, host, TINY_CONFIG.n_layers)
    assert held["ids_in_order"] == held["queries"] == SMALL["n_queries"]
    assert card["facts_at_cap"] == card["cap"] == CAP
    assert card["pruned_after_sync"] > 0 and sum(card["removed"]) > 0
    assert [s["facts"] for s in card["syncs"]][0] == CAP
    assert card["sync_forwards"] == 2 and card["query_forwards"] > 0
    assert card["launches"] is None and card["events"]
    assert card["stage_counts"]["sync"] == 2
    assert card["stage_counts"]["decay"] == 1
    assert "knowledge-queries" in {s["thread"] for s in card["searches"]}
    counted = dict(card, launches={"k1": TINY_CONFIG.n_layers * len(
        card["forwards"])})
    chip_smoke.knowledge_check(counted, host, TINY_CONFIG.n_layers)


def _sequential(run):
    return [s for s in run["searches"] if s["thread"] != "knowledge-queries"]


def _drop_fact(card, host):
    card["facts"].pop(3)


def _change_file(card, host):
    name = sorted(card["files"])[0]
    card["files"][name] += b" "


def _drop_event(card, host):
    card["events"].pop(7)


def _change_sync(card, host):
    card["syncs"][1]["facts"] += 1


def _change_fact_line(card, host):
    head, sep, rest = card["texts"][0].partition("\n")
    card["texts"][0] = head + sep + "  conversation mentioned x (rel=1.00)\n" \
        + rest


def _swap_order(card, host):
    """The two hits of the query whose CPU scores lie furthest apart."""
    ref = _sequential(host)
    gap, i = max((h["hits"][0][1] - h["hits"][1][1], i)
                 for i, h in enumerate(ref))
    assert gap > chip_smoke.KNOWLEDGE_SCORE_TOL
    hits = _sequential(card)[i]["hits"]
    hits[0], hits[1] = hits[1], hits[0]


def _far_hit(card, host):
    """A fact the CPU scores last, as the first query's first hit."""
    want = _sequential(host)[0]
    worst = min(want["scores"], key=want["scores"].get)
    _sequential(card)[0]["hits"][0] = [worst, want["scores"][worst]]


def _k1_off_by_one(card, host):
    card["launches"] = {"k1": TINY_CONFIG.n_layers * len(card["forwards"])
                        + 1}


CONTROLS = {"dropped fact": (_drop_fact, "facts differ"),
            "fact file": (_change_file, "fact files"),
            "dropped event": (_drop_event, "events"),
            "sync count": (_change_sync, "syncs"),
            "fact line": (_change_fact_line, "fact lines"),
            "swapped order": (_swap_order, "searches differ"),
            "far hit": (_far_hit, "searches differ"),
            "K1 off by one": (_k1_off_by_one, "K1 launches")}


@pytest.mark.parametrize("control", sorted(CONTROLS))
def test_a_control_fails_the_check(runs, control):
    card, host = copy.deepcopy(runs[0]), runs[1]
    spoil, message = CONTROLS[control]
    spoil(card, host)
    with pytest.raises(chip_smoke.SmokeFailure, match=message):
        chip_smoke.knowledge_check(card, host, TINY_CONFIG.n_layers)


SLO_SMALL = {**chip_smoke.SLO_BENCH, "n_ops": 300}


def test_slo_legs_on_the_cpu(openclaw_home, one_torch_thread):
    out = chip_smoke.slo_legs("cpu", bench=SLO_SMALL)
    assert set(out) == {"saturation_1", "saturation_2", "workers_2", "sim"}
    for name, _ in chip_smoke.SLO_LEGS:
        v = out[name]["verdicts"]
        assert v["losses"] == v["false_blocks"] == 0
        assert out[name]["e2e"]["count"] == SLO_SMALL["n_ops"]
    assert out["saturation_2"]["shed"] > 0
    assert out["sim"]["equal_cpu"] and out["sim"]["shed"] > 0


def test_a_lost_denial_fails_the_slo_legs(openclaw_home, monkeypatch,
                                          one_torch_thread):
    from vainplex_openclaw_tpu_torch.slo import harness

    denied = harness._denied
    lost = []

    def lose_the_first(obs, op):
        if op.kind == "tool_denied" and not lost:
            lost.append(op.index)
            return 0
        return denied(obs, op)

    monkeypatch.setattr(harness, "_denied", lose_the_first)
    with pytest.raises(chip_smoke.SmokeFailure, match="verdicts lost"):
        chip_smoke.slo_legs("cpu", bench=SLO_SMALL,
                            legs=chip_smoke.SLO_LEGS[:1])


def test_a_differing_sim_report_fails_the_slo_legs(openclaw_home,
                                                   monkeypatch,
                                                   one_torch_thread):
    """The first sim report (the card's, in the phase) with its throughput
    moved by 0.1 ops/s."""
    from vainplex_openclaw_tpu_torch import slo

    real = slo.run_slo_report
    calls = []

    def report(**kw):
        out = real(**kw)
        calls.append(kw)
        if len(calls) == 1:
            out["throughput_ops_s"] += 0.1
        return out

    monkeypatch.setattr(slo, "run_slo_report", report)
    with pytest.raises(chip_smoke.SmokeFailure, match="sim report"):
        chip_smoke.slo_legs("cpu", legs=())


def test_knowledge_queries_and_sync_cases():
    qs = chip_smoke.knowledge_queries(32, chip_smoke.KNOWLEDGE_QUERY_SEED)
    assert qs == chip_smoke.knowledge_queries(
        32, chip_smoke.KNOWLEDGE_QUERY_SEED)
    assert sum(q.startswith("item ") for q in qs) == 16
    assert len(set(qs)) > 24
    # the phase's syncs (2000 facts, then 214) launch at these buckets
    for n, case in zip((2000, 214), chip_smoke.KNOWLEDGE_SYNC_CASES):
        shape = chip_smoke.trace_k1_shape(TINY_CONFIG, n)
        assert tuple(shape) == (case[1], case[2], case[3], case[5])
        assert case in chip_smoke.KERNEL_CASES
    assert chip_smoke.trace_k1_unheld(
        [chip_smoke.trace_k1_shape(TINY_CONFIG, 1)]) == []
