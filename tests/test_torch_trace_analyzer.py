"""The port's trace analyzer against the JAX package's, on the CPU.

Every comparison is exact: the pipeline is integer and set arithmetic, the
similarity programs are bit-identical (``test_torch_similarity.py``), and
local triage's decisions are argmaxes on the shipped checkpoint.

- ``normalize_event``, ``detect_schema``, ``map_event_type`` and
  ``reconstruct_chains`` on both schemas;
- ``detect_all_signals`` on a corpus that hits every detector: a 40-retry
  ASCII doom loop (the batched Levenshtein path), windows of 32 and 31
  pairs on either side of ``BATCH_SIMILARITY_MIN``, a window with
  non-ASCII commands and one of empty commands (Jaccard); with and
  without per-signal overrides;
- the clusterer, batch and incremental, with the state file byte-equal
  and read across packages;
- ``TraceAnalyzer.run`` twice on one state dir with a fixed clock and
  local triage on the shipped checkpoint: the report (less its timing
  fields), the cluster state and the processing state equal JAX's;
- the deviations: the ``useLocalTriage`` auto rule, and the cluster and
  detector catches that let a device error through;
- ``/trace-analyze`` through a real ``Gateway`` answered by the port while
  the JAX package's similarity programs and ``local_triage`` raise;
- the copies of the atomic writer, the plugin dataclasses, the sources and
  the language packs; and every device entry point raising without a card.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re

import numpy as np
import pytest
import torch

from helpers import make_gateway
from test_torch_classify_findings import deep_with_fact
from trace_helpers import EventFactory
from vainplex_openclaw_tpu.core import api as jax_api
from vainplex_openclaw_tpu.core.api import list_logger
from vainplex_openclaw_tpu.cortex import CortexPlugin
from vainplex_openclaw_tpu.cortex import trace_analyzer as jta
from vainplex_openclaw_tpu.cortex.trace_analyzer import analyzer as jax_an
from vainplex_openclaw_tpu.cortex.trace_analyzer import chains as jax_chains
from vainplex_openclaw_tpu.cortex.trace_analyzer import \
    classifier as jax_cls
from vainplex_openclaw_tpu.cortex.trace_analyzer import clusters as jax_cl
from vainplex_openclaw_tpu.cortex.trace_analyzer import events as jax_ev
from vainplex_openclaw_tpu.cortex.trace_analyzer import outputs as jax_out
from vainplex_openclaw_tpu.cortex.trace_analyzer import report as jax_rep
from vainplex_openclaw_tpu.cortex.trace_analyzer import \
    signal_patterns as jax_pat
from vainplex_openclaw_tpu.cortex.trace_analyzer import signals as jax_sig
from vainplex_openclaw_tpu.models import pretrained as jax_pretrained
from vainplex_openclaw_tpu.ops import similarity as jax_sim
from vainplex_openclaw_tpu.storage import atomic as jax_atomic
from vainplex_openclaw_tpu_torch import device as port_device
from vainplex_openclaw_tpu_torch.core import api as port_api
from vainplex_openclaw_tpu_torch.cortex import trace_analyzer as pta
from vainplex_openclaw_tpu_torch.cortex.trace_analyzer import \
    analyzer as port_an
from vainplex_openclaw_tpu_torch.cortex.trace_analyzer import \
    chains as port_chains
from vainplex_openclaw_tpu_torch.cortex.trace_analyzer import \
    classifier as port_cls
from vainplex_openclaw_tpu_torch.cortex.trace_analyzer import \
    clusters as port_cl
from vainplex_openclaw_tpu_torch.cortex.trace_analyzer import \
    events as port_ev
from vainplex_openclaw_tpu_torch.cortex.trace_analyzer import \
    outputs as port_out
from vainplex_openclaw_tpu_torch.cortex.trace_analyzer import \
    report as port_rep
from vainplex_openclaw_tpu_torch.cortex.trace_analyzer import \
    signal_patterns as port_pat
from vainplex_openclaw_tpu_torch.cortex.trace_analyzer import \
    signals as port_sig
from vainplex_openclaw_tpu_torch.models import pretrained as port_pretrained
from vainplex_openclaw_tpu_torch.ops import similarity as port_sim
from vainplex_openclaw_tpu_torch.storage import atomic as port_atomic

CLOCK = 1_700_100_000.0
TIMING_KEYS = ("durationMs", "eventsPerMinute", "stageMs")
CONFIG = {"classify": {"enabled": True, "useLocalTriage": True},
          "cluster": {"incremental": True}}
HOSTS = ("alpha", "bravo", "charlie", "delta", "echo", "foxtrot", "golf",
         "hotel")
ASCII_WORDS = ("git", "push", "--force", "origin", "main", "npm", "run",
               "build", "kubectl", "apply", "-f", "deploy.yaml", "docker",
               "compose", "up", "-d", "pytest", "-q", "tests/", "&&")
NO_CARD = pytest.mark.skipif(torch.cuda.is_available(),
                             reason="a CUDA device is present")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain Levenshtein DP runs thousands of small tensor ops, which
    stall on a thread pool when test workers share the cores: one thread
    keeps this file's time its own."""
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


# ── corpora ─────────────────────────────────────────────────────────


def unsequenced(raws: list) -> list:
    """Drop each factory's own ``seq``: a memory source then numbers the
    events by their place in the list, so a second run over a longer list
    reads only the new ones."""
    return [{k: v for k, v in r.items() if k != "seq"} for r in raws]


def command(rng, n_words: int) -> str:
    return " ".join(ASCII_WORDS[i] for i in rng.integers(
        0, len(ASCII_WORDS), size=n_words))


def retries(rng, n: int) -> list:
    """``n`` commands, each a retry of the one before: one word changed,
    or every fifth time three quarters of them (a pair below 0.8)."""
    out = [command(rng, 12)]
    for k in range(1, n):
        words = out[-1].split(" ")
        for i in rng.choice(len(words), size=9 if k % 5 == 0 else 1,
                            replace=False):
            words[i] = ASCII_WORDS[int(rng.integers(len(ASCII_WORDS)))]
        out.append(" ".join(words))
    return out


def failing_window(f: EventFactory, commands: list, tool: str = "exec",
                   error: str = "exit status 1: build broke") -> list:
    raws = []
    for c in commands:
        params = c if isinstance(c, dict) else {"command": c}
        raws += f.failing_call(tool, params, error)
    return raws


def detector_corpus(seed: int = 0, start: int = 0,
                    ts: float = 1_700_000_000_000.0) -> list:
    """Raw events that hit every detector, both schemas, and every route
    of the consecutive-similarity windows."""
    rng = np.random.default_rng(seed)
    raws = []
    host = HOSTS[seed % len(HOSTS)]

    def factory(name: str) -> EventFactory:
        return EventFactory(agent=f"agent{len(raws) % 3}",
                            session=f"{name}{start}", start_ts=ts)

    f = factory("loop")                    # 39 pairs: batched, bucket 64
    raws += [f.msg_in("deploy the release")]
    raws += failing_window(f, retries(rng, 40),
                           error=f"exit status 1: build broke on {host}")
    raws += [f.msg_out("I've successfully deployed the release.")]
    f = factory("edge32")                  # 32 pairs: batched, bucket 32
    raws += failing_window(f, retries(rng, 33),
                           error=f"exit 2 on step 7 of {host}")
    f = factory("edge31")                  # 31 pairs: the scalar DP
    raws += failing_window(f, retries(rng, 32), error="exit 2 on step 7")
    f = factory("nonascii")                # 35 ASCII pairs, 4 scalar
    cmds = retries(rng, 40)
    cmds[10] = cmds[10] + " # überprüfen"
    cmds[25] = "echo 'déploiement échoué' " + cmds[25]
    raws += failing_window(f, cmds,
                           error=f"permission denied: /srv/{host}/app")
    f = factory("jaccard")                 # empty commands: Jaccard
    raws += failing_window(f, [
        {"command": "", "cwd": "/srv/app" if k % 7 else "/srv/other",
         "timeout": k, "env": {"A": [1, 2]}} for k in range(34)])
    f = factory("talk")                    # correction, dissatisfied
    raws += [f.msg_in("what is the status?"),
             f.msg_out("the deploy is done and verified"),
             f.msg_in("no, that's wrong — it is still failing"),
             f.msg_out("is it the api?"), f.msg_in("no"),
             f.msg_out("checking"),
             f.msg_in("this is useless, still broken")]
    f = factory("claim")                   # unverified completion claim
    raws += [f.msg_in("update the docs"),
             f.msg_out("I have updated the documentation, it is done")]
    for k in range(3):                     # a failure across chains
        f = factory(f"repeat{k}-")
        raws += [f.msg_in("run the tests")]
        raws += f.failing_call("exec", {"command": "pytest -q"},
                               f"error: 3 tests failed in {k + 1}.2s")
        raws += [f.msg_out("tests completed")]
    raws += [{"id": f"b{start}-{i}", "type": t, "timestamp": ts + 1000 * i,
              "sessionKey": f"agent:main:{start}-uuid", "data": d,
              "meta": {"source": "session-sync", "agent": "main"}}
             for i, (t, d) in enumerate((
                 ("conversation.message.in", {"text": "please restart"}),
                 ("conversation.tool_call", {"tool": "exec", "arguments": {
                     "command": "systemctl restart api"}}),
                 ("conversation.tool_result", {"tool": "exec",
                                               "error": "unit not found"}),
                 ("conversation.message.out",
                  {"text": "The service is now ready"})))]
    return unsequenced(raws)


def both_chains(raws: list) -> tuple:
    port = port_chains.reconstruct_chains(
        port_ev.normalize_event(r, i + 1) for i, r in enumerate(raws))
    jax = jax_chains.reconstruct_chains(
        jax_ev.normalize_event(r, i + 1) for i, r in enumerate(raws))
    return port, jax


def chain_view(c) -> tuple:
    return (c.id, c.agent, c.session, c.start_ts, c.end_ts, c.type_counts,
            c.boundary_type, [dataclasses.astuple(e) for e in c.events])


# ── events and chains ───────────────────────────────────────────────

RAW_EVENTS = [
    {"type": "msg.in", "ts": 5, "agent": "a", "session": "s",
     "payload": {"content": "hi", "from": "u"}},
    {"type": "msg.out", "ts": 6, "payload": {}},
    {"type": "tool.call", "ts": 7, "payload": {"toolName": "exec",
                                               "params": {"command": "ls"}}},
    {"type": "tool.result", "ts": 8, "seq": 9,
     "payload": {"tool_name": "exec", "tool_error": "boom"}},
    {"type": "run.error", "ts": 9, "payload": {"error": "x",
                                               "duration_ms": 3}},
    {"type": "session.start", "ts": 1},
    {"type": "msg.sending", "ts": 2},
    {"type": "conversation.message.in", "timestamp": 10,
     "sessionKey": "agent:main:uuid-1", "data": {"content": "hey"}},
    {"type": "conversation.tool_result", "timestamp": 11, "agent": "b",
     "payload": {"name": "read", "is_error": True, "result": "r"}},
    {"type": "msg.in", "timestamp": 12, "meta": {"source": "session-sync",
                                                 "agent": "m"}},
    {"type": "tool.call", "timestamp": 13, "data": {"tool": "read"}},
    {"type": "unknown.type", "ts": 1},
    {"type": 3},
    {"ts": 4},
]


@pytest.mark.parametrize("i", range(len(RAW_EVENTS)))
def test_normalize_event_equals_jax(i):
    raw = RAW_EVENTS[i]
    assert port_ev.detect_schema(raw) == jax_ev.detect_schema(raw)
    got, want = port_ev.normalize_event(raw, 4), jax_ev.normalize_event(raw, 4)
    assert (got is None) == (want is None)
    if got is not None:
        assert dataclasses.astuple(got) == dataclasses.astuple(want)


def test_event_type_map_equals_jax():
    for raw in ("msg.in", "conversation.tool_call", "msg.sending", "x", ""):
        assert port_ev.map_event_type(raw) == jax_ev.map_event_type(raw)
    assert port_ev.ANALYZER_EVENT_TYPES == jax_ev.ANALYZER_EVENT_TYPES
    assert port_ev.normalize_session("agent:main:u1") == "u1"


def test_reconstruct_chains_equals_jax_on_both_schemas():
    f = EventFactory(session="s1")
    raws = [f.session_start(), f.msg_in("a"), f.msg_out("b"), f.session_end(),
            f.msg_in("c"), f.msg_out("d")]
    f.gap(31)
    raws += [f.msg_in("e"), f.msg_out("f"), f.msg_in("single")]
    g = EventFactory(session="s2", start_ts=f.ts)
    raws += [g.msg_in(f"m{k}") for k in range(5)]
    # a cross-schema duplicate of s1's "a", dropped; a same-schema repeat kept
    raws += [{"type": "conversation.message.in", "timestamp": raws[1]["ts"],
              "session": "s1", "agent": "main", "data": {"text": "a"}},
             dict(raws[2], id="dup")]
    raws += detector_corpus(seed=3)
    port, jax = both_chains(unsequenced(raws))
    assert [chain_view(c) for c in port] == [chain_view(c) for c in jax]
    assert {c.boundary_type for c in port} >= {"lifecycle", "gap"}
    capped_port = port_chains.reconstruct_chains(
        (port_ev.normalize_event(r) for r in raws), max_events_per_chain=3)
    capped_jax = jax_chains.reconstruct_chains(
        (jax_ev.normalize_event(r) for r in raws), max_events_per_chain=3)
    assert [chain_view(c) for c in capped_port] == \
        [chain_view(c) for c in capped_jax]
    assert "memory_cap" in {c.boundary_type for c in capped_port}


def test_signal_packs_equal_jax():
    assert {k: dataclasses.asdict(p) for k, p in port_pat.SIGNAL_PACKS.items()} \
        == {k: dataclasses.asdict(p) for k, p in jax_pat.SIGNAL_PACKS.items()}
    got = port_pat.compile_signal_patterns(["en", "de", "xx"])
    want = jax_pat.compile_signal_patterns(["en", "de", "xx"])
    for attr in ("correction", "short_negatives", "dissatisfaction",
                 "satisfaction_overrides", "resolution", "completion_claims"):
        assert [(p.pattern, p.flags) for p in getattr(got, attr)] == \
            [(p.pattern, p.flags) for p in getattr(want, attr)]


# ── detectors ───────────────────────────────────────────────────────


def spy_k3(monkeypatch) -> list:
    """The ``[N, L]`` shape of each batched Levenshtein call of the port
    (the K3 launches a card would make)."""
    seen, real = [], port_sim.levenshtein_rows

    def spy(A, *rest):
        seen.append(tuple(A.shape))
        return real(A, *rest)

    monkeypatch.setattr(port_sim, "levenshtein_rows", spy)
    return seen


@pytest.mark.parametrize("config", [
    None, {"SIG-TOOL-FAIL": {"enabled": False},
           "SIG-DOOM-LOOP": {"severity": "low"},
           "SIG-CORRECTION": {"severity": "critical"}}])
def test_detect_all_signals_equals_jax(config, monkeypatch):
    raws = detector_corpus()
    port, jax = both_chains(raws)
    shapes = spy_k3(monkeypatch)
    got = port_sig.detect_all_signals(
        port, port_pat.compile_signal_patterns(["en", "de"]), config,
        list_logger(), device="cpu")
    want = jax_sig.detect_all_signals(
        jax, jax_pat.compile_signal_patterns(["en", "de"]), config,
        list_logger())
    assert [s.to_dict() for s in got] == [s.to_dict() for s in want]
    assert {s.signal for s in got} >= (
        {"SIG-CORRECTION", "SIG-DISSATISFIED", "SIG-HALLUCINATION",
         "SIG-UNVERIFIED-CLAIM", "SIG-DOOM-LOOP", "SIG-REPEAT-FAIL"}
        | ({"SIG-TOOL-FAIL"} if config is None else set()))
    # loop (39 pairs), edge32 (32) and the non-ASCII window's 35 ASCII pairs
    # take the batched path; edge31, the Jaccard window and the short
    # windows do not
    assert sorted(shapes) == [(32, 512), (64, 512), (64, 512)]
    # every window's similarities equal JAX's, pair for pair
    for pc, jc in zip(port, jax):
        assert pc._pair_sims == jc._pair_sims
    sims = {c.session: c._pair_sims for c in port if c._pair_sims}
    for name in ("loop0", "edge320", "edge310", "nonascii0"):
        assert min(sims[name]) < 0.8 <= max(sims[name]), name


def test_detector_fault_is_logged_and_device_error_propagates(monkeypatch):
    """A detector's own fault costs its signals, logged as JAX logs it; an
    error from the device propagates (the narrowed catch)."""
    raws = detector_corpus()
    port, jax = both_chains(raws)

    def bug(*_a, **_k):
        raise ValueError("detector bug")

    monkeypatch.setitem(port_sig.DETECTOR_REGISTRY, "SIG-DOOM-LOOP", bug)
    monkeypatch.setitem(jax_sig.DETECTOR_REGISTRY, "SIG-DOOM-LOOP", bug)
    plog, jlog = list_logger(), list_logger()
    got = port_sig.detect_all_signals(
        port, port_pat.compile_signal_patterns(["en"]), None, plog,
        device="cpu")
    want = jax_sig.detect_all_signals(
        jax, jax_pat.compile_signal_patterns(["en"]), None, jlog)
    assert [s.to_dict() for s in got] == [s.to_dict() for s in want]
    assert plog.records == jlog.records and plog.messages("error")

    def launch_failed(*_a, **_k):
        raise port_device.DeviceError("levenshtein kernel launch failed")

    monkeypatch.setattr(port_sig, "batch_levenshtein_ratio", launch_failed)
    fresh, _ = both_chains(raws)
    with pytest.raises(port_device.DeviceError):
        port_sig.detect_all_signals(
            fresh, port_pat.compile_signal_patterns(["en"]), None,
            list_logger(), device="cpu")


@pytest.mark.parametrize("exc,device_error", [
    (port_device.DeviceError("no card"), True),
    (torch.OutOfMemoryError("CUDA out of memory"), True),
    (RuntimeError("CUDA error: an illegal memory access"), True),
    (RuntimeError("CUBLAS_STATUS_EXECUTION_FAILED"), True),
    (RuntimeError("cluster bug"), False),
    (ValueError("CUDA in a value error"), False),
    (KeyError("x"), False)])
def test_is_device_error(exc, device_error):
    assert port_device.is_device_error(exc) is device_error


# ── outputs and report ──────────────────────────────────────────────


def test_outputs_and_summary_equal_jax():
    raws = detector_corpus()
    port, jax = both_chains(raws)
    pf = port_sig.detect_all_signals(
        port, port_pat.compile_signal_patterns(["en"]), device="cpu")
    jf = jax_sig.detect_all_signals(jax, jax_pat.compile_signal_patterns(
        ["en"]))
    pc = port_cls.classify_findings(pf, {c.id: c for c in port},
                                    deep_llm=deep_with_fact)
    jc = jax_cls.classify_findings(jf, {c.id: c for c in jax},
                                   deep_llm=deep_with_fact)
    got = [o.to_dict() for o in port_out.generate_outputs(pc)]
    want = [o.to_dict() for o in jax_out.generate_outputs(jc)]
    assert got == want and got
    assert port_out.normalize_action_text(" A  b. ") == "a b"
    state_p, state_j = port_rep.ProcessingState(), jax_rep.ProcessingState()
    for counts in ({"SIG-A": 3}, {"SIG-A": 1, "SIG-B": 2}):
        assert port_rep.rule_effectiveness(state_p, counts) == \
            jax_rep.rule_effectiveness(state_j, counts)
    report = port_rep.assemble_report({"events": 1}, pf, pc, [], [],
                                      lambda: CLOCK)
    assert report == jax_rep.assemble_report({"events": 1}, jf, jc, [], [],
                                             lambda: CLOCK)
    report["runStats"] = {"events": 9, "chains": 2, "signals": 3,
                          "durationMs": 1.5, "eventsPerMinute": 2.0,
                          "stageMs": {"signals": 1.0}}
    report["failureClusters"] = [{"size": 2, "chains": ["a", "b"],
                                  "tools": ["exec"], "sample": "x" * 90}]
    report["outputs"] = want
    assert port_an._summary_text(report) == jax_an._summary_text(report)


def test_processing_state_round_trips_across_packages(tmp_path):
    for text in (None, "[1, 2]", "{not json", json.dumps({
            "lastProcessedTs": 5.5, "lastProcessedSeq": 7,
            "totalEventsProcessed": 9, "totalRuns": 2,
            "ruleSignalCounts": {"SIG-A": 1}})):
        path = tmp_path / port_rep.STATE_FILE
        if text is None:
            path.unlink(missing_ok=True)
        else:
            path.write_text(text)
        got = port_rep.ProcessingState.load(tmp_path)
        want = jax_rep.ProcessingState.load(tmp_path)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    got.save(tmp_path / "p")
    want.save(tmp_path / "j")
    assert (tmp_path / "p" / port_rep.STATE_FILE).read_bytes() == \
        (tmp_path / "j" / jax_rep.STATE_FILE).read_bytes()


# ── clusters ────────────────────────────────────────────────────────


def corpus_signals(seed: int, start: int = 0, ts: float = 1.7e12) -> tuple:
    raws = detector_corpus(seed, start, ts)
    port, jax = both_chains(raws)
    return (port_sig.detect_all_signals(
        port, port_pat.compile_signal_patterns(["en"]), device="cpu"),
        jax_sig.detect_all_signals(jax, jax_pat.compile_signal_patterns(
            ["en"])))


@pytest.mark.parametrize("max_signals", [512, 6])
def test_cluster_failure_signals_equals_jax(max_signals):
    ps, js = corpus_signals(1)
    ps2, js2 = corpus_signals(2, start=1)
    plog, jlog = list_logger(), list_logger()
    pstats, jstats = {}, {}
    got = port_cl.cluster_failure_signals(
        ps + ps2, max_signals=max_signals, logger=plog, stats=pstats,
        device="cpu")
    want = jax_cl.cluster_failure_signals(
        js + js2, max_signals=max_signals, logger=jlog, stats=jstats)
    assert json.dumps(got) == json.dumps(want) and got
    assert pstats == jstats and plog.records == jlog.records
    assert port_cl.signal_features(ps[0]) == jax_cl.signal_features(js[0])


MAX_KEPT = 20  # the kept window fills on the third update


def test_incremental_clusterer_state_equals_jax_and_reads_across(tmp_path):
    """Three updates (the kept window growing, then capped), the state file
    byte-equal after each; a state JAX wrote is read by the port and the
    next update equals JAX's."""
    runs = [corpus_signals(k, start=k, ts=1.7e12 + k * 86_400_000)
            for k in range(4)]
    pdir, jdir = tmp_path / "p", tmp_path / "j"
    for k, (ps, js) in enumerate(runs[:3]):
        pstats, jstats = {}, {}
        got = port_cl.IncrementalClusterer(pdir, max_signals=MAX_KEPT,
                                           device="cpu").update(ps, pstats)
        want = jax_cl.IncrementalClusterer(jdir, max_signals=MAX_KEPT).update(
            js, jstats)
        assert json.dumps(got) == json.dumps(want) and got, k
        assert pstats == jstats
        assert (pdir / port_cl.CLUSTER_STATE_FILE).read_bytes() == \
            (jdir / jax_cl.CLUSTER_STATE_FILE).read_bytes(), k
    assert pstats["truncated"] > 0
    ps, js = runs[3]
    got = port_cl.IncrementalClusterer(jdir, max_signals=MAX_KEPT,
                                       device="cpu").update(ps, save=False)
    want = jax_cl.IncrementalClusterer(jdir, max_signals=MAX_KEPT).update(js)
    assert json.dumps(got) == json.dumps(want)
    assert json.dumps(port_cl.IncrementalClusterer(
        jdir, max_signals=MAX_KEPT, device="cpu").clusters()) == \
        json.dumps(jax_cl.IncrementalClusterer(jdir, max_signals=MAX_KEPT).clusters())


def test_incremental_block_is_rectangular_and_equals_jax(tmp_path,
                                                         monkeypatch):
    """A second update computes a new-rows × all-rows block: its shape and
    bits equal JAX's."""
    ps1, js1 = corpus_signals(5)
    ps2, js2 = corpus_signals(6, start=1, ts=1.8e12)
    pblocks, jblocks = [], []

    def spy(blocks, real, **kw):
        def f(Xa, Xb=None, **k):
            out = real(Xa, Xb, **k)
            blocks.append(out)
            return out
        return f

    monkeypatch.setattr(port_cl, "jaccard_from_rows",
                        spy(pblocks, port_cl.jaccard_from_rows))
    monkeypatch.setattr(jax_cl, "jaccard_from_rows",
                        spy(jblocks, jax_cl.jaccard_from_rows))
    for ps, js in ((ps1, js1), (ps2, js2)):
        port_cl.IncrementalClusterer(tmp_path / "p",
                                     device="cpu").update(ps)
        jax_cl.IncrementalClusterer(tmp_path / "j").update(js)
    assert len(pblocks) == len(jblocks)
    for p, j in zip(pblocks, jblocks):
        assert p.dtype == np.float32 and p.shape == j.shape
        assert np.array_equal(p.view(np.int32), j.view(np.int32))
    assert any(0 < b.shape[0] < b.shape[1] for b in pblocks)


# ── the analyzer ────────────────────────────────────────────────────


def log_view(records: list) -> list:
    """Log records less the run's events per minute."""
    return [(lv, re.sub(r"\(\d+ ev/min\)", "", m)) for lv, m in records]


def two_runs(tmp_path, analyzer_cls, source_cls, label, **kw) -> list:
    """Two runs on one state dir: the corpus, then it with new chains a
    day later. Returns per run (report less timing, cluster-state bytes,
    processing-state bytes, log records)."""
    first = detector_corpus(seed=7)
    new = detector_corpus(seed=8, start=1, ts=1_700_086_400_000.0)
    out = []
    for raws in (first, first + new):
        log = list_logger()
        rep = analyzer_cls(CONFIG, tmp_path / label, log,
                           source=source_cls(raws), clock=lambda: CLOCK,
                           **kw).run()
        disk = json.loads((tmp_path / label / jax_rep.REPORT_FILE)
                          .read_text())
        for r in (rep, disk):
            for key in TIMING_KEYS:
                r["runStats"].pop(key)
        assert rep == disk
        out.append((json.dumps(disk),
                    (tmp_path / label / jax_cl.CLUSTER_STATE_FILE)
                    .read_bytes(),
                    (tmp_path / label / jax_rep.STATE_FILE).read_bytes(),
                    log_view(log.records)))
    return out


def test_trace_analyzer_two_incremental_runs_equal_jax(tmp_path, monkeypatch):
    shapes = spy_k3(monkeypatch)
    triaged = []
    real_triage = port_cls.local_triage

    def spy(findings, *a, **k):
        triaged.append(len(findings))
        return real_triage(findings, *a, **k)

    monkeypatch.setattr(port_cls, "local_triage", spy)
    got = two_runs(tmp_path, pta.TraceAnalyzer, pta.MemoryTraceSource,
                   "port", device="cpu")
    want = two_runs(tmp_path, jta.TraceAnalyzer, jta.MemoryTraceSource,
                    "jax")
    for k, (g, w) in enumerate(zip(got, want)):
        assert g[0] == w[0], f"report of run {k + 1}"
        assert g[1] == w[1], f"cluster state of run {k + 1}"
        assert g[2] == w[2], f"processing state of run {k + 1}"
        assert g[3] == w[3]
    reports = [json.loads(g[0]) for g in got]
    assert [r["runStats"]["events"] for r in reports] == [
        len(detector_corpus(seed=7)), len(detector_corpus(seed=8, start=1))]
    assert all(r["failureClusters"] for r in reports)
    assert len(triaged) == 2 and all(triaged)  # local triage ran each run
    assert sorted(shapes) == [(32, 512), (32, 512), (64, 512), (64, 512),
                              (64, 512), (64, 512)]


def test_local_triage_auto_rule(tmp_path, monkeypatch):
    """``useLocalTriage: None``: on where the checkpoint is shipped (the
    port's only condition), off where it is not. JAX also asks
    ``backend_init_safe``: where that is false, JAX skips local triage and
    the port runs it."""
    calls = []
    real = port_cls.local_triage
    monkeypatch.setattr(port_cls, "local_triage",
                        lambda f, *a, **k: calls.append(len(f)) or real(
                            f, *a, **k))
    raws = detector_corpus(seed=9)[:40]
    cfg = {"classify": {"enabled": True, "useLocalTriage": None}}

    def port_run(label):
        return pta.TraceAnalyzer(cfg, tmp_path / label, list_logger(),
                                 source=pta.MemoryTraceSource(raws),
                                 clock=lambda: CLOCK, device="cpu").run()

    port_run("shipped")
    assert len(calls) == 1 and port_pretrained.available()
    monkeypatch.setattr(port_an, "available", lambda: False)
    port_run("absent")
    assert len(calls) == 1
    monkeypatch.setattr(port_an, "available", port_pretrained.available)
    import vainplex_openclaw_tpu.utils.jax_safety as jax_safety

    monkeypatch.setattr(jax_safety, "backend_init_safe", lambda: False)
    jlog = list_logger()
    jta.TraceAnalyzer(cfg, tmp_path / "jax", jlog,
                      source=jta.MemoryTraceSource(raws),
                      clock=lambda: CLOCK).run()
    assert any("local triage skipped" in m for m in jlog.messages("info"))
    port_run("unsafe")
    assert len(calls) == 2


@pytest.mark.parametrize("incremental", [True, False])
def test_cluster_stage_catches_a_clusterer_fault_like_jax(tmp_path,
                                                          monkeypatch,
                                                          incremental):
    def boom(*_a, **_k):
        raise RuntimeError("cluster bug")

    raws = unsequenced(failing_window(EventFactory(), ["x"] * 3, error="err"))
    cfg = {"cluster": {"incremental": incremental}}
    out = {}
    for label, mod, pkg, kw in (("port", port_an, pta, {"device": "cpu"}),
                                ("jax", jax_an, jta, {})):
        monkeypatch.setattr(mod, "cluster_failure_signals", boom)
        monkeypatch.setattr(mod.IncrementalClusterer, "update", boom)
        log = list_logger()
        rep = pkg.TraceAnalyzer(cfg, tmp_path / label, log,
                                source=pkg.MemoryTraceSource(raws),
                                clock=lambda: CLOCK, **kw).run()
        assert rep["failureClusters"] == [] and rep["runStats"]["signals"]
        assert (tmp_path / label / jax_rep.REPORT_FILE).exists()
        out[label] = log.messages("error")
    assert out["port"] == out["jax"] == ["failure clustering failed: "
                                         "cluster bug"]


@pytest.mark.parametrize("error", [
    port_device.DeviceError("kernel build failed"),
    torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2 GiB"),
    RuntimeError("CUDA error: device-side assert triggered")])
def test_cluster_stage_lets_a_device_error_through(tmp_path, monkeypatch,
                                                   error):
    """The narrowed catch: an error from the device's Jaccard block ends
    the run; JAX would log it and report no clusters."""
    def device_fault(*_a, **_k):
        raise error

    monkeypatch.setattr(port_cl, "jaccard_from_rows", device_fault)
    raws = detector_corpus(seed=4)
    analyzer = pta.TraceAnalyzer({}, tmp_path, list_logger(),
                                 source=pta.MemoryTraceSource(raws),
                                 clock=lambda: CLOCK, device="cpu")
    with pytest.raises(type(error)):
        analyzer.run()
    assert not (tmp_path / jax_rep.REPORT_FILE).exists()


def test_gateway_trace_analyze_is_served_by_the_port(tmp_path, workspace,
                                                     openclaw_home,
                                                     monkeypatch):
    """``Gateway.load`` returns the plugin API; the port's
    ``register_trace_analyzer`` puts ``/trace-analyze`` on it. The command
    answers with JAX's similarity programs and ``local_triage`` made to
    raise: the run never reaches the JAX package."""
    gw, _ = make_gateway()
    plugin = CortexPlugin(workspace=str(workspace), clock=gw.clock,
                          wall_timers=False)
    api = gw.load(plugin, plugin_config={"enabled": True,
                                         "traceAnalyzer": {"enabled": False}})
    gw.start()
    assert plugin.trace_analyzer is None and "trace-analyze" not in gw.commands

    def jax_reached(*_a, **_k):
        raise AssertionError("the JAX package was reached")

    for mod, name in ((jax_sim, "batch_levenshtein_ratio"),
                      (jax_sim, "jaccard_from_rows"),
                      (jax_sim, "levenshtein_ratio"),
                      (jax_cl, "jaccard_from_rows"),
                      (jax_cls, "local_triage"),
                      (jax_cls, "classify_findings")):
        monkeypatch.setattr(mod, name, jax_reached)
    raws = detector_corpus(seed=10)
    shapes = spy_k3(monkeypatch)
    analyzer = pta.TraceAnalyzer(CONFIG, tmp_path / "ta", api.logger,
                                 source=pta.MemoryTraceSource(raws),
                                 device="cpu")
    port_an.register_trace_analyzer(api, analyzer, wall_timers=False)
    assert isinstance(gw.commands["trace-analyze"], port_api.PluginCommand)
    text = gw.command("/trace-analyze")["text"]
    rep = json.loads((tmp_path / "ta" / jax_rep.REPORT_FILE).read_text())
    head = text.splitlines()[0]
    assert head.startswith("🔍 trace analysis:") and "failed" not in head
    assert f"{len(raws)} events" in text
    assert f"{rep['runStats']['signals']} signals" in text
    assert shapes and rep["failureClusters"]
    gw.stop()


def test_schedule_registers_a_port_service(tmp_path):
    class Api:
        logger = list_logger()
        commands, services = {}, {}

        def register_command(self, cmd):
            self.commands[cmd.name] = cmd

        def register_service(self, svc):
            self.services[svc.id] = svc

    api = Api()
    analyzer = pta.TraceAnalyzer({"scheduleMinutes": 5}, tmp_path,
                                 api.logger, device="cpu")
    port_an.register_trace_analyzer(api, analyzer)
    assert isinstance(api.services["trace-analyzer"], port_api.PluginService)
    api.services["trace-analyzer"].stop(None)
    # no source: the graceful empty report, as in JAX
    assert api.commands["trace-analyze"].handler({})["text"].startswith(
        "🔍 trace analysis: 0 events")
    assert port_an.DEFAULT_ANALYZER_CONFIG == jax_an.DEFAULT_ANALYZER_CONFIG


@NO_CARD
def test_device_entry_points_raise_without_a_card(tmp_path):
    with pytest.raises(port_device.DeviceError, match="device='cpu'"):
        pta.TraceAnalyzer({}, tmp_path, list_logger())
    with pytest.raises(port_device.DeviceError, match="device='cpu'"):
        pta.detect_all_signals([], port_pat.compile_signal_patterns(["en"]))
    with pytest.raises(port_device.DeviceError, match="device='cpu'"):
        pta.cluster_failure_signals([])
    with pytest.raises(port_device.DeviceError, match="device='cpu'"):
        pta.IncrementalClusterer(tmp_path)
    with pytest.raises(port_device.DeviceError, match="device='cpu'"):
        port_sim.jaccard_matrix([{"a": 1}])


# ── sources, storage and the plugin types ───────────────────────────


def test_sources_equal_jax():
    raws = detector_corpus(seed=11)[:30] + [{"type": "nope", "ts": 1}]
    for kw in ({}, {"start_seq": 5}, {"max_events": 7}):
        got = list(pta.MemoryTraceSource(raws).fetch(**kw))
        want = list(jta.MemoryTraceSource(raws).fetch(**kw))
        assert [dataclasses.astuple(e) for e in got] == \
            [dataclasses.astuple(e) for e in want]
    src = pta.MemoryTraceSource(raws)
    assert (src.last_sequence(), src.event_count()) == (31, 31)
    with pytest.raises(ConnectionError):
        pta.MemoryTraceSource([], fail_on_connect=True)
    from vainplex_openclaw_tpu.core import Gateway
    from vainplex_openclaw_tpu.events import EventStorePlugin, MemoryTransport

    gw = Gateway()
    store = EventStorePlugin(transport=MemoryTransport())
    gw.load(store, plugin_config={"enabled": True})
    gw.message_received("hello there", {"agent_id": "main",
                                        "session_key": "main"})
    for kw in ({}, {"max_events": 1}):
        got = list(pta.TransportTraceSource(store.transport).fetch(**kw))
        want = list(jta.TransportTraceSource(store.transport).fetch(**kw))
        assert [dataclasses.astuple(e) for e in got] == \
            [dataclasses.astuple(e) for e in want] and got
    port_t = pta.TransportTraceSource(store.transport)
    assert port_t.last_sequence() == store.transport.last_sequence()
    assert port_t.event_count() == store.transport.event_count()
    plog, jlog = list_logger(), list_logger()
    assert pta.create_nats_trace_source("nats://localhost:4222",
                                        logger=plog) is None
    assert jta.create_nats_trace_source("nats://localhost:4222",
                                        logger=jlog) is None
    assert plog.records == jlog.records


@pytest.mark.parametrize("indent", [2, None])
@pytest.mark.parametrize("durable", [False, True])
def test_atomic_json_writes_the_jax_bytes(tmp_path, indent, durable):
    obj = {"ts": 1.5, "f32": float(np.float32(0.1)), "text": "héllo ✓",
           "nested": {"a": [1, None, True]}, "path": tmp_path / "x",
           "set": {3}}
    port_atomic.write_json_atomic(tmp_path / "p" / "s.json", obj,
                                  indent=indent, durable=durable)
    jax_atomic.write_json_atomic(tmp_path / "j" / "s.json", obj,
                                 indent=indent, durable=durable)
    got = (tmp_path / "p" / "s.json").read_bytes()
    assert got == (tmp_path / "j" / "s.json").read_bytes()
    assert os.listdir(tmp_path / "p") == ["s.json"]
    assert port_atomic.read_json(tmp_path / "p" / "s.json") == \
        jax_atomic.read_json(tmp_path / "j" / "s.json")
    (tmp_path / "bad.json").write_text("{")
    for path in (tmp_path / "bad.json", tmp_path / "missing.json"):
        assert port_atomic.read_json(path, default=7) == 7


def test_plugin_types_have_jax_fields():
    for name in ("PluginCommand", "PluginService"):
        got = dataclasses.fields(getattr(port_api, name))
        want = dataclasses.fields(getattr(jax_api, name))
        assert [(f.name, f.default) for f in got] == \
            [(f.name, f.default) for f in want]
    assert pta.__all__ == jta.__all__
