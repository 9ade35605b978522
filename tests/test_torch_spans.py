"""The port's spans inside the served paths (``utils/stage_timer.py``).

With no profiler the span log stays empty and the stage sums count every
batch. Under ``torch.profiler.profile(activities=[CPU])`` a CPU
``ContinuousBatcher`` behind the ``call_llm`` seam and ``keep_logits``
emit every span with its id, parent and rows; the children lie inside
their parents; a request's ``extract``, ``queue`` and ``wake`` share its
id and point at the batch that served it; and the profiler's
``openclaw.*`` ranges sit on the log's intervals, one clock for both.
"""

from __future__ import annotations

import statistics
import time
import threading
from dataclasses import dataclass, field

import pytest
from torch.profiler import ProfilerActivity, profile

from vainplex_openclaw_tpu_torch.cortex.trace_analyzer import classifier
from vainplex_openclaw_tpu_torch.governance.validation.llm_validator import (
    build_prompt)
from vainplex_openclaw_tpu_torch.models import batching, serve
from vainplex_openclaw_tpu_torch.utils import stage_timer
from vainplex_openclaw_tpu_torch.utils.stage_timer import (SPANS, SpanLog,
                                                           new_id, tracing)

SESSIONS, CALLS, MAX_BATCH, QUIET = 4, 5, 4, 3
COLLECTOR = ("wait", "window", "batch", "tokenize", "prefill", "launch",
             "sync", "decode")
PER_REQUEST = ("extract", "queue", "wake")
KEEP = ("keep_logits", "load", "tokenize", "pad", "launch", "sync")
JAX_STAGES = {"queue", "batch", "prefill", "decode"}
MARK = "clock_mark"


@dataclass
class Finding:
    signal: str
    summary: str
    evidence: list = field(default_factory=list)
    severity: str = "low"


def findings(n: int) -> list:
    return [Finding("tool_error", f"exec failed on step {i}", [f"exit {i}"])
            for i in range(n)]


def texts(n: int) -> list:
    return [f"The deploy {i} failed with code {i}; throughput fell {i}%."
            for i in range(n)]


def _profiler():
    try:
        from torch._C._profiler import _ExperimentalConfig

        config = _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return profile(activities=[ProfilerActivity.CPU])
    return profile(activities=[ProfilerActivity.CPU],
                   experimental_config=config)


def _sessions(call, prompts: list) -> None:
    def session(s: int) -> None:
        for k in range(CALLS):
            call(prompts[(s * CALLS + k) % len(prompts)])

    threads = [threading.Thread(target=session, args=(s,))
               for s in range(SESSIONS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120.0)
        assert not t.is_alive()


@pytest.fixture(scope="module")
def traced():
    """One profiled run: the seam's sessions through a collector thread;
    then, with nothing else running, the clock marker, ``QUIET`` calls one
    at a time from this thread and two ``keep_logits`` calls. Returns the
    log's records, the profiler's ``openclaw.*`` events, the marker's
    offset (profiler µs − perf_counter µs), when the quiet part began and
    the two calls' sizes."""
    call = serve.make_local_call_llm(
        None, serve_cfg={"maxBatch": MAX_BATCH, "windowMs": 2.0},
        device="cpu")
    prompts = [build_prompt(t, []) for t in texts(SESSIONS * CALLS)]
    try:
        call(prompts[0])   # the first forward, outside the profile
        classifier.keep_logits(findings(3), device="cpu")
        SPANS.clear()
        sizes = (5, 9)
        with _profiler() as prof:
            _sessions(call, prompts)
            with stage_timer.span(MARK):
                pass
            for prompt in prompts[:QUIET]:
                call(prompt)
            for n in sizes:
                classifier.keep_logits(findings(n), device="cpu")
        records = SPANS.between(float("-inf"), float("inf"))
        events = [e for e in prof.events() if e.name.startswith("openclaw.")]
    finally:
        serve.close_batchers()
        SPANS.clear()
    mark = next(e for e in events if e.name == "openclaw." + MARK)
    quiet_t0 = _by(records, MARK)[0].t0
    return {"records": records, "events": events, "sizes": sizes,
            "offset_us": mark.time_range.start - quiet_t0 * 1e6,
            "quiet_t0": quiet_t0}


def _by(records, name: str) -> list:
    return [r for r in records if r.name == name]


def _batch_ids(records) -> set:
    return {r.id for r in _by(records, "batch")}


def _keep_ids(records) -> set:
    return {r.id for r in _by(records, "keep_logits")}


# ── with no profiler ─────────────────────────────────────────────────


@pytest.mark.parametrize("path", ["step", "collector"])
def test_no_profiler_no_log_and_every_batch_counted(path):
    SPANS.clear()
    assert not tracing()
    batcher = batching.ContinuousBatcher(
        max_batch=3, window_ms=0.0, device="cpu",
        autostart=path == "collector")
    try:
        if path == "step":
            tickets = [batcher.enqueue(t) for t in texts(7)]
            while batcher.step():
                pass
        else:
            tickets = [batcher.enqueue(t) for t in texts(7)]
        for t in tickets:
            assert t.done.wait(60.0) and t.error is None
            assert t.result.startswith("{")
    finally:
        batcher.close()
    classifier.keep_logits(findings(4), device="cpu")
    assert len(SPANS) == 0
    # the serve edge's timer holds the per-request stages alone
    counts = batcher.timer.counts()
    assert set(counts) == JAX_STAGES
    assert counts["queue"] == batcher.served == 7
    for stage in ("batch", "prefill", "decode"):
        assert counts[stage] == batcher.batches, stage


@pytest.mark.parametrize("traced_step", [False, True])
def test_model_fn_step_keeps_jax_stages(traced_step):
    batcher = batching.ContinuousBatcher(
        max_batch=4, window_ms=0.0, device="cpu", autostart=False,
        model_fn=lambda texts: [1] * len(texts))
    for t in texts(6):
        batcher.enqueue(t)
    if traced_step:
        with _profiler():
            while batcher.step():
                pass
    else:
        while batcher.step():
            pass
    SPANS.clear()
    assert set(batcher.timer.counts()) == JAX_STAGES
    assert batcher.timer.counts()["queue"] == 6


# ── the span log itself ──────────────────────────────────────────────


def test_span_log_is_bounded_and_keeps_the_newest():
    log = SpanLog(capacity=4)
    for i in range(10):
        log.add("s", float(i), float(i) + 0.5, id=i)
    assert len(log) == 4
    assert [r.id for r in log.between(0.0, 100.0)] == [6, 7, 8, 9]


def test_between_takes_only_records_inside():
    log = SpanLog()
    log.add("in", 1.0, 2.0)
    log.add("edge", 2.0, 3.0)
    log.add("early", 0.5, 1.5)
    log.add("late", 2.5, 3.5)
    assert [r.name for r in log.between(1.0, 3.0)] == ["in", "edge"]


def test_ids_are_unique_across_threads():
    got: list = []
    lock = threading.Lock()

    def take() -> None:
        ids = [new_id() for _ in range(2000)]
        with lock:
            got.extend(ids)

    threads = [threading.Thread(target=take) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30.0)
        assert not t.is_alive()
    assert len(set(got)) == len(got) == 16000


def test_span_without_stage_costs_no_record_off():
    assert stage_timer.span("pad") is stage_timer.span("sync")
    with stage_timer.span("pad", 1, None, 3):
        pass
    assert len(SPANS) == 0


# ── under the profiler ───────────────────────────────────────────────


@pytest.mark.parametrize("name", COLLECTOR)
def test_collector_spans(traced, name):
    records = traced["records"]
    bids = _batch_ids(records)
    assert bids
    got = [r for r in _by(records, name) if r.id in bids]
    # the first batch's wait began before the profile, so it is unlogged
    assert len(got) >= len(bids) - (name in ("wait", "window"))
    rows = {r.id: r.n for r in _by(records, "batch")}
    for r in got:
        assert r.parent is None and r.cpu_s is not None
        assert r.t1 >= r.t0
        assert r.n == (None if name in ("wait", "window") else rows[r.id])
        assert 1 <= rows[r.id] <= MAX_BATCH


@pytest.mark.parametrize("name", PER_REQUEST)
def test_request_spans(traced, name):
    records = traced["records"]
    got = _by(records, name)
    assert len(got) == SESSIONS * CALLS + QUIET
    assert len({r.id for r in got}) == len(got)
    bids = _batch_ids(records)
    for r in got:
        assert r.n == 1 and r.cpu_s is None
        # the seam logs ``extract`` before the request has a batch
        assert r.parent in bids if name != "extract" else r.parent is None


def test_request_spans_share_the_request_id_and_batch(traced):
    records = traced["records"]
    parents = {name: {r.id: r.parent for r in _by(records, name)}
               for name in PER_REQUEST}
    assert set(parents["extract"]) == set(parents["queue"])
    assert parents["queue"] == parents["wake"]
    served: dict = {}
    for bid in parents["queue"].values():
        served[bid] = served.get(bid, 0) + 1
    for r in _by(records, "batch"):
        assert served[r.id] == r.n
    for r in _by(records, "queue"):
        batch = next(b for b in _by(records, "batch") if b.id == r.parent)
        assert r.t1 == batch.t0
    for r in _by(records, "wake"):
        decode = next(d for d in _by(records, "decode") if d.id == r.parent)
        assert decode.t0 <= r.t0 <= decode.t1


@pytest.mark.parametrize("name", KEEP)
def test_keep_logits_spans(traced, name):
    records = traced["records"]
    cids = _keep_ids(records)
    assert len(cids) == len(traced["sizes"])
    got = [r for r in _by(records, name) if r.id in cids]
    assert sorted(r.n for r in got) == sorted(traced["sizes"])
    for r in got:
        # the call's CPU time is its parts' summed
        assert r.parent is None
        assert (r.cpu_s is None) == (name == "keep_logits")


@pytest.mark.parametrize("child,parent,ids", [
    ("tokenize", "batch", _batch_ids),
    ("launch", "prefill", _batch_ids),
    ("sync", "prefill", _batch_ids),
    ("load", "keep_logits", _keep_ids),
    ("tokenize", "keep_logits", _keep_ids),
    ("pad", "keep_logits", _keep_ids),
    ("launch", "keep_logits", _keep_ids),
    ("sync", "keep_logits", _keep_ids),
])
def test_child_lies_inside_parent(traced, child, parent, ids):
    records = traced["records"]
    outer = {r.id: r for r in _by(records, parent) if r.id in ids(records)}
    inner = [r for r in _by(records, child) if r.id in outer]
    assert len(inner) == len(outer)
    for r in inner:
        assert outer[r.id].t0 <= r.t0 <= r.t1 <= outer[r.id].t1


def test_keep_logits_parts_follow_one_another(traced):
    records = traced["records"]
    for cid in _keep_ids(records):
        parts = sorted((r for r in records
                        if r.id == cid and r.name != "keep_logits"),
                       key=lambda r: r.t0)
        assert [r.name for r in parts] == list(KEEP[1:])
        for a, b in zip(parts, parts[1:]):
            assert a.t1 == b.t0


def test_stages_split_prefill_and_batch(traced):
    records = traced["records"]
    for bid in _batch_ids(records):
        one = {r.name: r for r in records
               if r.id == bid and r.name in COLLECTOR}
        assert one["batch"].t1 == one["prefill"].t0
        assert one["prefill"].t1 == one["decode"].t0
        assert one["launch"].t1 <= one["sync"].t0
        if "window" in one:
            assert one["window"].t1 <= one["batch"].t0
            if "wait" in one:
                assert one["wait"].t1 == one["window"].t0


@pytest.mark.parametrize("name", sorted(set(COLLECTOR) | set(KEEP)))
def test_profiler_ranges_on_the_logs_clock(traced, name):
    """The records of a serving thread's span in the quiet part have their
    ``openclaw.<name>`` ranges in the profiler's events: once the
    marker's offset is taken off, the median gap at either end is under
    50 µs, and no range is more than 1 ms off its record. (A range's
    end stamp follows the clock reading by the profiler's own bookkeeping,
    which grows with the ops recorded inside it, and a thread may be
    switched out between the two: that is not the clock.)"""
    off = traced["offset_us"]
    events = [(e.time_range.start - off, e.time_range.end - off)
              for e in traced["events"] if e.name == "openclaw." + name]
    recs = [r for r in _by(traced["records"], name)
            if r.t0 >= traced["quiet_t0"]]
    assert recs and events
    gaps = []
    for r in recs:
        start, end = min(events, key=lambda ev: abs(ev[0] - r.t0 * 1e6))
        gaps.append((start - r.t0 * 1e6, end - r.t1 * 1e6))
    for side in (0, 1):
        assert abs(statistics.median(g[side] for g in gaps)) < 50.0, gaps
        assert max(abs(g[side]) for g in gaps) < 1000.0, gaps


# ── a batch that fails ───────────────────────────────────────────────


def _fail(*_a, **_k):
    raise RuntimeError("injected")


@pytest.mark.parametrize("where,open_stage", [
    ("load_pretrained", "batch"), ("forward", "prefill"),
    ("model_fn", "prefill")])
def test_failed_batch_closes_its_ranges(monkeypatch, where, open_stage):
    """A batch that raises mid-chain closes the span it was in: its
    ``openclaw.*`` range ends before the error leaves ``step``, not when
    the profiler stops, and the failed stage takes no sample."""
    model_fn = _fail if where == "model_fn" else None
    if model_fn is None:
        monkeypatch.setattr(batching, where, _fail)
    batcher = batching.ContinuousBatcher(
        max_batch=4, window_ms=0.0, device="cpu", autostart=False,
        model_fn=model_fn)
    tickets = [batcher.enqueue(t) for t in texts(3)]
    SPANS.clear()
    with _profiler() as prof:
        with pytest.raises(RuntimeError, match="injected"):
            batcher.step()
        with stage_timer.span(MARK):
            time.sleep(0.05)
    records = SPANS.between(float("-inf"), float("inf"))
    SPANS.clear()
    events = [e for e in prof.events() if e.name.startswith("openclaw.")]
    mark = next(e for e in events if e.name == "openclaw." + MARK)
    served = [e for e in events if e.name != "openclaw." + MARK]
    assert "openclaw." + open_stage in {e.name for e in served}
    for e in served:
        assert e.time_range.end <= mark.time_range.start, e.name
    assert open_stage in {r.name for r in records}
    assert open_stage not in batcher.timer.counts()
    assert all(t.error is not None for t in tickets)


# ── the serve edge's SLO ─────────────────────────────────────────────


def test_idle_gateway_keeps_its_serve_slo(tmp_path, openclaw_home):
    """The batcher's timer is the gateway's ``serve`` edge, and the slo
    collector holds every stage on it to ``defaultP99Ms``. The collector's
    idle wait for work is no stage of a request: a gateway with local
    stage 3 that sits idle between sends keeps its SLO."""
    from helpers import FakeClock

    from vainplex_openclaw_tpu_torch import core
    from vainplex_openclaw_tpu_torch.core import api
    from vainplex_openclaw_tpu_torch.governance import GovernancePlugin
    from vainplex_openclaw_tpu_torch.sitrep.collectors import collect_slo

    logger = api.list_logger()
    gw = core.Gateway(config={"workspace": str(tmp_path),
                              "agents": [{"id": "main"}]},
                      logger=logger, clock=FakeClock())
    plugin = GovernancePlugin(workspace=str(tmp_path), clock=gw.clock,
                              device="cpu")
    gw.load(plugin, plugin_config={
        "builtinPolicies": {}, "validation": {"enabled": True,
                                              "llmValidator": {
                                                  "enabled": True,
                                                  "local": True}}},
        logger=logger)
    gw.start()
    meta = {"agent_id": "main", "session_key": "agent:main",
            "channel_id": "twitter"}
    try:
        for text in ("the deploy finished and all checks pass",
                     "the cache restarted; nothing else changed",
                     "billing is up again after the rollback"):
            gw.message_sending(text, dict(meta))
            time.sleep(0.8)
        stages = set(gw.stage_timers["serve"].counts())
        slo = collect_slo({"defaultP99Ms": 200.0},
                          {"stage_timers": lambda: {
                              name: t.snapshot()
                              for name, t in gw.stage_timers.items()}})
        gw.stop()
    finally:
        serve.close_batchers()
    assert slo["status"] != "error", slo
    assert stages == JAX_STAGES
