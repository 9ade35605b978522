"""A whole run on the CPU at a test size (the look for a card skipped):
the last line's keys, discovery by name, the refusal without a card, and
the faults the check has to catch."""

import hashlib
import json
import os

import pytest

from portbench import run as R
from portbench.spec import Spec

CHAT = "triage_tiny.stage3_chat"
BULK = "triage_tiny.bulk_triage"
SEED = 2**31 + 12345


def execute(root: str, name: str, traced: bool = False, seconds: float = 1.0,
            control: bool = False) -> dict:
    return R.execute(Spec(root), name, SEED, seconds, traced, device="cpu",
                     control=control)


def test_last_line_keys(bench_copy):
    root, _ = bench_copy
    result = execute(root, CHAT)
    info = result.pop("_info")
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] > 0 and info["compared"] > 0
    assert set(result["metrics"]) == {"verdicts_per_s", "setup_s"}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(result)


def test_traced_run_reports_per_layer_metrics(bench_copy):
    root, _ = bench_copy
    result = execute(root, CHAT, traced=True)
    # host-side layers read on the CPU; device metrics read nothing here
    assert {"verdict_p95_ms.chat", "queue_ms.chat", "batch_fill.chat",
            "batch_stage_ms.chat", "prefill_ms.chat"} \
        <= set(result["metrics"])
    assert not {"k1_roofline.chat", "mfu.chat", "device_idle.chat"} \
        & set(result["metrics"])
    assert 0 < result["metrics"]["batch_fill.chat"]["value"] <= 100


def test_main_refuses_without_a_card(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = R.main(["--workload", CHAT, "--seed", "1", "--seconds", "1",
                 "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0
    assert out.out == ""


def _digests(root: str) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if "__pycache__" in d:
                continue
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_discovery_by_name(bench_copy):
    """A new traffic mix, a new metric and a new cell come in as new files
    and new entries; no file the benchmark has is edited."""
    root, _ = bench_copy
    before = _digests(root)
    pb = os.path.join(root, "portbench")
    with open(os.path.join(pb, "traffic", "stage3_chat.json")) as f:
        mix = json.load(f)
    mix.update(sessions=2, pool=40)
    mix["sizes"] = {"loguniform": [3, 20]}
    with open(os.path.join(pb, "traffic", "short_pairs.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(pb, "metrics", "latency_max_ms.py"), "w") as f:
        f.write('"""The slowest request of the window."""\n\n\n'
                'def read(window, setup_s):\n'
                '    return max(window.latencies_ms, default=None)\n')
    with open(os.path.join(pb, "limits", CHAT + ".json")) as f:
        limits = f.read()
    with open(os.path.join(pb, "limits", "triage_tiny.short_pairs.json"),
              "w") as f:
        f.write(limits)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": "triage_tiny.short_pairs",
                               "config": "triage_tiny",
                               "traffic": "short_pairs", "chips": 1,
                               "why": "two sessions of short prompts"})
    bench["end_to_end"][0]["workloads"].append("triage_tiny.short_pairs")
    bench["per_layer"].append({
        "name": "latency_max_ms.pairs", "unit": "ms", "better": "lower",
        "source": "host_clock", "layer": "serve seam",
        "moves": "verdicts_per_s", "workloads": ["triage_tiny.short_pairs"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    after = _digests(root)
    changed = {p for p in before if p in after and before[p] != after[p]}
    assert changed == {"BENCHMARK.json"}
    assert set(after) - set(before) == {
        os.path.join("portbench", "traffic", "short_pairs.json"),
        os.path.join("portbench", "metrics", "latency_max_ms.py"),
        os.path.join("portbench", "limits", "triage_tiny.short_pairs.json")}
    result = execute(root, "triage_tiny.short_pairs", traced=True)
    assert result["correct"] is True
    assert result["metrics"]["latency_max_ms.pairs"]["value"] > 0
    plain = execute(root, "triage_tiny.short_pairs")
    assert "verdicts_per_s" in plain["metrics"]


class _FlakyTracer:
    """Stands in for ``trace.DeviceTrace``: its first sub-window comes
    back empty (None), as the profiler's has on the card."""

    def __init__(self):
        self.t0 = None
        self.stops = 0

    def start(self):
        import time

        self.t0 = time.perf_counter()

    def stop(self, spans=None):
        import time

        self.stops += 1
        if self.stops == 1:
            return None
        return {"t0": self.t0, "t1": time.perf_counter(), "busy_s": 0.1,
                "window_s": 0.3, "kernel_s": {}, "breakdown": {}}


@pytest.mark.parametrize("name", [CHAT, BULK])
def test_an_empty_sub_window_is_profiled_again(bench_copy, name):
    root, _ = bench_copy
    spec = Spec(root)
    cell = spec.cell(name)
    mix = spec.traffic(cell)
    run = R.Run(root, cell, spec.config(cell), mix, SEED, "cpu")
    runner = spec.entry(mix).Runner(run)
    runner.warm()
    tracer = _FlakyTracer()
    w = runner.window(2.5, tracer, None, {"skip_s": 0.2, "seconds": 0.3})
    runner.close()
    assert tracer.stops == 2
    assert w.trace is not None and w.trace["window_s"] == 0.3
