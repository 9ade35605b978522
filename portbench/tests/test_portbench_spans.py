"""The readers of the program's span log (``metrics/_spans.py`` and the
metrics on it), on a synthetic log: each value as its definition gives
it, None without a trace, without the log or without a span, and spans
outside the profiled sub-window left out."""

import pytest

from portbench.spec import Spec
from portbench.window import Window

T0, T1 = 100.0, 104.0   # the profiled sub-window (perf_counter s)
NINE = ("tokenize_us.chat", "tokenize_us.triage", "launch_us.chat",
        "launch_us.triage", "sync_us.chat", "sync_us.triage", "form_ms.chat",
        "wake_ms.chat", "offcpu_ms.chat")


def _log():
    """Two batches of 4 and 2 rows inside the sub-window, one batch and
    one of each span outside it (which must not count), and one span that
    crosses its start."""
    from vainplex_openclaw_tpu_torch.utils.stage_timer import SpanLog

    log = SpanLog()
    for bid, t, rows in ((1, 101.0, 4), (2, 102.0, 2)):
        log.add("wait", t, t + 0.001, bid)
        log.add("window", t + 0.001, t + 0.003, bid)
        log.add("batch", t + 0.003, t + 0.008, bid, None, rows, 0.004)
        log.add("tokenize", t + 0.004, t + 0.0076, bid, None, rows, 0.003)
        log.add("prefill", t + 0.008, t + 0.015, bid, None, rows, 0.006)
        log.add("launch", t + 0.008, t + 0.014, bid, None, rows, 0.005)
        log.add("sync", t + 0.014, t + 0.015, bid, None, rows, 0.0001)
        log.add("decode", t + 0.015, t + 0.016, bid, None, rows, 0.0008)
        for k in range(rows):
            log.add("queue", t - 0.002, t + 0.003, 10 * bid + k, bid, 1)
            log.add("wake", t + 0.0155, t + 0.0155 + 0.0001 * (k + 1),
                    10 * bid + k, bid, 1)
    for name in ("wait", "window", "batch", "tokenize", "launch", "sync",
                 "decode", "wake"):
        log.add(name, 90.0, 99.0, 9, None, 1, 0.0)
        log.add(name, 104.5, 110.0, 9, None, 1, 0.0)
    log.add("tokenize", 99.9, 100.5, 8, None, 1, 0.0)
    return log


def _window(trace=True) -> Window:
    w = Window(unit="verdict", span_s=51.0)
    if trace:
        w.trace = {"t0": T0, "t1": T1}
    return w


def _read(name: str, window: Window):
    return Spec().reader({"name": name}).read(window, setup_s=1.0)


@pytest.fixture
def log(monkeypatch):
    from vainplex_openclaw_tpu_torch.utils import stage_timer

    log = _log()
    monkeypatch.setattr(stage_timer, "SPANS", log)
    return log


@pytest.mark.parametrize("name,want", [
    # Σ duration over Σ rows, µs: (3.6 + 3.6) ms over 6 rows
    ("tokenize_us.chat", 1e6 * (0.0036 + 0.0036) / 6),
    ("tokenize_us.triage", 1e6 * (0.0036 + 0.0036) / 6),
    ("launch_us.chat", 1e6 * (0.006 + 0.006) / 6),
    ("launch_us.triage", 1e6 * (0.006 + 0.006) / 6),
    ("sync_us.chat", 1e6 * (0.001 + 0.001) / 6),
    ("sync_us.triage", 1e6 * (0.001 + 0.001) / 6),
    # (wait + window) over batches, ms: 3 ms a batch
    ("form_ms.chat", 3.0),
    # the mean wake, ms: 0.1 .. 0.4 and 0.1 .. 0.2
    ("wake_ms.chat", (0.1 + 0.2 + 0.3 + 0.4 + 0.1 + 0.2) / 6),
    # Σ (wall − CPU) of tokenize, launch and decode over batches, ms
    ("offcpu_ms.chat", ((3.6 - 3.0) + (6.0 - 5.0) + (1.0 - 0.8))),
])
def test_reader_value(log, name, want):
    assert _read(name, _window()) == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("name", NINE)
def test_reader_none_without_a_trace(log, name):
    assert _read(name, _window(trace=False)) is None


@pytest.mark.parametrize("name", NINE)
def test_reader_none_without_spans(monkeypatch, name):
    from vainplex_openclaw_tpu_torch.utils import stage_timer

    monkeypatch.setattr(stage_timer, "SPANS", stage_timer.SpanLog())
    assert _read(name, _window()) is None


@pytest.mark.parametrize("name", NINE)
def test_reader_none_where_the_program_has_no_span_log(monkeypatch, name):
    """As at a parent commit that predates the span log."""
    from vainplex_openclaw_tpu_torch.utils import stage_timer

    monkeypatch.delattr(stage_timer, "SPANS")
    assert _read(name, _window()) is None


@pytest.mark.parametrize("name", NINE)
def test_spans_outside_the_sub_window_are_ignored(log, name):
    inside = _read(name, _window())
    log.add("batch", 104.2, 104.9, 7, None, 32, 0.0)
    log.add("wake", 99.0, 100.0, 7, None, 1, 0.0)
    wide = Window(unit="verdict", span_s=51.0)
    wide.trace = {"t0": 0.0, "t1": 200.0}
    assert _read(name, _window()) == inside
    assert _read(name, wide) != inside
