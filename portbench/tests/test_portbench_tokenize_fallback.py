"""``metrics/tokenize_fallback.py`` on a synthetic span log: 0 with no
``tokenize_py`` record, the share of rows where some fell back, records
outside the profiled sub-window left out, and None without a trace,
without ``tokenize`` spans or without the program's span log."""

import pytest

from portbench.spec import Spec
from portbench.window import Window

T0, T1 = 100.0, 104.0   # the profiled sub-window (perf_counter s)
NAMES = ("tokenize_fallback.chat", "tokenize_fallback.triage")


def _window(trace=True) -> Window:
    w = Window(unit="verdict", span_s=51.0)
    if trace:
        w.trace = {"t0": T0, "t1": T1}
    return w


def _read(name: str, window: Window):
    return Spec().reader({"name": name}).read(window, setup_s=1.0)


@pytest.fixture
def log(monkeypatch):
    """Two ``tokenize`` spans of 32 and 16 rows inside the sub-window, and
    one of each record outside it, which must not count."""
    from vainplex_openclaw_tpu_torch.utils import stage_timer

    log = stage_timer.SpanLog()
    log.add("tokenize", 101.0, 101.004, 1, None, 32, 0.003)
    log.add("tokenize", 102.0, 102.004, 2, None, 16, 0.003)
    log.add("tokenize", 90.0, 91.0, 9, None, 64, 0.0)
    log.add("tokenize_py", 90.1, 90.2, None, None, 64)
    log.add("tokenize_py", 104.5, 104.6, None, None, 8)
    monkeypatch.setattr(stage_timer, "SPANS", log)
    return log


@pytest.mark.parametrize("name", NAMES)
def test_zero_without_a_fallback_record(log, name):
    assert _read(name, _window()) == 0.0


@pytest.mark.parametrize("name", NAMES)
def test_half_the_rows_fallen_back(log, name):
    log.add("tokenize_py", 101.001, 101.003, None, None, 16)
    log.add("tokenize_py", 102.001, 102.003, None, None, 8)
    assert _read(name, _window()) == pytest.approx(50.0)


@pytest.mark.parametrize("name", NAMES)
def test_none_without_a_trace(log, name):
    assert _read(name, _window(trace=False)) is None


@pytest.mark.parametrize("name", NAMES)
def test_none_without_tokenize_spans(monkeypatch, name):
    from vainplex_openclaw_tpu_torch.utils import stage_timer

    monkeypatch.setattr(stage_timer, "SPANS", stage_timer.SpanLog())
    assert _read(name, _window()) is None


@pytest.mark.parametrize("name", NAMES)
def test_none_where_the_program_has_no_span_log(monkeypatch, name):
    from vainplex_openclaw_tpu_torch.utils import stage_timer

    monkeypatch.delattr(stage_timer, "SPANS")
    assert _read(name, _window()) is None


def test_the_program_logs_its_python_rows_while_tracing(monkeypatch):
    """The program's own record: a row above U+FFFF falls back, and the
    reader sees it against the ``tokenize`` span around the call."""
    import torch

    from vainplex_openclaw_tpu_torch.models import tokenizer
    from vainplex_openclaw_tpu_torch.utils import stage_timer

    log = stage_timer.SpanLog()
    monkeypatch.setattr(stage_timer, "SPANS", log)
    texts = ["deploy failed", "deploy \U0001F680 failed", "ok", "fine"]
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        t0 = stage_timer.time.perf_counter()
        with stage_timer.span("tokenize", 1, None, len(texts)):
            tokenizer.encode_texts(texts, 16, 2048)
        t1 = stage_timer.time.perf_counter()
    w = Window(unit="verdict", span_s=51.0)
    w.trace = {"t0": t0, "t1": t1}
    assert _read("tokenize_fallback.chat", w) == pytest.approx(25.0)
