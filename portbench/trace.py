"""The traced run's instruments, all from the benchmark's side.

- :class:`Spans` wraps the program's calls into its layers (the tokenizer,
  the forward) where an entry module calls them through a module attribute, and
  records each call's host interval on ``time.perf_counter``. Only traced
  runs wrap; the wrappers are taken off when the run ends. A name the
  program no longer has is passed over, and what would have read it stays
  silent.
- :class:`DeviceTrace` runs ``torch.profiler`` over a sub-window and
  reduces it to what the metrics read: the seconds in which any kernel or
  copy ran (the union of their intervals), the window's length, the device
  time of each kernel kind, the longest device operations, and the longest
  idle gaps named by the span the host was inside.

The profiler records every thread (``profile_all_threads``, where the
installed torch has it), and its clock is tied to ``perf_counter`` by one
marker of the main thread. Its first start, which initializes CUPTI and
takes seconds, is made in set-up (:meth:`DeviceTrace.warm`).
"""

from __future__ import annotations

import importlib
import re
import threading
import time

import torch

# (module, attribute, span label): the calls into each layer that the
# entry modules make.
WRAPPED = (
    ("vainplex_openclaw_tpu_torch.models.batching", "encode_texts",
     "tokenizer"),
    ("vainplex_openclaw_tpu_torch.models.batching", "forward", "forward"),
    ("vainplex_openclaw_tpu_torch.cortex.trace_analyzer.classifier",
     "encode_texts", "tokenizer"),
    ("vainplex_openclaw_tpu_torch.cortex.trace_analyzer.classifier",
     "forward", "forward"),
)
NO_SPAN = "no span: batch window, hand-off or clients"

# The flash kernels' template arguments <Dh, causal, stats> as the
# profiler names them (``mma::flash_fwd_mma<16, false, true>(...)``);
# stats marks K2.
_FLASH = re.compile(r"flash_fwd_\w*?<\s*(\d+)\s*,\s*(true|false)\s*,\s*"
                    r"(true|false)\s*>")


def kernel_kind(name: str):
    """``"K1"`` or ``"K2"`` for a flash kernel's name, else None."""
    m = _FLASH.search(name)
    if m is None:
        return None
    return "K2" if m.group(3) == "true" else "K1"


class Spans:
    """Host intervals of the wrapped calls, from every thread."""

    def __init__(self):
        self.records: list = []   # (label, t0, t1) in perf_counter seconds
        self._lock = threading.Lock()
        self._undo: list = []

    def _wrap(self, fn, label: str):
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                t1 = time.perf_counter()
                with self._lock:
                    self.records.append((label, t0, t1))
        return wrapped

    def install(self) -> None:
        for mod_name, attr, label in WRAPPED:
            try:
                module = importlib.import_module(mod_name)
            except ImportError:
                continue
            fn = getattr(module, attr, None)
            if fn is None:
                continue
            setattr(module, attr, self._wrap(fn, label))
            self._undo.append((module, attr, fn))

    def remove(self) -> None:
        for module, attr, fn in reversed(self._undo):
            setattr(module, attr, fn)
        self._undo.clear()

    def between(self, t0: float, t1: float) -> list:
        with self._lock:
            return [r for r in self.records if r[2] > t0 and r[1] < t1]


def _union_s(intervals: list) -> tuple:
    """(seconds covered, merged intervals) of ``[start, end]`` µs pairs."""
    merged: list = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged) / 1e6, merged


class DeviceTrace:
    """``torch.profiler`` over one sub-window; :meth:`stop` returns the
    reduced trace (a dict), or None where the profiler handed back no
    kernel for the sub-window (it has done so on the H100, about one
    traced run in a dozen, with the copies of that sub-window recorded).
    A runner then profiles a later sub-window of its window; ``misses``
    says what each empty one held. A traced run in which no sub-window
    reads the device prints no result."""

    MARK = "portbench.clock"

    def __init__(self):
        self._prof = None
        self.t0 = self.t1 = None
        self._mark_t = None
        self.misses: list = []

    @staticmethod
    def _profile():
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        try:
            from torch._C._profiler import _ExperimentalConfig

            # the collector and the sessions run on threads of their own
            config = _ExperimentalConfig(profile_all_threads=True)
        except (ImportError, TypeError):
            return profile(activities=activities)
        return profile(activities=activities, experimental_config=config)

    def warm(self, seconds: float = 1.0) -> None:
        """Profile ``seconds`` of small kernels once, in set-up: the first
        start initializes CUPTI, which takes seconds, and a profile stopped
        before that has finished records no kernel."""
        prof = self._profile()
        prof.__enter__()
        x = torch.zeros(1024, device="cuda")
        end = time.perf_counter() + seconds
        while time.perf_counter() < end:
            x.add_(1)
            torch.cuda.synchronize()
            time.sleep(0.005)
        prof.__exit__(None, None, None)

    def start(self) -> None:
        self._prof = self._profile()
        self._prof.__enter__()
        self.t0 = time.perf_counter()
        self._mark_t = time.perf_counter()
        with torch.profiler.record_function(self.MARK):
            pass

    def stop(self, spans: "Spans | None" = None) -> "dict | None":
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self._prof.__exit__(None, None, None)
        return self._reduce(self._prof.events(), spans)

    def _reduce(self, events, spans) -> "dict | None":
        from torch.autograd import DeviceType

        device, kinds, by_name = [], {}, {}
        offset_us = None
        kernels = empty = 0
        for evt in events:
            if evt.device_type == DeviceType.CPU:
                if offset_us is None and evt.name == self.MARK:
                    offset_us = evt.time_range.start - self._mark_t * 1e6
                continue
            s, e = evt.time_range.start, evt.time_range.end
            if e <= s:
                empty += 1
                continue
            device.append((s, e))
            if not evt.name.startswith(("Memcpy", "Memset")):
                kernels += 1
            by_name[evt.name] = by_name.get(evt.name, 0.0) + (e - s) / 1e6
            kind = kernel_kind(evt.name)
            if kind:
                kinds[kind] = kinds.get(kind, 0.0) + (e - s) / 1e6
        if not kernels:
            self.misses.append({"copies": len(device),
                                "device_events_without_time": empty,
                                "window_s": self.t1 - self.t0})
            return None
        busy_s, merged = _union_s(device)
        gaps = [(merged[i + 1][0] - merged[i][1], merged[i][1],
                 merged[i + 1][0]) for i in range(len(merged) - 1)]
        gaps.sort(reverse=True)
        named = []
        host = spans.between(self.t0, self.t1) if spans is not None else []
        for length, a, b in gaps[:10]:
            label = NO_SPAN
            if offset_us is not None and host:
                mid = ((a + b) / 2 - offset_us) / 1e6
                inside = [(t1 - t0, lab) for lab, t0, t1 in host
                          if t0 <= mid <= t1]
                if inside:
                    label = min(inside)[1]
            named.append([label, length / 1e6])
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        return {"busy_s": busy_s, "window_s": self.t1 - self.t0,
                "kernel_s": kinds, "t0": self.t0, "t1": self.t1,
                "breakdown": {"device_ops": [[k[:120], v] for k, v in top],
                              "idle_gaps": named}}
