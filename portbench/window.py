"""What an entry's runner hands the metric readers once its window has
closed."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass
class Window:
    # the unit of work a request delivers ("verdict", "finding")
    unit: str
    # seconds the rate is taken over: the whole window, set-up excluded
    span_s: float
    # units delivered in the window, and their real tokens
    units: int = 0
    tokens: int = 0
    # units the window asked for (delivered or not)
    attempted: int = 0
    # host-clock latency of every request of the window (ms)
    latencies_ms: list = field(default_factory=list)
    # the program's StageTimer and counters over the window (their change
    # from the window's start to its end)
    stages: dict = field(default_factory=dict)   # stage -> (sum ms, count)
    served: int = 0
    batches: int = 0
    max_batch: int = 0
    # the profiled sub-window (trace.DeviceTrace's reduction) and the real
    # tokens of the rows served inside it, by the kernel that served them
    trace: Optional[dict] = None
    traced_rows: dict = field(default_factory=dict)  # "K1"/"K2" -> [n]
    all_traced_rows: list = field(default_factory=list)
    widths: dict = field(default_factory=dict)
