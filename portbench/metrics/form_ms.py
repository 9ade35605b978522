"""Forming a batch: the collector's ``wait`` (queue empty → first ticket)
and ``window`` (first ticket → drained) spans over the profiled sub-window,
Σ duration over the batches there, in ms a batch (see ``_spans.py``)."""

from portbench.metrics._spans import batches, records


def read(window, setup_s: float):
    n = batches(window)
    spans = records(window, ("wait", "window"))
    if n <= 0 or not spans:
        return None
    return 1e3 * sum(r.t1 - r.t0 for r in spans) / n
