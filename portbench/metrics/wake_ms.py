"""Handing a verdict back: the program's ``wake`` spans (the collector's
``done.set()`` → the session's wait returning on its own thread) over the
profiled sub-window, their mean, in ms a request (see ``_spans.py``)."""

from portbench.metrics._spans import records


def read(window, setup_s: float):
    spans = records(window, ("wake",))
    if not spans:
        return None
    return 1e3 * sum(r.t1 - r.t0 for r in spans) / len(spans)
