"""The collector ready but not running (the interpreter lock or the OS):
over its ``tokenize``, ``launch`` and ``decode`` spans in the profiled
sub-window, Σ (wall − the thread's CPU seconds) over the batches there, in
ms a batch (see ``_spans.py``). ``sync`` is left out: there the thread
waits for the card by design."""

from portbench.metrics._spans import batches, records


def read(window, setup_s: float):
    n = batches(window)
    spans = [r for r in records(window, ("tokenize", "launch", "decode"))
             if r.cpu_s is not None]
    if n <= 0 or not spans:
        return None
    return 1e3 * sum((r.t1 - r.t0) - r.cpu_s for r in spans) / n
