"""Waiting for the card, a row: the program's ``sync`` spans (the ``.cpu()``
that brings the logits back once the forward has run) over the profiled
sub-window, Σ duration over Σ rows, in µs (see ``_spans.py``)."""

from portbench.metrics._spans import us_per_row


def read(window, setup_s: float):
    return us_per_row(window, "sync")
