"""Issuing the forward, a row: the program's ``launch`` spans (tokens to the
device and ``forward`` returning, before the wait for the card) over the
profiled sub-window, Σ duration over Σ rows, in µs (see ``_spans.py``)."""

from portbench.metrics._spans import us_per_row


def read(window, setup_s: float):
    return us_per_row(window, "launch")
