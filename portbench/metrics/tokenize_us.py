"""The tokenizer's time a row: the program's ``tokenize`` spans (the
``encode_texts`` call in the batcher's ``batch`` stage, or the finding text
and ``encode_texts`` in ``keep_logits``) over the profiled sub-window, Σ
duration over Σ rows, in µs (see ``_spans.py``)."""

from portbench.metrics._spans import us_per_row


def read(window, setup_s: float):
    return us_per_row(window, "tokenize")
