"""The share of the tokenizer's rows that took its Python loop instead of
the compiled pass: Σ rows of the program's ``tokenize_py`` records over Σ
rows of its ``tokenize`` spans in the profiled sub-window, in %. It reads
0 where ``tokenize`` spans exist and no ``tokenize_py`` record does (every
row compiled, or a program without the compiled pass), and None without a
trace or without ``tokenize`` spans (see ``_spans.py``)."""

from portbench.metrics._spans import records


def read(window, setup_s: float):
    spans = records(window, ("tokenize", "tokenize_py"))
    rows = sum(r.n or 0 for r in spans if r.name == "tokenize")
    if rows <= 0:
        return None
    fell_back = sum(r.n or 0 for r in spans if r.name == "tokenize_py")
    return 100.0 * fell_back / rows
