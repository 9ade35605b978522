"""The whole step's share of the card's bf16 peak over the profiled
sub-window: the operations of the encoder forwards the rows served inside
it need (``rooflines.rows_flops``, at each row's real tokens) over the
sub-window's length times 989 TFLOP/s, as a percentage."""

from portbench.rooflines import PEAK_BF16_OPS_PER_S, rows_flops


def read(window, setup_s: float):
    if window.trace is None or not window.all_traced_rows:
        return None
    flops = rows_flops(window.all_traced_rows, window.widths)
    return 100.0 * flops / (window.trace["window_s"] * PEAK_BF16_OPS_PER_S)
