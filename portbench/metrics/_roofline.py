"""A flash kernel's share of its roofline over the profiled sub-window:
the least time of the attention the rows served inside it need
(``rooflines.rows_attention_bound``, at each row's real tokens), over the
kernel's device time there, as a percentage. Nothing is read where the
profiler saw no such kernel or no row."""

from portbench.rooflines import rows_attention_bound


def share(window, kind: str, stats: bool):
    if window.trace is None:
        return None
    kernel_s = window.trace["kernel_s"].get(kind, 0.0)
    rows = window.traced_rows.get(kind, [])
    if kernel_s <= 0 or not rows:
        return None
    bound = rows_attention_bound(rows, window.widths, stats=stats)
    return 100.0 * bound["bound_ms"] / 1e3 / kernel_s
