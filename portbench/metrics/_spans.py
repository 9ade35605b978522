"""The program's span log (``vainplex_openclaw_tpu_torch.utils.stage_timer``'s
``SPANS``) over the profiled sub-window, ``window.trace["t0"]`` to
``["t1"]``: the log fills exactly while the profiler records. Every reader
here returns None without a trace, where the program has no span log, or
where the log holds no span it reads."""


def records(window, names) -> list:
    """The records named in ``names`` lying inside the sub-window."""
    if window.trace is None:
        return []
    try:
        from vainplex_openclaw_tpu_torch.utils.stage_timer import SPANS
    except ImportError:
        return []
    return [r for r in SPANS.between(window.trace["t0"], window.trace["t1"])
            if r.name in names]


def us_per_row(window, name: str):
    """Σ duration of the spans ``name`` over Σ their rows, in µs."""
    spans = [r for r in records(window, (name,)) if r.n]
    rows = sum(r.n for r in spans)
    if rows <= 0:
        return None
    return 1e6 * sum(r.t1 - r.t0 for r in spans) / rows


def batches(window) -> int:
    """The batches whose ``batch`` span lies inside the sub-window."""
    return len({r.id for r in records(window, ("batch",))})
