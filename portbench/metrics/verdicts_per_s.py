"""Stage-3 verdicts delivered inside the window, from every session, over
the window's seconds (host clock)."""


def read(window, setup_s: float):
    if window.unit != "verdict":
        return None
    return window.units / window.span_s
