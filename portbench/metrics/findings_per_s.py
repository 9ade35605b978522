"""Findings triaged over the window: every finding of the window's calls,
over the seconds from its start to the end of its last call (host
clock)."""


def read(window, setup_s: float):
    if window.unit != "finding":
        return None
    return window.units / window.span_s
