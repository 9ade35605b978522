"""The device's idle share of the profiled sub-window: one less the union
of every kernel's and copy's interval over the sub-window's length, as a
percentage."""


def read(window, setup_s: float):
    if window.trace is None or window.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - window.trace["busy_s"] / window.trace["window_s"])
