"""The mean of one of the program's StageTimer stages over the window:
the change of its summed milliseconds over the change of its count (not
its log2-bucket quantiles, which resolve only to a factor of 2)."""


def mean_ms(window, stage: str):
    total, count = window.stages.get(stage, (0.0, 0))
    return total / count if count > 0 else None
