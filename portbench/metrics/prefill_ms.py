"""The program's StageTimer ``prefill`` stage over the window, in ms per
entry (see ``_stage.py``)."""

from portbench.metrics._stage import mean_ms


def read(window, setup_s: float):
    return mean_ms(window, "prefill")
