"""K1 (the normalized flash kernel, ``ops/flash_attention.py`` →
``ops/csrc/flash_attention_mma.cuh``) against its roofline (see
``_roofline.py``)."""

from portbench.metrics._roofline import share


def read(window, setup_s: float):
    return share(window, "K1", stats=False)
