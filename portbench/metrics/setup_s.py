"""Set-up: seconds from the process's start to the window's start
(imports, CUDA init, weights, kernel builds and the warm-up)."""


def read(window, setup_s: float):
    return setup_s
