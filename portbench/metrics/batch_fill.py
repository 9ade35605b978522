"""The batcher's fill over the window: requests served over batches formed
times ``maxBatch``, as a percentage."""


def read(window, setup_s: float):
    if window.batches <= 0 or window.max_batch <= 0:
        return None
    return 100.0 * window.served / (window.batches * window.max_batch)
