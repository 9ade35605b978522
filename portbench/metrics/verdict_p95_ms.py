"""The 95th percentile of the host-clock latency of every call the window
made, from the call into the seam to its verdict (nearest rank)."""

import math


def read(window, setup_s: float):
    lat = sorted(window.latencies_ms)
    if not lat:
        return None
    return lat[max(0, math.ceil(0.95 * len(lat)) - 1)]
