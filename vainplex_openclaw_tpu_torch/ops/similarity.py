"""Batch-shape helpers shared by the serve path.

Copies of ``pow2_bucket`` and ``pad_rows`` from
``vainplex_openclaw_tpu/ops/similarity.py``: one rounding discipline for
every bucketed batch, so the batcher pads to the same power-of-two sizes as
the JAX package.
"""

from __future__ import annotations

import numpy as np


def pow2_bucket(n: int) -> int:
    """Smallest power of two ≥ n (n ≥ 1)."""
    return 1 << max(n - 1, 0).bit_length()


def pad_rows(X: np.ndarray, n: int) -> np.ndarray:
    """Zero-pad a row batch up to ``n`` rows (no-op at exactly ``n``)."""
    if len(X) == n:
        return X
    out = np.zeros((n, X.shape[1]), dtype=X.dtype)
    out[:len(X)] = X
    return out
