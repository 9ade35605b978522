"""JAX's default random keys and normal draws, reproduced in numpy.

The JAX package draws its initial parameters with ``jax.random``:
``PRNGKey(seed)``, ``split`` and ``normal`` over threefry2x32 with
``jax_threefry_partitionable`` on (the default of the JAX it runs). This
module computes the same key words and the same uint32 bits on the host:

- :func:`prng_key` is ``PRNGKey(seed)`` with 64-bit types off (JAX's
  default): the words ``(0, seed mod 2**32)``;
- :func:`split` and :func:`random_bits` hash the flat row-major index of
  each output element, as a (high, low) pair of 32-bit counters, with
  threefry2x32 (20 rounds) under the key; ``split`` keeps both output
  words as the new keys, ``random_bits`` their xor;
- :func:`normal` maps the bits to a uniform in ``[nextafter(-1, 0), 1)``
  (the top 23 bits as a float32 mantissa in [1, 2), minus 1, times 2,
  plus the low end) and returns ``sqrt(2) * erfinv(u)`` with Giles'
  single-precision ``erfinv`` polynomial, the one XLA lowers ``ErfInv``
  to, evaluated in float32.

The bits are JAX's exactly. The normals differ from JAX's by the rounding
of ``log1p`` and ``sqrt`` only: within 1e-6 per unit draw
(``tests/test_torch_prng.py``).
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray) -> tuple:
    """Threefry-2x32 with 20 rounds: the two output words for the counter
    pairs ``(x0, x1)`` under ``key`` (two uint32 words)."""
    k0, k1 = (np.uint32(w) for w in key)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = x0.astype(np.uint32) + ks[0]
    x1 = x1.astype(np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``'s two uint32 words: JAX without 64-bit
    types takes the seed's low 32 bits."""
    return np.array([0, int(seed) & 0xFFFFFFFF], dtype=np.uint32)


def _counters(n: int) -> tuple:
    """The flat indices 0 .. n-1 as (high, low) uint32 words."""
    idx = np.arange(n, dtype=np.uint64)
    return ((idx >> np.uint64(32)).astype(np.uint32),
            (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: ``[num, 2]`` uint32 keys."""
    b0, b1 = threefry2x32(key, *_counters(num))
    return np.stack([b0, b1], axis=1)


def random_bits(key: np.ndarray, shape: tuple) -> np.ndarray:
    """``jax.random.bits(key, shape)``: uint32 of ``shape``."""
    b0, b1 = threefry2x32(key, *_counters(int(np.prod(shape, dtype=np.int64))))
    return (b0 ^ b1).reshape(shape)


# Giles, "Approximating the erfinv function" (2010), single precision: the
# coefficients of XLA's ErfInv for float32, highest degree first.
_W_LT_5 = np.array([2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                    -4.39150654e-06, 0.00021858087, -0.00125372503,
                    -0.00417768164, 0.246640727, 1.50140941], np.float32)
_W_GE_5 = np.array([-0.000200214257, 0.000100950558, 0.00134934322,
                    -0.00367342844, 0.00573950773, -0.0076224613,
                    0.00943887047, 1.00167406, 2.83297682], np.float32)


def erfinv_f32(x: np.ndarray) -> np.ndarray:
    """float32 ``erfinv`` by Giles' polynomial, in float32 throughout."""
    x = np.asarray(x, np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        w = -np.log1p(-x * x)
        lt = w < np.float32(5.0)
        w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0))
        p = np.where(lt, _W_LT_5[0], _W_GE_5[0])
        for a, b in zip(_W_LT_5[1:], _W_GE_5[1:]):
            p = np.where(lt, a, b) + p * w
        out = p * x
        return np.where(np.abs(x) == np.float32(1.0),
                        x * np.float32(np.inf), out).astype(np.float32)


def uniform(key: np.ndarray, shape: tuple, minval: float,
            maxval: float) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    bits = random_bits(key, shape)
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)
    floats = floats - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, floats * (hi - lo) + lo)


def normal(key: np.ndarray, shape: tuple) -> np.ndarray:
    """``jax.random.normal(key, shape, float32)``."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(key, shape, lo, np.float32(1.0))
    return np.float32(np.sqrt(2)) * erfinv_f32(u)
