"""Batch-shape helpers and the batched similarity programs.

Counterpart of ``vainplex_openclaw_tpu/ops/similarity.py``:

- ``pow2_bucket`` and ``pad_rows``: one rounding discipline for every
  bucketed batch, so the batcher pads to the same power-of-two sizes as the
  JAX package;
- the param-set half, copied: ``VOLATILE_KEYS``, the scalar
  :func:`jaccard_similarity` and :func:`param_similarity` the doom-loop
  detectors read, and the rows the clusterer builds (:func:`hash_entries`,
  :func:`multi_hot_rows`, :func:`hashed_multi_hot`), with
  :func:`jaccard_matrix` over them;
- :func:`jaccard_from_rows`, the twin of the jitted Jaccard block
  (``_jaccard_matrix_jax_impl``): intersections as one matrix product of the
  multi-hot rows, unions from the row counts. A plain matrix product, which
  the JAX package leaves to XLA, and so does the port;
- :func:`batch_levenshtein_ratio`, the twin of the batched Levenshtein DP
  (``_batch_levenshtein_jax``), at any ``length`` as JAX takes it. Its DP
  runs in :func:`levenshtein_rows`: on a CUDA tensor the hand-written
  kernel K3 (``csrc/levenshtein.cu``, the bit-parallel distance with one
  warp per pair, one launch, counted in :data:`launches`), on a CPU tensor
  the plain version :func:`levenshtein_rows_reference`, the vectorized row
  DP of ``_batch_levenshtein_numpy`` with ``torch.cummin`` for the prefix
  minimum that carries the in-row dependency. The plain version runs a
  few tensor operations per DP row, ~1400 launches at L=128, and on the
  card it was bound by those launches at every batch size measured, which
  is why the DP has a kernel.

Both batched programs are integer-exact, as the reference's note says:
rows are {0, 1}, so every partial sum of the product is a small integer,
exact in fp32 under any order of accumulation, and the Levenshtein DP is
integer arithmetic throughout. The one rounding is the final ratio, and it
is taken as numpy takes it (a float64 quotient of integers for the
Levenshtein ratio, cast to fp32; a correctly rounded fp32 quotient for
Jaccard, here a float64 quotient cast to fp32, which equals it because
float64 carries more than twice fp32's precision). So the results are
bit-identical to the JAX package's numpy, jax and scalar paths, on the card
too. The batch dimension is bucketed to powers of two as the JAX path
buckets it (zero rows padded, the result sliced back).

The programs run on the card by default and on the CPU when asked
(``device="cpu"``); without a card the default raises. A CUDA tensor
never falls back to the plain version: the kernel launches or raises.
"""

from __future__ import annotations

import json
import threading
import zlib
from typing import Optional

import numpy as np
import torch

from ..device import DeviceError, DeviceLike, resolve_device

VOLATILE_KEYS = frozenset({"timeout", "timestamp", "ts"})
LEVENSHTEIN_CAP = 500

# K3 launches since the last reset; only the CUDA branch of
# ``levenshtein_rows`` adds to it.
launches = 0
_launch_lock = threading.Lock()


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


# ── param sets ─────────────────────────────────────────────────────────


def _entries(params: dict) -> set:
    """A param set's ``key=value`` entries, volatile keys left out."""
    return {f"{k}={json.dumps(v, sort_keys=True, default=str)}"
            for k, v in (params or {}).items() if k not in VOLATILE_KEYS}


def jaccard_similarity(a: dict, b: dict) -> float:
    """Exact Jaccard of two param sets' entries; 1.0 when both are
    empty."""
    a_entries, b_entries = _entries(a), _entries(b)
    union = a_entries | b_entries
    if not union:
        return 1.0
    return len(a_entries & b_entries) / len(union)


def param_similarity(a: dict, b: dict) -> float:
    """Levenshtein ratio of two exec commands, Jaccard of the param sets
    otherwise."""
    a_cmd = a.get("command") if isinstance(a.get("command"), str) else ""
    b_cmd = b.get("command") if isinstance(b.get("command"), str) else ""
    if a_cmd and b_cmd:
        return levenshtein_ratio(a_cmd, b_cmd)
    return jaccard_similarity(a or {}, b or {})


def hash_entries(params: dict, dim: int = 1024) -> tuple:
    """Sorted unique bit indices of a param set's entries: crc32 of each
    entry modulo ``dim``. crc32, not the salted builtin ``hash()``, so a
    row hashes the same in every process and both packages read each
    other's persisted bits."""
    return tuple(sorted({zlib.crc32(e.encode("utf-8")) % dim
                         for e in _entries(params)}))


def multi_hot_rows(bit_rows: list, dim: int = 1024) -> np.ndarray:
    """{0, 1}^dim fp32 rows from per-row bit-index tuples."""
    X = np.zeros((len(bit_rows), dim), dtype=np.float32)
    for i, bits in enumerate(bit_rows):
        if bits:
            X[i, list(bits)] = 1.0
    return X


def hashed_multi_hot(param_sets: list, dim: int = 1024) -> np.ndarray:
    """One multi-hot row per param set."""
    return multi_hot_rows([hash_entries(p, dim) for p in param_sets], dim)


def jaccard_matrix(param_sets: list, others: Optional[list] = None,
                   dim: int = 1024, device: DeviceLike = None) -> np.ndarray:
    """Jaccard of hashed param sets: the full N×N block, or N×M against
    ``others``, from :func:`jaccard_from_rows` on ``device`` (default: the
    card). Hash collisions can only raise a similarity."""
    Xa = hashed_multi_hot(param_sets, dim)
    Xb = None if others is None else hashed_multi_hot(others, dim)
    return jaccard_from_rows(Xa, Xb, device=device)


# ── Jaccard ────────────────────────────────────────────────────────────


def _jaccard_block(Xa: torch.Tensor, Xb: torch.Tensor) -> torch.Tensor:
    """The Jaccard block of two padded multi-hot row batches on one device
    (``_jaccard_matrix_jax_impl``)."""
    inter = Xa @ Xb.T                       # small integers: exact in fp32
    union = Xa.sum(dim=1)[:, None] + Xb.sum(dim=1)[None, :] - inter
    ratio = (inter.double() / union.double()).float()
    return torch.where(union > 0, ratio, torch.ones_like(ratio))


def jaccard_from_rows(Xa: np.ndarray, Xb: Optional[np.ndarray] = None,
                      device: DeviceLike = None) -> np.ndarray:
    """Jaccard block from {0, 1} multi-hot rows (:func:`multi_hot_rows`);
    ``Xb=None`` is the symmetric Xa×Xa matrix. Both batch dimensions are
    bucketed to powers of two on the way in and sliced back, as the JAX
    path does. Returns an fp32 numpy array ``[len(Xa), len(Xb)]``.

    The block is always this torch product on ``device``; JAX routes
    blocks under 64 rows, and every block on a CPU backend, to numpy. The
    two agree bit for bit only because the rows are {0, 1} (every partial
    sum an exact small integer) and the ratio is a float64 quotient cast
    to fp32, which equals numpy's correctly rounded fp32 quotient."""
    dev = resolve_device(device)
    B = Xa if Xb is None else Xb
    na, nb = len(Xa), len(B)
    if na == 0 or nb == 0:
        return np.zeros((na, nb), dtype=np.float32)
    ta = torch.from_numpy(np.ascontiguousarray(
        pad_rows(np.asarray(Xa, np.float32), pow2_bucket(na)))).to(dev)
    if Xb is None:
        tb = ta
    else:
        tb = torch.from_numpy(np.ascontiguousarray(
            pad_rows(np.asarray(B, np.float32), pow2_bucket(nb)))).to(dev)
    return _jaccard_block(ta, tb)[:na, :nb].cpu().numpy()


# ── Levenshtein ────────────────────────────────────────────────────────


def levenshtein_distance(a: str, b: str) -> int:
    """The reference's scalar DP over the first ``LEVENSHTEIN_CAP``
    characters."""
    sa, sb = a[:LEVENSHTEIN_CAP], b[:LEVENSHTEIN_CAP]
    if sa == sb:
        return 0
    if not sa:
        return len(sb)
    if not sb:
        return len(sa)
    prev = list(range(len(sa) + 1))
    for i, cb in enumerate(sb, 1):
        curr = [i]
        for j, ca in enumerate(sa, 1):
            cost = 0 if cb == ca else 1
            curr.append(min(prev[j] + 1, curr[j - 1] + 1, prev[j - 1] + cost))
        prev = curr
    return prev[len(sa)]


def levenshtein_ratio(a: str, b: str) -> float:
    max_len = max(len(a[:LEVENSHTEIN_CAP]), len(b[:LEVENSHTEIN_CAP]))
    if max_len == 0:
        return 1.0
    return 1.0 - levenshtein_distance(a, b) / max_len


def tokenize_fixed(strings: list, length: int) -> np.ndarray:
    """``[N, length]`` int32: each string's UTF-8 bytes (the first
    ``length``) plus 1, 0 for padding."""
    out = np.zeros((len(strings), length), dtype=np.int32)
    for i, s in enumerate(strings):
        b = s[:LEVENSHTEIN_CAP].encode("utf-8", "replace")[:length]
        out[i, :len(b)] = np.frombuffer(b, dtype=np.uint8).astype(np.int32) + 1
    return out


def levenshtein_rows_reference(A: torch.Tensor, B: torch.Tensor,
                               len_a: torch.Tensor,
                               len_b: torch.Tensor) -> torch.Tensor:
    """The plain version of K3: distances ``[N]`` (int32) between the padded
    token rows ``A`` and ``B`` ``[N, L]`` over their first
    ``len_a``/``len_b`` tokens. The row DP over b,
    ``curr[j] = min(tent[j], curr[j-1] + 1)``, taken as
    ``cummin(tent - j) + j``; a row past b's length leaves the DP alone."""
    n, L = A.shape
    idx = torch.arange(L + 1, dtype=torch.int32, device=A.device)
    prev = idx.expand(n, L + 1).contiguous()
    tent = torch.empty_like(prev)
    for i in range(1, L + 1):
        cost = (A != B[:, i - 1:i]).int()
        tent[:, 0] = i
        torch.minimum(prev[:, 1:] + 1, prev[:, :-1] + cost, out=tent[:, 1:])
        curr = torch.cummin(tent - idx, dim=1).values + idx
        prev = torch.where((i <= len_b)[:, None], curr, prev)
    return prev.gather(1, len_a.long()[:, None])[:, 0]


def _check_rows(A, B, len_a, len_b) -> None:
    if A.dim() != 2 or A.shape != B.shape:
        raise ValueError(f"A {tuple(A.shape)} and B {tuple(B.shape)} must be "
                         "one [N, L] shape")
    if len_a.shape != (A.shape[0],) or len_b.shape != (A.shape[0],):
        raise ValueError("len_a and len_b must be [N]")
    ts = (A, B, len_a, len_b)
    if any(t.dtype != torch.int32 for t in ts):
        raise TypeError("levenshtein_rows takes int32 tensors")
    if len({t.device for t in ts}) != 1:
        raise ValueError("A, B, len_a and len_b must lie on one device")


def _launch(A, B, len_a, len_b) -> torch.Tensor:
    """K3 on CUDA tensors; adds one to :data:`launches` once the launch is
    accepted, or raises."""
    global launches
    from ._build import load_library

    n, L = A.shape
    A, B, len_a, len_b = (t.contiguous() for t in (A, B, len_a, len_b))
    out = torch.empty((n,), dtype=torch.int32, device=A.device)
    lib = load_library("levenshtein")
    # rows past one band of 1024 tokens pass 3 bits a column between bands
    words = lib.levenshtein_edge_words(n, L)
    edge = (torch.empty((words,), dtype=torch.int32, device=A.device)
            if words else None)
    with torch.cuda.device(A.device):
        err = lib.levenshtein_fwd(
            A.data_ptr(), B.data_ptr(), len_a.data_ptr(), len_b.data_ptr(),
            out.data_ptr(), None if edge is None else edge.data_ptr(), n, L,
            torch.cuda.current_stream(A.device).cuda_stream)
    if err != 0:
        raise DeviceError(
            f"levenshtein kernel launch failed: CUDA error {err} "
            f"({lib.levenshtein_error_string(err).decode()})")
    with _launch_lock:
        launches += 1
    return out


def levenshtein_rows(A: torch.Tensor, B: torch.Tensor, len_a: torch.Tensor,
                     len_b: torch.Tensor) -> torch.Tensor:
    """Distances ``[N]`` (int32) of the padded token rows ``A``, ``B``
    ``[N, L]`` (int32, tokens as a prefix of ``len_a``/``len_b``, 0 for
    padding) over their first ``len_a``/``len_b`` tokens: kernel K3 on a
    CUDA tensor, :func:`levenshtein_rows_reference` on a CPU tensor."""
    _check_rows(A, B, len_a, len_b)
    if A.device.type == "cuda":
        return _launch(A, B, len_a, len_b)
    if A.device.type != "cpu":
        raise ValueError(f"levenshtein_rows: unsupported device {A.device}")
    return levenshtein_rows_reference(A, B, len_a, len_b)


def batch_levenshtein_ratio(pairs: list, length: int = 128,
                            batched: Optional[bool] = None,
                            device: DeviceLike = None) -> np.ndarray:
    """Levenshtein ratios of string pairs as fp32 numpy ``[N]``.

    Routed as the JAX ``batch_levenshtein_ratio`` routes: fewer than 32
    pairs (or ``batched=False``) take the scalar path, exact up to the
    500-character cap; otherwise the batched DP over the first ``length``
    UTF-8 bytes, with the pair batch bucketed to a power of two on
    ``device`` (the card by default)."""
    if batched is None:
        batched = len(pairs) >= 32
    if not batched or not pairs:
        return np.array([levenshtein_ratio(a, b) for a, b in pairs],
                        dtype=np.float32)
    dev = resolve_device(device)
    A = tokenize_fixed([p[0] for p in pairs], length)
    B = tokenize_fixed([p[1] for p in pairs], length)
    len_a = (A > 0).sum(axis=1).astype(np.int32)
    len_b = (B > 0).sum(axis=1).astype(np.int32)
    bucket = pow2_bucket(len(pairs))

    def on_device(x: np.ndarray) -> torch.Tensor:
        x = pad_rows(x[:, None], bucket)[:, 0] if x.ndim == 1 \
            else pad_rows(x, bucket)
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    dist = levenshtein_rows(on_device(A), on_device(B), on_device(len_a),
                            on_device(len_b))[:len(pairs)].cpu().numpy()
    max_len = np.maximum(len_a, len_b)
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.where(max_len > 0, 1.0 - dist / max_len, 1.0)
    return ratio.astype(np.float32)
