"""The port's batched similarity twins against the JAX package's paths.

``ops/similarity.py`` of the port holds torch twins of the JAX package's two
jitted programs: the Jaccard block (``_jaccard_matrix_jax_impl``) and the
batched Levenshtein DP (``_batch_levenshtein_jax``), with the same pow2
bucketing. Both are integer-exact, so every comparison here is bit for bit
(the fp32 results viewed as int32), on the CPU:

- Jaccard against the JAX numpy formulation and the jitted JAX program,
  full and rectangular blocks, with the padded shapes each package hands its
  program equal;
- Levenshtein against the JAX numpy row DP, the jitted JAX program and the
  scalar ``levenshtein_ratio`` over the 128-byte window (past it the
  batched paths of both packages see the first 128 bytes only), routing and
  padded shapes equal;
- edge inputs: no rows, one row, N off a power of two, empty strings and
  strings past 128 bytes.
"""

from __future__ import annotations

import numpy as np
import pytest

from vainplex_openclaw_tpu.ops import similarity as jax_sim
from vainplex_openclaw_tpu_torch.ops import similarity as sim


def bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


def multi_hot(n: int, seed: int, dim: int = 1024) -> np.ndarray:
    rng = np.random.default_rng(seed)
    X = np.zeros((n, dim), np.float32)
    for i in range(n):
        X[i, rng.integers(0, 40, size=rng.integers(0, 10))] = 1.0
    if n > 2:
        X[n // 2] = 0.0  # an empty row: union 0 against other empties
    return X


def string_pairs(n: int, seed: int, max_len: int = 200) -> list:
    rng = np.random.default_rng(seed)

    def word() -> str:
        return "".join("acgt"[c] for c in rng.integers(
            0, 4, size=rng.integers(0, max_len + 1)))

    pairs = [(word(), word()) for _ in range(n)]
    if n > 2:
        pairs[0], pairs[1] = ("", ""), (pairs[2][0], pairs[2][0])
    return pairs


def shapes_of(monkeypatch, module, name: str) -> list:
    """Record the shapes of the first argument each call of
    ``module.name`` receives."""
    seen, real = [], getattr(module, name)

    def spy(*a, **kw):
        seen.append(tuple(np.asarray(a[0]).shape) if not hasattr(
            a[0], "shape") else tuple(a[0].shape))
        return real(*a, **kw)

    monkeypatch.setattr(module, name, spy)
    return seen


# ── Jaccard ─────────────────────────────────────────────────────────


@pytest.mark.parametrize("n", [1, 2, 5, 33, 64, 100])
def test_jaccard_symmetric_block_is_bit_identical(n, monkeypatch):
    X = multi_hot(n, seed=n)
    got = sim.jaccard_from_rows(X, device="cpu")
    want_np = jax_sim.jaccard_from_rows(X, use_jax=False)
    want_jax = jax_sim.jaccard_from_rows(X, use_jax=True)
    assert got.dtype == np.float32 and got.shape == (n, n)
    assert np.array_equal(bits(got), bits(want_np))
    assert np.array_equal(bits(got), bits(want_jax))
    port_shapes = shapes_of(monkeypatch, sim, "_jaccard_block")
    jax_shapes = shapes_of(monkeypatch, jax_sim, "_jaccard_matrix_jax")
    sim.jaccard_from_rows(X, device="cpu")
    jax_sim.jaccard_from_rows(X, use_jax=True)
    assert port_shapes == jax_shapes == [(sim.pow2_bucket(n), 1024)]


@pytest.mark.parametrize("na,nb", [(3, 17), (16, 512), (40, 1)])
def test_jaccard_rectangular_block_is_bit_identical(na, nb):
    Xa, Xb = multi_hot(na, seed=1), multi_hot(nb, seed=2)
    got = sim.jaccard_from_rows(Xa, Xb, device="cpu")
    assert got.shape == (na, nb)
    for use_jax in (False, True):
        want = jax_sim.jaccard_from_rows(Xa, Xb, use_jax=use_jax)
        assert np.array_equal(bits(got), bits(want))


def test_jaccard_of_no_rows_and_of_param_sets():
    """No rows give an empty block; rows hashed from tool-call param sets
    (the JAX package's ``hashed_multi_hot``, as its consumers build them)
    give JAX's ``jaccard_matrix`` and the scalar ``jaccard_similarity``."""
    empty = np.zeros((0, 1024), np.float32)
    assert sim.jaccard_from_rows(empty, device="cpu").shape == (0, 0)
    assert sim.jaccard_from_rows(multi_hot(3, 0), empty,
                                 device="cpu").shape == (3, 0)
    sets = [{"path": "/tmp/a", "mode": "r"}, {"path": "/tmp/a", "ts": 5},
            {}, {"cmd": ["ls", "-l"], "path": "/tmp/a", "mode": "r"}]
    got = sim.jaccard_from_rows(jax_sim.hashed_multi_hot(sets), device="cpu")
    want = jax_sim.jaccard_matrix(sets, use_jax=False)
    assert np.array_equal(bits(got), bits(want))
    scalar = np.array([[jax_sim.jaccard_similarity(a, b) for b in sets]
                       for a in sets], np.float32)
    assert np.array_equal(bits(got), bits(scalar))


def test_the_card_is_the_default():
    """No card here: the default device raises, it does not fall back."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sim.jaccard_from_rows(multi_hot(2, 0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sim.batch_levenshtein_ratio(string_pairs(40, 0))


# ── Levenshtein ─────────────────────────────────────────────────────


def numpy_ratio(pairs: list, length: int = 128) -> np.ndarray:
    """The JAX package's numpy row DP and ratio."""
    A = jax_sim._tokenize_fixed([a for a, _ in pairs], length)
    B = jax_sim._tokenize_fixed([b for _, b in pairs], length)
    la = (A > 0).sum(axis=1).astype(np.int32)
    lb = (B > 0).sum(axis=1).astype(np.int32)
    dist = jax_sim._batch_levenshtein_numpy(A, B, la, lb)
    max_len = np.maximum(la, lb)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(max_len > 0, 1.0 - dist / max_len,
                        1.0).astype(np.float32)


@pytest.mark.parametrize("n", [32, 33, 64, 100])
def test_levenshtein_batch_is_bit_identical(n, monkeypatch):
    pairs = string_pairs(n, seed=n)
    got = sim.batch_levenshtein_ratio(pairs, device="cpu")
    assert got.dtype == np.float32 and got.shape == (n,)
    assert np.array_equal(bits(got), bits(numpy_ratio(pairs)))
    assert np.array_equal(bits(got), bits(jax_sim.batch_levenshtein_ratio(
        pairs, use_jax=True)))
    window = np.array([jax_sim.levenshtein_ratio(a[:128], b[:128])
                       for a, b in pairs], np.float32)
    assert np.array_equal(bits(got), bits(window))
    port_shapes = shapes_of(monkeypatch, sim, "levenshtein_rows")
    jax_shapes = shapes_of(monkeypatch, jax_sim, "_batch_levenshtein_jax")
    sim.batch_levenshtein_ratio(pairs, device="cpu")
    jax_sim.batch_levenshtein_ratio(pairs, use_jax=True)
    assert port_shapes == jax_shapes == [(sim.pow2_bucket(n), 128)]


def test_levenshtein_short_lists_take_the_scalar_path(monkeypatch):
    """Under 32 pairs both packages take the scalar path, exact up to the
    500-character cap (strings past 128 bytes included)."""
    seen = shapes_of(monkeypatch, sim, "levenshtein_rows")
    for n in (0, 1, 31):
        pairs = string_pairs(n, seed=7, max_len=300)
        got = sim.batch_levenshtein_ratio(pairs)  # no device: no tensor
        want = jax_sim.batch_levenshtein_ratio(pairs)
        assert got.shape == (n,) and np.array_equal(bits(got), bits(want))
    assert seen == []
    assert sim.levenshtein_ratio("kitten", "sitting") == \
        jax_sim.levenshtein_ratio("kitten", "sitting")
    one = string_pairs(1, seed=3)
    assert np.array_equal(
        bits(sim.batch_levenshtein_ratio(one, batched=True, device="cpu")),
        bits(numpy_ratio(one)))


def test_levenshtein_past_the_window_and_multibyte():
    """Past 128 bytes (and with multi-byte characters) the batched paths
    of both packages agree bit for bit on the first 128 bytes."""
    rng = np.random.default_rng(11)
    pairs = [("é" * int(rng.integers(0, 120)) + "x" * int(rng.integers(0, 90)),
              "é" * int(rng.integers(0, 120)) + "y" * int(rng.integers(0, 90)))
             for _ in range(40)]
    got = sim.batch_levenshtein_ratio(pairs, device="cpu")
    assert np.array_equal(bits(got), bits(numpy_ratio(pairs)))
    assert np.array_equal(bits(got), bits(jax_sim.batch_levenshtein_ratio(
        pairs, use_jax=True)))
    assert np.array_equal(sim.tokenize_fixed([p[0] for p in pairs], 128),
                          jax_sim._tokenize_fixed([p[0] for p in pairs], 128))


def test_pow2_bucket_and_pad_rows_equal_jax():
    for n in (1, 2, 3, 31, 32, 33, 1000, 4096, 4097):
        assert sim.pow2_bucket(n) == jax_sim.pow2_bucket(n)
    X = multi_hot(5, 1)
    assert np.array_equal(sim.pad_rows(X, 8), jax_sim.pad_rows(X, 8))


# ── K3's plain version and wrapper on the CPU ───────────────────────


def test_levenshtein_rows_on_the_cpu_builds_nothing(monkeypatch):
    """A CPU tensor takes the plain version and never reaches the kernel
    build; the launch count stays put."""
    import torch

    from vainplex_openclaw_tpu_torch.ops import _build

    def refuse(*a, **kw):
        raise AssertionError("a CPU call touched the kernel build")

    monkeypatch.setattr(_build, "load_library", refuse)
    monkeypatch.setattr(_build, "build", refuse)
    before = sim.launches
    pairs = string_pairs(40, seed=4)
    got = sim.batch_levenshtein_ratio(pairs, device="cpu")
    assert np.array_equal(bits(got), bits(numpy_ratio(pairs)))
    A = torch.from_numpy(sim.tokenize_fixed([a for a, _ in pairs], 128))
    B = torch.from_numpy(sim.tokenize_fixed([b for _, b in pairs], 128))
    la, lb = (A > 0).sum(1).int(), (B > 0).sum(1).int()
    assert torch.equal(sim.levenshtein_rows(A, B, la, lb),
                       sim.levenshtein_rows_reference(A, B, la, lb))
    assert sim.launches == before


def test_padded_dp_reads_only_the_prefixes():
    """What K3 computes, the distance of the prefixes of lengths len_a and
    len_b, is what the padded DP computes: tokens past the lengths change
    nothing."""
    import torch

    pairs = string_pairs(64, seed=9)
    A = torch.from_numpy(sim.tokenize_fixed([a for a, _ in pairs], 128))
    B = torch.from_numpy(sim.tokenize_fixed([b for _, b in pairs], 128))
    la, lb = (A > 0).sum(1).int(), (B > 0).sum(1).int()
    clean = sim.levenshtein_rows_reference(A, B, la, lb)
    cols = torch.arange(128)[None, :]
    noise = torch.randint(1, 257, A.shape, generator=torch.Generator()
                          .manual_seed(0), dtype=torch.int32)
    A2 = torch.where(cols < la[:, None].long(), A, noise)
    B2 = torch.where(cols < lb[:, None].long(), B, noise.flip(0))
    assert torch.equal(sim.levenshtein_rows_reference(A2, B2, la, lb), clean)
    want = [jax_sim.levenshtein_distance(a[:128], b[:128]) for a, b in pairs]
    assert clean.tolist() == want


def test_levenshtein_rows_checks_its_inputs():
    import torch

    A = torch.zeros((4, 8), dtype=torch.int32)
    n = torch.zeros((4,), dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        sim.levenshtein_rows(A.long(), A, n, n)
    with pytest.raises(ValueError, match="one"):
        sim.levenshtein_rows(A, A[:, :4], n, n)
    with pytest.raises(ValueError, match=r"\[N\]"):
        sim.levenshtein_rows(A, A, n[:3], n)
