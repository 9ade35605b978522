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
  strings past 128 bytes;
- lengths 512 (the trace analyzer's doom-loop detector) and 2048 (500
  characters of 4-byte UTF-8) against the JAX numpy DP;
- K3's bit-parallel recurrence (``csrc/levenshtein.cu``), which cannot run
  here, as a word-level model on 32-bit Python ints in the kernel's order
  (bands, carry-lookahead, shifted bits), held against the plain version
  and JAX's scalar DP at lengths on and around the word edges.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest

from vainplex_openclaw_tpu.ops import similarity as jax_sim
from vainplex_openclaw_tpu_torch.ops import similarity as sim

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402  (its top level imports only the standard library)
from test_torch_chip_smoke_bounds import one_torch_thread  # noqa: E402,F401


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


# ── param sets ──────────────────────────────────────────────────────

PARAM_SETS = [
    {}, {"command": "ls -la"}, {"command": "ls -la", "timeout": 30},
    {"command": "ls -l", "ts": 1, "timestamp": "2024"},
    {"path": "/tmp/a", "mode": "r"}, {"path": "/tmp/a", "mode": "w"},
    {"cmd": ["ls", {"deep": [1, 2.5, None]}], "path": "/tmp/a"},
    {"command": "echo 'déploiement échoué' ✓", "cwd": "/srv"},
    {"command": "echo 'déploiement échoue'", "cwd": "/srv"},
    {"command": "", "cwd": "/srv"}, {"command": 7, "cwd": "/srv"},
    {"timeout": 5}, {"ts": 1, "timestamp": 2}, {"set": {1, 2}},
    {"nested": {"b": 1, "a": [True, False]}},
    {"nested": {"a": [True, False], "b": 1}},
]


def test_param_similarities_equal_jax():
    """Volatile keys, nested values (key order ignored), non-ASCII, empty
    and volatile-only sets: the exact scalars, pair for pair."""
    assert sim.VOLATILE_KEYS == jax_sim.VOLATILE_KEYS
    for a in PARAM_SETS:
        for b in PARAM_SETS:
            assert sim.jaccard_similarity(a, b) == \
                jax_sim.jaccard_similarity(a, b)
            assert sim.param_similarity(a, b) == jax_sim.param_similarity(a, b)
    assert sim.jaccard_similarity({}, {"ts": 3}) == 1.0
    assert sim.jaccard_similarity(None, None) == 1.0


@pytest.mark.parametrize("dim", [1024, 64, 7])
def test_hashed_rows_equal_jax(dim):
    for p in PARAM_SETS:
        assert sim.hash_entries(p, dim) == jax_sim.hash_entries(p, dim)
    bit_rows = [sim.hash_entries(p, dim) for p in PARAM_SETS] + [()]
    assert np.array_equal(sim.multi_hot_rows(bit_rows, dim),
                          jax_sim.multi_hot_rows(bit_rows, dim))
    got = sim.hashed_multi_hot(PARAM_SETS, dim)
    assert got.dtype == np.float32 and got.shape == (len(PARAM_SETS), dim)
    assert np.array_equal(got, jax_sim.hashed_multi_hot(PARAM_SETS, dim))
    assert sim.hash_entries({"ts": 1, "timeout": 2}, dim) == ()


@pytest.mark.parametrize("others", [None, slice(3, 11), slice(0, 1)])
@pytest.mark.parametrize("use_jax", [False, True])
def test_jaccard_matrix_is_bit_identical(others, use_jax):
    """Square and rectangular blocks against JAX's numpy and jax paths."""
    rng = np.random.default_rng(5)
    sets = [PARAM_SETS[i] for i in rng.integers(0, len(PARAM_SETS), 70)]
    other = None if others is None else PARAM_SETS[others]
    got = sim.jaccard_matrix(sets, other, device="cpu")
    want = jax_sim.jaccard_matrix(sets, other, use_jax=use_jax)
    assert got.shape == (70, 70 if other is None else len(other))
    assert np.array_equal(bits(got), bits(want))
    assert sim.jaccard_matrix([], device="cpu").shape == (0, 0)


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


@pytest.mark.parametrize("length,n", [(512, 32), (512, 45), (2048, 32)])
def test_levenshtein_past_512_is_bit_identical(length, n, one_torch_thread):
    """At the detector's length (512) and past it (2048: 500 characters of
    4-byte UTF-8 are 2000 bytes), on the pairs of chip_smoke's legs there,
    the port's batched path equals the JAX package's numpy DP bit for bit. At 512 the commands are ASCII, so the
    JAX package's ``use_jax=False`` path (the scalar DP over characters)
    gives the same ratios; over multibyte text it counts characters, not
    the batch's bytes, so at 2048 the numpy DP is the reference."""
    pairs = (chip_smoke.detector_pairs(n, seed=n) if length == 512
             else chip_smoke.multibyte_pairs(n, seed=n))
    got = sim.batch_levenshtein_ratio(pairs, length=length, device="cpu")
    assert got.shape == (n,)
    assert np.array_equal(bits(got), bits(numpy_ratio(pairs, length)))
    if length == 512:
        assert all(a.isascii() and b.isascii() for a, b in pairs)
        assert np.array_equal(bits(got), bits(jax_sim.batch_levenshtein_ratio(
            pairs, length=length, use_jax=False)))
    else:
        A = sim.tokenize_fixed([a for a, _ in pairs], length)
        assert (A > 0).sum(axis=1).max() == 2000  # 63 words of 32 tokens
    assert len(np.unique(got)) > n // 2


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


# ── K3's bit-parallel recurrence, word by word ──────────────────────

M32 = 0xFFFFFFFF
K3_LENGTHS = (0, 1, 31, 32, 33, 63, 64, 65, 127, 128, 500, 511, 512)


def k3_band_words(L: int) -> int:
    """``band_words`` in ``csrc/levenshtein.cu``."""
    words = (L + 31) // 32
    return 4 if words <= 4 else 16 if words <= 16 else 32


def k3_model(a_row, b_row, la: int, lb: int, L: int) -> int:
    """K3's arithmetic on 32-bit words, in the kernel's order: bands of
    ``k3_band_words(L)`` words taken one after the other over all of b,
    each column's Eq from a's first ``la`` tokens (the kernel reads 0 past
    them), the add's carries into the words from the ballots of generate
    (g) and propagate (p) as ``((G | P) + G + carry_in) ^ P`` (held
    against the carry rippled word by word), the shifts' top bits from the
    word below, and 3 bits a column (carry, HP and HN shifted in) from the
    band below. The distance is len_b plus the last column's vertical
    deltas (VP's bits less VN's below len_a), held against the score kept
    along a's last row."""
    la, lb = min(max(la, 0), L), min(max(lb, 0), L)
    if la == 0 or lb == 0:
        return la + lb
    kw = k3_band_words(L)
    words = (la + 31) // 32
    a = [int(t) if i < la else 0 for i, t in enumerate(a_row[:words * 32])]
    a += [0] * (words * 32 - len(a))
    edge = [(0, 1, 0)] * lb  # the first band: carry 0, HP 1, HN 0
    score = la  # along a's last row, column by column
    column = lb  # down the last column: the kernel's count
    for w0 in range(0, words, kw):
        wb = min(kw, words - w0)
        final = w0 + wb == words
        peq: dict = {}
        for k in range(wb):
            for i in range(32):
                t = a[(w0 + k) * 32 + i]
                peq.setdefault(t, [0] * wb)[k] |= 1 << i
        vp, vn = [M32] * wb, [0] * wb
        out_edge = []
        for j in range(lb):
            eq = peq.get(int(b_row[j]), [0] * wb)
            cin, hp_in, hn_in = edge[j]
            s = [(eq[k] & vp[k]) + vp[k] for k in range(wb)]
            G = sum((s[k] >> 32) << k for k in range(wb))
            P = sum(((s[k] & M32) == M32) << k for k in range(wb))
            carries = ((G | P) + G + cin) ^ P
            ripple = cin
            hp, hn = [0] * wb, [0] * wb
            for k in range(wb):
                ck = (carries >> k) & 1
                assert ck == ripple  # the lookahead is the rippled carry
                total = s[k] + ck
                ripple = total >> 32
                xh = ((total & M32) ^ vp[k]) | eq[k]
                hp[k] = (vn[k] | ~(xh | vp[k])) & M32
                hn[k] = vp[k] & xh
            if final:
                word, bit = divmod(la - 1 - w0 * 32, 32)
                score += ((hp[word] >> bit) & 1) - ((hn[word] >> bit) & 1)
            out_edge.append(((carries >> kw) & 1, hp[wb - 1] >> 31,
                             hn[wb - 1] >> 31))
            for k in range(wb):
                hp_low = hp[k - 1] >> 31 if k else hp_in
                hn_low = hn[k - 1] >> 31 if k else hn_in
                xv = eq[k] | vn[k]
                hps = ((hp[k] << 1) | hp_low) & M32
                hns = ((hn[k] << 1) | hn_low) & M32
                vp[k] = (hns | ~(xv | hps)) & M32
                vn[k] = hps & xv
        edge = out_edge
        for k in range(wb):
            valid = (1 << min(max(la - (w0 + k) * 32, 0), 32)) - 1
            column += (bin(vp[k] & valid).count("1")
                       - bin(vn[k] & valid).count("1"))
    assert column == score
    return column


def k3_case(la: int, lb: int, L: int, seed: int, alphabet: int = 4):
    """Rows ``[1, L]`` of width L: a is ``la`` tokens of a small alphabet
    (0 among them), b a near-duplicate of a's prefix (or a and a tail) with
    a few substitutions; arbitrary int32 noise past both lengths."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, alphabet, size=la)
    b = np.concatenate([a[:lb], rng.integers(0, alphabet, size=max(
        lb - la, 0))])
    flips = rng.random(lb) < 0.1
    b[flips] = rng.integers(0, alphabet, size=int(flips.sum()))
    A = rng.integers(-2**31, 2**31, size=(1, L), dtype=np.int64)
    B = rng.integers(-2**31, 2**31, size=(1, L), dtype=np.int64)
    A[0, :la], B[0, :lb] = a, b
    return A.astype(np.int32), B.astype(np.int32)


def k3_check(A, B, la: int, lb: int) -> int:
    """The model against the plain version, the JAX package's numpy DP
    (any length) and JAX's scalar DP where it is not capped; returns the
    distance."""
    import torch

    L = A.shape[1]
    got = k3_model(A[0].tolist(), B[0].tolist(), la, lb, L)
    want = sim.levenshtein_rows_reference(
        torch.from_numpy(A), torch.from_numpy(B),
        torch.tensor([la], dtype=torch.int32),
        torch.tensor([lb], dtype=torch.int32))
    assert got == int(want[0])
    assert got == int(jax_sim._batch_levenshtein_numpy(
        A, B, np.array([la], np.int32), np.array([lb], np.int32))[0])
    if max(la, lb) <= jax_sim.LEVENSHTEIN_CAP:
        text = lambda row, n: "".join(chr(0x100 + int(t)) for t in row[:n])
        assert got == jax_sim.levenshtein_distance(text(A[0], la),
                                                   text(B[0], lb))
    return got


@pytest.mark.parametrize("la", K3_LENGTHS)
@pytest.mark.parametrize("lb", K3_LENGTHS)
def test_k3_recurrence_equals_the_dp(la, lb):
    """K3's word-level recurrence at lengths on and around its word edges,
    with noise past both lengths, equals the plain version and JAX's
    scalar DP."""
    A, B = k3_case(la, lb, 512, seed=1000 * la + lb)
    k3_check(A, B, la, lb)


@pytest.mark.parametrize("n", [1, 31, 64, 500, 512])
def test_k3_recurrence_of_equal_and_empty_strings(n):
    A, B = k3_case(n, n, 512, seed=n, alphabet=256)
    B[0, :n] = A[0, :n]
    assert k3_check(A, B, n, n) == 0
    assert k3_check(A, B, n, 0) == n and k3_check(A, B, 0, n) == n


@pytest.mark.parametrize("la,lb", [(1025, 700), (1100, 1024), (2000, 1990)])
def test_k3_recurrence_across_bands(la, lb):
    """Past 1024 tokens of a the kernel takes a in bands of 32 words and
    passes each column's carry and shifted bits between them."""
    A, B = k3_case(la, lb, 2048, seed=la + lb)
    assert k3_band_words(2048) == 32 and la > 32 * 32
    k3_check(A, B, la, lb)
