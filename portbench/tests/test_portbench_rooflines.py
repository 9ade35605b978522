"""The yardstick's arithmetic against hand counts at the cells' shapes."""

import pytest

from portbench import rooflines as R

TINY = {"vocab_size": 2048, "seq_len": 64, "d_model": 64, "n_heads": 4,
        "n_layers": 2, "d_ff": 256}
LONG = {"vocab_size": 512, "seq_len": 16384, "d_model": 32, "n_heads": 2,
        "n_layers": 2, "d_ff": 64}


@pytest.mark.parametrize("B,H,L,Dh,stats,want_bytes,want_ops,by", [
    # serve: q, k, v, out 4 x 32*4*64*16 bf16 + bias 32*64 fp32
    (32, 4, 64, 16, False, 4 * 32 * 4 * 64 * 16 * 2 + 32 * 64 * 4,
     4 * 32 * 4 * 64 * 64 * 16, "bytes"),
    # the triage bucket
    (16384, 4, 64, 16, False, 4 * 16384 * 4 * 64 * 16 * 2 + 16384 * 64 * 4,
     4 * 16384 * 4 * 64 * 64 * 16, "bytes"),
    # K2 at L=16384: fp32 acc and fp32 m, l out
    (8, 2, 16384, 16, True,
     3 * 8 * 2 * 16384 * 16 * 2 + 8 * 16384 * 4 + 8 * 2 * 16384 * 16 * 4
     + 2 * 8 * 2 * 16384 * 4,
     4 * 8 * 2 * 16384 * 16384 * 16, "operations"),
])
def test_attention_bound_hand_counts(B, H, L, Dh, stats, want_bytes,
                                     want_ops, by):
    b = R.attention_bound(B, H, L, L, Dh, 2, stats)
    assert b["bytes"] == want_bytes
    assert b["operations"] == want_ops
    assert b["bound_by"] == by
    want_ms = max(want_bytes / 3.35e12, want_ops / 989e12) * 1e3
    assert b["bound_ms"] == pytest.approx(want_ms, rel=1e-12)


def test_published_bounds_of_the_kernel_table():
    # PERF.md's kernel table: serve 0.000315, triage 0.1615, L=16384 0.2779
    assert R.attention_bound(32, 4, 64, 64, 16, 2, False)["bound_ms"] \
        == pytest.approx(0.000315, rel=5e-3)
    assert R.attention_bound(16384, 4, 64, 64, 16, 2, False)["bound_ms"] \
        == pytest.approx(0.1615, rel=5e-3)
    assert R.attention_bound(8, 2, 16384, 16384, 16, 2, True)["bound_ms"] \
        == pytest.approx(0.2779, rel=5e-3)


def test_rows_bound_sums_rows_then_bounds():
    rows = [64] * 32
    one = R.attention_bound(32, 4, 64, 64, 16, 2, False)
    got = R.rows_attention_bound(rows, TINY, stats=False)
    assert got["bytes"] == 2 * one["bytes"]        # two layers
    assert got["operations"] == 2 * one["operations"]
    mixed = R.rows_attention_bound([10, 60, 16000], LONG, stats=True)
    assert mixed["operations"] == 2 * sum(4 * 2 * n * n * 16
                                          for n in (10, 60, 16000))


@pytest.mark.parametrize("n,widths,want", [
    # 2 layers x (8 n D^2 + 4 n D F + 4 n^2 D) + heads 2 D (11 + D)
    (64, TINY, 2 * (8 * 64 * 64 * 64 + 4 * 64 * 64 * 256
                    + 4 * 64 * 64 * 64) + 2 * 64 * 75),
    (1, TINY, 2 * (8 * 64 * 64 + 4 * 64 * 256 + 4 * 64) + 2 * 64 * 75),
    (16384, LONG, 2 * (8 * 16384 * 32 * 32 + 4 * 16384 * 32 * 64
                       + 4 * 16384 * 16384 * 32) + 2 * 32 * 43),
])
def test_encoder_flops_hand_counts(n, widths, want):
    assert R.encoder_flops(n, widths) == want


def test_tiny_forward_is_about_023_mflop_per_token():
    assert R.encoder_flops(64, TINY) / 64 == pytest.approx(0.23e6, rel=0.01)
