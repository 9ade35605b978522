"""chip_smoke.py's arithmetic and inputs, on the CPU.

``attention_bound`` gives the least time the card could take for one
attention launch (the guide's bound) and the floor that its exponentials
set; it is pinned here against hand counts at the two serve shapes.
``ptxas_report`` reads the compiler's register, shared memory and spill
lines, ``make_qkv`` makes the masks of the kernel cases, and ``k1_errors``
is the check K1 is held to, which must fail a plain version that dropped a
key tile at the long shape. ``levenshtein_bound`` counts K3's word steps
and ``check_bound`` fails a reading faster than it; the similarity legs'
pairs reach the word edges. The lifecycle phase's ``version_audit``
counts dropped and mis-versioned tickets against each stamp's oracle,
``swap_protocol`` stamps and serves as the phase expects, the negated twin
flips every verdict, and the K1 count it expects per mesh batch is the
runner's formula. The search phases' helpers: the point's parity bound
and measure, the launch count, the shapes each searched tile is held at,
the rows one card may write, and the rows every run agreed on.
chip_smoke's top level
imports only the standard library, so importing it here runs nothing.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

from vainplex_openclaw_tpu_torch.ops.flash_attention import (  # noqa: E402
    SUPPORTED_HEAD_DIMS, flash_attention_reference)


def test_k2_long_shape_hand_counts():
    """K2 at B=8, H=2, L=16384, Dh=16, bf16."""
    b = chip_smoke.attention_bound(8, 2, 16384, 16384, 16, 2, stats=True)
    assert b["operations"] == 274_877_906_944        # 4·B·H·L²·Dh
    assert b["bytes"] == (3 * 8 * 2 * 16384 * 16 * 2  # q, k, v in bf16
                          + 8 * 2 * 16384 * 16 * 4   # acc in fp32
                          + 2 * 8 * 2 * 16384 * 4    # m and l in fp32
                          + 8 * 16384 * 4)           # the bias row
    assert b["bytes"] == 44_564_480
    assert b["exponentials"] == 4_294_967_296        # B·H·L²
    assert b["exp_floor_ms"] == pytest.approx(1.1013, abs=1e-4)
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == pytest.approx(0.277935, abs=1e-6)


def test_k1_serve_shape_hand_counts():
    """K1 at B=32, H=4, L=64, Dh=16, bf16: bound by bytes."""
    b = chip_smoke.attention_bound(32, 4, 64, 64, 16, 2, stats=False)
    assert b["bytes"] == 4 * 32 * 4 * 64 * 16 * 2 + 32 * 64 * 4 == 1_056_768
    assert b["operations"] == 4 * 32 * 4 * 64 * 64 * 16
    assert b["exponentials"] == 32 * 4 * 64 * 64
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(0.000315453, abs=1e-9)


def test_k1_long_shape_has_the_same_work_as_k2():
    """K1 and K2 at the long shape differ only in what they write."""
    k1 = chip_smoke.attention_bound(8, 2, 16384, 16384, 16, 2, stats=False)
    k2 = chip_smoke.attention_bound(8, 2, 16384, 16384, 16, 2, stats=True)
    assert k1["operations"] == k2["operations"]
    assert k1["exponentials"] == k2["exponentials"]
    assert k1["exp_floor_ms"] == k2["exp_floor_ms"]
    assert k2["bytes"] - k1["bytes"] == (8 * 2 * 16384 * 16 * (4 - 2)
                                         + 2 * 8 * 2 * 16384 * 4)


@pytest.mark.parametrize("shape", [(1, 1, 1, 1, 16), (3, 2, 100, 129, 32),
                                   (2, 4, 96, 200, 64), (4, 16, 2048, 2048, 64)])
@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("elem", [2, 4])
def test_bound_is_the_larger_of_bytes_and_operations(shape, stats, elem):
    B, H, Lq, Lk, Dh = shape
    b = chip_smoke.attention_bound(B, H, Lq, Lk, Dh, elem, stats=stats)
    t_bytes = b["bytes"] / chip_smoke.HBM_BYTES_PER_S * 1e3
    t_ops = b["operations"] / chip_smoke.PEAK_BF16_OPS_PER_S * 1e3
    assert b["bound_ms"] == max(t_bytes, t_ops)
    assert b["bound_by"] == ("bytes" if t_bytes >= t_ops else "operations")
    assert b["exp_floor_ms"] == pytest.approx(
        B * H * Lq * Lk / chip_smoke.SFU_EXP_PER_S * 1e3)


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__86df54c7_18_flash_attention_cu_2c1389793mma13flash_fwd_mmaILi32ELb0ELb1EEEvPK13__nv_bfloat16S4_S4_PKfPvPfS8_iiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__86df54c7_18_flash_attention_cu_2c1389793mma13flash_fwd_mmaILi32ELb0ELb1EEEvPK13__nv_bfloat16S4_S4_PKfPvPfS8_iiiif
    8 bytes stack frame, 8 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers, 24576 bytes smem, 8 bytes cumulative stack size
ptxas info    : Compile time = 60.425 ms
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__86df54c7_18_flash_attention_cu_2c1389796scalar14flash_fwd_fp32ILi128ELb1ELb0EEEvPKfS3_S3_S3_PfS4_S4_iiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__86df54c7_18_flash_attention_cu_2c1389796scalar14flash_fwd_fp32ILi128ELb1ELb0EEEvPKfS3_S3_S3_PfS4_S4_iiiif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 400 bytes cmem[0]
"""


def test_ptxas_report_reads_each_instantiation():
    report = chip_smoke.ptxas_report(PTXAS_LOG)
    assert report == [
        {"kernel": "flash_fwd_mma", "dh": 32, "causal": False, "stats": True,
         "registers": 96, "smem_bytes": 24576, "spill_stores": 8,
         "spill_loads": 16},
        {"kernel": "flash_fwd_fp32", "dh": 128, "causal": True,
         "stats": False, "registers": 255, "smem_bytes": None,
         "spill_stores": 0, "spill_loads": 0}]


def test_ptxas_report_of_an_empty_log_is_empty():
    assert chip_smoke.ptxas_report("") == []


@pytest.mark.parametrize("kind", ["prefix", "last_tile", "holes"])
@pytest.mark.parametrize("Lk", [63, 64, 65, 129, 200])
def test_make_qkv_masks(kind, Lk):
    B, H, Lq, Dh = 4, 2, 70, 16
    q, k, v, mask = chip_smoke.make_qkv(np.random.default_rng(Lk), B, H, Lq,
                                        Lk, Dh, torch.bfloat16, kind, "cpu")
    assert q.shape == (B, H, Lq, Dh) and k.shape == v.shape == (B, H, Lk, Dh)
    assert q.dtype == torch.bfloat16
    m = mask.numpy()
    assert m.shape == (B, Lk) and m.dtype == bool
    assert not m[-1].any()  # the batcher's zero-pad row
    live = m[:-1]
    assert live.any(axis=1).all() or kind == "holes"
    if kind == "prefix":
        assert m[0].all()
        for row in live:
            n = int(row.sum())
            assert row[:n].all() and not row[n:].any()
    elif kind == "last_tile":
        first = (Lk - 1) // 64 * 64
        assert not live[:, :first].any() and live[:, first:].all()
    else:
        assert not live[:, 0].any()
        assert any(row.any() and not row[:int(row.sum())].all()
                   for row in live), "holes mask is a prefix"


def test_make_qkv_without_a_mask():
    *_, mask = chip_smoke.make_qkv(np.random.default_rng(0), 2, 1, 8, 8, 16,
                                   torch.float32, False, "cpu")
    assert mask is None


@pytest.mark.parametrize("case", chip_smoke.KERNEL_CASES + chip_smoke.STATS_CASES,
                         ids=lambda c: c[0])
def test_kernel_cases_are_shapes_the_kernel_takes(case):
    _, B, H, Lq, Lk, Dh, causal, kind = case
    assert min(B, H, Lq, Lk) >= 1 and Dh in SUPPORTED_HEAD_DIMS
    assert Lq == Lk or not causal
    assert kind in (False, "prefix", "last_tile", "holes")


def test_k1_errors_of_equal_outputs_are_zero():
    x = torch.randn(2, 2, 8, 16).to(torch.bfloat16)
    assert chip_smoke.k1_errors(x, x.clone(), "bfloat16") == (0.0, 0.0, 0.0)


def test_k1_errors_scale_each_row_by_its_largest_value():
    ref = torch.tensor([[[[1.0, -4.0], [0.01, 0.02]]]])
    out = ref + torch.tensor([[[[0.0, 0.04], [0.001, 0.0]]]])
    err, rel, held = chip_smoke.k1_errors(out, ref, "bfloat16")
    assert err == pytest.approx(0.04)
    assert rel == pytest.approx(0.05)     # 0.001 / 0.02 in the second row
    assert held == rel
    assert chip_smoke.k1_errors(out, ref, "float32")[2] == err


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_k1_check_fails_a_dropped_key_tile_at_16384_keys(dtype):
    """A row that averages 16384 keys has |out| ~ 0.01. The plain version
    without its first key tile must fail the check the card holds K1 to
    (in bf16 it stays within an absolute 3e-2, so only the per-row
    relative check sees it), while the same function computed in another
    order (float64, p rounded the same way) passes with room."""
    tdt = getattr(torch, dtype)
    tol = chip_smoke.TOL[dtype]
    q, k, v, _ = chip_smoke.make_qkv(np.random.default_rng(7), 1, 2, 128,
                                     16384, 16, tdt, False, "cpu")
    ref = flash_attention_reference(q, k, v)
    dropped = flash_attention_reference(q, k[:, :, 64:].contiguous(),
                                        v[:, :, 64:].contiguous())
    err, _, held = chip_smoke.k1_errors(dropped, ref, dtype)
    assert held > 3 * tol
    if dtype == "bfloat16":
        assert err <= tol
    s = q.double() @ k.double().transpose(-1, -2) / 4
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    other = ((p.to(tdt).double() @ v.double())
             / p.sum(dim=-1, keepdim=True)).to(tdt)
    assert chip_smoke.k1_errors(other, ref, dtype)[2] <= tol / 3


def test_every_long_k1_case_gets_the_control():
    controlled = {c[0] for c in chip_smoke.KERNEL_CASES
                  if c[4] >= chip_smoke.CONTROL_MIN_LK and not c[6]}
    assert {"mfu_shape", "long_16384", "long_16384_masked"} <= controlled
    assert any(c[4] == 16384 and c[7] is False
               for c in chip_smoke.KERNEL_CASES)


def test_kernel_cases_reach_the_tile_edges():
    """The card checks cover Lk one below, at and one above a 64-key tile
    multiple, Lq off the 64-row tile, causal at L=130 with Dh 16 and 128,
    and masks valid only in the last tile or with holes."""
    for cases in (chip_smoke.KERNEL_CASES, chip_smoke.STATS_CASES):
        lks = {c[4] for c in cases}
        assert {63, 65, 129} <= lks
        assert any(c[3] % 64 for c in cases)
        assert {(130, 16), (130, 128)} <= {(c[3], c[5]) for c in cases
                                           if c[6]}
        assert {"last_tile", "holes"} <= {c[7] for c in cases}
    assert {63, 64, 65, 127, 128, 129} <= {c[4] for c in chip_smoke.KERNEL_CASES}


def test_k1_training_shape_hand_counts():
    """K1 at the recipe's training shape, B=64, H=4, L=64, Dh=16, bf16."""
    b = chip_smoke.attention_bound(64, 4, 64, 64, 16, 2, stats=False)
    assert b["bytes"] == 4 * 64 * 4 * 64 * 16 * 2 + 64 * 64 * 4
    assert b["bytes"] == 2_113_536
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(0.000631, abs=1e-6)
    assert b["exponentials"] == 1_048_576  # B·H·L·L
    # the serve row's exponentials, which the measured ex2 rate turns
    # into its floor
    assert chip_smoke.attention_bound(32, 4, 64, 64, 16, 2, False)[
        "exponentials"] == 524_288


class _Evt:
    def __init__(self, key, device_type, us, count=1):
        from torch.autograd import DeviceType

        self.key, self.count = key, count
        self.device_type = getattr(DeviceType, device_type)
        self.self_device_time_total = us


class _Prof:
    def __init__(self, events):
        self.events = events

    def key_averages(self):
        return self.events


def test_device_rows_count_each_kernel_once():
    """A host op's device time repeats its kernels' time; only the device
    events are summed."""
    prof = _Prof([_Evt("aten::index_put_", "CPU", 1700.0),
                  _Evt("indexing_backward_kernel", "CUDA", 1650.0),
                  _Evt("Memcpy HtoD", "CUDA", 50.0, count=4),
                  _Evt("aten::empty", "CPU", 0.0)])
    rows = chip_smoke.device_rows(prof)
    assert sorted(r[1] for r in rows) == ["Memcpy HtoD",
                                          "indexing_backward_kernel"]
    busy = chip_smoke.device_busy(prof, wall_s=0.017)
    assert busy["device_ms"] == pytest.approx(1.7)
    assert busy["busy_share"] == pytest.approx(0.1)


def test_training_phase_inputs_are_the_recipe_and_repo_configs():
    from vainplex_openclaw_tpu_torch.models.pretrained import TINY_CONFIG

    batch = chip_smoke.tiny_batch(TINY_CONFIG)
    assert batch["tokens"].shape == (64, TINY_CONFIG.seq_len)
    assert chip_smoke.TRAIN_STEPS == 600
    assert chip_smoke.MOE_WIDTHS == dict(vocab_size=512, seq_len=32,
                                         d_model=64, n_heads=4, n_layers=2,
                                         d_ff=128, n_experts=4)
    findings = chip_smoke.triage_findings(64, seed=31)
    facts = chip_smoke.seeded_facts(8, seed=2)
    assert len({f.severity for f in findings}) == 5
    assert [f.id for f in facts] == [f"f{i}" for i in range(8)]
    assert all(f.summary for f in findings)
    assert 0 < sum(bool(f.evidence) for f in findings) < len(findings)


def test_triage_findings_split_the_keep_head_and_the_control_moves_it():
    """On the CPU: the shipped keep head keeps some of the triage phase's
    findings and drops some, and uniform attention moves its logits past
    the phase's tolerance."""
    from vainplex_openclaw_tpu_torch.cortex.trace_analyzer.classifier import (
        keep_logits)
    from vainplex_openclaw_tpu_torch.models import encoder

    findings = chip_smoke.triage_findings(64, seed=31)
    host = keep_logits(findings, device="cpu")
    kept = int(host.argmax(dim=-1).sum())
    assert len(findings) // 8 <= kept <= len(findings) * 7 // 8
    real = encoder.flash_attention
    try:
        encoder.flash_attention = lambda q, k, v, mask=None, **kw: real(
            torch.zeros_like(q), k, v, mask, **kw)
        control = keep_logits(findings, device="cpu")
    finally:
        encoder.flash_attention = real
    assert float((control - host).abs().max()) > 10 * chip_smoke.TRIAGE_TOL


# ── sharded training, the MoE long path and K3 ──────────────────────


@pytest.mark.parametrize("axes,shape,per_forward,k1_shape", [
    (("dp", "tp"), (2, 2), 2 * 2 * 2, (32, 2, 64, 16)),   # tiny 2x2
    (("dp", "tp"), (1, 4), 2 * 1 * 4, (64, 1, 64, 16)),   # tiny 1x4
    (("dp", "tp"), (1, 8), 2 * 1 * 4, (64, 1, 64, 16)),   # tp above heads
    (("dp", "ep"), (2, 2), 2 * 2, (32, 4, 64, 16)),       # ep: whole rows
])
def test_mesh_k1_formula_and_shard_shape(axes, shape, per_forward,
                                         k1_shape):
    """At ``triage-tiny`` (4 heads of 16, 2 layers) and batch 64."""
    from vainplex_openclaw_tpu_torch.models.pretrained import TINY_CONFIG

    assert chip_smoke.mesh_k1_per_forward(TINY_CONFIG, axes,
                                          shape) == per_forward
    assert chip_smoke.mesh_k1_shape(TINY_CONFIG, 64, axes,
                                    shape) == k1_shape


def test_train_mesh_shard_shapes_are_kernel_cases():
    """Every K1 shape train_mesh launches is a case the kernels phase holds
    against the plain version, and the MoE long path's K2 block is a stats
    case; the training shard shapes' bounds by hand."""
    from vainplex_openclaw_tpu_torch.models.encoder import EncoderConfig
    from vainplex_openclaw_tpu_torch.models.pretrained import TINY_CONFIG

    k1 = {c[1:6] for c in chip_smoke.KERNEL_CASES}
    moe = EncoderConfig(**chip_smoke.MOE_WIDTHS)
    graft = EncoderConfig(**chip_smoke.GRAFT_DENSE)
    for _, widths, _, axes, shape in chip_smoke.TRAIN_MESH_SETTINGS:
        cfg = TINY_CONFIG if widths == "tiny" else moe
        B, H, L, Dh = chip_smoke.mesh_k1_shape(
            cfg, chip_smoke.TRAIN_MESH_BATCH, axes, shape)
        assert (B, H, L, L, Dh) in k1
    B, H, L, Dh = chip_smoke.mesh_k1_shape(graft, 4, ("dp", "tp"), (2, 2))
    assert (B, H, L, L, Dh) == (2, 4, 64, 64, 16) and (B, H, L, L, Dh) in k1
    sp = 4
    assert (chip_smoke.LONG_MOE_BATCH, moe.n_heads, moe.seq_len // sp,
            moe.seq_len // sp, 16) in {c[1:6] for c in chip_smoke.STATS_CASES}
    tp = chip_smoke.attention_bound(32, 2, 64, 64, 16, 2, stats=False)
    assert tp["bytes"] == 4 * 32 * 2 * 64 * 16 * 2 + 32 * 64 * 4 == 532_480
    assert tp["bound_by"] == "bytes"
    ep = chip_smoke.attention_bound(32, 4, 32, 32, 16, 2, stats=False)
    assert ep["bytes"] == 4 * 32 * 4 * 32 * 16 * 2 + 32 * 32 * 4 == 528_384
    assert ep["bound_ms"] == pytest.approx(528_384 / 3.35e12 * 1e3)


def test_levenshtein_bound_hand_counts():
    """K3's bound by hand. The bytes are the tokens the distances depend
    on (each pair's len_a + len_b, none where a length is 0), two lengths
    and one distance a pair. L=128: 4096 pairs of 100 x 100 tokens, 4
    words of a, 100 word steps each: 3.3 MB, bytes bound. L=512: 32 pairs
    of 500 x 500 tokens, 16 words, 500 word steps each; and one pair whose
    a is empty (no tokens, no word steps). L=64: lengths clamped to L, and
    an empty b reads no token of a. ``dp_cell_bound_ms`` is the per-cell
    formula: 5 operations a DP cell at the CUDA-core rate."""
    la = np.full(4096, 100)
    b = chip_smoke.levenshtein_bound(128, la, la)
    assert b["bytes"] == 4096 * 200 * 4 + 3 * 4096 * 4 == 3_325_952
    assert b["word_steps"] == 4096 * 100 * 4
    assert b["operations"] == 18 * 1_638_400 == 29_491_200
    assert b["cells"] == 40_960_000
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(3_325_952 / 3.35e12 * 1e3)
    assert b["dp_cell_bound_ms"] == pytest.approx(
        5 * 40_960_000 / 67e12 * 1e3)
    la = np.full(33, 500)
    lb = la.copy()
    la[0] = 0
    d = chip_smoke.levenshtein_bound(512, la, lb)
    assert d["bytes"] == 32 * 1000 * 4 + 3 * 33 * 4 == 128_396
    assert d["word_steps"] == 32 * 500 * 16 == 256_000
    assert d["operations"] == 18 * 256_000
    assert d["cells"] == 32 * 500 * 500
    assert d["bound_by"] == "operations"
    assert d["bound_ms"] == pytest.approx(18 * 256_000 / 67e12 * 1e3)
    assert d["dp_cell_bound_ms"] == pytest.approx(
        5 * 8_000_000 / 67e12 * 1e3)
    # a bit-parallel word step covers 32 cells: the new count is below
    # the per-cell one, so a DP-cell kernel respects it too
    assert d["bound_ms"] < d["dp_cell_bound_ms"]
    e = chip_smoke.levenshtein_bound(64, [70, 10, 0], [0, 64, 5])
    assert e["bytes"] == (10 + 64) * 4 + 3 * 3 * 4 == 332
    assert e["word_steps"] == 64 and e["cells"] == 640


def test_a_reading_faster_than_the_bound_fails():
    chip_smoke.check_bound(0.0050, 0.005, "K3")
    chip_smoke.check_bound(0.005 / 1.05, 0.005, "K3")
    with pytest.raises(chip_smoke.SmokeFailure, match="below bound_ms"):
        chip_smoke.check_bound(0.0047, 0.005, "K3")


def test_similarity_inputs_reach_the_edges():
    """The similarity phase's rows include an empty row and its pairs an
    empty pair, an equal pair and strings past the 128-byte window; its
    numpy references equal the JAX package's formulations."""
    from vainplex_openclaw_tpu.ops import similarity as jax_sim

    X = chip_smoke.seeded_multi_hot(64, seed=1)
    assert X.shape == (64, chip_smoke.SIM_DIM) and not X[32].any()
    assert np.array_equal(chip_smoke.jaccard_numpy(X, X).astype(np.float32),
                          jax_sim.jaccard_from_rows(X, use_jax=False))
    pairs = chip_smoke.seeded_pairs(64, seed=2)
    assert pairs[0] == ("", "") and pairs[1][0] == pairs[1][1]
    assert max(len(a) for a, _ in pairs) > 128
    A = jax_sim._tokenize_fixed([a for a, _ in pairs], 128)
    B = jax_sim._tokenize_fixed([b for _, b in pairs], 128)
    la, lb = ((x > 0).sum(axis=1).astype(np.int32) for x in (A, B))
    assert np.array_equal(chip_smoke.levenshtein_numpy(A, B, la, lb),
                          jax_sim._batch_levenshtein_numpy(A, B, la, lb))


@pytest.mark.parametrize("n", [32, 256, 4096])
def test_detector_legs_are_the_detectors_pairs(n):
    """The L=512 legs: ASCII commands of 1 to 500 characters, an empty
    pair (the bucket's padding), an equal pair, a's lengths on the word
    edges, and the odd pairs a few edits apart."""
    pairs = chip_smoke.lev_leg_pairs(chip_smoke.DETECTOR_LEN, n)
    assert len(pairs) == n and pairs[0] == ("", "")
    assert pairs[1][0] == pairs[1][1] != ""
    assert all(a.isascii() and b.isascii() for a, b in pairs)
    lengths = [len(s) for p in pairs[1:] for s in p]
    assert min(lengths) >= 1 and max(lengths) <= 500
    assert set(chip_smoke.DETECTOR_EDGES) <= {len(a) for a, _ in pairs}
    if n == 32:
        assert chip_smoke.detector_pairs(n, seed=90 + n) == pairs
        from vainplex_openclaw_tpu_torch.ops import similarity as sim

        ta = sim.tokenize_fixed([a for a, _ in pairs], 512)
        tb = sim.tokenize_fixed([b for _, b in pairs], 512)
        la, lb = ((x > 0).sum(axis=1).astype(np.int32) for x in (ta, tb))
        dist = chip_smoke.levenshtein_numpy(ta, tb, la, lb)
        assert dist[0] == dist[1] == 0
        assert all(1 <= d <= 5 for d in dist[3::2])  # near-duplicates
        assert (dist[4::2] > 5).sum() > 5  # independent commands


def test_long_leg_reaches_63_words():
    """The L=2048 leg: multibyte text near the 500-character cap, a up to
    2000 bytes, 63 words of 32 tokens: two bands of the kernel."""
    from vainplex_openclaw_tpu_torch.ops import similarity as sim

    pairs = chip_smoke.lev_leg_pairs(chip_smoke.LONG_LEV_LEN, 32)
    assert all(480 <= len(a) <= 500 for a, _ in pairs)
    A = sim.tokenize_fixed([a for a, _ in pairs], chip_smoke.LONG_LEV_LEN)
    la = (A > 0).sum(axis=1)
    assert la.max() == 2000 and (la.max() + 31) // 32 == 63
    assert (la > 1024).sum() > 16


# ── the lifecycle phase ─────────────────────────────────────────────


def ticket(version, result, done=True, error=None):
    import threading
    import types

    ev = threading.Event()
    if done:
        ev.set()
    return types.SimpleNamespace(version=version, result=result, done=ev,
                                 error=error)


def test_version_audit_hand_counts():
    oracle = {"v1": ["a", "b", "c", "d"], "v2": ["A", "B", "C", "D"]}
    assert chip_smoke.version_audit(
        [ticket("v1", "a"), ticket("v2", "B"), ticket("v1", "c"),
         ticket("v2", "D")], oracle) == {"dropped": 0, "mis_versioned": 0}
    # served by the other version's tree: mis-versioned, whatever it says
    assert chip_smoke.version_audit(
        [ticket("v1", "A"), ticket("v2", "b"), ticket("v1", "c"),
         ticket("v2", "D")], oracle) == {"dropped": 0, "mis_versioned": 2}
    # never enqueued, never served, or failed: dropped
    assert chip_smoke.version_audit(
        [None, ticket("v2", None, done=False),
         ticket("v1", None, error=RuntimeError("x")), ticket("v2", "d")],
        oracle) == {"dropped": 3, "mis_versioned": 1}


def test_tree_bytes_hand_counts():
    tree = {"a": torch.zeros(3, dtype=torch.bfloat16),
            "blocks": [{"w": torch.zeros(2, 2)}, {"w": torch.zeros(5)}]}
    assert chip_smoke.tree_bytes(tree) == 3 * 2 + 4 * 4 + 5 * 4


def test_quantiles_hand_counts():
    q = chip_smoke.quantiles_ms([5.0, 1.0, 3.0, 2.0, 4.0])
    assert q == {"p50": 3.0, "p99": 5.0, "n": 5}
    q = chip_smoke.quantiles_ms([float(i) for i in range(200)])
    assert (q["p50"], q["p99"]) == (100.0, 198.0)


def test_swap_protocol_stamps_and_serves_as_expected():
    """On a stub registry behind the port's batcher (the CPU), the stepped
    swap stamps the first half v1 and the rest v2, serves each by its
    stamp, and ends rolled back to v1."""
    from vainplex_openclaw_tpu_torch.models.batching import (
        ContinuousBatcher, render_verdict)
    from vainplex_openclaw_tpu_torch.models.registry import (
        ModelRegistry, clear_registries)

    reg = ModelRegistry({"enabled": True}, name="chip-protocol",
                        device="cpu")
    reg.register_stub("v1")
    reg.register_stub("v2")
    batcher = ContinuousBatcher(
        registry=reg, max_batch=8, window_ms=0.0, autostart=False,
        device="cpu",
        model_fn=lambda texts, v: [int(v == "v2") * 3] * len(texts))
    try:
        got = chip_smoke.swap_protocol(batcher, [f"t{i}" for i in range(48)])
    finally:
        batcher.close()
        clear_registries()
    assert [v for v, _ in got] == ["v1"] * 24 + ["v2"] * 24
    assert [r for _, r in got] == [render_verdict(0)] * 24 + \
        [render_verdict(3)] * 24
    assert batcher.batches == 6           # 8 + 16 drained, then 24 in 3
    assert reg.active() == "v1" and reg.stats()["rollbacks"] == 1


def test_negated_twin_flips_every_verdict(tmp_path):
    from vainplex_openclaw_tpu_torch.models.registry import (
        ModelRegistry, clear_registries)

    d = str(tmp_path / "negated")
    chip_smoke.negated_twin(d)
    reg = ModelRegistry({"enabled": True}, name="chip-twin", device="cpu")
    try:
        reg.register("v1")
        reg.register("v2", d)
        texts = chip_smoke.seeded_texts(64, seed=81)
        a, b = reg._score("v1", texts), reg._score("v2", texts)
    finally:
        clear_registries()
    assert all(x != y for x, y in zip(a, b))


def test_mesh_swap_expects_the_runners_k1_count():
    """The (1, 2) dp x tp grid: each batch's forward launches K1 on both
    tp columns of the one dp row, in each of triage-tiny's 2 layers."""
    from vainplex_openclaw_tpu_torch.models.pretrained import TINY_CONFIG

    assert chip_smoke.mesh_k1_per_forward(TINY_CONFIG, ("dp", "tp"),
                                          (1, 2)) == 4


# ── the search phases ─────────────────────────────────────────────────

def test_point_parity_bound_is_the_kernels_phase_bf16_bound():
    """Every candidate tile is held to the plain versions at the point
    shape with the bound the kernels phase holds bf16 K1 to, measured as
    it measures it (per row, relative to each row's largest value), and
    with the control from the same key count."""
    from vainplex_openclaw_tpu_torch.ops import kernel_search as ks

    assert chip_smoke.POINT_TOL == chip_smoke.TOL["bfloat16"] == 3e-2
    assert ks.PARITY_TOL["bfloat16"] == chip_smoke.POINT_TOL
    assert ks.POINT_SHAPE == (4, 8, 64)
    assert ks.CONTROL_MIN_L == chip_smoke.CONTROL_MIN_LK
    rng = np.random.default_rng(2)
    ref = torch.from_numpy(rng.standard_normal((3, 5, 16)) * 0.01)
    out = ref + torch.from_numpy(rng.standard_normal((3, 5, 16)) * 1e-3)
    assert ks.held_error(out, ref, per_row=True) == \
        chip_smoke.k1_errors(out, ref, "bfloat16")[2]
    assert ks.held_error(out, ref, per_row=False) == \
        chip_smoke.k1_errors(out, ref, "float32")[2]


def test_served_cases_are_the_searched_buckets_shapes():
    """Every bf16 kernel case whose Lq or Lk falls in a searched bucket,
    and the long serve shape, hold each candidate tile."""
    from vainplex_openclaw_tpu_torch.ops.similarity import pow2_bucket

    cases = chip_smoke.served_cases(chip_smoke.SEARCH_LENGTHS)
    names = [c[0] for c in cases]
    assert {"serve_path", "keys_63", "keys_64", "rows_not_tile_multiple",
            "long_16384", "long_16384_masked", "mesh_tp2_shard",
            "train_tp4_shard", "long_serve"} <= set(names)
    assert not {"keys_65", "mfu_shape", "head_dim_128"} & set(names)
    for c in cases:
        assert {pow2_bucket(c[3]), pow2_bucket(c[4])} & {64, 16384}
        assert c[5] in SUPPORTED_HEAD_DIMS
    assert cases[-1] == ("long_serve", *chip_smoke.LONG_SERVE[:3],
                         chip_smoke.LONG_L, 16, False, False)
    assert [c[0] for c in chip_smoke.served_cases((64,))] == \
        [n for n in names if n not in ("long_16384", "long_16384_masked",
                                       "long_serve")]


def test_every_committed_block_row_serves_a_kernel_case():
    assert chip_smoke.table_rows_unserved(chip_smoke.KERNEL_CASES) == []
    serve_only = [c for c in chip_smoke.KERNEL_CASES if c[4] <= 64]
    assert chip_smoke.table_rows_unserved(serve_only) == \
        ["cuda:bfloat16:16384"]


def _sweeps(*improved):
    return {"sweeps": {
        f"cuda:1x1:k{i}": {"improved": bool(w), "best": {"candidate": w}
                           if w else {"candidate": None},
                           **({"entry": {"candidate": w}} if w else {})}
        for i, w in enumerate(improved)}, "factorizations": {}}


@pytest.mark.parametrize("runs,kept", [
    ([("a", None), ("a", None), ("a", None)], ["k0"]),
    ([("a", None), ("a", None), (None, None)], []),
    ([("a", "b"), ("c", "b"), ("a", "b")], ["k1"]),
    ([(None, "b")], ["k1"]),
])
def test_agreed_sweeps_keep_a_winner_every_run_passed(runs, kept):
    got = chip_smoke.agreed_sweeps([_sweeps(*r) for r in runs])
    assert sorted(k.split(":")[-1] for k, s in got["sweeps"].items()
                  if s["improved"]) == kept
    for key, sweep in got["sweeps"].items():
        assert ("entry" in sweep) == sweep["improved"]


def test_card_plan_search_times_more_than_jax_defaults():
    """12 queries (~40 ms on the card) let host noise choose a row."""
    from vainplex_openclaw_tpu_torch.parallel import plan_search as ps

    for k in ("requests", "queries"):
        assert chip_smoke.PLAN_SEARCH_CARD[k] >= \
            8 * ps.PLAN_SEARCH_DEFAULTS[k]
    assert chip_smoke.PLAN_RUNS >= 3


@pytest.mark.parametrize("steps,rounds,want", [(4, 3, 12), (1, 1, 1),
                                               (8, 2, 16)])
def test_search_launch_count_is_one_per_timed_step(steps, rounds, want):
    assert chip_smoke.search_launches(steps, rounds) == want
    assert chip_smoke.search_launches(chip_smoke.SEARCH_STEPS,
                                      chip_smoke.SEARCH_ROUNDS) == 12


def test_searched_lengths_are_the_served_buckets():
    assert chip_smoke.SEARCH_LENGTHS == (64, chip_smoke.LONG_L) == \
        (64, 16384)


def test_card_rows_keep_only_one_card_grids():
    table = {"schema": "plan-table-v1", "provenance": {"x": 1}, "entries": {
        "cpu:2x4:encoder_validator": {"a": 1},
        "cpu:n8:encoder_validator": {"mesh_shape": [8, 1]},
        "cuda:1x1:encoder_validator": {"b": 1},
        "cuda:1:embeddings_forward": {"c": 1},
        "cuda:2x1:encoder_validator": {"d": 1},
        "cuda:2:embeddings_forward": {"e": 1},
        "cuda:n2:encoder_validator": {"mesh_shape": [2, 1]},
        "tpu:4x4:encoder_validator": {"f": 1}}}
    kept = chip_smoke.card_rows(table)
    assert sorted(kept["entries"]) == [
        "cpu:2x4:encoder_validator", "cpu:n8:encoder_validator",
        "cuda:1:embeddings_forward", "cuda:1x1:encoder_validator",
        "tpu:4x4:encoder_validator"]
    assert kept["provenance"] == table["provenance"]
    assert len(table["entries"]) == 8  # the input is left as it was


def test_table_tiles_are_the_committed_rows_libraries():
    """The build phase builds each tile a cuda row names (the default
    library is built anyway)."""
    import json

    from vainplex_openclaw_tpu_torch.ops import _build
    from vainplex_openclaw_tpu_torch.ops import flash_attention as fa

    with open(fa.TABLE_PATH, encoding="utf-8") as f:
        rows = json.load(f)["entries"]
    want = {(e["block_q"], e["block_k"]) for k, e in rows.items()
            if k.startswith("cuda:")} - {_build.DEFAULT_TILES}
    assert set(chip_smoke.table_tiles()) == want
    for t in chip_smoke.table_tiles():
        assert _build.tile_defines(t)
