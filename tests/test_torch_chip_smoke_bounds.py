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
the rows one card may write, and the rows every run agreed on. Every
shape the graft dryrun launches K1 or K2 at is a kernels case, and the
kernels line books the dryrun's launches per leg. chip_smoke's top level
imports only the standard library, so importing it here runs nothing.
"""

from __future__ import annotations

import json
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
    COMPILED_HEAD_DIMS, flash_attention_reference,
    flash_attention_stats_reference, kernel_head_dim)


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
    # in each dtype a compiled width, a Dh <= 128 the wrapper zero-pads to
    # one, or above 128 a multiple of 128 the wide library runs
    assert min(B, H, Lq, Lk, Dh) >= 1
    for dtype, widths in COMPILED_HEAD_DIMS.items():
        width = kernel_head_dim(Dh, dtype)
        assert width in widths or (width > 128 and width % 128 == 0)
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


def test_head_dim_cases_cover_the_compiled_and_padded_routes():
    """Both kernels' cases reach Dh 8 (a compiled width in fp32, padded to
    16 in bf16) at a short and a controlled long length, and Dh 24 (the
    padded route in both dtypes); K2's include the dryrun's ring+flash
    shard."""
    assert 8 in COMPILED_HEAD_DIMS["float32"]
    assert 8 not in COMPILED_HEAD_DIMS["bfloat16"]
    for cases in (chip_smoke.KERNEL_CASES, chip_smoke.STATS_CASES):
        dhs = {c[5] for c in cases}
        assert {8, 24} <= dhs
        assert all(24 not in widths for widths in COMPILED_HEAD_DIMS.values())
        assert any(c[5] == 8 and c[4] >= chip_smoke.CONTROL_MIN_LK
                   and not c[6] for c in cases)
    assert ("dryrun_ring_shard_dh8", 1, 2, 16, 16, 8, False, False) in \
        chip_smoke.STATS_CASES


def test_wide_cases_cover_head_dims_above_128_in_both_phases():
    """K1 and K2 hold Dh 129, 256 and 384 (padded, exact, padded), with
    fully masked rows, a causal case and B=2 H=2 L=2048 at 256; the tile
    search never takes them, and the timing phase times every non-causal
    one."""
    for cases in (chip_smoke.KERNEL_CASES, chip_smoke.STATS_CASES):
        assert set(chip_smoke.WIDE_CASES) <= set(cases)
    wide = chip_smoke.WIDE_CASES
    assert {c[5] for c in wide} == {129, 256, 384}
    assert all(c[7] == "prefix" for c in wide)  # fully masked last rows
    assert any(c[6] for c in wide)
    assert ("head_dim_256_long", 2, 2, 2048, 2048, 256, False, "prefix") \
        in wide
    assert not set(wide) & set(chip_smoke.served_cases((64, 128, 256, 2048,
                                                        16384)))


def test_wide_line_lists_every_timed_shape_without_a_path():
    timed = [{"name": "head_dim_129_wide", "shape": [4, 2, 100, 100, 129],
              "dtype": "bfloat16", "stats": stats, "kernel_ms": 0.01,
              "bound_ms": 0.001, "bound_by": "bytes", "plain_ms": 0.1,
              "library_ms": None if stats else 0.02,
              "sdpa_normalized_ms": 0.02} for stats in (False, True)]
    k1 = chip_smoke.wide_line({"shapes": timed}, stats=False)
    k2 = chip_smoke.wide_line({"shapes": timed}, stats=True)
    assert len(k1) == len(k2) == 1
    for line in (k1[0], k2[0]):
        assert line["launches"] is None and line["path"] is None
        assert {"ms", "bound_ms", "bound_by", "plain_ms", "library_ms"} <= \
            set(line)
    assert k2[0]["sdpa_normalized_ms"] == 0.02 and k1[0]["library_ms"] == 0.02


def test_wide_cases_meet_a_long_causal_walk_and_a_ragged_last_tile():
    """At head dim 256 both kernel phases hold a causal walk over 2048
    keys and Lk = 1999 (a ragged last key tile) with Lq = 1000 (off the
    64-row query tile), prefix-masked."""
    new = [("head_dim_256_causal_long", 2, 2, 2048, 2048, 256, True,
            "prefix"),
           ("head_dim_256_ragged", 2, 2, 1000, 1999, 256, False, "prefix")]
    for case in new:
        assert case in chip_smoke.WIDE_CASES
        assert case in chip_smoke.KERNEL_CASES
        assert case in chip_smoke.STATS_CASES
    assert 1999 % 64 and 1000 % 64


def _kernel_constant(source: str, name: str) -> int:
    """``constexpr int <name> = <n>;`` of one of the port's CUDA sources."""
    import re

    path = os.path.join(REPO, "vainplex_openclaw_tpu_torch", "ops", "csrc",
                        source)
    with open(path, encoding="utf-8") as f:
        found = re.findall(rf"constexpr int {name} = (\d+);", f.read())
    assert len(found) == 1, (source, name, found)
    return int(found[0])


def test_streamed_q_case_is_past_both_wide_kernels_resident_q():
    """Each wide kernel keeps Q in shared memory up to its kWideQResMax
    and streams it with K above it: every ``WIDE_CASES`` width stays
    resident in both, the streamed case's width (1024) is past both, and
    both kernel phases hold it."""
    limits = [_kernel_constant("flash_attention.cu", "kWideQResMax"),
              _kernel_constant("flash_attention_mma.cuh", "kWideQResMax")]
    for dtype in COMPILED_HEAD_DIMS:
        assert all(kernel_head_dim(c[5], dtype) <= min(limits)
                   for c in chip_smoke.WIDE_CASES)
    (case,) = chip_smoke.WIDE_STREAMED_Q_CASES
    assert all(kernel_head_dim(case[5], dtype) > max(limits)
               for dtype in COMPILED_HEAD_DIMS)
    assert case in chip_smoke.KERNEL_CASES and case in chip_smoke.STATS_CASES
    assert case not in chip_smoke.served_cases((64, 128, 256, 2048, 16384))


def test_timing_wide_times_every_non_causal_wide_case_and_the_fp32_walk(
        monkeypatch, capsys):
    """``phase_timing_wide`` times K1 and K2 in bf16 and fp32 at every
    non-causal ``WIDE_CASES`` shape, and the fp32 kernel at the compiled
    widths (K1 and K2) at every ``FP32_WALK_SHAPES`` shape: B=2 H=2 L=2048
    with Dh 64 and 128, the ring's shard, B=1 at 16384 and the fp32 legs'
    shape; the kernels line carries both."""
    calls = []

    def time_attention(B, H, Lq, Lk, Dh, dt_name, stats, seed, n, reps):
        calls.append(((B, H, Lq, Lk, Dh), dt_name, stats))
        return {"shape": [B, H, Lq, Lk, Dh], "dtype": dt_name,
                "stats": stats, "kernel_ms": 1.0, "bound_ms": 0.5,
                "bound_by": "operations", "plain_ms": 2.0,
                "library_ms": None if stats else 1.5,
                "sdpa_normalized_ms": 1.5 if stats else None}

    monkeypatch.setattr(chip_smoke, "time_attention", time_attention)
    record = chip_smoke.phase_timing_wide("card, 700 W")
    capsys.readouterr()
    wide = {tuple(c[1:6]) for c in chip_smoke.WIDE_CASES if not c[6]}
    assert {(2, 2, 1000, 1999, 256), (2, 2, 2048, 2048, 256)} <= wide
    want = {(s, dt, st) for s in wide for dt in ("bfloat16", "float32")
            for st in (False, True)}
    walk_shapes = {(2, 2, 2048, 2048, 64), (2, 2, 2048, 2048, 128),
                   (8, 2, 4096, 4096, 16), (1, 2, 16384, 16384, 16),
                   (32, 4, 64, 64, 16)}
    assert {tuple(c[1:]) for c in chip_smoke.FP32_WALK_SHAPES} == walk_shapes
    want |= {(shape, "float32", st) for shape in walk_shapes
             for st in (False, True)}
    assert sorted(calls) == sorted(want)
    for stats in (False, True):
        walk = chip_smoke.wide_line(record, stats, key="fp32_walk")
        assert sorted(tuple(t["shape"]) for t in walk) == sorted(walk_shapes)
        assert all(t["dtype"] == "float32" for t in walk)
        assert len(chip_smoke.wide_line(record, stats)) == 2 * len(wide)


@pytest.mark.parametrize("shape,ms", [
    ((2, 2, 2048, 2048, 64), 0.0641), ((2, 2, 2048, 2048, 128), 0.1282),
    ((8, 2, 4096, 4096, 16), 0.2564), ((1, 2, 16384, 16384, 16), 0.5128)])
@pytest.mark.parametrize("stats", [False, True])
def test_fp32_walk_bounds_at_the_cuda_core_rate(shape, ms, stats):
    """The fp32 kernel's shapes are bound by operations at 67 TFLOP/s:
    4·B·H·Lq·Lk·Dh of them, by hand."""
    B, H, Lq, Lk, Dh = shape
    b = chip_smoke.attention_bound(B, H, Lq, Lk, Dh, 4, stats,
                                   ops_per_s=chip_smoke.CUDA_CORE_OPS_PER_S)
    assert chip_smoke.CUDA_CORE_OPS_PER_S == 67e12
    assert b["operations"] == 4 * B * H * Lq * Lk * Dh
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == pytest.approx(ms, abs=5e-5)
    assert b["bound_ms"] == b["operations"] / 67e12 * 1e3


def test_fp32_walk_shapes_are_kernel_cases_with_the_control():
    """Every shape the fp32 kernel is timed at is held against the plain
    version in both kernel phases (in fp32 among both dtypes), and at
    2048 keys or more by a non-causal case that carries the
    dropped-first-tile control; Dh 128 is also held causal at 2048."""
    for cases in (chip_smoke.KERNEL_CASES, chip_smoke.STATS_CASES):
        by_shape: dict = {}
        for c in cases:
            by_shape.setdefault(tuple(c[1:6]), []).append(c)
        for name, *shape in chip_smoke.FP32_WALK_SHAPES:
            held = by_shape.get(tuple(shape))
            assert held, (name, shape)
            if shape[3] >= chip_smoke.CONTROL_MIN_LK:
                assert any(not c[6] for c in held), (name, shape)
        assert ("head_dim_128_long", 2, 2, 2048, 2048, 128, False,
                "prefix") in cases
        assert any(c[1:7] == (2, 2, 2048, 2048, 128, True) for c in cases)


def test_fp32_launches_take_the_default_library():
    """The block table has no ``cuda:float32`` row, so every fp32 launch
    runs the default tiles (the library built without defines) at every
    length the committed table names a bucket for."""
    from vainplex_openclaw_tpu_torch.ops import flash_attention as fa
    from vainplex_openclaw_tpu_torch.ops._build import DEFAULT_TILES

    rows = fa.load_block_table(fa.TABLE_PATH)["entries"]
    assert not any(k.startswith("cuda:float32:") for k in rows)
    buckets = {int(k.rsplit(":", 1)[1]) for k in rows}
    assert buckets
    for L in sorted(buckets):
        assert fa.launch_tiles(L, L, "float32") == DEFAULT_TILES


def _ptxas_entry(kernel, dh, stores):
    return {"kernel": kernel, "dh": dh, "causal": False, "stats": False,
            "registers": 128, "smem_bytes": None, "spill_stores": stores,
            "spill_loads": stores}


@pytest.mark.parametrize("dh", [8, 16, 32, 64, 128])
def test_check_spills_fails_any_spill_of_the_fp32_kernel(dh):
    """The build phase fails on a spill of the fp32 kernel at every
    compiled width, and of the bf16 kernel at Dh <= 64 (not at 128)."""
    chip_smoke.check_spills("lib", [_ptxas_entry("flash_fwd_fp32", dh, 0),
                                    _ptxas_entry("flash_fwd_mma", 128, 8)])
    with pytest.raises(chip_smoke.SmokeFailure, match="spill"):
        chip_smoke.check_spills("lib", [_ptxas_entry("flash_fwd_fp32", dh,
                                                     4)])
    if dh <= 64:
        with pytest.raises(chip_smoke.SmokeFailure, match="spill"):
            chip_smoke.check_spills("lib", [_ptxas_entry("flash_fwd_mma",
                                                         dh, 4)])


# the bf16 body at Dh 16 as ptxas names it (a wgmma/TMA kernel taking
# three tensor maps), spilling
PTXAS_BF16_BODY_SPILL = """\
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__3f0e2a11_18_flash_attention_cu_6c1a07d13mma13flash_fwd_mmaILi16ELb0ELb1EEEv14CUtensorMap_stS3_S3_PKfPvPfS7_iiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__3f0e2a11_18_flash_attention_cu_6c1a07d13mma13flash_fwd_mmaILi16ELb0ELb1EEEv14CUtensorMap_stS3_S3_PKfPvPfS7_iiiif
    24 bytes stack frame, 24 bytes spill stores, 24 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers, 1152 bytes cmem[0]
"""


def test_check_spills_fails_a_spilling_bf16_body_at_head_dim_16():
    """A sample ptxas log of the bf16 body at Dh 16 that spills fails the
    build phase's gate; the same body without a spill passes."""
    report = chip_smoke.ptxas_report(PTXAS_BF16_BODY_SPILL)
    assert [(e["kernel"], e["dh"], e["stats"], e["spill_stores"])
            for e in report] == [("flash_fwd_mma", 16, True, 24)]
    with pytest.raises(chip_smoke.SmokeFailure, match="spill"):
        chip_smoke.check_spills("lib", report)
    chip_smoke.check_spills("lib", chip_smoke.ptxas_report(
        PTXAS_BF16_BODY_SPILL.replace("24 bytes spill stores, 24 bytes spill "
                                      "loads", "0 bytes spill stores, 0 "
                                      "bytes spill loads")))


@pytest.mark.parametrize("kernel", ["flash_fwd_bf16", "flash_fwd_wgmma"])
def test_check_spills_holds_a_body_under_another_name(kernel):
    """A flash kernel under a name the gate does not know is held at every
    width, Dh 128 included; the two wide kernels are not held."""
    chip_smoke.check_spills("lib", [_ptxas_entry("flash_fwd_mma_wide", 256, 8),
                                    _ptxas_entry("flash_fwd_fp32_wide", 256,
                                                 8)])
    for dh in (16, 128):
        with pytest.raises(chip_smoke.SmokeFailure, match="spill"):
            chip_smoke.check_spills("lib", [_ptxas_entry(kernel, dh, 4)])


def test_instantiation_cap_is_the_default_librarys_count():
    """The build phase's cap: 4 bf16 and 5 fp32 head dims, causal or not,
    stats or not."""
    n = sum(len(w) for w in COMPILED_HEAD_DIMS.values()) * 2 * 2
    assert chip_smoke.MAX_INSTANTIATIONS == n == 36


def test_walk_line_books_each_paths_fp32_launches():
    """The kernels line's fp32 rows take the launches of every path whose
    shape is the row's but for the batch: the ring's shard (sp=4) and its
    whole sequence (sp=1, B=8) in K2; the legs' single-device forwards in
    K1. A path that launches at several shapes adds to the totals only."""
    rows = [{"name": name, "shape": list(shape), "dtype": "float32",
             "stats": stats, "kernel_ms": 1.0, "bound_ms": 0.5,
             "bound_by": "operations", "plain_ms": 2.0,
             "library_ms": None if stats else 1.5,
             "sdpa_normalized_ms": 1.5}
            for name, *shape in chip_smoke.FP32_WALK_SHAPES
            for stats in (False, True)]
    wide = {"fp32_walk": rows}
    k2 = [("ring", [8, 2, 4096, 4096, 16], 32),
          ("ring", [8, 2, 16384, 16384, 16], 2),
          ("dryrun_ring_flash", None, 40)]
    k1 = [("grad", [64, 4, 64, 64, 16], 2),
          ("mesh_pp", [32, 4, 64, 64, 16], 2), ("mesh_pp", None, 16),
          ("forward", [32, 8, 128, 128, 32], 2)]
    line2 = {r["name"]: r for r in chip_smoke.walk_line(wide, True, k2)}
    assert line2["fp32_walk_ring_shard"]["launches"] == 32
    assert line2["fp32_walk_long_16384"]["launches"] == 2
    assert line2["fp32_walk_long_16384"]["path"] == "ring"
    assert line2["fp32_walk_dh64"]["launches"] is None
    line1 = {r["name"]: r for r in chip_smoke.walk_line(wide, False, k1)}
    assert line1["fp32_walk_legs"]["launches"] == 4
    assert line1["fp32_walk_legs"]["path"] == "grad+mesh_pp"
    assert line1["fp32_walk_ring_shard"]["launches"] is None
    assert chip_smoke.fp32_by_path(k2) == {"ring": 34,
                                           "dryrun_ring_flash": 40}
    assert chip_smoke.fp32_by_path(k1) == {"grad": 2, "mesh_pp": 18,
                                           "forward": 2}


def test_fp32_launches_read_each_phases_record():
    """The kernels line's fp32 launches come from the records the phases
    return: the forward and grad legs, each mesh_tp grid's and mesh_pp's
    single-device reference and mesh forward, the ring at sp=4 and 1, and
    the dryrun's ring+flash leg (Dh 8, fp32)."""
    leg = {"k1_per_forward": {"counted": 8},
           "reference_k1_launches": 2,
           "reference_k1_shape": [64, 4, 64, 64, 16]}
    pp = {"phase": "mesh_pp", "float32": dict(
        leg, reference_k1_shape=[32, 4, 64, 64, 16]), "bfloat16": leg}
    mesh = {"tp": {"record": {"phase": "mesh_tp", "2x2": {"float32": leg},
                              "1x4": {"float32": leg}}},
            "pp": {"record": pp}}
    forwarded = {"random_float32": {"k1_launches": 2,
                                    "k1_shape": [32, 8, 128, 128, 32]}}
    grad = {"float32": {"k1_launches": 2, "k1_shape": [64, 4, 64, 64, 16]}}
    ring = {"float32": {"k2_launches": 32, "k2_launches_sp1": 2,
                        "k2_shapes": [[8, 2, 4096, 4096, 16],
                                      [8, 2, 16384, 16384, 16]]}}
    graft = {f"dryrun_{n}": {"legs": {
        "ring_flash": {"k1_launches": 0, "k2_launches": 4 * n},
        "serve_plan": {"k1_launches": 10, "k2_launches": 0}}}
        for n in chip_smoke.GRAFT_DRYRUN_SIZES}
    got = chip_smoke.fp32_launches(forwarded, grad, mesh, ring, graft)
    assert chip_smoke.fp32_by_path(got["k1"]) == {
        "forward": 2, "grad": 2, "mesh_tp": 2 * (8 + 2), "mesh_pp": 8 + 2}
    assert chip_smoke.fp32_by_path(got["k2"]) == {
        "ring": 34, "dryrun_ring_flash": 4 * sum(
            chip_smoke.GRAFT_DRYRUN_SIZES)}
    legs = [s for s in chip_smoke.FP32_WALK_SHAPES if s[0] == "fp32_walk_legs"]
    rows = [{"name": name, "shape": list(shape), "dtype": "float32",
             "stats": False, "kernel_ms": 1.0, "bound_ms": 0.5,
             "bound_by": "bytes", "plain_ms": 2.0, "library_ms": 1.5}
            for name, *shape in legs]
    (row,) = chip_smoke.walk_line({"fp32_walk": rows}, False, got["k1"])
    assert row["launches"] == 2 + 2 + 2 + 2  # grad, both tp grids, pp
    assert row["path"] == "grad+mesh_tp+mesh_pp"


@pytest.fixture
def one_torch_thread():
    """Runs a test's torch work on one intra-op thread. The suite's
    parallel workers oversubscribe the cores, and a contended pool slows
    small CPU ops 40-150x; no check of these tests depends on the count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_dryrun_launch_shapes_are_kernel_cases(monkeypatch, one_torch_thread):
    """Every shape at which ``dryrun_multichip(8)`` and ``(4)`` launch K1
    or K2 (the legs, the pipeline microbatch and the single-device
    forwards the serve legs are held against) is a case the kernels or
    kernels_stats phase holds against the plain version. On the CPU each
    would-be launch is a call of the wrapper's ``_forward``."""
    from vainplex_openclaw_tpu_torch import graft_entry
    from vainplex_openclaw_tpu_torch.ops import flash_attention as fa

    seen = set()
    forward = fa._forward

    def record(q, k, v, bias, causal, return_stats, tiles=None):
        seen.add((bool(return_stats), (*q.shape[:3], k.shape[2], q.shape[3],
                                       causal)))
        return forward(q, k, v, bias, causal, return_stats, tiles)

    monkeypatch.setattr(fa, "_forward", record)
    for n in chip_smoke.GRAFT_DRYRUN_SIZES:
        graft_entry.dryrun_multichip(n, "cpu")
    cases = {False: {c[1:7] for c in chip_smoke.KERNEL_CASES},
             True: {c[1:7] for c in chip_smoke.STATS_CASES}}
    missing = sorted(s for s in seen if s[1] not in cases[s[0]])
    assert not missing
    assert (True, (1, 8, 16, 16, 16, False)) in seen   # the ring at n = 8
    assert (False, (4, 8, 64, 64, 16, False)) in seen  # leg 5's reference


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_k2_check_fails_a_dropped_key_tile_at_2048_keys(dtype):
    """K2's check (m, l and acc over l, and in bf16 acc per row) must fail
    the plain version without its first key tile at the head-dim-8 long
    case, as the kernels_stats phase's control demands."""
    tdt = getattr(torch, dtype)
    q, k, v, mask = chip_smoke.make_qkv(np.random.default_rng(5), 2, 2, 256,
                                        2048, 8, tdt, "prefix", "cpu")
    want = flash_attention_stats_reference(q, k, v, mask)
    rows = chip_smoke.valid_rows(mask, 2, 256, 2048, False, "cpu")
    assert max(chip_smoke.stats_errors(want, want, rows, dtype)) == 0.0
    dropped = flash_attention_stats_reference(
        q, k[:, :, 64:].contiguous(), v[:, :, 64:].contiguous(),
        mask[:, 64:].contiguous())
    assert max(chip_smoke.stats_errors(dropped, want, rows, dtype)) > \
        3 * chip_smoke.TOL[dtype]


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
    """Every bf16 kernel case whose Lq or Lk falls in a searched bucket
    (but the trace analyzer's triage batches), and the long serve shape,
    hold each candidate tile."""
    from vainplex_openclaw_tpu_torch.ops.similarity import pow2_bucket

    cases = chip_smoke.served_cases(chip_smoke.SEARCH_LENGTHS)
    names = [c[0] for c in cases]
    assert {"serve_path", "keys_63", "keys_64", "rows_not_tile_multiple",
            "long_16384", "long_16384_masked", "mesh_tp2_shard",
            "train_tp4_shard", "long_serve"} <= set(names)
    assert not {"keys_65", "mfu_shape", "head_dim_128"} & set(names)
    # the triage buckets differ from serve_path only in the batch
    assert not {c[0] for c in chip_smoke.TRACE_TRIAGE_CASES} & set(names)
    for c in cases:
        assert {pow2_bucket(c[3]), pow2_bucket(c[4])} & {64, 16384}
        assert kernel_head_dim(c[5], "bfloat16") in \
            COMPILED_HEAD_DIMS["bfloat16"]
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


def test_kernels_line_books_dryrun_launches_by_leg():
    """The kernels line counts the dryrun's launches per leg (K2's ring
    forward at Dh 16 apart from its ring+flash leg at Dh 8), a Dh 8 shape
    carries its path's count or null where no path launches it, and K2's
    SDPA time is ``sdpa_normalized_ms`` beside a null ``library_ms``."""
    def legs(ring_forward, ring_flash, serve):
        return {"legs": {
            "ring_forward": {"k1_launches": 0, "k2_launches": ring_forward},
            "ring_flash": {"k1_launches": 0, "k2_launches": ring_flash},
            "serve_plan": {"k1_launches": serve, "k2_launches": 0}}}

    timed = {"kernel_ms": 0.01, "bound_ms": 1e-6, "bound_by": "bytes",
             "exp_floor_ms": 1e-7, "plain_ms": 0.2, "dtype": "float32",
             "shape": [1, 2, 16, 16, 8]}
    graft = {"dryrun_8": legs(64, 32, 34), "dryrun_4": legs(16, 8, 18),
             "dh8_timing": {
                 "ring_k2": {**timed, "stats": True, "leg": "ring_flash",
                             "library_ms": None, "sdpa_normalized_ms": 0.03},
                 "long_k2": {**timed, "stats": True, "leg": None,
                             "library_ms": None, "sdpa_normalized_ms": 0.04},
                 "short_k1": {**timed, "stats": False, "leg": None,
                              "library_ms": 0.05}}}
    assert chip_smoke.dryrun_launches(graft, "k2") == {
        "dryrun_ring_forward": 64 + 16, "dryrun_ring_flash": 32 + 8}
    assert chip_smoke.dryrun_launches(graft, "k1") == {
        "dryrun_serve_plan": 34 + 18}
    k2 = {e["name"]: e for e in chip_smoke.dh8_line(graft, stats=True)}
    assert k2["ring_k2"]["launches"] == 40
    assert k2["ring_k2"]["path"] == "dryrun_ring_flash"
    assert k2["long_k2"]["launches"] is None and k2["long_k2"]["path"] is None
    assert all(e["library_ms"] is None and e["sdpa_normalized_ms"] > 0
               for e in k2.values())
    (k1,) = chip_smoke.dh8_line(graft, stats=False)
    assert k1["launches"] is None and k1["library_ms"] == 0.05
    assert "sdpa_normalized_ms" not in k1
    cases = {False: {c[0] for c in chip_smoke.KERNEL_CASES},
             True: {c[0] for c in chip_smoke.STATS_CASES}}
    assert all(case in cases[stats]
               for case, _, stats, _ in chip_smoke.DH8_TIMED)


# ── the trace analyzer phase ─────────────────────────────────────────


def test_trace_corpus_is_the_phase_size():
    """~22,000 events: 1000 chains of 14 events and 64 doom loops of 65
    failing retries, whose ASCII commands of 200-500 characters fall on
    both sides of the 0.8 threshold; the second run's chains come a day
    later. The host formula gives one K3 window of 64 pairs per doom
    loop."""
    from vainplex_openclaw_tpu_torch.ops.similarity import levenshtein_ratio

    first, new = chip_smoke.trace_corpora()
    assert len(first) == 1000 * 14 + 64 * (2 + 2 * 65) == 22448
    assert len(new) == 100 * 14 + 6 * (2 + 2 * 65)
    assert min(e["ts"] for e in new) > max(e["ts"] for e in first)
    assert chip_smoke.trace_k3_windows(first) == [64] * 64
    assert chip_smoke.trace_k3_windows(new) == [64] * 6
    commands = [e["payload"]["params"]["command"] for e in first
                if e["session"] == "doom0" and e["type"] == "tool.call"]
    assert len(commands) == 65 and all(
        200 <= len(c) <= 500 and c.isascii() for c in commands)
    ratios = [levenshtein_ratio(a, b) for a, b in zip(commands, commands[1:])]
    assert min(ratios) < 0.8 <= max(ratios)
    assert chip_smoke.trace_corpora() == (first, new)  # seeded


@pytest.fixture
def one_torch_thread():
    """The plain Levenshtein DP runs thousands of small tensor ops, which
    stall on a thread pool when test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.usefixtures("one_torch_thread")
def test_trace_launch_formulas_equal_the_port_cpu_run(tmp_path, monkeypatch):
    """The phase's host formulas against what the port's analyzer does on
    the CPU over a cut corpus of the same shape: one batched Levenshtein
    call per ``trace_k3_windows`` window, at a bucket of 64 × 512 tokens,
    and one triage forward a run (n_layers attention calls) at the pow2
    bucket of the run's findings."""
    import math

    from vainplex_openclaw_tpu_torch.cortex.trace_analyzer import (
        MemoryTraceSource, TraceAnalyzer)
    from vainplex_openclaw_tpu_torch.models import encoder
    from vainplex_openclaw_tpu_torch.models.pretrained import TINY_CONFIG
    from vainplex_openclaw_tpu_torch.ops import similarity as sim

    first = chip_smoke.trace_corpus(0, 12, 0, 3, chip_smoke.TRACE_BASE_TS, 5)
    new = chip_smoke.trace_corpus(12, 2, 3, 1, chip_smoke.TRACE_BASE_TS
                                  + chip_smoke.TRACE_DAY_MS, 6)
    k3, k1 = [], []
    real_rows, real_attn = sim.levenshtein_rows, encoder.flash_attention
    monkeypatch.setattr(sim, "levenshtein_rows", lambda A, *r: k3.append(
        tuple(A.shape)) or real_rows(A, *r))
    monkeypatch.setattr(encoder, "flash_attention", lambda q, *r: k1.append(
        tuple(q.shape)) or real_attn(q, *r))
    for raws, windows in ((first, chip_smoke.trace_k3_windows(first)),
                          (first + new, chip_smoke.trace_k3_windows(new))):
        k3.clear()
        k1.clear()
        log = chip_smoke.RecordingLogger()
        rep = TraceAnalyzer(chip_smoke.TRACE_CONFIG, tmp_path, log,
                            source=MemoryTraceSource(raws),
                            clock=lambda: chip_smoke.TRACE_CLOCK,
                            device="cpu").run()
        assert k3 == [(sim.pow2_bucket(n), chip_smoke.TRACE_K3_LEN)
                      for n in windows] and windows
        n = len(rep["findings"])
        bucket = 1 << math.ceil(math.log2(n))
        shape = [bucket, TINY_CONFIG.n_heads, TINY_CONFIG.seq_len,
                 TINY_CONFIG.d_model // TINY_CONFIG.n_heads]
        assert k1 == [tuple(shape)] * TINY_CONFIG.n_layers
        assert chip_smoke.trace_k1_shape(TINY_CONFIG, n) == shape
        assert log.messages("error") == [] and rep["failureClusters"]
    files = chip_smoke.trace_files(str(tmp_path))
    assert set(files) == {"report", "clusters", "state"}
    assert not set(chip_smoke.TRACE_TIMING_KEYS) & set(
        files["report"]["runStats"])


def test_trace_k1_buckets_of_the_phase_are_held_cases():
    """The phase's triage buckets (8949 findings in run 1, 879 in run 2 on
    the card) are kernels cases; a bucket no case holds is reported, and
    the phase fails on it."""
    from vainplex_openclaw_tpu_torch.models.pretrained import TINY_CONFIG

    shapes = [chip_smoke.trace_k1_shape(TINY_CONFIG, n) for n in (8949, 879)]
    assert shapes == [[16384, 4, 64, 16], [1024, 4, 64, 16]]
    assert chip_smoke.trace_k1_unheld(shapes) == []
    # (2048 is held since the knowledge_slo phase's sync took it)
    assert chip_smoke.trace_k1_unheld([[4096, 4, 64, 16]] + shapes) == [
        [4096, 4, 64, 16]]
    cases = {c[0]: c[1:] for c in chip_smoke.KERNEL_CASES}
    assert cases["trace_triage_run2"] == (1024, 4, 64, 64, 16, False,
                                          "prefix")


def test_trace_cluster_leg_grows_the_kept_window(tmp_path):
    """The cluster leg at the phase's size on the CPU: run 1 stays under
    the 512-signal cap and computes one block over its window; run 2's
    signals join the window, so its one block is new rows x every kept
    row. ``trace_cluster_leg`` passes these runs and fails a second run
    whose signals did not join (the main corpus's run 2)."""
    from vainplex_openclaw_tpu_torch.cortex.trace_analyzer import clusters

    first, new = chip_smoke.trace_cluster_corpora()
    assert min(e["ts"] for e in new) > max(e["ts"] for e in first)
    runs = {name: chip_smoke.trace_run(raws, str(tmp_path), "cpu",
                                       chip_smoke.TRACE_CLUSTER_CONFIG)
            for name, raws in zip(chip_smoke.TRACE_RUNS,
                                  (first, first + new))}
    leg = chip_smoke.trace_cluster_leg({"cuda": runs, "cpu": runs},
                                       chip_smoke.TRACE_CLUSTER_NEW_CHAINS)
    (r1, k1), = leg["run1"]["blocks"]
    (r2, k2), = leg["run2"]["blocks"]
    assert r1 == k1 and 0 < r2 < k2 <= clusters.MAX_CLUSTER_SIGNALS
    assert k2 - k1 == r2 and leg["run2"]["card"]["clusters"] > 1
    state = json.loads(runs["run2"]["files"]["clusters"])
    assert len(state["kept"]) == len(state["entries"]) < 512
    stalled = dict(runs["run2"], blocks=[])
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.trace_cluster_leg(
            {"cuda": dict(runs, run2=stalled), "cpu": dict(runs,
                                                           run2=stalled)},
            chip_smoke.TRACE_CLUSTER_NEW_CHAINS)


@pytest.mark.usefixtures("one_torch_thread")
def test_trace_profile_times_the_run_s_parts(tmp_path):
    """The profiled run on the CPU over a cut corpus (one K3 window): the
    same report and launches as an unprofiled run, each part timed, and
    every wrapped name restored."""
    from vainplex_openclaw_tpu_torch.cortex.trace_analyzer import classifier
    from vainplex_openclaw_tpu_torch.models import encoder
    from vainplex_openclaw_tpu_torch.ops import similarity as sim

    raws = chip_smoke.trace_corpus(0, 6, 0, 1, chip_smoke.TRACE_BASE_TS, 5)
    before = (classifier.encode_texts, sim.tokenize_fixed,
              sim.levenshtein_rows, encoder.flash_attention)
    plain = chip_smoke.trace_run(raws, str(tmp_path / "plain"), "cpu")
    prof = chip_smoke.trace_profile(raws, str(tmp_path / "prof"), "cpu")
    # the CPU counts no launch; the calls show in the times below
    assert prof["launches"] == {"k1": plain["k1"], "k3": plain["k3"]}
    assert chip_smoke.trace_k3_windows(raws) == [64]
    assert prof["report"] == plain["files"]["report"]
    assert set(prof["ms"]) == {"triage_tokenize", "k3_tokenize",
                               "report_assemble", "report_save", "k1", "k3"}
    assert all(v > 0 for v in prof["ms"].values())
    assert before == (classifier.encode_texts, sim.tokenize_fixed,
                      sim.levenshtein_rows, encoder.flash_attention)
    assert set(prof["stage_ms"]) >= {"signals", "classify", "report"}


def test_trace_lines_book_both_runs():
    timed = {"shape": [64, 512], "kernel_ms": 0.01, "bound_ms": 1e-5,
             "bound_by": "bytes", "plain_ms": 5.0, "library_ms": 0.02}
    traced = {"run1": {"card": {"k1_launches": 2, "k3_launches": 64}},
              "run2": {"card": {"k1_launches": 2, "k3_launches": 6}},
              "k1_timing": dict(timed, shape=[16384, 4, 64, 64, 16]),
              "k3_timing": timed}
    k1 = chip_smoke.trace_k1_line(traced)
    k3 = chip_smoke.trace_k3_line(traced)
    assert k1["launches"] == 4 and k1["library_ms"] == 0.02
    assert k3["launches"] == 70 and k3["library_ms"] is None
    assert k1["shape"] == [16384, 4, 64, 64, 16] and k3["shape"] == [64, 512]
