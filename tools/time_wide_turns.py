#!/usr/bin/env python3
"""Time two builds of a flash library in turns on one CUDA card: a baseline
built from another checkout's ``vainplex_openclaw_tpu_torch/ops/csrc`` and
this checkout's own. By default the wide library (K1 and K2 at head dims
above 128); with ``--narrow`` or ``--bf16`` the default library (no
defines: the compiled widths up to 128), at the fp32 walk's shapes or at
the bf16 body's.

Run from the repository root::

    python3 tools/time_wide_turns.py --baseline-csrc DIR [--narrow | --bf16] [--out FILE]

DIR holds the baseline's ``flash_attention.cu`` and its headers, for
example an older commit's sources unpacked with ``git archive <commit>
vainplex_openclaw_tpu_torch/ops/csrc | tar -x -C build/baseline`` (DIR is
then ``build/baseline/vainplex_openclaw_tpu_torch/ops/csrc``). Both
libraries are built with the flags of ``ops/_build.py`` (and
``-DFLASH_WIDE`` without ``--narrow``), in parallel, under
``build/wide_turns/``. The shapes: the non-causal ``WIDE_CASES`` that the
``timing_wide`` phase of ``chip_smoke.py`` times, in bf16 and fp32; with
``--narrow`` its ``FP32_WALK_SHAPES`` in fp32; with ``--bf16``
:data:`BF16_SHAPES` in bf16 (the long family's shape, the serve shape,
the trace analyzer's triage bucket, ``entry()``'s, ``mfu_shape`` and B=2
H=2 L=2048 at Dh 8, 64 and 128) from the default library, whose 64 × 64
tile both committed rows of the block table name, the baseline at the
widths it compiles (``--baseline-widths``, default 8 to 128: bf16 Dh 8
native there, padded to 16 in this checkout). At every shape, K1 and K2,
on the inputs ``chip_smoke.time_attention`` makes, the calls run in turns:
baseline, new, SDPA, plain, plain, SDPA, new, baseline
(``chip_smoke.time_ms``, CUDA events; ten times the calls where the
fp32 bound is under 0.01 ms, the launch); both builds' outputs are held
against the plain version at ``chip_smoke.TOL``. With ``--narrow`` or
``--bf16`` each shape also names the kernels SDPA launched and gives each
build's device time a call, from the profiler; with ``--bf16`` also the
exponential floor at the card's own ex2 rate (``chip_smoke.sfu_rates``).
One JSON line per shape; FILE (default ``chiprun_out/wide_turns.json``,
with ``--narrow`` ``chiprun_out/narrow_turns.json``, with ``--bf16``
``chiprun_out/bf16_turns.json``) gets every line, each build's seconds
and ptxas registers and spills, and the card's name and power limit.
Exits 1 if a build fails or an output is out of tolerance.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import os
import statistics
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

# (name, B, H, L, Dh) of the bf16 body's shapes (``--bf16``), L = Lq = Lk
BF16_SHAPES = [("long_16384", 8, 2, cs.LONG_L, 16),
               ("serve", 32, 4, 64, 16),
               ("triage_bucket", 16384, 4, 64, 16),
               ("entry", 2, 8, 128, 32),
               ("mfu_shape", 4, 16, 2048, 64),
               ("dh8_2048", 2, 2, 2048, 8),
               ("dh64_2048", 2, 2, 2048, 64),
               ("dh128_2048", 2, 2, 2048, 128)]


def start_build(csrc: str, name: str, defines: tuple):
    """``nvcc`` of the flash library from ``csrc`` with ``defines``,
    started: (process, path of the library it writes, start time)."""
    from vainplex_openclaw_tpu_torch.ops import _build

    out_dir = os.path.join(REPO, "build", "wide_turns")
    os.makedirs(out_dir, exist_ok=True)
    kind = "wide" if defines else "default"
    path = os.path.join(out_dir, f"libflash_attention_{name}_{kind}.so")
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, *defines,
           "-o", path, os.path.join(csrc, "flash_attention.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), path, \
        time.perf_counter()


def load(path: str) -> ctypes.CDLL:
    from vainplex_openclaw_tpu_torch.ops import _build

    lib = ctypes.CDLL(path)
    for fn, (argtypes, restype) in \
            _build.SIGNATURES["flash_attention"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def sdpa_kernels(fn, n: int = 5) -> list:
    """The CUDA kernels ``n`` calls of ``fn`` launched, from the profiler:
    name (first 120 characters), device ms per call and records, the
    longest first."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return [{"name": name[:120], "ms_per_call": t / 1e3 / n,
             "records": count}
            for t, name, count in sorted(cs.device_rows(prof), reverse=True)]


def time_shape(libs: dict, B, H, Lq, Lk, Dh, dt_name: str, stats: bool,
               seed: int, n: int, reps: int, name_sdpa: bool = False,
               widths: "dict | None" = None) -> dict:
    """One shape, dtype and mode: each build, SDPA and the plain version in
    turns, and each build's error against the plain version; with
    ``name_sdpa`` the kernels SDPA launched and each build's device time
    a call. ``widths`` maps a build to the head dim it runs at (default:
    this checkout's ``kernel_head_dim``)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from vainplex_openclaw_tpu_torch.ops import flash_attention as fa

    dtype = getattr(torch, dt_name)
    q, k, v, mask = cs.make_qkv(np.random.default_rng(seed), B, H, Lq, Lk,
                                Dh, dtype, "prefix" if B > 1 else False,
                                "cuda")
    bias = fa._bias(mask, B, Lk, q.device)
    widths = widths or {}
    padded = {}
    got = {}
    calls = {}
    for name, lib in libs.items():
        width = widths.get(name) or fa.kernel_head_dim(Dh, dt_name)
        qp, kp, vp = padded.setdefault(width, tuple(
            fa._pad_head_dim(t, width) for t in (q, k, v)))
        got[name] = ((torch.empty((B, H, Lq, width), dtype=torch.float32,
                                  device="cuda"),
                      torch.empty((B, H, Lq), dtype=torch.float32,
                                  device="cuda"),
                      torch.empty((B, H, Lq), dtype=torch.float32,
                                  device="cuda"))
                     if stats else torch.empty_like(qp))
        calls[name] = cs.raw_launch(lib, qp, kp, vp, bias, got[name],
                                    f"{name} {'K2' if stats else 'K1'}",
                                    Dh ** -0.5)
    plain = functools.partial(
        fa.flash_attention_stats_reference if stats
        else fa.flash_attention_reference, q, k, v, mask)
    sdpa_mask = bias.to(dtype)[:, None, None, :]

    def sdpa():
        F.scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask)

    timed = functools.partial(cs.time_ms, n=n, reps=reps)
    runs = {"baseline": [], "new": [], "sdpa": [], "plain": []}
    for name, fn in (("baseline", calls["baseline"]), ("new", calls["new"]),
                     ("sdpa", sdpa), ("plain", plain), ("plain", plain),
                     ("sdpa", sdpa), ("new", calls["new"]),
                     ("baseline", calls["baseline"])):
        runs[name].append(timed(fn))
    want = plain()
    errors = {}
    for name in libs:
        calls[name]()
        torch.cuda.synchronize()
        if stats:
            rows = cs.valid_rows(mask, B, Lq, Lk, False, "cuda")
            errors[name] = max(cs.stats_errors(
                (got[name][0][..., :Dh], *got[name][1:]), want, rows,
                dt_name))
        else:
            errors[name] = cs.k1_errors(got[name][..., :Dh], want,
                                        dt_name)[2]
    ops = cs.PEAK_BF16_OPS_PER_S if dt_name == "bfloat16" \
        else cs.CUDA_CORE_OPS_PER_S
    bound = cs.attention_bound(B, H, Lq, Lk, Dh, q.element_size(), stats,
                               ops_per_s=ops)
    named = {}
    if name_sdpa:
        # the kernels SDPA ran, and each build's device time a call (the
        # host's launch rate sets the turns at the smallest shapes)
        named = {"sdpa_kernels": sdpa_kernels(sdpa),
                 "device_ms": {name: cs.device_kernel_ms(fn, n=20)[
                     "ms_per_call"] for name, fn in calls.items()}}
    return {"shape": [B, H, Lq, Lk, Dh], "dtype": dt_name, "stats": stats,
            **{f"{name}_ms": statistics.median(r) for name, r in runs.items()},
            "runs": runs, "err": errors, "tol": cs.TOL[dt_name],
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            "exp_floor_ms": bound["exp_floor_ms"], **named}


def shapes(narrow: bool, bf16: bool = False) -> list:
    """(name, B, H, Lq, Lk, Dh, dtypes, seed) of every shape timed: the
    non-causal ``WIDE_CASES`` in both dtypes, or with ``narrow`` the
    ``FP32_WALK_SHAPES`` in fp32, on ``timing_wide``'s seeds, or with
    ``bf16`` :data:`BF16_SHAPES` in bf16."""
    if bf16:
        return [(name, B, H, L, L, Dh, ("bfloat16",), 340 + i)
                for i, (name, B, H, L, Dh) in enumerate(BF16_SHAPES)]
    if narrow:
        return [(name, B, H, Lq, Lk, Dh, ("float32",), 320 + i)
                for i, (name, B, H, Lq, Lk, Dh)
                in enumerate(cs.FP32_WALK_SHAPES)]
    return [(name, B, H, Lq, Lk, Dh, ("bfloat16", "float32"), 300 + i)
            for i, (name, B, H, Lq, Lk, Dh, causal, _)
            in enumerate(cs.WIDE_CASES) if not causal]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--baseline-csrc", required=True)
    parser.add_argument("--narrow", action="store_true",
                        help="the default library at FP32_WALK_SHAPES")
    parser.add_argument("--bf16", action="store_true",
                        help="the default library at BF16_SHAPES")
    parser.add_argument("--baseline-widths", default="8,16,32,64,128",
                        help="with --bf16, the bf16 head dims the "
                             "baseline compiles")
    parser.add_argument("--out")
    parser.add_argument("--n", type=int, default=20)
    parser.add_argument("--reps", type=int, default=5)
    args = parser.parse_args()
    info = cs.phase_device()
    import torch

    from vainplex_openclaw_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    narrow = args.narrow or args.bf16
    defines = () if narrow else _build.WIDE_DEFINES
    out = args.out or os.path.join(
        REPO, "chiprun_out",
        "bf16_turns.json" if args.bf16 else
        "narrow_turns.json" if args.narrow else "wide_turns.json")
    builds = {"baseline": start_build(os.path.abspath(args.baseline_csrc),
                                      "baseline", defines),
              "new": start_build(_build.CSRC_DIR, "new", defines)}
    record = {"nvidia_smi": info["nvidia_smi"], "kind": info["kind"],
              "library": "default" if narrow else "wide",
              "build_seconds": {}, "ptxas": {}, "shapes": []}
    logs = {}

    def wait(name, proc, t0):  # each build's seconds end with its own nvcc
        logs[name] = proc.communicate()[0]
        record["build_seconds"][name] = time.perf_counter() - t0

    waiters = [threading.Thread(target=wait, args=(name, proc, t0))
               for name, (proc, _, t0) in builds.items()]
    for w in waiters:
        w.start()
    for w in waiters:
        w.join()
    libs = {}
    for name, (proc, path, _) in builds.items():
        if proc.returncode != 0:
            print(f"{name} build failed:\n{logs[name]}", file=sys.stderr)
            return 1
        record["ptxas"][name] = cs.ptxas_report(logs[name])
        libs[name] = load(path)
    cs.emit({"build_seconds": record["build_seconds"],
             "ptxas": record["ptxas"]})
    widths = {}
    ex2_per_s = None
    if args.bf16:
        compiled = sorted(int(w) for w in args.baseline_widths.split(","))
        record["sfu"] = cs.sfu_rates()
        ex2_per_s = record["sfu"]["ex2"]["steps_per_s"]
    failed = []
    for name, B, H, Lq, Lk, Dh, dtypes, seed in shapes(args.narrow,
                                                      args.bf16):
        if args.bf16:
            widths = {"baseline": next((w for w in compiled if w >= Dh),
                                       Dh)}
        # a shape the launch bounds takes ten times the calls a turn
        small = cs.attention_bound(
            B, H, Lq, Lk, Dh, 4, False,
            ops_per_s=cs.CUDA_CORE_OPS_PER_S)["bound_ms"] < 0.01
        for dt_name in dtypes:
            for stats in (False, True):
                r = {"name": name, **time_shape(
                    libs, B, H, Lq, Lk, Dh, dt_name, stats, seed=seed,
                    n=args.n * (10 if small else 1), reps=args.reps,
                    name_sdpa=narrow, widths=widths)}
                if ex2_per_s:
                    r["exp_floor_measured_ms"] = \
                        B * H * Lq * Lk / ex2_per_s * 1e3
                cs.emit({k: v for k, v in r.items() if k != "runs"})
                record["shapes"].append(r)
                failed += [(name, dt_name, stats, lib) for lib, e in
                           r["err"].items() if not e <= r["tol"]]
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w", encoding="utf-8") as f:
        json.dump(record, f, indent=1)
    if failed:
        print(f"out of tolerance: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
