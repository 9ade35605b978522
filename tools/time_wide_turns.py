#!/usr/bin/env python3
"""Time two builds of the wide flash library (K1 and K2 at head dims above
128) in turns on one CUDA card: a baseline built from another checkout's
``vainplex_openclaw_tpu_torch/ops/csrc`` and this checkout's own.

Run from the repository root::

    python3 tools/time_wide_turns.py --baseline-csrc DIR [--out FILE]

DIR holds the baseline's ``flash_attention.cu`` and its headers, for
example an older commit's sources unpacked with ``git archive <commit>
vainplex_openclaw_tpu_torch/ops/csrc | tar -x -C build/baseline`` (DIR is
then ``build/baseline/vainplex_openclaw_tpu_torch/ops/csrc``). Both
libraries are built with the flags and ``-DFLASH_WIDE`` of
``ops/_build.py``, in parallel, under ``build/wide_turns/``. At every
shape the ``timing_wide`` phase of ``chip_smoke.py`` times (the non-causal
``WIDE_CASES``), in bf16 and fp32, K1 and K2, on the inputs
``chip_smoke.time_attention`` makes, the calls run in turns: baseline,
new, SDPA, plain, plain, SDPA, new, baseline (``chip_smoke.time_ms``, CUDA
events); both builds' outputs are held against the plain version at
``chip_smoke.TOL``. One JSON line per shape;
FILE (default ``chiprun_out/wide_turns.json``) gets every line, each
build's ptxas registers and spills, and the card's name and power limit.
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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def start_build(csrc: str, name: str):
    """``nvcc`` of the wide library from ``csrc``, started: (process,
    path of the library it writes)."""
    from vainplex_openclaw_tpu_torch.ops import _build

    out_dir = os.path.join(REPO, "build", "wide_turns")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"libflash_attention_{name}_wide.so")
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, *_build.WIDE_DEFINES,
           "-o", path, os.path.join(csrc, "flash_attention.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), path


def load(path: str) -> ctypes.CDLL:
    from vainplex_openclaw_tpu_torch.ops import _build

    lib = ctypes.CDLL(path)
    for fn, (argtypes, restype) in \
            _build.SIGNATURES["flash_attention"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def time_shape(libs: dict, B, H, Lq, Lk, Dh, dt_name: str, stats: bool,
               seed: int, n: int, reps: int) -> dict:
    """One shape, dtype and mode: each build, SDPA and the plain version in
    turns, and each build's error against the plain version."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from vainplex_openclaw_tpu_torch.ops import flash_attention as fa

    dtype = getattr(torch, dt_name)
    q, k, v, mask = cs.make_qkv(np.random.default_rng(seed), B, H, Lq, Lk,
                                Dh, dtype, "prefix" if B > 1 else False,
                                "cuda")
    bias = fa._bias(mask, B, Lk, q.device)
    width = fa.kernel_head_dim(Dh)
    qp, kp, vp = (fa._pad_head_dim(t, width) for t in (q, k, v))

    def outputs():
        if stats:
            return (torch.empty((B, H, Lq, width), dtype=torch.float32,
                                device="cuda"),
                    torch.empty((B, H, Lq), dtype=torch.float32,
                                device="cuda"),
                    torch.empty((B, H, Lq), dtype=torch.float32,
                                device="cuda"))
        return torch.empty_like(qp)

    got = {name: outputs() for name in libs}
    calls = {name: cs.raw_launch(lib, qp, kp, vp, bias, got[name],
                                 f"{name} {'K2' if stats else 'K1'}",
                                 Dh ** -0.5)
             for name, lib in libs.items()}
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
    return {"shape": [B, H, Lq, Lk, Dh], "dtype": dt_name, "stats": stats,
            **{f"{name}_ms": statistics.median(r) for name, r in runs.items()},
            "runs": runs, "err": errors, "tol": cs.TOL[dt_name],
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"]}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--baseline-csrc", required=True)
    parser.add_argument("--out", default=os.path.join(
        REPO, "chiprun_out", "wide_turns.json"))
    parser.add_argument("--n", type=int, default=20)
    parser.add_argument("--reps", type=int, default=5)
    args = parser.parse_args()
    info = cs.phase_device()
    import torch

    from vainplex_openclaw_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    builds = {"baseline": start_build(os.path.abspath(args.baseline_csrc),
                                      "baseline"),
              "new": start_build(_build.CSRC_DIR, "new")}
    record = {"nvidia_smi": info["nvidia_smi"], "kind": info["kind"],
              "ptxas": {}, "shapes": []}
    libs = {}
    for name, (proc, path) in builds.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"{name} build failed:\n{log}", file=sys.stderr)
            return 1
        record["ptxas"][name] = cs.ptxas_report(log)
        libs[name] = load(path)
    cs.emit({"ptxas": record["ptxas"]})
    failed = []
    for i, (name, B, H, Lq, Lk, Dh, causal, _) in enumerate(cs.WIDE_CASES):
        if causal:
            continue
        for dt_name in ("bfloat16", "float32"):
            for stats in (False, True):
                r = {"name": name, **time_shape(
                    libs, B, H, Lq, Lk, Dh, dt_name, stats, seed=300 + i,
                    n=args.n, reps=args.reps)}
                cs.emit({k: v for k, v in r.items() if k != "runs"})
                record["shapes"].append(r)
                failed += [(name, dt_name, stats, lib) for lib, e in
                           r["err"].items() if not e <= r["tol"]]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w", encoding="utf-8") as f:
        json.dump(record, f, indent=1)
    if failed:
        print(f"out of tolerance: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
