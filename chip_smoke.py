#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and hold its
hand-written kernel against the kernel's plain PyTorch version.

Run from the repository root::

    python3 chip_smoke.py

The main path is the governance stage-3 local validator:
``make_local_call_llm()`` → ``ContinuousBatcher`` → ``encode_texts`` →
``load_pretrained`` (the shipped triage-tiny checkpoint, at its full
width) → ``forward`` with attention through the CUDA kernel →
``render_verdict``. Each phase prints one JSON line; any failure exits
non-zero before the last line is printed.

1. device: the card's name and power limit (``nvidia-smi``), or exit 1
   without a CUDA device;
2. build: ``nvcc`` builds every kernel library from the sources in
   ``vainplex_openclaw_tpu_torch/ops/csrc``;
3. kernels: each kernel against its plain version on the card, in bf16
   (tolerance 3e-2, the JAX suite's own bf16 bound) and fp32 (1e-4: the two
   sum in another order), over rows with at least one valid key, and every
   row finite;
4. forward: the port's forward on the card against the same forward on the
   CPU (the plain attention), on the shipped weights over 512 seeded texts
   and on random weights at ``EncoderConfig()`` width;
5. serve: 256 requests from 32 threads through ``make_local_call_llm()``
   with its defaults; verdicts equal the CPU one-shot oracle's, and the
   kernel's launch count, set to 0 just before, equals layers × batches;
   a second, profiled round gives the card's busy share while serving;
6. timing: the kernel, its plain version and
   ``F.scaled_dot_product_attention`` (a yardstick the port never calls) at
   the serve path's shape, with CUDA events, beside the least time the card
   could take for the same work.

Then one line ``{"kernels": [...]}`` and, last,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import threading
import time

# H100 SXM peaks (NVIDIA data sheet) for the bound: HBM bytes/s and dense
# bf16 tensor-core operations per second.
HBM_BYTES_PER_S = 3.35e12
PEAK_BF16_OPS_PER_S = 989e12
TOL = {"bfloat16": 3e-2, "float32": 1e-4}
SOURCE = "vainplex_openclaw_tpu_torch/ops/csrc/flash_attention.cu"
REPLACES = "vainplex_openclaw_tpu/ops/flash_attention.py:130"

# (name, B, H, Lq, Lk, Dh, causal, masked)
KERNEL_CASES = [
    ("serve_path", 32, 4, 64, 64, 16, False, True),
    ("encoder_default_width", 32, 8, 128, 128, 32, False, True),
    ("mfu_shape", 4, 16, 2048, 2048, 64, False, True),
    ("causal", 2, 4, 256, 256, 32, True, False),
    ("causal_masked", 2, 4, 96, 96, 16, True, True),
    ("cross_length", 2, 4, 96, 200, 64, False, True),
    ("unaligned_100", 3, 4, 100, 100, 16, False, True),
    ("head_dim_128", 2, 2, 130, 130, 128, False, True),
]

_SUBJECTS = ("deploy", "api-server", "billing-job", "auth-service", "cache",
             "db-migration", "ingress", "webhook", "release", "audit")
_TEMPLATES = (
    "tool {n} failed: connection refused after {i} retries",
    "error: deployment {n} exceeded progress deadline",
    "no, that's wrong — {n} is still failing and this is useless",
    "permission denied writing to {n}",
    "rate limit hit calling {n}, backing off {i}s",
    "we decided to ship {n} tomorrow because the fix is ready",
    "thanks, {n} works perfectly now",
    "looks good, merging {n}",
    "reading file {n} ({i} bytes)",
    "what does the {n} flag do again?",
)


class SmokeFailure(Exception):
    pass


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def seeded_texts(n: int, seed: int) -> list:
    import numpy as np

    rng = np.random.default_rng(seed)
    return [_TEMPLATES[rng.integers(len(_TEMPLATES))].format(
        n=_SUBJECTS[rng.integers(len(_SUBJECTS))], i=int(rng.integers(2, 500)))
        for _ in range(n)]


def as_prompt(text: str) -> str:
    """The stage-3 prompt shape the serve seam cuts the message out of."""
    return ("You are reviewing an outbound message.\n\nKNOWN FACTS:\n- (none)"
            f"\n\nMESSAGE:\n{text}\n\nIdentify issues in these categories.")


def make_qkv(rng, B, H, Lq, Lk, Dh, dtype, masked, device):
    import numpy as np
    import torch

    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(device=device, dtype=dtype)
               for s in ((B, H, Lq, Dh), (B, H, Lk, Dh), (B, H, Lk, Dh)))
    if not masked:
        return q, k, v, None
    lengths = rng.integers(1, Lk + 1, size=B)
    lengths[-(B // 4 or 1):] = 0  # the batcher's zero-pad rows
    if B > 2:
        lengths[0] = Lk
    mask = torch.from_numpy(np.arange(Lk)[None, :] < lengths[:, None])
    return q, k, v, mask.to(device)


def valid_rows(mask, B, Lq, Lk, causal, device):
    """[B, 1, Lq, 1] bool: the query rows that see at least one valid key."""
    import torch

    m = torch.ones((B, Lk), dtype=torch.bool, device=device) \
        if mask is None else mask
    if causal:
        seen = torch.cumsum(m.int(), dim=1)[:, :Lq] > 0
    else:
        seen = m.any(dim=1, keepdim=True).expand(B, Lq)
    return seen[:, None, :, None]


def phase_device() -> dict:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        sys.exit(1)
    import vainplex_openclaw_tpu_torch  # noqa: F401 — fail before any output

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    line = smi.stdout.strip().splitlines()[0]
    print(line, flush=True)
    info = {"phase": "device", "nvidia_smi": line,
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(info)
    return info


def phase_build() -> None:
    from vainplex_openclaw_tpu_torch.ops import _build

    t0 = time.perf_counter()
    results = _build.build()
    for name, r in results.items():
        print(f"[ptxas {name}]\n{r['ptxas']}", file=sys.stderr, flush=True)
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "libraries": {n: {"seconds": round(r["seconds"], 3),
                            "cached": r["cached"]}
                        for n, r in results.items()}})


def phase_kernels() -> float:
    import numpy as np
    import torch

    from vainplex_openclaw_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference)

    rng = np.random.default_rng(0)
    cases = []
    worst = 0.0
    for name, B, H, Lq, Lk, Dh, causal, masked in KERNEL_CASES:
        for dt_name, dtype in (("bfloat16", torch.bfloat16),
                               ("float32", torch.float32)):
            q, k, v, mask = make_qkv(rng, B, H, Lq, Lk, Dh, dtype, masked,
                                     "cuda")
            out = flash_attention(q, k, v, mask, causal=causal)
            ref = flash_attention_reference(q, k, v, mask, causal=causal)
            torch.cuda.synchronize()
            check(out.dtype == q.dtype and out.shape == q.shape,
                  f"{name}/{dt_name}: output {out.dtype} {tuple(out.shape)}")
            check(bool(torch.isfinite(out.float()).all()),
                  f"{name}/{dt_name}: non-finite output")
            rows = valid_rows(mask, B, Lq, Lk, causal, "cuda")
            err = float(((out.float() - ref.float()).abs() * rows).max())
            check(err <= TOL[dt_name],
                  f"{name}/{dt_name}: max |kernel - plain| {err} > "
                  f"{TOL[dt_name]}")
            worst = max(worst, err)
            cases.append({"case": name, "dtype": dt_name,
                          "shape": [B, H, Lq, Lk, Dh], "causal": causal,
                          "max_abs_err": err, "tol": TOL[dt_name]})
    emit({"phase": "kernels", "kernels": [
        {"name": "flash_attention", "max_abs_err": worst, "cases": cases}]})
    return worst


def random_tree(cfg, seed: int) -> dict:
    """A JAX-layout parameter tree from a numpy seed, scaled like
    ``init_params`` (embeddings 0.02, matrices 1/√fan_in, norms ones)."""
    import numpy as np

    from vainplex_openclaw_tpu_torch.models.encoder import (
        param_shapes, unflatten_tree)

    rng = np.random.default_rng(seed)
    flat = {}
    for key, shape in param_shapes(cfg).items():
        if key.endswith("/scale"):
            flat[key] = np.ones(shape, np.float32)
        else:
            std = 0.02 if key.startswith("embed/") else 1 / math.sqrt(shape[0])
            flat[key] = (rng.standard_normal(shape) * std).astype(np.float32)
    return unflatten_tree(flat)


def compare_outputs(a: dict, b: dict) -> float:
    return max(float((a[h].float().cpu() - b[h].float().cpu()).abs().max())
               for h in ("severity", "keep", "mood", "embedding"))


def phase_forward() -> None:
    import dataclasses

    import numpy as np
    import torch

    from vainplex_openclaw_tpu_torch.models import (
        EncoderConfig, encode_texts, forward, params_from_numpy)
    from vainplex_openclaw_tpu_torch.models.pretrained import load_pretrained

    record = {"phase": "forward"}
    cfg, p_gpu = load_pretrained()
    _, p_cpu = load_pretrained(device="cpu")
    tokens = torch.from_numpy(encode_texts(seeded_texts(512, seed=0),
                                           cfg.seq_len, cfg.vocab_size))
    with torch.inference_mode():
        gpu = forward(p_gpu, tokens.cuda(), cfg)
        cpu = forward(p_cpu, tokens, cfg)
    err = compare_outputs(gpu, cpu)
    same = bool((gpu["severity"].cpu().argmax(-1)
                 == cpu["severity"].argmax(-1)).all())
    check(same, "shipped checkpoint: severity argmax differs card vs CPU")
    check(err <= 5e-2, f"shipped checkpoint: logits differ by {err} > 5e-2")
    record["shipped"] = {"texts": 512, "argmax_equal": same,
                         "max_abs_err": err, "tol": 5e-2}

    wide = EncoderConfig()
    tree = random_tree(wide, seed=1)
    rng = np.random.default_rng(2)
    lengths = rng.integers(1, wide.seq_len + 1, size=32)
    lengths[-4:] = 0
    tok = rng.integers(2, wide.vocab_size, size=(32, wide.seq_len))
    tok[:, 0] = 1
    tok[np.arange(wide.seq_len)[None, :] >= lengths[:, None]] = 0
    tok = torch.from_numpy(tok.astype(np.int32))
    for dt_name, tol in (("float32", 1e-4), ("bfloat16", 5e-2)):
        c = dataclasses.replace(wide, dtype=dt_name)
        with torch.inference_mode():
            gpu = forward(params_from_numpy(tree, c, "cuda"), tok.cuda(), c)
            cpu = forward(params_from_numpy(tree, c, "cpu"), tok, c)
        err = compare_outputs(gpu, cpu)
        check(all(bool(torch.isfinite(gpu[h]).all()) for h in gpu),
              f"random weights {dt_name}: non-finite output")
        check(err <= tol, f"random weights {dt_name}: outputs differ by "
                          f"{err} > {tol}")
        record[f"random_{dt_name}"] = {"batch": 32, "max_abs_err": err,
                                       "tol": tol}
    emit(record)


def serve_round(call, prompts: list, n_threads: int):
    """Every prompt through ``call`` from ``n_threads`` threads; returns
    (verdicts, per-request ms, wall s, errors)."""
    got: list = [None] * len(prompts)
    latency: list = [0.0] * len(prompts)
    errors: list = []

    def worker(w: int) -> None:
        try:
            for i in range(w, len(prompts), n_threads):
                t = time.perf_counter()
                got[i] = call(prompts[i])
                latency[i] = (time.perf_counter() - t) * 1e3
        except Exception as exc:  # noqa: BLE001 — reported by the caller
            errors.append(repr(exc))

    threads = [threading.Thread(target=worker, args=(w,))
               for w in range(n_threads)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(300.0)
    check(not any(t.is_alive() for t in threads), "serve threads hung")
    return got, latency, time.perf_counter() - t0, errors


def device_busy(prof, wall_s: float) -> dict:
    """Device time of every kernel and copy in a profiled window, its share
    of the window's wall time, and the five largest entries."""
    rows = []
    for evt in prof.key_averages():
        t = (getattr(evt, "self_device_time_total", None)
             or getattr(evt, "self_cuda_time_total", 0.0) or 0.0)
        if t > 0:
            rows.append((t, evt.key, evt.count))
    total_us = sum(r[0] for r in rows)
    rows.sort(reverse=True)
    return {"device_ms": total_us / 1e3,
            "busy_share": total_us / 1e6 / wall_s,
            "top": [{"name": k[:80], "device_ms": t / 1e3, "count": c}
                    for t, k, c in rows[:5]]}


def phase_serve() -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vainplex_openclaw_tpu_torch.models import serve
    from vainplex_openclaw_tpu_torch.models.pretrained import load_pretrained
    from vainplex_openclaw_tpu_torch.ops import flash_attention as fa

    n_requests, n_threads = 256, 32
    prompts = [as_prompt(t) for t in seeded_texts(n_requests, seed=3)]
    oracle_call = serve.make_local_call_llm(
        serve_cfg={"continuousBatching": False}, device="cpu")
    oracle = [oracle_call(p) for p in prompts]

    call = serve.make_local_call_llm()
    batcher = call.batcher
    cfg, _ = load_pretrained()
    # The collector thread's first forward sets up its own cuBLAS handle:
    # one request first, timed on its own, outside the counted run.
    t = time.perf_counter()
    call(as_prompt("warm-up request"))
    first_ms = (time.perf_counter() - t) * 1e3

    batches0, served0 = batcher.batches, batcher.served
    torch.cuda.synchronize()
    fa.launches = 0
    got, latency, wall, errors = serve_round(call, prompts, n_threads)
    launches = fa.launches
    batches = batcher.batches - batches0
    served = batcher.served - served0
    check(not errors, f"serve errors: {errors[:3]}")
    check(served == n_requests, f"served {served} of {n_requests}")
    mismatches = sum(a != b for a, b in zip(got, oracle))
    check(mismatches == 0, f"{mismatches} verdicts differ from the CPU "
                           "one-shot oracle")
    check(launches > 0 and launches == cfg.n_layers * batches,
          f"flash_attention launches {launches} != {cfg.n_layers} layers × "
          f"{batches} batches")
    snap = batcher.timer.snapshot()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        got2, _, wall2, errors2 = serve_round(call, prompts, n_threads)
        torch.cuda.synchronize()
    check(not errors2 and got2 == oracle, "profiled serve round differs")

    lat = sorted(latency)
    record = {"phase": "serve", "requests": n_requests, "threads": n_threads,
              "served": served, "batches": batches,
              "mean_batch": served / batches, "verdict_mismatches": 0,
              "flash_attention_launches": launches,
              "first_request_ms": first_ms,
              "requests_per_s": n_requests / wall,
              "latency_ms": {"p50": lat[len(lat) // 2],
                             "p99": lat[min(len(lat) - 1,
                                            int(0.99 * len(lat)))],
                             "max": lat[-1]},
              "stage_quantiles_ms": snap["quantiles"],
              "stage_ms": snap["stages_ms"],
              "stage_counts": snap["counts"],
              "profiled_round": {"wall_s": wall2,
                                 **device_busy(prof, wall2)}}
    emit(record)
    serve.close_batchers()
    return {"launches": launches}


def time_ms(fn, n: int = 200, reps: int = 15, warmup: int = 20) -> float:
    """Median over ``reps`` of CUDA-event time per call across ``n``
    back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / n)
    return statistics.median(samples)


def device_kernel_ms(fn, n: int = 50) -> "float | None":
    """Mean device time of the CUDA kernels ``fn`` launches, from the
    profiler; None when the profiler reports no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total_ms = device_busy(prof, 1.0)["device_ms"]
    return total_ms / n if total_ms > 0 else None


def phase_timing() -> dict:
    import numpy as np
    import torch
    import torch.nn.functional as F

    from vainplex_openclaw_tpu_torch.models import encode_texts, forward
    from vainplex_openclaw_tpu_torch.models.pretrained import load_pretrained
    from vainplex_openclaw_tpu_torch.ops import _build
    from vainplex_openclaw_tpu_torch.ops import flash_attention as fa

    B, H, L, Dh = 32, 4, 64, 16
    q, k, v, mask = make_qkv(np.random.default_rng(4), B, H, L, L, Dh,
                             torch.bfloat16, True, "cuda")
    bias = fa._bias(mask, B, L, q.device)
    out = torch.empty_like(q)
    lib = _build.load_library("flash_attention")

    def kernel():
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            out.data_ptr(), B, H, L, L, Dh, fa._DTYPE_CODES[q.dtype], 0,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise SmokeFailure(f"timing launch failed: CUDA error {err}")

    def wrapper():
        fa.flash_attention(q, k, v, mask)

    def plain():
        fa.flash_attention_reference(q, k, v, mask)

    sdpa_mask = bias.to(q.dtype)[:, None, None, :]

    def library():
        F.scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask)

    # kernel, plain, plain, kernel: compare within one call, in turns
    kernel_ms = [time_ms(kernel)]
    plain_ms = [time_ms(plain)]
    plain_ms.append(time_ms(plain))
    kernel_ms.append(time_ms(kernel))
    wrapper_ms = time_ms(wrapper)
    library_ms = time_ms(library)
    kernel_device_ms = device_kernel_ms(kernel)

    elem = q.element_size()
    n_bytes = 4 * B * H * L * Dh * elem + B * L * 4
    n_ops = 4 * B * H * L * L * Dh
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_BF16_OPS_PER_S * 1e3
    bound_ms = max(t_bytes, t_ops)

    cfg, params = load_pretrained()
    tokens = torch.from_numpy(encode_texts(seeded_texts(B, seed=5),
                                           cfg.seq_len, cfg.vocab_size)).cuda()
    torch.cuda.synchronize()
    fa.launches = 0
    with torch.inference_mode():
        forward(params, tokens, cfg)
    torch.cuda.synchronize()
    per_forward = fa.launches
    check(per_forward == cfg.n_layers,
          f"launches per forward {per_forward} != n_layers {cfg.n_layers}")

    record = {"phase": "timing", "shape": [B, H, L, L, Dh],
              "dtype": "bfloat16",
              "kernel_ms": statistics.median(kernel_ms),
              "kernel_ms_runs": kernel_ms,
              "kernel_device_ms": kernel_device_ms,
              "wrapper_ms": wrapper_ms,
              "plain_ms": statistics.median(plain_ms),
              "plain_ms_runs": plain_ms,
              "library_ms": library_ms,
              "bound_ms": bound_ms, "bound_by":
                  "bytes" if t_bytes >= t_ops else "operations",
              "bytes": n_bytes, "operations": n_ops,
              "launches_per_forward": per_forward}
    emit(record)
    return record


def main() -> int:
    info = phase_device()
    try:
        import torch

        torch.backends.cuda.matmul.allow_tf32 = False  # fp32 stays fp32
        torch.backends.cudnn.allow_tf32 = False
        phase_build()
        worst = phase_kernels()
        phase_forward()
        served = phase_serve()
        timing = phase_timing()
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr, flush=True)
        return 1
    emit({"kernels": [{
        "name": "flash_attention", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": served["launches"],
        "max_abs_err": worst, "ms": timing["kernel_ms"],
        "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"], "library_ms": timing["library_ms"]}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
