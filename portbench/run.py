"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The run loads the cell's configuration and
traffic (``portbench/spec.py`` finds them by name), warms the shapes this
traffic uses, measures for ``--seconds``, shuts the program down, checks
what the window produced against the plain reference, and prints one JSON
line last on standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device`` and, traced, ``breakdown``; its last key,
``checks``, holds each number compared beside its limit, and the same
lines end standard error.

It needs as many CUDA cards as the cell asks for and exits with 2 and no
result line without them; it exits with 3 and no result if the process
holds JAX or the JAX package once the window has closed. The port's
kernels build into ``build/torch_kernels/`` inside the checkout;
``TRITON_CACHE_DIR`` and ``TORCH_EXTENSIONS_DIR`` are pinned under
``build/`` too, where the environment does not set them.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "vainplex_openclaw_tpu")


class Refused(Exception):
    """The run cannot measure here; no result is printed."""

    def __init__(self, msg: str, code: int):
        super().__init__(msg)
        self.code = code


@dataclass
class Run:
    root: str
    cell: dict
    config: dict
    mix: dict
    seed: int
    device: str


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the run must not hold,
    compared whole (``vainplex_openclaw_tpu_torch`` is the port)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def device_info(torch, count: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(d)
                                     for d in range(count))}


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them, or
    the reason it could not."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable: {exc}"


def gate(numbers: dict, limits: dict) -> dict:
    """Each number compared beside its limit."""
    return {key: {"value": value, "limit": limits[key]["limit"]}
            for key, value in numbers.items()}


def passes(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def execute(spec, name: str, seed: int, seconds: float, traced: bool,
            device: str = "cuda", control: bool = False,
            t_process: float = None) -> dict:
    """One run of cell ``name``; returns the result object (the last line)
    and, under ``"_info"``, what the check looked at. With ``control``,
    ``"_control"`` holds the control's numbers through the same gate
    (``correct`` and ``checks``). ``device="cpu"`` is for the tests
    alone: it skips the look for a card, and the device metrics read
    nothing."""
    import torch

    from portbench.trace import DeviceTrace, Spans

    t_process = time.perf_counter() if t_process is None else t_process
    cell = spec.cell(name)
    if device == "cuda":
        if not torch.cuda.is_available():
            raise Refused("no CUDA device: this benchmark measures the card "
                          "and never falls back to the CPU", 2)
        if torch.cuda.device_count() < int(cell["chips"]):
            raise Refused(f"the cell needs {cell['chips']} cards, "
                          f"{torch.cuda.device_count()} visible", 2)
    mix = spec.traffic(cell)
    run = Run(spec.root, cell, spec.config(cell), mix, int(seed), device)
    limits = spec.limits(cell)
    runner = spec.entry(mix).Runner(run)
    spans = None
    try:
        runner.warm()
        tracer = None
        if traced and device == "cuda":
            tracer = DeviceTrace()
            tracer.warm()
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - t_process
        if traced:
            spans = Spans()
            spans.install()
        window = runner.window(float(seconds), tracer, spans,
                               mix.get("profile"))
        if spans is not None:
            spans.remove()
            spans = None
        if tracer is not None and window.trace is None:
            raise RuntimeError(
                "the profiler handed back no kernel in any sub-window of "
                f"the window ({tracer.misses}): the device metrics cannot "
                "be read")
        held = forbidden_modules()
        if held:
            raise Refused("the process holds " + ", ".join(held)
                          + " after the window", 3)
        dev = device_info(torch, int(cell["chips"])) if device == "cuda" \
            else {"platform": "cpu", "kind": "cpu", "count": 0,
                  "memory_peak_bytes": 0}
        runner.close()
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        numbers, info, low = runner.check(control=control)
    finally:
        if spans is not None:
            spans.remove()

    metrics = {}
    for m in spec.metrics(cell, traced):
        value = spec.reader(m).read(window, setup_s=setup_s)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = gate(numbers, limits)
    correct = window.units > 0 and passes(checks)
    result = {"correct": correct, "attempted": window.attempted,
              "failed": int(numbers.get("failed", 0)), "metrics": metrics,
              "device": dev}
    if tracer is not None and tracer.misses:
        info["empty_sub_windows"] = tracer.misses
    if traced and window.trace is not None:
        result["device"]["busy_s"] = window.trace["busy_s"]
        result["device"]["window_s"] = window.trace["window_s"]
        result["breakdown"] = window.trace["breakdown"]
    result["checks"] = checks
    result["_info"] = info
    if low is not None:
        result["_control"] = {"correct": passes(gate(low, limits)),
                              "checks": gate(low, limits)}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench.spec import ROOT, Spec

    build = os.path.join(ROOT, "build")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(build, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(build, "torch_extensions"))
    try:
        result = execute(Spec(ROOT), args.workload, args.seed, args.seconds,
                         bool(args.trace), t_process=T_PROCESS)
    except Refused as exc:
        print(f"portbench: {exc}", file=sys.stderr, flush=True)
        return exc.code
    info = result.pop("_info")
    result.pop("_control", None)
    held = forbidden_modules()
    if held:
        print("portbench: the process holds " + ", ".join(held),
              file=sys.stderr, flush=True)
        return 3
    print("portbench: card " + power_limit() + "; checked "
          + json.dumps(info), file=sys.stderr)
    for key, c in result["checks"].items():
        print(f"check {key} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
