"""Build and bind the port's CUDA kernels.

Each source ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library
with a plain C interface, loaded with ``ctypes``::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/torch_kernels/lib<name>-<hash>.so <name>.cu

The library lands in ``build/torch_kernels/`` at the repository root (the
``build/`` line of ``.gitignore`` covers it) at first use, and its file name
carries a hash of the sources and flags, so an edited source rebuilds.
Nothing here runs at import: the CPU tests import every module, and a CPU
tensor never reaches :func:`load_library`.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Optional

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BUILD_DIR = os.path.join(REPO_ROOT, "build", "torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# ctypes signatures of each library's C interface: pointers and the stream
# as c_void_p (a plain int would cut them to 32 bits), ints as c_int.
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "flash_attention": {
        "flash_attention_fwd": ([_P] * 5 + [_I] * 7 + [_P], _I),
        "flash_attention_stats_fwd": ([_P] * 7 + [_I] * 7 + [_P], _I),
        "kernel_error_string": ([_I], ctypes.c_char_p),
    },
    "levenshtein": {
        "levenshtein_fwd": ([_P] * 6 + [_I] * 2 + [_P], _I),
        "levenshtein_edge_words": ([_I] * 2, ctypes.c_longlong),
        "levenshtein_error_string": ([_I], ctypes.c_char_p),
    },
    # A throughput probe of the special function unit that chip_smoke.py
    # times; no path of the port calls it.
    "sfu_probe": {
        "sfu_probe": ([_I] * 4 + [_P] * 2, _I),
    },
}

_libs: dict = {}
_lock = threading.Lock()

# ``nvcc`` processes started by :func:`build` since the last reset. Serving
# never builds per version or per batch: a hot swap between two versions of
# one architecture runs the kernels already built, so this count does not
# move through one (the witness tests and chip_smoke.py read).
builds = 0


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.isfile(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (put nvcc on PATH or set CUDA_HOME)")


def library_path(name: str) -> str:
    """Where ``csrc/<name>.cu`` builds to: keyed by a hash of the source,
    every header beside it and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [os.path.join(CSRC_DIR, f"{name}.cu")] + sorted(
            glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(names: Optional[list] = None) -> dict:
    """Compile the named sources (default: every one in ``SIGNATURES``),
    one ``nvcc`` each, all started together. Returns ``{name: {"path",
    "seconds", "cached", "ptxas"}}``; raises ``RuntimeError`` with the
    compiler's output when a build fails."""
    global builds
    names = list(names or SIGNATURES)
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = None
    jobs = {}
    for name in names:
        out = library_path(name)
        if os.path.isfile(out):
            jobs[name] = (None, out, None, time.perf_counter())
            continue
        nvcc = nvcc or nvcc_path()
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        builds += 1
        jobs[name] = (proc, out, tmp, time.perf_counter())
    results = {}
    failures = []
    for name, (proc, out, tmp, t0) in jobs.items():
        if proc is None:
            results[name] = {"path": out, "seconds": 0.0, "cached": True,
                             "ptxas": ""}
            continue
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        results[name] = {"path": out, "seconds": seconds, "cached": False,
                         "ptxas": log}
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return results


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not os.path.isfile(path):
                build([name])
            lib = ctypes.CDLL(path)
            for fn, (argtypes, restype) in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _libs[name] = lib
    return lib
