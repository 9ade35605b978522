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

A build may add ``-D`` defines: the flash kernels' tiles are compile-time
constants (``FLASH_WARPS`` query warps of 16 rows, ``FLASH_BN`` keys per
tile; :func:`tile_defines`), so each (block_q, block_k) the kernel search
tries or the block table names is a library of its own, keyed by its
defines too. The default tiles add no define, and their library keeps the
path it has without one.
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

# The bf16 flash kernels' compiled default (block_q, block_k): 4 warps of
# 16 query rows, 64 keys per tile (csrc/flash_attention_mma.cuh).
DEFAULT_TILES = (64, 64)

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


def tile_defines(tiles=None) -> tuple:
    """The ``-D`` flags of the flash kernels' tiles ``(block_q, block_k)``:
    () for None or :data:`DEFAULT_TILES`, else ``FLASH_WARPS`` =
    block_q / 16 and ``FLASH_BN`` = block_k. Both must be positive
    multiples of 16 (the kernel's row and key steps); anything else raises
    ``ValueError`` (the header checks its shared memory itself)."""
    if tiles is None or tuple(tiles) == DEFAULT_TILES:
        return ()
    bq, bk = (int(t) for t in tiles)
    if bq < 16 or bk < 16 or bq % 16 or bk % 16:
        raise ValueError(f"flash tiles {tuple(tiles)}: block_q and block_k "
                         "must be positive multiples of 16")
    return (f"-DFLASH_WARPS={bq // 16}", f"-DFLASH_BN={bk}")


def label(name: str, defines: tuple = ()) -> str:
    """A build's name in results and logs: ``name`` or ``name[-D…]``."""
    return f"{name}[{' '.join(defines)}]" if defines else name


def library_path(name: str, defines: tuple = ()) -> str:
    """Where ``csrc/<name>.cu`` builds to with ``defines``: keyed by a hash
    of the flags and defines, the source and every header beside it."""
    h = hashlib.sha256(" ".join((*NVCC_FLAGS, *defines)).encode())
    for path in [os.path.join(CSRC_DIR, f"{name}.cu")] + sorted(
            glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(names: Optional[list] = None, defines: tuple = ()) -> dict:
    """Compile the named sources (default: every one in ``SIGNATURES``)
    with ``defines``, one ``nvcc`` each, all started together. An entry of
    ``names`` may also be a ``(name, defines)`` pair, so that one call
    builds several variants of a source in parallel. Returns
    ``{label(name, defines): {"path", "seconds", "cached", "ptxas"}}``;
    raises ``RuntimeError`` with the compiler's output when a build
    fails."""
    global builds
    jobs = []
    for entry in names or list(SIGNATURES):
        name, defs = (entry, tuple(defines)) if isinstance(entry, str) \
            else (entry[0], tuple(entry[1]))
        if (name, defs) not in jobs:
            jobs.append((name, defs))
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = None
    running = {}
    for name, defs in jobs:
        out = library_path(name, defs)
        if os.path.isfile(out):
            running[label(name, defs)] = (None, out, None, time.perf_counter())
            continue
        nvcc = nvcc or nvcc_path()
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, *defs, "-o", tmp,
               os.path.join(CSRC_DIR, f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        builds += 1
        running[label(name, defs)] = (proc, out, tmp, time.perf_counter())
    results = {}
    failures = []
    for key, (proc, out, tmp, t0) in running.items():
        if proc is None:
            results[key] = {"path": out, "seconds": 0.0, "cached": True,
                            "ptxas": ""}
            continue
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"{key}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        results[key] = {"path": out, "seconds": seconds, "cached": False,
                        "ptxas": log}
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return results


def load_library(name: str, tiles=None) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` at the flash ``tiles``
    (None: the compiled default), built first if needed; cached per
    (name, tiles)."""
    defines = tile_defines(tiles)
    key = (name, defines)
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            path = library_path(name, defines)
            if not os.path.isfile(path):
                build([(name, defines)])
            lib = ctypes.CDLL(path)
            for fn, (argtypes, restype) in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _libs[key] = lib
    return lib
