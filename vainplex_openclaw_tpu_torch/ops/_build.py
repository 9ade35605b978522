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
constants (``FLASH_WARPS`` consumer warps of 16 query rows, four to a
warpgroup, ``FLASH_BN`` keys per tile; :func:`tile_defines`), so each (block_q, block_k) the kernel search
tries or the block table names is a library of its own, keyed by its
defines too. The default tiles add no define, and their library keeps the
path it has without one. The flash kernels above head dim 128 are one more
library of the same source, built with :data:`WIDE_DEFINES` and holding
only those kernels; the kernel search never builds it.

Host code in ``csrc/<name>.cpp`` (the tokenizer's pass) builds the same
way with the host C++ compiler instead of ``nvcc``
(:func:`load_host_library`), on any machine that has one, card or not::

    c++ -std=c++17 -O3 -shared -fPIC -o build/torch_kernels/lib<name>-<hash>.so <name>.cpp
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

from ..device import DeviceError

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BUILD_DIR = os.path.join(REPO_ROOT, "build", "torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# ctypes signatures of each library's C interface: pointers and the stream
# as c_void_p (a plain int would cut them to 32 bits), ints as c_int, the
# flash kernels' softmax scale as c_float.
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "flash_attention": {
        "flash_attention_fwd": ([_P] * 5 + [_I] * 7 + [_F, _P], _I),
        "flash_attention_stats_fwd": ([_P] * 7 + [_I] * 7 + [_F, _P], _I),
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

# The host libraries (``csrc/<name>.cpp``), built by the host C++ compiler.
HOST_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC")
_L = ctypes.c_longlong
HOST_SIGNATURES = {
    "tokenizer": {
        "tokenize_rows": ([ctypes.c_char_p, _P, _L, _I, _L, _P, _P, _P],
                          None),
    },
}

# The bf16 flash kernels' compiled default (block_q, block_k): one consumer
# warpgroup of 64 query rows, 64 keys per tile (csrc/flash_attention_mma.cuh).
DEFAULT_TILES = (64, 64)
# The tiles that body compiles: block_q one or two warpgroups of 64 rows,
# block_k a multiple of 16 (wgmma's k-step of P . V) up to 128 (wgmma's N
# of q . k^T, as far as the registers take it).
BLOCK_Q_SIDES = (64, 128)
BLOCK_K_SIDES = tuple(range(16, 129, 16))
SMEM_LIMIT = 227 * 1024  # bytes of shared memory a block may opt in to
# The flash library of head dims above 128 (csrc/flash_attention.cu).
WIDE_DEFINES = ("-DFLASH_WIDE=1",)

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
    raise DeviceError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (put nvcc on PATH or set CUDA_HOME)")


def tile_defines(tiles=None) -> tuple:
    """The ``-D`` flags of the flash kernels' tiles ``(block_q, block_k)``:
    () for None or :data:`DEFAULT_TILES`, else ``FLASH_WARPS`` =
    block_q / 16 and ``FLASH_BN`` = block_k. block_q must be one of
    :data:`BLOCK_Q_SIDES` and block_k one of :data:`BLOCK_K_SIDES`;
    anything else raises ``ValueError``."""
    if tiles is None or tuple(tiles) == DEFAULT_TILES:
        return ()
    bq, bk = (int(t) for t in tiles)
    if bq not in BLOCK_Q_SIDES or bk not in BLOCK_K_SIDES:
        raise ValueError(f"flash tiles {tuple(tiles)}: block_q must be 64 or "
                         "128 and block_k one of the multiples of 16 up to "
                         "128")
    return (f"-DFLASH_WARPS={bq // 16}", f"-DFLASH_BN={bk}")


def flash_smem_bytes(tiles, dh: int) -> int:
    """Dynamic shared memory of the bf16 flash body at ``tiles``
    ``(block_q, block_k)`` and compiled head dim ``dh``, as ``Tiles<DH>``
    in ``csrc/flash_attention_mma.cuh`` lays it out: 1024 bytes of
    alignment, Q, 2 to 4 stages of K, V and a bias row (as many as fit in
    100 KB beside Q), and two mbarriers a stage and Q's."""
    bq, bk = tiles
    q_bytes = bq * dh * 2
    stage = 2 * bk * dh * 2
    stages = max(2, min(4, (100 * 1024 - q_bytes) // stage))
    return 1024 + q_bytes + stages * (stage + bk * 4) + 8 * (2 * stages + 1)


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
    raises ``DeviceError`` (a ``RuntimeError``) with the compiler's output
    when a build fails."""
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
    # one waiter a process, so each build's seconds end when its own nvcc
    # does, not when the ones before it in the list do
    done: dict = {}

    def wait(key, proc):
        log, _ = proc.communicate()
        done[key] = (time.perf_counter(), log)

    waiters = [threading.Thread(target=wait, args=(key, job[0]))
               for key, job in running.items() if job[0] is not None]
    for w in waiters:
        w.start()
    for w in waiters:
        w.join()
    results = {}
    failures = []
    for key, (proc, out, tmp, t0) in running.items():
        if proc is None:
            results[key] = {"path": out, "seconds": 0.0, "cached": True,
                            "ptxas": ""}
            continue
        end, log = done[key]
        seconds = end - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"{key}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        results[key] = {"path": out, "seconds": seconds, "cached": False,
                        "ptxas": log}
    if failures:
        raise DeviceError("kernel build failed:\n" + "\n".join(failures))
    return results


def host_compiler() -> str:
    for name in ("c++", "g++"):
        found = shutil.which(name)
        if found:
            return found
    raise DeviceError("no host C++ compiler (c++ or g++) on PATH")


def host_library_path(name: str, compiler: str) -> str:
    """Where ``csrc/<name>.cpp`` builds to: keyed by a hash of the
    compiler, its flags and the source."""
    h = hashlib.sha256(" ".join((compiler, *HOST_FLAGS)).encode())
    with open(os.path.join(CSRC_DIR, f"{name}.cpp"), "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build_host(name: str) -> str:
    """Compile ``csrc/<name>.cpp`` with the host C++ compiler unless its
    library is there; returns the library's path. The compiler writes a
    temporary file that is renamed into place, so processes that build at
    once each rename a whole library. Raises ``DeviceError`` (a
    ``RuntimeError``) with the compiler's output when the build fails."""
    compiler = host_compiler()
    out = host_library_path(name, compiler)
    if os.path.isfile(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        proc = subprocess.run(
            [compiler, *HOST_FLAGS, "-o", tmp,
             os.path.join(CSRC_DIR, f"{name}.cpp")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise DeviceError(f"{name}: {compiler} exited "
                              f"{proc.returncode}\n{proc.stdout}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load_host_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cpp``, built first if needed;
    cached per name."""
    key = (name, "host")
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            lib = ctypes.CDLL(build_host(name))
            for fn, (argtypes, restype) in HOST_SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _libs[key] = lib
    return lib


def load_library(name: str, tiles=None, defines: tuple = ()) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` at the flash ``tiles``
    (None: the compiled default) and with ``defines`` (such as
    :data:`WIDE_DEFINES`), built first if needed; cached per (name,
    defines)."""
    defines = tile_defines(tiles) + tuple(defines)
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
