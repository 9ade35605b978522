"""Offline tile search for the flash kernels K1 and K2.

Counterpart of ``vainplex_openclaw_tpu/ops/kernel_search.py``. The loop
sweeps (block_q, block_k) candidates per (family, dtype, pow2 length
bucket), timing ``steps`` serially data-dependent K1 calls per round at
JAX's point shape (B=4, H=8, Dh=64): each output, rescaled by 1/1.125,
feeds the next query, so no call can be skipped or overlapped with the
next. A candidate wins its bucket only when it is measured faster than
the incumbent (``default_block``'s tiles) by more than ``MIN_GAIN`` and
more than either record's spread, AND no kernel was built during its
timed rounds (the witness, ``analysis.witness``). JAX's gate has no
margin; on the card a step at a short length is the host's launches, and
a gain inside their noise would pick the tile. Winners land in the
block table (``ops/flash_block_table.json``) that each launch reads;
:func:`validate_table` is the gate a table must pass before it is
written.

On the card the bf16 kernel's tiles are compile-time constants
(``FLASH_WARPS`` warps of 16 query rows, ``FLASH_BN`` keys per tile), so
a candidate is a library of its own: :func:`measure_point` builds it
before anything is timed, then holds its K1 and K2 against their plain
versions at the point shape (bf16 3e-2 per row, fp32 1e-4), with a
control from ``CONTROL_MIN_L`` keys: the same measure must fail the plain
version without its first key tile. Then it times the candidate. A
candidate that fails to build, to launch or to agree becomes an
``{"error": …}`` record, and the sweep goes on: a failed candidate is
data. The candidate sides are (64, 128), clamped to the padded length
as JAX clamps them; the kernel takes block_q 64 or 128 and block_k a
multiple of 16 up to 128. The compiled
default 64×64 is the incumbent wherever the table has no row.

Seeded and resumable (``ops/search_common.py``): inputs come from a
generator seeded by (seed, L), and each finished point is persisted as it
lands, so a killed sweep resumes from its last finished point.

On the CPU the wrapper runs the plain version, so a CPU sweep times that
and proves the harness only; it can never write a ``cuda:`` row. On the
card ``chip_smoke.py`` runs the search (its ``kernel_search`` phase).
"""

from __future__ import annotations

import json
import os
import statistics
import time

import torch

from ..device import DeviceLike, backend_family, resolve_device
from .flash_attention import default_block, table_key
from .search_common import SweepState, config_key
from .similarity import pow2_bucket

#: candidate sides on the H100, for block_q and block_k alike: one or two
#: consumer warpgroups of 64 query rows, and 64 or 128 keys a tile
#: (``csrc/flash_attention_mma.cuh``; ``_build.tile_defines`` takes them).
DEFAULT_CANDIDATES = (64, 128)
#: (B, H, Dh) of the point a candidate is timed at (JAX ``_point_runner``).
POINT_SHAPE = (4, 8, 64)
#: K1/K2 against their plain versions at the point shape, per dtype (bf16
#: per row, fp32 absolute: :func:`held_error`).
PARITY_TOL = {"bfloat16": 3e-2, "float32": 1e-4}
#: the control: the plain version without its first key tile, at lengths
#: of at least ``CONTROL_MIN_L`` (below, one tile is much of the keys)
CONTROL_KEYS = 64
CONTROL_MIN_L = 2048
#: the gate's margin: a candidate must beat the incumbent by this share
#: and by each record's own spread (JAX's gate has no margin)
MIN_GAIN = 0.05
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _ceil8(n: int) -> int:
    return max(8, -(-n // 8) * 8)


def bucket_key(L: int, dtype: str = "bfloat16",
               family: "str | None" = None) -> str:
    """Alias of :func:`~.flash_attention.table_key`: the search writes
    keys with the function the launch reads them with."""
    return table_key(L, dtype, family)


def candidate_pairs(L: int, blocks: tuple = DEFAULT_CANDIDATES,
                    dtype: str = "bfloat16",
                    family: "str | None" = None) -> list:
    """(block_q, block_k) sweep for one length: the incumbent first (the
    baseline every candidate must beat), then the square and rectangular
    pairs of ``blocks`` clamped to the padded roundup of L."""
    lim = _ceil8(L)
    incumbent = (min(default_block(L, dtype, "q", family), lim),
                 min(default_block(L, dtype, "k", family), lim))
    sizes = sorted({min(b, lim) for b in blocks if b >= 8})
    pairs = [incumbent]
    for bq in sizes:
        for bk in sizes:
            if (bq, bk) != incumbent:
                pairs.append((bq, bk))
    return pairs


# ── one measured point ───────────────────────────────────────────────


def point_inputs(L: int, dtype: str, seed: int, device,
                 shape: tuple = POINT_SHAPE) -> tuple:
    """(q0, k, v) ``[B, H, L, Dh]`` in ``dtype`` on ``device``, drawn on
    the CPU from a generator seeded by (seed, L), so the card and the CPU
    see the same values."""
    B, H, Dh = shape
    gen = torch.Generator().manual_seed(seed * 1_000_003 + L)
    return tuple(torch.randn((B, H, L, Dh), generator=gen)
                 .to(_DTYPES[dtype]).to(device) for _ in range(3))


def _chain(q0, k, v, tiles: tuple, steps: int):
    """``steps`` K1 calls, each output rescaled into the next query."""
    from .flash_attention import flash_attention

    q = q0
    for _ in range(steps):
        o = flash_attention(q, k, v, block_q=tiles[0], block_k=tiles[1])
        q = (o.float() / 1.125).to(q.dtype)
    return q


def held_error(got, want, per_row: bool) -> float:
    """The error a tile is held to: max |got − want|, absolute, or with
    ``per_row`` the largest over rows of each row's max |got − want| over
    its largest |want|. bf16 keeps 8 bits of each value, so it is held per
    row: a row that averages 16384 keys has |out| ~ 0.01, where an
    absolute 3e-2 would pass a kernel that dropped a key tile."""
    d = (got.float() - want.float()).abs()
    if not per_row:
        return float(d.max())
    scale = want.float().abs().amax(dim=-1).clamp_min(1e-30)
    return float((d.amax(dim=-1) / scale).max())


def _slice_errors(out, stats, ref, ref_stats, per_row: bool) -> tuple:
    """(K1, K2) error of one (batch, head) slice. K1: :func:`held_error`
    of the output. K2: the largest of |Δm|, |Δl| / l and acc's
    :func:`held_error` (per row, or over l when absolute: acc and l grow
    with the key count)."""
    (acc, m, l), (acc_r, m_r, l_r) = stats, ref_stats
    scale = l_r.clamp_min(1e-30)
    if per_row:
        acc_err = held_error(acc, acc_r, True)
    else:
        acc_err = float(((acc - acc_r).abs().amax(-1) / scale).max())
    k2 = max(float((m - m_r).abs().max()),
             float(((l - l_r).abs() / scale).max()), acc_err)
    return held_error(out, ref, per_row), k2


def parity_errors(q, k, v, tiles: tuple, mask=None, causal: bool = False,
                  control: bool = False) -> dict:
    """K1 and K2 of the kernel at ``tiles`` against their plain versions
    on the same inputs, one (batch, head) slice at a time (the dense plain
    version of a whole point would not fit): ``{"k1", "k2"}``, bf16 held
    per row and fp32 absolutely (:func:`held_error`), and ``max_abs_err``,
    K1's absolute error. With ``control``, also ``k1_control`` and
    ``k2_control``: the same measures of the plain version without its
    first ``CONTROL_KEYS`` keys, as a kernel that skipped its first key
    tile would compute (not under ``causal``, where the first keys are
    all an early query sees). A check that passes them could not see such
    a fault at this length."""
    from .flash_attention import flash_attention, \
        flash_attention_stats_reference

    per_row = q.dtype == torch.bfloat16
    control = control and not causal
    got: dict = {"k1": 0.0, "k2": 0.0, "max_abs_err": 0.0}
    if control:
        got.update(k1_control=0.0, k2_control=0.0)
    with torch.inference_mode():
        out = flash_attention(q, k, v, mask, causal=causal,
                              block_q=tiles[0], block_k=tiles[1])
        stats = flash_attention(q, k, v, mask, causal=causal,
                                return_stats=True, block_q=tiles[0],
                                block_k=tiles[1])
        B, H = q.shape[:2]
        for b in range(B):
            mb = None if mask is None else mask[b:b + 1].contiguous()
            for h in range(H):
                qs, ks, vs = (t[b:b + 1, h:h + 1].contiguous()
                              for t in (q, k, v))
                acc_r, m_r, l_r = flash_attention_stats_reference(
                    qs, ks, vs, mb, causal=causal)
                # K1's plain version from the same pass, as
                # flash_attention_reference computes it
                ref = (acc_r / l_r.clamp_min(1e-30)[..., None]).to(q.dtype)
                ref_stats = (acc_r[0, 0], m_r[0, 0], l_r[0, 0])
                k1, k2 = _slice_errors(
                    out[b, h], tuple(t[b, h] for t in stats), ref[0, 0],
                    ref_stats, per_row)
                got["k1"] = max(got["k1"], k1)
                got["k2"] = max(got["k2"], k2)
                got["max_abs_err"] = max(got["max_abs_err"], float(
                    (out[b, h].float() - ref[0, 0].float()).abs().max()))
                if not control:
                    continue
                dk, dv = (t[:, :, CONTROL_KEYS:].contiguous()
                          for t in (ks, vs))
                dm = None if mb is None else mb[:, CONTROL_KEYS:].contiguous()
                acc_d, m_d, l_d = flash_attention_stats_reference(qs, dk, dv,
                                                                  dm)
                dropped = (acc_d / l_d.clamp_min(1e-30)[..., None]) \
                    .to(q.dtype)
                c1, c2 = _slice_errors(
                    dropped[0, 0], (acc_d[0, 0], m_d[0, 0], l_d[0, 0]),
                    ref[0, 0], ref_stats, per_row)
                got["k1_control"] = max(got["k1_control"], c1)
                got["k2_control"] = max(got["k2_control"], c2)
    return got


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_point(L: int, block_q: int, block_k: int, *,
                  dtype: str = "bfloat16", steps: int = 4, rounds: int = 3,
                  seed: int = 0, clock=time.perf_counter,
                  device: DeviceLike = None) -> dict:
    """Time one (L, block_q, block_k) candidate. On the card its library
    is built first and its K1 and K2 held against the plain versions
    (:func:`parity_errors`, with the control from ``CONTROL_MIN_L``
    keys); then the chain runs once untimed and ``rounds`` times timed,
    each round fenced by a synchronize on both sides. The record carries
    the median ms per call, the relative spread, ``retraces`` (kernel
    builds the witness saw during the timed rounds: 0 for a clean
    candidate) and ``launches`` (K1 launches in them: steps × rounds on
    the card, 0 on the CPU, where the plain version runs). A build,
    launch or parity failure, or a control the check passes, comes back
    as an ``{"error": …}`` record."""
    from ..analysis import RetraceWitness
    from . import _build

    dev = resolve_device(device)
    tiles = (int(block_q), int(block_k))
    rec = {"seq_len": L, "block_q": block_q, "block_k": block_k,
           "dtype": dtype, "steps": steps, "rounds": rounds, "seed": seed}
    try:
        if dev.type == "cuda":
            _build.build([("flash_attention", _build.tile_defines(tiles))])
        q0, k, v = point_inputs(L, dtype, seed, dev)
        errs = parity_errors(q0, k, v, tiles, control=L >= CONTROL_MIN_L)
        rec.update({"k1_err": errs["k1"], "k2_err": errs["k2"],
                    "max_abs_err": errs["max_abs_err"]})
        tol = PARITY_TOL[dtype]
        if not (errs["k1"] <= tol and errs["k2"] <= tol):
            rec["error"] = (f"parity: K1 {errs['k1']:.3g}, K2 "
                            f"{errs['k2']:.3g} against the plain versions "
                            f"(tolerance {tol})")
            return rec
        if "k1_control" in errs:
            rec.update({"k1_control": errs["k1_control"],
                        "k2_control": errs["k2_control"]})
            if not (errs["k1_control"] > tol and errs["k2_control"] > tol):
                rec["error"] = (
                    f"parity: the check passes the plain version without "
                    f"its first {CONTROL_KEYS} keys (K1 "
                    f"{errs['k1_control']:.3g}, K2 "
                    f"{errs['k2_control']:.3g}, tolerance {tol})")
                return rec
        with torch.inference_mode():
            _chain(q0, k, v, tiles, steps)  # warm-up (excluded)
        _sync(dev)
    except Exception as exc:  # noqa: BLE001 — a rejected candidate is data
        rec["error"] = str(exc)[:200]
        return rec
    witness = RetraceWitness.armed()
    base = witness.baseline()  # after the warm-up, before the timed rounds
    samples = []
    with torch.inference_mode():
        for _ in range(max(1, rounds)):
            _sync(dev)
            t0 = clock()
            _chain(q0, k, v, tiles, steps)
            _sync(dev)
            samples.append((clock() - t0) / steps * 1e3)
    med = statistics.median(samples)
    rec.update({
        "ms": round(med, 4),
        "spread": round((max(samples) - min(samples)) / med, 3) if med
        else 0.0,
        "retraces": witness.traces("builds") - base["builds"],
        "launches": witness.launched("k1"),
    })
    return rec


def clears_gate(cand: dict, best: dict) -> bool:
    """The gate: no build while timed, AND faster than ``best`` by more
    than ``MIN_GAIN`` and more than either record's spread (a gain inside
    the round-to-round spread is noise). A tie keeps ``best``."""
    if cand.get("ms") is None or cand.get("retraces") != 0:
        return False
    if best.get("ms") is None:
        return False
    margin = max(MIN_GAIN, cand.get("spread") or 0.0,
                 best.get("spread") or 0.0)
    return cand["ms"] < best["ms"] * (1.0 - margin)


# ── the search loop ──────────────────────────────────────────────────


def search(seq_lens: tuple, *, dtype: str = "bfloat16",
           blocks: tuple = DEFAULT_CANDIDATES, steps: int = 4,
           rounds: int = 3, seed: int = 0, state_path: "str | None" = None,
           budget_s_per_len: "float | None" = None, log=None,
           clock=time.perf_counter, device: DeviceLike = None) -> dict:
    """Sweep every candidate pair for every length on ``device`` (default:
    the card); returns ``{bucket_key: {"baseline", "best", "candidates",
    ...}}``.

    ``state_path`` makes the sweep resumable: finished points are read
    back instead of measured again (same seed, same identity) and each new
    point is persisted as it lands; error records are measured again.
    ``budget_s_per_len`` bounds one length's loop: on expiry the remaining
    candidates are counted as skipped and the next length still runs.
    A candidate must clear :func:`clears_gate` against the incumbent; the
    fastest that does wins the bucket."""
    dev = resolve_device(device)
    family = backend_family(dev)
    state = SweepState(state_path, done_field="ms")
    results: dict = {}
    for L in seq_lens:
        key = bucket_key(L, dtype, family)
        pairs = candidate_pairs(L, blocks, dtype, family)
        t_len = clock()
        cands, skipped = [], 0
        for i, (bq, bk) in enumerate(pairs):
            pkey = config_key(f"{key}:{bq}x{bk}", ("s", steps),
                              ("r", rounds), ("seed", seed))
            prior = state.finished(pkey)
            if prior is not None:
                rec = prior
            elif budget_s_per_len and i > 0 \
                    and clock() - t_len > budget_s_per_len:
                skipped += 1
                continue
            else:
                rec = measure_point(L, bq, bk, dtype=dtype, steps=steps,
                                    rounds=rounds, seed=seed, clock=clock,
                                    device=dev)
                state.record(pkey, rec)
            cands.append(rec)
            if log is not None:
                log(f"kernel_search {key} {bq}x{bk}: "
                    f"{rec.get('ms', rec.get('error'))}")
        baseline = cands[0] if cands else None
        best = baseline
        if baseline is not None:
            for c in cands[1:]:
                if clears_gate(c, baseline) \
                        and c["ms"] < best["ms"]:
                    best = c
        results[key] = {
            "seq_len": L, "dtype": dtype, "family": family,
            "baseline": baseline, "best": best, "candidates": cands,
            "improved": bool(best is not baseline),
            "skipped_candidates": skipped,
            "partial": bool(skipped),
        }
    return results


# ── table emission and the gate ──────────────────────────────────────


def to_table(results: dict, base_table: "dict | None" = None,
             provenance: "dict | None" = None) -> dict:
    """Merge search winners into a block-table dict (schema v1). Only
    buckets whose winner has a measurement land; rows of other buckets and
    families survive. ``provenance`` (the card, its power limit, the run)
    is merged into the table's."""
    table = {"schema": "flash-block-table-v1",
             "provenance": dict((base_table or {}).get("provenance") or {}),
             "entries": dict((base_table or {}).get("entries") or {})}
    table["provenance"].update(provenance or {})
    table["provenance"]["generator"] = \
        "python3 chip_smoke.py (phase kernel_search: kernel_search.search)"
    table["provenance"]["gate"] = (
        "faster than incumbent default by more than the margin and each "
        "record's spread AND zero builds in the timed phase")
    for key, res in results.items():
        best = res.get("best")
        if not best or best.get("ms") is None:
            continue
        table["entries"][key] = {
            "block_q": int(best["block_q"]), "block_k": int(best["block_k"]),
            "ms": best["ms"],
            "source": "kernel_search seed=%s steps=%s rounds=%s" % (
                best.get("seed"), best.get("steps"), best.get("rounds")),
        }
    return table


def write_table(table: dict, path: str) -> str:
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(table, f, indent=1)
        f.write("\n")
    os.replace(tmp, path)
    return path


def validate_table(table: dict) -> list:
    """Findings for a block table (empty: clean), as JAX's gate gives
    them. Run on the committed file and on every searched table before it
    may be written."""
    findings = []
    if table.get("schema") != "flash-block-table-v1":
        findings.append(f"unknown schema {table.get('schema')!r}")
    entries = table.get("entries")
    if not isinstance(entries, dict) or not entries:
        findings.append("no entries")
        return findings
    for key, ent in entries.items():
        parts = key.split(":")
        if len(parts) != 3:
            findings.append(f"{key}: key is not family:dtype:bucket")
            continue
        try:
            bucket = int(parts[2])
        except ValueError:
            findings.append(f"{key}: bucket is not an int")
            continue
        if bucket < 8 or bucket != pow2_bucket(bucket):
            findings.append(f"{key}: bucket {bucket} is not a pow2 ≥ 8")
        for side in ("block_q", "block_k"):
            b = ent.get(side) if isinstance(ent, dict) else None
            if not isinstance(b, int) or b < 8 or b % 8:
                findings.append(f"{key}: {side}={b!r} not an aligned block")
            elif b > bucket and b != _ceil8(bucket):
                findings.append(f"{key}: {side}={b} exceeds its padded bucket")
        ms = ent.get("ms") if isinstance(ent, dict) else None
        if ms is not None and not (isinstance(ms, (int, float)) and ms > 0):
            findings.append(f"{key}: ms={ms!r} not a positive number")
    return findings
