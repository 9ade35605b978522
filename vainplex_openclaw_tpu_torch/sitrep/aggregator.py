"""Sitrep aggregation + health rollup (reference:
openclaw-sitrep/src/aggregator.ts:19-44 + service.ts).

A copy of ``vainplex_openclaw_tpu/sitrep/aggregator.py``, kept here so the
port imports nothing of the JAX package."""

from __future__ import annotations

import os
import time
from pathlib import Path
from typing import Callable

from ..storage.atomic import write_json_atomic
from .collectors import BUILTIN_COLLECTORS, run_custom_collector, safe_collect

HEALTH_ORDER = {"ok": 0, "skipped": 0, "warn": 1, "error": 2}


def rollup_health(results: dict) -> str:
    worst = 0
    for result in results.values():
        worst = max(worst, HEALTH_ORDER.get(result.get("status"), 1))
    return ("healthy", "degraded", "unhealthy")[worst]


def generate_sitrep(config: dict, ctx: dict, logger,
                    clock: Callable[[], float] = time.time) -> dict:
    results: dict = {}
    collectors_cfg = config.get("collectors", {})
    for name, fn in BUILTIN_COLLECTORS.items():
        results[name] = safe_collect(name, fn, collectors_cfg.get(name, {"enabled": False}),
                                     ctx, logger)
    for definition in config.get("customCollectors", []):
        start = time.perf_counter()
        try:
            result = run_custom_collector(definition)
        except Exception as exc:  # noqa: BLE001
            result = {"status": "error", "items": [], "summary": f"error: {exc}",
                      "error": str(exc)}
        result["duration_ms"] = round((time.perf_counter() - start) * 1000, 2)
        results[f"custom:{definition.get('id', '?')}"] = result

    t = time.gmtime(clock())
    return {
        "generatedAt": (f"{t.tm_year:04d}-{t.tm_mon:02d}-{t.tm_mday:02d}T"
                        f"{t.tm_hour:02d}:{t.tm_min:02d}:{t.tm_sec:02d}Z"),
        "health": rollup_health(results),
        "collectors": results,
    }


def write_sitrep(report: dict, workspace: str | Path) -> Path:
    """Write sitrep.json, rotating the previous one to sitrep.previous.json.

    Rotation renames instead of read_json + re-encoding the whole previous
    report — the old path paid a full parse/serialize of a report that was
    already valid JSON on disk. Ordering keeps
    sitrep.json present at every instant: the new report is staged first
    (all write failures land before anything is touched), the current
    report becomes sitrep.previous.json via a hardlink (the original name
    stays in place), and one final ``os.replace`` swaps the new report in
    atomically. On a hardlink-capable filesystem a crash anywhere leaves
    sitrep.json valid — worst case a stale staging file lingers and is
    cleaned next rotation; the no-hardlink fallback keeps the no-re-encode
    win but reopens a brief rename window where sitrep.json is absent."""
    path = Path(workspace) / "sitrep.json"
    staged = path.with_name(".sitrep.json.new")
    write_json_atomic(staged, report)  # all failure modes land here
    previous = path.with_name("sitrep.previous.json")
    prev_tmp = path.with_name(".sitrep.previous.tmp")
    try:
        prev_tmp.unlink(missing_ok=True)  # stale tmp from a crashed rotation
        os.link(path, prev_tmp)
        os.replace(prev_tmp, previous)
    except FileNotFoundError:
        pass  # first sitrep: nothing to rotate
    except OSError:
        # Filesystem without hardlinks: fall back to rename rotation (a
        # brief sitrep.json-absent window, still no re-encode).
        try:
            os.replace(path, previous)
        except FileNotFoundError:
            pass
    os.replace(staged, path)
    return path
