"""Report assembly + incremental processing state: a copy of
``vainplex_openclaw_tpu/cortex/trace_analyzer/report.py``.

State is persisted to trace-analyzer-state.json, the report to
trace-analysis-report.json, through the port's copy of the atomic writer,
so both files are the bytes the JAX package writes; the rule-effectiveness
feedback loop compares before/after failure counts per signal.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Optional

from ...storage.atomic import read_json, write_json_atomic

STATE_FILE = "trace-analyzer-state.json"
REPORT_FILE = "trace-analysis-report.json"


@dataclass
class ProcessingState:
    last_processed_ts: float = 0.0
    last_processed_seq: int = 0
    total_events_processed: int = 0
    total_runs: int = 0
    rule_signal_counts: dict = field(default_factory=dict)  # ruleKey → [runIdx, count]

    @classmethod
    def load(cls, directory: str | Path) -> "ProcessingState":
        data = read_json(Path(directory) / STATE_FILE)
        if not isinstance(data, dict):
            return cls()
        return cls(
            last_processed_ts=float(data.get("lastProcessedTs") or 0),
            last_processed_seq=int(data.get("lastProcessedSeq") or 0),
            total_events_processed=int(data.get("totalEventsProcessed") or 0),
            total_runs=int(data.get("totalRuns") or 0),
            rule_signal_counts=data.get("ruleSignalCounts") or {},
        )

    def save(self, directory: str | Path) -> None:
        write_json_atomic(Path(directory) / STATE_FILE, {
            "lastProcessedTs": self.last_processed_ts,
            "lastProcessedSeq": self.last_processed_seq,
            "totalEventsProcessed": self.total_events_processed,
            "totalRuns": self.total_runs,
            "ruleSignalCounts": self.rule_signal_counts,
        })


def rule_effectiveness(state: ProcessingState, signal_counts: dict) -> list[dict]:
    """Before/after failure counts per signal across runs — did generated
    rules actually reduce recurrence?"""
    out = []
    for signal, count in signal_counts.items():
        prev = state.rule_signal_counts.get(signal)
        if prev is not None:
            out.append({"signal": signal, "before": prev, "after": count,
                        "improved": count < prev})
        state.rule_signal_counts[signal] = count
    return out


def assemble_report(run_stats: dict, signals: list, classified: list,
                    outputs: list, effectiveness: list,
                    clock: Callable[[], float] = time.time,
                    clusters: Optional[list] = None,
                    clusters_truncated: int = 0) -> dict:
    by_signal: dict = {}
    for s in signals:
        entry = by_signal.setdefault(s.signal, {"count": 0, "severities": {}})
        entry["count"] += 1
        entry["severities"][s.severity] = entry["severities"].get(s.severity, 0) + 1
    return {
        "generatedAt": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(clock())),
        "runStats": run_stats,
        "signalStats": by_signal,
        "failureClusters": clusters or [],
        "failureClustersTruncated": clusters_truncated,
        "ruleEffectiveness": effectiveness,
        "findings": [c.to_dict() for c in classified],
        "outputs": [o.to_dict() for o in outputs],
    }


def save_report(report: dict, directory: str | Path) -> Path:
    # Reports can run to megabytes (thousands of findings); compact JSON is
    # ~3x faster to serialize and the file is machine-consumed (bridge, CI).
    path = Path(directory) / REPORT_FILE
    write_json_atomic(path, report, indent=None)
    return path
