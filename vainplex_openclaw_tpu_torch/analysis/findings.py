"""Finding model + suppression baseline for the port's gates.

A copy of ``vainplex_openclaw_tpu/analysis/findings.py`` under the same
names; the keys name paths under ``vainplex_openclaw_tpu_torch/``.

Every pass reports :class:`Finding`s carrying a rule id, a repo-relative
path, a line, and a STABLE key. Keys deliberately exclude line numbers —
``rule::path::detail`` where ``detail`` names the symbol (``Journal.stats:
_marks``, a lock-cycle signature, a pattern hash) — so a baseline entry
survives unrelated edits to the file instead of rotting every PR.

Suppressions live in ONE checked-in file (``analysis/baseline.json``): a
list of ``{"key": ..., "rationale": ...}`` objects. A finding whose key is
baselined is reported as suppressed, not active; an entry with an empty
rationale is itself a finding (the baseline must explain every exception,
or it degenerates into a mute button); an entry matching nothing is stale
and reported as a warning so the baseline shrinks as code is fixed.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

BASELINE_NAME = "baseline.json"

# The three gates one runner hosts: rule-id prefix →
# which summary line a finding lands on. One shared baseline, one exit
# code; per-gate greppable lines so CI and humans see which discipline
# regressed. GL-BASELINE (a suppression without rationale) counts against
# the gate that owns the suppressed rule.
GATES: tuple = (
    ("graftlint", ("GL-LOCK", "GL-REDOS", "GL-DRIFT")),
    ("tracelint", ("GL-TRACE", "GL-RETRACE", "GL-SHARD")),
    ("protolint", ("GL-PROTO",)),
)


def gate_of(rule: str) -> str:
    for gate, prefixes in GATES:
        if any(rule.startswith(p) for p in prefixes):
            return gate
    return "graftlint"  # GL-BASELINE with no parsable owner, unknown rules


def gate_of_finding(finding) -> str:
    """Like :func:`gate_of`, but a GL-BASELINE finding (a suppression
    without rationale) is attributed to the gate that owns the SUPPRESSED
    rule, which rides in its ``no-rationale:<original key>`` detail."""
    if finding.rule.startswith("GL-BASELINE") \
            and finding.detail.startswith("no-rationale:"):
        return gate_of(finding.detail[len("no-rationale:"):])
    return gate_of(finding.rule)


@dataclass(frozen=True)
class Finding:
    rule: str          # e.g. "GL-LOCK-GUARD"
    path: str          # repo-relative, forward slashes
    line: int
    message: str
    detail: str = ""   # stable symbol-ish discriminator for the key

    @property
    def key(self) -> str:
        return f"{self.rule}::{self.path}::{self.detail or self.message}"

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


@dataclass
class LintReport:
    """The outcome of one analysis run (all three gates, or the subset a
    ``--only`` filter selected — ``gates_run`` names them)."""

    files_scanned: int = 0
    active: list = field(default_factory=list)       # findings not baselined
    suppressed: list = field(default_factory=list)   # (finding, rationale)
    stale_keys: list = field(default_factory=list)   # baseline entries unmatched
    # gate → files its passes parsed; gates absent fall back to
    # files_scanned (the canonical package traversal).
    gate_files: dict = field(default_factory=dict)
    schedules: int = 0   # explorer schedules executed (protolint line)
    gates_run: tuple = ("graftlint", "tracelint", "protolint")

    @property
    def ok(self) -> bool:
        return not self.active

    def _gate_counts(self, gate: str) -> tuple:
        a = sum(1 for f in self.active if gate_of_finding(f) == gate)
        s = sum(1 for f, _r in self.suppressed
                if gate_of_finding(f) == gate)
        t = sum(1 for k in self.stale_keys
                if gate_of(k.split("::", 1)[0]) == gate)
        return a, s, t

    def summary(self) -> str:
        # The CI parse smokes grep these exact shapes (one line per gate,
        # graftlint first): a crashing analyzer prints no summary lines
        # and exits 2 — it can never read as a passing gate.
        lines = []
        for gate, _prefixes in GATES:
            if gate not in self.gates_run:
                continue
            a, s, t = self._gate_counts(gate)
            files = self.gate_files.get(gate, self.files_scanned)
            extra = (f" schedules={self.schedules}"
                     if gate == "protolint" else "")
            lines.append(f"{gate}: files={files}{extra} "
                         f"active={a} suppressed={s} stale={t}")
        return "\n".join(lines)

    def to_dict(self) -> dict:
        gates = {}
        for gate, _prefixes in GATES:
            if gate not in self.gates_run:
                continue
            a, s, t = self._gate_counts(gate)
            gates[gate] = {
                "files": self.gate_files.get(gate, self.files_scanned),
                "active": a, "suppressed": s, "stale": t,
            }
            if gate == "protolint":
                gates[gate]["schedules"] = self.schedules
        return {
            "filesScanned": self.files_scanned,
            "gates": gates,
            "active": [vars(f) | {"key": f.key} for f in self.active],
            "suppressed": [vars(f) | {"key": f.key, "rationale": r}
                           for f, r in self.suppressed],
            "staleKeys": list(self.stale_keys),
            "ok": self.ok,
        }


def load_baseline(path: Optional[str | Path] = None) -> dict[str, str]:
    """{key: rationale} from the checked-in baseline file. A malformed
    baseline raises — a lint gate whose suppression file silently reads as
    empty would fail the build on every baselined finding (loud, but
    misleading); one that silently reads as 'everything suppressed' would
    pass violations. Neither is acceptable."""
    if path is None:
        path = Path(__file__).parent / BASELINE_NAME
    path = Path(path)
    if not path.exists():
        return {}
    entries = json.loads(path.read_text(encoding="utf-8"))
    if not isinstance(entries, list):
        raise ValueError(f"baseline {path} must be a JSON list")
    out: dict[str, str] = {}
    for e in entries:
        if not isinstance(e, dict) or "key" not in e:
            raise ValueError(f"baseline entry must carry a key: {e!r}")
        out[str(e["key"])] = str(e.get("rationale", ""))
    return out


def apply_baseline(findings: list, baseline: dict[str, str],
                   report: LintReport) -> None:
    """Split findings into active/suppressed on ``report``; empty-rationale
    suppressions surface as GL-BASELINE findings; unmatched keys as stale."""
    seen: set[str] = set()
    for f in findings:
        rationale = baseline.get(f.key)
        if rationale is None:
            report.active.append(f)
            continue
        seen.add(f.key)
        if not rationale.strip():
            report.active.append(Finding(
                "GL-BASELINE", f.path, f.line,
                f"suppression for {f.key} has no rationale",
                detail=f"no-rationale:{f.key}"))
        report.suppressed.append((f, rationale))
    report.stale_keys.extend(k for k in baseline if k not in seen)
