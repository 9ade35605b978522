"""Stage-2 fact registry + checker
(reference: governance/src/fact-checker.ts:21-100, trace-to-facts-bridge.ts).

Facts are subject|predicate → value triples, inline or loaded from JSON
files. The trace-to-facts bridge extracts ``factCorrection`` entries from
Cortex trace-analysis reports — the suite's one (file-mediated) cross-plugin
data flow.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

from ...storage.atomic import read_json
from .claims import Claim


@dataclass
class Fact:
    subject: str
    predicate: str
    value: str
    source: str = "inline"
    confidence: float = 1.0


@dataclass
class FactCheckResult:
    claim: Claim
    status: str  # verified | contradicted | unverified
    fact: Optional[Fact] = None


def _key(subject: str, predicate: str) -> str:
    return f"{subject.lower()}|{predicate.lower()}"


class FactRegistry:
    def __init__(self, inline_facts: Optional[list[dict]] = None, logger=None):
        self.logger = logger
        self._facts: dict[str, Fact] = {}
        for f in inline_facts or []:
            self.add_fact(Fact(f["subject"], f["predicate"], str(f["value"]),
                               f.get("source", "inline"), f.get("confidence", 1.0)))

    def add_fact(self, fact: Fact) -> None:
        self._facts[_key(fact.subject, fact.predicate)] = fact

    def lookup(self, subject: str, predicate: str) -> Optional[Fact]:
        return self._facts.get(_key(subject, predicate))

    def all_facts(self) -> list[Fact]:
        return list(self._facts.values())

    def load_facts_from_file(self, path: str | Path) -> int:
        """Fact file format: {"facts": [{subject, predicate, value}...]} or a
        bare list."""
        data = read_json(path)
        if data is None:
            if self.logger is not None:
                self.logger.warn(f"fact file unreadable: {path}")
            return 0
        entries = data.get("facts", []) if isinstance(data, dict) else data
        n = 0
        for f in entries:
            try:
                self.add_fact(Fact(f["subject"], f["predicate"], str(f["value"]),
                                   f.get("source", str(path)), f.get("confidence", 1.0)))
                n += 1
            except (KeyError, TypeError):
                continue
        return n


def check_claims(claims: list[Claim], registry: FactRegistry) -> list[FactCheckResult]:
    out = []
    for claim in claims:
        fact = registry.lookup(claim.subject, claim.predicate)
        if fact is None:
            out.append(FactCheckResult(claim, "unverified"))
        elif fact.value.lower() == claim.value.lower():
            out.append(FactCheckResult(claim, "verified", fact))
        else:
            out.append(FactCheckResult(claim, "contradicted", fact))
    return out


def extract_facts_from_trace_report(path: str | Path) -> list[dict]:
    """TraceToFactsBridge (reference: trace-to-facts-bridge.ts:35-80): read a
    trace-analysis report and pull ``factCorrection`` entries from findings
    into fact dicts consumable by FactRegistry.load_facts_from_file."""
    report = read_json(path)
    if not isinstance(report, dict):
        return []
    facts = []
    for finding in report.get("findings", []):
        corr = finding.get("factCorrection") or finding.get("fact_correction")
        if not isinstance(corr, dict):
            continue
        if all(k in corr for k in ("subject", "predicate", "value")):
            facts.append({
                "subject": corr["subject"],
                "predicate": corr["predicate"],
                "value": str(corr["value"]),
                "source": f"trace-analyzer:{finding.get('signal', finding.get('id', '?'))}",
                "confidence": float(finding.get("confidence", 0.8)),
            })
    return facts
