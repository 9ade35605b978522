"""Stage-3 output generation: a copy of
``vainplex_openclaw_tpu/cortex/trace_analyzer/outputs.py`` over the port's
``ClassifiedFinding``.

Classified findings group by normalized action text → deduped
``GeneratedOutput`` soul rules / governance policies / cortex patterns with
observation counts and mean confidence.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

from .classifier import ClassifiedFinding


@dataclass
class GeneratedOutput:
    action_type: str
    action_text: str
    observations: int
    mean_confidence: float
    signals: list = field(default_factory=list)
    severities: list = field(default_factory=list)

    def to_dict(self) -> dict:
        return {"actionType": self.action_type, "actionText": self.action_text,
                "observations": self.observations,
                "meanConfidence": round(self.mean_confidence, 3),
                "signals": self.signals, "severities": self.severities}


def normalize_action_text(text: str) -> str:
    return re.sub(r"\s+", " ", (text or "").strip().lower()).rstrip(".")


def generate_outputs(classified: list[ClassifiedFinding]) -> list[GeneratedOutput]:
    groups: dict[tuple[str, str], list[ClassifiedFinding]] = {}
    for cf in classified:
        if not cf.kept or not cf.action_text or cf.action_type == "manual_review":
            continue
        key = (cf.action_type, normalize_action_text(cf.action_text))
        groups.setdefault(key, []).append(cf)

    outputs = []
    for (action_type, _), members in groups.items():
        outputs.append(GeneratedOutput(
            action_type=action_type,
            action_text=members[0].action_text,
            observations=len(members),
            mean_confidence=sum(m.confidence for m in members) / len(members),
            signals=sorted({m.signal.signal for m in members}),
            severities=sorted({m.severity for m in members}),
        ))
    outputs.sort(key=lambda o: (-o.observations, -o.mean_confidence))
    return outputs
