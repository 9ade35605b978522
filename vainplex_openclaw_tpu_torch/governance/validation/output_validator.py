"""Output validator: staged verdicts with trust-proportional severity
(reference: governance/src/output-validator.ts:36-275).

- contradictions: block < blockBelow trust, pass ≥ flagAbove, flag between
- unverified claims per policy (ignore|flag|block), self-referential claims
  get their own policy
- Stage 3 (LLM) only for external comms; most-restrictive verdict wins;
  stage-3 errors fail open to the stage-1/2 result

A copy of ``vainplex_openclaw_tpu/governance/validation/output_validator.py``
with one deviation: an error of the device (``device.is_device_error``) in
stage 3 propagates instead of falling back to the stage-1/2 result.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

from ...device import is_device_error
from .claims import detect_claims
from .facts import FactRegistry, check_claims

VERDICT_SEVERITY = {"pass": 0, "flag": 1, "block": 2}

DEFAULT_VALIDATION_CONFIG = {
    "enabled": True,
    "enabledDetectors": ["system_state", "entity_name", "existence",
                         "operational_status", "self_referential"],
    "contradictionThresholds": {"blockBelow": 40, "flagAbove": 60},
    "unverifiedClaimPolicy": "ignore",   # ignore | flag | block
    "selfReferentialPolicy": "ignore",   # ignore | flag | block
    "llmValidator": {"enabled": False},
}


def more_restrictive(a: str, b: str) -> str:
    return a if VERDICT_SEVERITY.get(a, 0) >= VERDICT_SEVERITY.get(b, 0) else b


@dataclass
class OutputValidationResult:
    verdict: str
    reason: str
    claims: list = field(default_factory=list)
    fact_check_results: list = field(default_factory=list)
    contradictions: list = field(default_factory=list)
    evaluation_us: int = 0
    llm_result: Optional[object] = None


class OutputValidator:
    def __init__(self, config: dict, fact_registry: FactRegistry, logger,
                 llm_validator=None):
        from ...config.loader import deep_merge

        self.config = deep_merge(DEFAULT_VALIDATION_CONFIG, config or {})
        self.facts = fact_registry
        self.logger = logger
        self.llm_validator = llm_validator

    def validate(self, text: str, trust_score: float,
                 is_external: bool = False) -> OutputValidationResult:
        start = time.perf_counter()

        def done(verdict, reason, claims=(), results=(), contradictions=(), llm=None):
            return OutputValidationResult(
                verdict, reason, list(claims), list(results), list(contradictions),
                round((time.perf_counter() - start) * 1e6), llm)

        if not self.config["enabled"] or not text:
            return done("pass", "Validation disabled or empty text")

        claims = detect_claims(text, self.config["enabledDetectors"])
        if not claims and not is_external:
            return done("pass", "No claims detected")

        results = check_claims(claims, self.facts) if claims else []
        contradictions = [r for r in results if r.status == "contradicted"]
        unverified = [r for r in results if r.status == "unverified"]
        stage12 = self._determine_verdict(contradictions, unverified, trust_score)

        if is_external and self.llm_validator is not None \
                and self.config.get("llmValidator", {}).get("enabled"):
            try:
                llm = self.llm_validator.validate(text, self.facts.all_facts(), True)
                final = more_restrictive(stage12[0], llm.verdict)
                reasons = [r for v, r in (stage12, (llm.verdict, llm.reason)) if v != "pass"]
                reason = " | ".join(reasons) or stage12[1]
                return done(final, reason, claims, results, contradictions, llm)
            except Exception as exc:  # noqa: BLE001 — stage 3 fails open to stage 1+2
                if is_device_error(exc):
                    raise
                self.logger.error(f"LLM validation stage error: {exc}")

        return done(stage12[0], stage12[1], claims, results, contradictions)

    def _determine_verdict(self, contradictions, unverified, trust_score) -> tuple[str, str]:
        if contradictions:
            return self._contradiction_verdict(contradictions, trust_score)
        if unverified and self.config["unverifiedClaimPolicy"] != "ignore":
            self_ref = [r for r in unverified if r.claim.type == "self_referential"]
            other = [r for r in unverified if r.claim.type != "self_referential"]
            if self_ref and self.config["selfReferentialPolicy"] != "ignore":
                action = "block" if self.config["selfReferentialPolicy"] == "block" else "flag"
                quoted = ", ".join(f'"{r.claim.source}"' for r in self_ref)
                plural = "s" if len(self_ref) > 1 else ""
                return action, f"Self-referential claim{plural} detected: {quoted}"
            if other:
                action = "block" if self.config["unverifiedClaimPolicy"] == "block" else "flag"
                quoted = ", ".join(f'"{r.claim.source}"' for r in other)
                plural = "s" if len(other) > 1 else ""
                return action, f"Unverified claim{plural}: {quoted}"
        return "pass", "All claims verified or no contradictions found"

    def _contradiction_verdict(self, contradictions, trust_score) -> tuple[str, str]:
        thresholds = self.config["contradictionThresholds"]
        block_below, flag_above = thresholds["blockBelow"], thresholds["flagAbove"]
        detail = "; ".join(
            f'{c.claim.subject}: claimed "{c.claim.value}", actual '
            f'"{c.fact.value if c.fact else "unknown"}"'
            for c in contradictions)
        if trust_score < block_below:
            return "block", f"Contradiction detected (trust {trust_score} < {block_below}): {detail}"
        if trust_score >= flag_above:
            return "pass", f"Contradiction detected but trusted (trust {trust_score} >= {flag_above}): {detail}"
        return "flag", f"Contradiction detected (trust {trust_score}): {detail}"
