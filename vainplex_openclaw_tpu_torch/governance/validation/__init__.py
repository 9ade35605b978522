"""Output validation (RFC-006; reference: governance/src/output-validator.ts,
claim-detector.ts, fact-checker.ts, llm-validator.ts, response-gate.ts).

Stage 1 regex claim detection → Stage 2 fact-registry check with
trust-proportional verdicts → Stage 3 LLM validation (external comms only),
most-restrictive-verdict-wins. Plus the synchronous Response Gate.
"""

from .claims import detect_claims
from .facts import FactRegistry, check_claims, extract_facts_from_trace_report
from .llm_validator import LlmValidator
from .output_validator import OutputValidator
from .response_gate import ResponseGate

__all__ = [
    "FactRegistry",
    "LlmValidator",
    "OutputValidator",
    "ResponseGate",
    "check_claims",
    "detect_claims",
    "extract_facts_from_trace_report",
]
