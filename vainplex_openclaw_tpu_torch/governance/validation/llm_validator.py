"""Stage-3 LLM validation behind a DI'd ``call_llm``
(reference: governance/src/llm-validator.ts:25-281).

The reference posts to an Ollama/OpenAI-compatible endpoint; here the
callable seam is identical — production installs can point it at the local
encoder classifier (models/serve.py) instead of an HTTP LLM.

Semantics preserved: "Corporate Communications Fact-Checker" prompt with a
known-facts section, 5 issue categories, JSON parsing tolerant of markdown
fences, djb2-keyed response cache with 5-minute TTL, one retry, fail-open or
fail-closed per config.

A copy of ``vainplex_openclaw_tpu/governance/validation/llm_validator.py``
with one deviation: an error of the device (``device.is_device_error``)
from ``call_llm`` propagates at once, with no retry and no failMode
verdict. Every other error is retried and then failed open or closed as in
the JAX package.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from ...device import is_device_error

ISSUE_CATEGORIES = ("factual_error", "unverifiable_claim", "contradiction",
                    "exaggeration", "sensitive_info")
CACHE_TTL_S = 300.0


def djb2(text: str) -> int:
    h = 5381
    for ch in text.encode("utf-8"):
        h = ((h * 33) + ch) & 0xFFFFFFFF
    return h


@dataclass
class LlmValidationResult:
    verdict: str  # pass | flag | block
    reason: str
    issues: list = field(default_factory=list)
    from_cache: bool = False


def build_prompt(text: str, facts: list) -> str:
    fact_lines = "\n".join(f"- {f.subject} {f.predicate}: {f.value}" for f in facts) or "- (none)"
    return (
        "You are a Corporate Communications Fact-Checker reviewing an AI "
        "agent's outbound message before it is sent externally.\n\n"
        f"KNOWN FACTS:\n{fact_lines}\n\n"
        f"MESSAGE:\n{text}\n\n"
        "Identify issues in these categories: factual_error, "
        "unverifiable_claim, contradiction, exaggeration, sensitive_info.\n"
        'Respond with ONLY JSON: {"verdict": "pass"|"flag"|"block", '
        '"reason": "...", "issues": [{"category": "...", "detail": "..."}]}'
    )


def parse_response(raw: str) -> Optional[dict]:
    """JSON parse tolerant of ```json fences and surrounding prose."""
    from ...utils.llm_json import parse_llm_json

    parsed = parse_llm_json(raw)
    if parsed is None or parsed.get("verdict") not in ("pass", "flag", "block"):
        return None
    issues = parsed.get("issues") or []
    parsed["issues"] = [i for i in issues if isinstance(i, dict)
                        and i.get("category") in ISSUE_CATEGORIES]
    return parsed


class LlmValidator:
    def __init__(self, call_llm: Callable[[str], str], logger,
                 fail_mode: str = "open", clock: Callable[[], float] = time.time):
        self.call_llm = call_llm
        self.logger = logger
        self.fail_mode = fail_mode
        self.clock = clock
        self._cache: dict[int, tuple[float, LlmValidationResult]] = {}

    def validate(self, text: str, facts: list, is_external: bool = True) -> LlmValidationResult:
        key = djb2(text)
        cached = self._cache.get(key)
        if cached is not None and self.clock() - cached[0] < CACHE_TTL_S:
            result = cached[1]
            return LlmValidationResult(result.verdict, result.reason, result.issues, True)

        prompt = build_prompt(text, facts)
        parsed = None
        for attempt in (1, 2):  # one retry
            try:
                raw = self.call_llm(prompt)
            except Exception as exc:  # noqa: BLE001
                if is_device_error(exc):
                    raise
                self.logger.warn(f"LLM validation call failed (attempt {attempt}): {exc}")
                continue
            parsed = parse_response(raw)
            if parsed is not None:
                break
            self.logger.warn(f"LLM validation unparseable response (attempt {attempt})")

        if parsed is None:
            if self.fail_mode == "closed":
                result = LlmValidationResult("block", "LLM validation unavailable (closed-fail)")
            else:
                result = LlmValidationResult("pass", "LLM validation unavailable (open-fail)")
        else:
            result = LlmValidationResult(parsed["verdict"], parsed.get("reason", ""),
                                         parsed["issues"])
        self._cache[key] = (self.clock(), result)
        return result
