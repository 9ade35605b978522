"""Optional LLM conversation-analysis enhancement
(reference: cortex/src/llm-enhance.ts:14-120).

Batches messages (default 3), sends one strict-JSON analysis prompt through
the DI'd ``call_llm`` seam (an HTTP LLM in the reference, or any callable an
operator injects, the port's local ``call_llm`` included), merges results
into the trackers, and falls back silently to regex-only on a failure.

The port's copy of ``vainplex_openclaw_tpu/cortex/llm_enhance.py``, with one
deviation: ``LlmEnhancer.flush`` re-raises an error of the device
(``device.is_device_error``: no card, a kernel that did not build or
launch) from ``call_llm``, where the JAX package logs it and falls back to
regex; every other error keeps that fallback.
"""

from __future__ import annotations

from typing import Callable, Optional

from ..device import is_device_error
from ..utils.llm_json import parse_llm_json

SYSTEM_PROMPT = (
    "You analyze agent-user conversations. Given the messages, respond with "
    "ONLY strict JSON: {\"threads\": [{\"title\": str, \"status\": "
    "\"open\"|\"closed\", \"summary\": str}], \"decisions\": [str], "
    "\"closures\": [str], \"mood\": \"frustrated\"|\"excited\"|\"tense\"|"
    "\"productive\"|\"exploratory\"|\"neutral\"}"
)


def parse_analysis(raw: str) -> Optional[dict]:
    parsed = parse_llm_json(raw)
    if parsed is None:
        return None
    return {
        "threads": [t for t in parsed.get("threads", []) if isinstance(t, dict) and t.get("title")],
        "decisions": [d for d in parsed.get("decisions", []) if isinstance(d, str)],
        "closures": [c for c in parsed.get("closures", []) if isinstance(c, str)],
        "mood": parsed.get("mood", "neutral"),
    }


class LlmEnhancer:
    def __init__(self, call_llm: Callable[[str], str], logger, batch_size: int = 3):
        self.call_llm = call_llm
        self.logger = logger
        self.batch_size = batch_size
        self._batch: list[dict] = []

    def add_message(self, content: str, sender: str) -> Optional[dict]:
        """Queue a message; returns an analysis dict when the batch fires."""
        self._batch.append({"sender": sender, "content": content[:2000]})
        if len(self._batch) < self.batch_size:
            return None
        return self.flush()

    def flush(self) -> Optional[dict]:
        if not self._batch:
            return None
        batch, self._batch = self._batch, []
        transcript = "\n".join(f"[{m['sender']}] {m['content']}" for m in batch)
        prompt = f"{SYSTEM_PROMPT}\n\nMESSAGES:\n{transcript}"
        try:
            raw = self.call_llm(prompt)
        except Exception as exc:  # noqa: BLE001 — silent regex-only fallback
            if is_device_error(exc):
                raise
            self.logger.debug(f"LLM enhance failed (regex-only fallback): {exc}")
            return None
        analysis = parse_analysis(raw)
        if analysis is None:
            self.logger.debug("LLM enhance returned unparseable output")
        return analysis
