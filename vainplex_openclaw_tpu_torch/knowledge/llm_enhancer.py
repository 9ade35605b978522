"""Batched LLM fact extraction (reference: knowledge-engine/src/
llm-enhancer.ts — batched messages → SPO facts tagged ``extracted-llm``).

A copy of ``vainplex_openclaw_tpu/knowledge/llm_enhancer.py`` on the port's
``utils.llm_json``, with one deviation: a failed ``call_llm`` falls back
silently to regex-only extraction, as in the JAX package, unless the error
comes from the device (``device.is_device_error``, e.g. the port's local
``call_llm`` on a card that failed), which propagates.
"""

from __future__ import annotations

from typing import Callable, Optional

from ..device import is_device_error
from ..utils.llm_json import parse_llm_json

PROMPT = (
    "Extract factual subject-predicate-object triples from these messages. "
    "Only durable facts (preferences, relationships, attributes), no "
    "small talk. Respond ONLY JSON: "
    '{"facts": [{"subject": str, "predicate": str, "object": str}]}'
)


class KnowledgeLlmEnhancer:
    def __init__(self, call_llm: Callable[[str], str], logger, batch_size: int = 3):
        self.call_llm = call_llm
        self.logger = logger
        self.batch_size = batch_size
        self._batch: list[str] = []

    def add_to_batch(self, content: str) -> Optional[list[dict]]:
        self._batch.append(content[:2000])
        if len(self._batch) < self.batch_size:
            return None
        return self.send_batch()

    def send_batch(self) -> Optional[list[dict]]:
        if not self._batch:
            return None
        batch, self._batch = self._batch, []
        prompt = PROMPT + "\n\nMESSAGES:\n" + "\n".join(f"- {m}" for m in batch)
        try:
            raw = self.call_llm(prompt)
        except Exception as exc:  # noqa: BLE001 — silent fallback to regex-only
            if is_device_error(exc):
                raise
            self.logger.debug(f"knowledge LLM batch failed: {exc}")
            return None
        parsed = parse_llm_json(raw)
        if parsed is None:
            return None
        facts = []
        for f in parsed.get("facts", []):
            if isinstance(f, dict) and all(isinstance(f.get(k), str) and f.get(k)
                                           for k in ("subject", "predicate", "object")):
                facts.append({"subject": f["subject"], "predicate": f["predicate"],
                              "object": f["object"]})
        return facts or None
