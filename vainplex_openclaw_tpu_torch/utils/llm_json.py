"""Strict-JSON parsing of LLM output, tolerant of the two failure shapes
every LLM JSON contract hits: markdown code fences (with or without a
language tag) and surrounding prose.

A copy of ``vainplex_openclaw_tpu/utils/llm_json.py`` (stdlib only), kept
here so the port imports nothing of the JAX package.
"""

from __future__ import annotations

import json
from typing import Optional


def parse_llm_json(raw: str) -> Optional[dict]:
    """Return the first JSON object in ``raw`` or None."""
    if not isinstance(raw, str):
        return None
    text = raw.strip()
    if text.startswith("```"):
        text = "\n".join(line for line in text.splitlines()
                         if not line.strip().startswith("```")).strip()
    try:
        parsed = json.loads(text)
    except json.JSONDecodeError:
        start, end = text.find("{"), text.rfind("}")
        if start == -1 or end <= start:
            return None
        try:
            parsed = json.loads(text[start:end + 1])
        except json.JSONDecodeError:
            return None
    return parsed if isinstance(parsed, dict) else None
