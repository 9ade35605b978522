"""Redaction engine: deep recursive scan with circular-ref protection and
JSON-within-string reparse (reference: governance/src/redaction/engine.ts:37-195).

A copy of ``vainplex_openclaw_tpu/governance/redaction/engine.py``."""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field

from .registry import PatternMatch, PatternRegistry
from .vault import RedactionVault

MAX_DEPTH = 20
MAX_JSON_PARSE_LENGTH = 1_000_000  # 1 MB


def _looks_like_json(s: str) -> bool:
    t = s.lstrip()
    return t.startswith("{") or t.startswith("[")


@dataclass
class ScanResult:
    output: object
    redaction_count: int
    categories: set = field(default_factory=set)
    elapsed_ms: float = 0.0


class RedactionEngine:
    def __init__(self, registry: PatternRegistry, vault: RedactionVault):
        self.registry = registry
        self.vault = vault

    def scan(self, value) -> ScanResult:
        start = time.perf_counter()
        state = {"count": 0, "categories": set()}
        output = self._scan_value(value, set(), 0, state)
        return ScanResult(output, state["count"], state["categories"],
                          (time.perf_counter() - start) * 1000)

    def scan_string(self, text: str) -> ScanResult:
        """Flat string scan for Layer-2 outbound messages (no deep traversal)."""
        state = {"count": 0, "categories": set()}
        return ScanResult(self._redact_string(text, state), state["count"], state["categories"])

    def _scan_value(self, value, seen: set, depth: int, state: dict):
        if depth > MAX_DEPTH or value is None:
            return value
        if isinstance(value, str):
            return self._scan_string_value(value, seen, depth, state)
        if isinstance(value, dict):
            if id(value) in seen:
                return "[Circular]"
            seen.add(id(value))
            return {k: self._scan_value(v, seen, depth + 1, state) for k, v in value.items()}
        if isinstance(value, (list, tuple)):
            if id(value) in seen:
                return "[Circular]"
            seen.add(id(value))
            return [self._scan_value(v, seen, depth + 1, state) for v in value]
        return value

    def _scan_string_value(self, value: str, seen: set, depth: int, state: dict):
        if len(value) <= MAX_JSON_PARSE_LENGTH and _looks_like_json(value):
            try:
                parsed = json.loads(value)
            except json.JSONDecodeError:
                parsed = None
            if isinstance(parsed, (dict, list)):
                scanned = self._scan_value(parsed, seen, depth + 1, state)
                return json.dumps(scanned)
        return self._redact_string(value, state)

    def _redact_string(self, text: str, state: dict) -> str:
        matches = self.registry.find_matches(text)
        if not matches:
            return text
        return self._apply(text, matches, state)

    def _apply(self, text: str, matches: list[PatternMatch], state: dict) -> str:
        # end-to-start so positions stay valid
        for m in sorted(matches, key=lambda x: -x.start):
            placeholder = self.vault.store(m.match, m.pattern.category)
            text = text[:m.start] + placeholder + text[m.end:]
            state["count"] += 1
            state["categories"].add(m.pattern.category)
        return text
