"""Credential scrubbing before anything leaves for an LLM or disk.

A copy of ``vainplex_openclaw_tpu/cortex/trace_analyzer/redactor.py``
(stdlib only), kept here so the port imports nothing of the JAX package;
``tests/test_torch_classify_findings.py`` pins its output equal to the
original's. Rules: API keys, Bearer tokens, URL userinfo passwords,
env-var-style values, PEM blocks, GitHub tokens, JWTs. Patterns are
compiled fresh per call.
"""

from __future__ import annotations

import re

_RULES = (
    (r"sk-[a-zA-Z0-9_-]{20,}", "[REDACTED-KEY]"),
    (r"AKIA[0-9A-Z]{16}", "[REDACTED-KEY]"),
    (r"gh[ps]_[a-zA-Z0-9]{36}", "[REDACTED-TOKEN]"),
    (r"glpat-[a-zA-Z0-9_-]{20,}", "[REDACTED-TOKEN]"),
    (r"Bearer\s+[a-zA-Z0-9_./-]{16,}", "Bearer [REDACTED]"),
    (r"eyJ[a-zA-Z0-9_-]{10,}\.[a-zA-Z0-9_-]{10,}\.[a-zA-Z0-9_-]{5,}", "[REDACTED-JWT]"),
    (r"://([^:/@\s]+):([^@/\s]+)@", r"://\1:[REDACTED]@"),
    (r"(?i)((?:password|passwd|secret|token|api_key|apikey)\s*[=:]\s*)\S{6,}",
     r"\1[REDACTED]"),
    (r"-----BEGIN [A-Z ]*PRIVATE KEY-----[\s\S]*?-----END [A-Z ]*PRIVATE KEY-----",
     "[REDACTED-PEM]"),
)


def builtin_rules() -> list[tuple[re.Pattern, str]]:
    return [(re.compile(p), repl) for p, repl in _RULES]


def redact_text(text: str, rules=None) -> str:
    if not text:
        return text
    for rx, repl in (rules or builtin_rules()):
        text = rx.sub(repl, text)
    return text


def redact_chain(chain) -> dict:
    """Chain → redacted plain dict safe for LLM prompts / disk."""
    rules = builtin_rules()
    return {
        "id": chain.id,
        "agent": chain.agent,
        "session": chain.session,
        "events": [
            {"type": e.type, "ts": e.ts,
             "content": redact_text(str(e.payload.get("content") or ""), rules)[:500],
             "tool_name": e.payload.get("tool_name"),
             "tool_error": redact_text(str(e.payload.get("tool_error") or ""), rules)[:300]}
            for e in chain.events
        ],
    }
