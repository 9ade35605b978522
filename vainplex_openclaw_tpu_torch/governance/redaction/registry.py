"""Pattern registry: 17 built-in secret/PII/financial patterns + custom
(reference: governance/src/redaction/registry.ts:17-220).

Category order credential → financial → pii → custom; overlapping matches
resolve to the longest match.

A copy of ``vainplex_openclaw_tpu/governance/redaction/registry.py``;
custom patterns are screened by the port's ``policy_loader.validate_regex``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional

CATEGORY_ORDER = ("credential", "financial", "pii", "custom")


@dataclass(frozen=True)
class RedactionPattern:
    id: str
    category: str
    regex: re.Pattern
    replacement_type: str
    builtin: bool = True
    # Literal substrings (lowercase), any of which must appear in the text
    # for the regex to be worth running — a C-speed prefilter that keeps the
    # 100 KB <5 ms scan budget (RFC-007). () = always run.
    anchors: tuple[str, ...] = ()
    # Case-insensitive patterns (lowercase literals) scan the already-lowered
    # text without re.IGNORECASE (~4x faster) when lowering preserved length;
    # otherwise this IGNORECASE-compiled fallback scans the original text
    # (non-ASCII lowering like 'İ' can change string length).
    regex_ci_fallback: Optional[re.Pattern] = None


def _p(id: str, category: str, pattern: str, replacement_type: str,
       flags: int = 0, anchors: tuple[str, ...] = (),
       lower_fast_path: bool = False) -> RedactionPattern:
    return RedactionPattern(
        id, category, re.compile(pattern, flags), replacement_type,
        anchors=anchors,
        regex_ci_fallback=re.compile(pattern, flags | re.IGNORECASE)
        if lower_fast_path else None)


BUILTIN_PATTERNS: tuple[RedactionPattern, ...] = (
    _p("anthropic-api-key", "credential", r"sk-ant-[a-zA-Z0-9-]{80,}", "api_key",
       anchors=("sk-ant-",)),
    _p("openai-api-key", "credential", r"sk-[a-zA-Z0-9]{20,}", "api_key",
       anchors=("sk-",)),
    _p("generic-api-key", "credential", r"sk-[a-zA-Z0-9_-]{20,}", "api_key",
       anchors=("sk-",)),
    _p("aws-key", "credential", r"(?<![A-Z0-9])AKIA[0-9A-Z]{16}(?![A-Z0-9])", "api_key",
       anchors=("akia",)),
    _p("google-api-key", "credential", r"AIza[0-9A-Za-z_-]{35}", "api_key",
       anchors=("aiza",)),
    _p("github-pat", "credential", r"ghp_[a-zA-Z0-9]{36}", "token",
       anchors=("ghp_",)),
    _p("github-server-token", "credential", r"ghs_[a-zA-Z0-9]{36}", "token",
       anchors=("ghs_",)),
    _p("gitlab-pat", "credential", r"glpat-[a-zA-Z0-9_-]{20,}", "token",
       anchors=("glpat-",)),
    _p("private-key-header", "credential",
       r"-----BEGIN (?:RSA |EC |OPENSSH )?PRIVATE KEY-----", "private_key",
       anchors=("-----begin",)),
    _p("bearer-token", "credential", r"Bearer [a-zA-Z0-9_./-]{20,}", "bearer",
       anchors=("bearer ",)),
    _p("basic-auth", "credential", r"Basic [A-Za-z0-9+/]{16,}={0,2}", "basic_auth",
       anchors=("basic ",)),
    _p("key-value-credential", "credential",
       r"(?:password|passwd|pwd|secret|token|api_key|apikey)\s*[:=]\s*['\"]?[^\s'\"]{8,64}",
       "credential",
       anchors=("password", "passwd", "pwd", "secret", "token", "api_key", "apikey"),
       lower_fast_path=True),
    _p("credit-card", "financial", r"\b[45]\d{3}[\s-]?\d{4}[\s-]?\d{4}[\s-]?\d{4}\b",
       "credit_card"),
    _p("iban", "financial", r"\b[A-Z]{2}\d{2}\s?[A-Z0-9]{4}\s?(?:\d{4}\s?){2,7}\d{1,4}\b",
       "iban"),
    _p("email-address", "pii", r"\b[a-zA-Z0-9._%+-]+@[a-zA-Z0-9.-]+\.[a-zA-Z]{2,}\b",
       "email", anchors=("@",)),
    # E.164 with + prefix, or separator-formatted numbers — bare digit runs
    # (ids, timestamps, error codes) must NOT be treated as phone numbers.
    # Anchors must be a SUPERSET of matchable strings: the separator class
    # includes space, so punctuation-only anchors would skip "555 123 4567".
    # Every match contains a digit, so anchor on digits — still prunes prose.
    _p("phone-number", "pii",
       r"(?<!\d)(?:\+[1-9]\d{6,14}|\(?\d{3}\)?[-. ]\d{3}[-. ]\d{4})(?!\d)", "phone",
       anchors=tuple("0123456789")),
    _p("ssn-us", "pii", r"\b\d{3}-\d{2}-\d{4}\b", "ssn", anchors=("-",)),
)


@dataclass
class PatternMatch:
    pattern: RedactionPattern
    match: str
    start: int
    end: int


class PatternRegistry:
    def __init__(self, enabled_categories: list[str],
                 custom_patterns: Optional[list[dict]] = None, logger=None):
        enabled = set(enabled_categories)
        self.patterns: list[RedactionPattern] = [
            p for p in BUILTIN_PATTERNS if p.category in enabled]
        for cp in custom_patterns or []:
            compiled = self._compile_custom(cp, logger)
            if compiled is not None:
                self.patterns.append(compiled)
        if logger is not None:
            n_builtin = sum(1 for p in self.patterns if p.builtin)
            logger.info(f"[redaction] Registry initialized: {len(self.patterns)} patterns "
                        f"({n_builtin} built-in, {len(self.patterns) - n_builtin} custom)")

    @staticmethod
    def _compile_custom(cp: dict, logger) -> Optional[RedactionPattern]:
        from ..policy_loader import validate_regex

        pattern = cp.get("pattern", "")
        err = validate_regex(pattern)
        if err:
            if logger is not None:
                logger.warn(f"[redaction] custom pattern {cp.get('id')} rejected: {err}")
            return None
        return RedactionPattern(
            id=cp.get("id", "custom"),
            category="custom",
            regex=re.compile(pattern),
            replacement_type=cp.get("replacementType", "custom"),
            builtin=False,
        )

    def by_category(self, category: str) -> list[RedactionPattern]:
        return [p for p in self.patterns if p.category == category]

    def find_matches(self, text: str) -> list[PatternMatch]:
        """All matches in category-priority order, overlaps resolved to the
        longest (earlier-category wins ties), sorted by position."""
        lowered = text.lower()
        lower_safe = len(lowered) == len(text)
        raw: list[PatternMatch] = []
        for category in CATEGORY_ORDER:
            for pattern in self.by_category(category):
                if pattern.anchors and not any(a in lowered for a in pattern.anchors):
                    continue
                if pattern.regex_ci_fallback is not None:
                    if lower_safe:
                        for m in pattern.regex.finditer(lowered):
                            raw.append(PatternMatch(pattern, text[m.start():m.end()],
                                                    m.start(), m.end()))
                    else:
                        for m in pattern.regex_ci_fallback.finditer(text):
                            raw.append(PatternMatch(pattern, m.group(0),
                                                    m.start(), m.end()))
                    continue
                for m in pattern.regex.finditer(text):
                    raw.append(PatternMatch(pattern, m.group(0), m.start(), m.end()))
        # overlap resolution: keep longest, first-registered priority on ties
        raw.sort(key=lambda m: (m.start, -(m.end - m.start)))
        out: list[PatternMatch] = []
        last_end = -1
        for m in raw:
            if m.start >= last_end:
                out.append(m)
                last_end = m.end
        return out
