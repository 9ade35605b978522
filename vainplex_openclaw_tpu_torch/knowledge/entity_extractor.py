"""Regex NER (reference: knowledge-engine/src/entity-extractor.ts,
patterns.ts).

A copy of ``vainplex_openclaw_tpu/knowledge/entity_extractor.py``, kept
here so the port imports nothing of the JAX package: the same
``PATTERNS``, ``canonicalize``, ``initial_importance`` and
``EntityExtractor``, so both packages extract the same entities.

Patterns: email, url, ISO/common/German/English dates, proper nouns (with a
sentence-start exclusion list), product names (versions/Roman numerals/
camelCase), organization suffixes. Canonicalization strips org suffixes and
trailing punctuation; repeated mentions merge and bump counts. Python's
``re`` is stateless, so patterns compile once.
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass, field
from typing import Callable

EXCLUDED_WORDS = (
    "A", "An", "The", "Hello", "My", "This", "Contact", "He", "She", "It",
    "We", "They", "I", "You", "His", "Her", "Our", "Your", "Their", "Its",
    "That", "These", "Those", "What", "Which", "Who", "How", "When", "Where",
    "Why", "But", "And", "Or", "So", "Not", "No", "Yes", "Also", "Just",
    "For", "From", "With", "About", "After", "Before", "Between", "During",
    "Into", "Through", "Event", "Talk", "Project", "Multiple", "German",
    "Am", "Are", "Is", "Was", "Were", "Has", "Have", "Had", "Do", "Does",
    "Did", "Will", "Would", "Could", "Should", "May", "Might", "Must",
    "Can", "Shall", "If", "Then",
)

_EXCL = "|".join(f"{w}\\b" for w in EXCLUDED_WORDS)
_CAP = r"(?:[A-Z][a-z']*(?:[A-Z][a-z']+)*|[A-Z]{2,})"
_DE_MONTHS = ("Januar|Februar|März|April|Mai|Juni|Juli|August|September|"
              "Oktober|November|Dezember")
_EN_MONTHS = ("January|February|March|April|May|June|July|August|September|"
              "October|November|December")

PATTERNS: dict[str, re.Pattern] = {
    "email": re.compile(r"\b[a-zA-Z0-9._%+-]+@[a-zA-Z0-9.-]+\.[a-zA-Z]{2,}\b"),
    "url": re.compile(r"\bhttps?://[^\s/$.?#].[^\s]*"),
    "iso_date": re.compile(r"\b\d{4}-\d{2}-\d{2}(?:T\d{2}:\d{2}:\d{2}(?:\.\d+)?Z?)?\b"),
    "common_date": re.compile(r"\b(?:\d{1,2}/\d{1,2}/\d{2,4})|(?:\d{1,2}\.\d{1,2}\.\d{2,4})\b"),
    "german_date": re.compile(rf"\b\d{{1,2}}\.\s(?:{_DE_MONTHS})\s+\d{{4}}\b", re.IGNORECASE),
    "english_date": re.compile(rf"\b(?:{_EN_MONTHS})\s+\d{{1,2}}(?:st|nd|rd|th)?,\s+\d{{4}}\b",
                               re.IGNORECASE),
    "proper_noun": re.compile(rf"\b(?!{_EXCL}){_CAP}(?:(?:-|\s)(?!{_EXCL}){_CAP})*\b"),
    "product_name": re.compile(
        rf"\b(?:(?!{_EXCL})[A-Z][a-zA-Z0-9]{{2,}}(?:\s[a-zA-Z]+)*\s[IVXLCDM]+"
        r"|[a-zA-Z][a-zA-Z0-9-]{2,}[\s-]v?\d+(?:\.\d+)?"
        r"|[a-zA-Z][a-zA-Z0-9]+[IVXLCDM]+)\b"),
    "organization_suffix": re.compile(
        r"\b(?:[A-Z][A-Za-z0-9]+(?:\s[A-Z][A-Za-z0-9]+)*),?\s?"
        r"(?:Inc\.|LLC|Corp\.|GmbH|AG|Ltd\.)"),
}

PATTERN_TYPE_MAP = {
    "email": "email", "url": "url",
    "iso_date": "date", "common_date": "date", "german_date": "date",
    "english_date": "date",
    "proper_noun": "unknown", "product_name": "product",
    "organization_suffix": "organization",
}

_ORG_SUFFIX_RE = re.compile(r",?\s?(?:Inc\.|LLC|Corp\.|GmbH|AG|Ltd\.)$", re.IGNORECASE)
_TRAILING_PUNCT_RE = re.compile(r"[.,!?;:]$")

TYPE_IMPORTANCE = {"email": 0.8, "organization": 0.8, "product": 0.7,
                   "url": 0.6, "date": 0.5, "unknown": 0.4}


@dataclass
class Entity:
    id: str
    type: str
    value: str
    mentions: list[str] = field(default_factory=list)
    count: int = 1
    importance: float = 0.4
    last_seen: str = ""
    source: list[str] = field(default_factory=lambda: ["regex"])

    def to_dict(self) -> dict:
        return {"id": self.id, "type": self.type, "value": self.value,
                "mentions": self.mentions, "count": self.count,
                "importance": self.importance, "lastSeen": self.last_seen,
                "source": self.source}


def canonicalize(value: str, entity_type: str) -> str:
    if entity_type == "organization":
        return _ORG_SUFFIX_RE.sub("", value).strip()
    return _TRAILING_PUNCT_RE.sub("", value).strip()


def initial_importance(entity_type: str, value: str) -> float:
    base = TYPE_IMPORTANCE.get(entity_type, 0.4)
    if len(value) > 20:
        base = min(1.0, base + 0.1)  # longer names are more specific
    return base


class EntityExtractor:
    def __init__(self, logger=None, clock: Callable[[], float] = time.time):
        self.logger = logger
        self.clock = clock

    def extract(self, text: str) -> list[Entity]:
        found: dict[str, Entity] = {}
        for key, pattern in PATTERNS.items():
            entity_type = PATTERN_TYPE_MAP.get(key, "unknown")
            for m in pattern.finditer(text):
                value = m.group(0).strip()
                if value:
                    self._process(value, entity_type, found)
        return list(found.values())

    def _process(self, value: str, entity_type: str, found: dict) -> None:
        canonical = canonicalize(value, entity_type)
        if not canonical:
            return
        slug = re.sub(r"\s+", "-", canonical.lower())
        entity_id = f"{entity_type}:{slug}"
        existing = found.get(entity_id)
        if existing is not None:
            if value not in existing.mentions:
                existing.mentions.append(value)
            existing.count += 1
            return
        t = time.gmtime(self.clock())
        found[entity_id] = Entity(
            id=entity_id, type=entity_type, value=canonical, mentions=[value],
            importance=initial_importance(entity_type, canonical),
            last_seen=(f"{t.tm_year:04d}-{t.tm_mon:02d}-{t.tm_mday:02d}T"
                       f"{t.tm_hour:02d}:{t.tm_min:02d}:{t.tm_sec:02d}Z"),
        )
