"""Stage-1 claim detection: 5 regex detectors
(reference: governance/src/claim-detector.ts:20-341).

Detector ids: system_state, entity_name, existence, operational_status,
self_referential.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

COMMON_WORDS = frozenset(
    "it this that there what which who everything something nothing anything "
    "all one thing things system systems service services server servers they "
    "he she we you i the a an is are was were be been being".split())


@dataclass
class Claim:
    type: str
    subject: str
    predicate: str
    value: str
    source: str
    offset: int


_SYSTEM_STATE = re.compile(
    r"\b([\w][\w.:-]{0,60})\s+(?:is|are)\s+"
    r"(running|stopped|online|offline|active|inactive|enabled|disabled|up|down|"
    r"started|paused|healthy|unhealthy)\b", re.IGNORECASE)

_ENTITY_NAME = re.compile(
    r"\bthe\s+(agent|service|server|container|process|pod|node|instance|database|"
    r"cluster|daemon|plugin|module)\s+(?:named|called|known as|labelled|labeled)?"
    r"\s*[\"`']?([\w][\w.:-]{0,60})[\"`']?\b", re.IGNORECASE)

_EXISTENCE_POS = re.compile(
    r"\b([\w][\w.:-]{0,60})\s+(?:exists|is available|is present|is configured|"
    r"is installed|is deployed|is registered)\b", re.IGNORECASE)

_EXISTENCE_NEG = re.compile(
    r"\b([\w][\w.:-]{0,60})\s+(?:does(?:n't| not) exist|is not available|"
    r"is not present|is not configured|is not installed|is not deployed|"
    r"is not registered)\b", re.IGNORECASE)

_OPERATIONAL = re.compile(
    r"\b([\w][\w.:-]{0,60})\s+(?:responded|returned|completed|failed|succeeded|"
    r"crashed|timed out|rebooted|restarted)\b", re.IGNORECASE)

_SELF_REFERENTIAL = re.compile(
    r"\bI\s+(?:am|have|was|did|can|will)\s+((?:[\w'-]+\s*){1,8})", re.IGNORECASE)


def _is_common(subject: str) -> bool:
    return subject.lower() in COMMON_WORDS


def detect_system_state(text: str) -> list[Claim]:
    out = []
    for m in _SYSTEM_STATE.finditer(text):
        subject = m.group(1).strip()
        if _is_common(subject):
            continue
        out.append(Claim("system_state", subject, "state", m.group(2).lower(),
                         m.group(0), m.start()))
    return out


def detect_entity_name(text: str) -> list[Claim]:
    return [Claim("entity_name", m.group(2).strip(), "entity_type",
                  m.group(1).lower(), m.group(0), m.start())
            for m in _ENTITY_NAME.finditer(text)]


def detect_existence(text: str) -> list[Claim]:
    out = []
    for m in _EXISTENCE_POS.finditer(text):
        subject = m.group(1).strip()
        if not _is_common(subject):
            out.append(Claim("existence", subject, "exists", "true", m.group(0), m.start()))
    for m in _EXISTENCE_NEG.finditer(text):
        subject = m.group(1).strip()
        if not _is_common(subject):
            out.append(Claim("existence", subject, "exists", "false", m.group(0), m.start()))
    return out


def detect_operational_status(text: str) -> list[Claim]:
    out = []
    for m in _OPERATIONAL.finditer(text):
        subject = m.group(1).strip()
        if _is_common(subject):
            continue
        out.append(Claim("operational_status", subject, "last_operation",
                         m.group(0)[len(m.group(1)):].strip().lower(), m.group(0), m.start()))
    return out


def detect_self_referential(text: str) -> list[Claim]:
    return [Claim("self_referential", "self", "statement", m.group(1).strip(),
                  m.group(0).strip(), m.start())
            for m in _SELF_REFERENTIAL.finditer(text)]


BUILTIN_DETECTORS = {
    "system_state": detect_system_state,
    "entity_name": detect_entity_name,
    "existence": detect_existence,
    "operational_status": detect_operational_status,
    "self_referential": detect_self_referential,
}


def detect_claims(text: str, enabled=None) -> list[Claim]:
    enabled = enabled if enabled is not None else list(BUILTIN_DETECTORS)
    claims: list[Claim] = []
    for detector_id in enabled:
        fn = BUILTIN_DETECTORS.get(detector_id)
        if fn is not None:
            claims.extend(fn(text))
    claims.sort(key=lambda c: c.offset)
    return claims
