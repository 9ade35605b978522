"""Frozen copies of the text the program reads and writes: the hash
tokenizer, the stage-3 prompt and the cut of its MESSAGE section, the
verdict's rendering and a finding's triage text.

Each is copied from the program as it stood when the benchmark was
written (``models/tokenizer.py``, ``models/serve.py``'s
``_extract_message``, ``models/batching.py``'s ``render_verdict``,
``cortex/trace_analyzer/classifier.py``'s ``finding_text``), so the
reference reads the requests the same way whatever a later change does to
the program's own copies.
"""

from __future__ import annotations

import json
import re

import numpy as np

PAD_ID = 0
CLS_ID = 1
_RESERVED = 2
WORD_RE = re.compile(r"[\w$#@/.-]+|[^\w\s]", re.UNICODE)


def _fnv1a(token: str) -> int:
    h = 0xCBF29CE484222325
    for b in token.encode("utf-8"):
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def encode_texts(texts: list, seq_len: int, vocab_size: int) -> np.ndarray:
    """``[len(texts), seq_len]`` int32: CLS, then each word hashed into
    ``vocab_size - 2`` buckets above the reserved ids, then PAD."""
    out = np.zeros((len(texts), seq_len), dtype=np.int32)
    buckets = vocab_size - _RESERVED
    for i, text in enumerate(texts):
        out[i, 0] = CLS_ID
        words = WORD_RE.findall(text.lower())[: seq_len - 1]
        for j, w in enumerate(words):
            out[i, j + 1] = _RESERVED + (_fnv1a(w) % buckets)
    return out


def real_tokens(text: str, seq_len: int) -> int:
    """The tokens the encoder reads for ``text``: CLS and its words, cut
    at ``seq_len``. A hashed word is never PAD, so this is the count of
    non-zero ids :func:`encode_texts` gives."""
    return min(1 + len(WORD_RE.findall(text.lower())), seq_len)


# The stage-3 prompt: llm_validator.build_prompt's shape, the message
# embedded verbatim between the MESSAGE header and the next section.
_MESSAGE_START = "MESSAGE:\n"
_MESSAGE_END = "\n\nIdentify issues"


def as_prompt(text: str) -> str:
    return ("You are reviewing an outbound message.\n\nKNOWN FACTS:\n- (none)"
            f"\n\nMESSAGE:\n{text}\n\nIdentify issues in these categories.")


def extract_message(prompt: str) -> str:
    if _MESSAGE_START not in prompt:
        return prompt.strip()
    body = prompt.split(_MESSAGE_START, 1)[1]
    if _MESSAGE_END in body:
        body = body.rsplit(_MESSAGE_END, 1)[0]
    return body.strip()


SEVERITY_TO_VERDICT = ("pass", "pass", "flag", "block")


def render_verdict(severity: int) -> str:
    verdict = SEVERITY_TO_VERDICT[min(severity, len(SEVERITY_TO_VERDICT) - 1)]
    issues = []
    if verdict != "pass":
        issues.append({"category": "unverifiable_claim",
                       "detail": f"local triage severity class {severity}"})
    return json.dumps({
        "verdict": verdict,
        "reason": f"local triage encoder: severity class {severity}",
        "issues": issues,
    })


# Every verdict the program may render, to its severity class.
VERDICT_CLASS = {render_verdict(c): c for c in range(4)}


def finding_text(finding) -> str:
    return (f"{finding.signal} {finding.summary} "
            f"{' '.join(map(str, finding.evidence))}")
