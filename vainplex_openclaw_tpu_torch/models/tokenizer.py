"""Hash tokenizer: text → fixed-shape int32 ids with no vocabulary files.

A verbatim copy of ``vainplex_openclaw_tpu/models/tokenizer.py``: the word
regex, FNV-1a hashing into ``vocab_size`` buckets, the ``.lower()`` and the
reserved ids (PAD=0, CLS=1) must stay byte-equal, or the shipped checkpoint
reads different tokens than it was trained on.
"""

from __future__ import annotations

import re

import numpy as np

PAD_ID = 0
CLS_ID = 1
_RESERVED = 2
_WORD_RE = re.compile(r"[\w$#@/.-]+|[^\w\s]", re.UNICODE)


def _fnv1a(token: str) -> int:
    h = 0xCBF29CE484222325
    for b in token.encode("utf-8"):
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def encode_texts(texts: list[str], seq_len: int = 128, vocab_size: int = 8192) -> np.ndarray:
    """Batch-encode to ``[len(texts), seq_len]`` int32 (CLS + hashed words + PAD)."""
    out = np.zeros((len(texts), seq_len), dtype=np.int32)
    buckets = vocab_size - _RESERVED
    for i, text in enumerate(texts):
        out[i, 0] = CLS_ID
        words = _WORD_RE.findall(text.lower())[: seq_len - 1]
        for j, w in enumerate(words):
            out[i, j + 1] = _RESERVED + (_fnv1a(w) % buckets)
    return out
