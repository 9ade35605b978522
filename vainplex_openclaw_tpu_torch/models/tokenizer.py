"""Hash tokenizer: text → fixed-shape int32 ids with no vocabulary files.

Byte-equal output to ``vainplex_openclaw_tpu/models/tokenizer.py``: the
word regex, FNV-1a hashing into ``vocab_size`` buckets, the ``.lower()``
and the reserved ids (PAD=0, CLS=1) must stay byte-equal, or the shipped
checkpoint reads different tokens than it was trained on.

Rows are encoded by one compiled host pass (``ops/csrc/tokenizer.cpp``,
built at first use with the host C++ compiler and called once a batch
through ``ctypes``, which lets go of the interpreter lock for the call).
Python lowers each whole text and encodes it to UTF-8; the pass classifies
each code point by :func:`class_table`, built from the running Python's own
``str`` predicates, forms the regex's tokens, hashes them and stops at the
``seq_len - 1``-th. A row the pass cannot take (a code point above U+FFFF
before its last kept token, or text that will not encode to UTF-8, such as
a lone surrogate) runs the Python loop below, as does every row where the
library cannot be built; the ids are the same either way.

:data:`compiled_rows` and :data:`python_rows` count the rows each path
encoded. While a torch profiler records, the Python loop inside a call is
the log record ``tokenize_py`` (``n``: its rows; see
``utils/stage_timer.py``).
"""

from __future__ import annotations

import logging
import re
import threading
import time

import numpy as np

from ..utils import stage_timer

PAD_ID = 0
CLS_ID = 1
_RESERVED = 2
_WORD_RE = re.compile(r"[\w$#@/.-]+|[^\w\s]", re.UNICODE)

# Code point classes of the compiled pass (``csrc/tokenizer.cpp``).
OTHER, WORD, SPACE = 0, 1, 2
TABLE_SIZE = 0x10000

# Rows encoded since the last reset, by the compiled pass and by the
# Python loop; tools set them to 0 before a run they read.
compiled_rows = 0
python_rows = 0
_count_lock = threading.Lock()

# (tokenize_rows, class table) once loaded; False where the library
# cannot be built.
_native = None
_native_lock = threading.Lock()
_log = logging.getLogger(__name__)


def _fnv1a(token: str) -> int:
    h = 0xCBF29CE484222325
    for b in token.encode("utf-8"):
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def class_table() -> bytes:
    """The class of each code point U+0000..U+FFFF as ``_WORD_RE`` reads
    it: WORD for ``\\w`` (``str.isalnum()`` or ``_``, the predicate ``re``
    uses) and ``$#@/.-``, SPACE for ``\\s`` (``str.isspace()``), else
    OTHER."""
    return bytes(WORD if c.isalnum() or c in "_$#@/.-"
                 else SPACE if c.isspace() else OTHER
                 for c in map(chr, range(TABLE_SIZE)))


def _compiled():
    """``(tokenize_rows, table)``, built and loaded at the first call, or
    None where the library cannot be built."""
    global _native
    if _native is None:
        with _native_lock:
            if _native is None:
                from ..ops import _build

                try:
                    fn = _build.load_host_library("tokenizer").tokenize_rows
                    _native = (fn, np.frombuffer(class_table(), np.uint8))
                except (RuntimeError, OSError) as exc:
                    _log.warning("compiled tokenizer unavailable, every "
                                 "row takes the Python loop: %s", exc)
                    _native = False
    return _native or None


def _encode_compiled(native, texts, out: np.ndarray, seq_len: int,
                     vocab_size: int) -> np.ndarray:
    """Encode ``texts`` into ``out`` in one call of the compiled pass;
    returns the indices of the rows it did not take, ascending."""
    fn, table = native
    n = len(texts)
    skipped = np.zeros(n, np.uint8)
    try:
        parts = [t.lower().encode("utf-8") for t in texts]
    except (AttributeError, UnicodeEncodeError):
        parts = []
        for i, t in enumerate(texts):
            try:
                parts.append(t.lower().encode("utf-8"))
            except (AttributeError, UnicodeEncodeError):
                parts.append(b"")
                skipped[i] = 1
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(np.fromiter(map(len, parts), np.int64, n), out=offsets[1:])
    fn(b"".join(parts), offsets.ctypes.data, n, seq_len, vocab_size,
       table.ctypes.data, out.ctypes.data, skipped.ctypes.data)
    return np.flatnonzero(skipped)


def _encode_python(texts, rows, out: np.ndarray, seq_len: int,
                   vocab_size: int) -> None:
    """The regex loop over ``rows`` of ``texts``."""
    buckets = vocab_size - _RESERVED
    for i in rows:
        out[i, 0] = CLS_ID
        words = _WORD_RE.findall(texts[i].lower())[: seq_len - 1]
        for j, w in enumerate(words):
            out[i, j + 1] = _RESERVED + (_fnv1a(w) % buckets)


def encode_texts(texts: list[str], seq_len: int = 128, vocab_size: int = 8192) -> np.ndarray:
    """Batch-encode to ``[len(texts), seq_len]`` int32 (CLS + hashed words + PAD)."""
    global compiled_rows, python_rows
    n = len(texts)
    out = np.zeros((n, seq_len), dtype=np.int32)
    # the pass takes what the int32 ids and its uint64 hash can hold
    native = _compiled() if n and seq_len >= 1 \
        and 3 <= vocab_size <= 1 << 31 else None
    if native is None:
        rows = range(n)
    else:
        rows = _encode_compiled(native, texts, out, int(seq_len),
                                int(vocab_size))
    with _count_lock:
        compiled_rows += n - len(rows)
        python_rows += len(rows)
    if len(rows):
        t0 = time.perf_counter() if stage_timer.tracing() else None
        _encode_python(texts, rows, out, seq_len, vocab_size)
        if t0 is not None:
            stage_timer.SPANS.add("tokenize_py", t0, time.perf_counter(),
                                  n=len(rows))
    return out
