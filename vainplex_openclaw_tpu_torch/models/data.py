"""Deterministic data pipeline: labelled agent-trace text → static-shape
batches.

A verbatim copy of ``vainplex_openclaw_tpu/models/data.py`` over the port's
tokenizer: the templates, the noun lists, the generator draws and the
epoch-keyed shuffle must stay byte-equal, so the port and the JAX package
see identical corpora and identical batches in identical order (the parity
tests compare them).

Every batch is exactly ``[batch_size, seq_len]`` (drop-remainder for
training; eval wraps around so every example is scored exactly once via
the ``n_valid`` count). Shuffling is seeded and epoch-keyed, so a resumed
run (``models/train.py``) sees the identical batch order.
"""

from __future__ import annotations

import numpy as np

from .tokenizer import encode_texts

# (template, severity 0..3, keep, mood) — mood: 0 frustrated | 1 neutral |
# 2 satisfied | 3 urgent | 4 confused. Formatted with a varying noun/index.
_TEMPLATES = [
    ("tool {n} failed: connection refused after {i} retries", 3, 1, 3),
    ("error: deployment {n} exceeded progress deadline", 3, 1, 3),
    ("no, that's wrong — {n} is still failing and this is useless", 2, 1, 0),
    ("you already tried {n} three times, stop repeating yourself", 2, 1, 0),
    ("permission denied writing to {n}", 2, 1, 1),
    ("rate limit hit calling {n}, backing off {i}s", 1, 1, 1),
    ("we decided to ship {n} tomorrow because the fix is ready", 1, 1, 1),
    ("let's go with {n} — it handles the edge cases better", 1, 1, 2),
    ("I'll deliver the {n} report by friday", 1, 1, 1),
    ("thanks, {n} works perfectly now", 0, 0, 2),
    ("looks good, merging {n}", 0, 0, 2),
    ("reading file {n} ({i} bytes)", 0, 0, 1),
    ("listing directory {n}", 0, 0, 1),
    ("hmm, which {n} did you mean? I see {i} candidates", 0, 1, 4),
    ("what does the {n} flag do again?", 0, 0, 4),
    ("ok", 0, 0, 1),
]
_NOUNS = ["deploy", "api-server", "kubectl", "auth-service", "build", "cache",
          "v2-rollout", "db-migration", "billing-job", "ingress", "webhook",
          "scheduler"]


def _generate(n: int, seed: int, templates: list, nouns: list) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        tmpl, sev, keep, mood = templates[rng.integers(len(templates))]
        text = tmpl.format(n=nouns[rng.integers(len(nouns))],
                           i=int(rng.integers(2, 500)))
        out.append((text, {"severity": sev, "keep": keep, "mood": mood}))
    return out


def synthetic_examples(n: int, seed: int = 0) -> list[tuple[str, dict]]:
    """n labelled (text, {severity, keep, mood}) examples, deterministic."""
    return _generate(n, seed, _TEMPLATES, _NOUNS)


# Nouns reserved for evaluation: never seen in any training text.
_EVAL_NOUNS = 3


def synthetic_split(n_train: int, n_eval: int,
                    seed: int = 0) -> tuple[list, list]:
    """Train/eval corpora with DISJOINT noun vocabularies — and eval
    restricted to templates with a noun slot — so no eval text can be an
    exact training duplicate (ADVICE r4: the old tail-split drew from one
    generator, letting 'held-out' accuracy measure template memorization).
    Eval still uses the same templates: the tested skill is generalization
    over surface variation, which is what the triage heads need in
    production."""
    train = _generate(n_train, seed, _TEMPLATES, _NOUNS[:-_EVAL_NOUNS])
    eval_templates = [t for t in _TEMPLATES if "{n}" in t[0]]
    evals = _generate(n_eval, seed + 1, eval_templates, _NOUNS[-_EVAL_NOUNS:])
    return train, evals


class TextClassificationData:
    """Seeded, epoch-keyed batches over labelled examples."""

    def __init__(self, examples: list[tuple[str, dict]], batch_size: int,
                 seq_len: int = 128, vocab_size: int = 8192, seed: int = 0):
        if not examples:
            raise ValueError("empty dataset")
        self.examples = examples
        self.batch_size = batch_size
        self.seed = seed
        texts = [t for t, _ in examples]
        self.tokens = encode_texts(texts, seq_len=seq_len, vocab_size=vocab_size)
        self.labels = {head: np.asarray([lab[head] for _, lab in examples],
                                        dtype=np.int32)
                       for head in ("severity", "keep", "mood")}

    def __len__(self) -> int:
        return len(self.examples)

    def _batch(self, idx: np.ndarray) -> dict:
        return {"tokens": self.tokens[idx],
                **{h: self.labels[h][idx] for h in self.labels}}

    def epoch(self, epoch_idx: int, shuffle: bool = True):
        """Drop-remainder batches; order depends only on (seed, epoch_idx)."""
        order = np.arange(len(self.examples))
        if shuffle:
            np.random.default_rng((self.seed, epoch_idx)).shuffle(order)
        for start in range(0, len(order) - self.batch_size + 1, self.batch_size):
            yield self._batch(order[start:start + self.batch_size])

    def eval_batches(self):
        """Static-shape eval batches; the final batch wraps around and
        reports ``n_valid`` so wrapped duplicates are excluded from metrics."""
        n = len(self.examples)
        for start in range(0, n, self.batch_size):
            idx = np.arange(start, start + self.batch_size) % n
            yield self._batch(idx), min(self.batch_size, n - start)
