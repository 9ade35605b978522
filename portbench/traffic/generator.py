"""The one generator of every traffic mix: it reads a mix's parameters
(``traffic/<mix>.json``) and draws the requests from ``--seed``.

Every seed gets the same multiset of sizes: lengths and call sizes are
taken at fixed quantiles of the mix's distribution, and the seed only
permutes them and draws the words. So two seeds ask for the same work in
another order and with other text, and a rate does not move with the seed.

The word and sentence tables and ``text_of`` are frozen copies of
``chip_smoke.py``'s (``_SUBJECTS``, ``_TEMPLATES``, ``_WORDS``, ``text_of``);
the finding texts copy ``models/data.py``'s held-out split and
``chip_smoke.triage_findings``. None is imported from the program, so a
change there does not change the traffic.

A mix's ``texts`` key picks the kind of request:

- ``"chat"``: outbound messages of ``sizes`` words, built from sentences
  of the chat tables and cut at that many words;
- ``"words"``: messages the tokenizer reads as exactly ``sizes`` real
  tokens (``text_of``);
- ``"findings"``: calls of ``sizes`` trace-analyzer findings each.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

_SUBJECTS = ("deploy", "api-server", "billing-job", "auth-service", "cache",
             "db-migration", "ingress", "webhook", "release", "audit")
_TEMPLATES = (
    "tool {n} failed: connection refused after {i} retries",
    "error: deployment {n} exceeded progress deadline",
    "no, that's wrong — {n} is still failing and this is useless",
    "permission denied writing to {n}",
    "rate limit hit calling {n}, backing off {i}s",
    "we decided to ship {n} tomorrow because the fix is ready",
    "thanks, {n} works perfectly now",
    "looks good, merging {n}",
    "reading file {n} ({i} bytes)",
    "what does the {n} flag do again?",
)
_WORDS = tuple(sorted({w for t in _TEMPLATES + _SUBJECTS
                       for w in t.replace("{n}", "").replace("{i}", "")
                       .replace("-", " ").split() if w.isalpha()}))

# models/data.py's held-out split: the templates with a noun slot, and the
# three nouns no training text has.
_FINDING_TEMPLATES = (
    "tool {n} failed: connection refused after {i} retries",
    "error: deployment {n} exceeded progress deadline",
    "no, that's wrong — {n} is still failing and this is useless",
    "you already tried {n} three times, stop repeating yourself",
    "permission denied writing to {n}",
    "rate limit hit calling {n}, backing off {i}s",
    "we decided to ship {n} tomorrow because the fix is ready",
    "let's go with {n} — it handles the edge cases better",
    "I'll deliver the {n} report by friday",
    "thanks, {n} works perfectly now",
    "looks good, merging {n}",
    "reading file {n} ({i} bytes)",
    "listing directory {n}",
    "hmm, which {n} did you mean? I see {i} candidates",
    "what does the {n} flag do again?",
)
_FINDING_NOUNS = ("ingress", "webhook", "scheduler")
_SEVERITIES = ("info", "low", "medium", "high", "critical")


@dataclass
class Finding:
    """A trace-analyzer finding as ``local_triage`` reads it."""
    signal: str
    severity: str
    summary: str
    evidence: list


def rng_of(seed: int, stream: int) -> np.random.Generator:
    """The seed's generator for one stream of draws (any whole number,
    negative or past 64 bits, is taken modulo 2**64)."""
    return np.random.default_rng([int(seed) % (1 << 64), stream])


def quantile_grid(spec: dict, n: int) -> np.ndarray:
    """``n`` whole sizes at the quantiles (i + 0.5) / n of ``spec``'s
    distribution, in ascending order, the same for every seed.

    - ``{"lognormal": {"median", "sigma"}, "min", "max"}``
    - ``{"loguniform": [lo, hi]}``"""
    u = (np.arange(n) + 0.5) / n
    if "lognormal" in spec:
        from statistics import NormalDist

        p = spec["lognormal"]
        z = np.array([NormalDist().inv_cdf(float(x)) for x in u])
        vals = np.exp(math.log(p["median"]) + p["sigma"] * z)
        vals = np.clip(np.rint(vals), spec["min"], spec["max"])
    elif "loguniform" in spec:
        lo, hi = spec["loguniform"]
        vals = np.rint(np.exp(math.log(lo) + u * math.log(hi / lo)))
    else:
        raise ValueError(f"unknown size distribution {sorted(spec)}")
    return vals.astype(np.int64)


def text_of(n_tokens: int, rng) -> str:
    """A message the tokenizer reads as ``n_tokens`` real tokens (the CLS
    token and ``n_tokens - 1`` words)."""
    return " ".join(_WORDS[i] for i in rng.integers(len(_WORDS),
                                                    size=n_tokens - 1))


def chat_text(n_words: int, rng) -> str:
    """An agent's outbound message of ``n_words`` whitespace-separated
    words: sentences of the chat tables, each with a subject and a number
    drawn from ``rng``, joined and cut at ``n_words``."""
    words: list = []
    while len(words) < n_words:
        words += _TEMPLATES[rng.integers(len(_TEMPLATES))].format(
            n=_SUBJECTS[rng.integers(len(_SUBJECTS))],
            i=int(rng.integers(2, 500))).split()
    return " ".join(words[:n_words])


def findings(n: int, rng) -> list:
    """``n`` findings over the held-out texts, at a severity each, half of
    them with an exit code as evidence (``chip_smoke.triage_findings``)."""
    out = []
    for _ in range(n):
        text = _FINDING_TEMPLATES[rng.integers(len(_FINDING_TEMPLATES))] \
            .format(n=_FINDING_NOUNS[rng.integers(len(_FINDING_NOUNS))],
                    i=int(rng.integers(2, 500)))
        evidence = [f"exit {int(rng.integers(0, 3))}"] \
            if rng.random() < 0.5 else []
        out.append(Finding("tool_failure",
                           _SEVERITIES[rng.integers(len(_SEVERITIES))],
                           text, evidence))
    return out


def generate(mix: dict, seed: int) -> list:
    """The mix's pool of requests for ``seed``, in the order they are
    sent: message texts (``chat``, ``words``) or lists of findings, one a
    call (``findings``). ``pool`` requests are drawn; the runner cycles
    through them."""
    kind, n = mix["texts"], int(mix["pool"])
    order_rng, text_rng = rng_of(seed, 1), rng_of(seed, 2)
    sizes = order_rng.permutation(quantile_grid(mix["sizes"], n))
    if kind == "chat":
        return [chat_text(int(k), text_rng) for k in sizes]
    if kind == "words":
        return [text_of(int(k), text_rng) for k in sizes]
    if kind == "findings":
        return [findings(int(k), text_rng) for k in sizes]
    raise ValueError(f"unknown texts kind {kind!r}")
