"""Static catastrophic-backtracking (ReDoS) detection over sre parse trees.

CPython's ``re`` is a backtracking engine: patterns whose match ambiguity
grows with input length take exponential time on crafted non-matching
input. The serving edges compile operator- and user-supplied patterns
(governance policy ``matches``/``messageContains``, cortex
``customPatterns``) and run them on every message — one pathological
pattern is a one-line denial of service against the verdict path.

Two heuristics cover the classic constructions (the same ground
``safe-regex``-style linters stand on; this is a *screen*, not a decision
procedure — Adversarial patterns beyond these shapes exist, which is why
unsafe patterns are demoted, not trusted-after-passing):

- **nested-quantifier** (star height ≥ 2): an unbounded backtracking
  repeat whose body contains another unbounded backtracking repeat, or can
  match the empty string. ``(a+)+``, ``(?:a*)*``, ``(?:\\s*x?)+`` — input
  ``"aaaa…!"`` explores exponentially many decompositions.
- **overlapping-alternation**: an unbounded repeat whose body reaches an
  alternation where two branches can start with the same character.
  ``(a|aa)+``, ``(?:ab|a.)+`` — same ambiguity, spelled with branches.

Possessive repeats and atomic groups never backtrack and are skipped;
lookarounds are scanned (they re-read text and backtrack internally).
Bounded repeats (``{3,40}``) are linear in their bound and safe here.

``pattern_safe`` is the compile-time gate the policy planner and cortex
pattern banks call; unparseable patterns answer safe — ``re.compile``
rejects them with its own, better error.

A copy of the screen of ``vainplex_openclaw_tpu/analysis/redos.py``
(``analyze_pattern``, ``pattern_safe``, ``unsafe_report``), kept here so
the port imports nothing of the JAX package. Its reverse, the attack-input
synthesis the adversarial packs use, is not ported.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

try:  # Python ≥3.11 moved the regex parser; 3.10 ships it as sre_parse
    from re import _constants as _c
    from re import _parser as _parser
except ImportError:  # pragma: no cover — version-dependent import only
    import sre_constants as _c
    import sre_parse as _parser

_UNBOUNDED = _c.MAXREPEAT
# Backtracking repeats only: POSSESSIVE_REPEAT (3.11+) never gives back.
_BACKTRACK_REPEATS = {_c.MAX_REPEAT, _c.MIN_REPEAT}
_POSSESSIVE = getattr(_c, "POSSESSIVE_REPEAT", None)
_ATOMIC = getattr(_c, "ATOMIC_GROUP", None)

# First-set markers: a concrete set of codepoints, or BROAD — "overlaps
# anything non-empty" (ANY, category classes, negated classes). BROAD keeps
# the analysis conservative exactly where precision stops being cheap.
_BROAD = object()


def _seq_items(node):
    """Child sequence(s) a construct can match through (skips the ones that
    consume no text or cannot backtrack into the body)."""
    op, av = node
    if op is _c.SUBPATTERN:
        return [av[3]]
    if op in _BACKTRACK_REPEATS or op is _POSSESSIVE:
        return [av[2]]
    if op is _c.BRANCH:
        return list(av[1])
    if op is _c.ASSERT or op is _c.ASSERT_NOT:
        return [av[1]]
    if _ATOMIC is not None and op is _ATOMIC:
        return [av]
    return []


def _min_len(seq) -> int:
    total = 0
    for op, av in seq:
        if op in (_c.LITERAL, _c.NOT_LITERAL, _c.IN, _c.ANY, _c.CATEGORY):
            total += 1
        elif op is _c.SUBPATTERN:
            total += _min_len(av[3])
        elif op in _BACKTRACK_REPEATS or op is _POSSESSIVE:
            total += av[0] * _min_len(av[2])
        elif op is _c.BRANCH:
            total += min((_min_len(b) for b in av[1]), default=0)
        elif _ATOMIC is not None and op is _ATOMIC:
            # (?>a)+ is SAFE and its body consumes text: dropping this
            # case read atomic groups as zero-length, flagging the
            # canonical safe rewrite as 'empty-matchable body'.
            total += _min_len(av)
        elif op is _c.GROUPREF:
            total += 0  # may be empty; conservative
        # AT / ASSERT / ASSERT_NOT consume nothing
    return total


def _first_set(seq):
    """Approximate set of first characters ``seq`` can consume, walking past
    zero-width and optional leading items. Returns (chars: set[int],
    broad: bool)."""
    chars: set[int] = set()
    broad = False
    for op, av in seq:
        consumed = True
        if op is _c.LITERAL:
            chars.add(av)
        elif op is _c.NOT_LITERAL:
            broad = True
        elif op is _c.ANY:
            broad = True
        elif op is _c.IN:
            negated = False
            for iop, iav in av:
                if iop is _c.NEGATE:
                    negated = True
                elif iop is _c.LITERAL:
                    chars.add(iav)
                elif iop is _c.RANGE:
                    lo, hi = iav
                    if hi - lo > 512:  # huge range: treat as broad
                        broad = True
                    else:
                        chars.update(range(lo, hi + 1))
                elif iop is _c.CATEGORY:
                    broad = True
            if negated:
                broad = True
        elif op is _c.SUBPATTERN:
            c, b = _first_set(av[3])
            chars |= c
            broad = broad or b
            consumed = _min_len(av[3]) > 0
        elif op in _BACKTRACK_REPEATS or op is _POSSESSIVE:
            c, b = _first_set(av[2])
            chars |= c
            broad = broad or b
            consumed = av[0] * _min_len(av[2]) > 0
        elif op is _c.BRANCH:
            for branch in av[1]:
                c, b = _first_set(branch)
                chars |= c
                broad = broad or b
            consumed = all(_min_len(b) > 0 for b in av[1])
        elif _ATOMIC is not None and op is _ATOMIC:
            c, b = _first_set(av)
            chars |= c
            broad = broad or b
            consumed = _min_len(av) > 0
        elif op in (_c.AT, _c.ASSERT, _c.ASSERT_NOT):
            consumed = False
        elif op is _c.GROUPREF:
            broad = True  # runtime-dependent
        else:
            broad = True
        if consumed:
            break  # a required consumer ends the first-set frontier
    return chars, broad


def _overlap(a, b) -> bool:
    (ca, ba), (cb, bb) = a, b
    if ba and (cb or bb):
        return True
    if bb and (ca or ba):
        return True
    return bool(ca & cb)


def _has_backtracking_unbounded(seq) -> bool:
    for node in seq:
        op, av = node
        if op in _BACKTRACK_REPEATS and av[1] == _UNBOUNDED:
            return True
        if op is _POSSESSIVE or (_ATOMIC is not None and op is _ATOMIC):
            continue  # never gives back: cannot multiply ambiguity
        for sub in _seq_items(node):
            if _has_backtracking_unbounded(sub):
                return True
    return False


def _ambiguous_branch(seq, restart_first) -> bool:
    """True when ``seq`` reaches an alternation (outside possessive/atomic
    regions) that makes an enclosing unbounded repeat ambiguous: two
    branches whose first characters collide, or an empty-matchable branch
    next to one whose first characters collide with ``restart_first`` (the
    first set of the whole repeat body — sre prefix-factors ``(a|aa)`` into
    ``a(?:|a)``, so the trailing ``a`` overlaps the next iteration's start,
    the exact two-ways-to-split ambiguity)."""
    for node in seq:
        op, av = node
        if op is _POSSESSIVE or (_ATOMIC is not None and op is _ATOMIC):
            continue
        if op is _c.BRANCH:
            firsts = [_first_set(b) for b in av[1]]
            empties = [_min_len(b) == 0 for b in av[1]]
            for i in range(len(firsts)):
                for j in range(i + 1, len(firsts)):
                    if _overlap(firsts[i], firsts[j]):
                        return True
            if sum(empties) >= 2:
                return True  # two zero-width parses per iteration
            if any(empties):
                for first, empty in zip(firsts, empties):
                    if not empty and _overlap(first, restart_first):
                        return True
        for sub in _seq_items(node):
            if _ambiguous_branch(sub, restart_first):
                return True
    return False


def _walk_repeats(seq, issues: list) -> None:
    for node in seq:
        op, av = node
        if op in _BACKTRACK_REPEATS and av[1] == _UNBOUNDED:
            body = av[2]
            if _min_len(body) == 0:
                issues.append("nested-quantifier: unbounded repeat over a "
                              "body that can match the empty string")
            elif _has_backtracking_unbounded(body):
                issues.append("nested-quantifier: unbounded repeat containing "
                              "another unbounded backtracking repeat")
            if _ambiguous_branch(body, _first_set(body)):
                issues.append("overlapping-alternation: unbounded repeat over "
                              "branches sharing first characters")
        for sub in _seq_items(node):
            _walk_repeats(sub, issues)


@lru_cache(maxsize=4096)
def analyze_pattern(pattern: str, flags: int = 0) -> tuple[str, ...]:
    """Issues found in ``pattern`` — empty tuple means no known-catastrophic
    construction. Unparseable patterns report no issues (``re.compile`` owns
    that failure mode)."""
    try:
        seq = _parser.parse(pattern, flags)
    except Exception:  # noqa: BLE001 — invalid regex: not this analyzer's job
        return ()
    issues: list[str] = []
    _walk_repeats(seq, issues)
    return tuple(dict.fromkeys(issues))


def pattern_safe(pattern: str, flags: int = 0) -> bool:
    return not analyze_pattern(pattern, flags)


def unsafe_report(pattern: str, flags: int = 0) -> Optional[str]:
    issues = analyze_pattern(pattern, flags)
    return "; ".join(issues) if issues else None

