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

A copy of ``vainplex_openclaw_tpu/analysis/redos.py``, kept here so the
port imports nothing of the JAX package: the screen (``analyze_pattern``,
``pattern_safe``, ``unsafe_report``) and its reverse, the attack-input
synthesis the adversarial packs use (``worst_case_inputs``,
``stress_inputs``).
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


# ── the screen run in reverse ─────────────────────────────────────────
#
# ``worst_case_inputs`` synthesizes the attack strings the analyzer's
# issue reports describe: a pump of the flagged repeat body's first
# characters followed by a byte that forces the overall match to fail, so
# a backtracking engine explores every decomposition of the pump. The
# harvest walk mirrors ``_walk_repeats`` condition for condition, which
# makes the contract structural rather than aspirational: the generator
# returns attacks for EXACTLY the patterns the screen flags.
#
# ``stress_inputs`` is the companion for patterns the screen PASSED: the
# heaviest probes a linear pattern admits — near-miss pumps of its longest
# literal runs and first-set floods. The adversarial redos_storm pack
# feeds these to the shipped (screened-clean) packs and policies, so a
# latency blowup there would mean the screen's linearity guarantee broke.


def _pump_unit(body) -> str:
    """One character the repeat body can start with — printable if any."""
    chars, _broad = _first_set(body)
    printable = sorted(c for c in chars if 32 <= c < 127)
    if printable:
        return chr(printable[0])
    if chars:
        return chr(min(chars))
    return "a"


def _walk_attack_bodies(seq, bodies: list) -> None:
    """The ``_walk_repeats`` walk, harvesting flagged repeat bodies instead
    of issue strings. Keep the two conditionals in lockstep: a divergence
    breaks the generator⟺screen iff-contract the tests pin."""
    for node in seq:
        op, av = node
        if op in _BACKTRACK_REPEATS and av[1] == _UNBOUNDED:
            body = av[2]
            if (_min_len(body) == 0
                    or _has_backtracking_unbounded(body)
                    or _ambiguous_branch(body, _first_set(body))):
                bodies.append(body)
        for sub in _seq_items(node):
            _walk_attack_bodies(sub, bodies)


def worst_case_inputs(pattern: str, flags: int = 0, pump: int = 48,
                      cap: int = 4) -> list[str]:
    """Attack inputs for a pattern the screen flags; ``[]`` for every
    pattern it passes. Each input pumps a flagged repeat body ``pump``
    times and appends a terminator chosen to miss the body's first set,
    the classic fail-late shape that maximizes backtracking. NEVER run
    these through ``re`` against an unscreened pattern — the whole point
    is that they take exponential time there."""
    if not analyze_pattern(pattern, flags):
        return []
    try:
        seq = _parser.parse(pattern, flags)
    except Exception:  # noqa: BLE001 — analyze_pattern already parsed; belt
        return []
    bodies: list = []
    _walk_attack_bodies(seq, bodies)
    out: list[str] = []
    seen: set[str] = set()
    for body in bodies:
        unit = _pump_unit(body)
        chars, _broad = _first_set(body)
        tail = "\x00" if ord(unit) != 0 else "\x01"
        while ord(tail) in chars and ord(tail) < 32:
            tail = chr(ord(tail) + 1)
        s = unit * max(1, pump) + tail
        if s not in seen:
            seen.add(s)
            out.append(s)
        if len(out) >= cap:
            break
    if not out:  # unreachable while the walks agree; keeps the iff honest
        out.append("a" * max(1, pump) + "\x00")
    return out


def _literal_runs(seq, runs: list, cur: list) -> None:
    """Collect maximal consecutive LITERAL runs anywhere in the tree."""
    for node in seq:
        op, av = node
        if op is _c.LITERAL:
            cur.append(chr(av))
            continue
        if cur:
            runs.append("".join(cur))
            cur.clear()
        for sub in _seq_items(node):
            _literal_runs(sub, runs, [])
    if cur:
        runs.append("".join(cur))
        cur.clear()


def stress_inputs(pattern: str, flags: int = 0, pump: int = 32,
                  cap: int = 3) -> list[str]:
    """Heaviest linear probes for any parseable pattern: the longest
    literal run minus its final character pumped (repeated almost-match,
    the prefilter's worst honest case) plus a first-set flood. Intended
    for patterns ``pattern_safe`` already passed — cost is linear exactly
    because the screen found no catastrophic construction."""
    try:
        seq = _parser.parse(pattern, flags)
    except Exception:  # noqa: BLE001 — invalid regex: nothing to probe
        return []
    out: list[str] = []
    seen: set[str] = set()

    def add(s: str) -> None:
        if s and s not in seen and len(out) < cap:
            seen.add(s)
            out.append(s)

    runs = sorted((r for r in _harvest_runs(seq) if len(r) >= 2),
                  key=len, reverse=True)
    if runs:
        near_miss = runs[0][:-1]
        add(near_miss * max(1, pump))
    chars, _broad = _first_set(seq)
    printable = sorted(c for c in chars if 32 <= c < 127)
    if printable:
        add(chr(printable[0]) * max(1, pump * 4))
    if runs:
        add((runs[0] + "\x00") * max(1, pump // 2))
    if not out:
        add("a" * max(1, pump * 4))
    return out


def _harvest_runs(seq) -> list[str]:
    runs: list[str] = []
    _literal_runs(seq, runs, [])
    return runs
