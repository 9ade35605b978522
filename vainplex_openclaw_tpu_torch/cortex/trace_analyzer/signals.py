"""The 7 failure-signal detectors + registry: the port's copy of
``vainplex_openclaw_tpu/cortex/trace_analyzer/signals.py``.

Signals: SIG-CORRECTION, SIG-DISSATISFIED, SIG-HALLUCINATION,
SIG-UNVERIFIED-CLAIM, SIG-TOOL-FAIL, SIG-DOOM-LOOP, SIG-REPEAT-FAIL.

Every detector takes ``device``, which only the two that read consecutive
similarities use: a window of at least ``BATCH_SIMILARITY_MIN`` ASCII
command pairs goes through the port's ``batch_levenshtein_ratio``, kernel
K3 on a CUDA device. ``detect_all_signals`` keeps the per-detector
try/except, with one narrowing: an error that comes from the device
(``device.is_device_error``) propagates, where the JAX package would log
it and drop the detector's signals for that chain.
"""

from __future__ import annotations

import hashlib
import re
from dataclasses import dataclass, field
from typing import Callable, Optional

from ...device import DeviceLike, is_device_error, resolve_device
from ...ops.similarity import (LEVENSHTEIN_CAP, batch_levenshtein_ratio,
                               jaccard_similarity, levenshtein_ratio)
from .chains import ConversationChain
from .signal_patterns import CompiledSignalPatterns

SIMILARITY_THRESHOLD = 0.8
DOOM_LOOP_MIN = 3
DOOM_LOOP_CRITICAL = 5
# Windows with at least this many ASCII command pairs route consecutive-pair
# similarity through the batched Levenshtein program (K3 on the card)
# instead of N scalar Python calls.
BATCH_SIMILARITY_MIN = 32

_QUESTION_RE = re.compile(r"\?\s*$")


def truncate(text: str, n: int = 200) -> str:
    text = text or ""
    return text[:n] + ("…" if len(text) > n else "")


def is_question(text: str) -> bool:
    return bool(_QUESTION_RE.search((text or "").strip()))


@dataclass(slots=True)
class FailureSignal:
    signal: str
    severity: str  # info | low | medium | high | critical
    chain_id: str
    agent: str
    session: str
    ts: float
    summary: str
    evidence: list = field(default_factory=list)
    extra: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"signal": self.signal, "severity": self.severity,
                "chain_id": self.chain_id, "agent": self.agent,
                "session": self.session, "ts": self.ts, "summary": self.summary,
                "evidence": self.evidence, "extra": self.extra}


def _sig(chain: ConversationChain, signal: str, severity: str, ts: float,
         summary: str, evidence: list, **extra) -> FailureSignal:
    return FailureSignal(signal=signal, severity=severity, chain_id=chain.id,
                         agent=chain.agent, session=chain.session, ts=ts,
                         summary=summary, evidence=evidence, extra=extra)


# ── SIG-CORRECTION ───────────────────────────────────────────────────


def detect_corrections(chain: ConversationChain,
                       patterns: CompiledSignalPatterns, state=None,
                       device: DeviceLike = None) -> list[FailureSignal]:
    """msg.out (assertion) → msg.in (correction). Exclusion: the agent asked
    a question and got a short negative — that's an answer, not a correction."""
    out = []
    events = chain.events
    for i in range(1, len(events)):
        prev, curr = events[i - 1], events[i]
        if prev.type != "msg.out" or curr.type != "msg.in":
            continue
        agent_text = prev.payload.get("content") or ""
        user_text = curr.payload.get("content") or ""
        if not user_text:
            continue
        if not any(rx.search(user_text) for rx in patterns.correction):
            continue
        if is_question(agent_text) and any(rx.search(user_text)
                                           for rx in patterns.short_negatives):
            continue
        out.append(_sig(chain, "SIG-CORRECTION", "medium", curr.ts,
                        f"User corrected the agent: {truncate(user_text, 120)}",
                        [truncate(agent_text), truncate(user_text)]))
    return out


# ── SIG-DISSATISFIED ─────────────────────────────────────────────────


def detect_dissatisfied(chain: ConversationChain,
                        patterns: CompiledSignalPatterns, state=None,
                        device: DeviceLike = None) -> list[FailureSignal]:
    """Last user message near chain end expresses dissatisfaction with no
    resolution afterwards (satisfaction phrasing overrides)."""
    events = chain.events
    last_user = next((i for i in range(len(events) - 1, -1, -1)
                      if events[i].type == "msg.in"), -1)
    if last_user < 0 or last_user < len(events) - 3:
        return []
    text = events[last_user].payload.get("content") or ""
    if any(rx.search(text) for rx in patterns.satisfaction_overrides):
        return []
    if not any(rx.search(text) for rx in patterns.dissatisfaction):
        return []
    for j in range(last_user + 1, len(events)):
        if events[j].type == "msg.out":
            response = events[j].payload.get("content") or ""
            if any(rx.search(response) for rx in patterns.resolution):
                return []
    return [_sig(chain, "SIG-DISSATISFIED", "high", events[last_user].ts,
                 f"Session ended dissatisfied: {truncate(text, 120)}",
                 [truncate(text)])]


# ── SIG-HALLUCINATION ────────────────────────────────────────────────


def _last_tool_result_in_turn(events, msg_out_idx: int) -> int:
    for j in range(msg_out_idx - 1, -1, -1):
        if events[j].type == "tool.result":
            return j
        if events[j].type == "msg.in":
            break
    return -1


def _completion_claim_indices(chain: ConversationChain,
                              patterns: CompiledSignalPatterns) -> list[int]:
    """Indices of msg.out events matching a completion-claim pattern.
    Cached on the chain like ``_tool_attempts``: two detectors
    (hallucination, unverified-claim) sweep the same events with the same
    pattern set, and the duplicated regex pass was a measurable slice of
    the signals stage. Assumes one pattern set per run (the analyzer's
    chains are rebuilt every run)."""
    cached = getattr(chain, "_completion_claims", None)
    if cached is not None:
        return cached
    hits = [i for i, event in enumerate(chain.events)
            if event.type == "msg.out"
            and any(rx.search(event.payload.get("content") or "")
                    for rx in patterns.completion_claims)]
    chain._completion_claims = hits
    return hits


def detect_hallucinations(chain: ConversationChain,
                          patterns: CompiledSignalPatterns, state=None,
                          device: DeviceLike = None) -> list[FailureSignal]:
    """Agent claims completion while the last tool result in the same turn
    errored — the claim contradicts its own evidence. Critical."""
    out = []
    events = chain.events
    for i in _completion_claim_indices(chain, patterns):
        event = events[i]
        content = event.payload.get("content") or ""
        tr = _last_tool_result_in_turn(events, i)
        if tr < 0 or not events[tr].payload.get("tool_is_error"):
            continue
        out.append(_sig(chain, "SIG-HALLUCINATION", "critical", event.ts,
                        f"Completion claim after failed tool "
                        f"{events[tr].payload.get('tool_name')}: {truncate(content, 120)}",
                        [truncate(str(events[tr].payload.get('tool_error'))),
                         truncate(content)],
                        tool_name=events[tr].payload.get("tool_name")))
    return out


# ── SIG-UNVERIFIED-CLAIM ─────────────────────────────────────────────


def detect_unverified_claims(chain: ConversationChain,
                             patterns: CompiledSignalPatterns, state=None,
                             device: DeviceLike = None) -> list[FailureSignal]:
    """Completion claim in a turn with NO tool activity at all — asserted
    work without any evidence trail."""
    out = []
    events = chain.events
    for i in _completion_claim_indices(chain, patterns):
        event = events[i]
        content = event.payload.get("content") or ""
        saw_tool = False
        for j in range(i - 1, -1, -1):
            if events[j].type in ("tool.call", "tool.result"):
                saw_tool = True
                break
            if events[j].type == "msg.in":
                break
        if saw_tool:
            continue
        out.append(_sig(chain, "SIG-UNVERIFIED-CLAIM", "medium", event.ts,
                        f"Completion claim without tool evidence: {truncate(content, 120)}",
                        [truncate(content)]))
    return out


# ── SIG-TOOL-FAIL ────────────────────────────────────────────────────


def _tool_attempts(chain: ConversationChain) -> list[dict]:
    """Pair tool.call with its following tool.result. Cached on the chain —
    three detectors (tool-fail, doom-loop, repeat-fail) share the pairing."""
    cached = getattr(chain, "_tool_attempts", None)
    if cached is not None:
        return cached
    attempts = []
    events = chain.events
    n = len(events)
    for i, event in enumerate(events):
        if event.type != "tool.call":
            continue
        result = None
        for j in range(i + 1, min(i + 4, n)):
            e = events[j]
            if (e.type == "tool.result"
                    and e.payload.get("tool_name") == event.payload.get("tool_name")):
                result = e
                break
        attempts.append({
            "ts": event.ts,
            "tool": event.payload.get("tool_name") or "?",
            "params": event.payload.get("tool_params") or {},
            "error": (result.payload.get("tool_error") if result else None),
            "is_error": bool(result and result.payload.get("tool_is_error")),
        })
    chain._tool_attempts = attempts
    return attempts


def _consecutive_similarities(chain, attempts: list[dict],
                              device: DeviceLike = None) -> list:
    """``sims[i]`` = similarity(attempts[i], attempts[i+1]) for every
    consecutive ERROR→ERROR same-tool pair — the ONLY pairs the detectors
    below ever read; all other slots stay 0.0 and healthy chains cost
    ~zero. Cached on the chain.

    At least BATCH_SIMILARITY_MIN ASCII command pairs take the batched
    Levenshtein program on ``device`` (K3 on the card), the pair list
    padded to a power of two; fewer take the scalar DP. Jaccard pairs
    always use the exact scalar set computation: the hashed approximation
    could flip a near-threshold verdict on bin collisions. The routing is
    the JAX package's, so the verdicts are its, pair for pair."""
    cached = getattr(chain, "_pair_sims", None)
    if cached is not None:
        return cached
    n = len(attempts) - 1
    sims = [0.0] * max(n, 0)
    relevant = [i for i in range(n)
                if attempts[i]["is_error"] and attempts[i + 1]["is_error"]
                and attempts[i]["tool"] == attempts[i + 1]["tool"]]
    if not relevant:
        chain._pair_sims = sims
        return sims

    def cmd(i: int) -> str:
        p = attempts[i]["params"] or {}
        c = p.get("command")
        return c if isinstance(c, str) else ""

    # The batched DP kernel is BYTE-level; the scalar reference path is
    # CHAR-level. They agree exactly only on ASCII, so non-ASCII command
    # pairs keep the scalar path (rare in exec commands, and parity with
    # the small-window verdicts must hold bit-for-bit).
    lev_idx, scalar_lev_idx, jac_idx = [], [], []
    for i in relevant:
        a, b = cmd(i), cmd(i + 1)
        if a and b:
            if a[:LEVENSHTEIN_CAP].isascii() and b[:LEVENSHTEIN_CAP].isascii():
                lev_idx.append(i)
            else:
                scalar_lev_idx.append(i)
        else:
            jac_idx.append(i)

    if len(lev_idx) >= BATCH_SIMILARITY_MIN:
        # the pair list padded to a power of two, as the JAX package pads
        # it; length ≥ the scalar 500-char cap
        pairs = [(cmd(i), cmd(i + 1)) for i in lev_idx]
        bucket = 1 << max(len(pairs) - 1, 0).bit_length()
        pairs += [("", "")] * (bucket - len(pairs))
        ratios = batch_levenshtein_ratio(pairs, length=LEVENSHTEIN_CAP + 12,
                                         device=device)
        for j, i in enumerate(lev_idx):
            sims[i] = float(ratios[j])
    else:
        scalar_lev_idx = lev_idx + scalar_lev_idx
    for i in scalar_lev_idx:
        sims[i] = levenshtein_ratio(cmd(i), cmd(i + 1))
    for i in jac_idx:
        sims[i] = jaccard_similarity(attempts[i]["params"] or {},
                                     attempts[i + 1]["params"] or {})
    chain._pair_sims = sims
    return sims


def detect_tool_failures(chain: ConversationChain,
                         patterns: CompiledSignalPatterns, state=None,
                         device: DeviceLike = None) -> list[FailureSignal]:
    """A failing call retried with basically-the-same params and failing
    again — no recovery behavior."""
    out = []
    attempts = _tool_attempts(chain)
    sims = _consecutive_similarities(chain, attempts, device)
    for i in range(1, len(attempts)):
        a, b = attempts[i - 1], attempts[i]
        if not (a["is_error"] and b["is_error"] and a["tool"] == b["tool"]):
            continue
        if sims[i - 1] >= SIMILARITY_THRESHOLD:
            out.append(_sig(chain, "SIG-TOOL-FAIL", "medium", b["ts"],
                            f"Repeated identical failure of {b['tool']}: "
                            f"{truncate(str(b['error']), 100)}",
                            [truncate(str(a["error"])), truncate(str(b["error"]))],
                            tool_name=b["tool"]))
    return out


# ── SIG-DOOM-LOOP ────────────────────────────────────────────────────


def detect_doom_loops(chain: ConversationChain,
                      patterns: CompiledSignalPatterns, state=None,
                      device: DeviceLike = None) -> list[FailureSignal]:
    """3+ consecutive similar failing calls of one tool (similarity ≥ 0.8 —
    Levenshtein on exec commands, Jaccard on params); ≥5 escalates to
    critical (doom-loop.ts:142-201)."""
    out = []
    attempts = _tool_attempts(chain)
    sims = _consecutive_similarities(chain, attempts, device)
    i = 0
    while i < len(attempts):
        anchor = attempts[i]
        if not anchor["is_error"]:
            i += 1
            continue
        run = [anchor]
        j = i + 1
        while j < len(attempts):
            cand = attempts[j]
            if not cand["is_error"] or cand["tool"] != anchor["tool"]:
                break
            # run[-1] is always attempts[j-1], so the consecutive-pair
            # similarity vector covers every comparison this loop makes.
            if sims[j - 1] < SIMILARITY_THRESHOLD:
                break
            run.append(cand)
            j += 1
        if len(run) >= DOOM_LOOP_MIN:
            severity = "critical" if len(run) >= DOOM_LOOP_CRITICAL else "high"
            out.append(_sig(chain, "SIG-DOOM-LOOP", severity, run[-1]["ts"],
                            f"{len(run)} consecutive similar failing calls of "
                            f"{anchor['tool']}",
                            [truncate(str(a["error"]), 100) for a in run[:3]],
                            tool_name=anchor["tool"], loop_length=len(run)))
        i = j if j > i + 1 else i + 1
    return out


# ── SIG-REPEAT-FAIL (cross-chain) ────────────────────────────────────


_SIGNATURE_CACHE: dict = {}
_SIGNATURE_CACHE_CAP = 8192


def failure_signature(tool: str, error: str) -> str:
    # Memoized: persistent failures repeat the same (tool, error) text by
    # definition, so the regex + sha256 amortize to one dict hit.
    key = (tool, (error or "")[:200])
    hit = _SIGNATURE_CACHE.get(key)
    if hit is None:
        normalized = re.sub(r"\d+", "N", key[1].lower())
        hit = hashlib.sha256(f"{tool}:{normalized}".encode()).hexdigest()[:16]
        if len(_SIGNATURE_CACHE) >= _SIGNATURE_CACHE_CAP:
            _SIGNATURE_CACHE.clear()
        _SIGNATURE_CACHE[key] = hit
    return hit


def detect_repeat_failures(chain: ConversationChain,
                           patterns: CompiledSignalPatterns,
                           state: Optional[dict] = None,
                           device: DeviceLike = None) -> list[FailureSignal]:
    """Same (tool, normalized error) signature appearing across ≥2 distinct
    chains — a persistent failure the agent keeps re-hitting. Needs the
    cross-chain ``state`` dict threaded by the registry."""
    if state is None:
        return []
    seen: dict = state.setdefault("repeat_fail_signatures", {})
    out = []
    for attempt in _tool_attempts(chain):
        if not attempt["is_error"]:
            continue
        sig = failure_signature(attempt["tool"], str(attempt["error"]))
        entry = seen.setdefault(sig, {"chains": set(), "tool": attempt["tool"],
                                      "error": str(attempt["error"]), "reported": False})
        entry["chains"].add(chain.id)
        if len(entry["chains"]) >= 2 and not entry["reported"]:
            entry["reported"] = True
            out.append(_sig(chain, "SIG-REPEAT-FAIL", "high", attempt["ts"],
                            f"Failure recurs across {len(entry['chains'])} chains: "
                            f"{attempt['tool']}: {truncate(entry['error'], 100)}",
                            [truncate(entry["error"])],
                            tool_name=attempt["tool"], signature=sig))
    return out


# ── registry ─────────────────────────────────────────────────────────

DETECTOR_REGISTRY: dict[str, Callable] = {
    "SIG-CORRECTION": detect_corrections,
    "SIG-DISSATISFIED": detect_dissatisfied,
    "SIG-HALLUCINATION": detect_hallucinations,
    "SIG-UNVERIFIED-CLAIM": detect_unverified_claims,
    "SIG-TOOL-FAIL": detect_tool_failures,
    "SIG-DOOM-LOOP": detect_doom_loops,
    "SIG-REPEAT-FAIL": detect_repeat_failures,
}


def detect_all_signals(chains: list[ConversationChain],
                       patterns: CompiledSignalPatterns,
                       config: Optional[dict] = None,
                       logger=None,
                       device: DeviceLike = None) -> list[FailureSignal]:
    """Run enabled detectors over every chain; per-detector try/catch (a
    device error propagates); per-signal severity overrides from config.
    ``device`` (default: the card) is where batched similarities run."""
    dev = resolve_device(device)
    config = config or {}
    state: dict = {}
    signals: list[FailureSignal] = []
    # Resolve enable/override config ONCE, not per (chain, detector): the
    # registry loop runs chains × detectors times.
    active = []
    for name, detector in DETECTOR_REGISTRY.items():
        sig_cfg = config.get(name, {})
        if sig_cfg.get("enabled", True) is False:
            continue
        active.append((name, detector, sig_cfg.get("severity")))
    for chain in chains:
        for name, detector, override in active:
            try:
                found = detector(chain, patterns, state, device=dev)
            except Exception as exc:  # noqa: BLE001 — one bad detector must not kill the run
                if is_device_error(exc):
                    raise
                if logger is not None:
                    logger.error(f"detector {name} failed on chain {chain.id}: {exc}")
                continue
            for s in found:
                if override:
                    s.severity = override
                signals.append(s)
    signals.sort(key=lambda s: s.ts)
    return signals
