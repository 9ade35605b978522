"""Stage-2 classification of trace-analyzer findings: on-device triage,
then deep analysis.

Counterpart of ``local_triage``, ``SEVERITY_RANK`` and ``classify_findings``
(with ``ClassifiedFinding``, the prompts and ``ACTION_TYPES``) in
``vainplex_openclaw_tpu/cortex/trace_analyzer/classifier.py``. The
encoder's keep head scores each finding's text in one batch, padded to a
power of two; the rule floor keeps every finding whose rule severity
reaches ``min_severity``, whatever the model says. A finding is
duck-typed: it needs ``.signal``, ``.summary``, ``.evidence`` and
``.severity`` (``.chain_id`` for the deep step, ``.to_dict()`` for
``ClassifiedFinding.to_dict``), as the JAX ``FailureSignal`` has them; a
chain needs ``.id``, ``.agent``, ``.session`` and ``.events``.

With no checkpoint the JAX function falls back to random weights from
``PRNGKey(7)``; so does the port, through the numpy copy of JAX's key
derivation (``models.encoder.init_params_from_seed``), so its decisions
match JAX's with or without a checkpoint.

One deliberate deviation: JAX's ``classify_findings`` catches any
exception from ``local_triage`` and falls back to rule severity. Here it
propagates, since that catch would hide a missing card or a kernel that
did not build or launch. The per-finding catches around the LLM callables
are JAX's.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from ...device import DeviceLike, resolve_device
from ...models.encoder import EncoderConfig, forward, \
    init_params_from_seed, params_from_numpy
from ...models.pretrained import load_pretrained
from ...models.tokenizer import encode_texts
from ...ops.similarity import pad_rows, pow2_bucket
from ...utils.llm_json import parse_llm_json
from ...utils.stage_timer import new_id, span
from .redactor import redact_chain, redact_text

ACTION_TYPES = ("soul_rule", "governance_policy", "cortex_pattern",
                "manual_review")

KNOWN_FALSE_POSITIVES = (
    "user said no to a yes/no question",
    "test environment failure",
    "user changed their mind (not a correction)",
)

SEVERITY_RANK = {"info": 0, "low": 1, "medium": 2, "high": 3, "critical": 4}


@dataclass
class ClassifiedFinding:
    signal: object            # the finding (a FailureSignal)
    kept: bool
    severity: str
    root_cause: str = ""
    action_type: str = "manual_review"
    action_text: str = ""
    confidence: float = 0.0
    fact_correction: Optional[dict] = None

    def to_dict(self) -> dict:
        return {**self.signal.to_dict(), "kept": self.kept,
                "severity": self.severity, "rootCause": self.root_cause,
                "actionType": self.action_type,
                "actionText": self.action_text,
                "confidence": self.confidence,
                "factCorrection": self.fact_correction}


def format_chain_as_transcript(chain) -> str:
    redacted = redact_chain(chain)
    lines = []
    for e in redacted["events"]:
        if e["type"] in ("msg.in", "msg.out"):
            who = "USER" if e["type"] == "msg.in" else "AGENT"
            lines.append(f"[{who}] {e['content']}")
        elif e["type"] == "tool.call":
            lines.append(f"[TOOL CALL] {e['tool_name']}")
        elif e["type"] == "tool.result":
            status = f"ERROR: {e['tool_error']}" if e["tool_error"] else "ok"
            lines.append(f"[TOOL RESULT] {e['tool_name']}: {status}")
    return "\n".join(lines)


def triage_prompt(finding) -> str:
    fps = "\n".join(f"- {fp}" for fp in KNOWN_FALSE_POSITIVES)
    return (
        "You triage agent-failure findings. Known false positives:\n"
        f"{fps}\n\n"
        f"FINDING: {finding.signal} ({finding.severity})\n"
        f"{finding.summary}\nEvidence: {json.dumps(finding.evidence)}\n\n"
        'Respond ONLY JSON: {"keep": bool, "severity": '
        '"info"|"low"|"medium"|"high"|"critical"}'
    )


def deep_prompt(finding, chain) -> str:
    transcript = format_chain_as_transcript(chain) if chain is not None \
        else ""
    return (
        "You analyze a confirmed agent failure. Produce a root cause and one "
        "corrective action.\n\n"
        f"FINDING: {finding.signal}: {finding.summary}\n"
        f"TRANSCRIPT:\n{redact_text(transcript)[:4000]}\n\n"
        'Respond ONLY JSON: {"rootCause": str, "actionType": "soul_rule"|'
        '"governance_policy"|"cortex_pattern"|"manual_review", '
        '"actionText": str, "confidence": 0.0-1.0, "factCorrection": '
        '{"subject": str, "predicate": str, "value": str} | null}'
    )


def finding_text(finding) -> str:
    """The text the keep head scores: signal, summary and evidence."""
    return (f"{finding.signal} {finding.summary} "
            f"{' '.join(map(str, finding.evidence))}")


def keep_logits(findings: list, checkpoint_dir: Optional[str] = None,
                device: DeviceLike = None) -> torch.Tensor:
    """The keep head's logits ``[len(findings), 2]``, computed on ``device``
    (default: the card) and returned in fp32 on the CPU.

    While a torch profiler records, the call is the span ``keep_logits``
    (a fresh call id, ``n`` the findings) and its parts are spans of the
    same id: ``load`` (device and weights), ``tokenize`` (finding text and
    ``encode_texts``), ``pad``, ``launch`` (tokens to the device and
    ``forward`` returning) and ``sync`` (the ``.cpu()`` that waits for the
    card), one after another; see ``utils/stage_timer.py``."""
    cid, n = new_id(), len(findings)
    # the parts follow one another with no gap (``Span.then``) and carry
    # the thread's CPU seconds; the call's own is theirs summed
    with span("keep_logits", cid, None, n, cpu=False):
        part = span("load", cid, None, n)
        try:
            dev = resolve_device(device)
            loaded = load_pretrained(checkpoint_dir, device=dev)
            if loaded is None:
                cfg = EncoderConfig()
                params = params_from_numpy(init_params_from_seed(cfg, 7),
                                           cfg, dev)
            else:
                cfg, params = loaded
            part = part.then("tokenize")
            tokens = encode_texts([finding_text(f) for f in findings],
                                  cfg.seq_len, cfg.vocab_size)
            part = part.then("pad")
            # zero-token pad rows pool to nothing and are sliced away below
            padded = pad_rows(tokens, pow2_bucket(n))
            with torch.inference_mode():
                part = part.then("launch")
                out = forward(params, torch.from_numpy(padded).to(dev), cfg)
                part = part.then("sync")
                return out["keep"][:n].float().cpu()
        finally:
            part.end()


def local_triage(findings: list, min_severity: str = "medium",
                 checkpoint_dir: Optional[str] = None,
                 device: DeviceLike = None) -> list:
    """Keep (True) or drop (False) each finding, on ``device`` (default:
    the card). The trained keep head prunes noise findings; a finding whose
    rule severity reaches ``min_severity`` is always kept."""
    if not findings:
        return []
    keep = keep_logits(findings, checkpoint_dir, device).argmax(dim=-1)
    floor = SEVERITY_RANK[min_severity]
    return [bool(k) or SEVERITY_RANK.get(f.severity, 2) >= floor
            for k, f in zip(keep.tolist(), findings)]


def classify_findings(findings: list, chains_by_id: dict,
                      triage_llm: Optional[Callable[[str], str]] = None,
                      deep_llm: Optional[Callable[[str], str]] = None,
                      logger=None, use_local_triage: bool = False,
                      device: DeviceLike = None) -> list:
    """Triage (keep? severity?) then deep analysis per kept finding. With
    no LLMs configured, findings pass through as manual_review at rule
    severity. ``use_local_triage`` keeps or drops each finding by
    :func:`local_triage` on ``device`` (default: the card) where no triage
    LLM is given; an exception there propagates (module docstring)."""
    out: list = []

    local_keep = None
    if use_local_triage and findings:
        local_keep = local_triage(findings, device=device)

    for idx, finding in enumerate(findings):
        kept, severity = True, finding.severity
        if triage_llm is not None:
            try:
                parsed = parse_llm_json(triage_llm(triage_prompt(finding)))
                if parsed is not None:
                    kept = bool(parsed.get("keep", True))
                    severity = parsed.get("severity") or severity
            except Exception as exc:  # noqa: BLE001
                if logger is not None:
                    logger.warn(f"triage failed for {finding.signal}: {exc}")
        elif local_keep is not None:
            kept = local_keep[idx]

        cf = ClassifiedFinding(finding, kept, severity)
        if kept and deep_llm is not None:
            try:
                parsed = parse_llm_json(deep_llm(deep_prompt(
                    finding, chains_by_id.get(finding.chain_id))))
                if parsed is not None:
                    cf.root_cause = str(parsed.get("rootCause") or "")
                    at = parsed.get("actionType")
                    cf.action_type = at if at in ACTION_TYPES \
                        else "manual_review"
                    cf.action_text = str(parsed.get("actionText") or "")
                    try:
                        cf.confidence = max(0.0, min(1.0, float(
                            parsed.get("confidence", 0))))
                    except (TypeError, ValueError):
                        cf.confidence = 0.0
                    fc = parsed.get("factCorrection")
                    if isinstance(fc, dict) and all(
                            k in fc for k in ("subject", "predicate",
                                              "value")):
                        cf.fact_correction = fc
            except Exception as exc:  # noqa: BLE001
                if logger is not None:
                    logger.warn(
                        f"deep analysis failed for {finding.signal}: {exc}")
        out.append(cf)
    return out
