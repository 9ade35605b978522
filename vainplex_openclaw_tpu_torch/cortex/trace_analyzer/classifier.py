"""On-device triage of trace-analyzer findings.

Counterpart of ``local_triage`` and ``SEVERITY_RANK`` in
``vainplex_openclaw_tpu/cortex/trace_analyzer/classifier.py``. The
encoder's keep head scores each finding's text in one batch, padded to a
power of two; the rule floor keeps every finding whose rule severity
reaches ``min_severity``, whatever the model says. A finding is
duck-typed: it needs ``.signal``, ``.summary``, ``.evidence`` and
``.severity``, as the JAX ``FailureSignal`` has them.

With no checkpoint the JAX function falls back to random weights from
``PRNGKey(7)``; the port cannot draw those, so it falls back to its own
seeded init (``torch.Generator`` seed 7), and decisions match JAX's only
with a checkpoint.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...device import DeviceLike, resolve_device
from ...models.encoder import EncoderConfig, forward, init_params, \
    params_from_numpy
from ...models.pretrained import load_pretrained
from ...models.tokenizer import encode_texts
from ...ops.similarity import pad_rows, pow2_bucket

SEVERITY_RANK = {"info": 0, "low": 1, "medium": 2, "high": 3, "critical": 4}


def finding_text(finding) -> str:
    """The text the keep head scores: signal, summary and evidence."""
    return (f"{finding.signal} {finding.summary} "
            f"{' '.join(map(str, finding.evidence))}")


def keep_logits(findings: list, checkpoint_dir: Optional[str] = None,
                device: DeviceLike = None) -> torch.Tensor:
    """The keep head's logits ``[len(findings), 2]``, computed on ``device``
    (default: the card) and returned in fp32 on the CPU."""
    dev = resolve_device(device)
    loaded = load_pretrained(checkpoint_dir, device=dev)
    if loaded is None:
        cfg = EncoderConfig()
        params = params_from_numpy(
            init_params(cfg, torch.Generator().manual_seed(7)), cfg, dev)
    else:
        cfg, params = loaded
    tokens = encode_texts([finding_text(f) for f in findings], cfg.seq_len,
                          cfg.vocab_size)
    # zero-token pad rows pool to nothing and are sliced away below
    padded = pad_rows(tokens, pow2_bucket(len(findings)))
    with torch.inference_mode():
        out = forward(params, torch.from_numpy(padded).to(dev), cfg)
        return out["keep"][:len(findings)].float().cpu()


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
