"""Local CortexEncoder serve path: ``call_llm``-compatible callables backed
by the port's encoder on the card.

Counterpart of ``vainplex_openclaw_tpu/models/serve.py``. Every LLM seam in
the suite is a ``call_llm: str -> str``; the governance stage-3 validator
accepts one as ``GovernancePlugin(call_llm=...)``. :func:`make_local_call_llm`
builds one from the shipped triage encoder: continuous batching by default,
or the one-shot path behind ``continuousBatching: false``, kept as the
equivalence oracle.

This slice serves on one device. A serve config that asks for mesh serving,
another plan family or the model registry raises ``NotImplementedError``
rather than being ignored.
"""

from __future__ import annotations

import atexit
import threading
from typing import Callable, Optional

import torch

from ..config.loader import deep_merge
from ..device import DeviceLike, resolve_device
from ..resilience.admission import AdmissionController
from .batching import ContinuousBatcher, render_verdict
from .encoder import forward
from .pretrained import available, load_pretrained
from .tokenizer import encode_texts

# The JAX package's serve defaults, key for key, so one ``serve`` config
# section reads the same on both. The mesh, plan-family and registry keys
# must keep these values here (see _check_supported).
SERVE_DEFAULTS = {
    "continuousBatching": True,
    "maxBatch": 32,
    "windowMs": 2.0,
    # AdmissionController over the serve queue: every submit sheds past 4x
    # the watermark; between 1x and 4x only over-fair-share tenants shed.
    "admission": {"enabled": True, "highWatermark": 128},
    "meshServing": False,
    "meshShape": None,
    "meshAxes": ["dp", "tp"],
    "planFamily": "encoder_validator",
    "longContext": {"thresholdTokens": 1024},
    "modelRegistry": False,
    "searchedPlans": True,
}

# Markers from llm_validator.build_prompt — the MESSAGE body is embedded
# VERBATIM between them and may itself contain blank lines, so the section
# must be cut on the known next header, never on the first blank line
# (that would validate only the first paragraph: a stage-3 bypass).
_MESSAGE_START = "MESSAGE:\n"
_MESSAGE_END = "\n\nIdentify issues"


def _extract_message(prompt: str) -> str:
    if _MESSAGE_START not in prompt:
        return prompt.strip()
    body = prompt.split(_MESSAGE_START, 1)[1]
    if _MESSAGE_END in body:
        body = body.rsplit(_MESSAGE_END, 1)[0]
    return body.strip()


def _check_supported(scfg: dict) -> None:
    if scfg.get("meshServing"):
        raise NotImplementedError("serve.meshServing is not ported yet")
    if scfg.get("planFamily", "encoder_validator") != "encoder_validator":
        raise NotImplementedError(
            f"serve.planFamily {scfg['planFamily']!r} is not ported yet")
    reg = scfg.get("modelRegistry", False)
    if (isinstance(reg, dict) and reg.get("enabled", True)) or reg is True:
        raise NotImplementedError("serve.modelRegistry is not ported yet")


# One batcher per (checkpoint dir, device, knob tuple): every
# call_llm closure a process builds for the same serving config shares one
# queue — that IS the continuous-batching win — and the collector-thread
# count stays bounded.
_batchers: dict = {}
_batchers_lock = threading.Lock()


def shared_batcher(checkpoint_dir: Optional[str], serve_cfg: dict,
                   device: DeviceLike = None) -> ContinuousBatcher:
    dev = resolve_device(device)
    scfg = deep_merge(SERVE_DEFAULTS, serve_cfg or {})
    _check_supported(scfg)
    key = (checkpoint_dir, str(dev), scfg["maxBatch"],
           scfg["windowMs"],
           tuple(sorted((scfg.get("admission") or {}).items())))
    with _batchers_lock:
        batcher = _batchers.get(key)
        if batcher is None:
            batcher = ContinuousBatcher(
                checkpoint_dir, max_batch=scfg["maxBatch"],
                window_ms=scfg["windowMs"],
                admission=AdmissionController.from_config(
                    scfg.get("admission")),
                device=dev)
            _batchers[key] = batcher
        return batcher


def close_batchers() -> None:
    """Stop every shared collector thread."""
    with _batchers_lock:
        batchers = list(_batchers.values())
        _batchers.clear()
    for b in batchers:
        b.close()


# Collector threads are daemons, but one parked inside a device call during
# interpreter teardown can still hang the exit. Closing at atexit joins
# them while the runtime is intact; a second close is a no-op.
atexit.register(close_batchers)


def make_local_call_llm(checkpoint_dir: Optional[str] = None,
                        serve_cfg: Optional[dict] = None,
                        device: DeviceLike = None) -> Callable[[str], str]:
    """Build a ``call_llm`` seam served by the local triage encoder on
    ``device`` (default: the card; raises ``RuntimeError`` without one).

    ``serve_cfg`` (deep-merged over :data:`SERVE_DEFAULTS`) selects the
    path: continuous batching by default, through a process-shared
    :class:`~.batching.ContinuousBatcher` exposed as ``call.batcher``, or
    the one-shot path behind ``continuousBatching: false``."""
    dev = resolve_device(device)
    if not available(checkpoint_dir):
        # Fail LOUD at construction: a silent per-call "pass" would
        # override a fail_mode='closed' validator.
        raise RuntimeError(
            "local serve path refused: no trained checkpoint at "
            f"{checkpoint_dir or 'the shipped default'} — point call_llm "
            "at a real LLM or ship a checkpoint")
    scfg = deep_merge(SERVE_DEFAULTS, serve_cfg or {})
    _check_supported(scfg)
    if scfg.get("continuousBatching"):
        batcher = shared_batcher(checkpoint_dir, scfg, device=dev)

        def call(prompt: str) -> str:
            return batcher.submit(_extract_message(prompt))

        call.batcher = batcher
        return call

    def call(prompt: str) -> str:
        # load_pretrained memoizes per (directory, device).
        loaded = load_pretrained(checkpoint_dir, device=dev)
        if loaded is None:  # checkpoint vanished after construction
            raise RuntimeError("local serve: checkpoint no longer loadable")
        cfg, params = loaded
        tokens = encode_texts([_extract_message(prompt)], cfg.seq_len,
                              cfg.vocab_size)
        with torch.inference_mode():
            out = forward(params, torch.from_numpy(tokens).to(dev), cfg)
            severity = int(out["severity"].argmax(dim=-1)[0])
        return render_verdict(severity)

    return call
