"""Local CortexEncoder serve path: ``call_llm``-compatible callables backed
by the port's encoder on the card.

Counterpart of ``vainplex_openclaw_tpu/models/serve.py``. Every LLM seam in
the suite is a ``call_llm: str -> str``; the governance stage-3 validator
accepts one as ``GovernancePlugin(call_llm=...)``. :func:`make_local_call_llm`
builds one from the shipped triage encoder: continuous batching by default,
or the one-shot path behind ``continuousBatching: false``, kept as the
equivalence oracle.

``meshServing: true`` serves through the plan of ``planFamily`` over a
``meshAxes`` grid of ``meshShape``: the default Megatron
``encoder_validator`` over (dp, tp), ``encoder_validator_pp`` over
``["pp"]``, ``encoder_validator_moe`` over ``["dp", "ep"]`` and
``encoder_validator_long`` over ``["dp", "sp"]`` (rows at or above
``longContext.thresholdTokens`` real tokens routed to ring attention).
``meshShape: null`` takes every device of the type, cut as the searched
plan table's factorization row says, else by ``_factor`` (so ``(1, 1)``
over ``("dp", "tp")`` on one card). With ``searchedPlans`` (default true)
the plan resolves through the searched table (``parallel/plan.py``);
``false`` serves the hand-written rules. The
grid's devices follow ``device``: visible cards for CUDA, repeated ``cpu``
for the CPU. Without ``meshServing`` the plan family is not read and every
checkpoint serves single-device, as in the JAX package; an unknown family
under ``meshServing`` raises ``KeyError`` when the batcher is built.

``modelRegistry: true`` (or a dict of ``registry.REGISTRY_DEFAULTS`` keys)
serves from a :class:`~.registry.ModelRegistry` on the batcher's device,
with the construction checkpoint registered as the incumbent ``"v0"``:
``call.batcher.registry`` takes more versions, canaries and promotions,
and ``call.batcher.swap_to`` hot-swaps between them.

While a torch profiler records, the continuous seam gives each call a
request id (``stage_timer.new_id``), logs its ``extract``
(``_extract_message``) under that id and carries the id into the
batcher's ticket, whose ``queue`` and ``wake`` carry it too and name the
batch that served it.
"""

from __future__ import annotations

import atexit
import threading
import time
from typing import Callable, Optional

import torch

from ..config.loader import deep_merge
from ..device import DeviceLike, is_device_error, resolve_device
from ..parallel.mesh import _factor, available_devices, cached_mesh
from ..parallel.plan import preferred_mesh_shape, searched_plans_enabled
from ..resilience.admission import AdmissionController
from ..utils.stage_timer import SPANS, new_id, tracing
from .batching import ContinuousBatcher, render_verdict
from .encoder import forward
from .pretrained import available, load_pretrained
from .registry import ModelRegistry, registry_settings
from .tokenizer import encode_texts

# The JAX package's serve defaults, key for key, so one ``serve`` config
# section reads the same on both.
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


# One batcher per (scope, checkpoint dir, device, knob tuple): every
# call_llm closure a process builds for the same serving config shares one
# queue — that IS the continuous-batching win — and the collector-thread
# count stays bounded. ``scope`` partitions the book per owner (a fleet
# replica's ``<worker>:fleet:<rid>``), so retiring an owner closes ONLY
# its batchers, as in the JAX package.
_batchers: dict = {}
_batchers_lock = threading.Lock()


def _mesh_key(serve_cfg: dict):
    """Hashable mesh identity for the batcher registry: two mesh configs
    (shape, axes, plan family, threshold) never share a batcher. None when
    mesh serving is off."""
    if not serve_cfg.get("meshServing"):
        return None
    shape = serve_cfg.get("meshShape")
    return (tuple(int(s) for s in shape) if shape is not None else "auto",
            tuple(serve_cfg.get("meshAxes") or ("dp", "tp")),
            bool(serve_cfg.get("searchedPlans", True)),
            str(serve_cfg.get("planFamily", "encoder_validator")),
            int((serve_cfg.get("longContext") or {})
                .get("thresholdTokens", 1024)))


def _resolve_mesh(serve_cfg: dict, device: torch.device):
    """The Mesh for the serving config on ``device``'s type, or None when
    mesh serving is off. ``meshShape: null`` takes every device of the
    type: one axis whole; more axes take the searched factorization for
    that count (``plan.preferred_mesh_shape``, the ``nN`` row of the
    default family, whatever ``planFamily`` is, as in JAX) when searched
    plans are on and it has as many axes, else ``_factor``."""
    if not serve_cfg.get("meshServing"):
        return None
    axes = tuple(serve_cfg.get("meshAxes") or ("dp", "tp"))
    shape = serve_cfg.get("meshShape")
    if shape is None:
        n = len(available_devices(device))
        if len(axes) == 1:
            shape = (n,)
        else:
            pref = preferred_mesh_shape(n, device=device) \
                if serve_cfg.get("searchedPlans", True) \
                and searched_plans_enabled() else None
            shape = pref if pref is not None and len(pref) == len(axes) \
                else _factor(n) + (1,) * (len(axes) - 2)
    return cached_mesh(tuple(int(s) for s in shape), axes, device.type)


def _registry_key(serve_cfg: dict):
    """Hashable registry identity: a versioned batcher never shares a
    queue with an unversioned one. Scalar knobs only (the section is
    flat)."""
    raw = serve_cfg.get("modelRegistry", False)
    if isinstance(raw, dict):
        return tuple(sorted((k, v) for k, v in raw.items()
                            if not isinstance(v, dict)))
    return bool(raw)


def shared_batcher(checkpoint_dir: Optional[str], serve_cfg: dict,
                   scope: str = "global", registry=None,
                   device: DeviceLike = None) -> ContinuousBatcher:
    """The process-shared batcher of ``scope`` for ``serve_cfg``, built on
    first use. ``registry`` (a fleet's shared :class:`ModelRegistry`)
    serves every version decision of its owner; without one, an enabled
    ``modelRegistry`` section builds a registry named ``serve:<scope>``
    (the JAX package's name for it) on the batcher's device, with the
    checkpoint registered as ``"v0"``. A key ``serve_cfg`` gives is taken
    as given (``admission: None`` turns admission off, as a fleet's
    replicas need); a key it lacks takes :data:`SERVE_DEFAULTS`'s."""
    dev = resolve_device(device)
    scfg = {**SERVE_DEFAULTS, **(serve_cfg or {})}
    key = (scope, checkpoint_dir, str(dev), scfg["maxBatch"],
           scfg["windowMs"],
           tuple(sorted((scfg.get("admission") or {}).items())),
           _mesh_key(scfg), _registry_key(scfg))
    with _batchers_lock:
        batcher = _batchers.get(key)
        if batcher is None:
            mesh = _resolve_mesh(scfg, dev)
            if registry is None:
                rcfg = registry_settings(scfg.get("modelRegistry", False))
                if rcfg["enabled"]:
                    registry = ModelRegistry(
                        rcfg, name=f"serve:{scope}",
                        device=mesh.devices[0] if mesh is not None else dev)
                    registry.register("v0", checkpoint_dir)
            batcher = ContinuousBatcher(
                checkpoint_dir, max_batch=scfg["maxBatch"],
                window_ms=scfg["windowMs"],
                admission=AdmissionController.from_config(
                    scfg.get("admission")),
                device=dev, mesh=mesh,
                plan_family=scfg.get("planFamily", "encoder_validator"),
                searched_plans=scfg.get("searchedPlans", True),
                long_threshold=(scfg.get("longContext") or {})
                .get("thresholdTokens", 1024),
                registry=registry)
            _batchers[key] = batcher
        return batcher


def close_batchers(scope: Optional[str] = None, drain: bool = False) -> None:
    """Stop shared collector threads. ``scope=None`` closes every batcher
    (tests, process teardown); a scope closes only that owner's, the
    replica-retirement path. ``drain=True`` serves what is still queued
    before closing, so a planned retirement strands no accepted request;
    a crash path keeps ``drain=False`` and lets fleet redelivery re-route
    the queue. A drain that fails with an error of the device
    (``device.is_device_error``) is raised once every batcher is closed;
    any other drain error is passed over, as in the JAX package."""
    with _batchers_lock:
        if scope is None:
            items = list(_batchers.items())
            _batchers.clear()
        else:
            items = [(k, v) for k, v in _batchers.items() if k[0] == scope]
            for k, _ in items:
                del _batchers[k]
    device_error = None
    for _, b in items:
        if drain:
            try:
                b.drain()
            except Exception as exc:  # noqa: BLE001 — teardown must reach close()
                if device_error is None and is_device_error(exc):
                    device_error = exc
        b.close()
    if device_error is not None:
        raise device_error


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
    if scfg.get("continuousBatching"):
        batcher = shared_batcher(checkpoint_dir, scfg, device=dev)

        def call(prompt: str) -> str:
            if not tracing():
                return batcher.submit(_extract_message(prompt))
            rid, t0 = new_id(), time.perf_counter()
            text = _extract_message(prompt)
            SPANS.add("extract", t0, time.perf_counter(), rid, None, 1)
            return batcher.submit(text, rid=rid)

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
