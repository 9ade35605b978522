"""Versioned model registry: hot weight swap, canary and promotion, and LRU
weight paging behind the continuous batcher, on the card.

Counterpart of ``vainplex_openclaw_tpu/models/registry.py``, under the same
names. Three shapes applied to weights:

- **Hot swap** is drain → place → resume
  (:meth:`~.batching.ContinuousBatcher.swap_to`). Nothing is torn down or
  rebuilt: two versions of one architecture run the same kernels, already
  built; only the placed parameter tree changes
  (``ops._build.builds`` is the witness: it does not move through a swap).
- **Promotion** gates a candidate against the incumbent-as-oracle: zero
  verdict regressions on shadow replay of recent traffic AND a
  pinned-bench win (candidate p50 <= incumbent p50 × ``benchFactor``).
  Each bench round times the two versions in turns, :data:`BENCH_REPEATS`
  times, and keeps each side's least time: the steady-state cost of a
  replay. The JAX registry times one replay of each side a round, and on
  a loaded host one preempted replay can refuse a twin at a factor of 4.
  Canary fractions split traffic by a counter, so reruns are identical;
  rollback is the same swap in reverse (:meth:`rollback_target`).
- **Weight paging**: past ``maxResidentVersions`` the least recently used
  version's *device* tree is dropped (its placement-cache entries with
  it, ``plan.drop_sharded_params``) while the host tree stays cached in
  pinned memory, so a wake is one host-to-device copy, timed until the
  card has it and counted by the port's
  :class:`~..storage.lifecycle.LifecycleManager`.

Where the JAX registry holds a numpy host tree, this one holds CPU tensors
in the checkpoint's dtypes (numpy has no bf16), one copy per version, so
two versions registered from one directory never share identity.
``ModelRegistry(device=None)`` places on the card and raises without one,
like every entry point of the port; ``device="cpu"`` keeps the placed tree
on the host (a wake there copies nothing).

``serve.modelRegistry`` (default off) turns it on for the serve seam.
Registries book themselves by name (:func:`all_registries`) for the ops
plane, in-process and I/O-free.
"""

from __future__ import annotations

import math
import os
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from ..device import DeviceLike, resolve_device
from ..ops.similarity import pad_rows, pow2_bucket
from ..parallel.plan import drop_sharded_params, map_tree
from ..storage.lifecycle import LifecycleManager
from .batching import render_verdict
from .encoder import forward
from .pretrained import DEFAULT_DIR, load_pretrained
from .tokenizer import encode_texts

# The JAX package's registry knobs, key for key, resolved from the
# ``serve.modelRegistry`` section (bool or dict) by :func:`registry_settings`.
REGISTRY_DEFAULTS = {
    "enabled": False,
    # LRU weight paging: resident placed (device) trees beyond this are
    # evicted coldest-first; host trees always stay cached, so a wake is a
    # host-to-device copy, never a disk restore.
    "maxResidentVersions": 4,
    # Share of unpinned traffic routed to the canary version: resolution n
    # serves the canary iff floor(n·f) advanced, so reruns are identical.
    "canaryFraction": 0.0,
    # Recent served texts kept for shadow replay (the promotion gate's
    # verdict-regression input). 0 disables the ring.
    "shadowWindow": 64,
    # Pinned-bench leg of the promotion gate: candidate p50 over the
    # shadow ring must be <= incumbent p50 × benchFactor.
    "benchFactor": 1.25,
    "benchRounds": 3,
}


# Replays of each version a bench round, in turns; a round's time is each
# side's least. Noise only adds time, so the least is the steady state.
BENCH_REPEATS = 5


def registry_settings(raw, default_enabled: bool = False) -> dict:
    """Resolve a ``serve.modelRegistry`` section (bool or dict) into full
    settings."""
    out = dict(REGISTRY_DEFAULTS)
    out["enabled"] = default_enabled
    if isinstance(raw, bool):
        out["enabled"] = raw
    elif isinstance(raw, dict):
        out.update({k: v for k, v in raw.items() if k in out})
        out["enabled"] = bool(raw.get("enabled", True))
    return out


@dataclass
class ModelVersion:
    """One registered version: identity, host-cached params, lifecycle
    state (``registered|canary|active|standby``) and serve accounting."""

    version: str
    checkpoint_dir: str
    cfg: object
    params: object            # HOST tree (CPU tensors) — paging never drops it
    state: str = "registered"
    served: int = 0
    registered_at: float = 0.0
    stub: bool = False        # sim-only version (model_fn batchers)


class ModelRegistry:
    """Process-resident version book for one serving surface.

    The batcher reads it per batch (:meth:`resolve` at enqueue,
    :meth:`checkout` at serve) and drives the swap protocol through it
    (:meth:`activate` is the resume leg). Copies to the device, cache
    eviction and checkpoint loads run outside the registry lock.
    """

    def __init__(self, settings=None,
                 clock: Callable[[], float] = time.perf_counter,
                 name: str = "serve", device: DeviceLike = None):
        if isinstance(settings, dict):
            s = dict(REGISTRY_DEFAULTS)
            s.update({k: v for k, v in settings.items() if k in s})
            s["enabled"] = bool(settings.get("enabled", True))
        else:
            s = registry_settings(settings, default_enabled=True)
        self.settings = s
        self.device = resolve_device(device)
        self.clock = clock
        self.name = str(name)
        self._shadow_cap = max(0, int(s["shadowWindow"]))
        self._bench_factor = float(s["benchFactor"])
        self._bench_rounds = max(1, int(s["benchRounds"]))
        # LRU over PLACED trees only: versions are the manager's keys, the
        # hibernate callback drops a device tree.
        self._pager = LifecycleManager(
            {"maxResident": max(1, int(s["maxResidentVersions"])),
             "idleSeconds": 0.0}, clock=clock)
        # ── guarded state (self._lock) ───────────────────────────────
        self._lock = threading.Lock()
        self._versions: dict[str, ModelVersion] = {}
        self._placed: dict[str, object] = {}   # version -> device tree
        self._active: Optional[str] = None
        self._previous: Optional[str] = None   # rollback target
        self._canary: Optional[str] = None
        self._canary_fraction = float(s["canaryFraction"])
        self._pins: dict[str, str] = {}        # tenant -> version
        self._shadow: list[str] = []           # recent served texts
        self._resolved = 0                     # canary split counter
        self.swaps = 0
        self.rollbacks = 0
        self.promotions = 0
        register_registry(self.name, self)

    # ── version book ─────────────────────────────────────────────────

    def register(self, version: str, checkpoint_dir: Optional[str] = None,
                 activate: bool = False) -> ModelVersion:
        """Load ``checkpoint_dir`` (shipped default when None) and book it
        under ``version``. Raises on a missing checkpoint: an empty
        version would serve nothing and look healthy. The first registered
        version bootstraps as active (the incumbent)."""
        loaded = load_pretrained(checkpoint_dir, device="cpu")
        if loaded is None:
            raise RuntimeError(
                f"model registry refused version {version!r}: no trained "
                f"checkpoint at {checkpoint_dir or 'the shipped default'}")
        cfg, params = loaded
        # A host copy per version (load_pretrained shares its cached tree),
        # pinned when the registry places on the card so a wake is one
        # asynchronous copy.
        pin = self.device.type == "cuda"
        host = map_tree(
            lambda _k, t: t.pin_memory() if pin else t.clone(), params)
        mv = ModelVersion(
            version=str(version),
            checkpoint_dir=os.path.abspath(checkpoint_dir or DEFAULT_DIR),
            cfg=cfg, params=host, registered_at=self.clock())
        self._book(mv, activate)
        self._pager.register(mv.version, self._make_dropper(mv.version))
        return mv

    def register_stub(self, version: str,
                      activate: bool = False) -> ModelVersion:
        """Book a checkpoint-less version for ``model_fn`` sim batchers:
        resolution, canary, pinning and ctl plumbing run as usual;
        :meth:`checkout` refuses it."""
        mv = ModelVersion(version=str(version), checkpoint_dir="",
                          cfg=None, params=None, stub=True,
                          registered_at=self.clock())
        self._book(mv, activate)
        return mv

    def _book(self, mv: ModelVersion, activate: bool) -> None:
        with self._lock:
            if mv.version in self._versions:
                raise ValueError(
                    f"model version {mv.version!r} already registered")
            self._versions[mv.version] = mv
            if activate or self._active is None:
                self._previous = self._active
                self._active = mv.version
                mv.state = "active"

    def has(self, version: str) -> bool:
        with self._lock:
            return str(version) in self._versions

    def versions(self) -> list[str]:
        with self._lock:
            return sorted(self._versions)

    def active(self) -> Optional[str]:
        with self._lock:
            return self._active

    def rollback_target(self) -> Optional[str]:
        """The previous active: rollback is ``swap_to(rollback_target())``,
        the same protocol in reverse."""
        with self._lock:
            return self._previous

    # ── request-time resolution ──────────────────────────────────────

    def resolve(self, tenant: str = "serve") -> Optional[str]:
        """Version for one request: tenant pin > canary split > active.
        Resolution n serves the canary iff floor(n·f) > floor((n-1)·f):
        exactly the fraction f, identical across reruns."""
        with self._lock:
            pin = self._pins.get(str(tenant))
            if pin is not None and pin in self._versions:
                return pin
            if self._canary is not None and self._canary_fraction > 0:
                self._resolved += 1
                n, f = self._resolved, self._canary_fraction
                if math.floor(n * f) > math.floor((n - 1) * f):
                    return self._canary
            return self._active

    def checkout(self, version: str):
        """``(cfg, placed_params, placement_key)`` for one batch. Wakes a
        paged version (a copy from the pinned host tree, timed until the
        device has it) and LRU-evicts colder versions' placed trees."""
        v = str(version)
        with self._lock:
            mv = self._versions.get(v)
            placed = self._placed.get(v)
        if mv is None:
            raise KeyError(f"unknown model version {v!r}")
        if mv.stub:
            raise RuntimeError(
                f"model version {v!r} is a sim stub — checkout needs a "
                "checkpoint-backed version")
        key = f"{mv.checkpoint_dir}::{v}"
        if placed is None:
            was_sleeping = self._pager.is_sleeping(v)
            t0 = self.clock()
            fresh = map_tree(
                lambda _k, t: t.to(self.device, non_blocking=True),
                mv.params)
            if self.device.type == "cuda":
                # the wake is over when the card holds the tree, not when
                # the copy is queued
                torch.cuda.synchronize(self.device)
            wake_ms = (self.clock() - t0) * 1e3
            with self._lock:
                placed = self._placed.setdefault(v, fresh)
            # Hibernation dropped the owner callback: the wake re-registers
            # it, or the next eviction of this version would do nothing.
            self._pager.register(v, self._make_dropper(v))
            if was_sleeping:
                self._pager.note_wake(v, wake_ms)
        victims = self._pager.note_traffic(v)
        for victim in victims:
            self._pager.hibernate(victim)
        return mv.cfg, placed, key

    def placement_key(self, version: str) -> str:
        """Placement-cache identity for ``version``: the checkpoint
        directory suffixed with the version id, so twin versions from one
        directory never collide."""
        v = str(version)
        with self._lock:
            mv = self._versions.get(v)
        if mv is None:
            raise KeyError(f"unknown model version {v!r}")
        return f"{mv.checkpoint_dir}::{v}"

    def note_served(self, version: str, n: int = 1) -> None:
        with self._lock:
            mv = self._versions.get(str(version))
            if mv is not None:
                mv.served += int(n)

    def is_paged(self, version: str) -> bool:
        return self._pager.is_sleeping(str(version))

    def is_stub(self, version: str) -> bool:
        with self._lock:
            mv = self._versions.get(str(version))
        return bool(mv is not None and mv.stub)

    def _make_dropper(self, version: str):
        def _drop() -> None:
            # The registry's entry and the placement cache's are the only
            # references a served tree keeps: once both go, the caching
            # allocator has the memory back.
            with self._lock:
                self._placed.pop(version, None)
            drop_sharded_params(self.placement_key(version))
        return _drop

    # ── swap / canary / pinning control plane ────────────────────────

    def activate(self, version: str) -> None:
        """Flip the active pointer — the RESUME leg of a hot swap. The
        displaced version turns ``standby`` (it serves its queued
        stragglers and is the rollback target); activating the previous
        active counts as a rollback."""
        v = str(version)
        with self._lock:
            mv = self._versions.get(v)
            if mv is None:
                raise KeyError(f"unknown model version {v!r}")
            if self._active == v:
                return
            rollback = v == self._previous
            prev = self._versions.get(self._active) \
                if self._active is not None else None
            if prev is not None and prev.state == "active":
                prev.state = "standby"
            self._previous = self._active
            self._active = v
            mv.state = "active"
            if self._canary == v:
                self._canary = None
                self._canary_fraction = 0.0
            self.swaps += 1
            if rollback:
                self.rollbacks += 1

    def set_canary(self, version: str, fraction: float) -> None:
        v = str(version)
        with self._lock:
            mv = self._versions.get(v)
            if mv is None:
                raise KeyError(f"unknown model version {v!r}")
            self._canary = v
            self._canary_fraction = max(0.0, min(1.0, float(fraction)))
            if mv.state == "registered":
                mv.state = "canary"

    def clear_canary(self) -> None:
        with self._lock:
            mv = self._versions.get(self._canary) \
                if self._canary is not None else None
            if mv is not None and mv.state == "canary":
                mv.state = "registered"
            self._canary = None
            self._canary_fraction = 0.0

    def pin(self, tenant: str, version: str) -> None:
        v = str(version)
        with self._lock:
            if v not in self._versions:
                raise KeyError(f"unknown model version {v!r}")
            self._pins[str(tenant)] = v

    def unpin(self, tenant: str) -> None:
        with self._lock:
            self._pins.pop(str(tenant), None)

    # ── shadow traffic + promotion gate ──────────────────────────────

    def shadow_note(self, text: str) -> None:
        """Ring-buffer one served text for shadow replay (bounded by
        ``shadowWindow``); the enqueue path calls this per request."""
        if self._shadow_cap <= 0:
            return
        with self._lock:
            self._shadow.append(str(text))
            if len(self._shadow) > self._shadow_cap:
                del self._shadow[:len(self._shadow) - self._shadow_cap]

    def shadow_texts(self) -> list[str]:
        with self._lock:
            return list(self._shadow)

    def _score(self, version: str, texts: list) -> list:
        """Verdicts for ``texts`` under ``version``: the plain
        single-device forward (attention through the kernel on the card)
        and the shared renderer, so two versions can only disagree
        through their weights. The ``.cpu()`` of the argmax waits for the
        device, which the bench leg's clock needs."""
        cfg, params, _key = self.checkout(version)
        tokens = encode_texts(list(texts), cfg.seq_len, cfg.vocab_size)
        padded = pad_rows(tokens, pow2_bucket(len(texts)))
        with torch.inference_mode():
            out = forward(params, torch.from_numpy(padded).to(self.device),
                          cfg)
            classes = out["severity"][:len(texts)].argmax(dim=-1).cpu()
        return [render_verdict(int(c)) for c in classes.tolist()]

    def promotion_report(self, candidate: str,
                         texts: Optional[list] = None) -> dict:
        """Score ``candidate`` against the incumbent-as-oracle over the
        shadow ring (or ``texts``): any verdict mismatch is a regression,
        and the pinned-bench leg requires candidate p50 <= incumbent p50
        × ``benchFactor``. ``promote`` is the conjunction."""
        with self._lock:
            incumbent = self._active
            ring = list(self._shadow)
        sample = list(texts) if texts is not None else ring
        report = {"candidate": str(candidate), "incumbent": incumbent,
                  "replayed": len(sample), "verdictRegressions": 0,
                  "candidateP50Ms": None, "incumbentP50Ms": None,
                  "benchOk": True}
        if incumbent is None or incumbent == str(candidate) or not sample:
            report["promote"] = True
            return report
        # Untimed first leg: the candidate's first score pays one-time
        # costs (its placement, a bucket's first use) that say nothing
        # about steady-state serving.
        cand_verdicts = self._score(candidate, sample)
        inc_verdicts = self._score(incumbent, sample)
        regressions = sum(1 for a, b in zip(cand_verdicts, inc_verdicts)
                          if a != b)
        cand_times, inc_times = [], []
        for _ in range(self._bench_rounds):
            cand_round, inc_round = [], []
            for _ in range(BENCH_REPEATS):
                t0 = self.clock()
                self._score(candidate, sample)
                cand_round.append((self.clock() - t0) * 1e3)
                t0 = self.clock()
                self._score(incumbent, sample)
                inc_round.append((self.clock() - t0) * 1e3)
            cand_times.append(min(cand_round))
            inc_times.append(min(inc_round))
        cand_p50 = sorted(cand_times)[len(cand_times) // 2]
        inc_p50 = sorted(inc_times)[len(inc_times) // 2]
        report.update({
            "verdictRegressions": regressions,
            "candidateP50Ms": round(cand_p50, 3),
            "incumbentP50Ms": round(inc_p50, 3),
            "benchOk": cand_p50 <= inc_p50 * self._bench_factor})
        report["promote"] = report["benchOk"] and regressions == 0
        return report

    def promote(self, candidate: str,
                report: Optional[dict] = None) -> dict:
        """Arm a promotion: raise on a refusing report, count it, and
        return the report. The caller completes the rollout with
        ``batcher.swap_to(candidate)``."""
        rep = report if report is not None \
            else self.promotion_report(candidate)
        if not rep.get("promote"):
            raise RuntimeError(
                f"promotion gate refused {candidate!r}: "
                f"{rep.get('verdictRegressions')} verdict regression(s), "
                f"benchOk={rep.get('benchOk')}")
        with self._lock:
            self.promotions += 1
        return rep

    # ── observability ────────────────────────────────────────────────

    def stats(self) -> dict:
        pager = self._pager.stats()
        resident = set(self._pager.resident_keys())
        paged = self._pager.sleeping_keys()
        with self._lock:
            versions = {
                v: {"state": mv.state, "served": mv.served,
                    "stub": mv.stub, "resident": v in resident}
                for v, mv in sorted(self._versions.items())}
            out = {"enabled": True, "name": self.name,
                   "active": self._active, "previous": self._previous,
                   "canary": {"version": self._canary,
                              "fraction": self._canary_fraction},
                   "pins": dict(self._pins), "resolved": self._resolved,
                   "swaps": self.swaps, "rollbacks": self.rollbacks,
                   "promotions": self.promotions,
                   "shadowBuffered": len(self._shadow),
                   "shadowWindow": self._shadow_cap}
        out["versions"] = versions
        out["paging"] = {"maxResidentVersions": self._pager.max_resident,
                         "resident": sorted(resident), "paged": paged,
                         "wakes": pager["wakes"],
                         "evictions": pager["evictions"],
                         "wakeP50Ms": pager["wakeP50Ms"],
                         "wakeP99Ms": pager["wakeP99Ms"]}
        return out


# ── process registry (the ops plane's model_registry view) ───────────

_registries: dict[str, ModelRegistry] = {}
_registries_lock = threading.Lock()


def register_registry(name: str, registry: ModelRegistry) -> None:
    """Book a registry for the ops plane (latest wins per name)."""
    with _registries_lock:
        _registries[str(name)] = registry


def all_registries() -> dict:
    with _registries_lock:
        return dict(_registries)


def clear_registries() -> None:
    with _registries_lock:
        _registries.clear()
