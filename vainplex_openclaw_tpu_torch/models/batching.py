"""Continuous batching for the local serve seam, on one device or a mesh.

Counterpart of ``vainplex_openclaw_tpu/models/batching.py``. Concurrent
requests queue; a collector
drains up to ``max_batch`` of them inside a ``window_ms`` batching window;
the batch dim is zero-row padded to a power of two; one ``forward`` serves
them all. Verdict rendering is per request and string-identical to the
one-shot path (``render_verdict``).

Admission rides :class:`AdmissionController`: a submit landing above the
shed threshold raises :class:`ServeSheddedError` instead of queueing.
Per-request attribution lands in a :class:`StageTimer` under JAX's four
stages: ``queue`` (enqueue → batch formation), ``batch`` (drain +
tokenize + pad), ``prefill`` (host → device tokens, the batched forward,
and the severity logits back to the host) and ``decode`` (argmax +
verdict render). The timer is the gateway's ``serve`` edge, so it holds
these per-request stages alone (a mesh adds ``shard`` and ``gather``,
below). Each is a :class:`~..utils.stage_timer.Span` of the batch's id,
so while a torch profiler records it is also an ``openclaw.*`` range and
a record of the span log. The log alone (no stage) gets the collector's
``wait`` (queue empty → first ticket) and ``window`` (first ticket →
drained), and in a checkpoint batch ``tokenize`` (the ``encode_texts``
call, inside ``batch``) and, on one device, ``launch`` (tokens to the
device and ``forward`` returning) and ``sync`` (the ``.cpu()`` that
waits for the card), which together make up ``prefill``; besides, each
ticket's ``queue`` (enqueue → batch start) and ``wake`` (its
``done.set()`` → :meth:`ContinuousBatcher.submit` returning on the
submitter's thread) under its request id, parent the batch id.

Tokens move host → device once per batch, and severity comes back with one
``.cpu()``. Every zero-pad row has all its keys masked; the attention
kernel keeps such rows finite, and they are sliced away before decode.

With a ``mesh`` (a :class:`~..parallel.mesh.Mesh`) the batch serves through
the plan of ``plan_family``, any family of ``parallel.plan.PLAN_TABLE``:
the ``forward`` runner (dp rows, tensor or expert parallel, kernel K1 on
every shard), the ``pipeline`` wavefront (K1 per microbatch and stage) or,
for ``encoder_validator_long``, ring attention over (dp, sp): rows with at
least ``long_threshold`` real tokens take that program (``forward_long``,
kernel K2), the rest its short-path twin over the same placed weights.
Each sub-batch is bucketed by ``serve_bucket``. Two more stages are timed:
``shard`` (placing weights and token shards) and ``gather`` (severity back
to the host); a pipeline plan also charges each of its microbatches
``prefill / M`` under ``microbatch`` (a mean, not a measured hop). An MoE
model on a mesh reports its load-balance aux under ``stats()["moe"]``.
Without a mesh ``plan_family`` is not read: every family serves
single-device.

Versioned serving: with a :class:`~.registry.ModelRegistry` attached,
tickets are version-stamped at enqueue (pin > canary > active), batches
form version-homogeneous, params come from ``registry.checkout`` (the
registry's LRU-paged device trees) and :meth:`ContinuousBatcher.swap_to`
hot-swaps the active version: drain, place, resume, with nothing torn
down and no kernel rebuilt. The registry must place on the batcher's
device. ``registry=None`` keeps the single-version path as it was.
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..ops.similarity import pad_rows, pow2_bucket
from ..parallel import plan as sharding_plan
from ..utils.stage_timer import SPANS, Span, StageTimer, new_id, span
from .encoder import forward
from .pretrained import DEFAULT_DIR, available, load_pretrained
from .tokenizer import encode_texts

# severity head classes (encoder n_severity=4): info|low|medium|high-crit
SEVERITY_TO_VERDICT = ("pass", "pass", "flag", "block")


class ServeSheddedError(RuntimeError):
    """Raised to a submitter the admission controller refused to queue."""


def render_verdict(severity: int) -> str:
    """The strict-JSON stage-3 verdict contract for one severity class —
    shared by the one-shot oracle (models/serve.py) and the batched path,
    so the two can only ever disagree through the model, never the
    renderer."""
    verdict = SEVERITY_TO_VERDICT[min(severity, len(SEVERITY_TO_VERDICT) - 1)]
    issues = []
    if verdict != "pass":
        issues.append({"category": "unverifiable_claim",
                       "detail": f"local triage severity class {severity}"})
    return json.dumps({
        "verdict": verdict,
        "reason": f"local triage encoder: severity class {severity}",
        "issues": issues,
    })


@dataclass
class _Pending:
    text: str
    tenant: str
    enqueued_at: float
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[str] = None
    error: Optional[BaseException] = None
    # Version stamped at enqueue: the ticket is served by exactly this
    # version whatever swaps land later ("mis-versioned" means the serving
    # version disagreed with this stamp).
    version: Optional[str] = None
    # The request's id, the id of the batch that served it, and when the
    # collector answered it (set only while tracing: the ``wake`` span).
    rid: Optional[int] = None
    bid: Optional[int] = None
    done_at: Optional[float] = None


def _same_device(a: torch.device, b: torch.device) -> bool:
    """``cuda`` and ``cuda:0`` name one card (the first, which is where an
    index-less CUDA tensor lands)."""
    if a.type != b.type:
        return False
    return a.type != "cuda" or (a.index or 0) == (b.index or 0)


class ContinuousBatcher:
    """Queue → collect → one batched forward, continuously.

    ``submit()`` is the blocking per-request surface the ``call_llm`` seam
    wraps; the background collector thread (``autostart=True``) forms
    batches. Tests drive deterministically with ``autostart=False`` +
    :meth:`step`. ``model_fn(texts) -> [severity]`` replaces the checkpoint
    forward (the simulation seam); the queue, window and verdict plumbing
    run unchanged around it. With a ``registry`` the sim contract is
    ``model_fn(texts, version)``, so a mis-versioned verdict shows.
    """

    def __init__(self, checkpoint_dir: Optional[str] = None,
                 max_batch: int = 32, window_ms: float = 2.0,
                 admission=None, timer: Optional[StageTimer] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 autostart: bool = True,
                 model_fn: Optional[Callable] = None,
                 device: DeviceLike = None, mesh=None,
                 plan_family: str = "encoder_validator",
                 searched_plans: bool = True, long_threshold: int = 1024,
                 registry=None):
        self.device = resolve_device(device)
        # Mesh serving: the plan resolves here, so an unknown family fails
        # at construction, not on the first request, and again once per
        # batch (override > searched table > hand-written), so bucket,
        # placement and runner agree. ``searched_plans=False``
        # (serve.searchedPlans) pins the hand-written rules.
        self.mesh = mesh
        self.plan_family = plan_family
        self.searched_plans = bool(searched_plans)
        self.long_threshold = max(1, int(long_threshold))
        self.long_routed = 0
        # Sub-batches served per runner ("long": ring attention, K2;
        # "forward" and "pipeline": K1), for launch accounting.
        self.mesh_runs = {runner: 0 for runner in sharding_plan.RUNNERS}
        self._moe_aux_last = 0.0
        self._moe_aux_sum = 0.0
        self._moe_batches = 0
        if mesh is not None:
            plan = sharding_plan.resolve_plan(plan_family, mesh,
                                              searched=self.searched_plans)
            sharding_plan.check_servable(plan, mesh)
            if {d.type for d in mesh.devices} != {self.device.type}:
                raise ValueError(f"mesh devices {mesh.distinct_devices()} "
                                 f"are not on {self.device.type}")
            self.device = mesh.devices[0]
        if registry is not None and not _same_device(registry.device,
                                                     self.device):
            raise ValueError(f"model registry places on {registry.device}, "
                             f"the batcher serves on {self.device}")
        self.model_fn = model_fn
        self.registry = registry
        if model_fn is None and registry is None and \
                not available(checkpoint_dir):
            # A silent per-call "pass" would override fail_mode='closed'.
            raise RuntimeError(
                "continuous batching serve path refused: no trained "
                f"checkpoint at {checkpoint_dir or 'the shipped default'}")
        self.checkpoint_dir = checkpoint_dir
        self.max_batch = max(1, int(max_batch))
        self.window_ms = float(window_ms)
        self.admission = admission
        self.timer = timer or StageTimer()
        self._clock = clock
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)
        self._queue: list[_Pending] = []
        self._closed = False
        self.served = 0
        self.shed = 0
        self.batches = 0
        self._thread: Optional[threading.Thread] = None
        if autostart:
            self._thread = threading.Thread(
                target=self._collector, name="serve-batcher", daemon=True)
            self._thread.start()

    # ── request surface ──────────────────────────────────────────────

    def enqueue(self, text: str, tenant: str = "serve",
                at: Optional[float] = None,
                version: Optional[str] = None,
                rid: Optional[int] = None) -> _Pending:
        """Queue one request WITHOUT waiting; returns the ticket. ``at``
        overrides the enqueue timestamp (virtual-time drivers such as the
        fleet router); ``version`` pre-stamps the serving version, else an
        attached registry resolves it here (pin > canary > active);
        ``rid`` is the request id the caller's spans carry (a fresh one
        by default)."""
        with self._lock:
            if self._closed:
                raise RuntimeError("batcher closed")
            depth = len(self._queue) + 1
        if self.admission is not None:
            self.admission.note_queue_depth(depth)
            if not self.admission.admit(tenant):
                with self._lock:
                    self.shed += 1
                raise ServeSheddedError(
                    f"serve admission shed (queue depth {depth})")
        if self.registry is not None:
            if version is None:
                version = self.registry.resolve(tenant)
            self.registry.shadow_note(text)
        req = _Pending(text=text, tenant=tenant,
                       enqueued_at=self._clock() if at is None else at,
                       version=version,
                       rid=new_id() if rid is None else rid)
        with self._nonempty:
            self._queue.append(req)
            self._nonempty.notify()
        return req

    def submit(self, text: str, tenant: str = "serve",
               timeout_s: float = 60.0,
               version: Optional[str] = None,
               rid: Optional[int] = None) -> str:
        """Serve one extracted message text; blocks until its batch ran.
        Raises :class:`ServeSheddedError` when admission sheds, whatever
        the batch worker raised when serving failed. ``rid`` is the
        request's id (a fresh one by default); where its batch ran while
        tracing, its ``wake`` is logged under that id, parent the batch
        id."""
        req = self.enqueue(text, tenant, version=version, rid=rid)
        if not req.done.wait(timeout_s):
            raise TimeoutError(f"serve request not batched in {timeout_s}s")
        if req.done_at is not None:
            SPANS.add("wake", req.done_at, self._clock(), req.rid, req.bid, 1)
        if req.error is not None:
            raise req.error
        return req.result

    # ── batch formation ──────────────────────────────────────────────

    def _drain(self) -> list:
        with self._lock:
            if self.registry is None:
                batch, self._queue = (self._queue[:self.max_batch],
                                      self._queue[self.max_batch:])
            else:
                # One batch = one placed tree: the head's version leads,
                # same-version followers join up to max_batch, the rest
                # keep their order for the next drain.
                head_v = self._queue[0].version if self._queue else None
                batch, rest = [], []
                for req in self._queue:
                    if len(batch) < self.max_batch and req.version == head_v:
                        batch.append(req)
                    else:
                        rest.append(req)
                self._queue = rest
            depth = len(self._queue)
        if self.admission is not None:
            self.admission.note_queue_depth(depth)
        return batch

    def step(self, wait_s: float = 0.0) -> int:
        """Serve ONE batch synchronously (the deterministic twin of the
        collector loop). Returns the number of requests served (0 when the
        queue stayed empty for wait_s, or a running collector drained it
        first). A failing batch answers its tickets with the error, then
        raises it."""
        with self._nonempty:
            if not self._queue and wait_s:
                self._nonempty.wait(wait_s)
            if not self._queue:
                return 0
        batch = self._drain()
        if not batch:
            return 0
        self._serve(batch, new_id())
        return len(batch)

    def drain(self) -> int:
        """Step until the queue is empty. Returns total served."""
        total = 0
        while True:
            n = self.step()
            if n == 0:
                return total
            total += n

    def occupancy(self) -> dict:
        """Bucket-window snapshot: ``0 < queued < maxBatch`` is an open
        window; ``oldestAt`` is the head request's enqueue time."""
        with self._lock:
            return {"queued": len(self._queue),
                    "maxBatch": self.max_batch,
                    "oldestAt": self._queue[0].enqueued_at
                    if self._queue else None}

    def _span(self, name: str, bid: Optional[int],
              n: Optional[int] = None) -> Span:
        """A stage of the batch ``bid`` on the batcher's timer, timed on
        the batcher's clock (virtual in simulations), not the timer's."""
        return Span(name, self.timer, bid, None, n, self._clock)

    def _collector(self) -> None:
        while True:
            # waiting for work and forming the batch are no stage of a
            # request: log-only spans, off the serve edge's timer
            bid = new_id()
            waiting = span("wait", bid)
            with self._nonempty:
                while not self._queue and not self._closed:
                    self._nonempty.wait(0.1)
                closing = self._closed and not self._queue
            if closing:
                waiting.end()
                return
            window = waiting.then("window")
            # batching window: let concurrent submitters land before the
            # drain — bounded, so a lone request pays ≤ window_ms extra.
            if self.window_ms > 0:
                deadline = self._clock() + self.window_ms / 1e3
                while self._clock() < deadline:
                    with self._lock:
                        if len(self._queue) >= self.max_batch:
                            break
                    time.sleep(0.0002)
            batch = self._drain()
            window.end()
            if batch:
                try:
                    self._serve(batch, bid)
                except BaseException:  # noqa: BLE001 — answered per ticket
                    # Not re-raised, as in the JAX batcher: in this thread
                    # it would only end the collector and strand every
                    # later request.
                    pass

    # ── the batched serve step ───────────────────────────────────────

    def _serve(self, batch: list, bid: int) -> None:
        """Run one batch under the batch id ``bid``. On any failure, even
        SystemExit or KeyboardInterrupt, every ticket not yet answered gets
        the error rather than waiting out its timeout; then the error is
        raised."""
        for req in batch:
            req.bid = bid
        try:
            self._run_batch(batch)
        except BaseException as exc:
            for req in batch:
                if not req.done.is_set():
                    req.error = exc
                    req.done.set()
            raise

    def _run_batch(self, batch: list) -> None:
        bid, n = batch[0].bid, len(batch)
        part = self._span("batch", bid, n)
        t0 = part.t0
        for req in batch:
            self.timer.add("queue", (t0 - req.enqueued_at) * 1e3)
        if part.traced:
            for req in batch:
                SPANS.add("queue", req.enqueued_at, t0, req.rid, bid, 1)
        batch_version = batch[0].version
        try:
            if self.model_fn is not None:
                part = part.then("prefill")
                texts = [r.text for r in batch]
                classes = self.model_fn(texts) if self.registry is None \
                    else self.model_fn(texts, batch_version)
                part = part.then("decode")
            else:
                if self.registry is not None:
                    # The stamped version decides the tree; a checkout
                    # that raises fails this batch, never falls back.
                    cfg, params, key = self.registry.checkout(batch_version)
                else:
                    loaded = load_pretrained(self.checkpoint_dir,
                                             device=self.device)
                    if loaded is None:
                        raise RuntimeError(
                            "continuous serve: checkpoint no longer loadable")
                    cfg, params = loaded
                    key = os.path.abspath(self.checkpoint_dir or DEFAULT_DIR)
                with span("tokenize", bid, None, n):
                    tokens = encode_texts([r.text for r in batch],
                                          cfg.seq_len, cfg.vocab_size)
                if self.mesh is not None:
                    severity, part = self._run_mesh(tokens, cfg, params,
                                                    key, part)
                else:
                    padded = pad_rows(tokens, pow2_bucket(n))
                    part = part.then("prefill")
                    with torch.inference_mode():
                        with span("launch", bid, None, n):
                            out = forward(
                                params,
                                torch.from_numpy(padded).to(self.device), cfg)
                        with span("sync", bid, None, n):  # waits for the card
                            severity = out["severity"].cpu()
                part = part.then("decode")
                classes = severity[:n].argmax(dim=-1).tolist()
            for req, cls in zip(batch, classes):
                req.result = render_verdict(int(cls))
                if part.traced:
                    req.done_at = self._clock()
                req.done.set()
            with self._lock:
                self.served += n
                self.batches += 1
            if self.registry is not None:
                self.registry.note_served(batch_version, n)
            # The batch's tensors are freed inside ``decode``, not as the
            # frame returns: freeing a tensor lets the sessions just
            # answered take the interpreter lock, and that wait is part of
            # the batch.
            out = severity = None  # noqa: F841
        except BaseException:
            part.end(timed=False)  # a failed stage is no sample of it
            raise
        part.end()

    def _run_mesh(self, tokens: np.ndarray, cfg, params, key: str,
                  staged: Span):
        """The mesh-served step: route rows by real-token occupancy (with a
        ``"long"`` plan), bucket each sub-batch, place (``shard``), run,
        and bring severity back (``gather``); ``staged`` is the batch's
        ``batch`` span, ended once the sub-batches are padded. Returns
        (severity [n, C] on the CPU, the ``gather`` span, still open)."""
        plan = sharding_plan.resolve_plan(self.plan_family, self.mesh,
                                          searched=self.searched_plans)
        subs = []  # (row indices, sub-plan, padded tokens)
        if plan.runner == "long":
            is_long = (tokens > 0).sum(axis=1) >= self.long_threshold
            for sub_plan, idx in (
                    (plan, np.nonzero(is_long)[0]),
                    (sharding_plan.short_path_plan(plan),
                     np.nonzero(~is_long)[0])):
                if idx.size:
                    subs.append((idx, sub_plan, pad_rows(
                        tokens[idx], sharding_plan.serve_bucket(
                            int(idx.size), self.mesh, plan=sub_plan))))
            with self._lock:
                self.long_routed += int(is_long.sum())
        else:
            subs.append((np.arange(len(tokens)), plan, pad_rows(
                tokens, sharding_plan.serve_bucket(len(tokens), self.mesh,
                                                   plan=plan))))
        with self._lock:
            for _, sub_plan, _ in subs:
                self.mesh_runs[sub_plan.runner] += 1
        part = staged.then("shard")
        try:
            placed = [(idx, sub_plan,
                       sharding_plan.sharded_params(key, params, self.mesh,
                                                    sub_plan),
                       sharding_plan.place_tokens(padded, self.mesh,
                                                  sub_plan))
                      for idx, sub_plan, padded in subs]
            part = part.then("prefill")
            prefill_t0 = part.t0
            with torch.inference_mode():
                outs = [(idx, sharding_plan.serve_forward(
                    sub_params, shards, cfg, self.mesh, sub_plan))
                    for idx, sub_plan, sub_params, shards in placed]
                self._sync()
            part = part.then("gather")
            if plan.runner == "pipeline" and plan.microbatches:
                # the wavefront's prefill, shared evenly by its microbatches
                per_mb = (part.t0 - prefill_t0) * 1e3 / plan.microbatches
                for _ in range(plan.microbatches):
                    self.timer.add("microbatch", per_mb)
            severity = torch.zeros((len(tokens), cfg.n_severity),
                                   dtype=torch.float32)
            for idx, out in outs:
                severity[torch.from_numpy(idx)] = \
                    out["severity"][:idx.size].float().cpu()
            if cfg.n_experts > 0 and outs:
                aux = float(outs[0][1]["moe_aux"])
                with self._lock:
                    self._moe_aux_last = aux
                    self._moe_aux_sum += aux
                    self._moe_batches += 1
        except BaseException:
            part.end(timed=False)
            raise
        return severity, part

    def _sync(self) -> None:
        """Wait for every card this batcher serves on."""
        devices = self.mesh.distinct_devices() if self.mesh is not None \
            else [self.device]
        for d in devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    # ── hot weight swap ──────────────────────────────────────────────

    def swap_to(self, version: str) -> dict:
        """Swap to ``version`` under load: **drain** (serve every request
        queued before the swap started), **place** (check the version out
        and, on a mesh, push it through the placement cache, then wait for
        the card), **resume** (flip the registry's active pointer, so new
        enqueues stamp the new version). Place-before-drain would serve
        old stamps beside a half-placed tree; resume-before-place would
        stall the first new batch on placement. The stage walls go into
        the StageTimer (``swap_drain``/``swap_place``/``swap_resume``) and
        into the result. Rollback is this method with
        ``registry.rollback_target()``."""
        if self.registry is None:
            raise RuntimeError(
                "swap_to requires a model registry "
                "(serve.modelRegistry is off)")
        t0 = self._clock()
        drained = self._swap_drain(t0)
        t1 = self._clock()
        self.timer.add("swap_drain", (t1 - t0) * 1e3)
        self._swap_place(version)
        t2 = self._clock()
        self.timer.add("swap_place", (t2 - t1) * 1e3)
        self._swap_resume(version)
        t3 = self._clock()
        self.timer.add("swap_resume", (t3 - t2) * 1e3)
        return {"version": str(version), "drained": drained,
                "stages": {"drain": (t1 - t0) * 1e3,
                           "place": (t2 - t1) * 1e3,
                           "resume": (t3 - t2) * 1e3},
                "totalMs": (t3 - t0) * 1e3}

    def _swap_drain(self, cutoff: float) -> int:
        """Serve until no queued request predates ``cutoff``. Requests
        enqueued during the swap are already stamped and do not extend
        it."""
        served = 0
        while True:
            with self._lock:
                pending = any(r.enqueued_at <= cutoff for r in self._queue)
            if not pending:
                return served
            served += self.step()

    def _swap_place(self, version: str) -> None:
        """Pre-place the new version, so the first batch after resume
        finds it resident. A stub version has nothing to place."""
        if self.registry.is_stub(version):
            return
        _cfg, params, key = self.registry.checkout(version)
        if self.mesh is not None:
            plan = sharding_plan.resolve_plan(self.plan_family, self.mesh,
                                              searched=self.searched_plans)
            sharding_plan.sharded_params(key, params, self.mesh, plan)
        self._sync()

    def _swap_resume(self, version: str) -> None:
        self.registry.activate(version)

    # ── lifecycle / observability ────────────────────────────────────

    def close(self, timeout_s: float = 5.0) -> None:
        with self._nonempty:
            self._closed = True
            self._nonempty.notify_all()
        if self._thread is not None:
            self._thread.join(timeout_s)

    def stats(self) -> dict:
        with self._lock:
            base = {"served": self.served, "batches": self.batches,
                    "shed": self.shed, "queued": len(self._queue),
                    "maxBatch": self.max_batch, "windowMs": self.window_ms,
                    "device": str(self.device),
                    "mesh": ("x".join(str(d) for d in self.mesh.dims)
                             if self.mesh is not None else None)}
        base["meanBatch"] = round(base["served"] / base["batches"], 2) \
            if base["batches"] else 0.0
        if self.mesh is not None:
            base["longRouted"] = self.long_routed
            base["meshRuns"] = dict(self.mesh_runs)
        if self._moe_batches:
            # the router's imbalance: n_experts × the balance term
            base["moe"] = {
                "auxLast": round(self._moe_aux_last, 6),
                "auxMean": round(self._moe_aux_sum / self._moe_batches, 6),
                "batches": self._moe_batches,
            }
        if self.registry is not None:
            # the pointer only; the version book is registry.stats()
            base["activeVersion"] = self.registry.active()
        if self.admission is not None:
            base["admission"] = self.admission.stats()
        base["stages"] = self.timer.snapshot()
        return base
