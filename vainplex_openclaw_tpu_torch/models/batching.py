"""Continuous batching for the local serve seam, on one device.

Counterpart of ``vainplex_openclaw_tpu/models/batching.py`` with
``mesh=None`` and ``registry=None``. Concurrent requests queue; a collector
drains up to ``max_batch`` of them inside a ``window_ms`` batching window;
the batch dim is zero-row padded to a power of two; one ``forward`` serves
them all. Verdict rendering is per request and string-identical to the
one-shot path (``render_verdict``).

Admission rides :class:`AdmissionController`: a submit landing above the
shed threshold raises :class:`ServeSheddedError` instead of queueing.
Per-request attribution lands in a :class:`StageTimer` under four stages:
``queue`` (enqueue → batch formation), ``batch`` (drain + tokenize + pad),
``prefill`` (host → device tokens, the batched forward, and the severity
logits back to the host) and ``decode`` (argmax + verdict render).

Tokens move host → device once per batch, and severity comes back with one
``.cpu()``. Every zero-pad row has all its keys masked; the attention
kernel keeps such rows finite, and they are sliced away before decode.
Mesh serving, the model registry and hot swap are not ported yet: passing
``mesh`` or ``registry`` raises.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from ..device import DeviceLike, resolve_device
from ..ops.similarity import pad_rows, pow2_bucket
from ..utils.stage_timer import StageTimer
from .encoder import forward
from .pretrained import available, load_pretrained
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


class ContinuousBatcher:
    """Queue → collect → one batched forward, continuously.

    ``submit()`` is the blocking per-request surface the ``call_llm`` seam
    wraps; the background collector thread (``autostart=True``) forms
    batches. Tests drive deterministically with ``autostart=False`` +
    :meth:`step`. ``model_fn(texts) -> [severity]`` replaces the checkpoint
    forward (the simulation seam); the queue, window and verdict plumbing
    run unchanged around it.
    """

    def __init__(self, checkpoint_dir: Optional[str] = None,
                 max_batch: int = 32, window_ms: float = 2.0,
                 admission=None, timer: Optional[StageTimer] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 autostart: bool = True,
                 model_fn: Optional[Callable] = None,
                 device: DeviceLike = None, mesh=None, registry=None):
        if mesh is not None:
            raise NotImplementedError("mesh serving is not ported yet")
        if registry is not None:
            raise NotImplementedError("the model registry is not ported yet")
        self.device = resolve_device(device)
        self.model_fn = model_fn
        if model_fn is None and not available(checkpoint_dir):
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

    def enqueue(self, text: str, tenant: str = "serve") -> _Pending:
        """Queue one request WITHOUT waiting; returns the ticket."""
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
        req = _Pending(text=text, tenant=tenant, enqueued_at=self._clock())
        with self._nonempty:
            self._queue.append(req)
            self._nonempty.notify()
        return req

    def submit(self, text: str, tenant: str = "serve",
               timeout_s: float = 60.0) -> str:
        """Serve one extracted message text; blocks until its batch ran.
        Raises :class:`ServeSheddedError` when admission sheds, whatever
        the batch worker raised when serving failed."""
        req = self.enqueue(text, tenant)
        if not req.done.wait(timeout_s):
            raise TimeoutError(f"serve request not batched in {timeout_s}s")
        if req.error is not None:
            raise req.error
        return req.result

    # ── batch formation ──────────────────────────────────────────────

    def _drain(self) -> list:
        with self._lock:
            batch, self._queue = (self._queue[:self.max_batch],
                                  self._queue[self.max_batch:])
            depth = len(self._queue)
        if self.admission is not None:
            self.admission.note_queue_depth(depth)
        return batch

    def step(self, wait_s: float = 0.0) -> int:
        """Serve ONE batch synchronously (the deterministic twin of the
        collector loop). Returns the number of requests served (0 when the
        queue stayed empty for wait_s)."""
        with self._nonempty:
            if not self._queue and wait_s:
                self._nonempty.wait(wait_s)
            if not self._queue:
                return 0
        batch = self._drain()
        self._run_batch(batch)
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

    def _collector(self) -> None:
        while True:
            with self._nonempty:
                while not self._queue and not self._closed:
                    self._nonempty.wait(0.1)
                if self._closed and not self._queue:
                    return
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
            if batch:
                try:
                    self._run_batch(batch)
                except Exception as exc:  # noqa: BLE001 — per-request fan-out
                    for req in batch:
                        if not req.done.is_set():
                            req.error = exc
                            req.done.set()

    # ── the batched serve step ───────────────────────────────────────

    def _run_batch(self, batch: list) -> None:
        t0 = self._clock()
        for req in batch:
            self.timer.add("queue", (t0 - req.enqueued_at) * 1e3)
        if self.model_fn is not None:
            t1 = self._clock()
            self.timer.add("batch", (t1 - t0) * 1e3)
            classes = self.model_fn([r.text for r in batch])
            t2 = self._clock()
            self.timer.add("prefill", (t2 - t1) * 1e3)
        else:
            loaded = load_pretrained(self.checkpoint_dir, device=self.device)
            if loaded is None:
                raise RuntimeError(
                    "continuous serve: checkpoint no longer loadable")
            cfg, params = loaded
            tokens = encode_texts([r.text for r in batch], cfg.seq_len,
                                  cfg.vocab_size)
            padded = pad_rows(tokens, pow2_bucket(len(batch)))
            t1 = self._clock()
            self.timer.add("batch", (t1 - t0) * 1e3)
            with torch.inference_mode():
                out = forward(params, torch.from_numpy(padded).to(self.device),
                              cfg)
                severity = out["severity"].cpu()  # waits for the device
            t2 = self._clock()
            self.timer.add("prefill", (t2 - t1) * 1e3)
            classes = severity[:len(batch)].argmax(dim=-1).tolist()
        for req, cls in zip(batch, classes):
            req.result = render_verdict(int(cls))
            req.done.set()
        with self._lock:
            self.served += len(batch)
            self.batches += 1
        self.timer.add("decode", (self._clock() - t2) * 1e3)

    def swap_to(self, version: str) -> dict:
        raise NotImplementedError("hot weight swap is not ported yet")

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
                    "device": str(self.device)}
        base["meanBatch"] = round(base["served"] / base["batches"], 2) \
            if base["batches"] else 0.0
        if self.admission is not None:
            base["admission"] = self.admission.stats()
        base["stages"] = self.timer.snapshot()
        return base
