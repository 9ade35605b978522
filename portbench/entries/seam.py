"""Runner of the stage-3 seam: ``models/serve.py``'s
``make_local_call_llm`` under a closed loop of agent sessions.

Each of the mix's ``sessions`` threads sends its next stage-3 prompt only
once the verdict of its last one has come back, as the gateway holds a
send until stage 3 answers. The seam is built on the mix's ``serve``
settings (deep-merged over the program's defaults).

Set-up warms every batch bucket the window can form (each pow2 up to
``maxBatch``), then runs the loop for ``warmup_s`` so that every thread
has made its first call.
The window then runs the loop for ``--seconds``. A request counts as
delivered when its verdict came back inside the window.

The check, once the window has closed and the program is shut: a sample
drawn from the seed of the distinct messages the window answered, with the
longest among them, goes through the reference. Every verdict served for
them is read back to its severity class, and ``verdict_gap`` is the widest
gap by which a served class's reference logit lies below the reference's
best. A verdict that is not one the program renders counts as
``malformed``; a request that raised counts as ``failed``.
"""

from __future__ import annotations

import threading
import time

from portbench.reference import text as T
from portbench.reference.encoder import Reference
from portbench.traffic import generator as G
from portbench.weights import Weights
from portbench.window import Window

JOIN_S = 180.0


def _pow2_upto(n: int) -> list:
    out, k = [], 1
    while k <= n:
        out.append(k)
        k *= 2
    return out


class Runner:
    unit = "verdict"

    def __init__(self, run):
        from vainplex_openclaw_tpu_torch.models import serve

        self.run, self.mix = run, run.mix
        self.model = run.config["model"]
        self.seq_len = self.model["seq_len"]
        self.serve = serve
        texts = G.generate(self.mix, run.seed)
        self.weights = Weights(run.root, run.config)
        self.call = serve.make_local_call_llm(
            self.weights.dir, serve_cfg=dict(self.mix.get("serve", {})),
            device=run.device)
        self.batcher = self.call.batcher
        self.prompts = [T.as_prompt(t) for t in texts]
        self.real = [T.real_tokens(t, self.seq_len) for t in texts]
        self.cursor = 0
        self.records: list = []

    # ── set-up ───────────────────────────────────────────────────────

    def warm(self) -> None:
        for k in _pow2_upto(self.batcher.max_batch):
            tickets = [self.batcher.enqueue(T.extract_message(p))
                       for p in self.prompts[:k]]
            for t in tickets:
                if not t.done.wait(JOIN_S):
                    raise TimeoutError("warm-up batch never served")
                if t.error is not None:
                    raise t.error
        self._loop(float(self.mix.get("warmup_s", 1.0)))

    # ── the closed loop ──────────────────────────────────────────────

    def _loop(self, seconds: float, during=None) -> tuple:
        """Run the sessions for ``seconds``; returns (records, t_start,
        deadline). ``during(t_start, deadline)`` runs on this thread
        while the sessions run."""
        S, P = int(self.mix["sessions"]), len(self.prompts)
        recs = [[] for _ in range(S)]
        barrier = threading.Barrier(S + 1)
        clock = {}

        def session(s: int) -> None:
            barrier.wait()
            deadline = clock["deadline"]
            k = 0
            while True:
                i = (self.cursor + s + k * S) % P
                t0 = time.perf_counter()
                if t0 >= deadline:
                    return
                try:
                    verdict, err = self.call(self.prompts[i]), None
                except Exception as exc:  # noqa: BLE001 — counted as failed
                    verdict, err = None, repr(exc)
                recs[s].append((i, t0, time.perf_counter(), verdict, err))
                k += 1

        threads = [threading.Thread(target=session, args=(s,), daemon=True)
                   for s in range(S)]
        for t in threads:
            t.start()
        t_start = time.perf_counter()
        clock["deadline"] = deadline = t_start + seconds
        barrier.wait()
        if during is not None:
            during(t_start, deadline)
        for t in threads:
            t.join(max(0.0, deadline - time.perf_counter()) + JOIN_S)
        if any(t.is_alive() for t in threads):
            raise TimeoutError("a session never got its verdict")
        self.cursor += sum(len(r) for r in recs)
        return [r for rs in recs for r in rs], t_start, deadline

    def _counters(self) -> dict:
        st = self.batcher.stats()
        timer = self.batcher.timer.state()
        return {"served": st["served"], "batches": st["batches"],
                "ms": dict(timer["ms"]), "counts": dict(timer["counts"])}

    def window(self, seconds: float, tracer=None, spans=None,
               profile: dict = None) -> Window:
        marks = {}

        def during(t_start: float, deadline: float) -> None:
            marks["start"] = self._counters()
            if tracer is not None:
                length = float(profile["seconds"])
                begin = t_start + float(profile["skip_s"])
                # a sub-window the profiler hands back empty is followed
                # by another while the window has room for one
                while marks.get("trace") is None \
                        and max(begin, time.perf_counter()) + length \
                        < deadline:
                    time.sleep(max(0.0, begin - time.perf_counter()))
                    tracer.start()
                    time.sleep(length)
                    marks["trace"] = tracer.stop(spans)
            time.sleep(max(0.0, deadline - time.perf_counter()))
            marks["end"] = self._counters()

        recs, t_start, deadline = self._loop(seconds, during)
        self.records = recs
        a, b = marks["start"], marks["end"]
        w = Window(unit=self.unit, span_s=deadline - t_start,
                   max_batch=self.batcher.max_batch, widths=self.model)
        w.attempted = len(recs)
        for i, t0, t1, verdict, err in recs:
            w.latencies_ms.append((t1 - t0) * 1e3)
            if err is None and t1 <= deadline:
                w.units += 1
                w.tokens += self.real[i]
        w.served = b["served"] - a["served"]
        w.batches = b["batches"] - a["batches"]
        w.stages = {k: (b["ms"][k] - a["ms"].get(k, 0.0),
                        b["counts"][k] - a["counts"].get(k, 0))
                    for k in b["ms"]}
        trace = marks.get("trace")
        if trace is not None:
            w.trace = trace
            for i, t0, t1, verdict, err in recs:
                if err is None and t0 >= trace["t0"] and t1 <= trace["t1"]:
                    w.traced_rows.setdefault("K1", []).append(self.real[i])
                    w.all_traced_rows.append(self.real[i])
        return w

    def close(self) -> None:
        from vainplex_openclaw_tpu_torch.models.pretrained import clear_cache

        self.serve.close_batchers()
        clear_cache()

    # ── correctness ──────────────────────────────────────────────────

    def check(self, control: bool = False) -> tuple:
        by_msg: dict = {}
        failed = 0
        for i, t0, t1, verdict, err in self.records:
            if err is not None:
                failed += 1
            else:
                by_msg.setdefault(i, []).append(verdict)
        distinct = sorted(by_msg)
        rng = G.rng_of(self.run.seed, 3)
        k = min(int(self.mix["check"]["sample"]), len(distinct))
        pick = [int(i) for i in rng.choice(distinct, size=k, replace=False)]
        longest = max(distinct, key=lambda i: self.real[i])
        if longest not in pick:
            pick.append(longest)
        tokens = T.encode_texts([T.extract_message(self.prompts[i])
                                 for i in pick], self.seq_len,
                                self.model["vocab_size"])
        ref = Reference(self.weights.arrays, self.model, self.run.device)
        logits = ref.logits(tokens, "severity")
        best = logits.max(dim=1).values
        gap, malformed, compared = 0.0, 0, 0
        for row, i in enumerate(pick):
            for verdict in by_msg[i]:
                cls = T.VERDICT_CLASS.get(verdict)
                if cls is None:
                    malformed += 1
                    continue
                compared += 1
                gap = max(gap, float(best[row] - logits[row, cls]))
        out = {"verdict_gap": gap, "malformed": malformed, "failed": failed}
        info = {"compared": compared, "messages": len(pick),
                "longest_tokens": self.real[longest]}
        low = None
        if control:
            cls = Reference(self.weights.arrays, self.model, self.run.device,
                            precision="fp8").logits(
                tokens, "severity").argmax(dim=1)
            low = {**out, "malformed": 0, "verdict_gap": float(
                (best - logits.gather(1, cls[:, None])[:, 0]).max())}
        return out, info, low
