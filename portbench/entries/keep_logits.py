"""Runner of the trace analyzer's classify step:
``cortex/trace_analyzer/classifier.py``'s ``keep_logits``, the entry of
``local_triage``, called back to back from one thread, one analysis run's
findings a call.

Set-up warms each pow2 bucket the pool's calls fall in, with the first
call of that bucket. The window runs whole calls until ``--seconds`` have
passed; the rate is every finding of those calls over the time from the
window's start to the end of its last call.

The check, once the window has closed and the program is shut: a sample
drawn from the seed of the findings of the pool's calls goes through the
reference (the same frozen finding text, tokenizer and encoder) once, and
``keep_logit_err`` is the largest absolute difference between a keep
logit the window returned for a sampled finding and the reference's, over
every call of the window that carried it (the pool repeats, so each is
compared as often as the window sent it). Every finding of a call that
raised counts as ``failed``.
"""

from __future__ import annotations

import time

from portbench.reference import text as T
from portbench.reference.encoder import Reference
from portbench.traffic import generator as G
from portbench.weights import Weights
from portbench.window import Window


def _bucket(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


class Runner:
    unit = "finding"

    def __init__(self, run):
        from vainplex_openclaw_tpu_torch.cortex.trace_analyzer import \
            classifier

        self.run, self.mix = run, run.mix
        self.model = run.config["model"]
        self.classifier = classifier
        self.weights = Weights(run.root, run.config)
        self.calls = G.generate(self.mix, run.seed)
        self.real = [[T.real_tokens(T.finding_text(f), self.model["seq_len"])
                      for f in call] for call in self.calls]
        self.cursor = 0
        self.records: list = []

    def _keep(self, call: list):
        return self.classifier.keep_logits(call, self.weights.dir,
                                           device=self.run.device)

    def warm(self) -> None:
        seen = set()
        for call in self.calls:
            if _bucket(len(call)) not in seen:
                seen.add(_bucket(len(call)))
                self._keep(call)

    def window(self, seconds: float, tracer=None, spans=None,
               profile: dict = None) -> Window:
        recs, trace = [], None
        t_start = time.perf_counter()
        deadline = t_start + seconds
        begin = t_start + float(profile["skip_s"]) if tracer else None
        length = float(profile["seconds"]) if tracer else None
        tracing = False
        k = 0
        while True:
            t0 = time.perf_counter()
            if t0 >= deadline:
                break
            # a sub-window the profiler hands back empty is followed by
            # another while the window has room for one
            if tracer is not None and trace is None and not tracing \
                    and t0 >= begin and t0 + length < deadline:
                tracer.start()
                tracing = True
                t0 = time.perf_counter()
            i = (self.cursor + k) % len(self.calls)
            try:
                out, err = self._keep(self.calls[i]), None
            except Exception as exc:  # noqa: BLE001 — counted as failed
                out, err = None, repr(exc)
            t1 = time.perf_counter()
            recs.append((i, t0, t1, out, err))
            k += 1
            if tracing and t1 >= tracer.t0 + length:
                trace = tracer.stop(spans)
                tracing = False
        if tracing:
            trace = tracer.stop(spans)
        self.cursor += k
        self.records = recs
        t_end = recs[-1][2] if recs else deadline
        w = Window(unit=self.unit, span_s=t_end - t_start, widths=self.model)
        for i, t0, t1, out, err in recs:
            w.latencies_ms.append((t1 - t0) * 1e3)
            w.attempted += len(self.calls[i])
            if err is None:
                w.units += len(self.calls[i])
                w.tokens += sum(self.real[i])
        if trace is not None:
            w.trace = trace
            for i, t0, t1, out, err in recs:
                if err is None and t0 >= trace["t0"] and t1 <= trace["t1"]:
                    w.traced_rows.setdefault("K1", []).extend(self.real[i])
                    w.all_traced_rows.extend(self.real[i])
        return w

    def close(self) -> None:
        from vainplex_openclaw_tpu_torch.models.pretrained import clear_cache

        clear_cache()

    def check(self, control: bool = False) -> tuple:
        got, failed = {}, 0
        for i, t0, t1, out, err in self.records:
            if err is not None:
                failed += len(self.calls[i])
            else:
                got.setdefault(i, []).append(out)
        pairs = [(i, j) for i in sorted(got)
                 for j in range(len(self.calls[i]))]
        rng = G.rng_of(self.run.seed, 3)
        k = min(int(self.mix["check"]["sample"]), len(pairs))
        pick = [pairs[int(p)] for p in rng.choice(len(pairs), size=k,
                                                  replace=False)]
        tokens = T.encode_texts([T.finding_text(self.calls[i][j])
                                 for i, j in pick], self.model["seq_len"],
                                self.model["vocab_size"])
        ref = Reference(self.weights.arrays, self.model, self.run.device)
        want = ref.logits(tokens, "keep")
        rows: dict = {}   # call -> (rows of the sample, its findings)
        for r, (i, j) in enumerate(pick):
            rows.setdefault(i, ([], []))
            rows[i][0].append(r)
            rows[i][1].append(j)
        err, compared = 0.0, 0
        for i, (r, j) in rows.items():
            w = want[r]
            for out in got[i]:
                err = max(err, float((out[j] - w).abs().max()))
                compared += len(j)
        out = {"keep_logit_err": err, "failed": failed}
        info = {"compared": compared, "findings": len(pick),
                "calls": sum(len(o) for o in got.values())}
        low = None
        if control:
            fp8 = Reference(self.weights.arrays, self.model, self.run.device,
                            precision="fp8").logits(tokens, "keep")
            low = {**out, "keep_logit_err": float((fp8 - want).abs().max())
                   if pick else 0.0}
        return out, info, low
