"""TraceAnalyzer orchestrator + gateway wiring: the port's copy of
``vainplex_openclaw_tpu/cortex/trace_analyzer/analyzer.py``.

Run: load state → source → fetch batches (incremental from last seq) →
reconstruct chains → detect signals → optional classify → outputs →
clusters → report → persist state → close. No source → graceful empty
report. The device stages run on ``device`` (default: the card, resolved
when the analyzer is built, so a process without one raises there): the
doom-loop detectors' batched Levenshtein (K3), local triage (the encoder,
its attention through K1) and the Jaccard blocks of the clusterer.

Two deviations from the JAX analyzer:

- ``classify.useLocalTriage: None`` (auto) turns local triage on when the
  shipped checkpoint is present (``models.pretrained.available()``). JAX
  also asks ``utils/jax_safety.backend_init_safe()``; the port has no such
  guard, since no entry point starts a backend by itself.
- The cluster stage still costs the run only its clusters when the
  clusterer fails, as in JAX, but an error from the device
  (``device.is_device_error``) propagates instead of being logged away;
  the per-detector catch of ``detect_all_signals`` is narrowed the same
  way.

A gateway reaches this analyzer through its public plugin API:
``register_trace_analyzer(api, TraceAnalyzer(...))`` on the ``PluginApi``
that ``Gateway.load`` returns registers ``/trace-analyze``.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Callable

from ...config.loader import deep_merge
from ...core.api import PluginCommand, PluginService
from ...device import DeviceLike, is_device_error, resolve_device
from ...models.pretrained import available
from ...utils.stage_timer import StageTimer
from .chains import reconstruct_chains
from .classifier import ClassifiedFinding, classify_findings
from .clusters import IncrementalClusterer, cluster_failure_signals
from .outputs import generate_outputs
from .report import ProcessingState, assemble_report, rule_effectiveness, save_report
from .signal_patterns import compile_signal_patterns
from .signals import detect_all_signals
from .source import create_nats_trace_source

DEFAULT_ANALYZER_CONFIG = {
    "enabled": True,
    "languages": ["en", "de"],
    "fetchBatchSize": 500,
    "maxEventsPerRun": 100_000,
    "gapMinutes": 30,
    "maxEventsPerChain": 1000,
    "signals": {},            # per-signal {enabled, severity}
    # useLocalTriage: None = auto — on exactly when the shipped trained
    # checkpoint is present (models/pretrained.py); operators can still
    # pin True/False explicitly.
    "classify": {"enabled": False, "useLocalTriage": None},
    # incremental: persist cluster features/assignments in the state dir and
    # compute only the new-rows × all-rows block per run (clusters.py) —
    # clusters then cover every run since state creation, not just this
    # one's batch. False restores the stateless per-run batch path.
    "cluster": {"incremental": True},
    "scheduleMinutes": 0,     # 0 = manual only
    "natsUrl": None,
    "stream": "CLAW_EVENTS",
}


class TraceAnalyzer:
    def __init__(self, config: dict, state_dir: str | Path, logger,
                 source=None, triage_llm=None, deep_llm=None,
                 clock: Callable[[], float] = time.time,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.config = deep_merge(DEFAULT_ANALYZER_CONFIG, config or {})
        self.state_dir = Path(state_dir)
        self.logger = logger
        self.clock = clock
        self._source = source
        self.triage_llm = triage_llm
        self.deep_llm = deep_llm
        self.patterns = compile_signal_patterns(self.config["languages"])

    def _get_source(self):
        if self._source is not None:
            return self._source
        url = self.config.get("natsUrl")
        if url:
            return create_nats_trace_source(url, self.config.get("stream"), self.logger)
        return None

    def run(self) -> dict:
        start = time.perf_counter()
        state = ProcessingState.load(self.state_dir)
        source = self._get_source()

        if source is None:
            self.logger.warn("trace analyzer: no event source; emitting empty report")
            report = assemble_report(
                {"events": 0, "chains": 0, "signals": 0, "durationMs": 0.0,
                 "eventsPerMinute": 0.0, "incrementalFromSeq": state.last_processed_seq},
                [], [], [], [], self.clock)
            save_report(report, self.state_dir)
            return report

        timer = StageTimer()
        try:
            with timer.stage("normalize"):
                events = list(source.fetch(
                    start_seq=state.last_processed_seq,
                    batch_size=self.config["fetchBatchSize"],
                    max_events=self.config["maxEventsPerRun"]))
            with timer.stage("chains"):
                chains = reconstruct_chains(events,
                                            gap_minutes=self.config["gapMinutes"],
                                            max_events_per_chain=self.config["maxEventsPerChain"])
            with timer.stage("signals"):
                signals = detect_all_signals(chains, self.patterns,
                                             self.config.get("signals"), self.logger,
                                             device=self.device)

            classified = []
            ccfg = self.config.get("classify", {})
            with timer.stage("classify"):
                if signals and (ccfg.get("enabled") or self.triage_llm or self.deep_llm):
                    chains_by_id = {c.id: c for c in chains}
                    use_local = ccfg.get("useLocalTriage")
                    if use_local is None:
                        # auto: on iff trained weights shipped
                        use_local = available()
                    classified = classify_findings(
                        signals, chains_by_id, self.triage_llm, self.deep_llm,
                        self.logger, use_local_triage=bool(use_local),
                        device=self.device)
                else:
                    classified = [ClassifiedFinding(s, True, s.severity) for s in signals]

            with timer.stage("outputs"):
                outputs = generate_outputs(classified)
            # Clustering is an optional enrichment stage: like the per-
            # detector try/catch, a fault of the clusterer must never cost the
            # run its report; an error from the device propagates.
            cluster_stats: dict = {}
            with timer.stage("cluster"):
                try:
                    if (self.config.get("cluster") or {}).get("incremental", True):
                        clusters = IncrementalClusterer(
                            self.state_dir, logger=self.logger,
                            device=self.device).update(
                                signals, stats=cluster_stats)
                    else:
                        clusters = cluster_failure_signals(
                            signals, logger=self.logger, stats=cluster_stats,
                            device=self.device)
                except Exception as exc:  # noqa: BLE001
                    if is_device_error(exc):
                        raise
                    self.logger.error(f"failure clustering failed: {exc}")
                    clusters, cluster_stats = [], {}

            with timer.stage("report"):
                signal_counts: dict = {}
                for s in signals:
                    signal_counts[s.signal] = signal_counts.get(s.signal, 0) + 1
                effectiveness = rule_effectiveness(state, signal_counts)

            duration_ms = (time.perf_counter() - start) * 1000
            events_per_minute = (len(events) / (duration_ms / 60_000)) if duration_ms > 0 else 0.0
            stage_ms = timer.stages_ms()
            run_stats = {
                "events": len(events), "chains": len(chains), "signals": len(signals),
                "durationMs": round(duration_ms, 2),
                "eventsPerMinute": round(events_per_minute, 1),
                "incrementalFromSeq": state.last_processed_seq,
                "stageMs": stage_ms,
            }
            t_persist = time.perf_counter()
            report = assemble_report(run_stats, signals, classified, outputs,
                                     effectiveness, self.clock, clusters=clusters,
                                     clusters_truncated=cluster_stats.get("truncated", 0))
            save_report(report, self.state_dir)

            if events:
                state.last_processed_seq = max(e.seq for e in events)
                state.last_processed_ts = max(e.ts for e in events)
            state.total_events_processed += len(events)
            state.total_runs += 1
            state.save(self.state_dir)
            # Fold report assembly + persistence into the report stage of the
            # RETURNED stats (stage_ms is the dict inside the report): the
            # saved file can't time its own write, so on disk "report" covers
            # effectiveness only — callers on the return path (the
            # /trace-analyze summary) see the full cost.
            stage_ms["report"] = round(
                stage_ms.get("report", 0.0)
                + (time.perf_counter() - t_persist) * 1000.0, 2)
            self.logger.info(
                f"trace analysis: {len(events)} events → {len(chains)} chains → "
                f"{len(signals)} signals ({run_stats['eventsPerMinute']:.0f} ev/min)")
            return report
        finally:
            source.close()


def register_trace_analyzer(api, analyzer: TraceAnalyzer,
                            wall_timers: bool = True) -> None:
    """Wire the analyzer: /trace-analyze command + optional schedule."""
    api.register_command(PluginCommand(
        name="trace-analyze", description="Run trace analysis now",
        handler=lambda ctx: {"text": _summary_text(analyzer.run())}))

    minutes = analyzer.config.get("scheduleMinutes") or 0
    if minutes > 0 and wall_timers:
        import threading

        stop = threading.Event()

        def loop():
            while not stop.wait(minutes * 60):
                try:
                    analyzer.run()
                except Exception as exc:  # noqa: BLE001
                    api.logger.error(f"scheduled trace analysis failed: {exc}")

        thread = threading.Thread(target=loop, daemon=True, name="trace-analyzer")
        api.register_service(PluginService(
            id="trace-analyzer",
            start=lambda ctx: thread.start(),
            stop=lambda ctx: stop.set()))


def _summary_text(report: dict) -> str:
    rs = report["runStats"]
    lines = [f"🔍 trace analysis: {rs['events']} events → {rs['chains']} chains → "
             f"{rs['signals']} signals in {rs['durationMs']}ms "
             f"({rs['eventsPerMinute']:.0f} ev/min)"]
    stage_ms = rs.get("stageMs") or {}
    if stage_ms:
        lines.append("  stages: " + " ".join(
            f"{name}={ms:.0f}ms" for name, ms in stage_ms.items()))
    for signal, stats in report["signalStats"].items():
        lines.append(f"  {signal}: {stats['count']}")
    for cluster in report.get("failureClusters", [])[:3]:
        lines.append(f"  ≈ cluster ×{cluster['size']} across "
                     f"{len(cluster['chains'])} chains "
                     f"[{', '.join(cluster['tools'])}]: {cluster['sample'][:80]}")
    for output in report["outputs"][:5]:
        lines.append(f"  → [{output['actionType']}] {output['actionText'][:80]} "
                     f"(×{output['observations']})")
    return "\n".join(lines)
