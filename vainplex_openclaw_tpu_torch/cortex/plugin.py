"""Cortex plugin: hook wiring + /cortexstatus + agent tools
(reference: cortex/index.ts:11-90, src/hooks.ts:57-258).

Hook layout: message_received/message_sent @100 feed the trackers;
agent_end @150 is a fallback ingest that only fires if message_sent never
did for the session; session_start @10 injects boot context;
before_compaction @5 runs the snapshot pipeline. Tracker instances are held
per-workspace in a map (multi-workspace gateways). Per-hook fire/error
diagnostics come from the kernel's HookBus stats.

The port's copy of ``vainplex_openclaw_tpu/cortex/plugin.py``, with JAX's
``MANIFEST``, ``DEFAULTS``, hooks and priorities, and these deviations:

- ``CortexPlugin(device=None)`` names the trace analyzer's device (the
  card by default; tests pass ``device="cpu"``), so with
  ``traceAnalyzer.enabled`` a process without a card raises at
  ``register``. ``/trace-analyze`` then runs the doom-loop detectors' K3
  and local triage's K1 on that device;
- every hook handler's catch (``message_received``'s ingest,
  ``message_sent``, ``agent_end``, ``session_start``,
  ``before_compaction``, and ``gateway_stop``'s flush) re-raises an error
  of the device (``device.is_device_error``), where the JAX package logs
  it and returns ``None``; every other error keeps JAX's log line and
  result. With the enhancer's and pre-compaction's own narrowed catches
  (``llm_enhance.py``, ``pre_compaction.py``) a failed launch behind an
  injected ``call_llm`` reaches the caller of ``Gateway.message_received``.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from ..config.loader import load_plugin_config
from ..config.manifest import PluginManifest, enabled_section
from ..core.api import PluginCommand
from ..device import DeviceLike, is_device_error
from ..resilience.faults import maybe_fail
from ..storage.journal import get_journal, journal_settings
from ..storage.lifecycle import LifecycleManager, lifecycle_settings
from ..utils.stage_timer import StageTimer
from .boot_context import BootContextGenerator
from .commitment_tracker import CommitmentTracker
from .decision_tracker import DecisionTracker
from .llm_enhance import LlmEnhancer
from .patterns import MergedPatterns, fold_lower, resolve_language_codes
from .pre_compaction import PreCompaction
from .thread_tracker import ThreadTracker
from .tools import register_cortex_tools

DEFAULTS = {
    "enabled": True,
    "workspace": None,
    "languages": "both",  # "both"=en+de, "all"=10, or explicit list
    "customPatterns": {},
    # False restores the interpreter ingest path end-to-end (per-regex walks
    # + naive thread matching) — the escape hatch for the compiled prefilter
    # banks and inverted thread index.
    "compiledPatterns": True,
    "threads": {"enabled": True, "pruneDays": 7, "maxThreads": 50},
    "decisions": {"enabled": True, "dedupeWindowHours": 24},
    "commitments": {"enabled": True, "overdueDays": 7},
    "bootContext": {"enabled": True, "maxChars": 16_000, "maxThreads": 10,
                    "decisionDays": 3, "maxDecisions": 10},
    "preCompaction": {"maxSnapshotMessages": 15},
    "narrative": {"enabled": True},
    "llmEnhance": {"enabled": False, "batchSize": 3},
    "registerTools": True,
    "traceAnalyzer": {"enabled": False},
    # Group-commit write-ahead journal: per-message tracker
    # persists append to the shared workspace journal instead of paying an
    # atomic rename each message. ``storage.journal: false`` restores the
    # legacy write-per-message path end-to-end (the durability oracle).
    # Workspace lifecycle: snapshot shipping + segment tiering
    # on the journal, LRU hibernation of idle workspace trackers.
    # ``storage.lifecycle: false`` restores the full-replay journal behavior.
    "storage": {"journal": True, "lifecycle": True},
}

MANIFEST = PluginManifest(
    id="cortex",
    description="Conversation intelligence: threads, decisions, commitments, "
                "boot context, pre-compaction snapshots, trace analyzer",
    config_schema={
        "type": "object",
        "properties": {
            "enabled": {"type": "boolean"},
            "workspace": {"type": ["string", "null"]},
            "languages": {"type": ["string", "array"],
                          "items": {"type": "string"}},
            "customPatterns": {"type": "object"},
            "compiledPatterns": {"type": "boolean"},
            "threads": enabled_section(
                pruneDays={"type": "number", "minimum": 0},
                maxThreads={"type": "integer", "minimum": 1}),
            "decisions": enabled_section(
                dedupeWindowHours={"type": "number", "minimum": 0}),
            "commitments": enabled_section(
                overdueDays={"type": "number", "minimum": 0}),
            "bootContext": enabled_section(
                maxChars={"type": "integer", "minimum": 100},
                maxThreads={"type": "integer", "minimum": 1},
                decisionDays={"type": "number", "minimum": 0},
                maxDecisions={"type": "integer", "minimum": 0}),
            "preCompaction": {"type": "object", "properties": {
                "maxSnapshotMessages": {"type": "integer", "minimum": 1}}},
            "narrative": enabled_section(),
            "llmEnhance": enabled_section(
                batchSize={"type": "integer", "minimum": 1}),
            "registerTools": {"type": "boolean"},
            "storage": {"type": "object", "properties": {
                "journal": {"type": ["boolean", "object"]},
                "lifecycle": {"type": ["boolean", "object"]}}},
            "traceAnalyzer": enabled_section(
                languages={"type": "array", "items": {"type": "string"}},
                fetchBatchSize={"type": "integer", "minimum": 1},
                maxEventsPerRun={"type": "integer", "minimum": 1},
                gapMinutes={"type": "number", "minimum": 0},
                maxEventsPerChain={"type": "integer", "minimum": 1},
                signals={"type": "object"},
                classify={"type": "object"},
                scheduleMinutes={"type": "number", "minimum": 0},
                natsUrl={"type": ["string", "null"]},
                stream={"type": "string"}),
        },
    },
    commands=("cortexstatus", "trace-analyze"),
    gateway_methods=("cortex.patternSafety",),
    hooks=("message_received", "message_sent", "agent_end", "session_start",
           "before_compaction", "gateway_stop"),
)


class _WorkspaceTrackers:
    def __init__(self, workspace: str, config: dict, patterns: MergedPatterns,
                 logger, clock, wall_timers: bool, call_llm=None,
                 lifecycle_cfg: Optional[dict] = None, lifecycle_timer=None):
        self.workspace = workspace
        # One shared StageTimer per workspace: extract/mood/threads/
        # decisions/commitments/persist accumulate into a single breakdown
        # surfaced by status_text()/cortexstatus.
        self.timer = StageTimer()
        # Shared per-workspace group-commit journal — the same
        # instance knowledge/governance/events use for this workspace, so
        # one fsync covers every edge's records. None (escape hatch or an
        # unopenable journal dir) keeps every tracker on its legacy path.
        # The lifecycle settings arm snapshot shipping + segment
        # tiering on the shared instance (first creator wins, like the rest
        # of the journal settings).
        js = journal_settings(config)
        self.journal = (get_journal(workspace, js, clock=clock,
                                    wall=wall_timers, logger=logger,
                                    lifecycle=lifecycle_cfg,
                                    lifecycle_timer=lifecycle_timer)
                        if js["enabled"] else None)
        self.threads = ThreadTracker(workspace, config["threads"], patterns, logger,
                                     clock, timer=self.timer, journal=self.journal)
        self.decisions = DecisionTracker(workspace, config["decisions"], patterns, logger,
                                         clock, timer=self.timer,
                                         journal=self.journal)
        self.commitments = CommitmentTracker(workspace, config["commitments"], logger,
                                             clock, wall_timers=wall_timers,
                                             timer=self.timer,
                                             journal=self.journal)
        self.pre_compaction = PreCompaction(workspace, config, logger, self.threads,
                                            self.decisions, self.commitments, clock)
        self.message_sent_fired = False
        # One enhancer per workspace: batches must not mix content across
        # workspaces (cross-workspace leak + misattributed analysis otherwise).
        self.enhancer = None
        if config.get("llmEnhance", {}).get("enabled") and call_llm is not None:
            self.enhancer = LlmEnhancer(call_llm, logger,
                                        config["llmEnhance"].get("batchSize", 3))

    def flush(self) -> None:
        for tracker in (self.threads, self.decisions, self.commitments):
            tracker.flush()

    def hibernate(self) -> None:
        """Evict this workspace down to its journaled snapshot:
        flush every tracker, ship a durable snapshot (legacy files current +
        durable watermark), then close the shared journal so the next
        ``get_journal`` opens fresh and replays — the wake path IS the
        recovery path. Raises ``OSError`` while anything failed to flush:
        the LifecycleManager keeps the workspace RESIDENT on failure, so a
        broken disk degrades to no-eviction, never to dropped state."""
        ok = True
        for tracker in (self.threads, self.decisions, self.commitments):
            ok = tracker.flush() and ok
        if self.journal is not None:
            ok = self.journal.ship_snapshot() and ok
        if not ok:
            raise OSError(f"hibernate {self.workspace}: flush incomplete")
        self.commitments._debouncer.stop()
        if self.journal is not None:
            self.journal.close()


class CortexPlugin:
    id = "cortex"
    manifest = MANIFEST

    def __init__(self, workspace: Optional[str] = None,
                 clock: Callable[[], float] = time.time,
                 call_llm=None, wall_timers: bool = True, trace_source=None,
                 device: DeviceLike = None):
        self._workspace_override = workspace
        self.device = device              # the trace analyzer's device
        self.clock = clock
        self.call_llm = call_llm
        self.wall_timers = wall_timers
        self.trace_source = trace_source  # DI'd TraceSource (event-store bridge)
        self.trace_analyzer = None
        self.config: dict = {}
        self.patterns: Optional[MergedPatterns] = None
        self._trackers: dict[str, _WorkspaceTrackers] = {}
        self._api = None
        # Workspace lifecycle: None = storage.lifecycle:false —
        # no hibernation, journals keep the full-replay journal behavior.
        self.lifecycle: Optional[LifecycleManager] = None
        self._lifecycle_cfg: Optional[dict] = None

    def register(self, api) -> None:
        self.config = load_plugin_config(self.id, api.plugin_config,
                                         defaults=DEFAULTS, logger=api.logger)
        if not self.config.get("enabled", True):
            api.logger.info("disabled via config")
            return
        self._api = api
        self.logger = api.logger
        codes = resolve_language_codes(self.config.get("languages"))
        compiled = self.config.get("compiledPatterns", True)
        self.patterns = MergedPatterns(codes, self.config.get("customPatterns"),
                                       logger=api.logger, compiled=compiled)
        api.logger.info(f"patterns loaded: {','.join(codes)}"
                        + ("" if compiled else " (interpreter path)"))
        ls = lifecycle_settings(self.config)
        if ls["enabled"]:
            self._lifecycle_cfg = ls
            self.lifecycle = LifecycleManager(ls, clock=self.clock,
                                              logger=api.logger)
            if hasattr(api, "register_lifecycle"):
                api.register_lifecycle("cortex", self.lifecycle)

        api.on("message_received", self._make_ingest("user"), priority=100)
        api.on("message_sent", self._on_message_sent, priority=100)
        api.on("agent_end", self._on_agent_end, priority=150)
        api.on("session_start", self._on_session_start, priority=10)
        api.on("before_compaction", self._on_before_compaction, priority=5)
        api.on("gateway_stop", self._on_gateway_stop, priority=900)

        api.register_command(PluginCommand(
            name="cortexstatus", description="Cortex tracker status",
            handler=lambda ctx: {"text": self.status_text()}))
        # ReDoS screening surface: the sitrep pattern_safety
        # collector merges these with governance's planner reports so a
        # demoted cortex custom pattern is visible on /ops, not only in
        # cortexstatus.
        api.register_gateway_method(
            "cortex.patternSafety",
            lambda: list(self.patterns.unsafe) if self.patterns else [])

        if self.config.get("registerTools", True) and hasattr(api, "register_tool"):
            register_cortex_tools(api, self._workspace_for)

        ta_cfg = self.config.get("traceAnalyzer", {})
        if ta_cfg.get("enabled"):
            from .trace_analyzer.analyzer import TraceAnalyzer, register_trace_analyzer

            ws = self._workspace_for({})
            self.trace_analyzer = TraceAnalyzer(
                ta_cfg, ws, api.logger, source=self.trace_source,
                triage_llm=self.call_llm if ta_cfg.get("classify", {}).get("enabled") else None,
                deep_llm=self.call_llm if ta_cfg.get("classify", {}).get("enabled") else None,
                clock=self.clock, device=self.device)
            register_trace_analyzer(api, self.trace_analyzer,
                                    wall_timers=self.wall_timers)

    # ── workspace/tracker resolution ─────────────────────────────────

    def _workspace_for(self, ctx: dict) -> str:
        return str(ctx.get("workspace") or self._workspace_override
                   or self.config.get("workspace") or ".")

    def trackers(self, ctx: dict) -> _WorkspaceTrackers:
        ws = self._workspace_for(ctx)
        tr = self._trackers.get(ws)
        if tr is None:
            # Wake path: identical to first-sight construction —
            # the journal open replays last-snapshot + wal tail, the
            # trackers load the compacted files. ``lifecycle.wake`` faults
            # fire BEFORE construction so a crashed wake leaves no
            # half-built entry; the hook's fail-open catch retries on the
            # next message.
            waking = self.lifecycle is not None and self.lifecycle.is_sleeping(ws)
            t0 = time.perf_counter()
            if waking:
                maybe_fail("lifecycle.wake")
            lc_timer = (self.lifecycle.timer_for(ws)
                        if self.lifecycle is not None else None)
            tr = _WorkspaceTrackers(ws, self.config, self.patterns,
                                    self.logger, self.clock,
                                    self.wall_timers, self.call_llm,
                                    lifecycle_cfg=self._lifecycle_cfg,
                                    lifecycle_timer=lc_timer)
            self._trackers[ws] = tr
            if self._api is not None and hasattr(self._api, "register_stage_timer"):
                # Per-workspace edge in the observability registry;
                # keyed by workspace so a multi-tenant gateway's sitrep can
                # attribute latency to the tenant that paid it.
                self._api.register_stage_timer(f"cortex:{ws}", tr.timer)
            journal = tr.journal
            if (journal is not None and self._api is not None
                    and hasattr(self._api, "register_journal")):
                # Journal stats surface: pending/group/
                # fsync/compaction/replay counters through Gateway.get_status
                # and the sitrep journal collector; quantiles via the
                # journal's own StageTimer.
                self._api.register_journal(f"journal:{ws}", journal)
                self._api.register_stage_timer(f"journal:{ws}", journal.timer)
            if self.lifecycle is not None:
                self.lifecycle.register(ws, lambda w=ws: self._hibernate_workspace(w),
                                        owner="cortex")
                if (self._api is not None
                        and hasattr(self._api, "register_stage_timer")
                        and lc_timer is not None):
                    self._api.register_stage_timer(f"lifecycle:{ws}", lc_timer)
                if waking:
                    self.lifecycle.note_wake(
                        ws, (time.perf_counter() - t0) * 1000.0)
        if self.lifecycle is not None:
            base = self._workspace_for({})
            for victim in self.lifecycle.note_traffic(ws):
                if victim == base:
                    # The plugin's own base workspace never self-evicts: a
                    # single-workspace gateway must not hibernate the
                    # journal its co-plugins (governance audit, events)
                    # share mid-flight.
                    continue
                self.lifecycle.hibernate(victim)
        return tr

    def release_workspace(self, ws: str) -> bool:
        """Planned-handoff barrier: flush-ship-close the
        workspace's trackers and drop them from this plugin's cache —
        hibernation's eviction path invoked *deliberately*, so ownership
        can move to another worker with zero replay and this plugin keeps
        no stale tracker state to flush over the new owner's later. A
        workspace that was never woken here is already released."""
        ws = str(ws)
        if ws not in self._trackers:
            return True
        if self.lifecycle is not None:
            return self.lifecycle.hibernate(ws)
        try:
            self._hibernate_workspace(ws)
            return True
        except OSError:
            return False

    def _hibernate_workspace(self, ws: str) -> None:
        """LifecycleManager eviction callback: flush-ship-close the
        workspace's trackers and drop every per-workspace registry entry so
        a sleeping workspace costs neither RAM nor registry growth. Raises
        ``OSError`` (kept resident by the manager) when the flush failed."""
        tr = self._trackers.get(ws)
        if tr is None:
            return
        tr.hibernate()  # raises before anything is dropped on failure
        del self._trackers[ws]
        if self._api is not None and hasattr(self._api, "unregister_stage_timer"):
            self._api.unregister_stage_timer(f"cortex:{ws}")
            self._api.unregister_stage_timer(f"journal:{ws}")
            self._api.unregister_stage_timer(f"lifecycle:{ws}")
            self._api.unregister_journal(f"journal:{ws}")

    # ── hook handlers (every one fail-open) ──────────────────────────

    def _process(self, trackers: _WorkspaceTrackers, content: str, sender: str) -> None:
        # One fold-guard scan + lowercase copy per message, shared by the
        # thread AND decision trackers' prefilter screens, so neither
        # tracker recomputes it on the same content.
        low = (fold_lower(content)
               if content and self.patterns is not None and self.patterns.compiled
               else None)
        if self.config["threads"].get("enabled", True):
            trackers.threads.process_message(content, sender, low)
        if self.config["decisions"].get("enabled", True):
            trackers.decisions.process_message(content, sender, low)
        if self.config["commitments"].get("enabled", True):
            trackers.commitments.process_message(content, sender)
        if trackers.enhancer is not None:
            analysis = trackers.enhancer.add_message(content, sender)
            if analysis:
                trackers.threads.apply_llm_analysis(analysis)
                if analysis.get("decisions"):
                    trackers.decisions.add_llm_decisions(analysis["decisions"])

    def _make_ingest(self, sender: str):
        def handler(event: dict, ctx: dict):
            try:
                self._process(self.trackers(ctx), event.get("content") or "", sender)
            except Exception as exc:  # noqa: BLE001
                if is_device_error(exc):
                    raise
                self.logger.error(f"ingest failed: {exc}")
            return None

        return handler

    def _on_message_sent(self, event: dict, ctx: dict):
        try:
            trackers = self.trackers(ctx)
            trackers.message_sent_fired = True
            self._process(trackers, event.get("content") or "", "agent")
        except Exception as exc:  # noqa: BLE001
            if is_device_error(exc):
                raise
            self.logger.error(f"message_sent failed: {exc}")
        return None

    def _on_agent_end(self, event: dict, ctx: dict):
        """Fallback ingest: only when message_sent never fired (reference
        hooks.ts:167-213 — some channels skip message_sent)."""
        try:
            trackers = self.trackers(ctx)
            if trackers.message_sent_fired:
                return None
            content = event.get("final_message") or event.get("content") or ""
            if content:
                self._process(trackers, content, "agent")
        except Exception as exc:  # noqa: BLE001
            if is_device_error(exc):
                raise
            self.logger.error(f"agent_end failed: {exc}")
        return None

    def _on_session_start(self, event: dict, ctx: dict):
        try:
            if not self.config.get("bootContext", {}).get("enabled", True):
                return None
            ws = self._workspace_for(ctx)
            boot = BootContextGenerator(ws, self.config.get("bootContext", {}),
                                        self.logger, self.clock)
            # Regenerate fresh every session start (reference hooks.ts:170-181)
            # — a stale pre-compaction BOOTSTRAP.md must not freeze context,
            # and staleness warnings only surface through regeneration.
            context = boot.generate()
            boot.write()
            return {"prepend_context": context} if context else None
        except Exception as exc:  # noqa: BLE001
            if is_device_error(exc):
                raise
            self.logger.error(f"session_start failed: {exc}")
            return None

    def _on_before_compaction(self, event: dict, ctx: dict):
        try:
            trackers = self.trackers(ctx)
            result = trackers.pre_compaction.run(event.get("messages"))
            return {"snapshotted": result.messages_snapshotted,
                    "warnings": result.warnings}
        except Exception as exc:  # noqa: BLE001
            if is_device_error(exc):
                raise
            self.logger.error(f"before_compaction failed: {exc}")
            return None

    def _on_gateway_stop(self, event: dict, ctx: dict):
        for trackers in self._trackers.values():
            try:
                trackers.flush()
            except Exception as exc:  # noqa: BLE001
                if is_device_error(exc):
                    raise
                self.logger.error(f"flush failed: {exc}")
        return None

    # ── status ───────────────────────────────────────────────────────

    def status_text(self) -> str:
        lines = ["🧠 cortex:"]
        if self.lifecycle is not None:
            ls = self.lifecycle.stats()
            lines.append(f"  lifecycle: resident={ls['resident']} "
                         f"hibernated={ls['hibernated']} wakes={ls['wakes']} "
                         f"wakeP99={ls['wakeP99Ms']}ms")
        if self.patterns is not None and self.patterns.unsafe:
            lines.append(
                f"  ⚠ {len(self.patterns.unsafe)} ReDoS-unsafe pattern(s) "
                f"demoted to interpreter path: "
                + ", ".join(f"{e['category']}:{e['pattern']!r}"
                            for e in self.patterns.unsafe[:3]))
        if not self._trackers:
            lines.append("  (no workspaces active yet)")
        for ws, trackers in self._trackers.items():
            c = trackers.threads.counts()
            lines.append(f"  {ws}: open={c['open']} closed={c['closed']} "
                         f"mood={c['mood']} events={c['events']} "
                         f"decisions={len(trackers.decisions.decisions)} "
                         f"commitments={len(trackers.commitments.open_commitments())}")
            snap = trackers.timer.snapshot()  # one lock: ms + quantiles agree
            if snap["stages_ms"]:
                lines.append(f"  {ws} stage ms: {snap['stages_ms']}")
                p99 = {k: q["p99"] for k, q in snap["quantiles"].items()}
                lines.append(f"  {ws} stage p99 ms: {p99}")
            if trackers.journal is not None:
                js = trackers.journal.stats()
                lines.append(
                    f"  {ws} journal: pending={js['pendingRecords']} "
                    f"commits={js['commits']} avgGroup={js['avgGroupSize']} "
                    f"fsyncs={js['fsyncs']} compactions={js['compactions']} "
                    f"spilled={js['spilled']}")
        if self._api is not None:
            # Public degradation surface: also tells the operator
            # when the gateway is shedding cortex's own hooks.
            status = self._api.get_gateway_status()
            hooks = status["hooks"]
            fired = {h: s["fired"] for h, s in hooks.items() if s["fired"]}
            errors = {h: s["errors"] for h, s in hooks.items() if s["errors"]}
            skipped = {h: s["skipped"] for h, s in hooks.items() if s["skipped"]}
            lines.append(f"  hooks fired: {fired}")
            if errors:
                lines.append(f"  hook errors: {errors}")
            if skipped:
                lines.append(f"  hook handlers skipped: {skipped}")
            if status["degraded"]:
                lines.append(f"  degraded plugins: {status['degraded']}")
            if status["breakers"].get(self.id):
                lines.append(f"  breakers: {status['breakers'][self.id]}")
        return "\n".join(lines)
