"""Knowledge engine plugin (reference: knowledge-engine/index.ts:7-39,
src/hooks.ts:19-124).

Hook layout: session_start @200 loads the store + starts maintenance;
message_received/message_sent @100 extract entities→facts (+ optional LLM
batch); gateway_stop @900 flushes and stops timers.

The port's copy of ``vainplex_openclaw_tpu/knowledge/plugin.py``, with
JAX's ``DEFAULTS``, ``MANIFEST``, hooks and priorities, service,
``/knowledge`` command, ``stats()`` and ``status_text()``, and these
deviations:

- ``KnowledgeEnginePlugin(device=None)`` names the local embeddings'
  device (the card by default; tests pass ``device="cpu"``). With
  ``embeddings.backend: "local"`` (the default) a process without a card
  raises at ``register``, i.e. at ``gw.load``; the ``chroma`` and ``none``
  backends never ask for the card. A maintenance sync and an uncached
  ``/knowledge <query>`` then run the encoder, with K1, on that device;
- the catches of ``session_start``, ``message_received``/``message_sent``
  (which end in ``_ensure_loaded`` and the enhancer) and ``gateway_stop``
  re-raise an error of the device (``device.is_device_error``), where the
  JAX package logs it and returns ``None``; every other error keeps JAX's
  log line and result;
- an error of the device on a maintenance thread is kept and raised from
  the plugin's next hook, ``/knowledge`` command, ``stats()`` or service
  stop (``Maintenance.raise_pending``), where JAX logs it on the thread.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from ..config.loader import load_plugin_config
from ..config.manifest import PluginManifest, enabled_section
from ..core.api import PluginCommand, PluginService
from ..device import DeviceLike, is_device_error
from ..resilience.faults import maybe_fail
from ..storage.journal import get_journal, journal_settings
from ..storage.lifecycle import LifecycleManager, lifecycle_settings
from ..utils.stage_timer import StageTimer
from .embeddings import create_embeddings
from .entity_extractor import EntityExtractor
from .fact_store import FactStore
from .llm_enhancer import KnowledgeLlmEnhancer
from .maintenance import Maintenance

DEFAULTS = {
    "enabled": True,
    "workspace": None,
    # storage.journal: debounced facts.json saves ride the shared
    # group-commit workspace journal; false restores the atomic rename.
    # storage.lifecycle: snapshot shipping + tiering on the shared journal;
    # idle hibernation of the fact store (idleSeconds > 0).
    "storage": {"maxFacts": 2000, "writeDebounceMs": 2000, "journal": True,
                "lifecycle": True},
    "extraction": {"minImportance": 0.5, "mentionPredicate": "mentioned"},
    "llm": {"enabled": False, "batchSize": 3},
    "embeddings": {"backend": "local", "enabled": True,
                   "endpoint": "http://localhost:8000/api/v2/collections/{name}/upsert",
                   "collectionName": "openclaw-facts",
                   # a data-parallel mesh for the local embeddings (the
                   # "embeddings_forward" plan); off: one device
                   "meshServing": False, "meshShape": None},
    "maintenance": {"decayHours": 24, "syncMinutes": 30},
}

MANIFEST = PluginManifest(
    id="knowledge-engine",
    description="Entity extraction into a decaying fact store with embeddings",
    config_schema={
        "type": "object",
        "properties": {
            "enabled": {"type": "boolean"},
            "workspace": {"type": ["string", "null"]},
            "storage": {"type": "object", "properties": {
                "maxFacts": {"type": "integer", "minimum": 1},
                "writeDebounceMs": {"type": "integer", "minimum": 0},
                "journal": {"type": ["boolean", "object"]},
                "lifecycle": {"type": ["boolean", "object"]}}},
            "extraction": {"type": "object", "properties": {
                "minImportance": {"type": "number", "minimum": 0, "maximum": 1},
                "mentionPredicate": {"type": "string"}}},
            "llm": enabled_section(batchSize={"type": "integer", "minimum": 1}),
            "embeddings": enabled_section(
                backend={"type": "string", "enum": ["local", "chroma", "none"]},
                endpoint={"type": "string"},
                collectionName={"type": "string"},
                meshServing={"type": "boolean"},
                meshShape={"type": ["array", "null"]}),
            "maintenance": {"type": "object", "properties": {
                "decayHours": {"type": "number", "minimum": 0},
                "syncMinutes": {"type": "number", "minimum": 0}}},
        },
    },
    hooks=("session_start", "message_received", "message_sent", "gateway_stop"),
)


class KnowledgeEnginePlugin:
    id = "knowledge-engine"
    manifest = MANIFEST

    def __init__(self, workspace: Optional[str] = None,
                 clock: Callable[[], float] = time.time,
                 call_llm=None, wall_timers: bool = True, http_post=None,
                 device: DeviceLike = None):
        self._workspace_override = workspace
        self.clock = clock
        self.call_llm = call_llm
        self.wall_timers = wall_timers
        self.http_post = http_post
        self.device = device              # the local embeddings' device
        self.config: dict = {}
        # One StageTimer shared by store, embeddings and maintenance: the
        # serve-path breakdown (ingest, query, sync, search, decay,
        # extract) reads as one attribution surface.
        self.timer = StageTimer()
        self.extractor: Optional[EntityExtractor] = None
        self.fact_store: Optional[FactStore] = None
        self.embeddings = None
        self.maintenance: Optional[Maintenance] = None
        self.enhancer: Optional[KnowledgeLlmEnhancer] = None
        self.lifecycle: Optional[LifecycleManager] = None
        self._ws_key = ""
        self._maintenance_started = False

    def register(self, api) -> None:
        self.config = load_plugin_config(self.id, api.plugin_config,
                                         defaults=DEFAULTS, logger=api.logger)
        if not self.config.get("enabled", True):
            api.logger.info("disabled via config")
            return
        self.logger = api.logger
        workspace = (self._workspace_override or self.config.get("workspace")
                     or api.config.get("workspace") or ".")
        self.extractor = EntityExtractor(api.logger, clock=self.clock)
        # Shipping/tiering settings ride the shared journal (first creator
        # wins); the manager drives idle hibernation of the fact store
        # through the maintenance loop.
        ls = lifecycle_settings(self.config)
        self._ws_key = str(workspace)
        if ls["enabled"]:
            self.lifecycle = LifecycleManager(ls, clock=self.clock,
                                              logger=api.logger)
            if hasattr(api, "register_lifecycle"):
                api.register_lifecycle("knowledge", self.lifecycle)
        else:
            self.lifecycle = None
        # the shared per-workspace group-commit journal, or the debounced
        # atomic write when it is off
        js = journal_settings(self.config)
        self.journal = (get_journal(workspace, js, clock=self.clock,
                                    wall=self.wall_timers, logger=api.logger,
                                    lifecycle=ls if ls["enabled"] else None,
                                    lifecycle_timer=(
                                        self.lifecycle.timer_for(self._ws_key)
                                        if self.lifecycle is not None
                                        else None))
                        if js["enabled"] else None)
        if self.journal is not None and hasattr(api, "register_journal"):
            api.register_journal(f"journal:{workspace}", self.journal)
        self.fact_store = FactStore(workspace, self.config.get("storage"),
                                    api.logger, clock=self.clock,
                                    wall_timers=self.wall_timers,
                                    timer=self.timer, journal=self.journal)
        if self.lifecycle is not None:
            # the store hibernates to its journaled snapshot; the shared
            # journal itself stays open (cortex or gateway stop closes it)
            self.lifecycle.register(self._ws_key, self.fact_store.hibernate,
                                    owner="knowledge")
        kwargs = {"http_post": self.http_post} if self.http_post else {}
        self.embeddings = create_embeddings(self.config.get("embeddings"),
                                            api.logger, timer=self.timer,
                                            device=self.device, **kwargs)
        mcfg = self.config.get("maintenance", {})
        self.maintenance = Maintenance(self.fact_store, self.embeddings, api.logger,
                                       decay_hours=mcfg.get("decayHours", 24),
                                       sync_minutes=mcfg.get("syncMinutes", 30),
                                       wall_timers=self.wall_timers,
                                       timer=self.timer,
                                       lifecycle=self.lifecycle)
        if self.config.get("llm", {}).get("enabled") and self.call_llm is not None:
            self.enhancer = KnowledgeLlmEnhancer(self.call_llm, api.logger,
                                                 self.config["llm"].get("batchSize", 3))

        api.on("session_start", self._on_session_start, priority=200)
        api.on("message_received", self._on_message, priority=100)
        api.on("message_sent", self._on_message, priority=100)
        api.on("gateway_stop", self._on_gateway_stop, priority=900)
        api.register_service(PluginService(
            id="knowledge-engine",
            start=lambda ctx: self._ensure_loaded(),
            stop=lambda ctx: self._shutdown()))
        api.register_stage_timer("knowledge", self.timer)
        api.register_command(PluginCommand(
            name="knowledge", description="Knowledge engine status + search",
            accepts_args=True,
            handler=lambda ctx: {"text": self.status_text(ctx.get("args", ""))}))

    # ── lifecycle ────────────────────────────────────────────────────

    def _ensure_loaded(self) -> None:
        self.maintenance.raise_pending()
        if self.fact_store.loaded:
            return
        # Wake path: after a hibernation this re-load IS the recovery; the
        # ``lifecycle.wake`` fault fires before it, so a crashed wake leaves
        # the store unloaded for the next message to retry.
        waking = (self.lifecycle is not None
                  and self.lifecycle.is_sleeping(self._ws_key))
        t0 = time.perf_counter()
        if waking:
            maybe_fail("lifecycle.wake")
        self.fact_store.load()
        if not self._maintenance_started:
            self.maintenance.start()
            self._maintenance_started = True
        if waking:
            # hibernation dropped the owner callback: re-register on wake
            self.lifecycle.register(self._ws_key, self.fact_store.hibernate,
                                    owner="knowledge")
            self.lifecycle.note_wake(self._ws_key,
                                     (time.perf_counter() - t0) * 1000.0)

    def _shutdown(self) -> None:
        if self.maintenance is not None:
            self.maintenance.stop()
        if self.enhancer is not None and self.fact_store is not None:
            # Flush a partial LLM batch so short sessions still extract facts.
            for f in self.enhancer.send_batch() or []:
                self.fact_store.add_fact(f["subject"], f["predicate"], f["object"],
                                         source="extracted-llm")
        if self.fact_store is not None:
            self.fact_store.flush()
        if self.maintenance is not None:
            self.maintenance.raise_pending()

    # ── hooks ────────────────────────────────────────────────────────

    def _on_session_start(self, event: dict, ctx: dict):
        try:
            self._ensure_loaded()
        except Exception as exc:  # noqa: BLE001
            if is_device_error(exc):
                raise
            self.logger.error(f"session_start failed: {exc}")
        return None

    def _on_message(self, event: dict, ctx: dict):
        try:
            content = event.get("content") or ""
            if not content:
                return None
            self._ensure_loaded()
            if self.lifecycle is not None:
                # Recency stamp; idle eviction itself runs on the
                # maintenance probe (an idle store gets no messages).
                self.lifecycle.note_traffic(self._ws_key)
            min_importance = self.config.get("extraction", {}).get("minImportance", 0.5)
            predicate = self.config.get("extraction", {}).get("mentionPredicate", "mentioned")
            with self.timer.stage("extract"):
                entities = self.extractor.extract(content)
            for entity in entities:
                if entity.importance < min_importance:
                    continue
                self.fact_store.add_fact("conversation", predicate, entity.value,
                                         source="extracted-regex")
            if self.enhancer is not None:
                facts = self.enhancer.add_to_batch(content)
                for f in facts or []:
                    self.fact_store.add_fact(f["subject"], f["predicate"], f["object"],
                                             source="extracted-llm")
        except Exception as exc:  # noqa: BLE001
            if is_device_error(exc):
                raise
            self.logger.error(f"message extraction failed: {exc}")
        return None

    def _on_gateway_stop(self, event: dict, ctx: dict):
        try:
            self._shutdown()
        except Exception as exc:  # noqa: BLE001
            if is_device_error(exc):
                raise
            self.logger.error(f"gateway_stop failed: {exc}")
        return None

    # ── status ───────────────────────────────────────────────────────

    def stats(self) -> dict:
        """Machine-readable serve-path stats: counts plus the shared
        StageTimer breakdown, so a slow knowledge path arrives attributed
        to ingest / query / sync / search / decay."""
        self._ensure_loaded()
        # one lock round-trip: the timer is shared with the maintenance
        # daemon, so separate reads could attribute different traffic
        snap = self.timer.snapshot()
        out = {
            "facts": self.fact_store.count(),
            "embedded": (self.embeddings.count()
                         if hasattr(self.embeddings, "count") else None),
            "stageMs": snap["stages_ms"],
            "stageCounts": snap["counts"],
            "stageQuantiles": snap["quantiles"],
        }
        if hasattr(self.embeddings, "query_cache_hits"):
            out["queryCache"] = {"hits": self.embeddings.query_cache_hits,
                                 "misses": self.embeddings.query_cache_misses}
        return out

    def _stage_line(self) -> str:
        stage_ms = self.timer.stages_ms()
        if not stage_ms:
            return ""
        return "stages: " + " ".join(f"{k}={v:.1f}ms" for k, v in stage_ms.items())

    def status_text(self, args: str = "") -> str:
        self._ensure_loaded()
        query = args.strip()
        if query:
            results = self.fact_store.query(text=query, limit=5)
            lines = [f"📚 facts matching {query!r}:"]
            lines += [f"  {f.subject} {f.predicate} {f.object} "
                      f"(rel={f.relevance:.2f}, {f.source})" for f in results]
            if hasattr(self.embeddings, "search") and self.embeddings.count():
                lines.append("  semantic:")
                lines += [f"    {r['document']} ({r['score']:.2f})"
                          for r in self.embeddings.search(query, k=3)]
            stage = self._stage_line()
            if stage:
                lines.append(f"  {stage}")
            return "\n".join(lines)
        n_vec = self.embeddings.count() if hasattr(self.embeddings, "count") else "n/a"
        base = (f"📚 knowledge: {self.fact_store.count()} facts, "
                f"{n_vec} embedded "
                f"(backend={self.config.get('embeddings', {}).get('backend')})")
        stage = self._stage_line()
        return f"{base}\n  {stage}" if stage else base
