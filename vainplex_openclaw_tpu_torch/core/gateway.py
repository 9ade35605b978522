"""The host gateway harness.

The reference suite assumes an *external* OpenClaw gateway and only ships a
test mock of it (``createMockApi`` with ``_fire`` —
openclaw-nats-eventstore/test/helpers.ts:21-35). Here the gateway host is a
first-class component: it loads plugins, owns the hook bus, runs service
lifecycles, dispatches commands and gateway RPC methods, and exposes typed
entry points for the flows that matter (tool calls, messages, sessions,
compaction). Everything is in-process, mirroring the reference's
single-event-loop execution model (SURVEY §3.1).

Hook result merging implemented here (reference: gateway-side semantics
reverse-engineered from handler return shapes, governance/src/types.ts:44-55
``HookBeforeToolCallResult {params?, block?, blockReason?}`` and the
response-gate fallback-message flow, governance/src/hooks.ts:339-353):

- ``before_tool_call``: first ``block`` verdict wins and stops the chain;
  ``params`` results replace the event's params for later handlers and for
  the tool itself.
- ``tool_result_persist``: synchronous; ``result`` mutations chain.
- ``message_sending`` / ``before_message_write``: ``content`` mutations chain;
  ``block`` stops the chain, optionally substituting ``fallback_message``.

A copy of ``vainplex_openclaw_tpu/core/gateway.py`` over the port's
``HookBus``, so an error from the device propagates out of every entry
point that fires a hook (``core/api.py``).
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from ..resilience.admission import AdmissionController
from .api import (
    ADMISSION_SHEDDABLE_HOOKS,
    HookBus,
    PluginApi,
    PluginCommand,
    PluginLogger,
    PluginService,
    make_logger,
)


@dataclass
class ToolCallDecision:
    blocked: bool
    block_reason: Optional[str]
    params: dict

    @property
    def allowed(self) -> bool:
        return not self.blocked


@dataclass
class MessageWriteDecision:
    blocked: bool
    content: str
    fallback_message: Optional[str] = None
    block_reason: Optional[str] = None

    @property
    def final_text(self) -> str:
        if self.blocked:
            return self.fallback_message or ""
        return self.content


@dataclass
class _LoadedPlugin:
    plugin_id: str
    api: PluginApi
    module: Any


def _run(coro):
    """Run a coroutine to completion from sync code (no nested loops)."""
    try:
        asyncio.get_running_loop()
    except RuntimeError:
        return asyncio.run(coro)
    raise RuntimeError("use the async gateway methods inside an event loop")


class Gateway:
    """In-process host: plugin loader + hook dispatcher + service supervisor."""

    def __init__(
        self,
        config: Optional[dict] = None,
        logger: Optional[PluginLogger] = None,
        clock: Callable[[], float] = time.time,
    ):
        self.config = config or {}
        self.logger = logger or make_logger("gateway")
        self.clock = clock
        self.bus = HookBus(
            self.logger, clock=clock,
            breaker_config=(self.config.get("resilience") or {}).get("pluginBreaker"))
        self.plugins: dict[str, _LoadedPlugin] = {}
        self.services: list[tuple[str, PluginService]] = []
        self.commands: dict[str, PluginCommand] = {}
        self.methods: dict[str, Callable[..., Any]] = {}
        self.tools: dict[str, dict] = {}
        # Observability registry: every serving edge publishes its
        # StageTimer here so sitrep/SLO surfaces read one place. In cluster
        # mode every key is prefixed with the worker's id so the
        # supervisor's merged view can tell which worker's governance edge a
        # quantile belongs to — and strip the prefix to merge across workers.
        self.worker_prefix = str(
            ((self.config.get("cluster") or {}).get("workerPrefix")) or "")
        self.stage_timers: dict[str, Any] = {}
        # Journal registry: plugins publish their (shared)
        # group-commit journals; get_status() exports pending/group/fsync/
        # compaction/replay counters and sitrep's journal collector reads
        # them. Multiple plugins sharing one workspace journal register the
        # same name — last one wins, same instance either way.
        self.journals: dict[str, Any] = {}
        # Lifecycle registry: plugins publish their
        # LifecycleManagers (hibernation/wake accounting); get_status()
        # exports resident/hibernated/wake-quantile counters and sitrep's
        # lifecycle collector reads them.
        self.lifecycles: dict[str, Any] = {}
        # Admission control: None unless configured — seed
        # behavior is "never shed".
        self.admission = AdmissionController.from_config(
            (self.config.get("resilience") or {}).get("admission"))
        self._started = False

    # ── plugin registry ──────────────────────────────────────────────

    def load(self, plugin: Any, plugin_config: Optional[dict] = None,
             logger: Optional[PluginLogger] = None) -> PluginApi:
        """Load a plugin object exposing ``id`` and ``register(api)``."""
        plugin_id = getattr(plugin, "id", None) or getattr(plugin, "ID", None)
        if not plugin_id:
            raise ValueError("plugin must expose an 'id'")
        # Manifest validation (the openclaw.plugin.json equivalent): config
        # problems are warnings, never load failures — the gateway must boot.
        manifest = getattr(plugin, "manifest", None)
        if manifest is not None and plugin_config:
            for err in manifest.validate_config(plugin_config):
                (logger or self.logger).warn(f"[{plugin_id}] config schema: {err}")
        api = PluginApi(plugin_id, self, plugin_config=plugin_config, logger=logger)
        plugin.register(api)
        self.plugins[plugin_id] = _LoadedPlugin(plugin_id, api, plugin)
        return api

    def _register_service(self, plugin_id: str, service: PluginService) -> None:
        self.services.append((plugin_id, service))
        if self._started:
            self._start_service(plugin_id, service)

    def _register_command(self, plugin_id: str, command: PluginCommand) -> None:
        self.commands[command.name] = command

    def _register_gateway_method(self, plugin_id: str, method: str, handler: Callable[..., Any]) -> None:
        self.methods[method] = handler

    def _register_tool(self, plugin_id: str, tool: dict) -> None:
        self.tools[tool["name"]] = tool

    def _register_stage_timer(self, plugin_id: str, name: str, timer: Any) -> None:
        self.stage_timers[self.worker_prefix + name] = timer

    def _register_journal(self, plugin_id: str, name: str, journal: Any) -> None:
        self.journals[name] = journal

    def _register_lifecycle(self, plugin_id: str, name: str, manager: Any) -> None:
        self.lifecycles[name] = manager

    def _unregister_stage_timer(self, name: str) -> None:
        # Hibernation: a sleeping workspace's per-ws registry
        # entries are dropped so 10⁵ workspaces that spoke once don't pin
        # 10⁵ timers/journal objects in RAM forever; the lifecycle manager
        # absorbs the timer's histogram into its aggregate first.
        self.stage_timers.pop(self.worker_prefix + name, None)

    def _unregister_journal(self, name: str) -> None:
        self.journals.pop(name, None)

    # ── lifecycle ────────────────────────────────────────────────────

    def _start_service(self, plugin_id: str, service: PluginService) -> None:
        try:
            out = service.start(self)
            if asyncio.iscoroutine(out):
                _run(out)
        except Exception as exc:  # noqa: BLE001 — a bad service must not take the gateway down
            self.logger.error(f"[gateway] service {plugin_id}/{service.id} failed to start: {exc}")

    def start(self) -> None:
        self._started = True
        for plugin_id, service in self.services:
            self._start_service(plugin_id, service)
        self.fire("gateway_start", {}, {})

    def stop(self) -> None:
        self.fire("gateway_stop", {}, {})
        for plugin_id, service in reversed(self.services):
            if service.stop is None:
                continue
            try:
                out = service.stop(self)
                if asyncio.iscoroutine(out):
                    _run(out)
            except Exception as exc:  # noqa: BLE001
                self.logger.error(f"[gateway] service {plugin_id}/{service.id} failed to stop: {exc}")
        # Journals close LAST: plugin stop paths above flush
        # through them. Closing compacts + persists watermarks and releases
        # the wal fd; a later get_journal() on the same workspace opens a
        # fresh instance, and a straggler append falls back to its legacy
        # write path (append() returns False on a closed journal).
        for journal in self.journals.values():
            try:
                journal.close()
            except Exception as exc:  # noqa: BLE001 — stop paths can't raise
                self.logger.error(f"[gateway] journal close failed: {exc}")
        self._started = False

    # ── generic hook firing (the mock-api `_fire` equivalent) ────────

    def _shed(self, hook_name: str, args: tuple) -> bool:
        """Admission check: True → this hook fire is shed.
        Shedding is handler-granular: the bus still runs handlers
        registered ``never_shed`` (2FA code interception, trust feedback)
        and skips the rest (visible in the hook's ``skipped`` counter).
        Verdict-bearing hooks are not in ``ADMISSION_SHEDDABLE_HOOKS`` and
        never reach the controller. The tenant key is the ctx's workspace
        (one per SLO-harness tenant), falling back to session/agent
        identity."""
        if self.admission is None or hook_name not in ADMISSION_SHEDDABLE_HOOKS:
            return False
        ctx = args[1] if len(args) > 1 and isinstance(args[1], dict) else {}
        tenant = str(ctx.get("workspace") or ctx.get("session_key")
                     or ctx.get("agent_id") or "?")
        return not self.admission.admit(tenant)

    def _dispatch(self, hook_name: str, *args: Any, until=None, on_result=None) -> list[Any]:
        """Single sync-vs-async dispatch decision: hooks with only sync
        handlers skip the event loop entirely (the enforcement/ingest hot
        paths are sync in the common case)."""
        shed = self._shed(hook_name, args)
        if self.bus.has_async(hook_name):
            return _run(self.bus.fire(hook_name, *args, until=until,
                                      on_result=on_result, shed=shed))
        return self.bus.fire_sync(hook_name, *args, until=until,
                                  on_result=on_result, shed=shed)

    def fire(self, hook_name: str, *args: Any) -> list[Any]:
        return self._dispatch(hook_name, *args)

    async def fire_async(self, hook_name: str, *args: Any) -> list[Any]:
        return await self.bus.fire(hook_name, *args,
                                   shed=self._shed(hook_name, args))

    # ── typed flows ──────────────────────────────────────────────────

    @staticmethod
    def _tool_call_fixture(tool_name: str, params: dict, ctx: Optional[dict]):
        event = {"tool_name": tool_name, "params": dict(params)}
        ctx = dict(ctx or {})
        ctx.setdefault("tool_name", tool_name)

        def fold(result: Any) -> None:
            if isinstance(result, dict) and result.get("params") is not None:
                event["params"] = result["params"]

        def is_block(r: Any) -> bool:
            return isinstance(r, dict) and bool(r.get("block"))

        return event, ctx, fold, is_block

    @staticmethod
    def _tool_call_decision(results: list[Any], event: dict) -> ToolCallDecision:
        for r in results:
            if isinstance(r, dict) and r.get("block"):
                return ToolCallDecision(True, r.get("block_reason") or r.get("blockReason"), event["params"])
        return ToolCallDecision(False, None, event["params"])

    async def before_tool_call_async(self, tool_name: str, params: dict,
                                     ctx: Optional[dict] = None) -> ToolCallDecision:
        event, ctx, fold, is_block = self._tool_call_fixture(tool_name, params, ctx)
        results = await self.bus.fire("before_tool_call", event, ctx, until=is_block, on_result=fold)
        return self._tool_call_decision(results, event)

    def before_tool_call(self, tool_name: str, params: dict, ctx: Optional[dict] = None) -> ToolCallDecision:
        event, fctx, fold, is_block = self._tool_call_fixture(tool_name, params, ctx)
        results = self._dispatch("before_tool_call", event, fctx, until=is_block, on_result=fold)
        return self._tool_call_decision(results, event)

    def after_tool_call(self, tool_name: str, params: dict, result: Any = None,
                        error: Optional[str] = None, ctx: Optional[dict] = None) -> None:
        event = {"tool_name": tool_name, "params": params, "result": result, "error": error}
        ctx = dict(ctx or {})
        ctx.setdefault("tool_name", tool_name)
        self.fire("after_tool_call", event, ctx)

    def tool_result_persist(self, tool_name: str, result: Any, ctx: Optional[dict] = None) -> Any:
        """Synchronous mutation point before a tool result enters LLM context
        (reference: redaction Layer 1, redaction/hooks.ts:33-47)."""
        event = {"tool_name": tool_name, "result": result}
        ctx = dict(ctx or {})
        ctx.setdefault("tool_name", tool_name)

        def fold(r: Any) -> None:
            if isinstance(r, dict) and "result" in r:
                event["result"] = r["result"]

        self.bus.fire_sync("tool_result_persist", event, ctx, on_result=fold)
        return event["result"]

    def run_tool(self, tool_name: str, params: dict, fn: Callable[[dict], Any],
                 ctx: Optional[dict] = None) -> tuple[ToolCallDecision, Any]:
        """Full tool round-trip: before → execute → persist-mutate → after."""
        decision = self.before_tool_call(tool_name, params, ctx)
        if decision.blocked:
            self.after_tool_call(tool_name, params, None, error=f"blocked: {decision.block_reason}", ctx=ctx)
            return decision, None
        try:
            raw = fn(decision.params)
            err = None
        except Exception as exc:  # noqa: BLE001 — tool failures flow into after_tool_call as errors
            raw, err = None, str(exc)
        persisted = self.tool_result_persist(tool_name, raw, ctx) if err is None else None
        self.after_tool_call(tool_name, decision.params, persisted, error=err, ctx=ctx)
        return decision, persisted

    def message_received(self, content: str, ctx: Optional[dict] = None) -> list[Any]:
        return self.fire("message_received", {"content": content}, dict(ctx or {}))

    def message_sending(self, content: str, ctx: Optional[dict] = None) -> MessageWriteDecision:
        return self._outbound("message_sending", content, ctx, sync=False)

    def before_message_write(self, content: str, ctx: Optional[dict] = None) -> MessageWriteDecision:
        return self._outbound("before_message_write", content, ctx, sync=True)

    def message_sent(self, content: str, ctx: Optional[dict] = None) -> list[Any]:
        return self.fire("message_sent", {"content": content}, dict(ctx or {}))

    def _outbound(self, hook: str, content: str, ctx: Optional[dict], sync: bool) -> MessageWriteDecision:
        event = {"content": content}
        ctx = dict(ctx or {})

        def fold(r: Any) -> None:
            if isinstance(r, dict) and r.get("content") is not None:
                event["content"] = r["content"]

        def is_block(r: Any) -> bool:
            return isinstance(r, dict) and bool(r.get("block"))

        if sync:
            results = self.bus.fire_sync(hook, event, ctx, until=is_block, on_result=fold)
        else:
            results = self._dispatch(hook, event, ctx, until=is_block, on_result=fold)
        for r in results:
            if is_block(r):
                return MessageWriteDecision(True, event["content"],
                                            r.get("fallback_message") or r.get("fallbackMessage"),
                                            r.get("block_reason") or r.get("blockReason"))
        return MessageWriteDecision(False, event["content"])

    def fire_results(self, hook: str, *args: Any, until=None, on_result=None) -> list[Any]:
        return self._dispatch(hook, *args, until=until, on_result=on_result)

    def session_start(self, ctx: Optional[dict] = None) -> list[Any]:
        return self.fire("session_start", {}, dict(ctx or {}))

    def session_end(self, ctx: Optional[dict] = None) -> list[Any]:
        return self.fire("session_end", {}, dict(ctx or {}))

    def before_agent_start(self, ctx: Optional[dict] = None) -> list[Any]:
        """Returns context-injection results (``{prepend_context: str}``)."""
        return self.fire("before_agent_start", {}, dict(ctx or {}))

    def agent_end(self, ctx: Optional[dict] = None, error: Optional[str] = None,
                  final_message: Optional[str] = None) -> list[Any]:
        return self.fire("agent_end", {"error": error, "final_message": final_message},
                         dict(ctx or {}))

    def before_compaction(self, ctx: Optional[dict] = None,
                          messages: Optional[list] = None) -> list[Any]:
        return self.fire("before_compaction", {"messages": messages or []}, dict(ctx or {}))

    def after_compaction(self, ctx: Optional[dict] = None,
                         kept_messages: int = 0) -> list[Any]:
        return self.fire("after_compaction", {"kept_messages": kept_messages},
                         dict(ctx or {}))

    def llm_input(self, prompt: str, ctx: Optional[dict] = None) -> list[Any]:
        """Observation hook; the event store records lengths only, never bodies."""
        return self.fire("llm_input", {"prompt": prompt}, dict(ctx or {}))

    def llm_output(self, completion: str, ctx: Optional[dict] = None) -> list[Any]:
        return self.fire("llm_output", {"completion": completion}, dict(ctx or {}))

    # ── commands & RPC ───────────────────────────────────────────────

    def command(self, name: str, ctx: Optional[dict] = None, args: str = "") -> dict:
        cmd = self.commands.get(name.lstrip("/"))
        if cmd is None:
            return {"text": f"unknown command: {name}"}
        try:
            out = cmd.handler({"args": args, **(ctx or {})})
            if asyncio.iscoroutine(out):
                out = _run(out)
            return out
        except Exception as exc:  # noqa: BLE001
            return {"text": f"command {name} failed: {exc}"}

    def call_method(self, method: str, *args: Any) -> Any:
        handler = self.methods.get(method)
        if handler is None:
            raise KeyError(f"unknown gateway method: {method}")
        return handler(*args)

    # ── status ───────────────────────────────────────────────────────

    def get_status(self) -> dict:
        """Degradation surface: which plugins are shedding, which
        hooks skipped handlers, and every tripped breaker's counters."""
        hooks = {name: {"fired": st.fired, "errors": st.errors,
                        "skipped": st.skipped}
                 for name, st in self.bus.stats.items()}
        breakers: dict[str, dict] = {}
        for (pid, hook), br in self.bus.breakers.items():
            if br.failures or br.state != "closed":
                breakers.setdefault(pid, {})[hook] = br.stats()
        return {
            "started": self._started,
            "plugins": sorted(self.plugins),
            "degraded": self.bus.degraded_plugins(),
            "breakers": breakers,
            "hooks": hooks,
            "admission": (self.admission.stats() if self.admission is not None
                          else {"enabled": False}),
            "journal": {name: j.stats() for name, j in self.journals.items()},
            "lifecycle": {name: m.stats()
                          for name, m in self.lifecycles.items()},
        }
