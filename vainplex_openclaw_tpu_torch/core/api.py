"""The plugin API contract.

This is the one seam every subsystem attaches through, equivalent to the
reference's ``OpenClawPluginApi`` (openclaw-governance/src/types.ts:10-41,
duplicated per package there; shared here because the gateway is in-repo).

Semantics:

- Hooks are named lifecycle events (``before_tool_call``, ``message_received``,
  ...). Handlers register with an integer priority and run in **ascending**
  priority order (5 before 950 before 1000), stable by registration order
  within a priority. This matches the reference's observed ordering: redaction
  vault resolution (prio 950) runs before governance enforcement (prio 1000)
  on ``before_tool_call`` (governance/src/redaction/hooks.ts:121-125 vs
  src/hooks.ts:883), and context injection registers at prio 5 to run first.
- Handlers may be sync functions or ``async def``. Certain hooks are declared
  synchronous (``before_message_write`` — reference engine.ts:360-365 requires
  output validation to stay sync) and the bus rejects coroutine results there.
- Every handler invocation is wrapped in try/except: a plugin must never crash
  the gateway (reference: each handler try/caught, e.g. cortex hooks.ts:127-130).
  Errors are logged and counted; the hook continues with later handlers.

A copy of ``vainplex_openclaw_tpu/core/api.py``, kept here so the port
imports nothing of the JAX package, with one deviation. In ``HookBus.fire``
and ``HookBus.fire_sync`` (the JAX package's catches at ``api.py:379`` and
``:458``) an error for which :func:`..device.is_device_error` holds — no
card, a kernel that did not build or launch — is logged and counted on the
hook, then propagates out of the fire. It never counts toward the plugin's
breaker (a breaker that opened on it would skip the plugin's handlers, so a
failing card would read as a quiet plugin); a half-open probe it took is
returned. Every other error is handled as in the JAX package.
"""

from __future__ import annotations

import asyncio
import inspect
import logging
import time
from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable, Optional, Protocol, Union

from ..device import is_device_error
from ..resilience.policy import CircuitBreaker

HookHandler = Callable[..., Union[Any, Awaitable[Any]]]

# Per-plugin error budget defaults: a plugin failing ≥90% of its
# last-minute handler calls, with at least 25 failures, is *degraded* — its
# handlers are skipped (visibly: counters + one log line per transition)
# until a recovery probe succeeds. Generous on purpose: the budget exists to
# shed a plugin that is broken, not one that is merely unlucky.
PLUGIN_BREAKER_DEFAULTS = {
    "failureThreshold": 25,
    "failureRate": 0.9,
    "windowS": 60.0,
    "recoveryS": 30.0,
    "halfOpenMax": 1,
}

# Hooks whose handlers may carry a verdict or scrub content before it leaves
# the process (enforcement deny, response gate, redaction of tool results).
# Shedding one of these FAILS OPEN — a denied tool call would silently run,
# a secret would persist unredacted — so the error budget never sheds them:
# their failures still count (the plugin shows degraded in status, and its
# handlers on other hooks shed), but these handlers always run.
NEVER_SHED_HOOKS = frozenset({
    "before_tool_call",
    "message_sending",
    "before_message_write",
    "tool_result_persist",
})

# Hooks whose handlers must be synchronous (results are needed inline, before
# the gateway writes the message).
SYNC_ONLY_HOOKS = frozenset({"before_message_write", "tool_result_persist"})

# Traffic-proportional hooks the admission controller may shed under
# saturation. Shedding is HANDLER-granular, not hook-granular:
# a shed fire skips only handlers registered without ``never_shed`` —
# observability/memory work (cortex ingest, knowledge extraction, event
# mirroring) — while verdict-relevant handlers that happen to live on
# these hooks (governance's 2FA code interception on message_received,
# trust feedback + sub-agent linking on after_tool_call) register with
# ``never_shed=True`` and run at any queue depth. Lifecycle hooks
# (session/gateway/compaction boundaries) carry state transitions and are
# not listed at all: shedding is strictly for per-message/per-call volume.
ADMISSION_SHEDDABLE_HOOKS = frozenset({
    "message_received",
    "message_sent",
    "after_tool_call",
    "llm_input",
    "llm_output",
})

KNOWN_HOOKS = (
    "before_tool_call",
    "after_tool_call",
    "tool_result_persist",
    "message_received",
    "message_sending",
    "message_sent",
    "before_message_write",
    "before_agent_start",
    "agent_end",
    "session_start",
    "session_end",
    "before_compaction",
    "after_compaction",
    "gateway_start",
    "gateway_stop",
    "llm_input",
    "llm_output",
)


class SyncDispatchInAsyncContext(RuntimeError):
    """Raised (never swallowed) when a sync fire meets an awaitable while an
    event loop is already running — the caller must use the async entry point;
    silently dropping an enforcement verdict here would fail open."""


class PluginLogger(Protocol):
    def info(self, msg: str) -> None: ...
    def warn(self, msg: str) -> None: ...
    def error(self, msg: str) -> None: ...
    def debug(self, msg: str) -> None: ...


@dataclass
class _StdLogger:
    """Default logger: ``[plugin-id]``-prefixed lines into :mod:`logging`."""

    prefix: str
    _log: logging.Logger = field(default_factory=lambda: logging.getLogger("openclaw"))

    def _fmt(self, msg: str) -> str:
        return msg if msg.startswith("[") else f"[{self.prefix}] {msg}"

    def info(self, msg: str) -> None:
        self._log.info(self._fmt(msg))

    def warn(self, msg: str) -> None:
        self._log.warning(self._fmt(msg))

    def error(self, msg: str) -> None:
        self._log.error(self._fmt(msg))

    def debug(self, msg: str) -> None:
        self._log.debug(self._fmt(msg))


def make_logger(plugin_id: str) -> PluginLogger:
    return _StdLogger(plugin_id)


@dataclass
class ListLogger:
    """Test logger capturing ``(level, msg)`` pairs.

    Mirrors the reference's ``createMockLogger`` fixture
    (cortex/test/trace-analyzer/helpers.ts:149-158) — here it is part of the
    framework because the host harness is first-class.
    """

    records: list[tuple[str, str]] = field(default_factory=list)

    def info(self, msg: str) -> None:
        self.records.append(("info", msg))

    def warn(self, msg: str) -> None:
        self.records.append(("warn", msg))

    def error(self, msg: str) -> None:
        self.records.append(("error", msg))

    def debug(self, msg: str) -> None:
        self.records.append(("debug", msg))

    def messages(self, level: Optional[str] = None) -> list[str]:
        return [m for lv, m in self.records if level is None or lv == level]


def list_logger() -> ListLogger:
    return ListLogger()


@dataclass
class PluginService:
    id: str
    start: Callable[[Any], Any]
    stop: Optional[Callable[[Any], Any]] = None


@dataclass
class PluginCommand:
    name: str
    description: str
    handler: Callable[..., dict]
    require_auth: bool = False
    accepts_args: bool = False


@dataclass
class _Registration:
    priority: int
    seq: int
    plugin_id: str
    handler: HookHandler
    is_async: bool = False
    # Exempt from admission shedding: verdict-relevant work
    # registered on an otherwise-sheddable hook.
    never_shed: bool = False


@dataclass
class HookStats:
    fired: int = 0
    errors: int = 0
    # Handlers skipped without running: plugin error-budget breaker open,
    # OR admission-control shed — both deliberate, both visible.
    skipped: int = 0
    last_fired_at: Optional[float] = None
    last_error: Optional[str] = None


class HookBus:
    """Priority-ordered hook dispatch with per-hook fire/error diagnostics.

    Diagnostics mirror cortex's per-hook fire counters
    (cortex/src/hooks.ts:31-36,71-77) but live in the kernel so every plugin
    gets them for free.
    """

    def __init__(self, logger: Optional[PluginLogger] = None, clock: Callable[[], float] = time.time,
                 breaker_config: Optional[dict] = None):
        self._handlers: dict[str, list[_Registration]] = {}
        self._snapshots: dict[str, list[_Registration]] = {}
        self._async_memo: dict[str, bool] = {}
        self._seq = 0
        self._logger = logger or make_logger("hook-bus")
        self._clock = clock
        self.stats: dict[str, HookStats] = {}
        # Per-(plugin, hook) error-budget breakers — per hook, not per
        # plugin, so one broken handler can't be masked by the same plugin's
        # healthy traffic on OTHER hooks (and a never-shed hook's successes
        # can't close a half-open breaker that a sheddable hook tripped).
        # ``breaker_config`` merges over PLUGIN_BREAKER_DEFAULTS;
        # {"enabled": False} disables shedding entirely (errors are still
        # logged and counted, seed behavior).
        cfg = dict(PLUGIN_BREAKER_DEFAULTS)
        cfg.update(breaker_config or {})
        self._breaker_cfg = cfg if cfg.get("enabled", True) else None
        self.breakers: dict[tuple[str, str], CircuitBreaker] = {}

    def _breaker_for(self, plugin_id: str, hook_name: str) -> Optional[CircuitBreaker]:
        cfg = self._breaker_cfg
        if cfg is None:
            return None
        key = (plugin_id, hook_name)
        br = self.breakers.get(key)
        if br is None:
            br = self.breakers[key] = CircuitBreaker(
                failure_threshold=int(cfg["failureThreshold"]),
                failure_rate=float(cfg["failureRate"]),
                window_s=float(cfg["windowS"]),
                recovery_s=float(cfg["recoveryS"]),
                half_open_max=int(cfg["halfOpenMax"]),
                clock=self._clock)
        return br

    def _record_handler_failure(self, br: Optional[CircuitBreaker],
                                plugin_id: str, hook_name: str, err: str) -> None:
        if br is None:
            return
        was_open = br.state == "open"
        br.record_failure(err)
        if not was_open and br.state == "open":
            shed = ("handlers shed" if hook_name not in NEVER_SHED_HOOKS
                    else "never shed (verdict-bearing hook), failures visible")
            self._logger.error(
                f"[hook-bus] plugin '{plugin_id}' DEGRADED on '{hook_name}': "
                f"error budget exhausted ({br.failures} failures), {shed} "
                f"for {br.recovery_s:.0f}s (last: {err})")

    def _device_failure(self, br: Optional[CircuitBreaker], plugin_id: str,
                        hook_name: str, exc: BaseException) -> str:
        """Log a device error before it propagates; hand back a half-open
        probe it took, and leave the breaker's window alone."""
        err = f"{plugin_id}/{hook_name}: {exc}"
        self._logger.error(f"[hook-bus] device error in {err}")
        if br is not None:
            br.release()
        return err

    def degraded_plugins(self) -> list[str]:
        return sorted({pid for (pid, _), br in self.breakers.items()
                       if br.state != "closed"})

    def on(self, hook_name: str, handler: HookHandler, priority: int = 100, plugin_id: str = "?",
           never_shed: bool = False) -> None:
        self._seq += 1
        reg = _Registration(priority=priority, seq=self._seq, plugin_id=plugin_id,
                            handler=handler,
                            is_async=inspect.iscoroutinefunction(inspect.unwrap(handler)),
                            never_shed=never_shed)
        regs = self._handlers.setdefault(hook_name, [])
        regs.append(reg)
        regs.sort(key=lambda r: (r.priority, r.seq))
        self._invalidate(hook_name)

    def _invalidate(self, hook_name: str) -> None:
        """Drop per-hook dispatch caches after registration or an is_async
        promotion."""
        self._snapshots.pop(hook_name, None)
        self._async_memo.pop(hook_name, None)

    def handlers_for(self, hook_name: str) -> list[_Registration]:
        # Cached snapshot, rebuilt only when the registration set changes:
        # the per-fire list() copy (it guards against handlers registering
        # handlers mid-iteration) was a fixed tax on every enforcement call.
        # The cached list must be treated as immutable by callers.
        snap = self._snapshots.get(hook_name)
        if snap is None:
            snap = self._snapshots[hook_name] = list(self._handlers.get(hook_name, ()))
        return snap

    def has_async(self, hook_name: str) -> bool:
        memo = self._async_memo.get(hook_name)
        if memo is None:
            memo = self._async_memo[hook_name] = any(
                r.is_async for r in self._handlers.get(hook_name, ()))
        return memo

    @staticmethod
    async def _await_result(awaitable: Any) -> Any:
        return await awaitable

    @staticmethod
    def _close_awaitable(out: Any) -> None:
        """Best-effort close; Tasks/Futures/custom __await__ objects lack close()."""
        close = getattr(out, "close", None)
        if close is not None:
            try:
                close()
            except Exception:  # noqa: BLE001
                pass

    def _record(self, hook_name: str, error: Optional[str], n_errors: int = 0,
                n_skipped: int = 0) -> None:
        st = self.stats.setdefault(hook_name, HookStats())
        st.fired += 1
        st.last_fired_at = self._clock()
        if n_errors:
            st.errors += n_errors
            st.last_error = error
        if n_skipped:
            st.skipped += n_skipped

    async def fire(
        self,
        hook_name: str,
        *args: Any,
        until: Optional[Callable[[Any], bool]] = None,
        on_result: Optional[Callable[[Any], None]] = None,
        shed: bool = False,
    ) -> list[Any]:
        """Run all handlers in priority order; return their non-None results.

        ``until(result)`` short-circuits the chain when it returns True (used
        by the gateway for block verdicts). ``on_result`` is invoked after each
        non-None result so the caller can fold mutations (e.g. redacted params)
        into the shared event before the next handler sees it. ``shed=True``
        (admission control) skips every handler not registered
        ``never_shed`` — verdict-relevant handlers still run.
        """
        results: list[Any] = []
        err: Optional[str] = None
        n_errors = 0
        n_skipped = 0
        for reg in self.handlers_for(hook_name):
            if shed and not reg.never_shed:
                n_skipped += 1
                continue
            br = self._breaker_for(reg.plugin_id, hook_name)
            if (br is not None and hook_name not in NEVER_SHED_HOOKS
                    and not br.allow()):
                n_skipped += 1
                continue
            try:
                out = reg.handler(*args)
                if inspect.isawaitable(out):
                    if hook_name in SYNC_ONLY_HOOKS:
                        self._close_awaitable(out)
                        raise TypeError(
                            f"hook '{hook_name}' is synchronous; handler from "
                            f"plugin '{reg.plugin_id}' returned a coroutine"
                        )
                    out = await out
            except Exception as exc:  # noqa: BLE001 — plugins must not crash the gateway
                n_errors += 1
                if is_device_error(exc):
                    err = self._device_failure(br, reg.plugin_id, hook_name, exc)
                    self._record(hook_name, err, n_errors, n_skipped)
                    raise
                err = f"{reg.plugin_id}/{hook_name}: {exc}"
                self._logger.error(f"[hook-bus] handler error in {err}")
                self._record_handler_failure(br, reg.plugin_id, hook_name, err)
                continue
            if br is not None:
                br.record_success()
            if out is not None:
                results.append(out)
                if on_result is not None:
                    on_result(out)
                if until is not None and until(out):
                    break
        self._record(hook_name, err, n_errors, n_skipped)
        return results

    def fire_sync(
        self,
        hook_name: str,
        *args: Any,
        until: Optional[Callable[[Any], bool]] = None,
        on_result: Optional[Callable[[Any], None]] = None,
        shed: bool = False,
    ) -> list[Any]:
        """Synchronous dispatch.

        A handler that unexpectedly returns an awaitable (sync lambda wrapping
        an async call, async ``__call__`` object — shapes registration-time
        detection can't see) is still honored on async-capable hooks: the
        awaitable is run to completion here and the registration is promoted
        so subsequent fires take the async path upfront. Sync-only hooks
        reject it, as ``fire`` does.
        """
        results: list[Any] = []
        err: Optional[str] = None
        n_errors = 0
        n_skipped = 0
        try:
            for reg in self.handlers_for(hook_name):
                if shed and not reg.never_shed:
                    n_skipped += 1
                    continue
                br = self._breaker_for(reg.plugin_id, hook_name)
                if (br is not None and hook_name not in NEVER_SHED_HOOKS
                        and not br.allow()):
                    n_skipped += 1
                    continue
                try:
                    out = reg.handler(*args)
                    if inspect.isawaitable(out):
                        if hook_name in SYNC_ONLY_HOOKS:
                            self._close_awaitable(out)
                            raise TypeError(
                                f"sync fire of '{hook_name}': handler from plugin "
                                f"'{reg.plugin_id}' is async"
                            )
                        reg.is_async = True
                        self._invalidate(hook_name)
                        try:
                            asyncio.get_running_loop()
                        except RuntimeError:
                            out = asyncio.run(self._await_result(out))
                        else:
                            self._close_awaitable(out)
                            raise SyncDispatchInAsyncContext(
                                f"hook '{hook_name}' handler from plugin "
                                f"'{reg.plugin_id}' returned an awaitable during a "
                                f"sync fire inside a running event loop; use the "
                                f"async gateway entry points"
                            )
                except SyncDispatchInAsyncContext:
                    # Fail loud (dropping a verdict here would fail open) —
                    # but settle the breaker first: a half-open probe slot
                    # consumed by allow() with no record_* afterwards would
                    # wedge the breaker in half-open forever.
                    if br is not None:
                        br.record_failure("awaitable during sync dispatch")
                    raise
                except Exception as exc:  # noqa: BLE001
                    n_errors += 1
                    if is_device_error(exc):
                        err = self._device_failure(br, reg.plugin_id,
                                                   hook_name, exc)
                        raise
                    err = f"{reg.plugin_id}/{hook_name}: {exc}"
                    self._logger.error(f"[hook-bus] handler error in {err}")
                    self._record_handler_failure(br, reg.plugin_id, hook_name, err)
                    continue
                if br is not None:
                    br.record_success()
                if out is not None:
                    results.append(out)
                    if on_result is not None:
                        on_result(out)
                    if until is not None and until(out):
                        break
        finally:
            self._record(hook_name, err, n_errors, n_skipped)
        return results


class PluginApi:
    """The per-plugin view handed to ``plugin.register(api)``.

    Field-for-field equivalent of the reference contract
    (governance/src/types.ts:10-26): ``id``, ``plugin_config``, ``logger``,
    ``config``, ``register_service``, ``register_command``,
    ``register_gateway_method``, ``on``.
    """

    def __init__(
        self,
        plugin_id: str,
        gateway: "Any",
        plugin_config: Optional[dict] = None,
        logger: Optional[PluginLogger] = None,
    ):
        self.id = plugin_id
        self.plugin_config = plugin_config or {}
        self.logger = logger or make_logger(plugin_id)
        self._gateway = gateway

    @property
    def config(self) -> dict:
        """The gateway-level config (openclaw.json equivalent)."""
        return self._gateway.config

    def register_service(self, service: PluginService) -> None:
        self._gateway._register_service(self.id, service)

    def register_command(self, command: PluginCommand) -> None:
        self._gateway._register_command(self.id, command)

    def register_gateway_method(self, method: str, handler: Callable[..., Any]) -> None:
        self._gateway._register_gateway_method(self.id, method, handler)

    def register_tool(self, tool: dict) -> None:
        """Optional agent-tool registration (reference: cortex/index.ts checks
        ``api.registerTool`` existence before registering its 5 tools)."""
        self._gateway._register_tool(self.id, tool)

    def register_stage_timer(self, name: str, timer: Any) -> None:
        """Publish a StageTimer into the gateway's observability registry
       : sitrep's stage-quantile/SLO collectors and the /ops
        command read every registered edge from one place instead of
        knowing each plugin's status shape."""
        self._gateway._register_stage_timer(self.id, name, timer)

    def register_journal(self, name: str, journal: Any) -> None:
        """Publish a group-commit journal into the gateway's observability
        registry: ``Gateway.get_status()["journal"]`` and sitrep's
        journal collector read pending/group-size/fsync/compaction/replay
        counters from one place. Plugins sharing a workspace journal all
        register the same instance under the same name — idempotent."""
        self._gateway._register_journal(self.id, name, journal)

    def register_lifecycle(self, name: str, manager: Any) -> None:
        """Publish a workspace LifecycleManager into the
        gateway's observability registry: ``get_status()["lifecycle"]`` and
        sitrep's lifecycle collector read resident/hibernated counts, wake
        quantiles and eviction counters from one place."""
        self._gateway._register_lifecycle(self.id, name, manager)

    def unregister_stage_timer(self, name: str) -> None:
        """Drop a per-workspace registry entry at hibernation;
        the caller is responsible for absorbing the timer's histogram into
        an aggregate first if its quantiles should survive."""
        self._gateway._unregister_stage_timer(name)

    def unregister_journal(self, name: str) -> None:
        self._gateway._unregister_journal(name)

    def get_gateway_status(self) -> dict:
        """Public view of ``Gateway.get_status()`` (the degradation
        surface) so plugin status commands can report degraded/breaker state
        for their own hooks without reaching through private gateway
        internals."""
        return self._gateway.get_status()

    def on(self, hook_name: str, handler: HookHandler, priority: int = 100,
           never_shed: bool = False) -> None:
        self._gateway.bus.on(hook_name, handler, priority=priority, plugin_id=self.id,
                             never_shed=never_shed)
