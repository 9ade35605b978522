"""Sitrep plugin: interval generation service + /sitrep and /ops commands
(reference: openclaw-sitrep/src/service.ts:28-68).

A copy of ``vainplex_openclaw_tpu/sitrep/plugin.py``, kept here so the port
imports nothing of the JAX package. It loads into the JAX package's
``Gateway`` like the JAX plugin (its commands and services are the port's
copies of ``PluginCommand``/``PluginService``), and its ``model_registry``
collector reads the port's registry book."""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from ..config.loader import load_plugin_config
from ..config.manifest import PluginManifest, enabled_section
from ..core.api import PluginCommand, PluginService
from .aggregator import generate_sitrep, write_sitrep

DEFAULTS = {
    "enabled": True,
    "workspace": None,
    "intervalMinutes": 30,
    "collectors": {
        "systemd_timers": {"enabled": False},
        "nats": {"enabled": True},
        "goals": {"enabled": True},
        "threads": {"enabled": True},
        "errors": {"enabled": True},
        "calendar": {"enabled": False},
        # Ops plane: in-process, no I/O — on by default.
        "gateway": {"enabled": True},
        "stage_quantiles": {"enabled": True},
        "resilience": {"enabled": True},
        "journal": {"enabled": True},
        # Sharded-gateway health: skipped unless a cluster
        # supervisor registered ``cluster.status`` on this gateway.
        "cluster": {"enabled": True},
        # Workspace lifecycle: hibernation/wake + tier health.
        "lifecycle": {"enabled": True},
        "slo": {"enabled": True},
        # ReDoS screening rollup: reads governance status only.
        "pattern_safety": {"enabled": True},
        # Versioned serving: registry version book, swap
        # counters, weight-paging view. In-process, no I/O.
        "model_registry": {"enabled": True},
    },
    "customCollectors": [],
}

# The ops collectors /ops always renders, whatever the sitrep interval
# config says — the live dashboard must not go dark because an operator
# trimmed the periodic report.
OPS_COLLECTORS = ("gateway", "stage_quantiles", "resilience", "journal",
                  "cluster", "lifecycle", "slo", "pattern_safety",
                  "model_registry")

MANIFEST = PluginManifest(
    id="sitrep",
    description="Interval situation reports aggregated from pluggable collectors",
    config_schema={
        "type": "object",
        "properties": {
            "enabled": {"type": "boolean"},
            "workspace": {"type": ["string", "null"]},
            "intervalMinutes": {"type": "number", "minimum": 0},
            "collectors": {"type": "object",
                           "additionalProperties": enabled_section()},
            "customCollectors": {"type": "array", "items": {
                "type": "object", "required": ["id", "command"],
                "properties": {"id": {"type": "string"},
                               "command": {"type": "string"}}}},
        },
    },
    commands=("sitrep", "ops"),
    hooks=("gateway_stop",),
)


class SitrepPlugin:
    id = "sitrep"
    manifest = MANIFEST

    def __init__(self, workspace: Optional[str] = None,
                 clock: Callable[[], float] = time.time, wall_timers: bool = True):
        self._workspace_override = workspace
        self.clock = clock
        self.wall_timers = wall_timers
        self.config: dict = {}
        self._stop = threading.Event()
        self._gateway = None
        self._api = None

    def register(self, api) -> None:
        self.config = load_plugin_config(self.id, api.plugin_config,
                                         defaults=DEFAULTS, logger=api.logger)
        if not self.config.get("enabled", True):
            api.logger.info("disabled via config")
            return
        self.logger = api.logger
        self._api = api
        self._gateway = api._gateway
        api.register_service(PluginService(id="sitrep", start=self._start,
                                           stop=lambda ctx: self._stop.set()))
        api.register_command(PluginCommand(
            name="sitrep", description="Generate a situation report now",
            handler=lambda ctx: {"text": self.sitrep_text()}))
        api.register_command(PluginCommand(
            name="ops", description="Live ops dashboard: gateway health, "
                                    "per-edge stage quantiles, resilience "
                                    "counters, SLO rollup",
            handler=lambda ctx: {"text": self.ops_text()}))

    def _ctx(self) -> dict:
        ctx = {"workspace": (self._workspace_override or self.config.get("workspace")
                             or ".")}
        gw = self._gateway
        if gw is None:
            return ctx
        if "eventstore.status" in gw.methods:
            ctx["eventstore_status"] = lambda: gw.call_method("eventstore.status")
        if "governance.status" in gw.methods:
            # Memoized per generation: get_status() eagerly estimates the
            # engine timer's quantiles — cap that cost at once per report
            # however many collectors end up reading it.
            gov_memo: list = []

            def governance_status() -> dict:
                if not gov_memo:
                    gov_memo.append(gw.call_method("governance.status"))
                return gov_memo[0]

            ctx["governance_status"] = governance_status
        if "cortex.patternSafety" in gw.methods:
            ctx["cortex_pattern_safety"] = (
                lambda: gw.call_method("cortex.patternSafety"))
        if "cluster.status" in gw.methods:
            # Registered by ClusterSupervisor.attach_gateway.
            ctx["cluster_status"] = lambda: gw.call_method("cluster.status")
        # Ops plane: gateway degradation surface (through the
        # public PluginApi view) + every registered StageTimer,
        # snapshotted once per report generation — the stage_quantiles
        # and slo collectors must read the SAME view (two snapshots could
        # disagree about samples landing between them), and quantile
        # estimation is not free to repeat per collector.
        # register() sets _api and _gateway together, and gw is non-None
        # here — the public PluginApi view is always available.
        ctx["gateway_status"] = self._api.get_gateway_status
        memo: list = []

        def stage_snapshots() -> dict:
            if not memo:
                memo.append({name: timer.snapshot()
                             for name, timer in sorted(gw.stage_timers.items())})
            return memo[0]

        ctx["stage_timers"] = stage_snapshots
        return ctx

    def generate(self) -> dict:
        report = generate_sitrep(self.config, self._ctx(), self.logger, self.clock)
        write_sitrep(report, self._ctx()["workspace"])
        return report

    def _start(self, ctx) -> None:
        self.generate()  # initial sitrep on start (reference service.ts:32)
        minutes = self.config.get("intervalMinutes") or 0
        if minutes > 0 and self.wall_timers:
            def loop():
                while not self._stop.wait(minutes * 60):
                    try:
                        self.generate()
                    except Exception as exc:  # noqa: BLE001
                        self.logger.error(f"sitrep generation failed: {exc}")

            threading.Thread(target=loop, daemon=True, name="sitrep").start()

    def sitrep_text(self) -> str:
        report = self.generate()
        lines = [f"📋 sitrep: {report['health']} ({report['generatedAt']})"]
        for name, result in report["collectors"].items():
            if result["status"] == "skipped":
                continue
            icon = {"ok": "✅", "warn": "⚠️", "error": "❌"}.get(result["status"], "•")
            lines.append(f"  {icon} {name}: {result['summary']}")
        return "\n".join(lines)

    # ── /ops: the live dashboard ───────────────────────────

    def ops_report(self) -> dict:
        """Consolidated ops report: the ops collectors forced on,
        whatever the interval-sitrep config enables."""
        cfg = dict(self.config)
        collectors = dict(cfg.get("collectors", {}))
        for name in OPS_COLLECTORS:
            collectors[name] = {**collectors.get(name, {}), "enabled": True}
        # The periodic report's other collectors stay as configured; /ops
        # is about the serving plane, not goals/calendar.
        for name in list(collectors):
            if name not in OPS_COLLECTORS:
                collectors[name] = {**collectors.get(name, {}),
                                    "enabled": False}
        cfg["collectors"] = collectors
        cfg["customCollectors"] = []
        return generate_sitrep(cfg, self._ctx(), self.logger, self.clock)

    def ops_text(self) -> str:
        report = self.ops_report()
        results = report["collectors"]
        icon = {"ok": "✅", "warn": "⚠️", "error": "❌", "skipped": "•"}
        lines = [f"🛰 ops: {report['health']} ({report['generatedAt']})"]
        gw = results.get("gateway", {})
        lines.append(f"  {icon.get(gw.get('status'), '•')} gateway: "
                     f"{gw.get('summary', 'n/a')}")
        for item in gw.get("items", []):
            adm = item.get("admission") or {}
            if adm.get("enabled"):
                lines.append(f"    admission: depth={adm.get('queueDepth')} "
                             f"(max {adm.get('maxQueueDepth')}), "
                             f"admitted={adm.get('admitted')} "
                             f"shed={adm.get('shed')} "
                             f"byTenant={adm.get('shedByTenant')}")
            if item.get("degraded"):
                lines.append(f"    degraded: {item['degraded']}")
            if item.get("breakers"):
                lines.append(f"    breakers: {item['breakers']}")
        res = results.get("resilience", {})
        lines.append(f"  {icon.get(res.get('status'), '•')} resilience: "
                     f"{res.get('summary', 'n/a')}")
        cl = results.get("cluster", {})
        if cl.get("status") != "skipped":
            lines.append(f"  {icon.get(cl.get('status'), '•')} cluster: "
                         f"{cl.get('summary', 'n/a')}")
        lc = results.get("lifecycle", {})
        if lc.get("status") != "skipped":
            lines.append(f"  {icon.get(lc.get('status'), '•')} lifecycle: "
                         f"{lc.get('summary', 'n/a')}")
        mr = results.get("model_registry", {})
        if mr.get("status") != "skipped":
            lines.append(f"  {icon.get(mr.get('status'), '•')} models: "
                         f"{mr.get('summary', 'n/a')}")
            for item in mr.get("items", [])[:4]:
                canary = item.get("canary") or {}
                paging = item.get("paging") or {}
                lines.append(
                    f"    {item.get('registry')}: active={item.get('active')}"
                    f" canary={canary.get('version')}@{canary.get('fraction')}"
                    f" swaps={item.get('swaps')}"
                    f" rollbacks={item.get('rollbacks')}"
                    f" paged={len(paging.get('paged') or [])}"
                    f" wakeP99={paging.get('wakeP99Ms')}ms")
        slo = results.get("slo", {})
        lines.append(f"  {icon.get(slo.get('status'), '•')} slo: "
                     f"{slo.get('summary', 'n/a')}")
        for b in slo.get("items", [])[:10]:
            lines.append(f"    BREACH {b['edge']}/{b['stage']}: "
                         f"p99 {b['p99Ms']}ms > budget {b['budgetMs']}ms")
        if slo.get("adversarial"):
            lines.append(f"    {slo['adversarial'].get('line', 'adversarial: n/a')}")
        ps = results.get("pattern_safety", {})
        lines.append(f"  {icon.get(ps.get('status'), '•')} pattern_safety: "
                     f"{ps.get('summary', 'n/a')}")
        for item in ps.get("items", [])[:5]:
            where = item.get("policyId") or item.get("category") or "?"
            lines.append(f"    DEMOTED {item.get('source', '?')}:{where}: "
                         f"{item.get('pattern')!r} — {item.get('issue')}")
        sq = results.get("stage_quantiles", {})
        if sq.get("status") == "ok":
            lines.append(f"  📈 stages ({sq['summary']}):")
            for item in sq.get("items", [])[:40]:
                lines.append(
                    f"    {item['edge']}/{item['stage']}: "
                    f"n={item['count']} p50={item.get('p50')}ms "
                    f"p95={item.get('p95')}ms p99={item.get('p99')}ms")
        return "\n".join(lines)
