"""Governance plugin: hook wiring, commands, gateway methods
(reference: governance/index.ts:60-118 + src/hooks.ts:733-920).

Hook layout (priorities follow the reference):
- ``before_tool_call``  @1000 — enforcement (deny → block, 2fa → approval)
- ``after_tool_call``   @900  — trust feedback + tool-call log ring +
                                 sub-agent spawn registration
- ``message_sending``   @1000 — outbound enforcement
- ``before_message_write`` @1000 — response gate + output validation (wired
                                 by the validation subsystem when enabled)
- ``before_agent_start`` @5   — trust context injection
- ``session_start`` @1, ``session_end`` @999, ``gateway_start`` @1,
  ``gateway_stop`` @999

Every handler is wrapped fail-open/fail-closed per ``failMode``
(reference src/hooks.ts:232-241).

A copy of ``vainplex_openclaw_tpu/governance/plugin.py`` with JAX's
``MANIFEST``, ``DEFAULTS``, hooks and priorities, and these deviations:

- ``device=None`` (the card) is passed to ``make_local_call_llm`` for the
  config-only local stage 3; tests pass ``device="cpu"``;
- ``_init_validation`` lets an error of the device
  (``device.is_device_error``: no card, a kernel that did not build)
  propagate out of ``register``, where the JAX package logs "local stage-3
  unavailable" and serves with no stage 3; any other ``RuntimeError`` (no
  checkpoint) is logged as there;
- ``_fail`` re-raises an error of the device, where the JAX package returns
  the failMode result (``None``, allow, under ``failMode: "open"``);
- ``twoFa`` is the port's own ``governance/approval/`` (TOTP batches, the
  Matrix notifier and the ``matrix-2fa-poller`` service), ``erc8004`` its
  own ``governance/security/``, and ``redaction`` its own
  ``governance/redaction/``: each is wired as in the JAX package, its
  catches around host work only.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, Optional

from ..config.loader import load_plugin_config
from ..config.manifest import PluginManifest, enabled_section
from ..core.api import PluginCommand, PluginService
from ..device import DeviceLike, is_device_error
from .engine import GovernanceEngine
from .util import extract_agent_ids, resolve_agent_id

TOOL_LOG_MAX = 50  # per-session ring for the response gate

MANIFEST = PluginManifest(
    id="governance",
    description="Agent firewall: policies, risk, trust, audit, redaction, "
                "output validation, 2FA approval",
    config_schema={
        "type": "object",
        "properties": {
            "enabled": {"type": "boolean"},
            "failMode": {"type": "string", "enum": ["open", "closed"]},
            "timezone": {"type": "string"},
            "workspace": {"type": ["string", "null"]},
            "builtinPolicies": {"type": "object", "properties": {
                "nightMode": {"type": "boolean"},
                "credentialGuard": {"type": "boolean"},
                "productionSafeguard": {"type": "boolean"},
                "rateLimiter": {"type": ["object", "boolean"], "properties": {
                    "maxPerMinute": {"type": "integer", "minimum": 1}}},
            }},
            "policies": {"type": "array", "items": {"type": "object",
                                                    "required": ["id", "rules"]}},
            "timeWindows": {"type": "object"},
            "toolRiskOverrides": {"type": "object",
                                  "additionalProperties": {"type": "number",
                                                           "minimum": 0, "maximum": 100}},
            "trust": enabled_section(),
            "sessionTrust": enabled_section(),
            "audit": enabled_section(
                retentionDays={"type": "integer", "minimum": 0},
                redactPatterns={"type": "array", "items": {"type": "string"}}),
            "storage": {"type": "object", "properties": {
                "journal": {"type": ["boolean", "object"]}}},
            "twoFa": enabled_section(),
            "validation": enabled_section(),
            "redaction": enabled_section(
                failMode={"type": "string", "enum": ["open", "closed"]}),
            "erc8004": enabled_section(),
            "internalChannels": {"type": "array", "items": {"type": "string"}},
        },
    },
    commands=("governance", "trust"),
    gateway_methods=("governance.status", "governance.trust"),
    hooks=("before_tool_call", "after_tool_call", "message_sending",
           "before_message_write", "before_agent_start", "session_start",
           "session_end", "gateway_stop", "message_received",
           "tool_result_persist"),
)

DEFAULTS = {
    "enabled": True,
    "failMode": "open",  # open | closed
    "timezone": "local",
    "workspace": None,
    "builtinPolicies": {
        "nightMode": False,
        "credentialGuard": True,
        "productionSafeguard": True,
        "rateLimiter": {"maxPerMinute": 15},
    },
    "policies": [],
    "timeWindows": {},
    "toolRiskOverrides": {},
    "trust": {"enabled": True},
    "sessionTrust": {"enabled": True},
    "audit": {"enabled": True, "retentionDays": 90, "redactPatterns": []},
    # storage.journal: audit records ride the shared group-commit
    # workspace journal (legacy flush cadence preserved); false restores the
    # legacy buffer + day-file append path end-to-end.
    "storage": {"journal": True},
    "twoFa": {"enabled": False},
    "validation": {"enabled": False, "facts": [], "factFiles": [],
                   # serve: None inherits models/serve.SERVE_DEFAULTS
                   # (continuous batching on; continuousBatching:false is
                   # the one-shot escape hatch)
                   "llmValidator": {"enabled": False, "local": False,
                                    "failMode": "open",
                                    "checkpointDir": None, "serve": None},
                   "responseGate": {"enabled": False, "rules": []}},
    "redaction": {"enabled": False},
    "erc8004": {"enabled": False},
    "internalChannels": [],  # channels NOT treated as external comms
}


class GovernancePlugin:
    id = "governance"
    manifest = MANIFEST

    def __init__(self, workspace: Optional[str] = None,
                 clock: Callable[[], float] = time.time,
                 approval_2fa=None, call_llm=None,
                 device: DeviceLike = None):
        self._workspace_override = workspace
        self.clock = clock
        self.engine: Optional[GovernanceEngine] = None
        self.config: dict = {}
        self.tool_call_log: dict[str, deque] = {}
        self.approval_2fa = approval_2fa  # injectable for tests; else built from config
        self.call_llm = call_llm          # DI'd LLM seam (Ollama, or the local encoder)
        self.device = device              # the local stage 3's device
        self.redaction_state = None
        self.response_gate = None
        self.fact_registry = None
        self.erc8004 = None

    # ── registration ─────────────────────────────────────────────────

    def register(self, api) -> None:
        self.config = load_plugin_config(self.id, api.plugin_config,
                                         defaults=DEFAULTS, logger=api.logger)
        if not self.config.get("enabled", True):
            api.logger.info("disabled via config")
            return
        workspace = (self._workspace_override or self.config.get("workspace")
                     or api.config.get("workspace") or ".")
        self.logger = api.logger
        self.engine = GovernanceEngine(self.config, workspace, api.logger, clock=self.clock)
        self.engine.set_known_agents(extract_agent_ids(api.config))
        if self.engine.journal is not None and hasattr(api, "register_journal"):
            api.register_journal(f"journal:{workspace}", self.engine.journal)

        api.register_service(PluginService(
            id="governance-engine",
            start=lambda ctx: self.engine.start(),
            stop=lambda ctx: self.engine.stop(),
        ))

        self._init_redaction(api)
        self._init_validation(api)
        self._init_2fa(api)
        self._init_erc8004(api)

        api.on("before_tool_call", self.handle_before_tool_call, priority=1000)
        # never_shed: trust feedback + sub-agent spawn linking feed later
        # VERDICTS (parent-keyed policies, trust tiers) — admission
        # shedding must not drop them with the observability handlers.
        api.on("after_tool_call", self.handle_after_tool_call, priority=900,
               never_shed=True)
        api.on("message_sending", self.handle_message_sending, priority=1000)
        api.on("before_message_write", self.handle_before_message_write, priority=1000)
        api.on("before_agent_start", self.handle_before_agent_start, priority=5)
        api.on("session_start", self.handle_session_start, priority=1)
        api.on("session_end", self.handle_session_end, priority=999)
        api.on("gateway_stop", lambda e, c: self.engine.stop(), priority=999)

        api.register_command(PluginCommand(
            name="governance", description="Governance engine dashboard",
            handler=lambda ctx: {"text": self.status_text()}))
        api.register_command(PluginCommand(
            name="trust", description="Agent trust dashboard",
            handler=lambda ctx: {"text": self.trust_text(ctx.get("args", ""))}))
        api.register_gateway_method("governance.status", lambda: self.engine.get_status())
        api.register_stage_timer("governance", self.engine.timer)
        api.register_gateway_method("governance.trust",
                                    lambda agent_id=None, session_key=None:
                                    self.engine.get_trust(agent_id, session_key))

    # ── subsystem wiring ─────────────────────────────────────────────

    def _init_redaction(self, api) -> None:
        if not self.config.get("redaction", {}).get("enabled"):
            return
        from .redaction import init_redaction, register_redaction_hooks

        self.redaction_state = init_redaction(self.config["redaction"], api.logger,
                                              clock=self.clock)
        register_redaction_hooks(api, self.redaction_state)
        # Audit records must never carry live credentials (vault resolution
        # runs before governance audits the params — verified leak otherwise).
        credential_engine = self.redaction_state.credential_only_engine
        self.engine.audit_trail.scrubber = lambda ctx: credential_engine.scan(ctx).output

    def _init_validation(self, api) -> None:
        vcfg = self.config.get("validation", {})
        if not vcfg.get("enabled"):
            return
        from .validation import FactRegistry, LlmValidator, OutputValidator, ResponseGate

        registry = FactRegistry(vcfg.get("facts", []), api.logger)
        for path in vcfg.get("factFiles", []):
            registry.load_facts_from_file(path)
        llm = None
        lcfg = vcfg.get("llmValidator", {})
        call_llm = self.call_llm
        if lcfg.get("enabled") and call_llm is None and lcfg.get("local"):
            # Config-only local stage 3: the on-device triage encoder serves
            # the verdict contract (models/serve.py) — continuous batching
            # by default, one-shot behind
            # serve.continuousBatching:false. A missing checkpoint degrades
            # to no-stage-3 with the reason logged, matching the DI'd seam's
            # absent behavior; a missing card or a failed kernel build
            # raises.
            try:
                from ..models.serve import make_local_call_llm

                call_llm = make_local_call_llm(lcfg.get("checkpointDir"),
                                               serve_cfg=lcfg.get("serve"),
                                               device=self.device)
                batcher = getattr(call_llm, "batcher", None)
                if batcher is not None:
                    # serve-path attribution (queue/batch/prefill/decode)
                    # rides the same status surface as every subsystem.
                    api.register_stage_timer("serve", batcher.timer)
                api.logger.info(
                    "stage-3 validator: local encoder serve path "
                    f"({'continuous batching' if batcher else 'one-shot'})")
            except RuntimeError as exc:
                if is_device_error(exc):
                    raise
                api.logger.warn(f"local stage-3 unavailable: {exc}")
        if lcfg.get("enabled") and call_llm is not None:
            llm = LlmValidator(call_llm, api.logger,
                               fail_mode=lcfg.get("failMode", "open"),
                               clock=self.clock)
        self.fact_registry = registry
        self.engine.output_validator = OutputValidator(vcfg, registry, api.logger, llm)
        self.response_gate = ResponseGate(vcfg.get("responseGate", {}))

    def _init_2fa(self, api) -> None:
        tcfg = self.config.get("twoFa", {})
        if not tcfg.get("enabled") or self.approval_2fa is not None:
            if self.approval_2fa is not None:
                api.on("message_received", self.handle_2fa_code, priority=100,
                       never_shed=True)
            return
        from .approval import Approval2FA

        try:
            self.approval_2fa = Approval2FA(tcfg, api.logger, clock=self.clock)
        except ValueError as exc:
            api.logger.error(f"2FA disabled: {exc}")
            return
        api.on("message_received", self.handle_2fa_code, priority=100,
               never_shed=True)
        creds_path = tcfg.get("matrixCredsPath")
        if creds_path:
            from .approval.matrix import MatrixNotifier
            from .approval.poller import MatrixPoller, load_matrix_credentials

            creds = load_matrix_credentials(creds_path)
            if creds:
                # Outbound: batched approval prompts go INTO the room
                # (ref hooks.ts:812-874); inbound: the poller reads codes
                # back out. Together they close the 2FA loop end-to-end.
                notifier = MatrixNotifier(creds, api.logger, clock=self.clock)
                self.approval_2fa.set_notify_fn(notifier.notify_fn())
                poller = MatrixPoller(
                    creds,
                    lambda code, sender: self.approval_2fa.try_resolve_any(code, sender),
                    api.logger,
                    interval_s=tcfg.get("matrixPollIntervalSeconds", 2.0))
                api.register_service(PluginService(
                    id="matrix-2fa-poller",
                    start=lambda ctx: poller.start(),
                    stop=lambda ctx: poller.stop()))

    def _init_erc8004(self, api) -> None:
        ecfg = self.config.get("erc8004", {})
        if not ecfg.get("enabled"):
            return
        from .security import ERC8004Provider

        self.erc8004 = ERC8004Provider(ecfg, api.logger, clock=self.clock)

    # ── helpers ──────────────────────────────────────────────────────

    def _identity(self, ctx: dict) -> tuple[str, str]:
        agent_id = resolve_agent_id(ctx, logger=self.logger)
        session_key = ctx.get("session_key") or ctx.get("session_id") or agent_id
        return agent_id, session_key

    def _fail(self, exc: Exception, where: str) -> Optional[dict]:
        if is_device_error(exc):
            raise exc
        self.logger.error(f"{where} failed: {exc}")
        if self.config.get("failMode") == "closed":
            return {"block": True, "block_reason": f"Governance error (closed-fail): {exc}"}
        return None

    def log_tool_call(self, session_key: str, tool_name: str, error=None) -> None:
        ring = self.tool_call_log.setdefault(session_key, deque(maxlen=TOOL_LOG_MAX))
        ring.append({"tool": tool_name, "ts": self.clock(), "error": error})

    # ── hook handlers ────────────────────────────────────────────────

    def handle_before_tool_call(self, event: dict, ctx: dict):
        try:
            agent_id, session_key = self._identity(ctx)
            ectx = self.engine.build_context(
                "before_tool_call", agent_id, session_key,
                tool_name=event.get("tool_name"), tool_params=event.get("params"),
                channel=ctx.get("channel_id"), metadata=ctx.get("metadata"),
            )
            verdict = self.engine.evaluate(ectx)
            if verdict.action == "deny":
                return {"block": True, "block_reason": verdict.reason}
            if verdict.action == "2fa":
                return self._handle_2fa(event, ctx, agent_id, session_key, verdict)
            return None
        except Exception as exc:  # noqa: BLE001
            return self._fail(exc, "before_tool_call")

    def _handle_2fa(self, event: dict, ctx: dict, agent_id: str,
                    session_key: str, verdict):
        if self.approval_2fa is None:
            # No approver wired: 2FA demands a human; without one the only
            # safe answer is deny (never silently allow a 2fa-gated call).
            return {"block": True,
                    "block_reason": f"2FA required but no approver configured: {verdict.reason}"}
        return self.approval_2fa.request(agent_id, session_key,
                                         event.get("tool_name"), event.get("params"),
                                         verdict.reason)

    def handle_after_tool_call(self, event: dict, ctx: dict):
        try:
            agent_id, session_key = self._identity(ctx)
            self.log_tool_call(session_key, event.get("tool_name"), event.get("error"))
            if event.get("error") is None:
                self.engine.record_tool_success(agent_id, session_key)
            # Sub-agent spawn detection (reference src/hooks.ts:391-440):
            # a successful sessions_spawn links child session → parent.
            if event.get("tool_name") == "sessions_spawn" and event.get("error") is None:
                child = None
                result = event.get("result")
                if isinstance(result, dict):
                    child = result.get("session_key") or result.get("sessionKey")
                if child:
                    self.engine.register_sub_agent(session_key, child)
            return None
        except Exception as exc:  # noqa: BLE001
            self._fail(exc, "after_tool_call")
            return None

    def handle_message_sending(self, event: dict, ctx: dict):
        try:
            agent_id, session_key = self._identity(ctx)
            ectx = self.engine.build_context(
                "message_sending", agent_id, session_key,
                message_content=event.get("content"), message_to=event.get("to"),
                channel=ctx.get("channel_id"),
            )
            verdict = self.engine.evaluate(ectx)
            if verdict.action == "deny":
                return {"block": True, "block_reason": verdict.reason}
            # External comms additionally pass output validation (Stage 3 LLM
            # only fires here — reference hooks.ts:209-229).
            if self.engine.output_validator is not None and self._is_external(event, ctx):
                result = self.engine.output_validator.validate(
                    event.get("content") or "", ectx.trust.session.score, is_external=True)
                if result.verdict == "block":
                    return {"block": True, "block_reason": result.reason}
                if result.verdict == "flag":
                    self.logger.warn(f"output validation flag (external): {result.reason}")
            return None
        except Exception as exc:  # noqa: BLE001
            return self._fail(exc, "message_sending")

    def _is_external(self, event: dict, ctx: dict) -> bool:
        """External-comm detection (reference detectExternalComm,
        hooks.ts:96-146): explicit recipient, or a channel not listed as
        internal."""
        if event.get("to"):
            return True
        channel = ctx.get("channel_id")
        if not channel:
            return False
        return channel not in (self.config.get("internalChannels") or [])

    def handle_before_message_write(self, event: dict, ctx: dict):
        """Synchronous response gate + output validation stages 1-2
        (must stay sync — reference engine.ts:360-365)."""
        try:
            agent_id, session_key = self._identity(ctx)
            content = event.get("content") or ""
            if self.response_gate is not None:
                log = list(self.tool_call_log.get(session_key, ()))
                gate = self.response_gate.validate(content, agent_id, log)
                if not gate.passed:
                    return {"block": True, "fallback_message": gate.fallback_message,
                            "block_reason": "; ".join(gate.reasons)}
            if self.engine.output_validator is not None:
                session = self.engine.session_trust.get_session_trust(session_key, agent_id)
                result = self.engine.output_validator.validate(content, session.score,
                                                               is_external=False)
                if result.verdict == "block":
                    return {"block": True, "block_reason": result.reason,
                            "fallback_message": f"[response withheld: {result.reason}]"}
                if result.verdict == "flag":
                    self.logger.warn(f"output validation flag: {result.reason}")
            return None
        except Exception as exc:  # noqa: BLE001
            return self._fail(exc, "before_message_write")

    def handle_2fa_code(self, event: dict, ctx: dict):
        """Intercept 6-digit codes on message_received (prio 100, reference
        hooks.ts:674-731, 854-856)."""
        try:
            import re as _re

            content = (event.get("content") or "").strip()
            m = _re.fullmatch(r"\s*(\d{6})\s*", content)
            if not m or self.approval_2fa is None:
                return None
            sender = ctx.get("sender_id") or ctx.get("agent_id") or "?"
            conversation = ctx.get("session_key") or ctx.get("channel_id") or "?"
            result = self.approval_2fa.try_resolve(m.group(1), sender, conversation)
            if result["status"] == "no_pending":
                return None
            return {"handled": True, "twofa": result}
        except Exception as exc:  # noqa: BLE001
            self._fail(exc, "2fa_code")
            return None

    def handle_before_agent_start(self, event: dict, ctx: dict):
        try:
            agent_id, session_key = self._identity(ctx)
            trust = self.engine.get_trust(agent_id, session_key)
            agent = trust["agent"]
            context = (f"[governance] agent={agent_id} trust={agent['score']:.0f} "
                       f"tier={agent['tier']}")
            if self.erc8004 is not None:
                token_id = (self.config.get("erc8004", {}).get("agentTokens") or {}).get(agent_id)
                if token_id is not None:
                    rep = self.erc8004.lookup_reputation(int(token_id))
                    if rep.get("exists"):
                        context += (f" onchain={rep['reputation_score']} "
                                    f"({rep['tier']}, {rep['feedback_count']} reviews)")
            return {"prepend_context": context}
        except Exception as exc:  # noqa: BLE001
            self._fail(exc, "before_agent_start")
            return None

    def handle_session_start(self, event: dict, ctx: dict):
        try:
            agent_id, session_key = self._identity(ctx)
            self.engine.handle_session_start(session_key, agent_id)
        except Exception as exc:  # noqa: BLE001
            self._fail(exc, "session_start")
        return None

    def handle_session_end(self, event: dict, ctx: dict):
        try:
            _, session_key = self._identity(ctx)
            self.engine.handle_session_end(session_key)
            self.tool_call_log.pop(session_key, None)
        except Exception as exc:  # noqa: BLE001
            self._fail(exc, "session_end")
        return None

    # ── dashboards ───────────────────────────────────────────────────

    def status_text(self) -> str:
        s = self.engine.get_status()
        st = s["stats"]
        return (
            f"🛡️ governance: {'on' if s['enabled'] else 'off'} | "
            f"policies={s['policyCount']} failMode={s['failMode']}\n"
            f"evaluations={st['totalEvaluations']} "
            f"(allow={st['allowCount']} deny={st['denyCount']}) "
            f"avg={st['avgEvaluationUs']}µs\n"
            f"audit: {self.engine.audit_trail.stats()}"
        )

    def trust_text(self, args: str = "") -> str:
        agent_id = args.strip() or None
        if agent_id:
            t = self.engine.get_trust(agent_id)
            a = t["agent"]
            return (f"🤝 {agent_id}: score={a['score']:.0f} tier={a['tier']} "
                    f"successes={a['signals']['successCount']} "
                    f"violations={a['signals']['violationCount']} "
                    f"streak={a['signals']['cleanStreak']}")
        store = self.engine.get_trust()
        lines = ["🤝 agent trust:"]
        for aid, a in sorted(store["agents"].items()):
            lines.append(f"  {aid}: {a['score']:.0f} ({a['tier']})")
        return "\n".join(lines)
