"""Response Gate: synchronous per-agent validators before message write
(reference: governance/src/response-gate.ts:23-115+).

Validators: ``requiredTools`` (checks the session tool-call log),
``mustMatch``, ``mustNotMatch``. Failures substitute a templated fallback
message instead of a silent block. Invalid regexes block (fail-closed) —
a broken gate must not become a bypass.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Optional

DEFAULT_FALLBACK = ("[response withheld by governance] agent={agent} "
                    "failed={validators}")


@dataclass
class GateResult:
    passed: bool
    failed_validators: list = field(default_factory=list)
    reasons: list = field(default_factory=list)
    fallback_message: Optional[str] = None


class ResponseGate:
    def __init__(self, config: dict):
        self.config = config or {}
        self._regex_cache: dict[str, Optional[re.Pattern]] = {}

    def _regex(self, pattern: str) -> Optional[re.Pattern]:
        if pattern in self._regex_cache:
            return self._regex_cache[pattern]
        try:
            compiled = re.compile(pattern)
        except re.error:
            compiled = None
        self._regex_cache[pattern] = compiled
        return compiled

    def _rule_applies(self, rule: dict, agent_id: str) -> bool:
        agents = rule.get("agents")
        return not agents or agent_id in agents

    def validate(self, content: str, agent_id: str, tool_call_log: list[dict]) -> GateResult:
        if not self.config.get("enabled"):
            return GateResult(True)
        failed, reasons = [], []
        for rule in self.config.get("rules", []):
            if not self._rule_applies(rule, agent_id):
                continue
            for validator in rule.get("validators", []):
                ok, reason = self._run(validator, content, tool_call_log)
                if not ok:
                    vtype = validator.get("type")
                    label = (f"requiredTools:{','.join(validator.get('tools', []))}"
                             if vtype == "requiredTools"
                             else f"{vtype}:{validator.get('pattern')}")
                    failed.append(label)
                    reasons.append(reason)
        if not failed:
            return GateResult(True)
        template = self.config.get("fallbackMessage", DEFAULT_FALLBACK)
        fallback = (template.replace("{agent}", agent_id)
                    .replace("{validators}", ", ".join(failed))
                    .replace("{reasons}", "; ".join(reasons)))
        return GateResult(False, failed, reasons, fallback)

    def _run(self, validator: dict, content: str, log: list[dict]) -> tuple[bool, str]:
        vtype = validator.get("type")
        if vtype == "requiredTools":
            called = {entry.get("tool") for entry in log}
            missing = [t for t in validator.get("tools", []) if t not in called]
            if missing:
                return False, validator.get("message") or \
                    f"Response Gate: required tool(s) not called: {', '.join(missing)}"
            return True, ""
        if vtype == "mustMatch":
            rx = self._regex(validator.get("pattern", ""))
            if rx is None:
                return False, (f"Response Gate: invalid regex pattern "
                               f"/{validator.get('pattern')}/ — blocked (fail-closed)")
            if not rx.search(content):
                return False, validator.get("message") or \
                    f"Response Gate: content must match /{validator.get('pattern')}/"
            return True, ""
        if vtype == "mustNotMatch":
            rx = self._regex(validator.get("pattern", ""))
            if rx is None:
                return False, (f"Response Gate: invalid regex pattern "
                               f"/{validator.get('pattern')}/ — blocked (fail-closed)")
            if rx.search(content):
                return False, validator.get("message") or \
                    f"Response Gate: content must not match /{validator.get('pattern')}/"
            return True, ""
        return True, ""
