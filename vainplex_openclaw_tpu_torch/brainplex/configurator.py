"""Per-plugin default config generation + timezone detection
(reference: brainplex/src/configurator.ts).

A copy of ``vainplex_openclaw_tpu/brainplex/configurator.py``, kept here
so the port imports nothing of the JAX package. ``manifest_for`` names the
port's plugin modules, so ``validate_generated`` holds each generated
config against the ``MANIFEST`` of the plugin that will load it."""

from __future__ import annotations

import time
from typing import Optional

# CORE plugins ship in this package; OPTIONAL adds the knowledge engine
# (reference installer.ts:22-34 — membrane/leuko live in separate repos
# there; our suite bundles the equivalents that exist here).
CORE_PLUGINS = ("governance", "cortex", "eventstore", "sitrep")
OPTIONAL_PLUGINS = ("knowledge-engine",)


def detect_timezone() -> str:
    try:
        return time.strftime("%Z") or "UTC"
    except Exception:  # noqa: BLE001
        return "UTC"


# Name-heuristic trust seeding (reference: brainplex/src/configurator.ts:11-31).
# Case-insensitive substring match; FIRST matching row wins, so "admin-forge"
# seeds 70, not 45. Unmatched named agents get 40; the wildcard floor is 10.
# Security note: the name is chosen by whoever registers the agent, and a 70
# seed puts a fresh session (seedFactor 0.8 → 56) above the output gate's
# blockBelow=40 — an operator who does not want name-granted trust should
# edit the generated defaults after init. Ported as-is for reference parity;
# these are bootstrap DEFAULTS for a human-reviewed config, not runtime
# trust, which only ever moves via earned signals (governance/trust.py).
_TRUST_HEURISTICS = (
    (("admin", "root"), 70.0),
    (("main",), 60.0),
    (("review", "cerberus"), 50.0),
    (("forge", "build"), 45.0),
)


def compute_trust_score(agent_name: str) -> float:
    name = agent_name.lower()
    if name == "*":
        return 10.0
    for needles, score in _TRUST_HEURISTICS:
        if any(n in name for n in needles):
            return score
    return 40.0


def build_trust_defaults(agents: list[str]) -> dict[str, float]:
    defaults = {agent: compute_trust_score(agent) for agent in agents}
    defaults["*"] = 10.0  # always include the wildcard floor
    return defaults


def default_config_for(plugin_id: str, agents: Optional[list[str]] = None) -> dict:
    agents = agents or []
    if plugin_id == "governance":
        return {
            "enabled": True,
            "failMode": "open",
            "timezone": detect_timezone(),
            "builtinPolicies": {"credentialGuard": True, "productionSafeguard": True,
                                "rateLimiter": {"maxPerMinute": 15}, "nightMode": False},
            "trust": {"enabled": True,
                      "defaults": build_trust_defaults(agents)},
            "redaction": {"enabled": True},
        }
    if plugin_id == "cortex":
        return {"enabled": True, "languages": "both",
                "bootContext": {"enabled": True},
                "traceAnalyzer": {"enabled": True}}
    if plugin_id == "eventstore":
        return {"enabled": True, "transport": "memory", "prefix": "claw"}
    if plugin_id == "knowledge-engine":
        return {"enabled": True, "embeddings": {"backend": "local"}}
    if plugin_id == "sitrep":
        return {"enabled": True, "intervalMinutes": 30}
    return {"enabled": True}


def generate_configs(plugin_ids: list[str], agents: list[str]) -> dict[str, dict]:
    return {pid: default_config_for(pid, agents) for pid in plugin_ids}


def manifest_for(plugin_id: str):
    """Resolve the installed plugin's manifest, or None if unknown."""
    from importlib import import_module

    modules = {
        "governance": "vainplex_openclaw_tpu_torch.governance.plugin",
        "cortex": "vainplex_openclaw_tpu_torch.cortex.plugin",
        "eventstore": "vainplex_openclaw_tpu_torch.events.plugin",
        "knowledge-engine": "vainplex_openclaw_tpu_torch.knowledge.plugin",
        "sitrep": "vainplex_openclaw_tpu_torch.sitrep.plugin",
    }
    name = modules.get(plugin_id)
    if name is None:
        return None
    try:
        return getattr(import_module(name), "MANIFEST", None)
    except ImportError:
        return None


def validate_generated(configs: dict[str, dict]) -> dict[str, list[str]]:
    """Validate generated configs against each plugin's manifest schema.
    Returns {plugin_id: [errors]} with only failing plugins present."""
    problems: dict[str, list[str]] = {}
    for pid, config in configs.items():
        manifest = manifest_for(pid)
        if manifest is None:
            continue
        errors = manifest.validate_config(config)
        if errors:
            problems[pid] = errors
    return problems
