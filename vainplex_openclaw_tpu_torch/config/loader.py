"""External-config loading with bootstrap-write.

A copy of ``vainplex_openclaw_tpu/config/loader.py``, kept here so the port
imports nothing of the JAX package; a plugin's config resolves the same in
both packages:

- The gateway's own config carries only a minimal inline pointer per plugin:
  ``{"enabled": bool, "configPath": "..."}``.
- The full config lives at ``~/.openclaw/plugins/<id>/config.json`` (or at the
  explicit ``configPath``; ``OPENCLAW_HOME`` moves ``~/.openclaw``),
  bootstrap-written with defaults on first run.
- Legacy-inline heuristic: an inline config with substantive keys beyond
  ``enabled``/``configPath`` is treated as the full config.
- All resolution is fail-open: unreadable/invalid external files fall back to
  defaults with a warning, never an exception.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Optional

from ..core.api import PluginLogger, make_logger
from ..storage.atomic import read_json, write_json_atomic

_POINTER_KEYS = {"enabled", "configPath", "config_path"}


def plugins_dir(home: Optional[str | Path] = None) -> Path:
    home = Path(home) if home else Path(os.environ.get("OPENCLAW_HOME") or (Path.home() / ".openclaw"))
    return home / "plugins"


def deep_merge(defaults: Any, override: Any) -> Any:
    """Deep-default: every key in ``defaults`` survives unless overridden."""
    if isinstance(defaults, dict) and isinstance(override, dict):
        out = dict(defaults)
        for k, v in override.items():
            out[k] = deep_merge(defaults.get(k), v) if k in defaults else v
        return out
    return defaults if override is None else override


def _is_legacy_inline(inline: dict) -> bool:
    return any(k not in _POINTER_KEYS for k in inline)


def load_plugin_config(
    plugin_id: str,
    inline: Optional[dict] = None,
    defaults: Optional[dict] = None,
    home: Optional[str | Path] = None,
    logger: Optional[PluginLogger] = None,
    bootstrap: bool = True,
) -> dict:
    """Resolve a plugin's full config; returns defaults ⊕ external ⊕ inline."""
    logger = logger or make_logger(plugin_id)
    inline = dict(inline or {})
    defaults = dict(defaults or {})
    enabled = bool(inline.get("enabled", True))

    if _is_legacy_inline(inline):
        merged = deep_merge(defaults, {k: v for k, v in inline.items() if k not in _POINTER_KEYS})
        merged["enabled"] = enabled
        return merged

    config_path = inline.get("configPath") or inline.get("config_path")
    path = Path(config_path) if config_path else plugins_dir(home) / plugin_id / "config.json"

    external: Optional[dict] = None
    if path.exists():
        try:
            loaded = json.loads(path.read_text(encoding="utf-8"))
            if isinstance(loaded, dict):
                external = loaded
            else:
                logger.warn(f"config at {path} is not an object; using defaults")
        except (OSError, json.JSONDecodeError) as exc:
            logger.warn(f"failed to read config at {path}: {exc}; using defaults")
    elif bootstrap:
        try:
            write_json_atomic(path, defaults)
            logger.info(f"bootstrapped default config at {path}")
        except OSError as exc:
            logger.warn(f"could not bootstrap config at {path}: {exc}")

    merged = deep_merge(defaults, external or {})
    # The inline pointer's enabled:false always wins: an operator who disabled
    # a plugin in openclaw.json must not have it re-enabled by the external
    # file (including the bootstrap-written defaults, which carry enabled:true).
    external_enabled = bool(external.get("enabled", True)) if external else True
    merged["enabled"] = enabled and external_enabled
    return merged


def read_openclaw_config(home: Optional[str | Path] = None) -> dict:
    """Read the gateway-level ``openclaw.json`` (empty dict if absent)."""
    home = Path(home) if home else Path(os.environ.get("OPENCLAW_HOME") or (Path.home() / ".openclaw"))
    return read_json(home / "openclaw.json", {}) or {}
