"""Config merging for the port.

``deep_merge`` is a copy of ``vainplex_openclaw_tpu/config/loader.py``'s,
kept here so the port imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Any


def deep_merge(defaults: Any, override: Any) -> Any:
    """Deep-default: every key in ``defaults`` survives unless overridden."""
    if isinstance(defaults, dict) and isinstance(override, dict):
        out = dict(defaults)
        for k, v in override.items():
            out[k] = deep_merge(defaults.get(k), v) if k in defaults else v
        return out
    return defaults if override is None else override
