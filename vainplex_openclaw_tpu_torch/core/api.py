"""A copy of the ``PluginCommand`` and ``PluginService`` dataclasses of
``vainplex_openclaw_tpu/core/api.py``, with the same fields. A gateway
stores a command or a service by its fields, so the port's registrations
serve in the JAX package's ``Gateway``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional


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
