"""A copy of the ``PluginCommand`` and ``PluginService`` dataclasses of
``vainplex_openclaw_tpu/core/api.py``, with the same fields, and of its
default logger (``make_logger``). A gateway stores a command or a service
by its fields, so the port's registrations serve in the JAX package's
``Gateway``.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Protocol


class PluginLogger(Protocol):
    def info(self, msg: str) -> None: ...
    def warn(self, msg: str) -> None: ...
    def error(self, msg: str) -> None: ...
    def debug(self, msg: str) -> None: ...


@dataclass
class _StdLogger:
    """Default logger: ``[plugin-id]``-prefixed lines into :mod:`logging`."""

    prefix: str
    _log: logging.Logger = field(
        default_factory=lambda: logging.getLogger("openclaw"))

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
