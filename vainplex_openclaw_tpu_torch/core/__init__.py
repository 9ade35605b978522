"""Plugin kernel: the hook/service/command contract every subsystem plugs into."""

from .api import (
    HookBus,
    HookHandler,
    PluginApi,
    PluginCommand,
    PluginLogger,
    PluginService,
    list_logger,
    make_logger,
)
from .gateway import Gateway, ToolCallDecision, MessageWriteDecision

__all__ = [
    "Gateway",
    "HookBus",
    "HookHandler",
    "MessageWriteDecision",
    "PluginApi",
    "PluginCommand",
    "PluginLogger",
    "PluginService",
    "ToolCallDecision",
    "list_logger",
    "make_logger",
]
