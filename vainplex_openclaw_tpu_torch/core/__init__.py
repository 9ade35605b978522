"""The plugin API types the port hands to a gateway."""

from .api import PluginCommand, PluginService, make_logger

__all__ = ["PluginCommand", "PluginService", "make_logger"]
