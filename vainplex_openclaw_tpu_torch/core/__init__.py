"""The plugin API types the port hands to a gateway."""

from .api import PluginCommand, PluginService

__all__ = ["PluginCommand", "PluginService"]
