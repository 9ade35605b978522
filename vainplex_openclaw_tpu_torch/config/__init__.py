"""Config conventions shared by every plugin: the port's own copies."""

from .loader import deep_merge, load_plugin_config, plugins_dir

__all__ = ["deep_merge", "load_plugin_config", "plugins_dir"]
