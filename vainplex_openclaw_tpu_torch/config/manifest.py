"""Plugin manifests: the ``openclaw.plugin.json`` equivalent.

A copy of ``vainplex_openclaw_tpu/config/manifest.py``, kept here so the
port imports nothing of the JAX package.

The reference ships a JSON-schema'd manifest per plugin
(``openclaw.plugin.json``, SURVEY §5 "Config / flag system": per-plugin
manifest + external config + bootstrap-write). Here the manifest is a
first-class object each plugin exposes as ``MANIFEST``; the gateway
validates supplied plugin config against it at load time (warn-only —
config problems must never crash the gateway) and ``brainplex`` validates
the configs it generates.

The schema dialect is the small JSON-Schema subset the reference manifests
actually use: ``type`` (object/array/string/number/integer/boolean/null),
``properties``/``required``/``additionalProperties``, ``items``, ``enum``,
``minimum``/``maximum``, and union types via a list in ``type``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

_TYPE_CHECKS = {
    "object": lambda v: isinstance(v, dict),
    "array": lambda v: isinstance(v, (list, tuple)),
    "string": lambda v: isinstance(v, str),
    "number": lambda v: isinstance(v, (int, float)) and not isinstance(v, bool),
    "integer": lambda v: isinstance(v, int) and not isinstance(v, bool),
    "boolean": lambda v: isinstance(v, bool),
    "null": lambda v: v is None,
}


def _check_type(types, value) -> bool:
    if isinstance(types, str):
        types = [types]
    return any(_TYPE_CHECKS.get(t, lambda v: True)(value) for t in types)


def validate_schema(schema: dict, value: Any, path: str = "$") -> list[str]:
    """Validate ``value`` against the schema subset. Returns error strings
    (empty = valid). Unknown schema keywords are ignored, never fatal."""
    errors: list[str] = []
    types = schema.get("type")
    if types is not None and not _check_type(types, value):
        errors.append(f"{path}: expected {types}, got {type(value).__name__}")
        return errors  # type mismatch: deeper checks would be noise

    if "enum" in schema and value not in schema["enum"]:
        errors.append(f"{path}: {value!r} not in {schema['enum']}")

    if isinstance(value, (int, float)) and not isinstance(value, bool):
        if "minimum" in schema and value < schema["minimum"]:
            errors.append(f"{path}: {value} < minimum {schema['minimum']}")
        if "maximum" in schema and value > schema["maximum"]:
            errors.append(f"{path}: {value} > maximum {schema['maximum']}")

    if isinstance(value, dict):
        props = schema.get("properties", {})
        for name in schema.get("required", []):
            if name not in value:
                errors.append(f"{path}: missing required property {name!r}")
        for key, sub in value.items():
            if key in props:
                errors.extend(validate_schema(props[key], sub, f"{path}.{key}"))
            elif schema.get("additionalProperties") is False:
                errors.append(f"{path}: unknown property {key!r}")
            elif isinstance(schema.get("additionalProperties"), dict):
                errors.extend(validate_schema(schema["additionalProperties"], sub,
                                              f"{path}.{key}"))

    if isinstance(value, (list, tuple)) and isinstance(schema.get("items"), dict):
        for i, item in enumerate(value):
            errors.extend(validate_schema(schema["items"], item, f"{path}[{i}]"))

    return errors


@dataclass(frozen=True)
class PluginManifest:
    """What ``openclaw.plugin.json`` declares: identity + config schema."""

    id: str
    description: str
    version: str = "1.0.0"
    config_schema: dict = field(default_factory=dict)
    commands: tuple = ()          # chat commands the plugin registers
    gateway_methods: tuple = ()   # RPC methods the plugin registers
    hooks: tuple = ()             # hook names the plugin attaches to

    def validate_config(self, config: Optional[dict]) -> list[str]:
        if config is None or not self.config_schema:
            return []
        return validate_schema(self.config_schema, config)

    def to_dict(self) -> dict:
        return {
            "id": self.id,
            "version": self.version,
            "description": self.description,
            "configSchema": self.config_schema,
            "commands": list(self.commands),
            "gatewayMethods": list(self.gateway_methods),
            "hooks": list(self.hooks),
        }


def _bool(desc: str = "") -> dict:
    return {"type": "boolean", "description": desc} if desc else {"type": "boolean"}


def enabled_section(extra: Optional[dict] = None, **props) -> dict:
    """Common ``{enabled: bool, ...}`` sub-object schema."""
    merged = {"enabled": _bool()}
    merged.update(extra or {})
    merged.update(props)
    return {"type": "object", "properties": merged}
