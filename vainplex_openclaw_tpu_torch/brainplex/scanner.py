"""Environment scanner (reference: brainplex/src/scanner.ts:15-95).

Runtime version check, walk-up discovery of ``openclaw.json`` (including
``.openclaw/`` nesting and the home fallback), JSON5-tolerant parsing
(comments + trailing commas), and agent extraction across the four config
shapes seen in the wild.

A copy of ``vainplex_openclaw_tpu/brainplex/scanner.py``, kept here so the
port imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import re
import sys
from pathlib import Path
from typing import Optional

MIN_PYTHON = (3, 10)


def check_runtime() -> tuple[bool, str]:
    version = sys.version_info[:2]
    ok = version >= MIN_PYTHON
    return ok, f"Python {version[0]}.{version[1]}"


def parse_config(content: str) -> dict:
    """Strict JSON first; fall back to stripping comments/trailing commas."""
    try:
        return json.loads(content)
    except json.JSONDecodeError:
        cleaned = re.sub(r"//[^\n]*", "", content)
        cleaned = re.sub(r"/\*[\s\S]*?\*/", "", cleaned)
        cleaned = re.sub(r",\s*([}\]])", r"\1", cleaned)
        return json.loads(cleaned)


def find_config(start_dir: str | Path, home: Optional[Path] = None) -> Optional[Path]:
    directory = Path(start_dir).resolve()
    home = home or Path.home()
    while True:
        direct = directory / "openclaw.json"
        if direct.exists():
            return direct
        nested = directory / ".openclaw" / "openclaw.json"
        if nested.exists():
            return nested
        if directory.parent == directory:
            break
        directory = directory.parent
    fallback = home / ".openclaw" / "openclaw.json"
    return fallback if fallback.exists() else None


def _agent_names(entries: list) -> list[str]:
    out = []
    for entry in entries:
        if isinstance(entry, str):
            out.append(entry)
        elif isinstance(entry, dict):
            name = entry.get("id") or entry.get("name")
            if isinstance(name, str):
                out.append(name)
    return out


def extract_agents(config: dict) -> list[str]:
    agents = config.get("agents")
    if not agents:
        return []
    if isinstance(agents, list):                       # 1: flat array
        return _agent_names(agents)
    if isinstance(agents, dict):
        if isinstance(agents.get("list"), list):       # 2: agents.list
            return _agent_names(agents["list"])
        if isinstance(agents.get("definitions"), list):  # 3: agents.definitions
            return _agent_names(agents["definitions"])
        meta = {"definitions", "defaults", "list"}     # 4: named keys
        return [k for k in agents if k not in meta]
    return []


def scan(start_dir: str | Path, home: Optional[Path] = None,
         config_path: Optional[str | Path] = None) -> dict:
    """Scan the environment. An explicit ``config_path`` skips discovery and
    is read directly (missing/unparseable file surfaces as ``parse_error``)."""
    runtime_ok, runtime = check_runtime()
    if config_path is not None:
        config_path = Path(config_path)
        if not config_path.exists():
            return {
                "runtime": runtime, "runtime_ok": runtime_ok,
                "config_path": str(config_path), "config": {},
                "parse_error": "file not found", "agents": [],
                "existing_plugins": [],
            }
    else:
        config_path = find_config(start_dir, home)
    config: dict = {}
    parse_error = None
    if config_path is not None:
        try:
            config = parse_config(config_path.read_text(encoding="utf-8"))
            if not isinstance(config, dict):
                config, parse_error = {}, "top-level JSON value is not an object"
        except (OSError, json.JSONDecodeError) as exc:
            parse_error = str(exc)
    return {
        "runtime": runtime,
        "runtime_ok": runtime_ok,
        "config_path": str(config_path) if config_path else None,
        "config": config,
        "parse_error": parse_error,
        "agents": extract_agents(config),
        "existing_plugins": sorted((config.get("plugins") or {}).keys()),
    }
