"""brainplex CLI (reference: brainplex/src/cli.ts:17-120+ — hand-rolled arg
parsing, ``init`` flow: scan → plan → confirm → generate configs → write →
merge openclaw.json → summary; dry-run threads through every step).

A copy of ``vainplex_openclaw_tpu/brainplex/cli.py``, kept here so the port
imports nothing of the JAX package: ``python -m
vainplex_openclaw_tpu_torch.brainplex.cli init [--full] [--yes]
[--dry-run] [--config PATH]`` exits 0, 1 or 2 as JAX's does. The port adds
no console script; ``brainplex`` stays JAX's.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path
from typing import Optional

from .configurator import (
    CORE_PLUGINS,
    OPTIONAL_PLUGINS,
    generate_configs,
    validate_generated,
)
from .installer import _default_run_cmd, install_plugins
from .scanner import scan
from .writer import update_openclaw_config, write_config

USAGE = """brainplex — install the openclaw plugin suite

usage: brainplex init [--full] [--dry-run] [--config PATH] [--no-color]
                      [--verbose] [--yes]

  init        scan for an OpenClaw install and enable the plugin suite
  --full      include optional plugins (knowledge-engine)
  --dry-run   show the plan without writing anything
  --config    explicit path to openclaw.json
  --yes       skip the confirmation prompt
"""


class Output:
    """ANSI/TTY-aware printing (reference: brainplex/src/output.ts)."""

    def __init__(self, color: bool = True, verbose: bool = False, stream=None):
        self.stream = stream or sys.stdout
        self.color = color and getattr(self.stream, "isatty", lambda: False)()
        self.verbose = verbose

    def _c(self, code: str, text: str) -> str:
        return f"\033[{code}m{text}\033[0m" if self.color else text

    def info(self, text: str) -> None:
        print(text, file=self.stream)

    def ok(self, text: str) -> None:
        print(self._c("32", f"✓ {text}"), file=self.stream)

    def warn(self, text: str) -> None:
        print(self._c("33", f"! {text}"), file=self.stream)

    def error(self, text: str) -> None:
        print(self._c("31", f"✗ {text}"), file=self.stream)

    def debug(self, text: str) -> None:
        if self.verbose:
            print(self._c("2", f"  {text}"), file=self.stream)


def parse_args(argv: list[str]) -> dict:
    args = {"command": None, "full": False, "dry_run": False, "config": None,
            "no_color": False, "verbose": False, "yes": False}
    positional = []
    i = 0
    while i < len(argv):
        arg = argv[i]
        if arg == "--full":
            args["full"] = True
        elif arg == "--dry-run":
            args["dry_run"] = True
        elif arg == "--no-color":
            args["no_color"] = True
        elif arg == "--verbose":
            args["verbose"] = True
        elif arg in ("--yes", "-y"):
            args["yes"] = True
        elif arg == "--config":
            i += 1
            if i >= len(argv):
                raise SystemExit("--config requires a path")
            args["config"] = argv[i]
        elif arg.startswith("-"):
            raise SystemExit(f"unknown flag: {arg}\n\n{USAGE}")
        else:
            positional.append(arg)
        i += 1
    args["command"] = positional[0] if positional else None
    return args


def plan_installation(scan_result: dict, full: bool) -> dict:
    wanted = list(CORE_PLUGINS) + (list(OPTIONAL_PLUGINS) if full else [])
    existing = set(scan_result.get("existing_plugins") or [])
    return {
        "install": [p for p in wanted if p not in existing],
        "already": [p for p in wanted if p in existing],
    }


def run_init(args: dict, start_dir: Optional[str] = None,
             home: Optional[Path] = None, out: Optional[Output] = None,
             confirm=None, run_cmd=None) -> int:
    out = out or Output(color=not args["no_color"], verbose=args["verbose"])
    start_dir = start_dir or os.getcwd()

    # 1-2: scan environment (an explicit --config path is read directly,
    # never replaced by discovery)
    result = scan(start_dir, home=home, config_path=args["config"])
    out.info(f"runtime: {result['runtime']}" +
             ("" if result["runtime_ok"] else "  (unsupported!)"))
    if not result["runtime_ok"]:
        out.error("unsupported runtime version")
        return 1
    if result["config_path"] is None:
        out.error("no openclaw.json found (walked up to root and ~/.openclaw)")
        return 1
    if result["parse_error"]:
        out.error(f"openclaw.json unreadable: {result['parse_error']}")
        return 1
    out.ok(f"found config: {result['config_path']}")
    out.info(f"agents: {', '.join(result['agents']) or '(none)'}")

    # 3-4: plan
    plan = plan_installation(result, args["full"])
    if not plan["install"]:
        out.ok("all plugins already configured — nothing to do")
        return 0
    out.info(f"will enable: {', '.join(plan['install'])}")
    if plan["already"]:
        out.debug(f"already present: {', '.join(plan['already'])}")

    # 5: confirm
    if not args["dry_run"] and not args["yes"]:
        ask = confirm or (lambda prompt: input(prompt).strip().lower() in ("y", "yes"))
        if not ask("proceed? [y/N] "):
            out.warn("aborted")
            return 1

    # 6: execute installations (reference cli.ts:168-186: report each entry;
    # exit 2 when every install failed; configure only what installed)
    workspace = Path(result["config_path"]).parent
    install_result = install_plugins(
        plan["install"], workspace=workspace, dry_run=args["dry_run"],
        run_cmd=run_cmd or _default_run_cmd)
    for entry in install_result.installed:
        ver = ""
        if entry.version:
            ver = ", " + ("v" + entry.version if entry.version[:1].isdigit()
                          else entry.version)
        out.ok(f"{entry.plugin_id} installed ({entry.source}{ver})")
    for entry in install_result.failed:
        out.error(f"{entry.plugin_id} install failed: {entry.error}")
    if not args["dry_run"] and install_result.all_failed:
        out.error("All plugin installations failed.")
        return 2
    installed_ids = ([e.plugin_id for e in install_result.installed]
                     if not args["dry_run"] else list(plan["install"]))

    # 7-8: generate + write per-plugin configs
    configs = generate_configs(installed_ids, result["agents"])
    for plugin_id, errors in validate_generated(configs).items():
        for err in errors:
            out.warn(f"{plugin_id} config schema: {err}")
    config_root = Path(result["config_path"]).parent / "plugins"
    entries = {}
    for plugin_id, config in configs.items():
        path = config_root / plugin_id / "config.json"
        write_result = write_config(path, config, dry_run=args["dry_run"])
        out.debug(f"{plugin_id}: {write_result['action']} ({write_result['path']})")
        entries[plugin_id] = {"enabled": True, "configPath": str(path)}

    # 9: merge openclaw.json
    merge = update_openclaw_config(result["config_path"], entries,
                                   dry_run=args["dry_run"])
    if merge["action"] == "error":
        out.error(f"openclaw.json not updated: {merge.get('error', 'unknown error')}")
        return 1
    out.debug(f"openclaw.json: {merge['action']}")

    # 10: summary
    verb = "planned" if args["dry_run"] else "enabled"
    out.ok(f"{verb} {len(plan['install'])} plugins "
           f"({'dry run — nothing written' if args['dry_run'] else 'ready'})")
    return 0


def main(argv: Optional[list[str]] = None) -> int:
    args = parse_args(list(sys.argv[1:] if argv is None else argv))
    if args["command"] != "init":
        print(USAGE)
        return 0 if args["command"] is None else 1
    return run_init(args)


if __name__ == "__main__":
    raise SystemExit(main())
