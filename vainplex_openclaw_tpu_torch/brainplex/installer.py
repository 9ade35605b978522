"""Install execution (reference: brainplex/src/installer.ts:22-45,96-210 —
openclaw-CLI detection, per-plugin install with a 2-minute timeout, temp-dir
install + copy into ``<workspace>/extensions/<id>``, version extraction,
exit-code-2 when every install fails).

Python-native translation of the same contract:

- Bundled-first: every suite plugin ships inside ``vainplex_openclaw_tpu_torch``,
  so an importable module counts as installed (version = the framework's) —
  init works end-to-end on a zero-egress box.
- Otherwise, prefer ``openclaw plugins install <dist>`` when the openclaw
  CLI is on PATH; else ``pip install --target <tmpdir> <dist>`` and copy the
  package into ``<workspace>/extensions/<id>`` (the npm-temp-dir dance in
  the reference exists for the same reason: never dirty the caller's cwd).
- Every subprocess goes through a DI'd ``run_cmd`` so tests exercise the
  full execution path without network or a real CLI.

A copy of ``vainplex_openclaw_tpu/brainplex/installer.py``, kept here so
the port imports nothing of the JAX package. ``PLUGIN_SPECS`` names the
port's plugin packages (so "bundled" finds them offline) beside JAX's pip
distribution names.
"""

from __future__ import annotations

import importlib.util
import shutil
import subprocess
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Optional

INSTALL_TIMEOUT_S = 120  # reference: 2-minute timeout per plugin

# plugin id → (bundled module, pip distribution)
PLUGIN_SPECS: dict[str, tuple[str, str]] = {
    "governance": ("vainplex_openclaw_tpu_torch.governance", "vainplex-openclaw-governance"),
    "cortex": ("vainplex_openclaw_tpu_torch.cortex", "vainplex-openclaw-cortex"),
    "eventstore": ("vainplex_openclaw_tpu_torch.events", "vainplex-openclaw-eventstore"),
    "sitrep": ("vainplex_openclaw_tpu_torch.sitrep", "vainplex-openclaw-sitrep"),
    "knowledge-engine": ("vainplex_openclaw_tpu_torch.knowledge",
                         "vainplex-openclaw-knowledge-engine"),
}


@dataclass
class InstallEntry:
    plugin_id: str
    success: bool
    version: Optional[str] = None
    source: str = "bundled"  # bundled | openclaw-cli | pip
    error: Optional[str] = None


@dataclass
class InstallResult:
    installed: list[InstallEntry] = field(default_factory=list)
    failed: list[InstallEntry] = field(default_factory=list)

    @property
    def all_failed(self) -> bool:
        return bool(self.failed) and not self.installed


def has_openclaw_cli(which: Callable[[str], Optional[str]] = shutil.which) -> bool:
    return which("openclaw") is not None


def _default_run_cmd(cmd: list[str], cwd: Optional[str] = None) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True,
                          timeout=INSTALL_TIMEOUT_S, cwd=cwd).stdout


def _framework_version() -> str:
    try:
        from importlib.metadata import version

        return version("vainplex-openclaw-tpu")
    except Exception:  # noqa: BLE001 — editable/source checkout
        return "bundled"


def extract_version(output: str) -> Optional[str]:
    """Pip prints e.g. 'Successfully installed vainplex-openclaw-governance-0.8.6'."""
    import re

    m = re.search(r"[\w.-]+-(\d+\.\d+\.\d+(?:[.\w]*)?)\s*$", output.strip(),
                  re.MULTILINE)
    return m.group(1) if m else None


def install_plugins(plugin_ids: list[str], *, workspace: Path,
                    dry_run: bool = False,
                    run_cmd: Callable = _default_run_cmd,
                    which: Callable[[str], Optional[str]] = shutil.which,
                    find_module: Callable = importlib.util.find_spec,
                    tmp_root: Optional[Path] = None) -> InstallResult:
    """Execute the install half of the plan (config writing stays in cli)."""
    result = InstallResult()
    if dry_run or not plugin_ids:
        return result
    use_cli = has_openclaw_cli(which)
    for pid in plugin_ids:
        result_entry = _install_one(pid, workspace, use_cli, run_cmd,
                                    find_module, tmp_root)
        (result.installed if result_entry.success else result.failed).append(
            result_entry)
    return result


def _install_one(pid: str, workspace: Path, use_cli: bool, run_cmd: Callable,
                 find_module: Callable, tmp_root: Optional[Path]) -> InstallEntry:
    module, dist = PLUGIN_SPECS.get(pid, (None, None))
    if module is None:
        return InstallEntry(pid, False, error=f"unknown plugin id: {pid}")
    try:
        if find_module(module) is not None:
            return InstallEntry(pid, True, version=_framework_version(),
                                source="bundled")
    except (ImportError, ModuleNotFoundError):
        pass

    try:
        if use_cli:
            out = run_cmd(["openclaw", "plugins", "install", dist])
            return InstallEntry(pid, True, version=extract_version(out or ""),
                                source="openclaw-cli")
        import tempfile

        with tempfile.TemporaryDirectory(
                dir=str(tmp_root) if tmp_root else None,
                prefix="brainplex-install-") as tmp:
            # sys.executable -m pip: bare "pip" from PATH can belong to a
            # different interpreter than the one running brainplex.
            out = run_cmd([sys.executable, "-m", "pip", "install",
                           "--no-deps", "--target", tmp, dist])
            pkg_dir = next((p for p in Path(tmp).iterdir()
                            if p.is_dir() and not p.name.endswith(".dist-info")
                            and p.name != "__pycache__"), None)
            if pkg_dir is None:
                return InstallEntry(pid, False, source="pip",
                                    error="pip produced no package directory")
            ext_dir = workspace / "extensions" / pid
            if not ext_dir.exists():
                ext_dir.parent.mkdir(parents=True, exist_ok=True)
                shutil.copytree(pkg_dir, ext_dir)
        return InstallEntry(pid, True, version=extract_version(out or ""),
                            source="pip")
    except Exception as exc:  # noqa: BLE001 — one failed plugin must not stop the rest
        return InstallEntry(pid, False, source="openclaw-cli" if use_cli else "pip",
                            error=str(exc)[:200])
