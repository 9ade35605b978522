"""Pre-compaction pipeline — the marquee checkpoint/resume feature
(reference: cortex/src/pre-compaction.ts).

Before the gateway compacts conversation memory: flush trackers → write
hot-snapshot.md (last ≤N messages, 200-char truncation) → narrative →
boot context. Every step individually try/caught; a failed step becomes a
warning, never an abort (the compaction must proceed regardless).

The port's copy of ``vainplex_openclaw_tpu/cortex/pre_compaction.py``, with
one deviation: each of ``PreCompaction.run``'s four catches (tracker flush,
hot snapshot, narrative, boot context) re-raises an error of the device
(``device.is_device_error``) instead of turning it into a warning; every
other error becomes the JAX package's warning.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Optional

from ..device import is_device_error
from .boot_context import BootContextGenerator
from .narrative import NarrativeGenerator
from .storage import ensure_reboot_dir, iso_now, reboot_dir, save_text


def build_hot_snapshot(messages: list[dict], max_messages: int,
                       clock: Callable[[], float] = time.time) -> str:
    parts = [f"# Hot Snapshot — {iso_now(clock)}",
             "## Last conversation before compaction", ""]
    recent = messages[-max_messages:] if messages else []
    if recent:
        parts.append("**Recent messages:**")
        for msg in recent:
            content = (msg.get("content") or "").strip()
            short = content[:200] + "..." if len(content) > 200 else content
            parts.append(f"- [{msg.get('role', '?')}] {short}")
    else:
        parts.append("(No recent messages captured)")
    parts.append("")
    return "\n".join(parts)


@dataclass
class PreCompactionResult:
    messages_snapshotted: int = 0
    warnings: list[str] = field(default_factory=list)


class PreCompaction:
    def __init__(self, workspace: str | Path, config: dict, logger, thread_tracker,
                 decision_tracker=None, commitment_tracker=None,
                 clock: Callable[[], float] = time.time):
        self.workspace = Path(workspace)
        self.config = config
        self.logger = logger
        self.thread_tracker = thread_tracker
        self.decision_tracker = decision_tracker
        self.commitment_tracker = commitment_tracker
        self.clock = clock

    def run(self, compacting_messages: Optional[list[dict]] = None) -> PreCompactionResult:
        result = PreCompactionResult()
        ensure_reboot_dir(self.workspace, self.logger)

        for name, tracker in (("thread", self.thread_tracker),
                              ("decision", self.decision_tracker),
                              ("commitment", self.commitment_tracker)):
            if tracker is None:
                continue
            try:
                tracker.flush()
            except Exception as exc:  # noqa: BLE001
                if is_device_error(exc):
                    raise
                result.warnings.append(f"{name} flush failed: {exc}")
                self.logger.warn(f"Pre-compaction: {name} flush failed: {exc}")

        try:
            messages = compacting_messages or []
            max_msgs = self.config.get("preCompaction", {}).get("maxSnapshotMessages", 15)
            result.messages_snapshotted = min(len(messages), max_msgs)
            snapshot = build_hot_snapshot(messages, max_msgs, self.clock)
            if not save_text(reboot_dir(self.workspace) / "hot-snapshot.md",
                             snapshot, self.logger):
                result.warnings.append("Hot snapshot write failed")
        except Exception as exc:  # noqa: BLE001
            if is_device_error(exc):
                raise
            result.warnings.append(f"Hot snapshot failed: {exc}")
            self.logger.warn(f"Pre-compaction: hot snapshot failed: {exc}")

        try:
            if self.config.get("narrative", {}).get("enabled", True):
                NarrativeGenerator(self.workspace, self.logger, self.clock).write()
        except Exception as exc:  # noqa: BLE001
            if is_device_error(exc):
                raise
            result.warnings.append(f"Narrative generation failed: {exc}")

        try:
            if self.config.get("bootContext", {}).get("enabled", True):
                BootContextGenerator(self.workspace, self.config.get("bootContext", {}),
                                     self.logger, self.clock).write()
        except Exception as exc:  # noqa: BLE001
            if is_device_error(exc):
                raise
            result.warnings.append(f"Boot context failed: {exc}")

        return result
