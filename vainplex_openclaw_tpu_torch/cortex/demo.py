"""Interactive demo — the suite's runnable end-to-end artifact
(reference: cortex/demo/demo.ts (347): a scripted bilingual conversation
through real trackers in a temp workspace, then a sandbox mode).

The port's copy of ``vainplex_openclaw_tpu/cortex/demo.py``: the same
script through the port's ``Gateway`` and ``CortexPlugin`` (no trace
analyzer, so no device is needed).

Run: ``python -m vainplex_openclaw_tpu_torch.cortex.demo [--sandbox]``
"""

from __future__ import annotations

import sys
import tempfile

SCRIPT = [
    ("user", "let's talk about the quarterly infrastructure review"),
    ("user", "we decided to migrate the database to pgvector because embeddings need it"),
    ("agent", "I'll draft the migration plan tonight"),
    ("user", "wir haben beschlossen, das Deployment zu automatisieren"),
    ("user", "the quarterly infrastructure review is waiting for budget approval"),
    ("user", "das Deployment ist erledigt ✅"),
    ("user", "careful, the migration is risky and urgent"),
]


def run_scripted(workspace: str) -> None:
    from ..core import Gateway
    from . import CortexPlugin

    gw = Gateway()
    plugin = CortexPlugin(workspace=workspace, wall_timers=False)
    gw.load(plugin, plugin_config={"enabled": True, "languages": "both"})
    gw.start()
    ctx = {"agent_id": "demo", "session_key": "agent:demo"}

    print("═══ scripted bilingual conversation ═══")
    for sender, message in SCRIPT:
        print(f"  [{sender}] {message}")
        if sender == "user":
            gw.message_received(message, ctx)
        else:
            gw.message_sent(message, ctx)

    print("\n═══ tracker state ═══")
    print(gw.command("/cortexstatus")["text"])

    print("\n═══ pre-compaction snapshot + boot context ═══")
    gw.before_compaction(ctx, messages=[
        {"role": sender, "content": text} for sender, text in SCRIPT[-3:]])
    out = gw.session_start(ctx)
    injected = next((r["prepend_context"] for r in out
                     if isinstance(r, dict) and r.get("prepend_context")), "")
    print(injected)
    gw.stop()


def run_sandbox(workspace: str) -> None:
    from ..core import Gateway
    from . import CortexPlugin

    gw = Gateway()
    plugin = CortexPlugin(workspace=workspace, wall_timers=False)
    gw.load(plugin, plugin_config={"enabled": True, "languages": "all"})
    gw.start()
    ctx = {"agent_id": "demo", "session_key": "agent:demo"}
    print("\n═══ sandbox — type messages (empty line to exit) ═══")
    while True:
        try:
            line = input("you> ").strip()
        except EOFError:
            break
        if not line:
            break
        gw.message_received(line, ctx)
        print(gw.command("/cortexstatus")["text"])
    gw.stop()


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    with tempfile.TemporaryDirectory(prefix="cortex-demo-") as workspace:
        print(f"demo workspace: {workspace}\n")
        run_scripted(workspace)
        if "--sandbox" in argv:
            run_sandbox(workspace)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
