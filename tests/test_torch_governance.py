"""The port's ``governance/`` against the JAX package's, through each
package's own ``Gateway``.

One seeded mix of tool calls (with results, errors and ``sessions_spawn``
links), outbound messages on internal and external channels, session
events and context injection runs against a ``GovernancePlugin`` in each
package on one virtual clock that crosses night hours: the builtin
policies with ``nightMode`` and a tight rate limiter, a seeded matrix of
user policies from the JAX package's own plan-equivalence test (every
condition type, prefilter banks, unsafe patterns that the loader rejects),
``bench.py``'s ten regex-gated audit policies, and audit redaction. The
engines' microsecond clock (``engine.now_us``) reads 0 on both sides, so
``evaluationUs`` is 0 in every verdict and audit record. The verdicts must
be equal, ``governance.status`` and the gateway status equal after every
step leaving out the stage timings (``stageMs``, ``stageQuantiles``), and
after ``stop()`` the trust file and the audit day files and journal
byte-equal, with the audit ids drawn from one seed on both sides. The
compiled planner is the default on both sides; the interpreter oracle
(``compiledPlans: false``) is run on the port as well.
"""

from __future__ import annotations

import dataclasses
import json
import random
from pathlib import Path

import pytest

import bench
from helpers import FakeClock
from test_governance_plan_equiv import TIME_WINDOWS, rand_policy
from vainplex_openclaw_tpu import core as jax_core
from vainplex_openclaw_tpu.core import api as jax_api
from vainplex_openclaw_tpu.governance import GovernancePlugin as JaxPlugin
from vainplex_openclaw_tpu.governance import engine as jax_engine
from vainplex_openclaw_tpu.utils import ids as jax_ids
from vainplex_openclaw_tpu_torch import core as port_core
from vainplex_openclaw_tpu_torch.core import api as port_api
from vainplex_openclaw_tpu_torch.governance import GovernancePlugin
from vainplex_openclaw_tpu_torch.governance import engine as port_engine
from vainplex_openclaw_tpu_torch.storage import journal as port_journal
from vainplex_openclaw_tpu_torch.utils import ids as port_ids

AGENTS = ("main", "forge", "scout", "ops")
TOOLS = ("exec", "read", "write", "gateway", "deploy_tool", "sessions_spawn")
COMMANDS = ("ls -la /tmp", "cat secrets.env", "git push origin main",
            "docker push registry/app", "kubectl get pods", "rm -rf build",
            "pattern-3-abc", "scp key.pem host:", "export TOKEN=tok123")
TEXTS = ("deploy is done", "the api is down", "urgent: push to prod now",
         "secret 123 leaked", "all good here", "nginx is running")
TIMING_KEYS = ("stageMs", "stageQuantiles")
START = 1_700_000_000.0 - 2.25 * 3600  # 2023-11-14 19:58 UTC


def plugin_config(seed: int, compiled: bool = True) -> dict:
    rng = random.Random(seed)
    return {
        "failMode": "closed" if seed % 2 else "open",
        "timezone": "UTC",
        "builtinPolicies": {"nightMode": True, "credentialGuard": True,
                            "productionSafeguard": True,
                            "rateLimiter": {"maxPerMinute": 6}},
        "policies": [rand_policy(rng, i) for i in range(14)]
        + bench._bench_user_policies(),
        "timeWindows": TIME_WINDOWS,
        "toolRiskOverrides": {"deploy_tool": 85},
        "audit": {"redactPatterns": [r"tok\d+"]},
        "internalChannels": ["dev"],
        "compiledPlans": compiled,
    }


def script(seed: int, n: int = 220) -> list:
    rng = random.Random(1000 + seed)
    ops = []
    children = 0
    for i in range(n):
        agent = rng.choice(AGENTS)
        sess = f"agent:{agent}:s{rng.randrange(2)}"
        if rng.random() < 0.15:
            sess += f":subagent:{rng.choice(AGENTS)}:c{rng.randrange(3)}"
        ctx = {"agent_id": agent, "session_key": sess,
               "channel_id": rng.choice([None, "dev", "prod", "general"])}
        if rng.random() < 0.2:
            ctx["metadata"] = {"priority": "high"}
        r = rng.random()
        if r < 0.42:
            tool = rng.choice(TOOLS)
            params = rng.choice([{}, {"command": rng.choice(COMMANDS)},
                                 {"command": rng.choice(COMMANDS),
                                  "host": rng.choice(["sandbox", "prod-1"])},
                                 {"path": "secrets/creds.env"}])
            ops.append(("tool", tool, params, ctx))
        elif r < 0.55:
            tool = rng.choice(TOOLS)
            result = None
            if tool == "sessions_spawn":
                children += 1
                result = {"session_key": f"{sess}:subagent:forge:k{children}"}
            ops.append(("after", tool, {}, result,
                        rng.choice([None, None, "exit 1"]), ctx))
        elif r < 0.72:
            msg_ctx = dict(ctx)
            ops.append(("send", rng.choice(TEXTS),
                        rng.choice([None, None, "ceo@example.com"]), msg_ctx))
        elif r < 0.78:
            ops.append(("session_start", ctx))
        elif r < 0.82:
            ops.append(("session_end", ctx))
        elif r < 0.86:
            ops.append(("agent_start", ctx))
        elif r < 0.94:
            ops.append(("advance", rng.choice([7.0, 30.0, 90.0, 1800.0,
                                              3600.0])))
        elif r < 0.97:
            ops.append(("trust", rng.choice(AGENTS), sess))
        else:
            ops.append(("status",))
    return ops


def untimed(status: dict) -> dict:
    return {k: v for k, v in status.items() if k not in TIMING_KEYS}


@pytest.fixture
def frozen_us(monkeypatch):
    for mod in (jax_engine, port_engine):
        monkeypatch.setattr(mod, "now_us", lambda: 0)


def drive(core_mod, api_mod, plugin_cls, ids_mod, ws: Path, seed: int,
          ops, compiled: bool = True):
    ids_mod._ID_RNG.seed(seed)
    clock = FakeClock(START)
    logger = api_mod.list_logger()
    gw = core_mod.Gateway(config={"workspace": str(ws),
                                  "agents": [{"id": a} for a in AGENTS]},
                          logger=logger, clock=clock)
    plugin = plugin_cls(workspace=str(ws), clock=clock)
    gw.load(plugin, plugin_config=plugin_config(seed, compiled))
    gw.start()
    out = []
    for op in ops:
        kind = op[0]
        if kind == "tool":
            res = dataclasses.asdict(gw.before_tool_call(op[1], op[2],
                                                         dict(op[3])))
        elif kind == "after":
            res = gw.after_tool_call(op[1], op[2], op[3], op[4], dict(op[5]))
        elif kind == "send":
            event_ctx = dict(op[3])
            res = dataclasses.asdict(gw.message_sending(op[1], event_ctx)) \
                if op[2] is None else gw.fire_results(
                    "message_sending", {"content": op[1], "to": op[2]},
                    event_ctx)
        elif kind == "session_start":
            res = gw.session_start(dict(op[1]))
        elif kind == "session_end":
            res = gw.session_end(dict(op[1]))
        elif kind == "agent_start":
            res = gw.before_agent_start(dict(op[1]))
        elif kind == "advance":
            res = clock.advance(op[1])
        elif kind == "trust":
            res = (gw.call_method("governance.trust", op[1], op[2]),
                   gw.command("/trust", args=op[1]))
        else:
            res = json.loads(json.dumps(
                (untimed(gw.call_method("governance.status")),
                 gw.get_status())).replace(str(ws), "<ws>"))
        out.append((op, res))
    status = untimed(gw.call_method("governance.status"))
    gw.stop()
    port_journal.reset_journals()
    return out, status, [m for _, m in logger.records]


def files(ws: Path) -> dict:
    return {str(path.relative_to(ws)): path.read_bytes()
            for path in sorted(ws.rglob("*")) if path.is_file()}


@pytest.mark.parametrize("seed", [4, 5, 7])
def test_governance_mix_matches_jax(tmp_path, openclaw_home, frozen_us,
                                    seed):
    from vainplex_openclaw_tpu.storage import journal as jax_journal

    ops = script(seed)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    try:
        want, want_status, want_log = drive(jax_core, jax_api, JaxPlugin,
                                            jax_ids, tmp_path / "jax", seed,
                                            ops)
    finally:
        jax_journal.reset_journals()
    got, got_status, got_log = drive(port_core, port_api, GovernancePlugin,
                                     port_ids, tmp_path / "port", seed, ops)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w
    assert got_status == want_status
    assert got_log == want_log
    got_files, want_files = files(tmp_path / "port"), files(tmp_path / "jax")
    assert sorted(got_files) == sorted(want_files)
    for name in want_files:
        assert got_files[name] == want_files[name], name
    # the mix reached what it is meant to reach
    assert "governance/trust.json" in want_files
    assert any(n.startswith("governance/audit/") for n in want_files)
    reasons = " ".join(str(res) for _, res in want)
    for path in ("Night mode", "Rate limit", "Credential Guard",
                 "2FA required but no approver"):
        assert path in reasons, path
    assert want_status["stats"]["denyCount"] > 0
    assert want_status["stats"]["allowCount"] > 0
    assert want_status["patternSafety"]["checked"]


def test_interpreter_oracle_agrees_on_the_port(tmp_path, openclaw_home,
                                               frozen_us):
    """``compiledPlans: false`` pins the port's engine to its evaluator,
    the planner's oracle; both give the same verdicts and files."""
    ops = script(4, n=160)
    runs = {}
    for compiled in (True, False):
        ws = tmp_path / f"c{int(compiled)}"
        ws.mkdir()
        runs[compiled] = drive(port_core, port_api, GovernancePlugin,
                               port_ids, ws, 4, ops, compiled=compiled)
    (plan_ops, plan_status, _), (interp_ops, interp_status, _) = \
        runs[True], runs[False]
    for g, w in zip(plan_ops, interp_ops):
        if g[0][0] != "status":  # patternSafety differs by design
            assert g == w
    assert files(tmp_path / "c1") == files(tmp_path / "c0")
    assert plan_status["stats"] == interp_status["stats"]


def test_manifest_and_defaults_are_jax_s():
    from vainplex_openclaw_tpu.governance import plugin as jax_plugin
    from vainplex_openclaw_tpu_torch.governance import plugin as port_plugin

    assert port_plugin.DEFAULTS == jax_plugin.DEFAULTS
    assert dataclasses.asdict(port_plugin.MANIFEST) == \
        dataclasses.asdict(jax_plugin.MANIFEST)
    assert port_plugin.TOOL_LOG_MAX == jax_plugin.TOOL_LOG_MAX


def test_hooks_and_priorities_are_jax_s(tmp_path, openclaw_home):
    seen = {}
    for name, core_mod, api_mod, plugin_cls in (
            ("jax", jax_core, jax_api, JaxPlugin),
            ("port", port_core, port_api, GovernancePlugin)):
        ws = tmp_path / name
        ws.mkdir()
        gw = core_mod.Gateway(config={"workspace": str(ws)},
                              logger=api_mod.list_logger(), clock=FakeClock())
        gw.load(plugin_cls(workspace=str(ws)),
                plugin_config={"validation": {"enabled": True}})
        seen[name] = ({hook: [(r.priority, r.never_shed)
                              for r in gw.bus.handlers_for(hook)]
                       for hook in api_mod.KNOWN_HOOKS},
                      sorted(gw.commands), sorted(gw.methods),
                      sorted(gw.stage_timers), sorted(gw.journals))
        gw.stop()
    port_journal.reset_journals()
    assert seen["port"][0] == seen["jax"][0]
    assert seen["port"][1:3] == seen["jax"][1:3]
    assert seen["port"][3] == seen["jax"][3]
    assert len(seen["port"][4]) == len(seen["jax"][4]) == 1


@pytest.mark.parametrize("pattern", [
    r"(a+)+", r"(?:a*)*", r"(a|aa)+", r"(?:ab|a.)+", r"(?:\s*x?)+",
    r"pattern-\d-[a-z]+", r"\d{3,40}", r"^ls", r"(?>a+)+", r"a*+b",
    r"(?=(a+)+)x", "(unclosed", r"(x|y|xz)*end"])
def test_redos_screen_matches_jax(pattern):
    from vainplex_openclaw_tpu.analysis import redos as jax_redos
    from vainplex_openclaw_tpu_torch.analysis import redos as port_redos

    assert port_redos.pattern_safe(pattern) == jax_redos.pattern_safe(pattern)
    assert port_redos.unsafe_report(pattern) == \
        jax_redos.unsafe_report(pattern)
