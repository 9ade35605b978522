"""The port's ``GovernancePlugin`` with ``twoFa`` and ``erc8004`` on,
against the JAX package's, through each package's own ``Gateway`` on the
real clock, against one loopback homeserver and one loopback chain
(``chip_smoke.LoopbackHomeserver`` and ``LoopbackChain``, on 127.0.0.1).

One JAX config with every governance section on
(``chip_smoke.install_governance_config``: stage 3 local, a ``2fa``
effect on ``exec``, 2FA through the Matrix room, ERC-8004 for three
agents) drives external sends serially and from threads, two approval
rounds in which threads of one agent block until the poller reads an
approver's TOTP code from the room, a round whose only code comes from an
unauthorised sender (it stays blocked, a wrong code from an approver
counts an attempt, then the batch times out), and ``before_agent_start``
for every agent twice. JAX's stage 3 runs its own local encoder, the
port's its encoder on the CPU. The decisions, the approval prompts (less
their order of commands), the refused round, the ``onchain=`` contexts
and the audit verdicts are equal, and no poller or timer thread outlives
``stop()``. Then the degraded configs (no ``totpSecret``, an unreadable
Matrix credentials file, a chain that refuses connections) log and serve
as JAX's do, and each section, enabled, registers what JAX's registers.
"""

from __future__ import annotations

import json
import threading

import pytest

from helpers import FakeClock
from test_torch_chip_smoke_bounds import one_torch_thread  # noqa: F401

import chip_smoke  # noqa: E402
from vainplex_openclaw_tpu import core as jax_core
from vainplex_openclaw_tpu.core import api as jax_api
from vainplex_openclaw_tpu.governance import GovernancePlugin as JaxPlugin
from vainplex_openclaw_tpu.governance.approval import Totp as JaxTotp
from vainplex_openclaw_tpu.models import serve as jax_serve
from vainplex_openclaw_tpu.storage import journal as jax_journal
from vainplex_openclaw_tpu_torch import core as port_core
from vainplex_openclaw_tpu_torch.core import api as port_api
from vainplex_openclaw_tpu_torch.governance import GovernancePlugin
from vainplex_openclaw_tpu_torch.governance.approval import Totp
from vainplex_openclaw_tpu_torch.models import serve
from vainplex_openclaw_tpu_torch.storage import journal as port_journal

PACKAGES = {"jax": (jax_core, jax_api, lambda: JaxPlugin(), JaxTotp),
            "port": (port_core, port_api,
                     lambda: GovernancePlugin(device="cpu"), Totp)}
AGENTS = list(chip_smoke.INSTALL_AGENTS) + ["ops0", "ops1"]


@pytest.fixture
def loopback():
    hs, chain = chip_smoke.LoopbackHomeserver(), chip_smoke.LoopbackChain()
    yield hs, chain
    hs.close()
    chain.close()
    assert not hs.thread.is_alive() and not chain.thread.is_alive()


def creds(tmp_path, hs, name="creds.json") -> str:
    path = tmp_path / name
    path.write_text(json.dumps({"homeserver": hs.url,
                                "accessToken": "syt_loopback",
                                "roomId": chip_smoke.INSTALL_ROOM}))
    return str(path)


def load(name, ws, config, agents=AGENTS):
    core, api, make, _ = PACKAGES[name]
    logger = api.list_logger()
    gw = core.Gateway(config={"workspace": str(ws),
                              "agents": [{"id": a} for a in agents]},
                      logger=logger)
    plugin = make()
    gw.load(plugin, plugin_config=config, logger=logger)
    gw.start()
    return gw, plugin, logger


def drive(name, tmp_path, hs, chain) -> dict:
    ws = tmp_path / name
    ws.mkdir()
    before = {t.ident for t in threading.enumerate()}
    config = chip_smoke.install_governance_config(
        creds(tmp_path, hs, f"{name}-creds.json"), chain.url,
        chip_smoke.install_secret())
    gw, plugin, logger = load(name, ws, config)
    try:
        texts = chip_smoke.gateway_texts(32, seed=chip_smoke.INSTALL_SEED)
        decide = chip_smoke.gateway_call(gw)
        got, _, _, errors = chip_smoke.serve_round(decide, texts[:16], 1)
        got_t, _, _, errors_t = chip_smoke.serve_round(decide, texts[16:], 4)
        assert not errors and not errors_t
        totp = PACKAGES[name][3](chip_smoke.install_secret())
        rounds = [chip_smoke.install_2fa_round(gw, hs, totp, f"ops{r}", 3,
                                               30.0 * r) for r in range(2)]
        refused = chip_smoke.install_refused_round(gw, hs, plugin, totp,
                                                   "ops-x")
        contexts = [[a, k, [r["prepend_context"] for r in
                            gw.before_agent_start(chip_smoke.install_ctx(a))
                            if r]] for k in range(2) for a in AGENTS]
        warnings = [m for lv, m in logger.records
                    if lv in ("warn", "error") and "[2fa]" in m]
    finally:
        gw.stop()
        serve.close_batchers()
        jax_serve.close_batchers()
        jax_journal.reset_journals()
        port_journal.reset_journals()
    left = chip_smoke.install_threads_left(before)
    return {"decisions": got + got_t,
            "rounds": [[r["decisions"], r["prompt"], r["auth"]]
                       for r in rounds],
            "refused": refused, "contexts": contexts,
            "unauthorised": [m for m in warnings if "Unauthorized" in m],
            "audit": chip_smoke.install_audit(str(ws)), "left": left}


def test_two_fa_and_erc8004_gateways_match_jax(tmp_path, openclaw_home,
                                               loopback, one_torch_thread):
    hs, chain = loopback
    want = drive("jax", tmp_path, hs, chain)
    rpc_jax = chain.calls
    got = drive("port", tmp_path, hs, chain)
    assert got == want
    assert chain.calls == 2 * rpc_jax == 4 * len(chip_smoke.INSTALL_TOKENS)
    assert want["left"] == []
    blocked = [d[0] for d in want["decisions"]]
    assert any(blocked) and not all(blocked)
    assert any("local triage encoder" in str(d[2]) for d in want["decisions"])
    for decisions, prompt, auth in want["rounds"]:
        assert all(not d[0] for row in decisions for d in row)
        assert prompt.startswith("🔒 APPROVAL REQUIRED (3 commands)")
        assert auth == "Bearer syt_loopback"
    assert want["refused"]["decision"] == [True, "2FA approval timed out"]
    assert want["unauthorised"] == [
        "[2fa] Unauthorized approval attempt by "
        + chip_smoke.INSTALL_INTRUDER]
    onchain = [c for _, _, cs in want["contexts"] for c in cs
               if "onchain=" in c]
    assert len(onchain) == 2 * len(chip_smoke.INSTALL_TOKENS)
    assert "onchain=85 (excellent, 12 reviews)" in onchain[0]
    assert len(hs.sent) == 2 * 3  # two rounds and the refused one, twice


def degraded_run(name, tmp_path, case, hs):
    ws = tmp_path / f"{name}-{case}"
    ws.mkdir()
    two_fa = {"enabled": True, "approvers": ["@a:x"],
              "matrixPollIntervalSeconds": 0.05}
    erc = {"enabled": True, "agentTokens": {"main": 8004}}
    if case == "no_secret":
        pass
    elif case == "bad_creds":
        bad = tmp_path / f"{name}-bad.json"
        bad.write_text('{"homeserver": "http://127.0.0.1:1"}')
        two_fa.update(totpSecret=chip_smoke.install_secret(),
                      matrixCredsPath=str(bad))
    else:
        two_fa.update(totpSecret=chip_smoke.install_secret(),
                      matrixCredsPath=creds(tmp_path, hs, f"{name}.json"))
        erc["rpcUrl"] = "http://127.0.0.1:1"
    core, api, _, _ = PACKAGES[name]
    logger = api.list_logger()
    gw = core.Gateway(config={"workspace": str(ws),
                              "agents": [{"id": "main"}]},
                      logger=logger, clock=FakeClock())
    plugin = (JaxPlugin if name == "jax" else GovernancePlugin)(
        workspace=str(ws), clock=gw.clock)
    gw.load(plugin, plugin_config={
        "builtinPolicies": {}, "twoFa": two_fa, "erc8004": erc,
        "policies": [{"id": "g", "rules": [{
            "conditions": [{"type": "tool", "name": "exec"}],
            "effect": {"action": "2fa", "reason": "exec"}}]}]},
        logger=logger)
    gw.start()
    try:
        if case == "no_secret":
            d = gw.before_tool_call("exec", {"command": "ls"},
                                    {"agent_id": "main"})
            outcome = [d.blocked, d.block_reason]
        else:
            outcome = [plugin.approval_2fa is not None]
        ctx = gw.before_agent_start({"agent_id": "main"})
        services = [pid_s[1].id for pid_s in gw.services]
    finally:
        gw.stop()
        jax_journal.reset_journals()
        port_journal.reset_journals()
    log = [[lv, m.replace(str(tmp_path), "<tmp>").replace(f"{name}-", "")]
           for lv, m in logger.records
           if "2FA" in m or "[2fa]" in m or "erc8004" in m]
    return {"outcome": outcome, "context": ctx, "services": services,
            "log": log}


@pytest.mark.parametrize("case", ["no_secret", "bad_creds", "chain_down"])
def test_degraded_sections_log_and_serve_as_in_jax(tmp_path, openclaw_home,
                                                   loopback, case):
    hs, _ = loopback
    want = degraded_run("jax", tmp_path, case, hs)
    got = degraded_run("port", tmp_path, case, hs)
    assert got == want
    if case == "no_secret":
        assert ["error", "2FA disabled: 2FA requires totpSecret"] in got["log"]
        assert got["outcome"][0] and "no approver configured" in \
            got["outcome"][1]
    if case == "bad_creds":
        assert "matrix-2fa-poller" not in got["services"]
    if case == "chain_down":
        assert "matrix-2fa-poller" in got["services"]
        assert any(lv == "warn" and m.startswith("[erc8004] eth_call failed")
                   for lv, m in got["log"])
        assert "onchain=" not in got["context"][0]["prepend_context"]
