"""The port's output validation against the JAX package's, and the port's
deviations on the stage-3 path.

Parity: stage-1 claims, the stage-2 fact registry and checker (inline,
from a file and from a trace report), the response gate, the output
validator over trust scores and policies, and ``LlmValidator`` on a
scripted ``call_llm`` (fenced and bare JSON, prose around it, unparseable
output, a failing first attempt and its retry, both failModes, the
cache's 300 s TTL on a virtual clock). Then the config-only local stage 3
on the shipped checkpoint: the port's ``GovernancePlugin(device="cpu")``
and the JAX plugin with ``local: true`` give equal decisions through each
package's ``Gateway.message_sending`` on texts of every severity class and
on claims that contradict a fact.

Deviations, each beside the JAX behaviour it departs from: a device error
from ``call_llm`` propagates out of the port's ``message_sending`` under
both failModes, where JAX logs it and answers with the failMode verdict;
a plain error gives identical decisions; a missing card raises at
``Gateway.load`` where JAX logs "local stage-3 unavailable". Each of the
2FA and ERC-8004 sections, enabled, registers what JAX's registers (their
flows: ``tests/test_torch_governance_2fa.py``; redaction:
``tests/test_torch_redaction.py``).
"""

from __future__ import annotations

import dataclasses
import json

import pytest
import torch

from helpers import FakeClock
from test_torch_chip_smoke_bounds import one_torch_thread  # noqa: F401
from vainplex_openclaw_tpu import core as jax_core
from vainplex_openclaw_tpu.core import api as jax_api
from vainplex_openclaw_tpu.governance import GovernancePlugin as JaxPlugin
from vainplex_openclaw_tpu.governance import validation as jax_val
from vainplex_openclaw_tpu.governance.validation import claims as jax_claims
from vainplex_openclaw_tpu.governance.validation import facts as jax_facts
from vainplex_openclaw_tpu.governance.validation import \
    llm_validator as jax_llm
from vainplex_openclaw_tpu.models import serve as jax_serve
from vainplex_openclaw_tpu.models.data import synthetic_examples
from vainplex_openclaw_tpu.storage import journal as jax_journal
from vainplex_openclaw_tpu_torch import core as port_core
from vainplex_openclaw_tpu_torch.core import api as port_api
from vainplex_openclaw_tpu_torch.device import DeviceError
from vainplex_openclaw_tpu_torch.governance import GovernancePlugin
from vainplex_openclaw_tpu_torch.governance import validation as port_val
from vainplex_openclaw_tpu_torch.governance.validation import \
    claims as port_claims
from vainplex_openclaw_tpu_torch.governance.validation import \
    facts as port_facts
from vainplex_openclaw_tpu_torch.governance.validation import \
    llm_validator as port_llm
from vainplex_openclaw_tpu_torch.models import serve
from vainplex_openclaw_tpu_torch.storage import journal as port_journal

TEXTS = (
    "nginx is running and the api-server is down",
    "The service named billing-core is not deployed; redis crashed.",
    "I have restarted the cache and I will verify the deploy",
    "the database called orders exists, auth-service returned 500",
    "worker-3 timed out, then worker-3 rebooted",
    "nothing to report",
    "",
    "deploy is stopped\n\nsecond paragraph: cache is offline",
)
FACTS = [{"subject": "nginx", "predicate": "state", "value": "running"},
         {"subject": "api-server", "predicate": "state", "value": "up"},
         {"subject": "redis", "predicate": "last_operation",
          "value": "restarted"},
         {"subject": "billing-core", "predicate": "exists", "value": "true"},
         {"subject": "deploy", "predicate": "state", "value": "running"}]
META = {"agent_id": "main", "session_key": "agent:main", "channel_id":
        "twitter"}


def as_dicts(items):
    return [dataclasses.asdict(x) for x in items]


def test_claims_and_facts_match_jax(tmp_path):
    for text in TEXTS:
        for enabled in (None, ["system_state"], ["self_referential",
                                                 "existence"]):
            assert as_dicts(port_claims.detect_claims(text, enabled)) == \
                as_dicts(jax_claims.detect_claims(text, enabled))
    fact_file = tmp_path / "facts.json"
    fact_file.write_text(json.dumps({"facts": FACTS[2:] + [{"bad": 1}]}))
    report = tmp_path / "report.json"
    report.write_text(json.dumps({"findings": [
        {"signal": "doom", "confidence": 0.6, "factCorrection": {
            "subject": "cache", "predicate": "state", "value": "online"}},
        {"id": "f2", "fact_correction": {"subject": "x"}}]}))
    results = []
    for facts_mod, claims_mod in ((jax_facts, jax_claims),
                                  (port_facts, port_claims)):
        reg = facts_mod.FactRegistry(FACTS[:2])
        n = reg.load_facts_from_file(fact_file)
        for f in facts_mod.extract_facts_from_trace_report(report):
            reg.add_fact(facts_mod.Fact(**f))
        checked = [as_dicts(facts_mod.check_claims(
            claims_mod.detect_claims(t), reg)) for t in TEXTS]
        results.append((n, as_dicts(reg.all_facts()), checked,
                        reg.load_facts_from_file(tmp_path / "missing.json")))
    assert results[0] == results[1]


def test_response_gate_matches_jax():
    cfg = {"enabled": True, "fallbackMessage": "{agent}: {validators} / "
                                               "{reasons}",
           "rules": [{"agents": ["main"], "validators": [
               {"type": "requiredTools", "tools": ["read", "exec"]},
               {"type": "mustMatch", "pattern": r"\bdone\b"},
               {"type": "mustNotMatch", "pattern": r"sk-\w+",
                "message": "secret"}]},
               {"validators": [{"type": "mustMatch", "pattern": "(bad"}]}]}
    logs = ([], [{"tool": "read"}], [{"tool": "read"}, {"tool": "exec"}])
    for text in ("done, sk-abc", "done", "not finished", ""):
        for agent in ("main", "other"):
            for log in logs:
                want = jax_val.ResponseGate(cfg).validate(text, agent, log)
                got = port_val.ResponseGate(cfg).validate(text, agent, log)
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert port_val.ResponseGate({}).validate("x", "a", []).passed


def out_dict(result):
    d = dataclasses.asdict(result)
    d.pop("evaluation_us")
    return d


@pytest.mark.parametrize("policy", ["ignore", "flag", "block"])
def test_output_validator_matches_jax(policy):
    cfg = {"unverifiedClaimPolicy": policy, "selfReferentialPolicy":
           {"ignore": "flag", "flag": "block", "block": "ignore"}[policy],
           "contradictionThresholds": {"blockBelow": 40, "flagAbove": 60}}
    log_j, log_p = jax_api.list_logger(), port_api.list_logger()
    ov_j = jax_val.OutputValidator(cfg, jax_val.FactRegistry(FACTS), log_j)
    ov_p = port_val.OutputValidator(cfg, port_val.FactRegistry(FACTS), log_p)
    for text in TEXTS:
        for trust in (10, 40, 50, 60, 90):
            for external in (False, True):
                assert out_dict(ov_p.validate(text, trust, external)) == \
                    out_dict(ov_j.validate(text, trust, external))
    assert port_val.OutputValidator({"enabled": False}, None, log_p) \
        .validate("x is down", 0).verdict == "pass"


class Scripted:
    """A ``call_llm`` that answers from a list, raising where it holds an
    exception; it records every prompt."""

    def __init__(self, answers):
        self.answers = list(answers)
        self.prompts = []

    def __call__(self, prompt):
        self.prompts.append(prompt)
        a = self.answers.pop(0)
        if isinstance(a, BaseException):
            raise a
        return a


def llm_answers():
    return [
        '```json\n{"verdict": "flag", "reason": "fenced", "issues": '
        '[{"category": "exaggeration", "detail": "x"}, {"category": "nope"},'
        ' "junk"]}\n```',
        'Here you go: {"verdict": "block", "reason": "prose"} thanks',
        "not json at all", '{"verdict": "maybe"}',
        RuntimeError("endpoint down"), '{"verdict": "pass", "reason": "ok"}',
        RuntimeError("down"), RuntimeError("still down"),
        '{"verdict": "pass"}',
    ]


@pytest.mark.parametrize("fail_mode", ["open", "closed"])
def test_llm_validator_matches_jax(fail_mode):
    texts = ("first", "second", "first", "third", "fourth", "fifth")
    runs = []
    for llm_mod, api_mod, facts_mod in ((jax_llm, jax_api, jax_facts),
                                        (port_llm, port_api, port_facts)):
        clock = FakeClock()
        logger = api_mod.list_logger()
        call = Scripted(llm_answers())
        v = llm_mod.LlmValidator(call, logger, fail_mode=fail_mode,
                                 clock=clock)
        facts = [facts_mod.Fact(**f) for f in FACTS[:2]]
        out = []
        for text in texts:
            out.append(dataclasses.asdict(v.validate(text, facts)))
            clock.advance(50.0)
        clock.advance(301.0)
        out.append(dataclasses.asdict(v.validate("first", facts)))  # stale
        runs.append((out, call.prompts, logger.records))
    assert runs[0] == runs[1]
    out = runs[0][0]
    assert out[2]["from_cache"] and not out[-1]["from_cache"]
    assert [o["verdict"] for o in out] == [
        "flag", "block", "flag", "block" if fail_mode == "closed" else "pass",
        "pass", "block" if fail_mode == "closed" else "pass", "pass"]
    assert port_llm.djb2("héllo") == jax_llm.djb2("héllo")
    assert port_llm.CACHE_TTL_S == jax_llm.CACHE_TTL_S


def load_plugin(core_mod, api_mod, plugin_cls, ws, lcfg, call_llm=None,
                fail_mode="open", **kw):
    logger = api_mod.list_logger()
    gw = core_mod.Gateway(config={"workspace": str(ws),
                                  "agents": [{"id": "main"}]},
                          logger=logger, clock=FakeClock())
    plugin = plugin_cls(workspace=str(ws), clock=gw.clock,
                        call_llm=call_llm, **kw)
    gw.load(plugin, plugin_config={
        "builtinPolicies": {}, "failMode": fail_mode,
        "validation": {"enabled": True, "facts": FACTS,
                       "llmValidator": lcfg}}, logger=logger)
    gw.start()
    return gw, plugin, logger


def decisions(gw, texts, meta=META):
    out = []
    for text in texts:
        d = gw.message_sending(text, dict(meta))
        out.append((d.blocked, d.content, d.block_reason))
    return out


def severity_texts():
    pool = synthetic_examples(240, seed=17)
    texts = [t for sev in range(4)
             for t in [t for t, lab in pool if lab["severity"] == sev][:6]]
    return texts + ["nginx is stopped and we are fine",
                    "deploy is stopped", "api-server is up, all good"]


def test_config_only_local_stage3_matches_jax(tmp_path, openclaw_home,
                                              one_torch_thread):
    texts = severity_texts()
    lcfg = {"enabled": True, "local": True, "failMode": "closed"}
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    try:
        gw_j, plugin_j, _ = load_plugin(jax_core, jax_api, JaxPlugin,
                                        tmp_path / "jax", lcfg)
        want = decisions(gw_j, texts)
        gw_j.stop()
        gw_p, plugin_p, log_p = load_plugin(port_core, port_api,
                                            GovernancePlugin,
                                            tmp_path / "port", lcfg,
                                            device="cpu")
        call = plugin_p.engine.output_validator.llm_validator.call_llm
        batcher = call.batcher
        assert batcher.device == torch.device("cpu")
        got = decisions(gw_p, texts)
        assert gw_p.stage_timers["serve"] is batcher.timer
        assert batcher.served == len(set(texts))  # repeats from the cache
        gw_p.stop()
    finally:
        serve.close_batchers()
        jax_serve.close_batchers()
        jax_journal.reset_journals()
        port_journal.reset_journals()
    assert got == want
    reasons = [r for _, _, r in want if r]
    assert any("local triage encoder" in r for r in reasons)
    assert any("Contradiction detected" in r for r in reasons)
    assert any(not blocked for blocked, _, _ in want)
    assert any("stage-3 validator: local encoder serve path" in m
               for _, m in log_p.records)


@pytest.mark.parametrize("fail_mode", ["open", "closed"])
@pytest.mark.parametrize("plugin_fail_mode", ["open", "closed"])
def test_device_error_propagates_where_jax_fails_over(
        tmp_path, openclaw_home, fail_mode, plugin_fail_mode):
    """JAX: ``LlmValidator`` catches the error, retries once and answers
    "LLM validation unavailable" by its failMode
    (``llm_validator.py:90``). The port: the error leaves
    ``gw.message_sending`` on the first attempt."""
    lcfg = {"enabled": True, "failMode": fail_mode}
    text = "all good here"
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    try:
        err = DeviceError("flash_attention: kernel did not launch")
        call_j = Scripted([err, err])
        gw_j, _, log_j = load_plugin(jax_core, jax_api, JaxPlugin,
                                     tmp_path / "jax", lcfg, call_llm=call_j,
                                     fail_mode=plugin_fail_mode)
        (want,) = decisions(gw_j, [text])
        assert want[0] == (fail_mode == "closed")
        assert len(call_j.prompts) == 2
        assert any("LLM validation call failed" in m
                   for _, m in log_j.records)
        call_p = Scripted([err, err])
        gw_p, plugin_p, _ = load_plugin(port_core, port_api,
                                        GovernancePlugin, tmp_path / "port",
                                        lcfg, call_llm=call_p,
                                        fail_mode=plugin_fail_mode)
        with pytest.raises(DeviceError):
            gw_p.message_sending(text, dict(META))
        assert len(call_p.prompts) == 1  # no retry
        cuda = RuntimeError("CUDA error: an illegal memory access")
        plugin_p.engine.output_validator.llm_validator.call_llm = \
            Scripted([cuda])
        with pytest.raises(RuntimeError, match="CUDA"):
            gw_p.message_sending("second text", dict(META))
        gw_j.stop()
        gw_p.stop()
    finally:
        jax_journal.reset_journals()
        port_journal.reset_journals()


def test_output_validator_lets_a_device_error_through():
    """JAX's stage-3 catch (``output_validator.py:87``) falls back to the
    stage-1/2 verdict on any error; the port's does so for every error but
    the device's."""

    class Raising:
        def __init__(self, exc):
            self.exc = exc

        def validate(self, *_a):
            raise self.exc

    cfg = {"llmValidator": {"enabled": True}}
    log_j, log_p = jax_api.list_logger(), port_api.list_logger()
    plain = ValueError("bad answer")
    ov_j = jax_val.OutputValidator(cfg, jax_val.FactRegistry(FACTS), log_j,
                                   Raising(plain))
    ov_p = port_val.OutputValidator(cfg, port_val.FactRegistry(FACTS), log_p,
                                    Raising(plain))
    assert out_dict(ov_p.validate("nginx is stopped", 10, True)) == \
        out_dict(ov_j.validate("nginx is stopped", 10, True))
    assert log_p.records == log_j.records
    ov_j.llm_validator = Raising(DeviceError("no card"))
    assert ov_j.validate("nginx is stopped", 10, True).verdict == "block"
    ov_p.llm_validator = Raising(DeviceError("no card"))
    with pytest.raises(DeviceError):
        ov_p.validate("nginx is stopped", 10, True)


@pytest.mark.parametrize("fail_mode", ["open", "closed"])
def test_plain_error_gives_identical_decisions(tmp_path, openclaw_home,
                                               fail_mode):
    lcfg = {"enabled": True, "failMode": fail_mode}
    texts = ["all good here", "nginx is stopped", "deploy is running"]
    out = []
    try:
        for name, core_mod, api_mod, plugin_cls in (
                ("jax", jax_core, jax_api, JaxPlugin),
                ("port", port_core, port_api, GovernancePlugin)):
            (tmp_path / name).mkdir()
            call = Scripted([RuntimeError("endpoint down")] * 3
                            + ['{"verdict": "flag", "reason": "r"}'] * 3)
            gw, _, logger = load_plugin(core_mod, api_mod, plugin_cls,
                                        tmp_path / name, lcfg, call_llm=call,
                                        fail_mode=fail_mode)
            out.append((decisions(gw, texts), call.prompts, logger.records))
            gw.stop()
    finally:
        jax_journal.reset_journals()
        port_journal.reset_journals()
    assert out[0] == out[1]


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="needs a host without a CUDA device")
def test_missing_card_raises_at_load_where_jax_logs(tmp_path, openclaw_home,
                                                    monkeypatch):
    """JAX's ``_init_validation`` logs "local stage-3 unavailable" for any
    ``RuntimeError`` of ``make_local_call_llm`` and serves with no stage 3
    (``plugin.py:235``); the port raises for a missing card and keeps
    JAX's log line for the others (here: no checkpoint)."""
    lcfg = {"enabled": True, "local": True, "failMode": "closed"}

    def no_backend(*_a, **_k):
        raise RuntimeError("no usable backend")

    monkeypatch.setattr(jax_serve, "make_local_call_llm", no_backend)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    (tmp_path / "port2").mkdir()
    try:
        gw_j, plugin_j, log_j = load_plugin(jax_core, jax_api, JaxPlugin,
                                            tmp_path / "jax", lcfg)
        assert plugin_j.engine.output_validator.llm_validator is None
        assert any("local stage-3 unavailable" in m for _, m in log_j.records)
        gw_j.stop()
        with pytest.raises(DeviceError, match="no CUDA device"):
            load_plugin(port_core, port_api, GovernancePlugin,
                        tmp_path / "port", lcfg)
        gw_p, plugin_p, log_p = load_plugin(
            port_core, port_api, GovernancePlugin, tmp_path / "port2",
            {**lcfg, "checkpointDir": str(tmp_path / "nowhere")},
            device="cpu")
        assert plugin_p.engine.output_validator.llm_validator is None
        assert any("local stage-3 unavailable" in m for _, m in log_p.records)
        gw_p.stop()
    finally:
        jax_journal.reset_journals()
        port_journal.reset_journals()


@pytest.mark.parametrize("section", [
    {"twoFa": {"enabled": True, "totpSecret": "JBSWY3DPEHPK3PXP"}},
    {"erc8004": {"enabled": True}}])
def test_two_fa_and_erc8004_configs_load_as_in_jax(tmp_path, openclaw_home,
                                                   section):
    """Each section, enabled, registers the same hooks (priority, plugin,
    never_shed, handler) and services in both packages, and builds the
    same approver or provider state."""
    out = []
    try:
        for name, core_mod, api_mod, plugin_cls in (
                ("jax", jax_core, jax_api, JaxPlugin),
                ("port", port_core, port_api, GovernancePlugin)):
            ws = tmp_path / name
            ws.mkdir()
            gw = core_mod.Gateway(config={"workspace": str(ws)},
                                  logger=api_mod.list_logger(),
                                  clock=FakeClock())
            plugin = plugin_cls(workspace=str(ws), clock=gw.clock)
            gw.load(plugin, plugin_config=section)
            hooks = {hook: [(r.priority, r.plugin_id, r.never_shed,
                             r.handler.__name__) for r in regs]
                     for hook, regs in gw.bus._handlers.items()}
            approval, erc = plugin.approval_2fa, plugin.erc8004
            state = {
                "approval": None if approval is None else {
                    "config": approval.config,
                    "wall_timers": approval.wall_timers,
                    "pending": approval.pending_count(),
                    "key": approval.totp.key,
                    "notify": approval.notify_fn is not None},
                "erc8004": None if erc is None else {
                    "rpc_url": erc.rpc_url, "registry": erc.registry,
                    "cache": [erc.cache_max, erc.cache_ttl_s]}}
            out.append((hooks, [(pid, s.id) for pid, s in gw.services],
                        sorted(gw.commands), state))
            gw.stop()
    finally:
        jax_journal.reset_journals()
        port_journal.reset_journals()
    assert out[1] == out[0]
    hooks, _, _, state = out[0]
    if "twoFa" in section:
        assert state["approval"]["config"]["totpSecret"] == "JBSWY3DPEHPK3PXP"
        assert (100, "governance", True, "handle_2fa_code") in \
            hooks["message_received"]
    else:
        assert state["erc8004"]["rpc_url"] == "https://mainnet.base.org"
        assert state["approval"] is None


def test_an_injected_approver_is_wired_as_in_jax(tmp_path, openclaw_home):
    class Approver:
        def __init__(self):
            self.calls = []

        def request(self, *args):
            self.calls.append(args)
            return {"block": True, "block_reason": "awaiting approval"}

        def try_resolve(self, code, sender, conversation):
            return {"status": "approved", "code": code}

    out = []
    try:
        for name, core_mod, api_mod, plugin_cls in (
                ("jax", jax_core, jax_api, JaxPlugin),
                ("port", port_core, port_api, GovernancePlugin)):
            ws = tmp_path / name
            ws.mkdir()
            approver = Approver()
            gw = core_mod.Gateway(config={"workspace": str(ws)},
                                  logger=api_mod.list_logger(),
                                  clock=FakeClock())
            gw.load(plugin_cls(workspace=str(ws), clock=gw.clock,
                               approval_2fa=approver),
                    plugin_config={"twoFa": {"enabled": True},
                                   "builtinPolicies": {},
                                   "policies": [{"id": "g", "rules": [{
                                       "conditions": [{"type": "tool",
                                                       "name": "exec"}],
                                       "effect": {"action": "2fa",
                                                  "reason": "exec"}}]}]})
            gw.start()
            d = gw.before_tool_call("exec", {"command": "ls"},
                                    {"agent_id": "main"})
            r = gw.message_received("123456", {"session_key": "s"})
            out.append((dataclasses.asdict(d), r, approver.calls))
            gw.stop()
    finally:
        jax_journal.reset_journals()
        port_journal.reset_journals()
    assert out[0] == out[1]
    assert out[0][0]["blocked"] and out[0][1]
