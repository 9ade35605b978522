"""The port's sitrep against the JAX package's.

Every port collector returns JAX's dict on the same state directory and
the same status surfaces; ``collect_model_registry`` reads each package's
own registry book, and equal registry histories give equal dicts. The
port's ``SitrepPlugin`` loads into JAX's ``Gateway`` and its ``/ops`` shows
the port's registries with no patch.
"""

from __future__ import annotations

import json

import pytest

from helpers import make_gateway
from vainplex_openclaw_tpu.core.api import list_logger
from vainplex_openclaw_tpu.models import registry as jax_registry
from vainplex_openclaw_tpu.sitrep import aggregator as jax_aggregator
from vainplex_openclaw_tpu.sitrep import collectors as jax_collectors
from vainplex_openclaw_tpu.sitrep import plugin as jax_plugin
from vainplex_openclaw_tpu.utils.stage_timer import StageTimer
from vainplex_openclaw_tpu_torch.models import registry
from vainplex_openclaw_tpu_torch.sitrep import (SitrepPlugin, aggregator,
                                                collectors)
from vainplex_openclaw_tpu_torch.sitrep import plugin as port_plugin
from vainplex_openclaw_tpu_torch.slo import harness
from vainplex_openclaw_tpu_torch.slo.workload import generate_fleet_workload

T0 = 1_753_772_400.0


@pytest.fixture(autouse=True)
def _clean_books():
    yield
    registry.clear_registries()
    jax_registry.clear_registries()


def write_state(ws) -> None:
    """Goals, threads, audit denials, a calendar and an adversarial run."""
    (ws / "goals.json").write_text(json.dumps({"goals": [
        {"title": "ship", "status": "open"}, {"title": "old", "status": "done"},
        "not a goal"]}))
    reboot = ws / "memory" / "reboot"
    reboot.mkdir(parents=True)
    (reboot / "threads.json").write_text(json.dumps({"threads": [
        {"title": "db move", "status": "open", "priority": "high",
         "waiting_for": "review"},
        {"title": "docs", "status": "open"},
        {"title": "done", "status": "closed"}]}))
    audit = ws / "governance" / "audit"
    audit.mkdir(parents=True)
    for day, n in (("2026-01-01", 3), ("2026-01-02", 25)):
        with (audit / f"{day}.jsonl").open("w") as fh:
            for i in range(n):
                fh.write(json.dumps({
                    "verdict": "deny" if i % 2 else "allow",
                    "reason": f"r{i}", "context": {"toolName": "exec"}}) + "\n")
            fh.write('{"torn')
    (ws / "calendar.json").write_text(json.dumps({"events": [
        {"title": f"e{i}"} for i in range(25)]}))
    (ws / ".adversarial.json").write_text(json.dumps({
        "packs": ["redos_storm"], "seed": 3, "attackOps": 12,
        "survived": False, "verdictLosses": 1, "falseBlocks": 0,
        "victimP99Ms": 4.5, "victimP99Factor": 1.2,
        "victimBudgetFactor": 3.0}))


def status_ctx(ws) -> dict:
    """Status surfaces a gateway would hand the collectors, as plain
    functions, with a replica fleet's stats in the cluster status."""
    ops = generate_fleet_workload(2, 120, 4, profile="burst")
    fleet_stats = harness._run_fleet_sim(
        ops, {"replicas": 2, "autoscale": True, "evalEveryOps": 16,
              "scaleUpQueueDepth": 2.0}, 2, device="cpu")["stats"]
    timer = StageTimer()
    for ms in (0.5, 1.0, 2.0, 40.0):
        timer.add("forward", ms)
    timer.add("route", 0.1)
    gateway = {"plugins": ["governance", "sitrep"], "degraded": ["cortex"],
               "breakers": {"cortex": {"message_received": {
                   "state": "open", "failures": 3}}},
               "hooks": {"message_received": {"errors": 2, "skipped": 1}},
               "admission": {"enabled": True, "queueDepth": 300,
                             "highWatermark": 128, "shed": 7},
               "journal": {"ws": {"fsync": "os", "pendingRecords": 2,
                                  "commits": 4, "spilled": 1,
                                  "replay": {"torn_tails": 1},
                                  "lifecycle": {"coldSegments": 2,
                                                "demoteBacklog": 1}}},
               "lifecycle": {"cortex": {"resident": 2, "hibernated": 1,
                                        "wakes": 3, "wakeP99Ms": 1.5}}}
    return {
        "workspace": str(ws),
        "eventstore_status": lambda: {"healthy": False,
                                      "transport": "file", "published": 9,
                                      "publish_failures": 1,
                                      "torn_tails": 1, "outbox_len": 0},
        "governance_status": lambda: {
            "audit": {"spilled": 2, "flushFailures": 0},
            "patternSafety": {"checked": True, "unsafePatterns": [
                {"policyId": "p1", "pattern": "(a+)+$", "issue": "nested"}]}},
        "cortex_pattern_safety": lambda: [],
        "cluster_status": lambda: {
            "workers": {"w0": {"breaker": {"state": "closed"}},
                        "w1": {"breaker": {"state": "half-open"}}},
            "membership": {"live": ["w0"], "dead": ["w1"]},
            "fencedRecords": 1, "routed": 40,
            "routeLog": {"kind": "memory", "healthy": True},
            "leases": {"ws0": {"epoch": 2}}, "fleet": fleet_stats},
        "gateway_status": lambda: gateway,
        "stage_timers": lambda: {"serve": timer.snapshot()},
    }


def strip_durations(result: dict) -> dict:
    return {k: v for k, v in result.items() if k != "duration_ms"}


def test_every_collector_equals_jax(tmp_path):
    write_state(tmp_path)
    ctx = status_ctx(tmp_path)
    config = {"path": str(tmp_path / "calendar.json"), "defaultP99Ms": 10.0,
              "p99Ms": {"serve:route": 1.0}}
    names = sorted(collectors.BUILTIN_COLLECTORS)
    assert names == sorted(jax_collectors.BUILTIN_COLLECTORS)
    for name in names:
        if name == "model_registry":
            continue  # each reads its own package's book (below)
        cfg = {} if name == "goals" else config
        got = collectors.BUILTIN_COLLECTORS[name](cfg, ctx)
        want = jax_collectors.BUILTIN_COLLECTORS[name](cfg, ctx)
        assert got == want, name
    for name in ("goals", "threads", "errors", "slo", "gateway", "cluster"):
        assert collectors.BUILTIN_COLLECTORS[name](config, ctx)["status"] \
            != "skipped", name
    cluster = collectors.collect_cluster({}, ctx)
    assert cluster["items"][0]["fleet"]["served"] == 120
    assert "fleet: " in cluster["summary"]
    slo = collectors.collect_slo(config, ctx)
    assert "adversarial" in slo and slo["status"] in ("warn", "error")
    # without status surfaces every collector skips alike
    bare = {"workspace": str(tmp_path / "empty")}
    for name in names:
        if name != "model_registry":
            assert strip_durations(collectors.safe_collect(
                name, collectors.BUILTIN_COLLECTORS[name], {"enabled": True},
                bare, list_logger())) == strip_durations(
                jax_collectors.safe_collect(
                    name, jax_collectors.BUILTIN_COLLECTORS[name],
                    {"enabled": True}, bare, list_logger())), name


def book_history(pkg_registry, **kw):
    """The same version-book history in either package."""
    reg = pkg_registry.ModelRegistry({"enabled": True},
                                     name="fleet:cluster.fleet", **kw)
    reg.register_stub("v1", activate=True)
    reg.register_stub("v2")
    reg.set_canary("v2", 0.5)
    for t in ("t0", "t1", "t2", "t3"):
        reg.resolve(t)
    reg.note_served("v2", 2)
    reg.activate("v2")
    reg.activate(reg.rollback_target())
    idle = pkg_registry.ModelRegistry({"enabled": True}, name="serve:global",
                                      **kw)
    idle.register_stub("v0")
    idle.register_stub("v9")
    idle.set_canary("v9", 0.0)
    return reg


def test_model_registry_collector_reads_its_own_book():
    empty = collectors.collect_model_registry({}, {})
    assert empty == jax_collectors.collect_model_registry({}, {})
    assert empty["status"] == "skipped"
    book_history(registry, device="cpu")
    got = collectors.collect_model_registry({}, {})
    # the JAX collector reads JAX's book, which is still empty
    assert jax_collectors.collect_model_registry({}, {})["status"] == \
        "skipped"
    book_history(jax_registry)
    assert got == jax_collectors.collect_model_registry({}, {})
    assert got["status"] == "warn"
    assert [i["registry"] for i in got["items"]] == ["fleet:cluster.fleet",
                                                     "serve:global"]
    assert got["items"][0]["swaps"] == 2 and got["items"][0]["rollbacks"] == 1


def test_generate_sitrep_and_ops_report_equal_jax(tmp_path):
    write_state(tmp_path)
    ctx = status_ctx(tmp_path)
    book_history(registry, device="cpu")
    book_history(jax_registry)
    cfg = {"collectors": {name: {"enabled": True}
                          for name in port_plugin.DEFAULTS["collectors"]
                          if name != "systemd_timers"},
           "customCollectors": []}
    got = aggregator.generate_sitrep(cfg, ctx, list_logger(), lambda: T0)
    want = jax_aggregator.generate_sitrep(cfg, ctx, list_logger(), lambda: T0)
    assert {k: strip_durations(v) for k, v in got["collectors"].items()} == \
        {k: strip_durations(v) for k, v in want["collectors"].items()}
    assert (got["health"], got["generatedAt"]) == (want["health"],
                                                   want["generatedAt"])
    assert port_plugin.DEFAULTS == jax_plugin.DEFAULTS
    assert port_plugin.OPS_COLLECTORS == jax_plugin.OPS_COLLECTORS
    assert port_plugin.MANIFEST.to_dict() == jax_plugin.MANIFEST.to_dict()
    path = aggregator.write_sitrep(got, tmp_path)
    aggregator.write_sitrep(got, tmp_path)
    assert json.loads(path.read_text()) == got
    assert (tmp_path / "sitrep.previous.json").exists()


def test_ops_in_a_jax_gateway_shows_the_port_registry(tmp_path):
    """The port's plugin in JAX's Gateway: ``/ops`` renders the port's
    fleet registry; JAX's plugin on the same process state does not see
    it (it reads JAX's book), and ``customCollectors`` stays off in
    ``/ops``."""
    book_history(registry, device="cpu")
    texts = {}
    for name, plugin in (("port", SitrepPlugin), ("jax", jax_plugin.SitrepPlugin)):
        gw, _ = make_gateway(config={"workspace": str(tmp_path)})
        gw.load(plugin(workspace=str(tmp_path), wall_timers=False),
                plugin_config={"intervalMinutes": 0, "customCollectors": [
                    {"id": "x", "command": "echo should-not-run"}]})
        gw.start()
        texts[name] = gw.command("ops")["text"]
        report = gw.plugins["sitrep"].module.ops_report()
        assert not any(k.startswith("custom:") for k in report["collectors"])
        gw.stop()
    assert "models: 2 registries" in texts["port"]
    assert "fleet:cluster.fleet: active=v1" in texts["port"]
    assert "models:" not in texts["jax"]
    assert texts["port"].split("\n", 1)[0].startswith("🛰 ops: ")
