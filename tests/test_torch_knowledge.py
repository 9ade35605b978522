"""The port's knowledge engine against the JAX package's.

- ``EntityExtractor`` on seeded texts that cover each of its ``PATTERNS``
  kinds, and on the SLO workload's messages: equal entities.
- ``FactStore``: a seeded stream of adds (with repeats), queries, decay
  ticks that prune, the prune at ``maxFacts``, hibernate and reload, with
  the legacy atomic write and with the workspace journal: equal facts,
  query results and ``facts.json`` bytes, the id RNG seeded alike.
- ``KnowledgeEnginePlugin`` through each framework's ``Gateway`` on a
  virtual clock (messages, maintenance ticks, ``/knowledge``): equal facts,
  files, ``stats()`` counts and ``/knowledge`` text (less its host-clock
  stage line). The semantic hits are held at 1e-5 on the shipped weights
  written as an fp32 checkpoint with the ids equal in order, and on the
  bf16 checkpoint as it ships at the bf16 vectors' tolerance (5e-2), with
  facts that score within it of each other free to trade ranks.

Deviations, each beside the JAX behaviour it departs from: an error of the
device propagates from each hook's catch, from the maintenance thread (at
the next hook, once) and from the enhancer, where JAX logs it; a plain
error gives JAX's log line and result; ``/knowledge`` lets a device error
through ``Gateway.command``, where JAX answers "command knowledge failed";
``Gateway.stop`` raises a device error of a service's stop after closing
the journals, where JAX logs it; the local backend asks for the card at
``gw.load`` unless told ``device="cpu"``, the ``chroma`` and ``none``
backends never.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from helpers import FakeClock
# the bounds module puts the repository root on the path for chip_smoke
from test_torch_chip_smoke_bounds import one_torch_thread  # noqa: F401
import chip_smoke  # noqa: E402
from vainplex_openclaw_tpu import core as jax_core
from vainplex_openclaw_tpu.core import api as jax_api
from vainplex_openclaw_tpu.knowledge import KnowledgeEnginePlugin as JaxKnowledge
from vainplex_openclaw_tpu.knowledge import entity_extractor as jax_ex
from vainplex_openclaw_tpu.knowledge import fact_store as jax_fs
from vainplex_openclaw_tpu.knowledge import llm_enhancer as jax_enh
from vainplex_openclaw_tpu.knowledge import plugin as jax_plugin
from vainplex_openclaw_tpu.models import pretrained as jax_pretrained
from vainplex_openclaw_tpu.slo.workload import generate_workload
from vainplex_openclaw_tpu.storage import journal as jax_journal
from vainplex_openclaw_tpu.utils import ids as jax_ids
from vainplex_openclaw_tpu_torch import core as port_core
from vainplex_openclaw_tpu_torch.core import api as port_api
from vainplex_openclaw_tpu_torch.device import DeviceError
from vainplex_openclaw_tpu_torch.knowledge import KnowledgeEnginePlugin
from vainplex_openclaw_tpu_torch.knowledge import entity_extractor as port_ex
from vainplex_openclaw_tpu_torch.knowledge import fact_store as port_fs
from vainplex_openclaw_tpu_torch.knowledge import llm_enhancer as port_enh
from vainplex_openclaw_tpu_torch.knowledge import plugin as port_plugin
from vainplex_openclaw_tpu_torch.models import checkpoint as port_ckpt
from vainplex_openclaw_tpu_torch.models import pretrained as port_pretrained
from vainplex_openclaw_tpu_torch.models.encoder import unflatten_tree
from vainplex_openclaw_tpu_torch.storage import journal as port_journal
from vainplex_openclaw_tpu_torch.utils import ids as port_ids

JAX = dict(core=jax_core, api=jax_api, ids=jax_ids, journal=jax_journal,
           fs=jax_fs, knowledge=JaxKnowledge)
PORT = dict(core=port_core, api=port_api, ids=port_ids, journal=port_journal,
            fs=port_fs,
            knowledge=lambda **kw: KnowledgeEnginePlugin(device="cpu", **kw))
START = 1_700_000_000.0
BF16_SCORE_TOL = 5e-2  # the bf16 vectors' tolerance (test_torch_triage_embeddings)


@pytest.fixture(autouse=True)
def fresh_state():
    for pkg in (JAX, PORT):
        pkg["journal"].reset_journals()
    jax_pretrained.clear_cache()
    port_pretrained.clear_cache()
    yield
    for pkg in (JAX, PORT):
        pkg["journal"].reset_journals()
    jax_pretrained.clear_cache()
    port_pretrained.clear_cache()


@pytest.fixture(scope="module")
def fp32_checkpoint(tmp_path_factory):
    """The shipped weights as an fp32 checkpoint both packages load."""
    path = str(tmp_path_factory.mktemp("tiny_fp32"))
    flat = {k: torch.as_tensor(v).float() for k, v in
            port_ckpt.read_checkpoint(port_pretrained.DEFAULT_DIR).items()}
    cfg = dataclasses.replace(port_pretrained.TINY_CONFIG, dtype="float32")
    port_pretrained.write_pretrained(path, cfg, unflatten_tree(flat))
    return path


def tree(ws: Path) -> dict:
    return {str(p.relative_to(ws)): p.read_bytes()
            for p in sorted(ws.rglob("*")) if p.is_file()}


# ── entity extraction ────────────────────────────────────────────────

_FIRST = ("Alice", "Bruno", "Chiara", "Dmitri", "Elena", "Farid")
_LAST = ("Johnson", "Keller", "Rossi", "Novak", "Okafor")
_TEXTS = {
    "email": lambda r: f"write to {r.choice(_FIRST).lower()}.{r.randrange(99)}"
                       f"@example.org or ops@{r.choice(_LAST).lower()}.io",
    "url": lambda r: f"see https://docs.example.com/{r.randrange(999)}/guide"
                     f"?q={r.randrange(9)} and http://x.io/a.",
    "iso_date": lambda r: f"due 2025-0{r.randrange(1, 9)}-1{r.randrange(9)}"
                          f"T10:2{r.randrange(9)}:30Z or 2024-12-0{r.randrange(1, 9)}",
    "common_date": lambda r: f"on {r.randrange(1, 28)}/{r.randrange(1, 12)}/2024"
                             f" and {r.randrange(1, 28)}.{r.randrange(1, 12)}.24",
    "german_date": lambda r: f"am {r.randrange(1, 28)}. März 2025 und "
                             f"{r.randrange(1, 28)}. oktober 2026",
    "english_date": lambda r: f"on March {r.randrange(1, 28)}th, 2024 or "
                              f"july {r.randrange(1, 28)}, 2025",
    "proper_noun": lambda r: f"{r.choice(_FIRST)} {r.choice(_LAST)} met "
                             f"{r.choice(_FIRST)} in New-York. The end",
    "product_name": lambda r: f"we shipped Widget Pro II, release-v2.{r.randrange(9)}"
                              f" and ZetaIV with gateway {r.randrange(9)}",
    "organization_suffix": lambda r: f"{r.choice(_LAST)} Corp. and Acme "
                                     f"{r.choice(_LAST)} GmbH, Foo Ltd. signed",
}


def test_pattern_tables_are_jax_s():
    assert {k: (p.pattern, p.flags) for k, p in port_ex.PATTERNS.items()} == \
        {k: (p.pattern, p.flags) for k, p in jax_ex.PATTERNS.items()}
    assert port_ex.PATTERN_TYPE_MAP == jax_ex.PATTERN_TYPE_MAP
    assert port_ex.TYPE_IMPORTANCE == jax_ex.TYPE_IMPORTANCE
    assert port_ex.EXCLUDED_WORDS == jax_ex.EXCLUDED_WORDS
    assert set(_TEXTS) == set(jax_ex.PATTERNS)


def extracted(mod, texts):
    ex = mod.EntityExtractor(clock=lambda: START)
    return [[e.to_dict() for e in ex.extract(t)] for t in texts]


@pytest.mark.parametrize("kind", sorted(_TEXTS))
def test_extractor_on_each_pattern_kind(kind):
    rng = random.Random(kind)
    texts = [_TEXTS[kind](rng) for _ in range(6)]
    got = extracted(port_ex, texts)
    assert got == extracted(jax_ex, texts)
    kinds = {e["type"] for row in got for e in row}
    assert jax_ex.PATTERN_TYPE_MAP[kind] in kinds
    for value, etype in (("Acme Corp.", "organization"), ("x.", "unknown")):
        assert port_ex.canonicalize(value, etype) == \
            jax_ex.canonicalize(value, etype)
        assert port_ex.initial_importance(etype, value * 9) == \
            jax_ex.initial_importance(etype, value * 9)


def test_extractor_on_the_workload_messages():
    texts = [op.content for op in generate_workload(3, 400, 4)
             if op.kind in ("msg_in", "msg_out")]
    got = extracted(port_ex, texts)
    assert got == extracted(jax_ex, texts)
    assert sum(map(len, got)) > 100


# ── the fact store ───────────────────────────────────────────────────


def store_stream(pkg, ws: Path, journal: bool) -> dict:
    pkg["ids"]._ID_RNG.seed(7)
    clock = FakeClock(START)
    jr = (pkg["journal"].get_journal(ws, pkg["journal"].journal_settings(
        {"storage": {"journal": True}}), clock=clock, wall=False)
        if journal else None)
    store = pkg["fs"].FactStore(ws, {"maxFacts": 20, "decayFactor": 0.6,
                                     "pruneBelowRelevance": 0.2},
                                clock=clock, wall_timers=False, journal=jr)
    store.load()
    rng = random.Random(11)
    out = []
    for step in range(120):
        clock.advance(rng.choice((0.2, 1.0, 30.0)))
        r = rng.random()
        if r < 0.7:
            f = store.add_fact(rng.choice(("conversation", "alice", "bob")),
                               rng.choice(("mentioned", "likes")),
                               f"thing {rng.randrange(30)}")
            out.append(("add", f.to_dict()))
        elif r < 0.85:
            res = store.query(subject=rng.choice((None, "Alice", "bob")),
                              text=rng.choice((None, "thing 1", "LIKES")),
                              limit=rng.randrange(1, 8))
            out.append(("query", [f.id for f in res]))
        elif r < 0.95:
            out.append(("decay", store.decay_facts()))
        else:
            store.hibernate()
            out.append(("hibernated", store.loaded, store.count()))
            store.load()
        out.append(("count", store.count()))
        assert store.find_by_content_scan("alice", "likes", "thing 3") is \
            store.facts.get(store._content_index.get(
                ("alice", "likes", "thing 3")))
    store.flush()
    if jr is not None:
        jr.close()
    return {"out": out, "facts": [f.to_dict() for f in store.snapshot()],
            "files": tree(ws)}


@pytest.mark.parametrize("journal", [False, True], ids=["legacy", "journal"])
def test_fact_store_stream_matches_jax(tmp_path, journal):
    got = store_stream(PORT, tmp_path / "port", journal)
    want = store_stream(JAX, tmp_path / "jax", journal)
    assert got == want
    assert any(op == "decay" and n > 0 for op, n, *_ in
               [o for o in got["out"] if o[0] == "decay"])
    assert "knowledge/facts.json" in got["files"]
    assert max(n for op, n, *_ in [o for o in got["out"]
                                  if o[0] == "count"]) == 20


def test_fact_from_dict_and_defaults_match_jax():
    d = {"id": "a", "subject": "s", "predicate": "p", "object": "o",
         "relevance": "0.5"}
    assert port_fs.Fact.from_dict(d).to_dict() == \
        jax_fs.Fact.from_dict(d).to_dict()
    assert port_fs.DEFAULT_STORE_CONFIG == jax_fs.DEFAULT_STORE_CONFIG


# ── the plugin through each gateway ──────────────────────────────────


def knowledge_gateway(pkg, ws: Path, config: dict, clock, **plugin_kw):
    log = pkg["api"].list_logger()
    gw = pkg["core"].Gateway(config={"workspace": str(ws)}, logger=log,
                             clock=clock)
    plugin = pkg["knowledge"](workspace=str(ws), clock=clock,
                              **{"wall_timers": False, **plugin_kw})
    gw.load(plugin, plugin_config=config, logger=log)
    gw.start()
    return gw, plugin, log


_ENTITY_TEXTS = (
    "Alice Johnson from Acme Corp. emailed alice@acme.com about Widget Pro II",
    "the deploy of release-v2.4 failed on 2025-03-14, see https://ci.example.com/run/7",
    "Bruno Keller said Foo GmbH ships ZetaIV on March 3rd, 2024",
    "we decided to move the Datenbank Umzug to 12.04.2025 with Chiara Rossi",
    "Elena Novak owns the billing migration v3 and Okafor Ltd. the audit",
)
_QUERIES = ("Widget Pro", "deploy failed", "Chiara Rossi", "billing migration",
            "who ships ZetaIV", "Acme")


def run_plugin(pkg, ws: Path, config: dict, ops) -> dict:
    pkg["ids"]._ID_RNG.seed(5)
    clock = FakeClock(START)
    gw, plugin, log = knowledge_gateway(pkg, ws, config, clock)
    out = []
    searches = []
    ctx = {"session_key": "s1", "agent_id": "main"}
    out.append(gw.session_start(ctx))
    for i, op in enumerate(ops):
        clock.advance(7.0)
        if op.kind == "msg_in":
            out.append(gw.message_received(op.content, ctx))
        elif op.kind == "msg_out":
            out.append(gw.message_sent(op.content, ctx))
        if i % 40 == 39:
            out.append(("sync", plugin.maintenance.run_embeddings_sync()))
            out.append(("decay", plugin.maintenance.run_decay()))
    out.append(("sync", plugin.maintenance.run_embeddings_sync()))
    texts = []
    for q in _QUERIES:
        texts.append(gw.command("/knowledge", args=q)["text"]
                     .split("  stages:")[0])
        emb = plugin.embeddings
        hits = [[h["id"], h["score"]] for h in emb.search(q, k=3)]
        # every live fact's score against the cached query vector
        scores = dict(zip(emb._ids[:emb._size], (
            emb._arena[:emb._size] @ emb._query_cache[q]).tolist()))
        searches.append({"thread": "main", "query": q, "hits": hits,
                         "scores": scores})
    texts.append(gw.command("/knowledge")["text"].split("\n  stages:")[0])
    stats = plugin.stats()
    gw.stop()
    return {"out": out, "texts": texts, "searches": searches,
            "facts": [f.to_dict() for f in plugin.fact_store.snapshot()],
            "stats": {k: stats[k] for k in ("facts", "embedded", "stageCounts",
                                            "queryCache")},
            "files": tree(ws / "knowledge"),
            "log": [line for line in log.messages() if "ms" not in line]}


def plugin_ops(seed: int, n: int) -> list:
    rng = random.Random(seed)
    ops = [op for op in generate_workload(seed, n, 4)
           if op.kind in ("msg_in", "msg_out")]
    for op in ops:
        if rng.random() < 0.3:
            op.content = f"{op.content} {rng.choice(_ENTITY_TEXTS)}"
    return ops


@pytest.mark.parametrize("storage", [
    {"journal": True, "lifecycle": True},
    {"journal": False, "lifecycle": False, "maxFacts": 40}],
    ids=["journal", "legacy-capped"])
def test_plugin_fp32_matches_jax(tmp_path, openclaw_home, fp32_checkpoint,
                                 storage, one_torch_thread):
    config = {"storage": storage,
              "embeddings": {"checkpointDir": fp32_checkpoint}}
    ops = plugin_ops(21, 240)
    got = run_plugin(PORT, tmp_path / "port", config, ops)
    want = run_plugin(JAX, tmp_path / "jax", config, ops)
    for key in ("out", "texts", "facts", "stats", "files", "log"):
        assert got[key] == want[key], key
    for a, b in zip(got["searches"], want["searches"]):
        assert [h[0] for h in a["hits"]] == [h[0] for h in b["hits"]]
        np.testing.assert_allclose([h[1] for h in a["hits"]],
                                   [h[1] for h in b["hits"]], atol=1e-5)
    assert got["stats"]["facts"] > 20 and got["stats"]["embedded"] > 0


def test_plugin_bf16_matches_jax(tmp_path, openclaw_home, one_torch_thread):
    ops = plugin_ops(22, 160)
    got = run_plugin(PORT, tmp_path / "port", {}, ops)
    want = run_plugin(JAX, tmp_path / "jax", {}, ops)
    for key in ("out", "facts", "stats", "files"):
        assert got[key] == want[key], key
    assert [t.split("  semantic:")[0] for t in got["texts"]] == \
        [t.split("  semantic:")[0] for t in want["texts"]]
    # bf16 noise (~2e-3 here) lets facts that score within it of each
    # other trade ranks ("deploy failed": 0.3617 / 0.3614 against JAX's
    # 0.3594 / 0.3613): each hit's score within the tolerance of JAX's
    # score of that fact, a hit that is not JAX's at its rank within the
    # tolerance of JAX's hit there (chip_smoke's card-vs-CPU rule), and
    # the first hit JAX's wherever JAX's first two are further apart
    assert chip_smoke.knowledge_search_differs(got, want, BF16_SCORE_TOL) \
        == []
    for a, b in zip(got["searches"], want["searches"]):
        (top, s0), (_, s1) = b["hits"][:2]
        assert a["hits"][0][0] == top or s0 - s1 <= BF16_SCORE_TOL
        np.testing.assert_allclose(
            [h[1] for h in a["hits"]],
            [b["scores"][h[0]] for h in a["hits"]], atol=BF16_SCORE_TOL)


def test_defaults_manifest_and_hooks_are_jax_s(tmp_path, openclaw_home):
    assert port_plugin.DEFAULTS == jax_plugin.DEFAULTS
    assert port_plugin.MANIFEST.config_schema == jax_plugin.MANIFEST.config_schema
    assert port_plugin.MANIFEST.hooks == jax_plugin.MANIFEST.hooks
    regs = {}
    for name, pkg in (("port", PORT), ("jax", JAX)):
        gw, plugin, _ = knowledge_gateway(pkg, tmp_path / name,
                                          {"embeddings": {"backend": "none"}},
                                          FakeClock(START))
        regs[name] = (sorted((hook, r.priority) for hook, rs in
                             gw.bus._handlers.items() for r in rs),
                      sorted(gw.commands), sorted(gw.stage_timers),
                      [s.id for _, s in gw.services])
        gw.stop()
    assert regs["port"] == regs["jax"]


# ── deviations ───────────────────────────────────────────────────────


class _Boom:
    def __init__(self, exc):
        self.exc = exc

    def __call__(self, *a, **kw):
        raise self.exc


_HOOK_FAULTS = {
    # hook → (how to fire it, the plugin attribute made to raise)
    "session_start": (lambda gw: gw.session_start({"session_key": "s"}),
                      ("fact_store", "load")),
    "message_received": (lambda gw: gw.message_received(
        "Alice Johnson ships Widget Pro II", {"session_key": "s"}),
        ("extractor", "extract")),
    "message_sent": (lambda gw: gw.message_sent(
        "Alice Johnson ships Widget Pro II", {"session_key": "s"}),
        ("extractor", "extract")),
    "gateway_stop": (lambda gw: gw.fire("gateway_stop", {}, {}),
                     ("fact_store", "flush")),
}


def arm(plugin, where, exc):
    owner = getattr(plugin, where[0])
    setattr(owner, where[1], _Boom(exc))


@pytest.mark.parametrize("hook", sorted(_HOOK_FAULTS))
def test_a_device_error_leaves_each_hook_where_jax_logs_it(
        tmp_path, openclaw_home, hook):
    fire, where = _HOOK_FAULTS[hook]
    config = {"embeddings": {"backend": "none"}}
    if hook == "session_start":
        def arm_now(plugin):
            plugin.fact_store.loaded = False
            arm(plugin, where, DeviceError("launch failed"))
    else:
        def arm_now(plugin):
            arm(plugin, where, DeviceError("launch failed"))
    gw, plugin, _ = knowledge_gateway(PORT, tmp_path / "port", config,
                                      FakeClock(START))
    arm_now(plugin)
    with pytest.raises(DeviceError, match="launch failed"):
        fire(gw)
    jgw, jplugin, jlog = knowledge_gateway(JAX, tmp_path / "jax", config,
                                           FakeClock(START))
    if hook == "session_start":
        jplugin.fact_store.loaded = False
    arm(jplugin, where, DeviceError("launch failed"))
    assert all(r is None for r in fire(jgw))
    assert any("launch failed" in line for line in jlog.messages())


@pytest.mark.parametrize("hook", sorted(_HOOK_FAULTS))
def test_a_plain_error_gives_jax_s_log_and_result(tmp_path, openclaw_home,
                                                  hook):
    fire, where = _HOOK_FAULTS[hook]
    got = {}
    for name, pkg in (("port", PORT), ("jax", JAX)):
        gw, plugin, log = knowledge_gateway(
            pkg, tmp_path / name, {"embeddings": {"backend": "none"}},
            FakeClock(START))
        if hook == "session_start":
            plugin.fact_store.loaded = False
        arm(plugin, where, RuntimeError("disk on fire"))
        got[name] = (fire(gw), [line for line in log.messages()
                                if "disk on fire" in line])
    assert got["port"] == got["jax"]
    assert got["port"][1]


def test_a_device_error_on_the_maintenance_thread_is_raised_once(
        tmp_path, openclaw_home):
    """JAX logs a failed tick on its daemon thread and every hook goes on;
    the port ends the loop, keeps the error and raises it from the next
    hook, once."""
    config = {"maintenance": {"syncMinutes": 0.0005, "decayHours": 1000},
              "embeddings": {"backend": "chroma", "enabled": True}}
    logged = {}
    for name, pkg in (("port", PORT), ("jax", JAX)):
        ticked = threading.Event()
        gw, plugin, log = knowledge_gateway(pkg, tmp_path / name, config,
                                            time.time, wall_timers=True)

        def sync(facts, _e=ticked):
            _e.set()
            raise DeviceError("sync launch failed")

        plugin.embeddings.sync = sync
        gw.message_received("Alice Johnson ships Widget Pro II", {})
        assert ticked.wait(10)
        loop = next(t for t in plugin.maintenance._threads
                    if t.name == "ke-embeddings")
        loop.join(10 if name == "port" else 0.2)
        if name == "port":
            assert not loop.is_alive()
            with pytest.raises(DeviceError, match="sync launch failed"):
                gw.message_received("Bruno Keller likes ZetaIV", {})
        gw.message_received("Bruno Keller likes ZetaIV", {})  # port: once
        gw.stop()
        logged[name] = [m for m in log.messages("error")
                        if "maintenance tick failed" in m]
    assert logged["jax"] and logged["port"]


def test_a_kept_device_error_is_raised_by_stop(tmp_path, openclaw_home):
    gw, plugin, log = knowledge_gateway(PORT, tmp_path, {
        "embeddings": {"backend": "none"}}, FakeClock(START))
    plugin.maintenance._device_error = DeviceError("tick failed")
    with pytest.raises(DeviceError, match="tick failed"):
        gw.stop()


def test_a_device_error_leaves_the_enhancer(tmp_path, openclaw_home):
    config = {"llm": {"enabled": True, "batchSize": 1},
              "embeddings": {"backend": "none"}}
    got = {}
    for exc in (DeviceError("local llm launch failed"),
                RuntimeError("llm down")):
        for name, pkg in (("port", PORT), ("jax", JAX)):
            gw, plugin, log = knowledge_gateway(
                pkg, tmp_path / f"{name}-{type(exc).__name__}", config,
                FakeClock(START), call_llm=_Boom(exc))
            if name == "port" and isinstance(exc, DeviceError):
                with pytest.raises(DeviceError):
                    gw.message_received("Alice Johnson ships Widget Pro II",
                                        {})
                continue
            res = gw.message_received("Alice Johnson ships Widget Pro II", {})
            got[(name, type(exc).__name__)] = (
                res, [f.object for f in plugin.fact_store.snapshot()],
                [line for line in log.messages() if "LLM batch" in line])
    assert got[("port", "RuntimeError")] == got[("jax", "RuntimeError")]
    assert got[("jax", "DeviceError")][1] == got[("jax", "RuntimeError")][1]
    for mod in (port_enh, jax_enh):
        enh = mod.KnowledgeLlmEnhancer(
            lambda p: '```json\n{"facts": [{"subject": "a", "predicate": '
                      '"b", "object": "c"}, {"subject": ""}]}\n```',
            port_api.list_logger(), batch_size=2)
        assert enh.add_to_batch("x") is None
        assert enh.add_to_batch("y") == [{"subject": "a", "predicate": "b",
                                          "object": "c"}]


def test_knowledge_command_lets_a_device_error_through(tmp_path,
                                                       openclaw_home):
    config = {"embeddings": {"backend": "none"}}
    gw, plugin, _ = knowledge_gateway(PORT, tmp_path / "port", config,
                                      FakeClock(START))
    plugin.fact_store.query = _Boom(DeviceError("search launch failed"))
    with pytest.raises(DeviceError):
        gw.command("/knowledge", args="alice")
    plugin.fact_store.query = _Boom(RuntimeError("index torn"))
    assert gw.command("/knowledge", args="alice") == \
        {"text": "command /knowledge failed: index torn"}
    jgw, jplugin, _ = knowledge_gateway(JAX, tmp_path / "jax", config,
                                        FakeClock(START))
    jplugin.fact_store.query = _Boom(DeviceError("search launch failed"))
    assert jgw.command("/knowledge", args="alice") == \
        {"text": "command /knowledge failed: search launch failed"}


def test_stop_raises_a_service_s_device_error_after_closing_journals(
        tmp_path, openclaw_home):
    gw, plugin, log = knowledge_gateway(PORT, tmp_path, {
        "embeddings": {"backend": "none"}}, FakeClock(START))
    journal = plugin.journal
    calls = []

    def shutdown():  # the gateway_stop hook's call passes, the service's fails
        calls.append(1)
        if len(calls) == 2:
            raise DeviceError("flush launch failed")

    plugin._shutdown = shutdown
    with pytest.raises(DeviceError, match="flush launch failed"):
        gw.stop()
    assert len(calls) == 2
    assert journal._closed
    assert any("failed to stop" in line for line in log.messages())


def test_local_backend_needs_the_card_unless_told(tmp_path, openclaw_home,
                                                  monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    clock = FakeClock(START)
    gw = port_core.Gateway(config={"workspace": str(tmp_path)}, clock=clock)
    with pytest.raises(DeviceError, match="device='cpu'"):
        gw.load(KnowledgeEnginePlugin(workspace=str(tmp_path), clock=clock,
                                      wall_timers=False), plugin_config={})
    for backend in ("chroma", "none"):
        gw = port_core.Gateway(config={"workspace": str(tmp_path)},
                               clock=clock)
        plugin = KnowledgeEnginePlugin(workspace=str(tmp_path), clock=clock,
                                       wall_timers=False)
        gw.load(plugin, plugin_config={"embeddings": {"backend": backend}})
        assert (plugin.embeddings is None) == (backend == "none")
        gw.stop()
    jgw = jax_core.Gateway(config={"workspace": str(tmp_path)}, clock=clock)
    jgw.load(JaxKnowledge(workspace=str(tmp_path), clock=clock,
                          wall_timers=False), plugin_config={})
    jgw.stop()
