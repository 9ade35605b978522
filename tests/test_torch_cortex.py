"""The port's cortex modules against the JAX package's, below the plugin.

``MergedPatterns`` on ``tests/test_cortex_perf_equiv.py``'s ``CONFIGS`` ×
300 seeded multilingual messages: the port's interpreter path
(``extract_signals_interp``, ``detect_mood_interp``) equals JAX's on every
message, and the port's compiled path equals JAX's on every message
without a fold-unsafe character. Then the three trackers on seeded
interleaved sequences (one virtual clock, the id RNG seeded alike), with
the journal off and on: ``threads.json``, ``decisions.json`` and
``commitments.json`` byte-equal. Then ``cortex/storage.py``, boot context,
narrative and pre-compaction over those files, the five agent tools, and
``LlmEnhancer`` on a scripted ``call_llm``.

The deviation, beside the JAX behaviour it departs from: the port builds
its fold-unsafe guard from ``re._casefix._EXTRA_CASES`` where Python has no
``re._compiler._equivalences`` (3.12 on), so its compiled path equals its
interpreter path, and JAX's interpreter path, on all 2,100 messages; JAX's
compiled path drops the decision in "we decıded to go" there.
"""

from __future__ import annotations

import dataclasses
import random

import pytest

from helpers import FakeClock
from test_cortex_perf_equiv import CONFIGS, WORDS, random_message
from vainplex_openclaw_tpu.core import api as jax_api
from vainplex_openclaw_tpu.cortex import boot_context as jax_boot
from vainplex_openclaw_tpu.cortex import commitment_tracker as jax_ct
from vainplex_openclaw_tpu.cortex import decision_tracker as jax_dt
from vainplex_openclaw_tpu.cortex import llm_enhance as jax_llm
from vainplex_openclaw_tpu.cortex import narrative as jax_narr
from vainplex_openclaw_tpu.cortex import patterns as jax_pat
from vainplex_openclaw_tpu.cortex import pre_compaction as jax_pre
from vainplex_openclaw_tpu.cortex import storage as jax_store
from vainplex_openclaw_tpu.cortex import thread_tracker as jax_tt
from vainplex_openclaw_tpu.cortex import tools as jax_tools
from vainplex_openclaw_tpu.storage import journal as jax_journal
from vainplex_openclaw_tpu.utils import ids as jax_ids
from vainplex_openclaw_tpu_torch.core import api as port_api
from vainplex_openclaw_tpu_torch.cortex import boot_context as port_boot
from vainplex_openclaw_tpu_torch.cortex import commitment_tracker as port_ct
from vainplex_openclaw_tpu_torch.cortex import decision_tracker as port_dt
from vainplex_openclaw_tpu_torch.cortex import llm_enhance as port_llm
from vainplex_openclaw_tpu_torch.cortex import narrative as port_narr
from vainplex_openclaw_tpu_torch.cortex import patterns as port_pat
from vainplex_openclaw_tpu_torch.cortex import pre_compaction as port_pre
from vainplex_openclaw_tpu_torch.cortex import storage as port_store
from vainplex_openclaw_tpu_torch.cortex import thread_tracker as port_tt
from vainplex_openclaw_tpu_torch.cortex import tools as port_tools
from vainplex_openclaw_tpu_torch.device import DeviceError
from vainplex_openclaw_tpu_torch.storage import journal as port_journal
from vainplex_openclaw_tpu_torch.utils import ids as port_ids

PORT = dict(api=port_api, pat=port_pat, tt=port_tt, dt=port_dt, ct=port_ct,
            boot=port_boot, narr=port_narr, pre=port_pre, store=port_store,
            tools=port_tools, llm=port_llm, ids=port_ids,
            journal=port_journal)
JAX = dict(api=jax_api, pat=jax_pat, tt=jax_tt, dt=jax_dt, ct=jax_ct,
           boot=jax_boot, narr=jax_narr, pre=jax_pre, store=jax_store,
           tools=jax_tools, llm=jax_llm, ids=jax_ids, journal=jax_journal)
REBOOT_FILES = ("threads.json", "decisions.json", "commitments.json",
                "hot-snapshot.md", "narrative.md", "BOOTSTRAP.md")
# "we decıded to go" (dotless ı): the en decision regex matches it under
# IGNORECASE, "decided" is no substring of its lowercase
DOTLESS = "we decıded to go"


def patterns(pkg, languages, custom, compiled):
    return pkg["pat"].MergedPatterns(
        pkg["pat"].resolve_language_codes(languages), custom,
        logger=pkg["api"].list_logger(), compiled=compiled)


def messages(languages, custom) -> list:
    rng = random.Random(f"extract:{languages}:{custom}")
    return [random_message(rng) for _ in range(300)]


def signals(pkg, text, pats) -> tuple:
    s = (pkg["tt"].extract_signals(text, pats) if pats.compiled
         else pkg["tt"].extract_signals_interp(text, pats))
    mood = pats.detect_mood(text) if pats.compiled \
        else pats.detect_mood_interp(text)
    return (s.decisions, s.closures, s.waits, s.topics, mood)


# ── MergedPatterns ───────────────────────────────────────────────────


def test_packs_and_tables_are_jax_s():
    assert port_pat.MOODS == jax_pat.MOODS
    assert port_pat.BUILTIN_LANGUAGES == jax_pat.BUILTIN_LANGUAGES
    assert port_pat.BASE_MOODS == jax_pat.BASE_MOODS
    assert {k: dataclasses.asdict(v) for k, v in port_pat.PACKS.items()} == \
        {k: dataclasses.asdict(v) for k, v in jax_pat.PACKS.items()}
    for sel in (None, "both", "all", "fr", ["zh", "xx", "ko"]):
        assert port_pat.resolve_language_codes(sel) == \
            jax_pat.resolve_language_codes(sel)
    assert [p.pattern for p in port_ct.COMMITMENT_PATTERNS] == \
        [p.pattern for p in jax_ct.COMMITMENT_PATTERNS]
    assert port_dt._WHY_RE.pattern == jax_dt._WHY_RE.pattern
    assert port_llm.SYSTEM_PROMPT == jax_llm.SYSTEM_PROMPT
    assert port_boot.DEFAULT_BOOT_CONFIG == jax_boot.DEFAULT_BOOT_CONFIG


@pytest.mark.parametrize("languages,custom", CONFIGS)
def test_merged_patterns_match_jax(languages, custom):
    """Interpreter = JAX's interpreter on every message; compiled = JAX's
    compiled on every message without a fold-unsafe character (where the
    two guards agree); the merged tables and the ReDoS report equal."""
    ports = {c: patterns(PORT, languages, custom, c) for c in (True, False)}
    theirs = {c: patterns(JAX, languages, custom, c) for c in (True, False)}
    p, j = ports[True], theirs[True]
    assert p.codes == j.codes and p.unsafe == j.unsafe
    assert p.topic_blacklist == j.topic_blacklist
    assert (p.high_impact, p.noise_prefixes) == (j.high_impact,
                                                 j.noise_prefixes)
    safe = 0
    for text in messages(languages, custom):
        assert signals(PORT, text, ports[False]) == \
            signals(JAX, text, theirs[False]), text
        if port_pat.fold_lower(text) is not None:
            safe += 1
            assert signals(PORT, text, ports[True]) == \
                signals(JAX, text, theirs[True]), text
            assert p.infer_priority(text) == j.infer_priority(text)
    assert safe > 200


@pytest.mark.parametrize("languages,custom", CONFIGS)
def test_compiled_equals_interpreter_on_every_message(languages, custom):
    """The deviation: the port's compiled path equals its interpreter path
    and JAX's interpreter path on all 300 messages of the config, where
    JAX's own compiled path may not (``tests/test_cortex_perf_equiv.py``
    fails on it under Python 3.12)."""
    compiled = patterns(PORT, languages, custom, True)
    interp = patterns(PORT, languages, custom, False)
    oracle = patterns(JAX, languages, custom, False)
    for text in messages(languages, custom):
        want = signals(JAX, text, oracle)
        assert signals(PORT, text, compiled) == want, text
        assert signals(PORT, text, interp) == want, text


def test_jax_s_compiled_path_drops_a_match_the_port_keeps():
    """On a Python without ``re._compiler._equivalences`` JAX's guard holds
    only İ and Σ: its compiled path finds no decision in "we decıded to go"
    while its interpreter path does. The port's guard holds the dotless ı,
    so the port's compiled path takes the walk and finds it."""
    from re import _compiler

    p_comp = patterns(PORT, "all", None, True)
    j_comp = patterns(JAX, "all", None, True)
    j_interp = patterns(JAX, "all", None, False)
    want = signals(JAX, DOTLESS, j_interp)
    assert want[0]  # the interpreter finds the decision
    assert signals(PORT, DOTLESS, p_comp) == want
    assert port_pat.fold_lower(DOTLESS) is None
    if getattr(_compiler, "_equivalences", None):  # Python <= 3.11
        assert signals(JAX, DOTLESS, j_comp) == want
    else:
        assert signals(JAX, DOTLESS, j_comp)[0] == []
        assert jax_pat.fold_lower(DOTLESS) is not None


def test_the_deviation_counted_over_every_config():
    """Over ``CONFIGS`` × 300 messages (2,100): where Python has no
    ``re._compiler._equivalences`` JAX's compiled path differs from its
    interpreter path on some messages (31 on Python 3.12), the port's on
    none."""
    import sys
    from re import _compiler

    jax_off = port_off = 0
    for languages, custom in CONFIGS:
        pats = {(pkg is PORT, c): patterns(pkg, languages, custom, c)
                for pkg in (PORT, JAX) for c in (True, False)}
        for text in messages(languages, custom):
            want = signals(JAX, text, pats[False, False])
            jax_off += signals(JAX, text, pats[False, True]) != want
            port_off += signals(PORT, text, pats[True, True]) != want
    assert port_off == 0
    if getattr(_compiler, "_equivalences", None):
        assert jax_off == 0
    elif sys.version_info[:2] == (3, 12):
        assert jax_off == 31
    else:
        assert jax_off > 0


def test_fold_guard_keeps_one_unguarded_member_per_class():
    """Every sre case-equivalence class (from whichever table this Python
    has) keeps at most one member unguarded, the smallest; the rest, and
    the full-casing İ and Σ, bypass the screens."""
    classes = port_pat.equivalence_classes()
    assert classes  # 3.12 keeps re._casefix
    assert (0x69, 0x131) in classes and (0x73, 0x17F) in classes
    for cls in classes:
        unguarded = [c for c in cls if not port_pat._fold_unsafe(chr(c))]
        assert unguarded == [cls[0]], cls
    assert port_pat._fold_unsafe("İ") and port_pat._fold_unsafe("Σ")


# ── the trackers ─────────────────────────────────────────────────────


def tracker_sequence(pkg, ws, pats, seed: int, journal: bool) -> list:
    """``test_cortex_perf_equiv.run_tracker_sequence`` for either package,
    the journal off or on; returns the three files' bytes."""
    pkg["ids"]._ID_RNG.seed(seed)
    clock = FakeClock(1_700_000_000.0)
    rng = random.Random(seed)
    log = pkg["api"].list_logger()
    js = pkg["journal"].journal_settings({"storage": {"journal": True}})
    j = (pkg["journal"].get_journal(str(ws), js, clock=clock,
                                    wall=False, logger=log)
         if journal else None)
    tt = pkg["tt"].ThreadTracker(ws, {"pruneDays": 2, "maxThreads": 7}, pats,
                                 log, clock, journal=j)
    dt = pkg["dt"].DecisionTracker(ws, {"dedupeWindowHours": 1}, pats, log,
                                   clock, journal=j)
    ct = pkg["ct"].CommitmentTracker(ws, {"overdueDays": 1}, log, clock,
                                     wall_timers=False, journal=j)
    for _ in range(rng.randrange(3, 9)):
        msg = random_message(rng)
        sender = rng.choice(["user", "agent"])
        tt.process_message(msg, sender)
        dt.process_message(msg, sender)
        ct.process_message(msg, sender)
        if rng.random() < 0.35:
            clock.advance(rng.choice([1, 60, 3600, 90_000, 260_000]))
        if rng.random() < 0.2:
            tt.apply_llm_analysis({
                "threads": [{"title": " ".join(rng.choice(WORDS)
                                               for _ in range(3)),
                             "status": "open", "summary": "llm"}],
                "closures": [random_message(rng)],
                "mood": rng.choice(["neutral", "excited", "tense"])})
            dt.add_llm_decisions([random_message(rng)])
        if rng.random() < 0.2 and ct.commitments:
            ct.resolve(rng.choice(ct.commitments)["id"])
    assert tt.flush() and dt.flush() and ct.flush()
    out = [(ws / "memory" / "reboot" / name).read_bytes()
           if (ws / "memory" / "reboot" / name).exists() else b""
           for name in REBOOT_FILES[:3]]
    out.append((tt.counts(), len(dt.recent(30, 100)),
                len(ct.open_commitments())))
    return out


@pytest.mark.parametrize("journal", [False, True], ids=["legacy", "journal"])
@pytest.mark.parametrize("languages,custom", CONFIGS[:1] + CONFIGS[4:6])
def test_trackers_write_jax_s_files(tmp_path, languages, custom, journal):
    """The port's trackers, compiled and interpreted, against JAX's
    interpreted ones (JAX's compiled path is the one at fault on 3.12)."""
    want_pats = patterns(JAX, languages, custom, False)
    try:
        for seed in range(8):
            want = tracker_sequence(JAX, tmp_path / f"j{seed}", want_pats,
                                    seed, journal)
            for compiled in (True, False):
                got = tracker_sequence(
                    PORT, tmp_path / f"p{seed}{int(compiled)}",
                    patterns(PORT, languages, custom, compiled), seed,
                    journal)
                assert got == want, (seed, compiled)
            assert want[0]
    finally:
        jax_journal.reset_journals()
        port_journal.reset_journals()


# ── storage, boot context, narrative, pre-compaction, tools ──────────


def files(ws) -> dict:
    rd = ws / "memory" / "reboot"
    return {name: (rd / name).read_bytes() for name in REBOOT_FILES
            if (rd / name).exists()}


def cortex_outputs(pkg, ws, seed: int) -> dict:
    pats = patterns(pkg, "all", None, True)
    tracker_sequence(pkg, ws, pats, seed, journal=False)
    clock = FakeClock(1_700_000_000.0 + 3600)
    log = pkg["api"].list_logger()
    out = {"iso": pkg["store"].iso_now(clock),
           "load_missing": pkg["store"].load_json(ws / "none.json"),
           "text_missing": pkg["store"].load_text(ws / "none.md"),
           "ensure": pkg["store"].ensure_reboot_dir(ws, log)}
    tt = pkg["tt"].ThreadTracker(ws, {}, pats, log, clock)
    dt = pkg["dt"].DecisionTracker(ws, {}, pats, log, clock)
    ct = pkg["ct"].CommitmentTracker(ws, {}, log, clock, wall_timers=False)
    cfg = {"preCompaction": {"maxSnapshotMessages": 3},
           "narrative": {"enabled": True},
           "bootContext": {"maxChars": 900, "decisionDays": 30}}
    pre = pkg["pre"].PreCompaction(ws, cfg, log, tt, dt, ct, clock)
    res = pre.run([{"role": "user", "content": "x" * 250},
                   {"role": "agent", "content": "we decided to ship"},
                   {"content": "no role"}, {"role": "user", "content": ""}])
    out["pre"] = (res.messages_snapshotted, res.warnings)
    out["narrative"] = pkg["narr"].NarrativeGenerator(ws, log, clock).generate()
    boot = pkg["boot"].BootContextGenerator(ws, {"decisionDays": 30}, log,
                                            clock)
    out["boot"] = (boot.generate(), boot.open_threads(),
                   boot.integrity_warning())
    out["stale"] = pkg["boot"].BootContextGenerator(
        ws, {}, log, lambda: clock() + 9 * 3600).integrity_warning()
    out["modes"] = [pkg["boot"].get_execution_mode(h) for h in range(24)]
    tools = {}
    api = type("Api", (), {"register_tool": lambda self, t: tools.update(
        {t["name"]: t}), "logger": log})()
    pkg["tools"].register_cortex_tools(api, lambda params: str(ws))
    out["tools"] = {name: tools[name]["handler"](params) for name, params in (
        ("cortex_threads", {"status": "all"}), ("cortex_threads", {}),
        ("cortex_decisions", {"limit": 3}), ("cortex_commitments", {}),
        ("cortex_commitments", {"status": "all"}),
        ("cortex_search", {"query": "the"}), ("cortex_search", {}),
        ("cortex_status", {}))}
    out["log"] = log.records
    out["files"] = files(ws)
    return out


@pytest.mark.parametrize("seed", [3, 5])
def test_storage_boot_narrative_pre_compaction_and_tools_equal_jax(
        tmp_path, seed):
    got = cortex_outputs(PORT, tmp_path / "port", seed)
    want = cortex_outputs(JAX, tmp_path / "jax", seed)
    for key in want:
        assert got[key] == want[key], key
    assert {"threads.json", "hot-snapshot.md", "narrative.md",
            "BOOTSTRAP.md"} <= set(want["files"])
    assert "Hot snapshot" in want["boot"][0]


def test_new_id_is_the_seeded_stream():
    port_ids._ID_RNG.seed(5)
    jax_ids._ID_RNG.seed(5)
    assert [port_store.new_id() for _ in range(4)] == \
        [jax_store.new_id() for _ in range(4)]


# ── the enhancer ─────────────────────────────────────────────────────

REPLIES = (
    '{"threads": [{"title": "database migration", "status": "open", '
    '"summary": "s"}], "decisions": ["use pg"], "closures": [], '
    '"mood": "productive"}',
    'Sure:\n```json\n{"threads": [{"title": ""}, 3], "decisions": [1, "x"],'
    ' "closures": ["done"]}\n```',
    "no json here at all",
    RuntimeError("the endpoint is down"),
    '{"mood": "tense"} trailing prose',
)


def enhancer_run(pkg, replies) -> tuple:
    replies = list(replies)
    prompts = []

    def call_llm(prompt):
        prompts.append(prompt)
        reply = replies.pop(0)
        if isinstance(reply, Exception):
            raise reply
        return reply

    log = pkg["api"].list_logger()
    enh = pkg["llm"].LlmEnhancer(call_llm, log, batch_size=2)
    out = []
    for i in range(2 * len(REPLIES)):
        out.append(enh.add_message(f"message {i} " + "z" * (i * 500),
                                   ("user", "agent")[i % 2]))
    out.append(enh.flush())
    return out, prompts, log.records


def test_enhancer_on_a_scripted_call_llm_equals_jax():
    got, want = enhancer_run(PORT, REPLIES), enhancer_run(JAX, REPLIES)
    assert got == want
    analyses = [a for a in want[0] if a]
    assert analyses and any(a["decisions"] == ["use pg"] for a in analyses)
    assert any("regex-only fallback" in m for _, m in want[2])


def test_a_device_error_leaves_the_enhancer():
    """The deviation: where JAX logs a failed ``call_llm`` and falls back
    to regex, the port's enhancer re-raises an error of the device."""
    replies = (DeviceError("no CUDA device"),)
    with pytest.raises(DeviceError):
        enhancer_run(PORT, replies)
    out, _, log = enhancer_run(JAX, replies)
    assert out[1] is None
    assert any("regex-only fallback" in m for _, m in log)
