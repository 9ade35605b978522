"""``chip_smoke.py``'s governance_install phase, its legs run here on the
CPU at a small size (16 serial and 32 threaded sends, 2 approval rounds):
the governance leg (stage 3 local, 2FA through a loopback homeserver,
ERC-8004 against a loopback chain) and the brainplex leg (the port's
``brainplex init``, then its five plugins loaded from the written files),
each run twice, held together by the phase's own checks. The CPU's plain
attention counts no launches, so the launch formulas are held with counts
put in their place, and each launch shape the phase's legs would make is
a case the kernels phase holds. Controls, each of which must fail a check:
a changed decision, a stage-3 verdict off the oracle, a changed approval
prompt, a lost on-chain context, a changed written file, a changed
command text, a search hit the CPU scores far below its own, K1 or K3
off by one, and a poller thread left running."""

from __future__ import annotations

import copy
import threading

import pytest

# the bounds module puts the repository root on the path for chip_smoke
from test_torch_chip_smoke_bounds import one_torch_thread  # noqa: F401

import chip_smoke  # noqa: E402
from vainplex_openclaw_tpu_torch.models.pretrained import TINY_CONFIG
from vainplex_openclaw_tpu_torch.ops.similarity import pow2_bucket

SMALL_GOV = {"serial": 16, "threaded": 32, "rounds": 2}
N_LAYERS = TINY_CONFIG.n_layers


@pytest.fixture(scope="module")
def legs(tmp_path_factory):
    root = tmp_path_factory.mktemp("install")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OPENCLAW_HOME", str(root / "home"))
        import torch

        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            out = chip_smoke.install_legs("cpu", str(root),
                                          chip_smoke.install_raws(),
                                          governance_kw=SMALL_GOV)
        finally:
            torch.set_num_threads(threads)
            from vainplex_openclaw_tpu_torch.models import serve

            serve.close_batchers()
    return out


def test_the_governance_leg_holds(legs):
    held = legs["held_governance"]
    card = legs["governance"]["card"]
    assert held["sends"] == SMALL_GOV["serial"] + SMALL_GOV["threaded"]
    assert 0 < held["blocked"] < held["sends"]
    assert held["stage3_verdicts"] == held["sends"]
    assert len(card["rounds"]) == SMALL_GOV["rounds"]
    assert all(not d[0] for r in card["rounds"] for row in r["decisions"]
               for d in row)
    assert card["refused"]["decision"] == [True, "2FA approval timed out"]
    assert card["refused"]["attempts"] == 1
    assert held["onchain"] == [
        "[governance] agent=forge trust=10 tier=untrusted onchain=45 "
        "(mixed, 3 reviews)",
        "[governance] agent=main trust=10 tier=untrusted onchain=85 "
        "(excellent, 12 reviews)",
        "[governance] agent=scout trust=10 tier=untrusted onchain=0 "
        "(unproven, 0 reviews)"]
    assert len(held["erc_uncached_ms"]) == len(held["erc_cached_ms"]) == 3
    assert card["launches"] is None and card["batches"] > 0
    counted = dict(card, launches={"k1": N_LAYERS * card["batches"]})
    chip_smoke.install_governance_check(counted, legs["governance"]["host"],
                                        legs["oracle"], N_LAYERS)


def test_the_brainplex_leg_holds(legs):
    held = legs["held_brainplex"]
    card = legs["brainplex"]["card"]
    assert held["written"] == [
        "openclaw.json", "openclaw.json.backup-<stamp>",
        "plugins/cortex/config.json", "plugins/eventstore/config.json",
        "plugins/governance/config.json",
        "plugins/knowledge-engine/config.json",
        "plugins/sitrep/config.json"]
    assert card["init_code"] == 0 and "nothing to do" in card["printed_again"]
    assert held["synced"] > 0 and held["findings"] > 0
    assert held["query_forwards"] > 0
    raws = chip_smoke.install_raws()
    counted = dict(card, launches={
        "k1": N_LAYERS * (len(card["forwards"]) + 1),
        "k3": len(chip_smoke.trace_k3_windows(raws))})
    chip_smoke.install_brainplex_check(counted, legs["brainplex"]["host"],
                                       N_LAYERS,
                                       chip_smoke.trace_k3_windows(raws))


def test_the_legs_launch_only_at_held_buckets(legs):
    """Serve sends at B <= 8, the sync of the brainplex leg, its queries
    at B=1 and its triage: each shape a kernels case holds."""
    card = legs["brainplex"]["card"]
    shapes = [chip_smoke.trace_k1_shape(TINY_CONFIG, b) for b in
              (1, 2, 3, 5, 8, card["synced"], card["findings"])]
    assert chip_smoke.trace_k1_unheld(shapes) == []
    assert pow2_bucket(card["synced"]) == \
        chip_smoke.INSTALL_SYNC_CASES[0][1]
    assert chip_smoke.INSTALL_SYNC_CASES[0] in chip_smoke.KERNEL_CASES
    assert chip_smoke.INSTALL_SYNC_CASES[0] not in \
        chip_smoke.served_cases((64,))


def _decision(card):
    text = sorted(card["decisions"])[0]
    blocked, content, reason = card["decisions"][text]
    card["decisions"][text] = (not blocked, content, reason)


def _verdict(card):
    prompt, verdict = card["served"][0]
    card["served"][0] = [prompt, verdict.replace('"', "'", 1) + " "]


def _prompt(card):
    card["rounds"][0]["prompt"] += "\n3. exec: command='rm -rf /'"


def _onchain(card):
    agent, k, ctx = card["contexts"][0]
    card["contexts"][0] = [agent, k, [ctx[0].split(" onchain=")[0]]]


def _k1_a(card):
    card["launches"] = {"k1": N_LAYERS * card["batches"] + 1}


GOV_CONTROLS = {"decision": (_decision, "decisions differ"),
                "verdict": (_verdict, "one-shot oracle"),
                "prompt": (_prompt, "2FA rounds differ"),
                "onchain": (_onchain, "contexts differ"),
                "K1 off by one": (_k1_a, "K1 launches")}


@pytest.mark.parametrize("control", sorted(GOV_CONTROLS))
def test_a_control_fails_the_governance_check(legs, control):
    card = copy.deepcopy(legs["governance"]["card"])
    spoil, message = GOV_CONTROLS[control]
    spoil(card)
    with pytest.raises(chip_smoke.SmokeFailure, match=message):
        chip_smoke.install_governance_check(
            card, legs["governance"]["host"], legs["oracle"], N_LAYERS)


def _written(card):
    card["written"]["plugins/governance/config.json"] += b"\n"


def _ops_text(card):
    card["ops_text"] += "\n  ✅ extra: 1 line"


def _far_hit(card):
    want = [s for s in card["searches"]][0]
    worst = min(want["scores"], key=want["scores"].get)
    want["hits"][0] = [worst, want["scores"][worst] + 0.5]


def _k1_b(card):
    card["launches"] = {"k1": N_LAYERS * (len(card["forwards"]) + 1) + 1,
                        "k3": 3}


def _k3_b(card):
    card["launches"] = {"k1": N_LAYERS * (len(card["forwards"]) + 1),
                        "k3": 4}


BP_CONTROLS = {"written file": (_written, "written files differ"),
               "ops text": (_ops_text, "ops_text differs"),
               "far hit": (_far_hit, "searches differ"),
               "K1 off by one": (_k1_b, "K1 launches"),
               "K3 off by one": (_k3_b, "K3 launches")}


@pytest.mark.parametrize("control", sorted(BP_CONTROLS))
def test_a_control_fails_the_brainplex_check(legs, control):
    card = copy.deepcopy(legs["brainplex"]["card"])
    spoil, message = BP_CONTROLS[control]
    spoil(card)
    with pytest.raises(chip_smoke.SmokeFailure, match=message):
        chip_smoke.install_brainplex_check(
            card, legs["brainplex"]["host"], N_LAYERS,
            chip_smoke.trace_k3_windows(chip_smoke.install_raws()))


def test_a_poller_left_running_is_named():
    before = {t.ident for t in threading.enumerate()}
    stop = threading.Event()
    t = threading.Thread(target=stop.wait, name="matrix-2fa-poller",
                         daemon=True)
    t.start()
    try:
        assert chip_smoke.install_threads_left(before) == [
            "matrix-2fa-poller"]
    finally:
        stop.set()
        t.join(5.0)
    assert chip_smoke.install_threads_left(before) == []


def test_the_loopback_homeserver_pages_forward():
    """``dir=b`` gives the newest token; ``dir=f`` from it sees only what
    came after, in order, and the PUT answers an event id."""
    import json
    from urllib.request import Request, urlopen

    hs = chip_smoke.LoopbackHomeserver()
    try:
        hs.post("old 111111", "@a:x")

        def get(query):
            with urlopen(f"{hs.url}/_matrix/client/v3/rooms/r/messages?"
                         f"{query}", timeout=10) as resp:
                return json.loads(resp.read())

        first = get("dir=b&limit=1")
        assert first["end"] == "s1" and len(first["chunk"]) == 1
        hs.post("new 222222", "@b:x")
        page = get(f"dir=f&from={first['end']}&limit=10")
        assert [e["content"]["body"] for e in page["chunk"]] == [
            "new 222222"] and page["end"] == "s2"
        req = Request(f"{hs.url}/_matrix/client/v3/rooms/r/send/"
                      "m.room.message/t1", data=b'{"body": "hi"}',
                      method="PUT")
        with urlopen(req, timeout=10) as resp:
            assert json.loads(resp.read()) == {"event_id": "$put1"}
        assert hs.sent[0]["body"] == "hi" and hs.gets == 2
    finally:
        hs.close()
    assert not hs.thread.is_alive()
