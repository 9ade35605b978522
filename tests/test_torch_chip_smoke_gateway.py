"""``chip_smoke.py``'s gateway phase, its legs run here on the CPU at a
small size: the serial and concurrent legs through the port's
``Gateway`` and ``GovernancePlugin`` against the one-shot oracle (the
CPU's plain attention counts no launches, so the kernel's count is the
card's check), the audit read-back, and the policy leg. The phase itself
runs on the card."""

from __future__ import annotations

import pytest

# the bounds module puts the repository root on the path for chip_smoke
from test_torch_chip_smoke_bounds import one_torch_thread  # noqa: F401

import chip_smoke  # noqa: E402
from vainplex_openclaw_tpu_torch.storage import journal as port_journal


def test_gateway_texts_are_distinct_and_carry_contradictions():
    texts = chip_smoke.gateway_texts(chip_smoke.GATEWAY_TEXTS, seed=17)
    assert len(set(texts)) == chip_smoke.GATEWAY_TEXTS
    stopped = [t for t in texts if " is stopped after " in t]
    assert len(stopped) == chip_smoke.GATEWAY_TEXTS // \
        chip_smoke.CONTRADICT_EVERY
    subjects = {f["subject"] for f in chip_smoke.GATEWAY_FACTS}
    assert {t.split(" is stopped")[0] for t in stopped} == subjects
    assert texts == chip_smoke.gateway_texts(chip_smoke.GATEWAY_TEXTS, 17)


def test_gateway_legs_on_the_cpu(tmp_path, openclaw_home, one_torch_thread):
    texts = chip_smoke.gateway_texts(48, seed=17)
    try:
        rec = chip_smoke.gateway_legs("cpu", texts, 4, str(tmp_path))
    finally:
        port_journal.reset_journals()
    serial, conc = rec["serial"], rec["concurrent"]
    assert serial["decisions"] == conc["decisions"]
    assert serial["batches"] == len(texts) and serial["audited"] == 48
    assert conc["batches"] < len(texts)  # buckets above 1 formed
    assert serial["evaluations"] == 48
    assert 0 < rec["blocked"] < 48 and rec["stage3_blocked"] > 0
    assert any(d[2] and "Contradiction" in d[2]
               for d in serial["decisions"])


def test_audit_check_fails_on_a_missing_record(tmp_path, openclaw_home):
    texts = chip_smoke.gateway_texts(8, seed=3)
    gw, _ = chip_smoke.governance_gateway(
        str(tmp_path), "cpu", {"continuousBatching": False})
    for text in texts[:-1]:
        gw.message_sending(text, dict(chip_smoke.GATEWAY_META))
    gw.stop()
    port_journal.reset_journals()
    with pytest.raises(chip_smoke.SmokeFailure, match="7 audit records"):
        chip_smoke.check_audit(str(tmp_path), texts, "leg")


def test_policy_leg_reaches_the_rate_limiter(tmp_path, openclaw_home):
    import bench

    assert chip_smoke.bench_user_policies() == bench._bench_user_policies()
    try:
        rec = chip_smoke.policy_leg(str(tmp_path), 200)
    finally:
        port_journal.reset_journals()
    assert rec["evaluations"] == rec["audited"] == 201
    assert rec["decisions"]["Rate limit exceeded"] > 0
    assert rec["policy_count"] == 10 + 3  # bench's ten and three builtins
    assert set(rec["stage_ms"]) == {"enrich", "frequency", "risk",
                                    "evaluate", "trust", "audit"}
