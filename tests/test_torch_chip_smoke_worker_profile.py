"""``chip_smoke.py``'s worker_profile phase, its legs run here on the CPU
at a small size: the port's worker gateway (redaction, the credential
guard, stage 3 local, cortex with journal, lifecycle and its trace
analyzer) once with continuous batching and once with the one-shot path,
each on its own root, and the phase's checks between them. The CPU's
plain attention counts no launches, so the kernels' counts are the card's
check. A control plants a secret where no redaction runs, and the leak
check must catch it."""

from __future__ import annotations

import pytest

# the bounds module puts the repository root on the path for chip_smoke
from test_torch_chip_smoke_bounds import one_torch_thread  # noqa: F401

import chip_smoke  # noqa: E402
from vainplex_openclaw_tpu_torch.models import serve

N_OPS = 80


@pytest.fixture(scope="module")
def raws():
    """One doom loop and ten bench chains: every stage of the analyzer,
    K3's detector and local triage included, at a CPU-sized corpus."""
    return chip_smoke.trace_corpus(0, 10, 0, 1, chip_smoke.TRACE_BASE_TS,
                                   chip_smoke.TRACE_SEED)


def test_worker_ops_are_seeded_and_carry_every_kind():
    script = chip_smoke.worker_ops(chip_smoke.WORKER_OPS,
                                   chip_smoke.WORKER_SEED)
    assert script == chip_smoke.worker_ops(chip_smoke.WORKER_OPS,
                                           chip_smoke.WORKER_SEED)
    ops = script["ops"]
    kinds = {op["kind"] for op in ops}
    assert kinds == {k for k, _ in chip_smoke.WORKER_KIND_CDF}
    assert {op["tenant"] for op in ops} == set(range(
        chip_smoke.WORKER_TENANTS))
    for op in ops:
        if op["kind"] == "tool_vault":
            assert ops[op["ref"]]["kind"] == "tool_secret"
    secrets = script["secrets"]
    assert len(set(secrets)) == len(secrets)
    assert any(s.startswith("sk-") for s in secrets)
    assert any(s.startswith("ghp_") for s in secrets)
    assert any(s.endswith("@example.org") for s in secrets)
    assert any(s.startswith("DE") and s[2:].isdigit() for s in secrets)
    assert any(" is stopped after " in op.get("content", "") for op in ops)


def test_worker_legs_on_the_cpu(tmp_path, openclaw_home, raws,
                                one_torch_thread):
    script = chip_smoke.worker_ops(N_OPS, chip_smoke.WORKER_SEED)
    try:
        legs = chip_smoke.worker_legs("cpu", script, str(tmp_path), raws)
    finally:
        serve.close_batchers()
    checks = legs["checks"]
    assert 0 < checks["blocked"] < checks["sends"]
    assert checks["stage3_blocked"] > 0 and checks["redacted"] > 0
    assert checks["vault_calls"] > 0
    assert checks["lifecycle"]["evictions"] > 0
    assert checks["lifecycle"]["wakes"] > 0
    card = legs["runs"]["card"]
    assert card["batches"] > 0 and card["launches"] is None
    assert card["files"]["report"]["findings"]
    assert card["evaluations"] == checks["audit_records"] > 0


def test_a_planted_secret_fails_the_leak_check(tmp_path, openclaw_home,
                                               raws, one_torch_thread):
    """A secret in a received message reaches the cortex files unredacted
    (redaction scans outbound text and tool results only): the phase's
    leak check must name it."""
    script = chip_smoke.worker_ops(N_OPS, chip_smoke.WORKER_SEED)
    planted = "sk-" + "Q" * 24
    i = next(i for i, op in enumerate(script["ops"])
             if op["kind"] == "msg_in")
    script["ops"][i] = dict(script["ops"][i], content=(
        "we decided to rotate the key " + planted))
    script["secrets"].append(planted)
    try:
        with pytest.raises(chip_smoke.SmokeFailure,
                           match="seeded secrets leaked"):
            chip_smoke.worker_legs("cpu", script, str(tmp_path), raws)
    finally:
        serve.close_batchers()
    run = chip_smoke.worker_run("cpu", script, str(tmp_path / "again"), raws,
                                {"continuousBatching": False})
    leaks = chip_smoke.worker_leaks(script, run)
    assert {secret for secret, _ in leaks} == {planted}
    assert any("tenants" in where and "decisions.json" in where
               for _, where in leaks)


def test_status_text_drops_only_the_host_clock():
    text = ("🧠 cortex:\n  lifecycle: resident=3 hibernated=5 wakes=9 "
            "wakeP99=0.52ms\n  /r/tenants/t1: open=1 closed=0\n"
            "  /r/tenants/t1 stage ms: {'persist': 0.2}\n"
            "  /r/tenants/t1 stage p99 ms: {'persist': 0.1}")
    assert chip_smoke.worker_status_text(text, "/r") == (
        "🧠 cortex:\n  lifecycle: resident=3 hibernated=5 wakes=9 "
        "wakeP99=<ms>\n  <root>/tenants/t1: open=1 closed=0")
