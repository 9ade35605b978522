"""The port's event transports and JSONL storage against the JAX package's.

The same seeded events go through both packages' ``MemoryTransport`` and
``FileTransport``: published sequences, subject-filtered fetches,
``last_sequence``, counters and the bytes on disk must be equal. A torn
tail is recovered the same way, and one fault plan per package (the same
specs and seed) fires at the same sites and calls in both.
"""

from __future__ import annotations

import random

import pytest

from vainplex_openclaw_tpu.events import envelope as jax_envelope
from vainplex_openclaw_tpu.events import transport as jax_transport
from vainplex_openclaw_tpu.resilience import faults as jax_faults
from vainplex_openclaw_tpu.storage import atomic as jax_atomic
from vainplex_openclaw_tpu.storage import journal as jax_journal
from vainplex_openclaw_tpu_torch.events import envelope, transport
from vainplex_openclaw_tpu_torch.events.subjects import build_subject
from vainplex_openclaw_tpu_torch.resilience import faults
from vainplex_openclaw_tpu_torch.storage import atomic, journal

PORT = (envelope, transport, faults)
JAX = (jax_envelope, jax_transport, jax_faults)
T0 = 1_753_772_400.0
FILTERS = (">", "", "claw.*.message.in.received", "claw.agent1.>",
           "claw.*.*.*", "cluster.fleet.req")
TYPES = ("message.in.received", "tool.call.failed", "run.ended")


class Clock:
    def __init__(self):
        self.t = T0

    def __call__(self):
        return self.t


def seeded_events(env_mod, n: int, seed: int) -> list:
    """(subject, event) pairs, every field a function of the seed."""
    rng = random.Random(f"events:{seed}")
    out = []
    for i in range(n):
        agent = f"agent{rng.randrange(3)}"
        ctype = rng.choice(TYPES)
        payload = {"i": i, "text": "x" * rng.randrange(1, 40),
                   "tool_call_id": f"call-{i}"}
        ev = env_mod.build_envelope(
            ctype, payload, {"agent_id": agent, "session_key": f"s{i % 4}"},
            now_ms=(T0 + i * 0.25) * 1000.0)
        subject = ("cluster.fleet.req" if rng.random() < 0.2
                   else build_subject("claw", agent, ctype))
        out.append((subject, ev))
    return out


def fetched(t, **kw) -> list:
    return [e.to_dict() for e in t.fetch(**kw)]


def read_view(t) -> dict:
    view = {"last": t.last_sequence(), "count": t.event_count(),
            "stats": t.stats()}
    for f in FILTERS:
        view[f] = fetched(t, subject_filter=f)
        view[f + "@3"] = fetched(t, subject_filter=f, start_seq=3)
        view[f + "#2"] = fetched(t, subject_filter=f, start_seq=1, batch=2)
    return view


def test_subject_matching_equals_jax():
    subjects = ("a.b.c", "a.b", "a", "a.b.c.d", "x.b.c", "")
    patterns = ("a.*.c", "a.>", ">", "", "*.b.*", "a.b.c.d", "a.*", "*")
    for p in patterns:
        for s in subjects:
            assert transport._subject_matches(p, s) == \
                jax_transport._subject_matches(p, s), (p, s)


@pytest.mark.parametrize("retention", [{}, {"max_msgs": 7},
                                       {"max_age_s": 2.0}])
def test_memory_transport_equals_jax(retention):
    views = []
    for env_mod, tr_mod, _ in (PORT, JAX):
        clock = Clock()
        t = tr_mod.MemoryTransport(clock=clock, **retention)
        seqs = []
        for subject, ev in seeded_events(env_mod, 24, seed=1):
            clock.t += 0.25
            assert t.publish(subject, ev)
            seqs.append(ev.seq)
        views.append((seqs, read_view(t)))
    assert views[0] == views[1]
    assert views[0][0] == list(range(1, 25))
    if retention:
        assert views[0][1]["stats"]["dropped_retention"] > 0


def file_drive(env_mod, tr_mod, root, torn_tail: bytes = b"") -> dict:
    clock = Clock()
    t = tr_mod.FileTransport(root, clock=clock)
    events = seeded_events(env_mod, 18, seed=2)
    for subject, ev in events[:10]:
        t.publish(subject, ev)
    t.drain()
    day = root / atomic.daily_jsonl_name(T0)
    if torn_tail:
        with day.open("ab") as fh:
            fh.write(torn_tail)
    t2 = tr_mod.FileTransport(root, clock=clock)  # recovers its sequence
    for subject, ev in events[10:]:
        t2.publish(subject, ev)
    t2.drain()
    return {"view": read_view(t2), "bytes": day.read_bytes(),
            "recovered": t2.last_sequence()}


@pytest.mark.parametrize("torn", [b"", b'{"subject": "claw.agent0.run.en'])
def test_file_transport_equals_jax(tmp_path, torn):
    got = file_drive(envelope, transport, tmp_path / "port", torn)
    want = file_drive(jax_envelope, jax_transport, tmp_path / "jax", torn)
    assert got == want
    assert got["recovered"] == 18
    if torn:  # newline-isolated: one corrupt line, counted, never merged
        assert got["view"]["stats"]["corrupt_lines"] == 1
        assert torn + b"\n" in got["bytes"]


def journal_drive(env_mod, tr_mod, root) -> list:
    """Publishes through a group-commit journal (the JAX package's
    ``Journal``: the port has none yet), rolling the day twice; the read
    barrier compacts the wal into the day files."""
    clock = Clock()
    journal = jax_journal.Journal(root / "journal", {}, wall=False)
    try:
        t = tr_mod.FileTransport(root, clock=clock, journal=journal)
        for i, (subject, ev) in enumerate(seeded_events(env_mod, 30, 4)):
            assert t.publish(subject, ev)
            if i % 12 == 11:
                clock.t += 86_400.0
        assert len(list(t.fetch())) == 30
        t.drain()
    finally:
        journal.close()
        jax_journal.reset_journals()
    return [(p.name, p.read_bytes()) for p in sorted(root.glob("*.jsonl"))]


def test_file_transport_through_a_journal_equals_jax(tmp_path):
    got = journal_drive(envelope, transport, tmp_path / "port")
    assert got == journal_drive(jax_envelope, jax_transport, tmp_path / "jax")
    assert len(got) == 3


def fault_drive(env_mod, tr_mod, faults_mod, root) -> dict:
    plan = jax_faults.FaultPlan([
        # the memory ring takes calls 1-10 of the site, the file log 11-20
        jax_faults.FaultSpec("transport.publish", steps=(2, 12)),
        jax_faults.FaultSpec("transport.publish", steps=(14, 17),
                             mode="torn"),
        jax_faults.FaultSpec("transport.fetch", steps=(1,)),
    ], seed=5)
    clock = Clock()
    out = {}
    with faults_mod.installed(plan):
        mem = tr_mod.MemoryTransport(clock=clock)
        f = tr_mod.FileTransport(root, clock=clock)
        events = seeded_events(env_mod, 10, seed=3)
        out["memory"] = [mem.publish(s, e) for s, e in events]
        out["file"] = [f.publish(s, e) for s, e in
                       seeded_events(env_mod, 10, seed=3)]
        out["first_fetch"] = fetched(f)  # the fetch fault serves the index
        out["second_fetch"] = fetched(f)
    out["fired"] = dict(plan.fired)
    out["memory_stats"] = mem.stats()
    out["file_stats"] = f.stats()
    f.drain()
    out["bytes"] = (root / atomic.daily_jsonl_name(T0)).read_bytes()
    return out


def test_fault_sites_fire_where_jax_fires(tmp_path):
    got = fault_drive(envelope, transport, faults, tmp_path / "port")
    want = fault_drive(jax_envelope, jax_transport, jax_faults,
                       tmp_path / "jax")
    for key in got:
        assert got[key] == want[key], key
    assert got["fired"] == {"transport.publish": 4, "transport.fetch": 1}
    assert got["memory"].count(False) == 1 and got["file"].count(False) == 3
    assert got["first_fetch"] == [] and len(got["second_fetch"]) == 7
    assert got["file_stats"]["corrupt_lines"] == 2


def test_jsonl_helpers_equal_jax(tmp_path):
    recs = [{"i": i, "s": "é" * i, "p": tmp_path} for i in range(5)]
    plan = jax_faults.FaultPlan([jax_faults.FaultSpec(
        "file.append", steps=(2,), mode="torn")], seed=1)
    views = []
    for atomic_mod, faults_mod, name in ((atomic, faults, "port"),
                                         (jax_atomic, jax_faults, "jax")):
        path = tmp_path / name / "log.jsonl"
        atomic_mod.append_jsonl(path, recs[:2])
        fresh = jax_faults.FaultPlan(plan.specs, seed=plan.seed)
        with faults_mod.installed(fresh):
            with pytest.raises(OSError):
                for _ in range(2):
                    atomic_mod.append_jsonl(path, recs[2:4])
        before = atomic_mod.JsonlReadReport()
        first = list(atomic_mod.read_jsonl(path, before))
        repaired = atomic_mod.repair_torn_tail(path)
        atomic_mod.append_jsonl(path, recs[4:])
        after = atomic_mod.JsonlReadReport()
        views.append({"first": first, "before": vars(before),
                      "repaired": repaired,
                      "second": list(atomic_mod.read_jsonl(path, after)),
                      "after": vars(after), "bytes": path.read_bytes(),
                      "day": atomic_mod.daily_jsonl_name(T0)})
    assert views[0] == views[1]
    assert views[0]["before"]["torn_tail"] is not None
    assert views[0]["after"]["corrupt_lines"] == 1
    assert len(views[0]["second"]) == 5


def test_journal_tail_dedup_equals_jax(tmp_path):
    path = tmp_path / "day.jsonl"
    lines = [f'{{"seq":{i}}}' for i in range(6)]
    path.write_text("\n".join(lines[:4]) + "\n" + '{"seq":4', encoding="utf-8")
    batch = [(i, line, None) for i, line in enumerate(lines)]
    for max_bytes in (1 << 20, 20):
        assert journal.tail_lines(path, max_bytes) == \
            jax_journal.tail_lines(path, max_bytes)
    assert journal.dedup_against_tail(path, batch) == \
        jax_journal.dedup_against_tail(path, batch)
    assert journal.dedup_against_tail(tmp_path / "missing", batch) == \
        (batch, 0)


def test_no_silent_nats_degrade():
    """JAX's ``create_nats_transport`` returns None without the ``nats``
    package, and its callers fall back to a local transport; the port's
    raises, so no caller can degrade silently."""
    import vainplex_openclaw_tpu_torch.events as port_events

    assert jax_transport.create_nats_transport("nats://localhost:4222") \
        is None
    assert port_events.create_nats_transport is \
        transport.create_nats_transport
    with pytest.raises(ImportError, match="'nats' client package"):
        transport.create_nats_transport("nats://localhost:4222")
