"""The port's cluster against the JAX package's: worker-kill storms,
heartbeat partitions and the fenced zombie write, real-process workers,
planned retirement, a file route log, watermark recovery and the sitrep
``/ops`` of an attached supervisor.

Every storm runs through both packages from one seed (180 ops over 8
tenants and 3 workers, JAX's chaos sizes) and returns JAX's duration-free
summary: per-op results, faults fired, failovers, membership, fenced
records, redelivered, route faults, leases and the tenants' tracker files
byte for byte after root normalisation. The two summaries must be equal.
The port's own ``LockOrderWitness`` watches each storm's locks (held
to JAX's witness in ``tests/test_torch_analysis_witness.py``); the port's
``ProtocolWitness`` records each storm, and JAX's reads the same events
the same way.

The other storm files of the port (``test_torch_cluster_handoff.py``,
``test_torch_cluster_fleet.py``) import the harness from here.
"""

from __future__ import annotations

import json
import types
from pathlib import Path

import pytest

from vainplex_openclaw_tpu.analysis import witness as jax_witness
from vainplex_openclaw_tpu.cluster import ring as jax_ring
from vainplex_openclaw_tpu.cluster import supervisor as jax_supervisor
from vainplex_openclaw_tpu.core import api as jax_api
from vainplex_openclaw_tpu.events import transport as jax_transport
from vainplex_openclaw_tpu.resilience import faults as jax_faults
from vainplex_openclaw_tpu.slo import workload as jax_workload
from vainplex_openclaw_tpu.storage import journal as jax_journal
from vainplex_openclaw_tpu_torch.analysis import witness
from vainplex_openclaw_tpu_torch.cluster import ring, supervisor
from vainplex_openclaw_tpu_torch.core import api
from vainplex_openclaw_tpu_torch.events import transport
from vainplex_openclaw_tpu_torch.resilience import faults
from vainplex_openclaw_tpu_torch.slo import workload
from vainplex_openclaw_tpu_torch.storage import journal


def _package(sup, rng, tr, flt, wl, jr, wit, capi) -> types.SimpleNamespace:
    return types.SimpleNamespace(
        ClusterSupervisor=sup.ClusterSupervisor, LeaseTable=rng.LeaseTable,
        HashRing=rng.HashRing, FENCE_FILE=rng.FENCE_FILE,
        MemoryTransport=tr.MemoryTransport, FileTransport=tr.FileTransport,
        FaultPlan=flt.FaultPlan, FaultSpec=flt.FaultSpec,
        installed=flt.installed, generate_workload=wl.generate_workload,
        Journal=jr.Journal, reset_journals=jr.reset_journals,
        ProtocolWitness=wit.ProtocolWitness, list_logger=capi.list_logger)


PORT = _package(supervisor, ring, transport, faults, workload, journal,
                witness, api)
JAX = _package(jax_supervisor, jax_ring, jax_transport, jax_faults,
               jax_workload, jax_journal, jax_witness, jax_api)

SEED = 0
BASE_T = 1_753_772_400.0
N_OPS = 180
TENANTS = 8
KILL_STEP = 90
# tick t probes (w0, w1, w2) in order, so w1's probes are the global
# heartbeat calls 3(t-1)+2; two lost in a row fail w1 over while it runs
PARTITION_STEPS = (3 * 39 + 2, 3 * 40 + 2)

# The worker's ack boundary is the journals' only commit trigger, so acked
# == committed == recovered, and redelivery covers exactly the ops a crash
# rolled back.
JOURNAL_CFG = {"maxBatchRecords": 1_000_000, "windowMs": 0.0}


class SetClock:
    def __init__(self, t: float = BASE_T):
        self.t = t

    def __call__(self) -> float:
        return self.t


def build_ops(pkg, seed: int, root: Path, n: int = N_OPS) -> list:
    return [{"i": op.index, "at": BASE_T + op.arrival,
             "ws": str(root / "tenants" / f"tenant{op.tenant}"),
             "wsKey": f"tenant{op.tenant}", "kind": op.kind,
             "content": op.content, "ids": f"{seed}:{op.index}"}
            for op in pkg.generate_workload(seed, n, TENANTS)]


def flush_cluster(sup) -> None:
    """Make every live worker's tenant files current (a tracker flush is a
    journal compaction per stream)."""
    sup.drain()
    for state in sup.workers().values():
        if not state.alive:
            continue
        for trackers in list(state.handle.cortex._trackers.values()):
            trackers.flush()


def tenant_state(root: Path) -> dict:
    """Root-normalized bytes of every tenant's tracker files."""
    out = {}
    for t in range(TENANTS):
        for name in ("threads.json", "decisions.json", "commitments.json"):
            path = (root / "tenants" / f"tenant{t}" / "memory" / "reboot"
                    / name)
            if path.exists():
                out[f"tenant{t}/{name}"] = path.read_bytes().replace(
                    str(root).encode(), b"ROOT")
    return out


def strip_timing(record: dict) -> dict:
    return {k: v for k, v in record.items()
            if k not in ("durationMs", "stagesMs", "at")}


def lock_witness(sup, extra=()):
    """The port's lock-order witness over the supervisor's locks (and the
    fleet's, given as ``extra``)."""
    w = witness.LockOrderWitness()
    w.wrap_attr(sup, "_lock", "ClusterSupervisor._lock")
    w.wrap_attr(sup.leases, "_lock", "LeaseTable._lock")
    if sup.leases.journal is not None:
        w.wrap_attr(sup.leases.journal, "_commit_lock",
                    "Journal._commit_lock")
        w.wrap_attr(sup.leases.journal, "_buffer_lock",
                    "Journal._buffer_lock")
    w.wrap_attr(sup.timer, "_lock", "ClusterSupervisor.timer._lock")
    for obj, name in extra:
        w.wrap_attr(obj, "_lock", name)
    return w


def summarize(sup, results: dict, plan, root: Path, n: int = N_OPS) -> dict:
    stats = sup.stats()
    return {
        "results": {i: results.get(i) for i in range(n)},
        "fired": dict(plan.fired),
        "failovers": [strip_timing(f) for f in stats["failovers"]],
        "handoffs": [strip_timing(h) for h in stats["handoffs"]],
        "handoffAborts": stats["handoffAborts"],
        "membership": stats["membership"],
        "fencedRecords": stats["fencedRecords"],
        "redelivered": stats["redelivered"],
        "routeFaults": stats["routeFaults"],
        "leases": {Path(ws).name: lease
                   for ws, lease in stats["leases"].items()},
        "state": tenant_state(root),
    }


def run_storm(pkg, root: Path, seed: int = SEED, kill_step=None,
              heartbeat_steps=(), handoff_steps=(), fault_specs=(),
              transport=None, config=None, n: int = N_OPS,
              on_step=None) -> dict:
    """One seeded storm through a 3-worker in-process cluster of ``pkg``:
    JAX's ``run_storm`` (with ``handoff_steps``, its ``run_handoff_storm``:
    at each listed op index the next leased workspace is handed to the
    least-loaded other worker; ``on_step(sup, i)`` runs after op ``i``'s
    tick). Returns the duration-free summary."""
    pkg.reset_journals()
    clock = SetClock()
    results: dict[int, dict] = {}
    cfg = {"workers": 3, "ackEveryOps": 6, "deterministicIds": True,
           "heartbeatMissLimit": 2}
    cfg.update(config or {})
    sup = pkg.ClusterSupervisor(
        root, cfg, clock=clock, wall_timers=False, settable_clock=clock,
        journal_cfg=JOURNAL_CFG, logger=pkg.list_logger(),
        transport=transport(clock) if transport else None,
        on_result=lambda op, obs: results.__setitem__(op.get("i"), obs))
    locks = lock_witness(sup)
    proto = pkg.ProtocolWitness()
    proto.arm_supervisor(sup)
    ops = build_ops(pkg, seed, root, n)
    specs = [pkg.FaultSpec("cluster.route", steps=(37,)),
             pkg.FaultSpec("journal.fsync", rate=0.05),
             pkg.FaultSpec("journal.append", rate=0.02, mode="torn"),
             *(pkg.FaultSpec(*a, **kw) for a, kw in fault_specs)]
    if kill_step is not None:
        specs.append(pkg.FaultSpec("cluster.worker.crash",
                                   steps=(kill_step,)))
    if heartbeat_steps:
        specs.append(pkg.FaultSpec("cluster.heartbeat",
                                   steps=heartbeat_steps))
    plan = pkg.FaultPlan(specs, seed=seed)
    handoff_at = set(handoff_steps)
    next_move = 0
    with pkg.installed(plan):
        for i, op in enumerate(ops):
            sup.submit(op)
            sup.tick()
            if i in handoff_at:
                leased = sorted(sup.leases.snapshot())
                if leased:
                    sup.handoff(leased[next_move % len(leased)],
                                reason=f"storm step {i}")
                    next_move += 1
            if on_step is not None:
                on_step(sup, i)
        flush_cluster(sup)
    summary = summarize(sup, results, plan, root, n)
    sup.stop()
    locks.assert_acyclic()
    check_protocol(proto)
    pkg.reset_journals()
    return summary


def check_protocol(proto) -> None:
    """The witness saw the storm, found it clean, and JAX's witness reads
    the same event sequence the same way. (Only one witness can arm an
    object: the second finds its methods already wrapped.)"""
    assert any(kind == "deliver" for kind, _ws, _info in proto.events)
    twin = jax_witness.ProtocolWitness()
    twin.events = list(proto.events)
    assert proto.violations() == twin.violations() == []


def both(tmp_path: Path, name: str, **kw) -> tuple:
    """The same storm through the port and through JAX, on sibling roots
    whose names differ only by package."""
    got = run_storm(PORT, tmp_path / "port" / name, **kw)
    want = run_storm(JAX, tmp_path / "jax" / name, **kw)
    return got, want


def verdict_check(summary: dict, ops: list, n: int = N_OPS) -> None:
    """JAX's verdict accounting: every op has a final observation, every
    denial blocks, every secret comes back redacted, nothing else
    blocks."""
    results = summary["results"]
    assert all(results[i] is not None for i in range(n))
    kinds = [op["kind"] for op in ops[:n]]
    denials = sum(1 for i, k in enumerate(kinds) if k == "tool_denied"
                  and results[i].get("blocked"))
    false_blocks = sum(1 for i, k in enumerate(kinds) if k == "tool_ok"
                       and results[i].get("blocked"))
    redactions = sum(1 for i, k in enumerate(kinds) if k == "tool_secret"
                     and results[i].get("redacted"))
    assert denials == kinds.count("tool_denied")
    assert redactions == kinds.count("tool_secret")
    assert false_blocks == 0


# ── the kill storm ──────────────────────────────────────────────────


def test_generate_workload_equals_jax():
    for seed in (0, 1, 17):
        for uniform in (False, True):
            got = workload.generate_workload(seed, 400, TENANTS, uniform)
            want = jax_workload.generate_workload(seed, 400, TENANTS,
                                                  uniform)
            assert [o.to_tuple() for o in got] == [o.to_tuple()
                                                   for o in want]


def test_kill_storm_equals_jax_and_converges_to_the_oracle(tmp_path):
    killed, want = both(tmp_path, "kill", kill_step=KILL_STEP)
    assert killed == want
    oracle = run_storm(PORT, tmp_path / "port" / "oracle")
    assert killed["fired"].get("cluster.worker.crash") == 1
    assert len(killed["failovers"]) == 1
    assert killed["failovers"][0]["workspacesMoved"] >= 1
    assert killed["membership"]["dead"] == [killed["failovers"][0]["worker"]]
    verdict_check(killed, build_ops(PORT, SEED, tmp_path))
    assert killed["fencedRecords"] == 0
    assert killed["state"] == oracle["state"]
    assert max(lease["epoch"] for lease in killed["leases"].values()) == 2
    assert all(lease["epoch"] == 1 for lease in oracle["leases"].values())


def test_kill_storm_is_bit_identical_per_seed(tmp_path):
    a = run_storm(PORT, tmp_path / "a", kill_step=KILL_STEP)
    b = run_storm(PORT, tmp_path / "b", kill_step=KILL_STEP)
    assert a == b
    assert sum(a["fired"].values()) > 0, "the storm was real"
    c = run_storm(PORT, tmp_path / "c", seed=SEED + 17, kill_step=KILL_STEP)
    assert a["fired"] != c["fired"] or a["results"] != c["results"]


def test_a_partial_ack_failure_applies_no_op_twice_where_jax_does(tmp_path):
    """A deviation the port makes on purpose. JAX's ``InProcessWorker._ack``
    acks nothing when any one journal's commit fails (here a torn
    ``journal.append``), even though the other workspaces' commits landed;
    a crash before the next boundary then replays those records from the
    wal AND redelivers their ops. In this storm (seed 31, 360 ops, w0
    crashed after op 147) JAX's tenant1 counts 43 events where the never
    crashed run counts 40. The port releases the seqs whose workspace
    committed and converges to the oracle byte for byte."""
    def kill(sup, i):
        if i == 147:
            sup.workers()["w0"].handle.crash()
            sup.failover("w0", reason="kill")

    runs = {}
    for name, pkg in (("port", PORT), ("jax", JAX)):
        oracle = run_storm(pkg, tmp_path / name / "oracle", seed=31, n=360)
        killed = run_storm(pkg, tmp_path / name / "kill", seed=31, n=360,
                           on_step=kill)
        verdict_check(killed, build_ops(pkg, 31, tmp_path, 360), 360)
        runs[name] = (oracle, killed)
    port_oracle, port_killed = runs["port"]
    jax_oracle, jax_killed = runs["jax"]
    assert port_oracle == jax_oracle
    assert port_killed["state"] == port_oracle["state"]
    assert port_killed["fired"] == jax_killed["fired"]
    differ = sorted(f for f in jax_oracle["state"]
                    if jax_killed["state"][f] != jax_oracle["state"][f])
    assert differ == ["tenant1/threads.json"]
    want = json.loads(jax_oracle["state"][differ[0]])
    got = json.loads(jax_killed["state"][differ[0]])
    assert want["integrity"]["events_processed"] == 40
    assert got["integrity"]["events_processed"] == 43
    assert {k: v for k, v in got.items() if k != "integrity"} == {
        k: v for k, v in want.items() if k != "integrity"}
    assert (port_killed["redelivered"], jax_killed["redelivered"]) == (2, 6)


# ── heartbeat partition and the zombie write ────────────────────────


def zombie_write(pkg, ws: Path, epoch: int) -> dict:
    """A journal still holding ``epoch`` (the partitioned worker's) writes
    after the move: returns what the boundary did with it."""
    before = {p.name: p.read_bytes()
              for p in (ws / "memory" / "reboot").glob("*.json")}
    zombie = pkg.Journal(ws / "journal", JOURNAL_CFG, wall=False)
    zombie.register_snapshot(
        "cortex:threads", ws / "memory" / "reboot" / "threads.json",
        indent=None)
    zombie.set_fence(ws / pkg.FENCE_FILE, epoch)
    zombie.append("cortex:threads", {"threads": ["ZOMBIE WRITE"]})
    out = {"committed": zombie.commit(),
           "fencedRecords": zombie.stats()["fencedRecords"],
           "compacted": zombie.compact()}
    zombie.close()
    after = {p.name: p.read_bytes()
             for p in (ws / "memory" / "reboot").glob("*.json")}
    out["untouched"] = after == before
    out["fence"] = pkg.LeaseTable.read_fence(ws)["epoch"]
    pkg.reset_journals()
    return out


def test_partition_storm_and_zombie_write_equal_jax(tmp_path):
    part, want = both(tmp_path, "part", heartbeat_steps=PARTITION_STEPS)
    assert part == want
    assert part["fired"].get("cluster.heartbeat") == 2
    assert [f["worker"] for f in part["failovers"]] == ["w1"]
    verdict_check(part, build_ops(PORT, SEED, tmp_path))
    oracle = run_storm(PORT, tmp_path / "port" / "oracle")
    assert part["state"] == oracle["state"]
    moved = sorted(name for name, lease in part["leases"].items()
                   if lease["epoch"] == 2)
    assert moved, "the partition failover moved a workspace"
    zombies = [zombie_write(pkg, tmp_path / key / "part" / "tenants" / moved[0],
                            1) for pkg, key in ((PORT, "port"), (JAX, "jax"))]
    assert zombies[0] == zombies[1] == {
        "committed": False, "fencedRecords": 1, "compacted": False,
        "untouched": True, "fence": 2}


# ── process workers ─────────────────────────────────────────────────


def process_round_trip(pkg, root: Path) -> dict:
    """JAX's round trip: 12 ops, a SIGKILL of one worker, 12 more."""
    results: dict[int, dict] = {}
    sup = pkg.ClusterSupervisor(
        root, {"workers": 2, "ackEveryOps": 4, "heartbeatDeadlineS": 5.0},
        worker_mode="process", journal_cfg={"fsync": "os"},
        on_result=lambda op, obs: results.__setitem__(op.get("i"), obs))
    ops = build_ops(pkg, SEED, root)[:24]
    try:
        for op in ops[:12]:
            sup.submit(op)
        sup.drain(timeout_s=60.0)
        first = dict(results)
        victim = sup.stats()["membership"]["live"][0]
        sup.workers()[victim].handle.kill()
        sup.tick()
        stats = sup.stats()
        for op in ops[12:]:
            sup.submit(op)
        sup.drain(timeout_s=60.0)
    finally:
        sup.stop()
    procs = [s.handle.proc for s in sup.workers().values()]
    return {"first": first, "results": dict(results),
            "dead": stats["membership"]["dead"] == [victim],
            "failovers": len(stats["failovers"]),
            "children_left": [p.name for p in procs if p.is_alive()]}


def test_process_workers_round_trip_kill_and_failover_equal_jax(
        tmp_path, monkeypatch):
    """The port's children start as on the card, with ``spawn``
    (``mp_context``'s rule once CUDA is initialised); JAX's by its own
    rule."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    got = process_round_trip(PORT, tmp_path / "port")
    monkeypatch.undo()
    want = process_round_trip(JAX, tmp_path / "jax")
    assert got == want
    assert len(got["first"]) == 12 and len(got["results"]) == 24
    assert got["dead"] and got["failovers"] == 1
    assert got["children_left"] == []


# ── planned retirement ──────────────────────────────────────────────


def retire_run(pkg, root: Path) -> dict:
    pkg.reset_journals()
    clock = SetClock()
    results: dict[int, dict] = {}
    sup = pkg.ClusterSupervisor(
        root, {"workers": 3, "ackEveryOps": 6, "deterministicIds": True},
        clock=clock, wall_timers=False, settable_clock=clock,
        journal_cfg=JOURNAL_CFG,
        on_result=lambda op, obs: results.__setitem__(op.get("i"), obs))
    ops = build_ops(pkg, SEED, root)
    for op in ops[:90]:
        sup.submit(op)
    victim = sup.stats()["membership"]["live"][0]
    owned = [Path(ws).name for ws in sup.leases.owned_by(victim)]
    out = sup.retire_worker(victim)
    stats = sup.stats()
    left = sup.leases.owned_by(victim)
    for op in ops[90:]:
        sup.submit(op)
    flush_cluster(sup)
    summary = {"victim": victim, "owned": owned, "retire": out,
               "membership": stats["membership"],
               "failovers": stats["failovers"],
               "handoffs": [strip_timing(h) for h in stats["handoffs"]],
               "left": left,
               "results": {i: results.get(i) for i in range(N_OPS)},
               "state": tenant_state(root)}
    sup.stop()
    pkg.reset_journals()
    return summary


def test_retire_worker_equals_jax(tmp_path):
    got = retire_run(PORT, tmp_path / "port")
    assert got == retire_run(JAX, tmp_path / "jax")
    assert got["retire"] == {"worker": got["victim"],
                             "moved": len(got["owned"]), "aborted": 0,
                             "retired": True}
    assert got["membership"]["retired"] == [got["victim"]]
    assert got["victim"] not in got["membership"]["dead"]
    assert got["failovers"] == [] and got["left"] == []
    assert all(h["replayedRecords"] == 0 and h["redelivered"] == 0
               for h in got["handoffs"])
    verdict_check(got, build_ops(PORT, SEED, tmp_path))


# ── route logs ──────────────────────────────────────────────────────


def test_file_route_log_storm_equals_jax_and_the_memory_oracle(tmp_path):
    filed, want = both(tmp_path, "file", kill_step=KILL_STEP,
                       handoff_steps=(60, 120),
                       config={"routeTransport": "file",
                               "ackWatermarkEvery": 1})
    assert filed == want
    memory = run_storm(PORT, tmp_path / "port" / "memory",
                       kill_step=KILL_STEP, handoff_steps=(60, 120))
    assert len(filed["failovers"]) == 1 and len(filed["handoffs"]) == 2
    assert filed["state"] == memory["state"]
    assert filed["results"] == memory["results"]
    log = sorted(p.name for p in
                 (tmp_path / "port" / "file" / "route-log").iterdir())
    assert log, "the schedule lives in files"


def watermark_run(pkg, root: Path, every: int) -> dict:
    pkg.reset_journals()
    clock = SetClock()
    sup = pkg.ClusterSupervisor(
        root, {"workers": 2, "ackEveryOps": 4, "deterministicIds": True,
               "ackWatermarkEvery": every},
        clock=clock, wall_timers=False, settable_clock=clock,
        journal_cfg=JOURNAL_CFG)
    for op in build_ops(pkg, SEED, root)[:48]:
        sup.submit(op)
    sup.drain()
    marks = {Path(ws).name: m for ws, m in sup.recover_watermarks().items()}
    with sup._lock:
        acked = {Path(ws).name: m for ws, m in sup._acked.items()}
    types_ = sorted({e.type for e in sup.transport.fetch(">")})
    sup.stop()
    pkg.reset_journals()
    return {"marks": marks, "acked": acked, "types": types_}


@pytest.mark.parametrize("every", [1, 0])
def test_watermark_recovery_equals_jax(tmp_path, every):
    got = watermark_run(PORT, tmp_path / "port", every)
    assert got == watermark_run(JAX, tmp_path / "jax", every)
    if every:
        assert got["marks"] == got["acked"] and got["marks"]
        assert got["types"] == ["cluster.ack", "cluster.route"]
    else:
        assert got["marks"] == {} and got["types"] == ["cluster.route"]


# ── sitrep /ops with the supervisor attached ────────────────────────


def ops_with_cluster(gateway_mod, sitrep_mod, pkg, root: Path) -> dict:
    """A supervisor-side gateway with the sitrep plugin and a supervisor
    attached (after a kill storm's first half): ``/ops`` and the cluster
    collector's item, host times masked."""
    import re

    pkg.reset_journals()
    clock = SetClock()
    sup = pkg.ClusterSupervisor(
        root / "cluster", {"workers": 3, "ackEveryOps": 6,
                           "deterministicIds": True},
        clock=clock, wall_timers=False, settable_clock=clock,
        journal_cfg=JOURNAL_CFG)
    ws = root / "ops"
    ws.mkdir(parents=True)
    gw = gateway_mod.Gateway(config={"workspace": str(ws)}, clock=clock)
    gw.load(sitrep_mod.SitrepPlugin(workspace=str(ws), wall_timers=False),
            plugin_config={"intervalMinutes": 0,
                           "collectors": {"cluster": {"enabled": True}}})
    gw.start()
    sup.attach_gateway(gw)
    for op in build_ops(pkg, SEED, root / "cluster")[:60]:
        sup.submit(op)
    sup.failover("w1", reason="operator kill")
    sup.drain()
    text = gw.command("ops")["text"]
    item = sitrep_mod_collect(sitrep_mod, gw)
    gw.stop()
    sup.stop()
    pkg.reset_journals()
    item.pop("lastFailover", None)  # its durationMs is the host's
    masked = json.dumps({"text": text, "item": item}, sort_keys=True,
                        ensure_ascii=False).replace(str(root), "ROOT")
    masked = re.sub(r"\d+\.\d+ms", "<ms>", masked)
    return json.loads(re.sub(r"\(\d{4}-\d\d-\d\dT[\d:]+Z\)", "(<utc>)",
                             masked))


def sitrep_mod_collect(sitrep_mod, gw) -> dict:
    collectors = sitrep_mod.collectors
    out = collectors.collect_cluster(
        {}, {"cluster_status": lambda: gw.call_method("cluster.status")})
    return {"status": out["status"], **(out["items"] or [{}])[0]}


def test_sitrep_ops_with_the_port_supervisor_equals_jax(tmp_path,
                                                        openclaw_home):
    from vainplex_openclaw_tpu import sitrep as jax_sitrep
    from vainplex_openclaw_tpu.core import gateway as jax_gateway
    from vainplex_openclaw_tpu_torch import sitrep
    from vainplex_openclaw_tpu_torch.core import gateway

    got = ops_with_cluster(gateway, sitrep, PORT, tmp_path / "port")
    want = ops_with_cluster(jax_gateway, jax_sitrep, JAX, tmp_path / "jax")
    assert got == want
    assert "cluster" in got["text"] and got["item"]["status"] == "warn"
