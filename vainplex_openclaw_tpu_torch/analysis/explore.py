"""Systematic interleaving explorer for the cluster protocols.

A copy of ``vainplex_openclaw_tpu/analysis/explore.py`` that drives the
port's own ``ClusterSupervisor``, ``InProcessWorker``, ``LeaseTable`` and
``Journal`` (through the supervisor's ``worker_factory`` and the worker's
``gateway_builder``), with the same configurations, mutations and replay
strings. It is host work only: the stub gateway runs no model, so nothing
here takes a device.

Chaos storms (seeds 0/1/2) explore whatever interleavings their seeds
happen to produce; this module explores *all of them* for configurations
small enough to enumerate. Each :class:`~.proto_table.ExplorerConfig`
declares per-workspace client-op streams plus control steps (failover,
partition, handoff, hibernate, adoption, a stale-epoch zombie probe); the
explorer runs **every interleaving** of those streams — loom/DPOR-lite:
order within a stream is fixed, cross-stream order is enumerated, and
streams a config declares ``commuting`` (pinned to disjoint workers) are
reduced to one representative per adjacent-swap equivalence class —
through the REAL ``ClusterSupervisor``/``InProcessWorker``/``LeaseTable``/
``Journal`` protocol stack, asserting the PROTOCOL_TABLE invariant catalog
after every step and emitting a replayable schedule string
(``config@a0.P.Z.a1.a2``) on violation.

What is real and what is stubbed: the supervisor, ring, lease table,
fences, route log, journal group-commit/fencing/recovery, the worker's
ack/fence/crash/release/wake machinery — all real (the worker is the real
:class:`InProcessWorker`; only its ``gateway_builder`` is substituted).
The *payload executor* is a stub that journals one durable record per op
through the real per-workspace journal, so exhaustive enumeration doesn't
pay a governance+cortex build per schedule. Tracker content is explicitly
out of scope here — the chaos storms own byte-identical state; this gate
owns the schedule space of the protocol itself.

Findings carry rule ``GL-PROTO-SCHED``. Replay: feed the schedule string
back through :func:`run_schedule` — same config, same schedule, same
violation, deterministically. ``mutation=`` names an injected protocol
bug (one per GL-PROTO family) used by the CI goes-blind smoke:
``frozen-epoch`` (grants stop advancing), ``skip-fence-write`` (the
durable fence is never stamped), ``skip-barrier`` (handoff regrants
without the release barrier), ``ack-without-commit`` (seqs released with
records still buffered).
"""

from __future__ import annotations

import json
import tempfile
from contextlib import nullcontext
from pathlib import Path
from types import SimpleNamespace
from typing import Callable, Optional

from .findings import Finding
from .proto_table import EXPLORER_CONFIGS, ExplorerConfig, explorer_config
from .witness import ProtocolWitness

BASE_T = 1_753_772_400.0
OPS_STREAM = "explore:ops"
# Ack boundary (and explicit barriers) as the ONLY commit trigger — the
# exactly-once configuration the chaos storms pin; fsync "os" because the
# explorer asserts protocol order, not power-loss durability.
JOURNAL_CFG = {"maxBatchRecords": 1_000_000, "windowMs": 0.0, "fsync": "os"}

MUTATIONS = ("frozen-epoch", "skip-fence-write", "skip-barrier",
             "ack-without-commit")


class _SetClock:
    def __init__(self, t: float = BASE_T):
        self.t = t

    def __call__(self) -> float:
        return self.t


# ── the protocol-faithful stub executor ──────────────────────────────


def _ops_sink(ws: Path) -> Callable:
    target = Path(ws) / "ops.jsonl"

    def sink(batch, dedup):
        from ..storage.journal import dedup_against_tail
        if dedup:
            batch, _ = dedup_against_tail(target, batch)
        if not batch:
            return
        target.parent.mkdir(parents=True, exist_ok=True)
        with target.open("a", encoding="utf-8") as fh:
            fh.write("".join(raw + "\n" for _q, raw, _m in batch))

    return sink


class _StubTrackers:
    __slots__ = ("journal",)

    def __init__(self, journal):
        self.journal = journal

    def flush(self):
        if self.journal is not None:
            self.journal.compact()


class _StubCortex:
    """The cortex surface :class:`InProcessWorker` drives, over the REAL
    shared per-workspace journal: trackers() opens/wakes it, hibernate()
    is the LRU-eviction twin (flush + close), release_workspace() the
    handoff barrier (flush + close so the target opens with zero replay).
    """

    def __init__(self, clock, journal_settings):
        self.clock = clock
        self.settings = dict(JOURNAL_CFG)
        if isinstance(journal_settings, dict):
            self.settings.update(journal_settings)
        self.lifecycle = None
        self._trackers: dict = {}

    def _journal(self, ws: str):
        from ..storage.journal import get_journal, peek_journal
        j = peek_journal(ws)
        if j is None:
            j = get_journal(ws, self.settings, clock=self.clock, wall=False)
        if j is not None:
            j.register_append(OPS_STREAM, _ops_sink(Path(ws)))
        return j

    def trackers(self, ctx) -> _StubTrackers:
        return _StubTrackers(self._journal(str(ctx["workspace"])))

    def release_workspace(self, ws) -> bool:
        from ..storage.journal import peek_journal
        j = peek_journal(str(ws))
        if j is None:
            return True
        if not (j.commit() and j.compact()):
            return False
        j.close()
        return True

    def hibernate(self, ws) -> bool:
        return self.release_workspace(ws)


class _StubGateway:
    """dispatch_op's surface: every op becomes one journaled record."""

    def __init__(self, worker_id: str, cortex: _StubCortex):
        self.worker_id = worker_id
        self.cortex = cortex
        self.stage_timers: dict = {}

    def _record(self, kind: str, content: str, ctx) -> None:
        trackers = self.cortex.trackers(ctx)
        if trackers.journal is not None:
            trackers.journal.append(
                OPS_STREAM, {"kind": kind, "content": content})

    def message_received(self, content, ctx):
        self._record("msg_in", content, ctx)

    def message_sent(self, content, ctx):
        self._record("msg_out", content, ctx)

    def run_tool(self, tool, params, fn, ctx):
        self._record("tool", str(params), ctx)
        return SimpleNamespace(blocked=False), fn(params)

    def tool_result_persist(self, tool, content, ctx):
        self._record("tool_result", content, ctx)
        return content

    def stop(self):
        pass


def _stub_gateway_builder(worker_root, worker_id, clock=None,
                          wall_timers=True, journal_cfg=True,
                          lifecycle_cfg=True, logger=None):
    cortex = _StubCortex(clock, journal_cfg if isinstance(journal_cfg, dict)
                         else None)
    return _StubGateway(worker_id, cortex), cortex, None


# ── injected protocol bugs (the goes-blind smoke) ────────────────────
# Each mutation is one deliberately broken protocol site; the explorer
# must go red on it or the gate is blind. "pre" mutations install beneath
# the witness (their effects must be *recorded*); "post" install over it
# (their point is to bypass the instrumented call).


def _mut_frozen_epoch(run) -> None:
    table = run.sup.leases
    orig = table.grant

    def grant(ws, worker_id):
        prev = table.epoch(ws)
        epoch = orig(ws, worker_id)
        if prev > 0:
            with table._lock:
                table._leases[ws][1] = prev
            table.write_fence(ws, prev, worker_id)
            return prev
        return epoch

    table.grant = grant


def _mut_skip_fence_write(run) -> None:
    run.sup.leases.write_fence = lambda ws, epoch, worker_id: None


def _mut_skip_barrier(run) -> None:
    for state in run.sup.workers().values():
        handle = state.handle

        def release(ws, _h=handle):
            _h.shard.pop(ws, None)
            return []

        handle.release_workspace = release


def _mut_ack_without_commit(run) -> None:
    for state in run.sup.workers().values():
        handle = state.handle

        def ack(_h=handle):
            # the port's worker books each seq's workspace and early
            # release beside _since_ack; all three reset together
            _h._touched.clear()
            fresh, _h._since_ack = _h._since_ack, []
            _h._since_ack_ws, _h._released_early = [], []
            _h.acked += len(fresh)
            return fresh

        handle._ack = ack


_MUTATIONS: dict = {
    "frozen-epoch": ("pre", _mut_frozen_epoch),
    "skip-fence-write": ("pre", _mut_skip_fence_write),
    "ack-without-commit": ("pre", _mut_ack_without_commit),
    "skip-barrier": ("post", _mut_skip_barrier),
}


# ── schedule enumeration (the DPOR-lite half) ────────────────────────


def schedules(cfg: ExplorerConfig) -> list:
    """Every interleaving of the config's streams as schedule strings.
    Stream-internal order is fixed; ``commuting`` stream pairs are reduced
    to one adjacent-swap representative (canonical: the lower-indexed
    stream never immediately follows a higher-indexed commuting one)."""
    streams = [[f"{label.lower()}{i}" for i in range(n)]
               for label, n in zip(cfg.workspaces, cfg.ops)]
    streams.append(list(cfg.controls))
    commuting = {i for i, label in enumerate(cfg.workspaces)
                 if label in cfg.commuting}
    out: list = []

    def rec(prefix: list, idxs: list, last_stream: Optional[int]) -> None:
        if all(idxs[i] >= len(s) for i, s in enumerate(streams)):
            out.append(".".join(prefix))
            return
        for si, stream in enumerate(streams):
            if idxs[si] >= len(stream):
                continue
            if (last_stream is not None and si in commuting
                    and last_stream in commuting and si < last_stream):
                continue  # the swapped twin is the canonical representative
            idxs[si] += 1
            rec(prefix + [stream[idxs[si] - 1]], idxs, si)
            idxs[si] -= 1

    rec([], [0] * len(streams), None)
    return out


# ── one schedule through the real stack ──────────────────────────────


class _ScheduleRun:
    def __init__(self, cfg: ExplorerConfig, root: Path,
                 mutation: Optional[str] = None):
        from ..events.transport import MemoryTransport
        from ..storage.journal import reset_journals
        reset_journals()
        self.cfg = cfg
        self.root = Path(root)
        self.clock = _SetClock()
        self.results: dict = {}
        self.violations: list = []   # (invariant, message)
        self.witness = ProtocolWitness()
        self.transport = MemoryTransport(clock=self.clock)
        self.sup = self._build_sup("w", adopt=False)
        self._armed_mutation = mutation
        when, fn = _MUTATIONS[mutation] if mutation else (None, None)
        if when == "pre":
            fn(self)
        self.witness.arm_supervisor(self.sup)
        if when == "post":
            fn(self)
        self._op_index = 0
        self._submitted: dict = {}       # ws path -> [content, …]
        self._last_epochs: dict = {}
        self._checked_handoffs = 0

    # ── building ─────────────────────────────────────────────────────

    def _ws_path(self, label: str) -> str:
        return str(self.root / "tenants" / f"tenant{label}")

    def _build_sup(self, prefix: str, adopt: bool):
        from ..cluster.supervisor import ClusterSupervisor
        from ..cluster.worker import InProcessWorker

        def factory(worker_id, worker_root):
            return InProcessWorker(
                worker_id, worker_root, clock=self.clock,
                ack_every=self.cfg.ack_every, wall_timers=False,
                journal_cfg=JOURNAL_CFG, lifecycle_cfg=False,
                gateway_builder=_stub_gateway_builder)

        return ClusterSupervisor(
            self.root,
            {"workers": self.cfg.workers, "ackEveryOps": self.cfg.ack_every,
             "workerPrefix": prefix,
             "ackWatermarkEvery": 1 if self.cfg.adoption else 0},
            clock=self.clock, wall_timers=False, settable_clock=self.clock,
            journal_cfg=JOURNAL_CFG, lifecycle_cfg=False,
            transport=self.transport,
            on_result=lambda op, obs: self.results.__setitem__(
                op.get("i"), obs),
            adopt=adopt, worker_factory=factory)

    # ── steps ────────────────────────────────────────────────────────

    def _flag(self, invariant: str, message: str) -> None:
        self.violations.append((invariant, message))

    def _owner_state(self, ws: str):
        owner = self.sup.leases.owner(ws)
        if owner is None:
            return None
        return self.sup.workers().get(owner)

    def step(self, token: str) -> None:
        self.clock.t += 1.0
        if token[0].isalpha() and token[0].isupper():
            self._control(token)
            return
        label = token[0].upper()
        ws = self._ws_path(label)
        content = f"{label}:{token[1:]}"
        op = {"i": self._op_index, "at": self.clock.t, "ws": ws,
              "wsKey": f"tenant{label}", "kind": "msg_in",
              "content": content}
        self._op_index += 1
        self._submitted.setdefault(ws, []).append(content)
        self.sup.submit(op)
        self.sup.tick()

    def _control(self, token: str) -> None:
        ws = self._ws_path(self.cfg.workspaces[0])
        if token == "P":        # partition: fail over a live owner (zombie)
            owner = self.sup.leases.owner(ws)
            if owner is not None and self.sup.workers()[owner].alive:
                self.sup.failover(owner, reason="partition (explorer)")
        elif token == "K":      # crash, then tick-detect
            state = self._owner_state(ws)
            if state is not None and state.alive:
                state.handle.crash()
                self.sup.tick()
        elif token == "H":      # planned handoff
            before = self.sup.leases.epoch(ws)
            record = self.sup.handoff(ws, reason="explorer")
            if record is None and before > 0 \
                    and self.sup.leases.epoch(ws) > before:
                self._flag("barrier-before-regrant",
                           f"aborted handoff of {ws} still advanced the "
                           f"epoch ({before} -> {self.sup.leases.epoch(ws)})")
        elif token == "S":      # hibernate on the owner (journal close)
            state = self._owner_state(ws)
            if state is not None and state.alive \
                    and ws in state.handle.shard:
                state.handle.cortex.hibernate(ws)
        elif token == "Z":
            self._zombie_probe(ws)
        elif token == "G":
            self._generation_switch()
        else:
            raise ValueError(f"unknown control token {token!r}")

    def _zombie_probe(self, ws: str) -> None:
        """A writer one epoch behind the durable fence must never commit.
        Models the partitioned old owner's PROCESS (a separate journal
        instance at the stale epoch — in-process failover re-fences the
        shared instance, so the cross-process shape needs its own probe)."""
        from ..cluster.ring import FENCE_FILE
        from ..storage.journal import Journal
        epoch = self.sup.leases.epoch(ws)
        if epoch < 1:
            return
        probe = Journal(Path(ws) / "journal", JOURNAL_CFG,
                        clock=self.clock, wall=False)
        try:
            probe.register_snapshot("explore:zombie",
                                    Path(ws) / "zombie.json", indent=None)
            probe.set_fence(Path(ws) / FENCE_FILE, epoch - 1)
            probe.append("explore:zombie", {"zombie": True})
            if probe.commit():
                self._flag("fence-before-write",
                           f"stale-epoch ({epoch - 1}) zombie commit on "
                           f"{ws} LANDED past the fence")
            elif probe.fence_rejected < 1:
                self._flag("fence-before-write",
                           f"zombie commit on {ws} neither landed nor was "
                           f"counted as fenced")
            if probe.compact():
                self._flag("fence-before-write",
                           f"stale-epoch zombie compaction on {ws} touched "
                           f"the legacy files")
        finally:
            probe.abandon()
        if (Path(ws) / "zombie.json").exists():
            self._flag("fence-before-write",
                       f"zombie snapshot reached {ws}/zombie.json")

    def _generation_switch(self) -> None:
        """Generation 1 dies uncleanly (workers crash, lease journal
        abandoned with committed-but-uncompacted grants in its wal);
        generation 2 adopts the same root + schedule."""
        before = {ws: lease["epoch"]
                  for ws, lease in self.sup.leases.snapshot().items()}
        for state in self.sup.workers().values():
            if state.handle.sync:
                state.handle.crash()
        if self.sup.leases.journal is not None:
            self.sup.leases.journal.abandon()
        self.sup = self._build_sup("b", adopt=True)
        # Same pre/post layering as __init__: "pre" mutations install
        # BENEATH the witness (their effects must be recorded), "post"
        # over it — re-arming in the other order would let the witness
        # record the unmutated call and go blind to the injected bug.
        when, fn = (_MUTATIONS[self._armed_mutation]
                    if self._armed_mutation else (None, None))
        if when == "pre":
            fn(self)
        self.witness.arm_supervisor(self.sup)
        if when == "post":
            fn(self)
        after = self.sup.leases.snapshot()
        for ws, old_epoch in before.items():
            new = after.get(ws, {}).get("epoch", 0)
            if new <= old_epoch:
                self._flag("epoch-monotonic",
                           f"adoption left {ws} at epoch {new} (was "
                           f"{old_epoch}) — the previous generation is "
                           f"not fenced")

    # ── invariant checks (after every step) ──────────────────────────

    def _durable_contents(self, ws: str) -> dict:
        """content -> committed-record count from the workspace wal (the
        explorer never rotates segments, so the wal holds every committed
        record of the run across instance generations)."""
        counts: dict = {}
        for seg in sorted((Path(ws) / "journal").glob("wal.*.jsonl")):
            try:
                lines = seg.read_text(encoding="utf-8").splitlines()
            except OSError:
                continue
            for line in lines:
                if not line.strip():
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if rec.get("s") != OPS_STREAM:
                    continue
                content = (rec.get("p") or {}).get("content")
                if content is not None:
                    counts[content] = counts.get(content, 0) + 1
        return counts

    def check(self) -> None:
        leases = self.sup.leases.snapshot()
        from ..cluster.ring import LeaseTable
        from ..storage.journal import peek_journal
        for ws, lease in leases.items():
            epoch = lease["epoch"]
            if epoch < self._last_epochs.get(ws, 0):
                self._flag("epoch-monotonic",
                           f"lease epoch of {ws} moved backwards "
                           f"({self._last_epochs[ws]} -> {epoch})")
            self._last_epochs[ws] = max(epoch,
                                        self._last_epochs.get(ws, 0))
            fence = LeaseTable.read_fence(ws)
            fence_epoch = (fence or {}).get("epoch")
            if fence_epoch != epoch:
                self._flag("fence-before-write",
                           f"durable fence of {ws} reads {fence_epoch} but "
                           f"the lease is at epoch {epoch} — a zombie one "
                           f"epoch back would pass the fence")
        workers = self.sup.workers()
        for worker_id, state in workers.items():
            if not state.alive or not state.handle.sync:
                continue
            for ws, epoch in state.handle.shard.items():
                journal = peek_journal(ws)
                if journal is None:
                    continue
                if journal.fence_epoch is None:
                    self._flag("wake-refences",
                               f"open journal on sharded {ws} ({worker_id}) "
                               f"carries no fence — the hibernation-wake "
                               f"zombie window")
                elif leases.get(ws, {}).get("owner") == worker_id \
                        and journal.fence_epoch != leases[ws]["epoch"]:
                    self._flag("wake-refences",
                               f"owner {worker_id}'s journal on {ws} is "
                               f"fenced at {journal.fence_epoch}, lease at "
                               f"{leases[ws]['epoch']}")
        # ack-after-commit: every acked seq's effect is durable on disk.
        delivered: dict = {}
        for kind, ws, info in self.witness.events:
            if kind == "deliver" and info.get("seq", -1) >= 0:
                delivered.setdefault(ws, []).append(
                    (info["seq"], info.get("content")))
        with self.sup._lock:
            marks = dict(self.sup._acked)
        for ws, pairs in delivered.items():
            mark = marks.get(ws, 0)
            if mark <= 0:
                continue
            durable = self._durable_contents(ws)
            for seq, content in pairs:
                if seq <= mark and content is not None \
                        and durable.get(content, 0) < 1:
                    self._flag("ack-after-commit",
                               f"seq {seq} ({content}) on {ws} is inside "
                               f"the acked watermark {mark} but its record "
                               f"was never committed — redelivery just "
                               f"became loss")
        # zero-replay handoff: planned moves pay no replay, no redelivery.
        handoffs = self.sup.stats()["handoffs"]
        for record in handoffs[self._checked_handoffs:]:
            if record["replayedRecords"] or record["redelivered"]:
                self._flag("barrier-before-regrant",
                           f"handoff of {record['ws']} replayed "
                           f"{record['replayedRecords']} and redelivered "
                           f"{record['redelivered']} — the barrier did not "
                           f"hold")
        self._checked_handoffs = len(handoffs)

    def finish(self) -> None:
        from ..storage.journal import peek_journal, reset_journals
        self.sup.drain()
        for ws in self._submitted:
            journal = peek_journal(ws)
            if journal is not None:
                journal.compact()
        for i in range(self._op_index):
            if i not in self.results:
                self._flag("ack-after-commit",
                           f"op {i} produced no final observation — a "
                           f"submitted op was lost")
        for ws, contents in self._submitted.items():
            durable = self._durable_contents(ws)
            for content in contents:
                n = durable.get(content, 0)
                if n != 1:
                    self._flag("ack-after-commit",
                               f"{content} on {ws} committed {n} times "
                               f"(expected exactly once)")
            extra = set(durable) - set(contents)
            if extra:
                self._flag("fence-before-write",
                           f"unsubmitted records landed on {ws}: "
                           f"{sorted(extra)}")
        for inv, msg in self.witness.violations():
            self._flag(inv, msg)
        try:
            self.sup.stop()
        except Exception:  # noqa: BLE001 — teardown must not mask findings
            pass
        reset_journals()


def run_schedule(cfg_or_name, schedule: str, base_dir=None,
                 mutation: Optional[str] = None) -> list:
    """Execute ONE schedule; returns ``(invariant, message)`` violations.
    This is the replay entry point: the schedule string a finding carries
    reproduces its violation deterministically."""
    cfg = (explorer_config(cfg_or_name) if isinstance(cfg_or_name, str)
           else cfg_or_name)
    from ..resilience.faults import FaultPlan, FaultSpec, installed
    tokens = schedule.split(".") if schedule else []
    with tempfile.TemporaryDirectory(dir=base_dir) as tmp:
        run = _ScheduleRun(cfg, Path(tmp), mutation=mutation)
        plan_ctx = nullcontext()
        if cfg.faults:
            plan_ctx = installed(FaultPlan(
                [FaultSpec(site, steps=(step,))
                 for site, step in cfg.faults], seed=0))
        with plan_ctx:
            for token in tokens:
                run.step(token)
                run.check()
            run.finish()
        return run.violations


def run_config(cfg_or_name, base_dir=None, mutation: Optional[str] = None,
               max_schedules: Optional[int] = None) -> dict:
    """Exhaustively run one config; returns ``{"config", "schedules",
    "violations": [(schedule, invariant, message), …]}``. A bounded sweep
    (``max_schedules``) is for diagnostics only — the gate runs unbounded,
    and silent truncation would be the 'three lucky seeds' problem with
    extra steps."""
    cfg = (explorer_config(cfg_or_name) if isinstance(cfg_or_name, str)
           else cfg_or_name)
    all_schedules = schedules(cfg)
    if max_schedules is not None:
        all_schedules = all_schedules[:max_schedules]
    violations: list = []
    for schedule in all_schedules:
        for inv, msg in run_schedule(cfg, schedule, base_dir=base_dir,
                                     mutation=mutation):
            violations.append((schedule, inv, msg))
    return {"config": cfg.name, "schedules": len(all_schedules),
            "violations": violations}


def run(root=None, configs=EXPLORER_CONFIGS,
        mutation: Optional[str] = None) -> tuple:
    """(findings, schedules_executed) — the analysis-runner pass shape.
    ``root`` is accepted for uniformity; the explorer runs in fresh
    temporary roots (it executes the machinery, it does not scan files)."""
    findings: list = []
    executed = 0
    for cfg in configs:
        report = run_config(cfg, mutation=mutation)
        executed += report["schedules"]
        for schedule, invariant, message in report["violations"]:
            findings.append(Finding(
                "GL-PROTO-SCHED", "vainplex_openclaw_tpu_torch/cluster/supervisor.py",
                1,
                f"[{cfg.name}] {invariant}: {message} "
                f"(replay: {cfg.name}@{schedule})",
                detail=f"{cfg.name}:{invariant}:{schedule}"))
    return findings, executed
