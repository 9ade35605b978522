"""Workspace sharding: consistent-hash ring + epoch-numbered lease table.

A copy of ``vainplex_openclaw_tpu/cluster/ring.py`` under the same names,
on the port's own ``Journal``, ``maybe_fail`` and atomic writers, so the
port imports nothing of the JAX package.

The ring answers "who serves this workspace" as a pure function of the
membership set and the key: deterministic across processes, platforms and
insertion orders (sha1, not ``hash()``: ``PYTHONHASHSEED`` must not reshard
the cluster). Virtual nodes give bounded movement: removing a worker moves
ONLY that worker's keys (each to the next point on the ring), adding one
steals ~1/N of the keyspace and touches nobody else's assignments. An
assignment function that silently reshuffled unrelated workspaces would
turn every membership change into a cluster-wide journal-replay storm.

The :class:`LeaseTable` turns assignments into *ownership*: per workspace an
``(owner, epoch)`` pair where the epoch increments on every grant. Leases
persist through the journal (snapshot stream, group-committed), and each
grant stamps the workspace itself with a durable **fence file**: the
single artifact a zombie writer's journal checks at commit time
(:meth:`..storage.journal.Journal.set_fence`). Fencing closes the split-brain
window: a worker the supervisor failed over away from may still be running,
but any write it attempts carries a stale epoch and is rejected at the
journal boundary before it can interleave with the new owner's.
"""

from __future__ import annotations

import hashlib
import threading
from bisect import bisect_right
from pathlib import Path
from typing import Callable, Optional

from ..resilience.faults import maybe_fail
from ..storage.atomic import read_json, write_json_atomic
from ..storage.journal import Journal

FENCE_FILE = "cluster.fence.json"
DEFAULT_VNODES = 160


def _point(label: str) -> int:
    """Stable 64-bit ring coordinate for a label."""
    return int.from_bytes(hashlib.sha1(label.encode("utf-8")).digest()[:8],
                          "big")


class HashRing:
    """Deterministic consistent-hash ring over worker ids.

    Not thread-safe by itself: the supervisor mutates membership under its
    own lock and everyone else only calls the read-only ``owner``/
    ``assignment`` views through it.
    """

    def __init__(self, vnodes: int = DEFAULT_VNODES):
        if vnodes < 1:
            raise ValueError("vnodes must be >= 1")
        self.vnodes = vnodes
        self._points: list[tuple[int, str]] = []  # sorted (coordinate, worker)
        self._members: set[str] = set()

    def add(self, worker_id: str) -> None:
        if worker_id in self._members:
            return
        self._members.add(worker_id)
        for v in range(self.vnodes):
            self._points.append((_point(f"{worker_id}#{v}"), worker_id))
        self._points.sort()

    def remove(self, worker_id: str) -> None:
        if worker_id not in self._members:
            return
        self._members.discard(worker_id)
        self._points = [p for p in self._points if p[1] != worker_id]

    def members(self) -> list[str]:
        return sorted(self._members)

    def owner(self, key: str, loads: Optional[dict] = None,
              max_load: Optional[int] = None) -> str:
        """The worker whose vnode follows the key's coordinate (wrapping).

        With ``loads``/``max_load`` this is consistent hashing **with
        bounded loads**: successors already at ``max_load`` are skipped, so
        no worker's placement count exceeds the cap (raw vnode hashing
        leaves the max-loaded worker at ~1.3–1.5× mean for realistic key
        counts, which alone caps 4-way scaling near 0.7). Placement stays a
        pure function of ``(members, key, loads, cap)``; the supervisor's
        leases are sticky, so bounded movement is preserved — an existing
        lease is never re-derived, only granted once and moved on failover."""
        if not self._points:
            raise LookupError("ring has no members")
        idx = bisect_right(self._points, (_point(key), "￿"))
        n = len(self._points)
        first = None
        for step in range(n):
            worker = self._points[(idx + step) % n][1]
            if first is None:
                first = worker
            if loads is None or max_load is None \
                    or loads.get(worker, 0) < max_load:
                return worker
        return first  # everyone at cap: fall back to the raw successor

    def assignment(self, keys) -> dict:
        """{key: worker} for a batch of keys (the rebalance diff input)."""
        return {k: self.owner(k) for k in keys}

    def shares(self, keys) -> dict:
        """{worker: fraction of keys} — the balance artifact the scaling
        bench attributes efficiency to (a skewed ring caps the max worker)."""
        keys = list(keys)
        counts: dict[str, int] = {w: 0 for w in self._members}
        for k in keys:
            counts[self.owner(k)] += 1
        total = max(1, len(keys))
        return {w: c / total for w, c in sorted(counts.items())}


class LeaseTable:
    """Per-workspace ``(owner, epoch)`` ownership with journal persistence.

    ``grant`` is the only mutation: it bumps the epoch, journals the full
    table (snapshot stream — coalesced, group-committed, replayed on
    reopen), and stamps the workspace's fence file durably BEFORE returning,
    so by the time a new owner is told to admit traffic every zombie commit
    against that workspace already reads a newer epoch.
    """

    STREAM = "cluster:leases"

    def __init__(self, root: str | Path, clock: Callable[[], float],
                 journal_settings: Optional[dict] = None, logger=None):
        self.root = Path(root)
        self.clock = clock
        self.logger = logger
        self._lock = threading.Lock()
        # Serializes the whole mutate→journal→(rollback|fence) sequence of
        # one grant against other GRANTS only (readers stay on the hot
        # ``_lock``). Without it, two interleaved grants break the abort
        # path both ways: drop_pending() on a failed grant would discard
        # the OTHER grant's buffered payload (its commit then vacuously
        # "succeeds" and stamps a fence for an epoch that never became
        # durable), and the full-table payload snapshotted after a
        # concurrent — later rolled back — mutation would persist the
        # aborted entry. Blocking (group commit + fsync) under this lock
        # is the point: a grant IS a durable control-plane write.
        self._grant_lock = threading.Lock()
        self._leases: dict[str, list] = {}  # ws -> [owner, epoch]
        self.path = self.root / "leases.json"
        try:
            # wall=False always: grant() commits explicitly (lease
            # durability precedes the fence write), so window timers add
            # nothing but a background thread — a fork hazard for the
            # process-worker mode (see worker.mp_context).
            self.journal: Optional[Journal] = Journal(
                self.root / "journal", journal_settings or {}, clock=clock,
                wall=False, logger=logger)
        except OSError:
            self.journal = None  # read-only root: in-memory leases only
        if self.journal is not None:
            self.journal.register_snapshot(self.STREAM, self.path, indent=None)
            # Supervisor restart/adoption: grants from a previous
            # supervisor generation are durable in the wal the moment
            # ``grant`` committed, but ``leases.json`` only advances on
            # compaction — fold the replayed records in BEFORE the read, or
            # a replacement supervisor would adopt a stale ownership table.
            self.journal.compact(self.STREAM)
        data = read_json(self.path, None)
        if isinstance(data, dict):
            for ws, lease in (data.get("leases") or {}).items():
                if isinstance(lease, list) and len(lease) == 2:
                    self._leases[str(ws)] = [str(lease[0]), int(lease[1])]

    # ── queries ──────────────────────────────────────────────────────

    def owner(self, ws: str) -> Optional[str]:
        with self._lock:
            lease = self._leases.get(ws)
            return lease[0] if lease else None

    def epoch(self, ws: str) -> int:
        with self._lock:
            lease = self._leases.get(ws)
            return lease[1] if lease else 0

    def owned_by(self, worker_id: str) -> list[str]:
        with self._lock:
            return sorted(ws for ws, (o, _e) in self._leases.items()
                          if o == worker_id)

    def snapshot(self) -> dict:
        with self._lock:
            return {ws: {"owner": o, "epoch": e}
                    for ws, (o, e) in sorted(self._leases.items())}

    # ── the one mutation ─────────────────────────────────────────────

    def grant(self, ws: str, worker_id: str) -> int:
        """Move/establish ownership of ``ws``; returns the new epoch. The
        fence write is the linearization point of the failover — it must
        land before the new owner opens the workspace journal. Grants
        serialize on ``_grant_lock`` (see __init__) so the abort path
        below only ever touches its OWN buffered payload and snapshot."""
        with self._grant_lock:
            with self._lock:
                lease = self._leases.get(ws)
                prior = list(lease) if lease else None
                epoch = (lease[1] if lease else 0) + 1
                self._leases[ws] = [worker_id, epoch]
                payload = {"leases": {w: list(l)
                                      for w, l in sorted(self._leases.items())}}
            if self.journal is not None:
                accepted = self.journal.append(self.STREAM, payload)
                committed = False
                for _attempt in range(3):
                    if self.journal.commit():
                        committed = True
                        break
                if not (accepted and committed):
                    # Lease durability PRECEDES the fence, enforced, not
                    # just stated (found by the adoption crash-point
                    # property test): stamping a fence for an
                    # uncommitted grant opens a crash window where a
                    # replacement supervisor folds the wal back to the OLD
                    # epoch while the fence advertises the new one, then
                    # re-issues that epoch — the old and new grantees
                    # would share it and both pass the journal's fence
                    # check. Transient write faults are retried (a torn
                    # wal tail self-repairs on the next commit);
                    # persistent failure aborts the grant UNFENCED — the
                    # same contract as a fence-write fault below. The
                    # abort is complete: the buffered payload is dropped
                    # (left in place, the NEXT successful commit — even
                    # close()'s farewell one — would make the aborted
                    # epoch durable behind the old fence) and the
                    # in-memory entry rolls back to the durable lease
                    # (left advanced, owner() would report the aborted
                    # grantee, so a supervisor that survives the raise
                    # would route traffic to an owner that was never
                    # fenced or recovered). The epoch number is reusable:
                    # it was never durable, never fenced, never returned
                    # to any caller.
                    self.journal.drop_pending()
                    with self._lock:
                        if prior is None:
                            self._leases.pop(ws, None)
                        else:
                            self._leases[ws] = prior
                    raise OSError(self.journal.last_error
                                  or "lease grant commit failed")
            self.write_fence(ws, epoch, worker_id)
        return epoch

    def write_fence(self, ws: str, epoch: int, worker_id: str) -> None:
        """Durable fence stamp inside the workspace itself — the artifact a
        (possibly partitioned) old owner's journal checks at every commit.
        ``cluster.lease`` is a chaos fault site; a failed write raises so
        the supervisor never admits a new owner behind an unwritten fence."""
        maybe_fail("cluster.lease")
        write_json_atomic(Path(ws) / FENCE_FILE,
                          {"epoch": epoch, "owner": worker_id,
                           "grantedAt": self.clock()},
                          indent=None, durable=True)

    @staticmethod
    def read_fence(ws: str | Path) -> Optional[dict]:
        data = read_json(Path(ws) / FENCE_FILE, None)
        return data if isinstance(data, dict) else None

    def close(self) -> None:
        if self.journal is not None:
            self.journal.close()
