"""Cross-chain failure clustering — the all-pairs similarity stage: the
port's copy of ``vainplex_openclaw_tpu/cortex/trace_analyzer/clusters.py``.

``failure_signature`` (signals.py) catches *exact* recurrences: same tool,
same digit-normalized error text. This stage groups tool-failure signals
whose token sets are *near* duplicates, so the report can say "these 14
signals across 9 chains are one problem" instead of listing them 14 times.
For N signals the pairwise Jaccard matrix is one product of hashed
multi-hot rows (``ops.similarity.jaccard_from_rows``), on ``device``:
the card by default.

Two consumers of the shared core:

- ``cluster_failure_signals`` — the stateless batch path (the oracle):
  full matrix over this call's signals.
- ``IncrementalClusterer`` — persists hashed feature rows + union-find
  assignments across runs (keyed by signal identity) and computes only the
  rectangular new-rows × all-rows block per run. The state file's name and
  format are the JAX package's, so a state written by one package is read
  by the other.

The rows are {0, 1}, so the product is integer-exact in fp32 under any
order of accumulation, and the similarities, the clusters and the state
equal the JAX package's bit for bit, whichever device computes them.
"""

from __future__ import annotations

import hashlib
import re
from collections import OrderedDict
from pathlib import Path
from typing import TYPE_CHECKING, Optional

import numpy as np

from ...device import DeviceLike, resolve_device
from ...ops.similarity import hash_entries, jaccard_from_rows, multi_hot_rows
from ...storage.atomic import read_json, write_json_atomic

if TYPE_CHECKING:  # pragma: no cover
    from .signals import FailureSignal

# Signals need to share about half their (tool ∪ error-token) feature set to
# merge — loose enough to bridge paraphrase, tight enough that "permission
# denied" and "disk full" stay apart.
CLUSTER_THRESHOLD = 0.5
# O(N²) matrix: cap the signal count per run; the analyzer surfaces the
# dropped count in the report (failureClustersTruncated) via ``stats``.
MAX_CLUSTER_SIGNALS = 512
# Hash dimension for signal feature rows. Module-level because signal
# hashing (``_features_bits_blob`` → ``hash_entries``) and row
# reconstruction (``multi_hot_rows``) must agree, including for bits
# replayed from persisted state.
FEATURE_DIM = 1024
# Persisted-state growth valve: representatives accumulate forever under
# the batch-equivalent semantics (dedupe keys include chain ids, which are
# unique per run), and the kept window is the OLDEST ``max_signals`` by ts
# — so an unbounded state would both grow without limit and freeze
# clustering on historical traffic. Past this many entries the state
# resets and clusters restart from current traffic (a new "state
# creation"; batch equivalence holds per state generation).
MAX_STATE_ENTRIES = 4096
CLUSTER_STATE_FILE = "trace-clusters-state.json"
_TOKEN_RE = re.compile(r"[^\W\d_]{2,}", re.UNICODE)
_MAX_TOKENS = 48
_RANK = {"critical": 4, "high": 3, "medium": 2, "low": 1, "info": 0}

# Feature memo keyed by (tool, evidence-text): failure traffic is massively
# repetitive (the whole premise of clustering), so the regex tokenization +
# crc32 hashing of near-identical evidence strings is paid once per text.
_FEATURE_CACHE: "OrderedDict[tuple, tuple[dict, tuple, str]]" = OrderedDict()
_FEATURE_CACHE_CAP = 8192


def _features_bits_blob(sig: "FailureSignal") -> tuple[dict, tuple, str]:
    """(feature dict, hashed bit indices, sorted-feature-key blob) — the
    blob is the precomputed serialization half of the incremental dedupe
    key, cached here so `_entry_key` only pays one hash per signal."""
    tool = (sig.extra or {}).get("tool_name") or ""
    text = " ".join(str(e) for e in (sig.evidence or []))
    key = (tool, text)
    hit = _FEATURE_CACHE.get(key)
    if hit is not None:
        _FEATURE_CACHE.move_to_end(key)
        return hit
    norm = re.sub(r"\d+", "N", text.lower())
    tokens = sorted(set(_TOKEN_RE.findall(norm)))[:_MAX_TOKENS]
    feats = {f"tok:{t}": 1 for t in tokens}
    feats["tool"] = tool
    bits = hash_entries(feats, FEATURE_DIM)
    blob = "\0".join(sorted(feats))
    if len(_FEATURE_CACHE) >= _FEATURE_CACHE_CAP:
        _FEATURE_CACHE.popitem(last=False)
    _FEATURE_CACHE[key] = (feats, bits, blob)
    return feats, bits, blob


def signal_features(sig: "FailureSignal") -> dict:
    """Feature dict for one signal: tool name + digit-normalized unique
    tokens of the EVIDENCE (the captured error/claim text). The summary is
    deliberately excluded — its detector template words ("consecutive
    similar failing calls of …") are shared by every signal of a type and
    would merge unrelated failures. Shaped as a param-dict so it hashes
    exactly like tool params (key=value multi-hot). Memoized by
    (tool, evidence-text) — treat as read-only."""
    return _features_bits_blob(sig)[0]


class _UnionFind:
    def __init__(self, n: int, parents: Optional[list] = None):
        self.parent = list(parents) if parents else list(range(n))
        while len(self.parent) < n:
            self.parent.append(len(self.parent))

    def find(self, x: int) -> int:
        while self.parent[x] != x:
            self.parent[x] = self.parent[self.parent[x]]
            x = self.parent[x]
        return x

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


def _dedupe_representatives(signals: list, into: Optional[dict] = None) -> dict:
    """One representative per (chain, tool, evidence-token-set): one
    incident emits several signals in ITS OWN chain (a doom loop also
    raises tool-fails over the same evidence), so clusters must measure
    cross-chain recurrence, not detector fan-out — while DISTINCT failures
    of the same tool in one chain (different evidence) each stay in play.
    Dict order = first-arrival order of keys (the truncation sort is
    stable on it); a strictly-higher-severity duplicate replaces the
    representative in place. ``into`` lets the incremental
    path fold new runs into its persisted map with identical semantics."""
    best: dict = {} if into is None else into
    for s in signals:
        tool = (s.extra or {}).get("tool_name")
        if not tool:
            continue
        feats, bits, _ = _features_bits_blob(s)
        key = (s.chain_id, tool, frozenset(feats))
        cur = best.get(key)
        if cur is None or _RANK.get(s.severity, 0) > _RANK.get(cur[0].severity, 0):
            best[key] = (s, bits)
    return best


def _build_clusters(members_by_group: dict, reps: list, sims_for) -> list[dict]:
    """Report-ready dicts from grouped member indices. ``reps`` is the kept
    representative list (ts order); ``sims_for(members)`` returns the dense
    member×member similarity block (identical floats however computed —
    see ops/similarity exactness note)."""
    clusters = []
    for members in members_by_group.values():
        if len(members) < 2:
            continue
        sigs = [reps[i] for i in members]
        if len({s.chain_id for s in sigs}) < 2:
            continue  # recurrence means ACROSS chains, by definition
        iu = np.triu_indices(len(members), 1)
        pair_sims = sims_for(members)[iu]
        clusters.append({
            "size": len(sigs),
            "tools": sorted({(s.extra or {}).get("tool_name") or "" for s in sigs}),
            "signals": sorted({s.signal for s in sigs}),
            "chains": sorted({s.chain_id for s in sigs}),
            "sessions": sorted({s.session for s in sigs}),
            "severities": sorted({s.severity for s in sigs}),
            "meanSimilarity": round(float(pair_sims.mean()), 3)
                              if pair_sims.size else 1.0,
            "sample": (sigs[0].summary or "")[:160],
            "firstTs": min(s.ts for s in sigs),
            "lastTs": max(s.ts for s in sigs),
        })
    clusters.sort(key=lambda c: (-c["size"], c["firstTs"]))
    return clusters


def _group_indices(adjacency: np.ndarray) -> dict:
    """Connected components over a boolean adjacency matrix → {label:
    [member indices]} in ascending index order."""
    groups: dict[int, list[int]] = {}
    try:
        # One C-level connected-components call: the dense-failure case —
        # every chain hitting the same root cause — yields O(N²) edges.
        from scipy.sparse import csr_matrix
        from scipy.sparse.csgraph import connected_components

        _, labels = connected_components(csr_matrix(adjacency), directed=False)
        for i, label in enumerate(labels):
            groups.setdefault(int(label), []).append(i)
    except ImportError:  # pragma: no cover — without scipy
        n = len(adjacency)
        uf = _UnionFind(n)
        # No triu: the incremental caller's adjacency is ASYMMETRIC
        # (member→root and new-row edges only); connected_components
        # treats it as undirected, so this fallback must too.
        for i, j in np.argwhere(adjacency):
            uf.union(int(i), int(j))
        for i in range(n):
            groups.setdefault(uf.find(i), []).append(i)
    return groups


def cluster_failure_signals(signals: list, threshold: float = CLUSTER_THRESHOLD,
                            max_signals: int = MAX_CLUSTER_SIGNALS,
                            logger=None, stats: Optional[dict] = None,
                            device: DeviceLike = None) -> list[dict]:
    """Group tool-failure signals into near-duplicate clusters — the
    stateless BATCH path, and the oracle the incremental path is
    equivalence-tested against.

    Returns report-ready dicts for every cluster of ≥ 2 signals, largest
    first. Only signals carrying a ``tool_name`` participate (tool-fail,
    doom-loop, hallucination, repeat-fail); conversational signals have no
    comparable failure text. If ``stats`` is given it receives
    ``candidates`` / ``truncated`` counts so callers can surface capping.
    The Jaccard matrix is computed on ``device`` (default: the card).
    """
    dev = resolve_device(device)
    best = _dedupe_representatives(signals)
    kept = sorted(best.values(), key=lambda sb: sb[0].ts)
    candidates = [s for s, _ in kept]
    bit_rows = [b for _, b in kept]
    truncated = max(len(candidates) - max_signals, 0)
    if stats is not None:
        stats["candidates"] = len(candidates)
        stats["truncated"] = truncated
    if truncated:
        if logger is not None:
            logger.warn(f"failure clustering capped at {max_signals} of "
                        f"{len(candidates)} signals")
        candidates = candidates[:max_signals]
        bit_rows = bit_rows[:max_signals]
    n = len(candidates)
    if n < 2:
        return []

    sim = jaccard_from_rows(multi_hot_rows(bit_rows), device=dev)
    groups = _group_indices(sim >= threshold)
    return _build_clusters(groups, candidates,
                           lambda members: sim[np.ix_(members, members)])


# ── incremental path ─────────────────────────────────────────────────


class _Rep:
    """Persisted representative rebuilt into the signal-shaped view
    ``_build_clusters`` reads (signal/severity/chain_id/session/ts/summary
    + extra.tool_name)."""

    __slots__ = ("signal", "severity", "chain_id", "session", "ts",
                 "summary", "extra")

    def __init__(self, e: dict):
        self.signal = e["signal"]
        self.severity = e["severity"]
        self.chain_id = e["chain"]
        self.session = e["session"]
        self.ts = e["ts"]
        self.summary = e["summary"]
        self.extra = {"tool_name": e["tool"]}


_KEY_CACHE: dict = {}
_KEY_CACHE_CAP = 16384


def _entry_key(chain_id: str, tool: str, feat_blob: str) -> str:
    """Stable serialization of the batch path's dedupe key
    ``(chain_id, tool, frozenset(feats))``; ``feat_blob`` is the cached
    sorted-key join from ``_features_bits_blob``. Memoized: ``feat_blob``
    is an interned cache object (its str hash is computed once), so
    repeat signals cost one dict probe instead of a sha256."""
    k = (chain_id, tool, feat_blob)
    hit = _KEY_CACHE.get(k)
    if hit is None:
        blob = f"{chain_id or ''}\0{tool or ''}\0{feat_blob}"
        hit = hashlib.sha256(blob.encode("utf-8", "replace")).hexdigest()[:24]
        if len(_KEY_CACHE) >= _KEY_CACHE_CAP:
            _KEY_CACHE.clear()
        _KEY_CACHE[k] = hit
    return hit


class IncrementalClusterer:
    """Failure clustering that persists across analyzer runs.

    State (``trace-clusters-state.json`` in the analyzer state dir) holds
    every deduped representative ever seen — hashed feature bits + the
    report-facing metadata — plus union-find parents and the previous
    run's kept set. Per ``update()``:

    1. fold the run's signals into the representative map (same key and
       severity-upgrade semantics as the batch path);
    2. recompute the kept set (first ``max_signals`` by ts — identical to
       the batch truncation over the cumulative stream);
    3. if the kept set only GREW, compute the rectangular new×kept Jaccard
       block and merge edges into the persisted union-find — each pair is
       computed exactly once across the analyzer's lifetime; if a
       previously-kept row fell out (out-of-order ts arrivals near the
       cap), fall back to one batch-style rebuild over the kept set;
    4. rebuild report dicts from the kept representatives (per-cluster
       similarity blocks recomputed from persisted bits — bit-identical to
       the batch matrix, see ops/similarity).

    Equivalent to ``cluster_failure_signals`` over the concatenation of
    every run's signals since state creation (property-tested), at the
    cost of one rectangular block per run instead of the full matrix.
    ``max_state`` bounds the state file: past it the state resets and
    clustering restarts from current traffic (see MAX_STATE_ENTRIES).
    Every Jaccard block is computed on ``device`` (default: the card).
    """

    def __init__(self, state_dir, threshold: float = CLUSTER_THRESHOLD,
                 max_signals: int = MAX_CLUSTER_SIGNALS,
                 max_state: int = MAX_STATE_ENTRIES, logger=None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.path = Path(state_dir) / CLUSTER_STATE_FILE
        self.threshold = threshold
        self.max_signals = max_signals
        self.max_state = max_state
        self.logger = logger
        self._load()

    def _load(self) -> None:
        self.entries: list[dict] = []
        self.parents: list[int] = []
        self.prev_kept: set[int] = set()
        data = read_json(self.path)
        if not isinstance(data, dict):
            return
        if (data.get("threshold") != self.threshold
                or data.get("maxSignals") != self.max_signals
                or data.get("dim") != FEATURE_DIM):
            if self.logger is not None:
                self.logger.info("cluster state parameters changed; resetting")
            return
        entries = data.get("entries")
        parents = data.get("parents")
        kept = data.get("kept")
        if (not isinstance(entries, list) or not isinstance(parents, list)
                or not isinstance(kept, list) or len(parents) != len(entries)):
            return
        self.entries = entries
        self.parents = [int(p) for p in parents]
        self.prev_kept = {int(i) for i in kept}

    def _kept_indices(self) -> list[int]:
        order = sorted(range(len(self.entries)),
                       key=lambda i: self.entries[i]["ts"])
        return order[:self.max_signals]

    def update(self, signals: list, stats: Optional[dict] = None,
               save: bool = True) -> list[dict]:
        """Fold one run's signals into the persisted state and return the
        current report-ready clusters (over ALL signals seen since state
        creation)."""
        if len(self.entries) > self.max_state:
            if self.logger is not None:
                self.logger.info(
                    f"cluster state exceeded {self.max_state} entries; "
                    f"resetting window — clusters restart from current traffic")
            self.entries, self.parents, self.prev_kept = [], [], set()
        index = {e["key"]: i for i, e in enumerate(self.entries)}
        for s in signals:
            tool = (s.extra or {}).get("tool_name")
            if not tool:
                continue
            _, bits, blob = _features_bits_blob(s)
            key = _entry_key(s.chain_id, tool, blob)
            i = index.get(key)
            if i is None:
                index[key] = len(self.entries)
                self.entries.append({
                    "key": key, "bits": list(bits), "tool": tool,
                    "signal": s.signal, "severity": s.severity,
                    "chain": s.chain_id, "session": s.session,
                    "ts": s.ts, "summary": s.summary or ""})
                self.parents.append(len(self.parents))
            elif (_RANK.get(s.severity, 0)
                  > _RANK.get(self.entries[i]["severity"], 0)):
                # higher-severity duplicate replaces the representative —
                # same rule as the batch dedupe; bits are key-identical
                self.entries[i].update({
                    "signal": s.signal, "severity": s.severity,
                    "session": s.session, "ts": s.ts,
                    "summary": s.summary or ""})

        kept = self._kept_indices()
        kept_set = set(kept)
        truncated = max(len(self.entries) - self.max_signals, 0)
        if stats is not None:
            stats["candidates"] = len(self.entries)
            stats["truncated"] = truncated
        if truncated and self.logger is not None:
            self.logger.warn(f"failure clustering capped at {self.max_signals} "
                             f"of {len(self.entries)} signals")

        # Collapse identical feature rows before ANY matrix work: rows with
        # equal bit sets have pairwise similarity exactly 1.0 (always ≥ any
        # sane threshold) and identical similarity to every third row, so
        # cluster STRUCTURE depends only on the unique rows — and failure
        # traffic collapses hard (the whole premise of clustering).
        uid_of: dict[tuple, int] = {}
        uids: list[int] = []
        for i in kept:
            uids.append(uid_of.setdefault(tuple(self.entries[i]["bits"]),
                                          len(uid_of)))
        rows_uid = multi_hot_rows(list(uid_of), FEATURE_DIM)

        # Merge via ONE dense adjacency + C-level connected-components pass
        # (_group_indices), never a per-edge Python union loop: the dense-
        # failure case has O(N²) qualifying edges. Prior components enter the
        # adjacency as one member-uid → root-uid edge per kept entry, so
        # the transitive closure of (old components ∪ new block edges)
        # comes out of the same call.
        pos_of = {i: p for p, i in enumerate(kept)}
        uf_old = _UnionFind(len(self.entries), self.parents)
        root_pos = [pos_of.get(uf_old.find(i)) for i in kept]
        incremental_ok = self.prev_kept <= kept_set and None not in root_pos
        adjacency = np.eye(len(uid_of), dtype=bool)
        if incremental_ok:
            adjacency[uids, [uids[p] for p in root_pos]] = True
            # A uid needs block rows only if NO previously-kept entry
            # carries it: pairs among previously-co-kept uids were computed
            # the run the younger uid arrived and live on as components.
            prev_uids = {uids[p] for p, i in enumerate(kept)
                         if i in self.prev_kept}
            new_uids = sorted({uids[p] for p, i in enumerate(kept)
                               if i not in self.prev_kept} - prev_uids)
            if new_uids:
                block = jaccard_from_rows(rows_uid[new_uids], rows_uid,
                                          device=self.device)
                adjacency[new_uids] |= block >= self.threshold
        else:
            # A previously-kept row fell out of the cap window (out-of-order
            # arrivals near the cap) or a persisted root escaped the kept
            # set: incremental edges can't be trusted — one batch-style
            # rebuild over the kept set restores the invariant.
            sim = jaccard_from_rows(rows_uid, device=self.device)
            adjacency |= sim >= self.threshold
        label_of: dict[int, int] = {}
        if len(uid_of):
            for label, members in _group_indices(adjacency).items():
                for u in members:
                    label_of[u] = label
        groups: dict[int, list[int]] = {}
        for p, u in enumerate(uids):
            groups.setdefault(label_of[u], []).append(p)
        parents = list(range(len(self.entries)))
        for members in groups.values():
            root = kept[members[0]]
            for p in members:
                parents[kept[p]] = root
        self.parents = parents
        self.prev_kept = kept_set
        if save:
            self._save()
        return self._clusters(kept, groups=groups, rows_uid=rows_uid,
                              uids=uids)

    def _clusters(self, kept: list[int], groups: Optional[dict] = None,
                  rows_uid: Optional[np.ndarray] = None,
                  uids: Optional[list] = None) -> list[dict]:
        if groups is None:
            uf = _UnionFind(len(self.entries), self.parents)
            groups = {}
            for pos, i in enumerate(kept):
                groups.setdefault(uf.find(i), []).append(pos)
        if rows_uid is None or uids is None:
            uid_of: dict[tuple, int] = {}
            uids = []
            for i in kept:
                uids.append(uid_of.setdefault(tuple(self.entries[i]["bits"]),
                                              len(uid_of)))
            rows_uid = multi_hot_rows(list(uid_of), FEATURE_DIM)
        reps = [_Rep(self.entries[i]) for i in kept]

        # Similarities are computed per cluster over just that cluster's
        # unique rows, never as the full uid×uid matrix — heterogeneous
        # traffic (one uid per entry) would otherwise pay the whole O(N²·D)
        # matmul here every run, the exact cost update()'s rectangular
        # block exists to avoid. Restricting the matrix loses nothing:
        # each pair's value depends only on its two rows ({0,1} rows make
        # the matmul integer-exact in float32 under ANY blocking — see
        # ops/similarity), so the gathered member×member block and
        # meanSimilarity stay bit-identical to the batch path.
        def sims_for(members: list[int]) -> np.ndarray:
            member_uids = [uids[p] for p in members]
            sub = sorted(set(member_uids))
            local = {u: j for j, u in enumerate(sub)}
            sim_sub = jaccard_from_rows(rows_uid[sub], device=self.device)
            m = np.array([local[u] for u in member_uids])
            return sim_sub[np.ix_(m, m)]

        return _build_clusters(groups, reps, sims_for)

    def clusters(self) -> list[dict]:
        """Current clusters without folding in new signals."""
        return self._clusters(self._kept_indices())

    def _save(self) -> None:
        write_json_atomic(self.path, {
            "version": 1, "dim": FEATURE_DIM, "threshold": self.threshold,
            "maxSignals": self.max_signals, "entries": self.entries,
            "parents": self.parents, "kept": sorted(self.prev_kept),
        }, indent=None)
