"""Fact embeddings for the knowledge engine: Chroma sync or on-device search.

Counterpart of ``vainplex_openclaw_tpu/knowledge/embeddings.py``. Two
backends:

- ``chroma``: facts become ``"subject predicate object."`` documents POSTed
  to a ChromaDB-v2-shaped endpoint through an injected ``http_post``
  (a copy of the JAX module's jax-free half);
- ``local``: :class:`LocalEmbeddings`, the port's encoder on the card
  (``device=None``) or the CPU, with cosine top-k over an in-memory arena.

``meshServing: true`` gives the local backend a mesh: the embedding
forward runs through the plan of ``planFamily`` (``embeddings_forward``:
weights replicated, batch over dp; ``embeddings_forward_moe``: expert
matrices over ep as well) and search scores the arena with its rows split
over dp (``parallel.plan.arena_scores``). The plan resolves through the
searched plan table as every mesh family's does, so its ``bucket_min``
floors the query and arena buckets.
"""

from __future__ import annotations

import json
import math
import re
import threading
from collections import OrderedDict
from typing import Callable, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models.encoder import (EncoderConfig, forward, init_params,
                              params_from_numpy)
from ..models.pretrained import load_pretrained
from ..models.tokenizer import encode_texts
from ..ops.similarity import pad_rows, pow2_bucket
from ..parallel import plan as sharding_plan
from ..parallel.mesh import _factor, available_devices, cached_mesh
from ..utils.stage_timer import StageTimer


def _default_http_post(url: str, payload: dict, timeout: float = 15.0) -> dict:
    from urllib.request import Request, urlopen

    req = Request(url, data=json.dumps(payload).encode(),
                  headers={"Content-Type": "application/json"})
    with urlopen(req, timeout=timeout) as resp:  # noqa: S310 — operator-configured endpoint
        body = resp.read().decode()
        return json.loads(body) if body else {}


def fact_document(fact) -> str:
    return f"{fact.subject} {fact.predicate.replace('-', ' ')} {fact.object}."


def construct_chroma_payload(facts: list) -> dict:
    payload = {"ids": [], "documents": [], "metadatas": []}
    for fact in facts:
        payload["ids"].append(fact.id)
        payload["documents"].append(fact_document(fact))
        payload["metadatas"].append({  # v2 requires string-only metadata
            "subject": fact.subject, "predicate": fact.predicate,
            "object": fact.object, "source": fact.source,
            "createdAt": fact.created_at,
        })
    return payload


class ChromaEmbeddings:
    def __init__(self, config: dict, logger,
                 http_post: Callable = _default_http_post):
        self.config = config
        self.logger = logger
        self.http_post = http_post

    def enabled(self) -> bool:
        return bool(self.config.get("enabled"))

    def _endpoint(self) -> str:
        url = (self.config.get("endpoint") or "").replace(
            "{name}", self.config.get("collectionName", "facts"))
        return re.sub(r"([^:])//", r"\1/", url)

    def sync(self, facts: list) -> int:
        if not self.enabled() or not facts:
            return 0
        try:
            self.http_post(self._endpoint(), construct_chroma_payload(facts))
            self.logger.info(f"Synced {len(facts)} facts to ChromaDB")
            return len(facts)
        except Exception as exc:  # noqa: BLE001 — embeddings are best-effort
            self.logger.error(f"Embeddings sync failed: {exc}")
            return 0

    def remove(self, ids) -> int:
        """Best-effort delete of pruned facts (the Chroma v2 ``…/delete``
        sibling of the configured upsert URL). Returns the number of ids
        settled: deleted, or permanently undeletable (a custom endpoint no
        delete URL can be derived from). A transient failure returns 0, so
        the caller retries next tick."""
        ids = sorted(ids)
        if not self.enabled() or not ids:
            return 0
        endpoint = self._endpoint()
        if not endpoint.endswith("/upsert"):
            self.logger.warn(
                "cannot derive delete endpoint from custom upsert URL; "
                f"{len(ids)} pruned facts remain in ChromaDB")
            return len(ids)
        try:
            self.http_post(endpoint[: -len("/upsert")] + "/delete",
                           {"ids": ids})
            self.logger.info(f"Removed {len(ids)} pruned facts from ChromaDB")
            return len(ids)
        except Exception as exc:  # noqa: BLE001 — embeddings are best-effort
            self.logger.error(f"Embeddings delete failed: {exc}")
            return 0


class LocalEmbeddings:
    """On-device fact embeddings: the encoder's unit vector ⊕ a hashed
    bag-of-tokens, cosine top-k by one matmul.

    - The learned half runs the shipped checkpoint (or ``checkpoint_dir``)
      on ``device``; without one it falls back to the port's own seeded
      init (``torch.Generator`` seed ``seed``). The model loads at first
      use, under its own lock.
    - ``_embed`` pads the batch to a power of two (zero-token rows pool to
      nothing and are sliced away); the bag-of-tokens half is one flat
      scatter-add.
    - Vectors live in a capacity-doubling float32 arena: a re-synced id
      overwrites its row, a new id appends, ``remove`` swaps the last row
      into the hole.
    - ``search`` takes the top k by ``np.argpartition`` and orders ties by
      (-score, id), independent of arena row order.
    - Query embeddings go through an LRU cache of vectors, never of
      results, so a cached query scores against the current arena.
    - Arena and cache are guarded by one lock (a maintenance thread syncs
      while a serve thread searches); the embedding compute stays outside.
    - ``timer`` attributes ``sync`` and ``search`` time, and with a mesh
      ``shard``: committing the arena to the mesh, which happens again
      only after ``sync`` or ``remove`` changed it.
    - ``mesh`` (a :class:`~..parallel.mesh.Mesh` on ``device``'s type)
      serves the forward through the plan of ``plan_family`` and scores
      the arena with its rows split over dp; its first device is the
      model's.
    """

    def __init__(self, logger, seed: int = 11, learned_weight: float = 0.5,
                 checkpoint_dir: Optional[str] = None,
                 timer: Optional[StageTimer] = None,
                 query_cache_size: int = 256, device: DeviceLike = None,
                 mesh=None, plan_family: str = "embeddings_forward"):
        self.logger = logger
        self.seed = seed
        self.learned_weight = learned_weight
        self.checkpoint_dir = checkpoint_dir
        self.device = resolve_device(device)
        self._mesh = mesh
        self._plan_family = plan_family
        if mesh is not None:
            sharding_plan.check_servable(
                sharding_plan.resolve_plan(plan_family, mesh), mesh)
            if {d.type for d in mesh.devices} != {self.device.type}:
                raise ValueError(f"mesh devices {mesh.distinct_devices()} "
                                 f"are not on {self.device.type}")
            self.device = mesh.devices[0]
        # the arena's rows on the mesh, committed again after a mutation
        self._device_arena = None
        self._device_arena_rows = 0
        self._arena_dirty = True
        self.timer = timer if timer is not None else StageTimer()
        self._model = None
        self._lock = threading.Lock()
        self._init_lock = threading.Lock()
        self._docs: dict[str, str] = {}
        # rows [0, _size) of _arena are live; _ids[row] <-> _pos[id]
        self._arena: Optional[np.ndarray] = None
        self._size = 0
        self._ids: list[str] = []
        self._pos: dict[str, int] = {}
        self._query_cache: "OrderedDict[str, np.ndarray]" = OrderedDict()
        self._query_cache_size = query_cache_size
        self.query_cache_hits = 0
        self.query_cache_misses = 0

    def enabled(self) -> bool:
        return True

    # ── embedding ────────────────────────────────────────────────────

    def _ensure_model(self):
        with self._init_lock:
            if self._model is None:
                self._model = load_pretrained(self.checkpoint_dir,
                                              device=self.device)
            if self._model is None:  # no checkpoint anywhere
                cfg = EncoderConfig()
                gen = torch.Generator().manual_seed(self.seed)
                self._model = (cfg, params_from_numpy(
                    init_params(cfg, gen), cfg, self.device))
            return self._model

    def _embed(self, texts: list[str]) -> np.ndarray:
        cfg, params = self._ensure_model()
        n = len(texts)
        tokens = encode_texts(texts, cfg.seq_len, cfg.vocab_size)
        with torch.inference_mode():
            if self._mesh is not None:
                padded = pad_rows(tokens, sharding_plan.serve_bucket(
                    n, self._mesh, plan=self._plan_family))
                placed = sharding_plan.sharded_params(
                    (self.checkpoint_dir or "shipped-default", self.seed),
                    params, self._mesh, self._plan_family)
                out = sharding_plan.serve_forward(
                    placed, sharding_plan.place_tokens(
                        padded, self._mesh, self._plan_family),
                    cfg, self._mesh, self._plan_family)
            else:
                padded = pad_rows(tokens, pow2_bucket(n))
                out = forward(params,
                              torch.from_numpy(padded).to(self.device), cfg)
            learned = out["embedding"][:n].float().cpu().numpy()  # unit norm

        mask = tokens > 1  # drop PAD/CLS
        rows = np.nonzero(mask)[0]
        ids = tokens[mask].astype(np.int64)
        flat = np.zeros(n * cfg.vocab_size, dtype=np.float32)
        np.add.at(flat, rows * cfg.vocab_size + ids, 1.0)
        bow = flat.reshape(n, cfg.vocab_size)
        norms = np.linalg.norm(bow, axis=1, keepdims=True)
        bow = np.where(norms > 0, bow / np.maximum(norms, 1e-9), bow)

        w = np.float32(self.learned_weight)  # float32: keep the arena fp32
        return np.concatenate([learned * np.sqrt(w),
                               bow * np.sqrt(np.float32(1.0) - w)], axis=1)

    def _embed_query(self, query: str) -> np.ndarray:
        with self._lock:
            cached = self._query_cache.get(query)
            if cached is not None:
                self._query_cache.move_to_end(query)
                self.query_cache_hits += 1
                return cached
            self.query_cache_misses += 1
        vec = self._embed([query])[0]  # slow: outside the lock
        with self._lock:
            self._query_cache[query] = vec
            while len(self._query_cache) > self._query_cache_size:
                self._query_cache.popitem(last=False)
        return vec

    # ── arena index ──────────────────────────────────────────────────

    def _reserve(self, extra: int, dim: int) -> None:
        need = self._size + extra
        if self._arena is None:
            self._arena = np.zeros((max(pow2_bucket(max(need, 1)), 64), dim),
                                   dtype=np.float32)
            return
        if need <= len(self._arena):
            return
        cap = len(self._arena)
        while cap < need:
            cap *= 2
        grown = np.zeros((cap, dim), dtype=np.float32)
        grown[:self._size] = self._arena[:self._size]
        self._arena = grown

    def sync(self, facts: list) -> int:
        if not facts:
            return 0
        with self.timer.stage("sync"):
            docs = [fact_document(f) for f in facts]
            vectors = self._embed(docs)  # slow: outside the lock
            with self._lock:
                # rows only for ids not resident yet: a full re-sync
                # takes no new row
                fresh = sum(1 for f in facts if f.id not in self._pos)
                self._reserve(fresh, vectors.shape[1])
                for fact, doc, vec in zip(facts, docs, vectors):
                    self._docs[fact.id] = doc
                    row = self._pos.get(fact.id)
                    if row is not None:  # re-sync: overwrite in place
                        self._arena[row] = vec
                        continue
                    self._arena[self._size] = vec
                    self._pos[fact.id] = self._size
                    self._ids.append(fact.id)
                    self._size += 1
                self._arena_dirty = True
        return len(facts)

    def _scores(self, q: np.ndarray, size: int) -> np.ndarray:
        """Scores of the live rows (the caller holds ``self._lock``): the
        host matmul, or with a mesh the dp-split one over the committed
        arena, padded to a dp multiple (zero rows score 0.0)."""
        if self._mesh is None:
            return self._arena[:size] @ q
        rows = sharding_plan.serve_bucket(size, self._mesh,
                                          plan=self._plan_family)
        if self._arena_dirty or self._device_arena_rows != rows:
            with self.timer.stage("shard"):
                self._device_arena = sharding_plan.place_rows(
                    pad_rows(self._arena[:size], rows), self._mesh)
                self._device_arena_rows = rows
                self._arena_dirty = False
        with torch.inference_mode():
            scores = sharding_plan.arena_scores(
                self._device_arena, torch.from_numpy(q), self._mesh)
            return scores.cpu().numpy()[:size]

    def search(self, query: str, k: int = 5) -> list[dict]:
        if self._size == 0:
            return []
        with self.timer.stage("search"):
            q = self._embed_query(query)
            with self._lock:
                size = self._size
                if size == 0:  # raced with a remove draining the arena
                    return []
                scores = self._scores(q, size)
                if 0 < k < size:
                    # every index at or above the kth score, so boundary
                    # ties are cut by (-score, id) as a full sort would
                    kth = scores[np.argpartition(-scores, k - 1)[:k]].min()
                    cand = np.nonzero(scores >= kth)[0]
                else:
                    cand = np.arange(size)
                order = sorted(cand,
                               key=lambda i: (-scores[i], self._ids[i]))[:k]
                return [{"id": self._ids[i],
                         "document": self._docs.get(self._ids[i], ""),
                         "score": float(scores[i])} for i in order]

    def remove(self, ids) -> int:
        """Drop pruned facts so search never returns them; ids already
        absent count as settled. The last live row swaps into each hole."""
        dead = set(ids)
        if not dead:
            return 0
        with self._lock:
            for fid in dead:
                self._docs.pop(fid, None)
                row = self._pos.pop(fid, None)
                if row is None:
                    continue
                last = self._size - 1
                if row != last:
                    self._arena[row] = self._arena[last]
                    moved = self._ids[last]
                    self._ids[row] = moved
                    self._pos[moved] = row
                self._ids.pop()
                self._size -= 1
            self._arena_dirty = True
        return len(dead)

    def count(self) -> int:
        return self._size


def create_embeddings(config: dict, logger,
                      http_post: Callable = _default_http_post,
                      timer: Optional[StageTimer] = None,
                      device: DeviceLike = None):
    """The backend ``config["backend"]`` names (``local`` by default), or
    None for an unknown one. ``meshServing`` builds the local backend's
    mesh now, so a config that cannot get its devices fails here:
    ``meshAxes`` (default ``["dp"]``) over ``meshShape`` (default: every
    device of ``device``'s type); one axis takes the shape's device count,
    and a shape of another rank than the axes is factored as the serve
    config's is."""
    config = config or {}
    backend = config.get("backend", "local")
    if backend == "chroma":
        return ChromaEmbeddings(config, logger, http_post)
    if backend == "local":
        mesh = None
        dev = resolve_device(device)
        if config.get("meshServing"):
            axes = tuple(config.get("meshAxes") or ("dp",))
            shape = tuple(int(s) for s in config.get("meshShape")
                          or (len(available_devices(dev)),))
            n = math.prod(shape)
            if len(axes) == 1:
                shape = (n,)
            elif len(shape) != len(axes):
                shape = _factor(n) + (1,) * (len(axes) - 2)
            mesh = cached_mesh(shape, axes, dev.type)
        return LocalEmbeddings(
            logger, checkpoint_dir=config.get("checkpointDir"), timer=timer,
            device=dev, mesh=mesh,
            plan_family=config.get("planFamily", "embeddings_forward"))
    return None
