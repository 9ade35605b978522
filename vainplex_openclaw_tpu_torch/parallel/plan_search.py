"""Sketch-constrained placement search for serving plans.

Counterpart of ``vainplex_openclaw_tpu/parallel/plan_search.py``. The
hand-written rule tables of ``parallel/plan.py`` are one point in the
placement space, chosen by reasoning; this module measures the others. A
seeded, resumable sweep per (device family, grid shape, family) writes
its winners into ``parallel/plan_table.json``, which
:func:`~.plan.serving_plan` consults.

- **Candidates**: the sketch-legal variants of the hand-written tables:
  per-site column/row/replicated splits, the :func:`~.plan.serve_bucket`
  floor (``bucket_min``); :func:`enumerate_candidates` also varies the
  gather mode, as JAX's does, but a plan's gather changes no output path
  in the port, so the sweep times each candidate in the incumbent's mode
  only (a sweep over both would time identical work). Several shapes of one
  device count sweep the dp×tp factorization; the best lands as a
  ``device_family:nN:family`` row that ``meshShape: null`` consults.
- **The communication sketch** (:class:`CommSketch`): a declared bound on
  the collectives a plan may induce. Producer→consumer pairs are Megatron
  column→row (one psum) or both replicated; loose sites (the embedding
  gather) are capped; anything else is rejected before any placement, in
  pure Python.
- **Measurement and the gate**: candidates flow through the unchanged
  port batcher and embeddings backend under :func:`~.plan.plan_override`;
  fitness is served requests/s (validator) or search queries/s
  (embeddings). A candidate wins only when it is faster than the
  hand-written incumbent by ``minGain`` AND its verdicts (or search ids)
  equal the single-device oracle's AND no kernel was built in its timed
  phase (the witness, ``analysis.witness``, where JAX counts compiles).
  The witness also reads the kernels' launch counters, and each record
  carries K1's and K2's launches beside the runner's formula
  (:func:`launches_per_forward`).

The grid: ``settings["device"]`` (default: the card; ``"cpu"`` repeats
``cpu``, as the JAX suite's virtual devices) and, for a grid larger than
the visible cards, ``settings["repeatDevice"]`` lays it over the first
card again: a harness check of the sharded arithmetic, whose rows are not
rows of a grid of distinct cards. Seeded and resumable on
``ops/search_common.py``; only a table that passes
:func:`validate_plan_table` may be written. On the card ``chip_smoke.py``
runs the search (its ``plan_search`` phase).
"""

from __future__ import annotations

import dataclasses
import itertools
import re
import time
from dataclasses import dataclass

import numpy as np

from ..ops.search_common import SweepState, config_key
from .plan import (GATHER_MODES, PLAN_TABLE, PLAN_TABLE_SCHEMA, ShardingPlan,
                   plan_axes, plan_entry_problems, spec_to_json)

# Sweep knobs, merged under the caller's settings. ``minGain`` keeps noise
# out of the table: a candidate must beat the incumbent by the margin.
# ``budgetS`` bounds one (family, shape) loop; on expiry the rest are
# counted as skipped and the next point still runs. ``device`` and
# ``repeatDevice`` (the port's) place the grid (module docstring).
PLAN_SEARCH_DEFAULTS = {
    "families": ("encoder_validator", "embeddings_forward"),
    "shapes": ((1, 1), (2, 1), (2, 4)),
    "requests": 32,
    "concurrency": 8,
    "maxBatch": 16,
    "windowMs": 0.5,
    "facts": 48,
    "queries": 12,
    "bucketMins": (1, 2, 4),
    "minGain": 0.05,
    "budgetS": None,
    "seed": 0,
    "device": None,
    "repeatDevice": False,
}


# ── communication sketches ───────────────────────────────────────────

#: split choices per site → the spec fragment they compile to.
_CHOICE_SPECS = {"col": (None, "tp"), "row": ("tp", None), "rep": ()}

#: encoder sites: (site, choices, rule patterns the choice governs), in
#: the order of ENCODER_VALIDATOR_RULES.
_ENCODER_SITES = (
    ("qkv", ("col", "rep"), ("attn/q$", "attn/k$", "attn/v$")),
    ("o", ("row", "rep"), ("attn/o$",)),
    ("w1", ("col", "rep"), ("mlp/w1$",)),
    ("w2", ("row", "rep"), ("mlp/w2$",)),
    ("embed", ("col", "rep"), ("embed/tok$", "embed/pos$")),
)


@dataclass(frozen=True)
class CommSketch:
    """A declared bound on the collectives a plan may induce.

    ``pairs``: (producer, consumer) sites whose splits must be one of
    ``allowed_pairs``; ``loose_sites`` may each add one gather, at most
    ``max_loose_collectives`` in all; every site the sketch does not name
    stays replicated. ``sites``: structural splits that select a rule
    table without a pairwise collective (the pipeline's stages, the MoE
    experts); ``declared``: the collectives the family's runner induces by
    construction, which ride into every candidate and the table row."""

    family: str
    pairs: tuple = ()
    allowed_pairs: tuple = ()
    loose_sites: tuple = ()
    loose_allowed: tuple = ("rep",)
    max_loose_collectives: int = 0
    sites: tuple = ()
    declared: tuple = ()


SKETCHES = {
    "encoder_validator": CommSketch(
        family="encoder_validator",
        pairs=(("qkv", "o"), ("w1", "w2")),
        allowed_pairs=(("col", "row"), ("rep", "rep")),
        loose_sites=("embed",),
        loose_allowed=("col", "rep"),
        max_loose_collectives=1),
    # data parallel by contract: a sharded-weights candidate is enumerated
    # and always rejected
    "embeddings_forward": CommSketch(family="embeddings_forward"),
    "encoder_validator_pp": CommSketch(
        family="encoder_validator_pp",
        sites=(("stages", ("pp",)),),
        declared=(("ppermute", "wavefront"),)),
    "encoder_validator_long": CommSketch(
        family="encoder_validator_long",
        sites=(("weights", ("rep",)),),
        declared=(("psum", "pool"),)),
    "encoder_validator_moe": CommSketch(
        family="encoder_validator_moe",
        sites=(("experts", ("ep", "rep")),),
        declared=(("psum", "expert_combine"),)),
    "embeddings_forward_moe": CommSketch(
        family="embeddings_forward_moe",
        sites=(("experts", ("ep", "rep")),),
        declared=(("psum", "expert_combine"),)),
}


def sketch_check(family: str, assignment: tuple,
                 mesh_shape: tuple) -> tuple:
    """(legal, reason, collectives) for one split assignment, in pure
    Python: ``collectives`` is the (kind, site) signature the plan would
    induce on the model axis."""
    sketch = SKETCHES[family]
    a = dict(assignment)
    covered = {s for pair in sketch.pairs for s in pair}
    covered |= set(sketch.loose_sites)
    covered |= {s for s, _allowed in sketch.sites}
    for site, choice in assignment:
        if site not in covered and choice != "rep":
            return (False, f"{site}={choice}: site outside the sketch's "
                           f"declared collective pattern must stay "
                           f"replicated", [])
    for site, allowed in sketch.sites:
        choice = a.get(site, allowed[0])
        if choice not in allowed:
            return (False, f"{site}={choice} not in the sketch's allowed "
                           f"structural choices {allowed}", [])
    colls: list = list(sketch.declared)
    for prod_site, cons_site in sketch.pairs:
        pat = (a.get(prod_site, "rep"), a.get(cons_site, "rep"))
        if pat not in sketch.allowed_pairs:
            return (False, f"{prod_site}={pat[0]} → {cons_site}={pat[1]} "
                           f"is not an allowed producer→consumer pattern "
                           f"(sketch allows {sketch.allowed_pairs})", [])
        if pat != ("rep", "rep"):
            colls.append(("psum", f"{prod_site}->{cons_site}"))
    n_loose = 0
    for site in sketch.loose_sites:
        choice = a.get(site, "rep")
        if choice not in sketch.loose_allowed:
            return (False, f"{site}={choice} not in the sketch's allowed "
                           f"loose choices {sketch.loose_allowed}", [])
        if choice != "rep":
            n_loose += 1
            colls.append(("all_gather", site))
    if n_loose > sketch.max_loose_collectives:
        return (False, f"{n_loose} loose collectives exceed the sketch "
                       f"bound {sketch.max_loose_collectives}", [])
    return True, "", colls


# ── candidate enumeration ────────────────────────────────────────────


@dataclass(frozen=True)
class PlanCandidate:
    cand_id: str
    family: str
    plan: ShardingPlan
    assignment: tuple = ()
    collectives: tuple = ()  # the sketch's (kind, site) signature


def _cand_id(assignment: tuple, bucket_min: int, gather: str) -> str:
    sites = ",".join(f"{s}={c}" for s, c in assignment)
    return f"{sites}|bm{bucket_min}|{gather}"


def _assignments(family: str, mesh_shape: tuple) -> list:
    """Every split assignment for one family on one grid shape (legality
    is applied after, so the sweep can report what the sketch pruned)."""
    if family == "embeddings_forward":
        return [(("weights", "rep"),), (("weights", "split"),)]
    if family in ("encoder_validator_moe", "embeddings_forward_moe"):
        return [(("experts", "ep"),), (("experts", "rep"),)]
    if family == "encoder_validator_pp":
        return [(("stages", "pp"),)]
    if family == "encoder_validator_long":
        return [(("weights", "rep"),)]
    tp = int(mesh_shape[1]) if len(mesh_shape) > 1 else 1
    if tp <= 1:
        # a model axis of 1: every split is replication
        return [tuple((site, "rep") for site, _, _ in _ENCODER_SITES)]
    names = [site for site, _, _ in _ENCODER_SITES]
    choice_lists = [choices for _, choices, _ in _ENCODER_SITES]
    return [tuple(zip(names, combo))
            for combo in itertools.product(*choice_lists)]


def _candidate_plan(family: str, assignment: tuple, bucket_min: int,
                    gather: str) -> ShardingPlan:
    a = dict(assignment)
    desc = "plan-search candidate " + _cand_id(assignment, bucket_min, gather)
    if family in ("encoder_validator_moe", "embeddings_forward_moe"):
        base = PLAN_TABLE[family]
        return dataclasses.replace(
            base,
            rules=base.rules if a.get("experts", "ep") == "ep"
            else (("", ()),),
            bucket_min=int(bucket_min), gather=gather, description=desc,
            source="candidate")
    if family in ("encoder_validator_pp", "encoder_validator_long"):
        # one structural configuration each; a pipeline's microbatch count
        # is its bucket floor
        base = PLAN_TABLE[family]
        return dataclasses.replace(
            base, bucket_min=int(bucket_min),
            microbatches=int(bucket_min) if base.runner == "pipeline"
            else base.microbatches,
            gather=gather, description=desc, source="candidate")
    if family == "embeddings_forward":
        spec = () if a.get("weights", "rep") == "rep" else ("dp", None)
        rules: tuple = (("", spec),)
        axes: tuple = ("dp",)
    else:
        out = []
        for site, _choices, patterns in _ENCODER_SITES:
            spec = _CHOICE_SPECS[a.get(site, "rep")]
            out.extend((pat, spec) for pat in patterns)
        out.append(("", ()))
        rules, axes = tuple(out), ("dp", "tp")
    return ShardingPlan(
        family=family, rules=rules, data_spec=("dp",), axes=axes,
        description=desc, bucket_min=int(bucket_min), gather=gather,
        source="candidate")


def enumerate_candidates(family: str, mesh_shape: tuple,
                         bucket_mins: tuple = (1, 2, 4),
                         gathers: "tuple | None" = None) -> tuple:
    """(candidates, rejected) for one (family, grid shape). The
    hand-written incumbent is always candidate 0; a sketch-illegal
    assignment is rejected once, before any bucket/gather variant, as an
    ``{"assignment", "reason"}`` record. ``gathers`` narrows the gather
    modes a forward runner's candidates take (default: JAX's, all of
    ``GATHER_MODES``)."""
    base = PLAN_TABLE[family]
    cands = [PlanCandidate("incumbent", family, base,
                           collectives=tuple(
                               SKETCHES[family].declared
                               if family in SKETCHES else ()))]
    rejected: list = []
    # runners other than "forward" own their gather by construction
    if base.runner != "forward":
        gathers = (base.gather,)
    elif gathers is None:
        gathers = GATHER_MODES
    for assignment in _assignments(family, mesh_shape):
        legal, reason, colls = sketch_check(family, assignment, mesh_shape)
        if not legal:
            rejected.append({"assignment": dict(assignment),
                             "reason": reason})
            continue
        for bm in bucket_mins:
            for gather in gathers:
                plan = _candidate_plan(family, assignment, bm, gather)
                if plan.rules == base.rules and bm == base.bucket_min \
                        and gather == base.gather:
                    continue  # the incumbent itself
                cands.append(PlanCandidate(
                    _cand_id(assignment, bm, gather), family, plan,
                    tuple(assignment), tuple(colls)))
    return cands, rejected


# ── seeded fixtures ──────────────────────────────────────────────────


class _NullLog:
    def info(self, *_a):
        pass
    warn = error = info


def _seeded_texts(n: int, seed: int) -> list:
    """The validator mix (seeded plain message texts, JAX's)."""
    rng = np.random.default_rng(seed)
    subjects = ("deploy", "quarterly report", "incident", "migration",
                "customer email", "release", "audit", "benchmark")
    verbs = ("completed", "failed", "regressed", "crashed", "improved",
             "shipped", "stalled", "recovered")
    return [f"The {rng.choice(subjects)} {rng.choice(verbs)} with code "
            f"{int(rng.integers(0, 500))}; throughput changed "
            f"{int(rng.integers(-60, 90))}%." for _ in range(n)]


def _synth_facts(n: int, seed: int) -> list:
    from types import SimpleNamespace

    rng = np.random.default_rng(seed + 1)
    subj = ("deploy", "db", "api", "release", "pipeline", "cache")
    preds = ("failed-with", "depends-on", "improved", "blocked-by")
    return [SimpleNamespace(
        id=f"f{i}", subject=str(rng.choice(subj)),
        predicate=str(rng.choice(preds)),
        object=f"thing-{int(rng.integers(0, 60))}",
        source="plan-search", created_at="2026-08-03") for i in range(n)]


def _seeded_queries(n: int, seed: int) -> list:
    """Distinct query texts (seeded): each timed search misses the query
    cache."""
    rng = np.random.default_rng(seed + 2)
    subj = ("deploy", "db", "api", "release", "pipeline", "cache")
    preds = ("failed", "depends", "improved", "blocked")
    return [f"{rng.choice(subj)} {rng.choice(preds)} thing-{i}"
            for i in range(n)]


# ── one measured candidate ───────────────────────────────────────────


def _grid(mesh_shape: tuple, axes: tuple, scfg: dict):
    """The candidate's grid on the search's device: distinct devices of
    its type, or with ``repeatDevice`` the first one repeated."""
    from ..device import resolve_device
    from .mesh import cached_mesh, make_mesh

    dev = resolve_device(scfg.get("device"))
    if scfg.get("repeatDevice"):
        return make_mesh(axes=axes, shape=tuple(mesh_shape),
                         devices=[dev] * int(np.prod(mesh_shape)))
    return cached_mesh(tuple(mesh_shape), axes, dev.type)


def _rule_spec(rules: tuple, path: str) -> tuple:
    """The spec the first rule matching ``path`` gives."""
    return next((tuple(spec) for pat, spec in rules
                 if re.search(pat, path)), ())


def launches_per_forward(plan: ShardingPlan, mesh, cfg) -> tuple:
    """(kernel, launches) of one forward of ``plan``'s runner on ``mesh``
    (the mesh phases' formulas): ``"forward"`` runs K1 n_layers × dp ×
    min(tp, heads) times when its rules split attention over the column
    axis, else n_layers × dp; ``"pipeline"`` K1 n_layers × microbatches;
    ``"long"`` K2 n_layers × dp × sp²."""
    row, col = plan_axes(plan)
    dp = mesh.shape.get(row, 1) if row else 1
    if plan.runner == "pipeline":
        return "k1", cfg.n_layers * int(plan.microbatches)
    if plan.runner == "long":
        return "k2", cfg.n_layers * dp * mesh.shape[col] ** 2
    split = col is not None and col in _rule_spec(plan.rules,
                                                  "blocks/0/attn/q")
    per_row = min(mesh.shape[col], cfg.n_heads) if split else 1
    return "k1", cfg.n_layers * dp * per_row


def _expected_launches(plans: dict, runs: dict, mesh, cfg,
                       on_card: bool) -> dict:
    """``{"k1": n, "k2": n}`` the runs of each runner (``runs``, from the
    batcher's ``mesh_runs``) launch on the card (0 on the CPU)."""
    want = {"k1": 0, "k2": 0}
    for runner, n in runs.items():
        if n and runner in plans:
            kernel, per = launches_per_forward(plans[runner], mesh, cfg)
            want[kernel] += per * n
    return want if on_card else {"k1": 0, "k2": 0}


def _measure_validator(plan: ShardingPlan, mesh_shape: tuple, scfg: dict,
                       fx: dict, clock, family: str = "encoder_validator",
                       ) -> dict:
    import threading

    from ..analysis import RetraceWitness
    from ..models.batching import ContinuousBatcher
    from ..models.pretrained import load_pretrained
    from . import plan as sharding_plan

    texts, ref = fx["texts"], fx["ref"]
    mesh = _grid(mesh_shape, tuple(plan.axes), scfg)
    dev = mesh.devices[0]
    loaded = load_pretrained(None, device=dev)
    if loaded is None:
        raise RuntimeError("plan_search: no shipped checkpoint")
    cfg = loaded[0]
    n = len(texts)
    plans = {plan.runner: plan}
    if plan.runner == "long":
        plans["forward"] = sharding_plan.short_path_plan(plan)
    with sharding_plan.plan_override(family, plan):
        # Warm every bucket this plan can form (its bucket_min moves the
        # floor) through a stepped batcher on the same grid: the
        # placements it caches are the ones the timed batcher finds.
        warm = ContinuousBatcher(max_batch=int(scfg.get("maxBatch")),
                                 window_ms=0.0, autostart=False, device=dev,
                                 mesh=mesh, plan_family=family)
        try:
            for b in range(1, warm.max_batch + 1):
                for _ in range(b):
                    warm.enqueue("warmup")
                warm.step()
        finally:
            warm.close()
        batcher = ContinuousBatcher(max_batch=int(scfg.get("maxBatch")),
                                    window_ms=float(scfg.get("windowMs")),
                                    device=dev, mesh=mesh,
                                    plan_family=family)
        try:
            witness = RetraceWitness.armed()
            base = witness.baseline()
            runs0 = dict(batcher.mesh_runs)
            results: list = [None] * n
            errors: list = [None] * n
            nxt = {"i": 0}
            ilock = threading.Lock()

            def worker():
                while True:
                    with ilock:
                        i = nxt["i"]
                        if i >= n:
                            return
                        nxt["i"] = i + 1
                    try:
                        results[i] = batcher.submit(texts[i])
                    except Exception as exc:  # noqa: BLE001 — surfaced below
                        errors[i] = exc

            t0 = clock()
            threads = [threading.Thread(target=worker)
                       for _ in range(max(1, int(scfg.get("concurrency"))))]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            dt = clock() - t0
            failed = [e for e in errors if e is not None]
            if failed:
                raise RuntimeError(
                    f"{len(failed)}/{n} submits raised") from failed[0]
            runs = {r: batcher.mesh_runs[r] - runs0.get(r, 0)
                    for r in batcher.mesh_runs}
            want = _expected_launches(plans, runs, mesh, cfg,
                                      dev.type == "cuda")
            q = batcher.timer.quantiles()
            return {
                "rps": round(n / dt, 2),
                "mismatches": sum(1 for a, b in zip(results, ref) if a != b),
                "retraces": witness.traces("builds") - base["builds"],
                "k1_launches": witness.launched("k1"),
                "k2_launches": witness.launched("k2"),
                "k1_expected": want["k1"], "k2_expected": want["k2"],
                "mean_batch": batcher.stats()["meanBatch"],
                "shard_ms_p95": (q.get("shard") or {}).get("p95"),
                "gather_ms_p95": (q.get("gather") or {}).get("p95"),
            }
        finally:
            batcher.close()


def _measure_embeddings(plan: ShardingPlan, mesh_shape: tuple, scfg: dict,
                        fx: dict, clock,
                        family: str = "embeddings_forward") -> dict:
    from ..analysis import RetraceWitness
    from ..knowledge.embeddings import LocalEmbeddings
    from . import plan as sharding_plan

    facts, queries, ref = fx["facts"], fx["queries"], fx["ref_search"]
    n = int(np.prod(mesh_shape))
    axes = tuple(plan.axes)
    mesh = _grid((n,) if len(axes) == 1 else tuple(mesh_shape), axes, scfg)
    with sharding_plan.plan_override(family, plan):
        emb = LocalEmbeddings(_NullLog(), device=mesh.devices[0], mesh=mesh,
                              plan_family=family)
        t0 = clock()
        emb.sync(facts)  # untimed: model load, placement, arena
        sync_s = clock() - t0
        # warm the query forward and the arena scores with queries outside
        # the timed set (the timed queries must miss the query cache)
        emb.search("plan search warmup one", k=5)
        emb.search("plan search warmup two", k=5)
        cfg = emb._ensure_model()[0]
        witness = RetraceWitness.armed()
        base = witness.baseline()
        t0 = clock()
        got = [emb.search(q_text, k=5) for q_text in queries]
        dt = clock() - t0
        mism = sum(1 for g, r in zip(got, ref)
                   if [x["id"] for x in g] != [x["id"] for x in r])
        score_dev = 0.0
        for g, r in zip(got, ref):
            if g and r:
                score_dev = max(score_dev, max(
                    abs(x["score"] - y["score"]) for x, y in zip(g, r)))
        # one query forward per timed search
        want = _expected_launches({plan.runner: plan},
                                  {plan.runner: len(queries)}, mesh, cfg,
                                  mesh.devices[0].type == "cuda")
        q = emb.timer.quantiles()
        return {
            "rps": round(len(queries) / dt, 2),
            "mismatches": mism,
            "search_score_dev": round(float(score_dev), 6),
            "retraces": witness.traces("builds") - base["builds"],
            "k1_launches": witness.launched("k1"),
            "k2_launches": witness.launched("k2"),
            "k1_expected": want["k1"], "k2_expected": want["k2"],
            "sync_facts_s": round(len(facts) / sync_s, 1) if sync_s else None,
            "shard_ms_p95": (q.get("shard") or {}).get("p95"),
            "gather_ms_p95": None,
        }


def measure_candidate(family: str, plan: ShardingPlan, mesh_shape: tuple,
                      scfg: dict, fixtures: dict,
                      clock=time.perf_counter) -> dict:
    """Fitness of one candidate through the unchanged serving machinery
    (``plan_override`` → ``ContinuousBatcher`` / ``LocalEmbeddings``). The
    record's ``rps`` is its done-field; a failure comes back as an
    ``{"error": …}`` record: a failed candidate is data."""
    from . import plan as sharding_plan

    # placements are keyed by plan; drop the last candidate's
    sharding_plan.clear_plan_caches()
    rec: dict = {"family": family, "mesh_shape": list(mesh_shape)}
    t0 = clock()
    try:
        if family.startswith("embeddings_forward"):
            rec.update(_measure_embeddings(plan, mesh_shape, scfg,
                                           fixtures, clock, family=family))
        else:
            rec.update(_measure_validator(plan, mesh_shape, scfg,
                                          fixtures, clock, family=family))
    except Exception as exc:  # noqa: BLE001 — a rejected candidate is data
        rec["error"] = str(exc)[:200]
    rec["elapsed_s"] = round(clock() - t0, 2)
    return rec


# ── the search loop ──────────────────────────────────────────────────


def search(settings: "dict | None" = None, *,
           state_path: "str | None" = None, log=None,
           clock=time.perf_counter) -> dict:
    """Sweep every sketch-legal candidate per (family, grid shape); returns
    ``{"device_family", "seed", "sweeps", "factorizations"}``.

    ``state_path`` makes the sweep resumable: finished points are read
    back, error records measured again. The gate per point: faster than
    the incumbent's rps by ``minGain`` AND oracle parity AND zero builds
    while timed; anything else keeps the hand-written plan."""
    from ..device import backend_family, resolve_device
    from .mesh import available_devices

    scfg = {**PLAN_SEARCH_DEFAULTS, **(settings or {})}
    dev = resolve_device(scfg.get("device"))
    seed = int(scfg.get("seed"))
    families = tuple(scfg.get("families"))
    shapes = tuple(tuple(int(x) for x in s) for s in scfg.get("shapes"))
    bucket_mins = tuple(int(b) for b in scfg.get("bucketMins"))
    budget_s = scfg.get("budgetS")
    min_gain = float(scfg.get("minGain"))
    fam_dev = backend_family(dev)
    state = SweepState(state_path, done_field="rps")

    need = max(int(np.prod(s)) for s in shapes)
    have = len(available_devices(dev))
    if have < need and not scfg.get("repeatDevice"):
        raise RuntimeError(
            f"plan_search: the largest shape needs {need} devices, "
            f"{have} {dev.type} devices are visible (repeatDevice lays a "
            f"grid over the first one again)")

    # single-device oracle references, computed once
    fixtures: dict = {}
    if any(f.startswith("encoder_validator") for f in families):
        from ..models.serve import make_local_call_llm

        texts = _seeded_texts(int(scfg.get("requests")), seed)
        oneshot = make_local_call_llm(
            serve_cfg={"continuousBatching": False}, device=dev)
        fixtures["texts"] = texts
        fixtures["ref"] = [oneshot(t) for t in texts]
    if any(f.startswith("embeddings_forward") for f in families):
        from ..knowledge.embeddings import LocalEmbeddings

        facts = _synth_facts(int(scfg.get("facts")), seed)
        queries = _seeded_queries(int(scfg.get("queries")), seed)
        oracle = LocalEmbeddings(_NullLog(), device=dev)
        oracle.sync(facts)
        fixtures["facts"] = facts
        fixtures["queries"] = queries
        fixtures["ref_search"] = [oracle.search(q, k=5) for q in queries]

    sweeps: dict = {}
    for family in families:
        seen: set = set()
        for shape in shapes:
            # dp-only embeddings grids are 1-D: (2, 4) collapses to (8,)
            mesh_shape = (int(np.prod(shape)),) \
                if family == "embeddings_forward" else shape
            if mesh_shape in seen:
                continue
            seen.add(mesh_shape)
            key = (f"{fam_dev}:"
                   f"{'x'.join(str(s) for s in mesh_shape)}:{family}")
            # a plan's gather changes no output path in the port: sweep
            # only the incumbent's
            cands, rejected = enumerate_candidates(
                family, mesh_shape, bucket_mins,
                (PLAN_TABLE[family].gather,))
            t_point = clock()
            skipped = 0
            measured: list = []
            warmed = False
            for i, cand in enumerate(cands):
                pkey = config_key(f"{key}:{cand.cand_id}",
                                  ("req", len(fixtures.get("texts") or [])
                                   if family == "encoder_validator"
                                   else len(fixtures.get("queries") or [])),
                                  ("seed", seed))
                prior = state.finished(pkey)
                if prior is not None:
                    rec = prior
                elif budget_s and i > 0 \
                        and clock() - t_point > float(budget_s):
                    skipped += 1
                    continue
                else:
                    if not warmed:
                        # one discarded measurement per point: the first
                        # run on a shape pays one-time costs
                        measure_candidate(family, cand.plan, mesh_shape,
                                          scfg, fixtures, clock=clock)
                        warmed = True
                    rec = measure_candidate(family, cand.plan, mesh_shape,
                                            scfg, fixtures, clock=clock)
                    rec["candidate"] = cand.cand_id
                    state.record(pkey, rec)
                measured.append((cand, rec))
                if log is not None:
                    log(f"plan_search {key} {cand.cand_id}: "
                        f"{rec.get('rps', rec.get('error'))}")
            baseline = measured[0][1] if measured else None
            best_cand, best = measured[0] if measured else (None, None)
            if baseline is not None and baseline.get("rps") is not None:
                floor = baseline["rps"] * (1.0 + min_gain)
                for cand, rec in measured[1:]:
                    # the gate: faster by minGain AND oracle parity AND no
                    # build while timed
                    if rec.get("rps") is None or rec.get("retraces") != 0 \
                            or rec.get("mismatches", 1) != 0:
                        continue
                    if rec["rps"] >= floor and rec["rps"] > best["rps"]:
                        best_cand, best = cand, rec
            improved = best is not None and best is not baseline
            res = {"family": family, "mesh_shape": list(mesh_shape),
                   "baseline": baseline, "best": best,
                   "candidates": [r for _, r in measured],
                   "improved": improved,
                   "sketch_rejected": len(rejected),
                   "rejected": rejected,
                   "skipped_candidates": skipped,
                   "partial": bool(skipped)}
            if improved:
                res["entry"] = entry_from_plan(
                    best_cand.plan, best, baseline, seed,
                    collectives=best_cand.collectives)
            sweeps[key] = res

    # the best dp×tp factorization per device count, for the base encoder
    # family: the nN rows meshShape: null consults
    factorizations: dict = {}
    for family in families:
        if family != "encoder_validator":
            continue
        by_n: dict = {}
        for res in sweeps.values():
            if res["family"] != family:
                continue
            rps = (res.get("best") or {}).get("rps")
            if rps is None:
                continue
            n = int(np.prod(res["mesh_shape"]))
            by_n.setdefault(n, []).append((rps, tuple(res["mesh_shape"])))
        for n, points in by_n.items():
            if n < 2 or len(points) < 2:
                continue  # one shape says nothing about factorization
            rps, shape = max(points)
            ranked = ",".join("x".join(str(x) for x in s)
                              for _, s in sorted(points, reverse=True))
            factorizations[f"{fam_dev}:n{n}:{family}"] = {
                "mesh_shape": [int(x) for x in shape],
                "rps": rps,
                "source": f"plan_search seed={seed}: best of {ranked}",
            }
    return {"device_family": fam_dev, "seed": seed, "sweeps": sweeps,
            "factorizations": factorizations}


# ── table emission and the gate ──────────────────────────────────────


def entry_from_plan(plan: ShardingPlan, rec: dict, baseline: dict,
                    seed: int, collectives: tuple = ()) -> dict:
    """The plan-table-v1 row of one winning candidate: the serialization
    twin of ``plan._plan_from_entry``."""
    entry = {
        "rules": [[pat, spec_to_json(spec)] for pat, spec in plan.rules],
        "data_spec": spec_to_json(plan.data_spec),
        "axes": list(plan.axes),
        "bucket_min": int(plan.bucket_min),
        "gather": plan.gather,
        "rps": rec.get("rps"),
        "baseline_rps": (baseline or {}).get("rps"),
        "candidate": rec.get("candidate"),
        "source": f"plan_search seed={seed} "
                  f"gate=faster+parity+zero-retraces",
    }
    if plan.runner != "forward":
        entry["runner"] = plan.runner
    if plan.microbatches:
        entry["microbatches"] = int(plan.microbatches)
    if collectives:
        entry["collectives"] = [[kind, site] for kind, site in collectives]
    return entry


def to_table(results: dict, base_table: "dict | None" = None) -> dict:
    """Merge sweep winners into a plan-table dict (schema v1). Only
    improved points land (the hand-written rules need no row); rows of
    other shapes and device families survive."""
    base = base_table or {}
    table = {"schema": PLAN_TABLE_SCHEMA,
             "provenance": dict(base.get("provenance") or {}),
             "entries": dict(base.get("entries") or {})}
    table["provenance"]["generator"] = \
        "python3 chip_smoke.py (phase plan_search: plan_search.search)"
    table["provenance"]["gate"] = (
        "faster than the hand-written incumbent AND single-device oracle "
        "parity AND zero builds in the timed phase")
    for key, res in (results.get("sweeps") or {}).items():
        ent = res.get("entry")
        if res.get("improved") and ent is not None:
            table["entries"][key] = ent
    for key, ent in (results.get("factorizations") or {}).items():
        table["entries"][key] = {"mesh_shape": ent["mesh_shape"],
                                 "rps": ent.get("rps"),
                                 "source": ent.get("source")}
    return table


def write_table(table: dict, path: str) -> str:
    import json
    import os

    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(table, f, indent=1)
        f.write("\n")
    os.replace(tmp, path)
    return path


def validate_plan_table(table) -> list:
    """Findings for a plan table (empty: clean), as JAX's gate gives
    them; per-row problems come from ``plan_entry_problems``, the
    loader's own test."""
    findings: list = []
    if not isinstance(table, dict):
        return ["table is not an object"]
    if table.get("schema") != PLAN_TABLE_SCHEMA:
        findings.append(f"unknown schema {table.get('schema')!r}")
    entries = table.get("entries")
    if not isinstance(entries, dict) or not entries:
        findings.append("no entries")
        return findings
    for key, ent in entries.items():
        parts = key.split(":")
        if len(parts) != 3:
            findings.append(f"{key}: key is not device_family:shape:family")
            continue
        family = parts[2]
        if family not in PLAN_TABLE:
            findings.append(f"{key}: unknown servable family {family!r} "
                            f"(known: {sorted(PLAN_TABLE)})")
        for p in plan_entry_problems(ent):
            findings.append(f"{key}: {p}")
        if not isinstance(ent, dict):
            continue
        if parts[1][:1] == "n" and parts[1][1:].isdigit():
            n = int(parts[1][1:])
            ms = ent.get("mesh_shape")
            if "mesh_shape" not in ent:
                findings.append(f"{key}: device-count key without a "
                                f"mesh_shape")
            elif isinstance(ms, list) and ms \
                    and all(isinstance(x, int) for x in ms) \
                    and int(np.prod(ms)) != n:
                findings.append(f"{key}: mesh_shape {ms} does not factor "
                                f"{n} devices")
            continue
        try:
            shape = tuple(int(x) for x in parts[1].split("x"))
        except ValueError:
            findings.append(f"{key}: shape {parts[1]!r} is not x-joined "
                            f"ints")
            continue
        if "mesh_shape" in ent:
            findings.append(f"{key}: shape key carrying a factorization "
                            f"entry (mesh_shape belongs under nN keys)")
            continue
        if any(s < 1 for s in shape):
            findings.append(f"{key}: shape {shape} has a dim < 1")
        axes = ent.get("axes")
        if isinstance(axes, list) and axes and len(axes) != len(shape):
            findings.append(f"{key}: {len(axes)} axes vs "
                            f"{len(shape)}-d shape {parts[1]}")
    return findings
