"""JIT_TABLE: the declarative registry of the port's per-call compute roots.

Counterpart of ``vainplex_openclaw_tpu/analysis/jit_table.py``, under the
same names (:data:`JIT_TABLE`, :class:`JitEntry`) and with one row per JAX
row, each pointed at the port's counterpart. The port never traces, so
the words keep their roles with a torch meaning:

- a "jit body" (``jit_fns``) is a function that runs on every call over
  device tensors: a host sync inside it (``.item()``, ``.cpu()``, a Python
  branch on a tensor's value) stalls the served path until the card
  drains, and an unseeded draw in it breaks the port's rule of explicit
  ``torch.Generator`` s (:mod:`.tracing`);
- ``static`` names parameters that are host metadata (a config, a mesh, a
  tile pair), on which Python control flow is legal;
- ``builders`` are the sanctioned build and load sites: ``ops/_build.py``'s
  :func:`build` and :func:`load_library` (the one place ``nvcc`` runs and
  libraries are cached per (name, defines)), and the kernel search's
  measurement, which builds one library per candidate on purpose. A build
  reached per call anywhere else would run ``nvcc`` at serve time
  (:mod:`.retrace`);
- ``BUCKETED`` still means the wrapper routes batch dims through the
  port's ``pow2_bucket``/``pad_rows``, so the served shapes, and with them
  the kernel's tile lookups (``launch_tiles``) and any library they key,
  stay O(log N); ``FIXED`` needs a reviewable rationale, as in JAX.
"""

from __future__ import annotations

from dataclasses import dataclass, field

#: shape policies an entry may declare
BUCKETED = "bucketed"   # wrapper routes shapes through pow2_bucket/pad_rows
FIXED = "fixed"         # shapes bounded by construction; rationale required


@dataclass(frozen=True)
class JitEntry:
    """One per-call compute root and its shape/staticness contract.

    ``jit_fns`` are dotted names of bodies that run per call on device
    tensors (nested functions as ``outer.inner``, methods as
    ``Class.method``); the tracing pass expands them through the
    same-module call graph, so helpers only reachable from such a body are
    scanned without being listed. ``static`` names parameters (matched BY
    NAME anywhere in the expansion) that are host metadata — Python
    control flow on them is legal. ``entry_names`` are the public
    callables whose *callers* own the shape discipline; every package call
    site must bucket, be a declared ``fixed_caller``, or itself be a
    per-call body. ``builders`` may build or load kernels (memoized, or a
    deliberate experiment); anywhere else a build inside a plain function
    is flagged as a per-call build.
    """

    module: str                      # repo-relative posix path
    jit_fns: tuple = ()              # per-call bodies (dotted names)
    static: tuple = ()               # static param names (by name)
    wrapper: str = ""                # bucketing wrapper (for BUCKETED)
    shape_policy: str = BUCKETED
    rationale: str = ""              # required when shape_policy == FIXED
    builders: tuple = ()             # sanctioned build/load sites
    entry_names: tuple = ()          # callables whose callers own shapes
    # ((module, function, rationale), ...) — call sites exempt from the
    # bucketing requirement; an empty rationale is itself a finding.
    fixed_callers: tuple = field(default_factory=tuple)


_PKG = "vainplex_openclaw_tpu_torch"

JIT_TABLE: tuple[JitEntry, ...] = (
    JitEntry(
        # JAX: _jaccard_matrix_jax_impl, built lazily by
        # _jaccard_matrix_jax. The port's block is plain torch on the
        # device: nothing to build, so no builder.
        module=f"{_PKG}/ops/similarity.py",
        jit_fns=("_jaccard_block",),
        wrapper="jaccard_from_rows",
        shape_policy=BUCKETED,
    ),
    JitEntry(
        # JAX: _batch_levenshtein_jax.one_pair. The port's body is K3's
        # wrapper (levenshtein_rows → _launch on the card, the plain DP on
        # the CPU); K3's library load goes through _build.load_library.
        module=f"{_PKG}/ops/similarity.py",
        jit_fns=("levenshtein_rows",),
        wrapper="batch_levenshtein_ratio",
        shape_policy=BUCKETED,
    ),
    JitEntry(
        module=f"{_PKG}/ops/flash_attention.py",
        jit_fns=("flash_attention", "_Flash.forward", "_Flash.backward"),
        static=("causal", "block_q", "block_k", "return_stats", "tiles",
                "scale", "ctx",
                # default_block/table_entry/launch_tiles run on Python
                # values only: L is the shape int, side/dtype/family/path
                # select a searched-table entry; Dh/width are head dims.
                "L", "Lq", "Lk", "side", "dtype", "family", "path", "Dh",
                "width"),
        wrapper="flash_attention",
        shape_policy=FIXED,
        rationale="pads any head dim to a compiled width and takes any "
                  "length (ragged keys masked by the bias row), so the "
                  "libraries it loads are keyed only by the tiles of the "
                  "searched block table (ops/flash_block_table.json, "
                  "launch_tiles memoized per (Lq, Lk, dtype)) plus the "
                  "wide library, not by caller shape diversity",
        entry_names=("flash_attention",),
        fixed_callers=(
            (f"{_PKG}/ops/kernel_search.py", "parity_errors",
             "offline kernel search: each probe's shape is pinned by its "
             "(L, block) search point from a bounded candidate list"),
        ),
    ),
    JitEntry(
        # Offline kernel-search probes: measure_point builds one library
        # per candidate ON PURPOSE — a fresh build per point IS the
        # experiment; the build witness lives inside measure_point (over
        # the timed rounds), not in the builder.
        module=f"{_PKG}/ops/kernel_search.py",
        jit_fns=("_chain",),
        static=("tiles", "steps", "L", "block_q", "block_k", "dtype",
                "seed", "B", "H", "Dh"),
        shape_policy=FIXED,
        rationale="every probe shape is pinned by its (L, block) search "
                  "point; the sweep enumerates a bounded candidate list "
                  "and each point's single build is excluded from its "
                  "timed rounds",
        builders=("measure_point",),
    ),
    JitEntry(
        # The build and load sites themselves (no JAX row: JAX's cache is
        # jit's). load_library memoizes per (name, defines) under a lock,
        # and builds only a library that is not on disk yet.
        module=f"{_PKG}/ops/_build.py",
        builders=("build", "load_library"),
        shape_policy=FIXED,
        rationale="libraries are keyed by (source, defines); the defines "
                  "come from the tiles of the searched block table or the "
                  "fixed wide set, so a served path loads a bounded set "
                  "and builds each at most once per checkout",
        entry_names=("load_library",),
    ),
    JitEntry(
        module=f"{_PKG}/models/encoder.py",
        jit_fns=("forward",),
        # prefix: flatten_tree's path string (the port flattens the
        # parameter tree by path where JAX walks a pytree)
        static=("cfg", "impl", "n_heads", "prefix"),
        shape_policy=FIXED,
        rationale="seq_len is fixed by config; the batch dim is owned per "
                  "call site (every caller is bucketed, a per-call body, "
                  "or declared below — the continuous batcher step, "
                  "models/batching.ContinuousBatcher._run_batch, buckets "
                  "through pad_rows(·, pow2_bucket(n)) and so passes the "
                  "call-site check structurally)",
        entry_names=("forward",),
        fixed_callers=(
            (f"{_PKG}/models/serve.py", "make_local_call_llm.call",
             "one-shot oracle path (serve.continuousBatching:false): "
             "batch is always exactly 1"),
        ),
    ),
    JitEntry(
        module=f"{_PKG}/models/moe.py",
        jit_fns=("moe_ffn", "moe_ffn_parts", "load_balance_loss"),
        static=("cfg", "n_experts"),
        shape_policy=FIXED,
        rationale="helpers run only inside encoder/long-context bodies; "
                  "they never own a shape of their own",
    ),
    JitEntry(
        module=f"{_PKG}/models/train.py",
        jit_fns=("train_step", "_eval_step"),
        static=("cfg", "optimizer"),
        shape_policy=FIXED,
        rationale="batches are drop-remainder (train) or wrapped to a "
                  "fixed batch_size (eval): every batch is exactly "
                  "[batch_size, seq_len] by data-pipeline construction",
        entry_names=("train_step", "_eval_step"),
        fixed_callers=(
            (f"{_PKG}/models/train.py", "train_loop",
             "epoch() is drop-remainder: one static batch shape"),
            (f"{_PKG}/models/train.py", "evaluate",
             "eval_batches() wraps the tail to a full static batch"),
        ),
    ),
    JitEntry(
        # JAX: _build_run.run, the memoized shard_map runner. The port's
        # runner is forward_long_placed, over params placed once per
        # (cfg, mesh) by the plan's placement cache.
        module=f"{_PKG}/models/long_context.py",
        jit_fns=("forward_long_placed",),
        static=("cfg", "mesh", "dp_axis", "sp_axis", "devices"),
        wrapper="forward_long",
        shape_policy=FIXED,
        rationale="L is divisible by the sp axis and fixed by config; the "
                  "shards come from split_tokens over the mesh grid, so "
                  "each device sees one [B/dp, L/sp] shape per bucket",
        entry_names=("forward_long", "forward_long_placed"),
        fixed_callers=(
            (f"{_PKG}/parallel/plan.py", "serve_forward",
             "runner dispatch: every serve_forward caller buckets its "
             "batch through serve_bucket + pad_rows before placement, so "
             "the long-context runner sees O(log N) batch shapes per "
             "(cfg, mesh)"),
        ),
    ),
    JitEntry(
        # JAX: _build_ring.run and ring_attention_local; the port runs the
        # ring over per-device shards in ring_attention_local.
        module=f"{_PKG}/parallel/ring_attention.py",
        jit_fns=("ring_attention_local",),
        static=("axis_name", "causal", "scale", "impl", "mesh",
                "dp_axis", "sp_axis", "devices"),
        wrapper="ring_attention",
        shape_policy=FIXED,
        rationale="shard shapes are fixed by the mesh: each device holds "
                  "one [B, H, L/sp, Dh] block per call",
        entry_names=("ring_attention",),
    ),
    JitEntry(
        module=f"{_PKG}/parallel/pipeline.py",
        jit_fns=("pipeline_apply",),
        static=("mesh", "pp_axis", "n_microbatches", "stage_fn",
                "treedef", "n_stages", "devices"),
        shape_policy=FIXED,
        rationale="microbatch count and stage layout are static; each "
                  "stage sees [B/M, L, D] microbatches of a bucketed batch",
        entry_names=("pipeline_apply",),
    ),
    JitEntry(
        # JAX: LocalEmbeddings._ensure_model.run, its jitted forward. The
        # port's embedding forward is encoder.forward and its mesh scoring
        # plan.arena_scores, both rows of their own, so this row names no
        # body: it holds the wrapper's bucketing and the model's load site.
        module=f"{_PKG}/knowledge/embeddings.py",
        wrapper="LocalEmbeddings._embed",
        shape_policy=BUCKETED,
        builders=("LocalEmbeddings._ensure_model",),
    ),
    JitEntry(
        # Pipeline-parallel serving forward: the GPipe wavefront behind
        # the encoder_validator_pp family, its stage a nested callable.
        module=f"{_PKG}/models/pipeline_serve.py",
        jit_fns=("pp_serve_forward",),
        static=("cfg", "mesh", "plan_axes", "microbatches", "plan"),
        shape_policy=FIXED,
        rationale="seq_len is fixed by config and the batch dim arrives "
                  "through serve_bucket, which floors at the plan's "
                  "microbatches so B % M is structural — callers are the "
                  "plan.serve_forward dispatch and the plan-search "
                  "warmup, both bucketed",
        entry_names=("pp_serve_forward",),
        fixed_callers=(
            (f"{_PKG}/parallel/plan.py", "serve_forward",
             "runner dispatch: serve_forward callers bucket through "
             "serve_bucket, which floors at the plan's microbatches, so "
             "B % M holds and the pipeline runner sees O(log N) batch "
             "shapes per (cfg, mesh, plan)"),
        ),
    ),
    JitEntry(
        # Mesh serving: the plan's forward dispatch and the arena-score
        # matmul, over params placed once per (cfg, mesh, plan) by
        # sharded_params' cache.
        module=f"{_PKG}/parallel/plan.py",
        jit_fns=("arena_scores",),
        static=("cfg", "mesh", "plan", "family", "dp_axis"),
        shape_policy=FIXED,
        rationale="every caller buckets its batch/row dim through "
                  "serve_bucket (pow2 floored at the plan's bucket_min "
                  "and the mesh dp size) + pad_rows before placement, so "
                  "each mesh sees O(log N) shapes — batching._run_batch, "
                  "embeddings._embed/_scores, the plan-search warmup",
        entry_names=("serve_forward", "arena_scores"),
    ),
)


def entries_for(module: str, table: tuple = None) -> list:
    """Table entries declared for a repo-relative module path. ``table``
    lets the fixture corpus drive the passes with synthetic entries."""
    return [e for e in (JIT_TABLE if table is None else table)
            if e.module == module]


def table_modules() -> list:
    """Distinct modules the table covers, in declaration order."""
    seen: dict = {}
    for e in JIT_TABLE:
        seen.setdefault(e.module, None)
    return list(seen)
