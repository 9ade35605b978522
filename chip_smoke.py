#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and hold its
hand-written kernels against the kernels' plain PyTorch versions.

Run from the repository root::

    python3 chip_smoke.py

The main path is the governance stage-3 local validator, from the port's
``Gateway.message_sending`` through its ``GovernancePlugin`` to
``make_local_call_llm()`` → ``ContinuousBatcher`` → ``encode_texts`` →
``load_pretrained`` (the shipped triage-tiny checkpoint, at its full
width) → ``forward`` with attention through the CUDA kernel →
``render_verdict``. The worker_profile phase runs the same path behind
the port's redaction and beside its ``CortexPlugin``, as a cluster worker
runs it. Each phase prints one JSON line; any failure exits non-zero
before the last line is printed.

1. device: the card's name and power limit (``nvidia-smi``), or exit 1
   without a CUDA device;
2. build: ``nvcc`` builds every kernel library from the sources in
   ``vainplex_openclaw_tpu_torch/ops/csrc``, the K1/K2 library of head dims
   above 128 (``_build.WIDE_DEFINES``) and the K1/K2 library of every
   tile the committed block table (``ops/flash_block_table.json``) names,
   so that serving builds nothing; each instantiation's registers,
   static shared memory and spills from ``ptxas`` (every kernel's, for a
   library of at most 8), at most 36 instantiations, no spills in the bf16
   kernels at Dh <= 64;
3. kernels: each kernel against its plain version on the card, in bf16
   (tolerance 3e-2, the JAX suite's own bf16 bound, absolute and relative
   to each row's largest value) and fp32 (1e-4 absolute: the two sum in
   another order), over every row (a row with no valid key averages V),
   every row finite; the cases reach the key tile's edges (Lk 63/64/65,
   127/128/129), query counts off the 64-row tile, causal at L=130, masks
   valid only in the last key tile and masks with holes, L=16384, head
   dim 8 (compiled in fp32, zero-padded to 16 in bf16) and 24
   (zero-padded to 32 by the wrapper), Dh 16, 32, 64 and 128 at 2048
   keys or more (each swizzle width of the bf16 body with a control),
   head dims 129, 256 and 384 (``WIDE_CASES``: the wide library, at one
   launch per call; at 256 also L=2048, causal L=2048 and Lq=1000
   Lk=1999) and 1000 (Q streamed with K, ``WIDE_STREAMED_Q_CASES``), and
   the shard shapes the mesh and graft_entry phases
   launch (16-21, 29), the serve path's smaller buckets (B 1-16, the
   worker_profile phase's one-at-a-time sends); at 2048 keys or more the
   plain version without its first key tile must fail the same check
   (``CONTROL_MIN_LK``); each bf16 case runs the tile the committed block
   table gives its shape, and every row of that table must serve at least
   one case;
4. forward: the port's forward on the card against the same forward on the
   CPU (the plain attention), on the shipped weights over 512 seeded texts
   and on random weights at ``EncoderConfig()`` width;
5. serve: 256 requests from 32 threads through ``make_local_call_llm()``
   with its defaults; verdicts equal the CPU one-shot oracle's, and the
   kernel's launch count, set to 0 just before, equals layers × batches;
   a second, profiled round gives the card's busy share while serving;
5a. gateway: the port's front door. Its ``Gateway`` with a config-only
    ``GovernancePlugin`` (default builtins, the audit journal on, stage 3
    by ``validation.llmValidator: {enabled, local, failMode: "closed"}``
    over ``GATEWAY_FACTS``): 256 distinct seeded texts (``gateway_texts``,
    every 16th contradicting a fact) through ``message_sending`` on an
    external channel, one at a time, with decisions equal to the same
    gateway on the CPU with the one-shot path, K1 = n_layers x batches,
    256 evaluations in ``governance.status`` and, after ``stop()``, one
    whole audit record per evaluation; then the same texts from 32
    threads on a fresh gateway (decisions equal to the serial leg's, K1 =
    n_layers x batches) beside a bare ``make_local_call_llm`` round on the
    same texts and threads; last ``bench.py``'s policy-eval setup, 5,000
    ``before_tool_call`` calls through the port's gateway on the host (ms
    a call, the engine's stages, the rate limiter's denials, audit records
    = evaluations);
6. timing: the kernel, its plain version and
   ``F.scaled_dot_product_attention`` (a yardstick the port never calls) at
   the serve path's shape, with CUDA events, beside the least time the card
   could take for the same work (``attention_bound``: the guide's bound and
   the floor its exponentials set).

The long-context family (``serve.planFamily: "encoder_validator_long"``,
ring attention over a (dp, sp) grid, kernel K2: attention in stats mode)
is driven after it:

7. kernels (K2): K2 against its plain version on the card in bf16 and
   fp32 at the ring's shapes (Dh 16 and 32, causal, Lq != Lk, L=100,
   L=16384), head dim 8 and 24, the dryrun's ring+flash shard (Dh 8), the
   ``WIDE_CASES``, ``WIDE_STREAMED_Q_CASES`` and the tile-edge and mask
   cases of phase 3, at one launch per call, over rows with a valid key: m
   as an absolute difference, l and the unnormalized acc relative to the
   plain l and, in bf16, acc per row relative to the row's largest value;
   every value finite, and a row with no valid key has m = -1e30 and l =
   its key count; at 2048 keys or more the plain version without its
   first key tile must fail the same check;
7a. timing_wide: K1 and K2 at each non-causal ``WIDE_CASES`` shape in
    bf16 and fp32, and the narrow fp32 walk at B=2 H=2 L=2048 with Dh 64
    and 128, beside the bound, the plain version and SDPA on the same
    inputs (no main path runs these shapes);
8. ring: ``forward_long`` at ``long_context_config(16384)`` on a (1, 4)
   grid laid over one card against the same call at (1, 1): fp32 logits
   within 1e-4, bf16 severity argmax identical;
9. serve-long: 32 long and 32 short requests from 8 threads through
   ``make_local_call_llm`` with the long family on a (1, 1) grid, on a
   checkpoint the port writes; verdicts equal the one-shot path on the
   card (the dense forward through K1) and, for 4 requests, on the CPU;
   32 rows route long; the K2 and K1 counts, set to 0 just before, equal
   layers × long and × short sub-batches; a profiled repeat gives the
   card's busy share;
10. timing (K2): K2, its plain version and ``scaled_dot_product_attention``
    (the normalized output, the nearest library call) at the long serve
    shape, beside the bound; K1 on the same inputs beside SDPA, which
    computes exactly K1's function there; the profiler's device time of
    each in short windows, with the records it kept; and the card's own
    ex2 rate (``sfu_rates``), which gives the exponential floor measured
    in this run beside the one from the published rate.

Training and the other consumers of the forward follow:

11. grad: one batch of 64 from ``synthetic_split`` through ``loss_fn`` at
    ``TINY_CONFIG``, fp32 and bf16, from the same fp32 masters on the card
    (K1 forward, its dense-recompute backward) and on the CPU: every leaf's
    gradient within ``GRAD_TOL`` of the CPU leaf's max |g|, every attention
    q, k, v gradient nonzero, K1 launched ``n_layers`` times per forward;
12. train: ``train_and_ship`` on the card with the JAX recipe (600 steps
    of batch 64 at ``TINY_CONFIG``'s full width) into a temporary
    directory: held-out keep and severity accuracy at least 0.9 after the
    float16 ship, mood at least the majority class, K1 launched n_layers ×
    (steps + eval batches) times; then 64 requests served from that
    checkpoint through ``make_local_call_llm()``, verdicts equal to the
    CPU one-shot path's;
13. train_moe: the repository's MoE encoder (``__graft_entry__``'s widths,
    4 experts) trained 100 steps on the card: the loss falls, ``moe_aux``
    stays finite, and the trained model's fp32 forward on the card is
    within 1e-4 of the CPU's;
14. triage_embed: ``local_triage`` on 64 seeded findings whose texts
    split the keep head and ``LocalEmbeddings`` search over 200 seeded
    facts on the card against the CPU: triage decisions identical, keep
    logits within ``TRIAGE_TOL`` (and uniform attention, the control,
    outside it), search ids identical in fp32 (the shipped weights as an
    fp32 checkpoint) and the top-1 ids in bf16 (the shipped checkpoint);
15. timing_train: K1 at the training shape (B=64, H=4, L=64, Dh=16 bf16)
    beside its bound, its plain version and SDPA; the dense-recompute
    backward of one attention call; a training step split into forward,
    backward, AdamW and the rest, and the card's busy share over a
    profiled window of steps.

Every mesh-serving family follows, each grid repeating the one card (the
sharded arithmetic and placement of a mesh, not copies between cards), and
each against the single-device path in the same call (requests/s and p50
from 64 seeded prompts at 8 threads, measurements with no claim):

16. mesh_default: ``make_local_call_llm(serve_cfg={"meshServing": True})``
    from the shipped checkpoint: a ``1x1`` grid over (dp, tp), verdicts
    (severity-3 templates included) equal to the one-shot card path, K1
    launched n_layers times per sub-batch;
17. mesh_tp: ``encoder_validator`` on (2, 2) and (1, 4) grids through
    ``ContinuousBatcher(mesh=...)``: verdicts equal; the shipped weights'
    logits within 1e-5 (cast to fp32) and 5e-2 with the argmax equal
    (bf16) of the single-device card forward; K1 n_layers × dp × tp times
    per forward; a control with the ``attn/o`` psum replaced by one
    column's partial must fail the fp32 check;
18. mesh_pp: ``encoder_validator_pp`` on two stages, 4 microbatches:
    verdicts and logits as above, ``microbatch`` charged 4 × batches, K1
    n_layers × M per forward;
19. mesh_ep: ``encoder_validator_moe`` on (2, 2) over (dp, ep) from a
    seeded 4-expert fp32 checkpoint: verdicts equal, ``auxMean`` within
    1e-5 of the single-device forward on the same batches, K1 n_layers ×
    dp per forward;
20. embed_mesh: ``embeddings_forward`` on (4,) and
    ``embeddings_forward_moe`` on (1, 2): search ids equal to the
    single-device port (fp32 top-5, bf16 top-1), K1 n_layers × dp per
    embedding forward;
21. timing_mesh: K1 at the shard shapes (a tp=2 column of a dp=2 row at
    the 32 bucket, B=16 H=2, and a pipeline microbatch, B=8 H=4) beside
    its bound, its plain version and SDPA, with the wrapper's output on
    the same inputs held against the plain version; then one line with
    the seconds each mesh phase took.

Sharded training, the MoE long path and the similarity twins close the run,
the grids again repeating the one card:

22. train_mesh: one sharded training step from the same fp32 masters and
    batch of 64 as the single-device card step, for ``triage-tiny`` on
    (2, 2) and (1, 4) over (dp, tp) and the repository's MoE encoder on
    (2, 2) over (dp, ep), fp32 and bf16: every copy's gradient within
    ``GRAD_TOL`` of the leaf's max |g| (fp32 1e-4, bf16 2e-2), K1 launched
    ``mesh_k1_per_forward`` times per step (n_layers × dp × min(tp, heads),
    n_layers × dp under ep); in fp32 the loss within 1e-5, the params after
    AdamW within 1e-6 of AdamW on one device fed the same gradient and,
    where the gradient exceeds 1e-6, of the single-device step, the copies
    bit-equal after 3 steps, a step without the cross-copy sum failing the
    gradient check (the control), and save, restore onto a fresh placement
    and the next step's loss bit-exact; ms per sharded step beside the
    single-device step. Then 30 sharded steps of ``__graft_entry__``'s
    dense recipe on (2, 2) must lower the held-out keep loss, and K1 is
    timed at the two training shard shapes;
23. long_moe: the MoE encoder through ``forward_long`` on (1, 4) over
    (dp, sp) against the single-device card forward: fp32 logits and
    ``moe_aux`` within 1e-5, the bf16 severity argmax equal, K2 launched
    n_layers × dp × sp² times;
24. similarity: the Jaccard block at N = 64, 512 and 4096 (dim 1024)
    bit-identical to numpy; then K3, the bit-parallel Levenshtein kernel
    (``ops/csrc/levenshtein.cu``, one warp per pair), at every leg of
    ``LEV_LEGS``: L = 128 at 32, 256 and 4096 pairs, the trace analyzer's
    doom-loop detector at L = 512 (ASCII commands of 1 to 500 characters,
    half near-duplicates, a's lengths on word edges) at 32, 256 and 4096,
    and L = 2048 at 32 pairs of multibyte text (a up to 63 words). Each leg:
    K3 launched once per ``batch_levenshtein_ratio`` call, the ratios
    bit-identical to numpy (and to the scalar DP where characters are
    bytes), the distances equal to the plain version's and numpy's, and
    ``kernel_ms`` no faster than ``levenshtein_bound`` / 1.05; at L = 512
    and 4096 pairs the call split into tokenize, copy in, K3 and copy out.
    Last, K3 against the plain version and numpy on tokens the legs never
    hold (``K3_TOKEN_CASES``): a outside the byte alphabet (its ballot
    path), and a inside it with b outside it and on its top rows.

Versioned serving and the trace analyzer follow:

25. lifecycle: the shipped checkpoint as ``v1`` and its twin with the
    severity head negated as ``v2`` (every verdict changes), in a
    ``ModelRegistry`` on the card. 256 seeded texts from 8 threads
    through a collector-driven ``ContinuousBatcher(registry=...)``, once
    as they are and once with ``swap_to("v2")`` after ~96 stamps and
    ``swap_to(rollback_target())`` after ~192: every ticket served with
    the verdict its stamped version gives (one card forward per version),
    K1 launched n_layers × batches, no kernel built (``_build.builds``);
    the swap stages and requests/s with and without the swaps. The
    promotion gate over the stream's shadow ring: a twin from the shipped
    directory promotes with 0 regressions, the negated head is refused.
    Paging with one resident version: 8 alternating checkouts, each
    eviction freeing at least its tree's bytes
    (``torch.cuda.memory_allocated``), woken verdicts unchanged, and the
    wake p99 below the median of 5 cold restores (checkpoint read, cast,
    copy to the card). Last, the stepped swap and rollback on a (1, 2)
    dp×tp grid over the card: the single-device swap's verdicts, K1
    n_layers × dp × tp per batch, and no placement left for the evicted
    version;
26. classify: ``classify_findings(..., use_local_triage=True)`` on 64
    seeded findings on the card: K1 launched n_layers times, the ``kept``
    flags equal to ``local_triage`` on the card and on the CPU;
27. trace_analyzer: the port's ``TraceAnalyzer`` (classify with
    ``useLocalTriage``, the incremental clusterer) over ~22,000 seeded
    events (``trace_corpora``: 1000 chains of bench.py's shape and 64
    doom loops of 65 failing ``exec`` retries of 200-500-character
    commands): a warm-up, then two runs on one state dir, the second over
    10% new chains, each on the card and on the CPU with the report (less
    its timing fields), the cluster state and the processing state equal;
    K1 n_layers times a run, K3 once per window of at least 32 ASCII
    pairs (``trace_k3_windows``, from the raw events); no ``clustering
    failed``, clusters non-empty within the 512-signal cap; then
    ``/trace-analyze`` through ``register_trace_analyzer`` on a recording
    API, and K1 at the triage bucket and K3 at the detector's window timed
    beside their bounds;
27b. worker_profile: the cluster worker's gateway (JAX's
     ``build_worker_gateway`` configs) on the port: ``GovernancePlugin``
     with redaction, the credential guard and stage 3 local (fail closed,
     over ``GATEWAY_FACTS``), ``CortexPlugin`` with every language pack,
     journal, lifecycle (3 tenants resident) and its trace analyzer over
     the 10% new chains of ``trace_corpora``. One seeded stream of 320 ops
     over 8 tenants (``worker_ops``: JAX's ``dispatch_op`` kinds, sends
     and writes on an external channel, a share carrying a seeded API key,
     GitHub token, email or IBAN, and tool calls whose params hold a vault
     placeholder), then ``session_start`` and ``before_compaction`` for
     each tenant, ``/trace-analyze`` and ``/cortexstatus``, against the
     same gateway on the CPU with the one-shot path: every result equal,
     blocked, passed, stage-3-blocked and redacted sends all present, no
     seeded secret in a sent content, a persisted tool result or any file
     under the worker's root, the placeholder resolved to the live secret
     in the tool's params, each tenant's workspace byte-equal,
     hibernations and wakes, one whole audit record per evaluation, the
     analyzer's files equal; K1 = n_layers x (batches + triage forwards),
     only at buckets the kernels phase holds, K3 once per window.
27c. cluster: the port's ``ClusterSupervisor`` (ring, lease table,
     route log) over workers that each run the worker profile, with
     ``fleetServing`` arming the port's ``ReplicaFleet`` on the card under
     the supervisor. storm: 3 in-process workers, a settable clock, JAX's
     fault plan (``cluster.route`` once, ``journal.fsync`` 5%,
     ``journal.append`` 2% torn), 360 ops of ``generate_workload`` over 8
     tenants, each also a stage-3 request to the fleet (3 replicas,
     maxBatch 8); the worker hosting the fullest replica is failed over,
     the fullest replica retired, and a survivor retired with
     ``retire_worker`` before the final drain: every fleet verdict equal
     to the one-shot oracle, none dropped or served twice, routed = served
     + redelivered, every op's final observation with each denial and
     redaction, no fenced record, ``ProtocolWitness`` clean, and each
     tenant's tracker files byte-equal to the same storm's on the CPU
     with no kill and no retire. process: 3 workers in their own
     processes (``spawn``; none touches the card) and the fleet in this
     one, 240 ops on the real clock, a SIGKILL after 120, then ``drain``:
     one failover, every op answered (twice only with one answer), fleet
     verdicts equal to the oracle, the children's stage timers merged, no
     child left after ``stop``. worker_serve: two ``InProcessWorker``s
     with ``serve_cfg`` on the card, 32 requests through each one's
     ``gw.serve_batcher`` equal to the oracle; one's ``stop`` drains and
     closes exactly its scope and the other still serves. No thread the
     phase started outlives it; K1 = n_layers x batches in each leg, only
     at buckets the kernels phase holds;
27d. knowledge_slo: the five-plugin gateway of JAX's SLO harness
     (``slo.harness._build_gateway``: governance with redaction, the
     event store on a memory transport, cortex, the knowledge engine,
     sitrep; virtual clock, wall timers off) on the port, with the
     knowledge engine's local embeddings on the card. ``generate_workload``
     (seed 0, 4 tenants) through ``dispatch_op`` until the fact store
     holds its default cap of 2000 facts; a maintenance sync (K1 at
     B=2048); 32 seeded ``/knowledge <query>`` commands (B=1 each); 500
     more ops, whose new facts prune old ones; a second sync, which removes
     the pruned facts from the arena, while a thread runs 16 queries; a
     decay tick. Held against the same run on the CPU: the fact files and
     the facts as JSON, every event on the memory transport (subject and
     envelope; a ``uuid4`` event id as such), each sync's count, the
     removals, the /knowledge fact lines, and each query's hits: each
     card hit's score within 5e-2 of the CPU's score of that fact (the
     bf16 tolerance ``tests/test_torch_triage_embeddings.py`` holds the
     vectors to), and a hit that is not the CPU's at its rank scoring on
     the CPU within 5e-2 of the CPU's hit (facts tied in bf16 noise may
     trade ranks; the count of queries whose ids match in order is
     printed); K1 = n_layers x (sync forwards + uncached query forwards),
     only at buckets the kernels phase holds; K1 at the first sync's
     bucket timed beside its bound, plain version and SDPA. Then
     ``run_slo_report`` with ``device=None`` at ``bench.py``'s
     ``bench_slo_report`` settings (2000 ops, seed 0, 6 tenants, wall,
     admission, watermark 32) at saturation 1.0, 2.0 and with 2 workers at
     1.0: no verdict lost, no false block, the observed denials and
     redactions equal to the expected (each above 0), at 2.0 shedding
     above 0 and equal to the sitrep's; and the sim report (seed 11, 260
     ops, 4 tenants, saturation 2.0) on the card equal to the CPU's as
     sorted JSON. NATS is not driven (the card's machine has no client
     package; the phase's line says whether one is installed);
27e. governance_install: governance's last two sections and the
     installer, each leg on the card and then on the CPU in this process.
     The governance leg loads ``GovernancePlugin`` with every section on
     (``install_governance_config``: stage 3 local over the shipped
     checkpoint, a ``2fa`` effect on ``exec``, 2FA with two approvers
     through a Matrix room, ERC-8004 for three agents) against a loopback
     homeserver and a loopback ``eth_call`` endpoint on 127.0.0.1 (the
     phase fails if either cannot bind): 64 external sends one at a time
     and 128 from 8 threads, each stage-3 verdict equal to the one-shot
     oracle's on the card; 4 rounds in which 4 threads of one agent call
     ``exec`` at once and block until the poller reads an approver's TOTP
     code from the room (request to allow timed), then call once more
     under the session approval; a round whose valid code comes from an
     unauthorised sender (the call stays blocked), then a wrong code from
     an approver (one attempt counted), then the batch's timeout; and
     ``before_agent_start`` twice for every agent (the ``onchain=``
     lookups uncached, then cached; each timed). Decisions, audit
     verdicts, prompts (less their order of commands and their ids) and
     contexts equal the CPU run's; K1 = n_layers x batches; no poller or
     timer thread outlives ``gw.stop()``. The brainplex leg runs the
     port's ``brainplex init --full --yes --config`` in a temporary
     ``OPENCLAW_HOME`` over an ``openclaw.json`` of three agents: exit 0,
     five plugin configs that the port's manifests pass, the merged
     ``openclaw.json`` and its backup, a second init with nothing to do;
     then one operator edit (``INSTALL_CORTEX_EDIT``: local triage on,
     which the generated cortex config leaves off) and the five port
     plugins loaded from those files on a virtual clock: 48 messages, an
     embeddings sync (K1 at B=32), 8 ``/knowledge`` queries (B=1 each),
     ``/trace-analyze`` over 3 doom loops and 12 bench chains (K3 one
     launch a window, K1 triage at B=256), a read the credential guard
     blocks, ``/governance`` and ``/ops``. The written files byte-equal
     the CPU run's (a backup's time stamp aside), each command's text
     equal less the host's clock, the search hits tie-aware within 5e-2;
     K1 = n_layers x (embedding forwards + 1 triage forward);

27a. chaos: fault plans (``resilience.faults``) on the checkpoint and
     state writers. The train leg trains ``triage-tiny`` at its full width
     (bf16, batch 64) from the JAX-key init for 60 steps, saving every 10,
     once straight and once under a plan that fails the 2nd
     ``checkpoint.write`` and the 4th ``checkpoint.rename``, restarting
     ``train_loop`` on its directory after each ``FaultError``, both under
     ``torch.use_deterministic_algorithms(True)``: after each fault no
     tmp file, the latest step the one ``chaos_schedule`` gives from the
     plan, every visible step's manifest present; one fault at each site;
     K1 n_layers x the steps run, replays included; the final params and
     AdamW moments bit-equal to the straight run. The trace leg runs run 1
     of ``trace_corpora`` under a torn ``file.write`` and a failed
     ``file.rename``, on the card and on the CPU: every state and report
     file parses or is absent, no tmp file, and a rerun without the plan
     leaves files equal card vs CPU.

The offline search loops end the run:

28. kernel_search: every candidate tile of K1/K2 (block_q, block_k in
    32/64/128) built in one parallel ``nvcc`` call, then
    ``kernel_search.search((64, 16384))`` from the compiled default (the
    64x64 incumbent; a winner must beat it by 5% and by each record's
    spread): one line per point (ms, spread, K1/K2 parity error at the
    point shape B=4 H=8 Dh=64 within 3e-2 per row, and at 16384 keys a
    control, the plain version without its first key tile, that the
    same check must fail; builds while timed = 0, launches = steps x
    rounds), the winner per bucket; every tile held the same way at each
    bf16 shape of phase 3 a row of the searched buckets would serve and
    at the long serve shape (``served_cases``); the table
    ``validate_table`` passes written to ``$CHIP_SMOKE_OUT``
    (``build/chip_smoke/`` by default); then K1 and K2 timed at the long
    serve shape (B=8 H=2 L=16384 Dh=16) at every tile, 64x64 first and
    last, beside the exponential floor at the measured ex2 rate;
29. plan_search: ``plan_search.search`` for ``encoder_validator`` and
    ``embeddings_forward`` with 256 requests and 256 queries a candidate
    (``PLAN_SEARCH_CARD``), each candidate in the incumbent's gather mode:
    at (1, 1) three times, whose rows may be written only where every run
    passed the same candidate (``agreed_sweeps``), and once at (2, 1) over
    the repeated card, a check of the harness whose rows are never
    written (``card_rows``): every candidate's results equal the one-shot
    oracle's, no build while timed, K1/K2 launches equal to the runner's
    formula; the table ``validate_plan_table`` passes written beside the
    block table; then ``serve.meshShape: null`` with the committed table
    resolves the plan ``plan_provenance`` reports and serves the one-shot
    path's verdicts.

The graft entry points close it:

30. graft_entry: ``graft_entry.entry()`` on the card, its forward
    (``EncoderConfig()`` widths, bf16) against the same forward with the
    plain attention on the card (argmax equal, logits within 5e-2), K1
    launched n_layers times, and K1 timed at its shape [2, 8, 128, 32];
    then ``dryrun_multichip(8)`` and ``(4)`` on grids that repeat the card
    (distinct cards where the host has them): every leg's own checks, and
    each leg's K1 and K2 launches equal to the count the leg records
    beside them by the runners' formulas and its steps, wall ms per leg;
    last, K1 and K2 at head dim 8 timed beside their bound, plain version
    and SDPA: the dryrun's ring+flash shard [1, 2, 16, 16, 8] in fp32
    (K2) and the kernels phases' Dh 8 shapes.

Then a line with K1's exponential floors at the serve and training shapes
at the ex2 rate phase 10 measured, one line ``{"kernels": [...]}`` listing
K1 (with its launches on every path, the lifecycle, classify,
trace_analyzer, worker_profile, cluster, knowledge_slo,
governance_install, chaos and graft_entry phases included, its triage
bucket
in the trace analyzer, its knowledge sync bucket, the tiles the block table gives the serve
and long shapes, its head-dim-8 shapes and its shapes above head dim 128),
K2 (with its head-dim-8 and wide shapes) and K3 (K3 at the detector's shape, L=512 and 4096 pairs,
with its L=128 figures and the trace analyzer's window beside them, and
its launches by path; measured numbers and the bound only)
and, last,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import functools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time
from dataclasses import dataclass

# H100 SXM peaks (NVIDIA data sheet) for the bound: HBM bytes/s and dense
# bf16 tensor-core operations per second.
HBM_BYTES_PER_S = 3.35e12
PEAK_BF16_OPS_PER_S = 989e12
# Exponentials per second of the H100 SXM's special function units: 132 SMs
# x 16 ex2 per clock x ~1.83 GHz, as FlashAttention-3 (Shah et al., 2024)
# gives it. Attention needs one per score, so at Dh=16 this sets its floor:
# an estimate from a published rate; sfu_rates measures the card's own.
SFU_EXP_PER_S = 3.9e12
SFU_PROBE_CHAINS = 8  # kChains in csrc/sfu_probe.cu
TOL = {"bfloat16": 3e-2, "float32": 1e-4}
SOURCE = "vainplex_openclaw_tpu_torch/ops/csrc/flash_attention.cu"
REPLACES = "vainplex_openclaw_tpu/ops/flash_attention.py:130"
# _flash_kernel's stats branch (return_stats=True)
REPLACES_STATS = "vainplex_openclaw_tpu/ops/flash_attention.py:180"
LONG_L = 16384  # long_context_config's length on the card
LONG_THRESHOLD = 1024  # serve.longContext.thresholdTokens, its default
# Gradients on the card against the CPU, per leaf, relative to the CPU
# leaf's max |g|. bf16: the kernel and the CPU's plain version sum in other
# orders, and a bf16 forward rounds that into every gradient (worst leaf
# measured on an H100: 0.0051).
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# The shipped bf16 checkpoint's logits on the card against the CPU, as
# phase 4 holds them (measured on an H100 there: 0.0044); uniform attention
# moves the keep logits by about 1.7 on the CPU.
TRIAGE_TOL = 5e-2
TRAIN_STEPS = 600  # the JAX recipe, pretrained.py:train_and_ship
MOE_STEPS = 100

# head dims above 128, which run in the wide library (Dh zero-padded to a
# multiple of 128 and walked in 256-wide output slices): 129 and 384 padded,
# 256 exact, a ragged and a causal one, B=2 H=2 L=2048 at 256, and at 256
# a long causal walk and a ragged last key tile (Lk=1999) with Lq off the
# query tile. The prefix masks give masked rows and fully masked ones (the
# last quarter of the batch). No main path runs them: the timing_wide
# phase times the non-causal ones.
WIDE_CASES = [
    ("head_dim_129_wide", 4, 2, 100, 100, 129, False, "prefix"),
    ("head_dim_256_wide", 4, 2, 96, 130, 256, False, "prefix"),
    ("head_dim_384_wide", 4, 2, 70, 65, 384, False, "prefix"),
    ("head_dim_256_causal", 2, 2, 130, 130, 256, True, "prefix"),
    ("head_dim_256_long", 2, 2, 2048, 2048, 256, False, "prefix"),
    ("head_dim_256_causal_long", 2, 2, 2048, 2048, 256, True, "prefix"),
    ("head_dim_256_ragged", 2, 2, 1000, 1999, 256, False, "prefix"),
]
# a head dim whose padded width (1024) is above both wide kernels'
# kWideQResMax, so each K unit carries its chunk of Q instead of a Q tile
# resident in shared memory
WIDE_STREAMED_Q_CASES = [
    ("head_dim_1000_q_streamed", 2, 2, 70, 130, 1000, False, "prefix"),
]

# (name, B, H, Lq, Lk, Dh, causal, mask) for K2 and, below, K1. mask is
# False (every key valid), "prefix" (a valid prefix per batch element, the
# last quarter of the batch fully masked: the batcher's zero-pad rows),
# "last_tile" (valid keys only in the last 64-key tile) or "holes" (valid
# keys scattered, not a prefix); see make_qkv.
STATS_CASES = [
    ("ring_shard_sp4", 8, 2, 4096, 4096, 16, False, "prefix"),
    ("ring_dh32", 4, 2, 2048, 2048, 32, False, "prefix"),
    ("causal", 2, 2, 256, 256, 32, True, "prefix"),
    ("cross_length", 2, 2, 96, 200, 64, False, "prefix"),
    ("unaligned_100", 3, 2, 100, 100, 16, False, "prefix"),
    ("keys_63", 3, 2, 70, 63, 16, False, "prefix"),
    ("keys_65", 3, 2, 70, 65, 16, False, "prefix"),
    ("keys_129", 3, 2, 100, 129, 32, False, "prefix"),
    ("causal_130", 4, 2, 130, 130, 16, True, "prefix"),
    ("causal_130_dh128", 4, 2, 130, 130, 128, True, "prefix"),
    # the fp32 walk's timed shapes (FP32_WALK_SHAPES) at 2048 keys, with the
    # dropped-first-tile control, and causal at Dh 128
    ("head_dim_64_long", 2, 2, 2048, 2048, 64, False, "prefix"),
    ("head_dim_128_long", 2, 2, 2048, 2048, 128, False, "prefix"),
    ("head_dim_128_causal_long", 2, 2, 2048, 2048, 128, True, "prefix"),
    # the fp32 legs' shape (FP32_WALK_SHAPES), the serve path's
    ("serve_path", 32, 4, 64, 64, 16, False, "prefix"),
    ("last_tile_only", 4, 2, 96, 200, 16, False, "last_tile"),
    ("holes", 4, 2, 150, 150, 16, False, "holes"),
    ("long_16384", 1, 2, LONG_L, LONG_L, 16, False, False),
    ("long_16384_masked", 2, 2, LONG_L, LONG_L, 16, False, "prefix"),
    # the long_moe phase's ring block: one sp shard of 8 tokens, 4 heads
    ("long_moe_sp4_shard", 8, 4, 8, 8, 16, False, "prefix"),
    # head dim 8 (compiled in fp32, zero-padded to 16 in bf16) and 24
    # (zero-padded to 32 by the wrapper); the last is the graft_entry
    # phase's ring+flash shard, fp32
    # in the dryrun: one dp row of 2 heads, 16 tokens on each of 4 sp shards
    ("head_dim_8", 4, 2, 64, 64, 8, False, "prefix"),
    ("head_dim_8_long", 2, 2, 2048, 2048, 8, False, "prefix"),
    ("head_dim_24_padded", 2, 4, 100, 100, 24, False, "prefix"),
    ("dryrun_ring_shard_dh8", 1, 2, 16, 16, 8, False, False),
    # the dryrun's ring forward (bf16, every key valid): one dp row of 8
    # heads on one of 4 sp shards (8 devices) or of 2 (4 devices)
    ("dryrun_ring_shard_sp4", 1, 8, 16, 16, 16, False, False),
    ("dryrun_ring_shard_sp2", 1, 8, 32, 32, 16, False, False),
] + WIDE_CASES + WIDE_STREAMED_Q_CASES

# the trace_analyzer phase's triage forwards: the pow2 bucket of each
# run's findings (8949 in run 1, 879 in run 2); the phase fails if a run's
# bucket is not among these cases
TRACE_TRIAGE_CASES = [
    ("trace_triage_run1", 16384, 4, 64, 64, 16, False, "prefix"),
    ("trace_triage_run2", 1024, 4, 64, 64, 16, False, "prefix"),
]

# the serve path's smaller pow2 buckets: the worker_profile phase sends
# one message at a time (B=1); the phase fails if it launches K1 at a
# bucket that no case holds
WORKER_SERVE_CASES = [(f"worker_serve_b{B}", B, 4, 64, 64, 16, False, "prefix")
                      for B in (1, 2, 4, 8, 16)]

# the knowledge_slo phase's embedding syncs: the pow2 bucket of the 2000
# facts at maxFacts, then of the 214 new ones after 500 more ops (its
# queries run at B=1, a worker_serve case); the phase fails if a sync
# launches K1 at a bucket that no case holds
KNOWLEDGE_SYNC_CASES = [(f"knowledge_sync_b{B}", B, 4, 64, 64, 16, False,
                         "prefix") for B in (2048, 256)]

# the governance_install phase's brainplex leg: the pow2 bucket of its
# sync's 28 facts (its queries run at B=1, its triage of 242 findings at
# B=256: cases above); the phase fails if it launches K1 at a bucket that
# no case holds
INSTALL_SYNC_CASES = [("install_sync_b32", 32, 4, 64, 64, 16, False,
                       "prefix")]

KERNEL_CASES = [
    ("serve_path", 32, 4, 64, 64, 16, False, "prefix"),
    ("encoder_default_width", 32, 8, 128, 128, 32, False, "prefix"),
    ("mfu_shape", 4, 16, 2048, 2048, 64, False, "prefix"),
    ("causal", 2, 4, 256, 256, 32, True, False),
    ("causal_masked", 2, 4, 96, 96, 16, True, "prefix"),
    ("cross_length", 2, 4, 96, 200, 64, False, "prefix"),
    ("unaligned_100", 3, 4, 100, 100, 16, False, "prefix"),
    ("head_dim_128", 2, 2, 130, 130, 128, False, "prefix"),
    ("keys_63", 4, 2, 63, 63, 16, False, "prefix"),
    ("keys_64", 4, 2, 64, 64, 16, False, "prefix"),
    ("keys_65", 4, 2, 65, 65, 16, False, "prefix"),
    ("keys_127", 4, 2, 100, 127, 32, False, "prefix"),
    ("keys_128", 4, 2, 100, 128, 32, False, "prefix"),
    ("keys_129", 4, 2, 100, 129, 64, False, "prefix"),
    ("rows_not_tile_multiple", 3, 2, 77, 64, 16, False, "prefix"),
    ("causal_130", 4, 2, 130, 130, 16, True, "prefix"),
    ("causal_130_dh128", 4, 2, 130, 130, 128, True, "prefix"),
    # the fp32 walk's timed shapes (FP32_WALK_SHAPES) at 2048 keys, with the
    # dropped-first-tile control, and causal at Dh 128; the ring's shard
    ("head_dim_64_long", 2, 2, 2048, 2048, 64, False, "prefix"),
    ("head_dim_128_long", 2, 2, 2048, 2048, 128, False, "prefix"),
    ("head_dim_128_causal_long", 2, 2, 2048, 2048, 128, True, "prefix"),
    ("ring_shard_sp4", 8, 2, 4096, 4096, 16, False, "prefix"),
    # Dh 32 at 2048 keys: each swizzle width of the bf16 body (32, 64 and
    # 128-byte rows: Dh 16, 32 and 64-128) meets a control
    ("head_dim_32_long", 2, 2, 2048, 2048, 32, False, "prefix"),
    ("last_tile_only", 4, 2, 96, 200, 16, False, "last_tile"),
    ("holes", 4, 2, 150, 150, 32, False, "holes"),
    ("long_16384", 1, 2, LONG_L, LONG_L, 16, False, False),
    ("long_16384_masked", 2, 2, LONG_L, LONG_L, 16, False, "prefix"),
    # the shard shapes of the mesh phases: a tp=2 column of a dp=2 row, a
    # tp=4 column, a pipeline microbatch, and an MoE dp row
    ("mesh_tp2_shard", 16, 2, 64, 64, 16, False, "prefix"),
    ("mesh_tp4_shard", 32, 1, 64, 64, 16, False, "prefix"),
    ("mesh_pp_microbatch", 8, 4, 64, 64, 16, False, "prefix"),
    ("mesh_moe_dp_row", 16, 4, 32, 32, 16, False, "prefix"),
    # the train_mesh shard shapes at batch 64: a tp=2 column of a dp=2 row,
    # a tp=4 column, an MoE dp row, and the graft recipe's tp=2 column
    ("train_tp2_shard", 32, 2, 64, 64, 16, False, "prefix"),
    ("train_tp4_shard", 64, 1, 64, 64, 16, False, "prefix"),
    ("train_moe_dp_row", 32, 4, 32, 32, 16, False, "prefix"),
    ("graft_tp2_shard", 2, 4, 64, 64, 16, False, "prefix"),
    # head dim 8 (a compiled width in fp32, zero-padded to 16 in bf16) and
    # 24 (zero-padded to 32 with the scale of 24)
    ("head_dim_8", 4, 2, 64, 64, 8, False, "prefix"),
    ("head_dim_8_long", 2, 2, 2048, 2048, 8, False, "prefix"),
    ("head_dim_8_causal", 2, 2, 130, 130, 8, True, "prefix"),
    ("head_dim_24_padded", 2, 4, 100, 100, 24, False, "prefix"),
    # the graft_entry phase: entry()'s forward (EncoderConfig() widths, two
    # texts) and the dryrun's shards at 8 devices: a tp=4 column of a dp=2
    # row (dense), an MoE dp row and an embeddings dp row of one text
    ("graft_entry", 2, 8, 128, 128, 32, False, "prefix"),
    ("dryrun_tp4_shard", 2, 2, 64, 64, 16, False, "prefix"),
    ("dryrun_moe_dp_row", 2, 4, 32, 32, 16, False, "prefix"),
    ("dryrun_embed_dp_row", 1, 8, 64, 64, 16, False, False),
    # and the serve legs' pipeline microbatch (one text) and the
    # single-device forwards they are held against (dense, MoE widths)
    ("dryrun_pp_microbatch", 1, 4, 32, 32, 16, False, False),
    ("dryrun_dense_reference", 4, 8, 64, 64, 16, False, "prefix"),
    ("dryrun_moe_reference", 4, 4, 32, 32, 16, False, "prefix"),
] + (WIDE_CASES + WIDE_STREAMED_Q_CASES + TRACE_TRIAGE_CASES
     + WORKER_SERVE_CASES + KNOWLEDGE_SYNC_CASES + INSTALL_SYNC_CASES)
# K1 cases with at least this many keys (and not causal) also check a
# control: the plain version without the first 64-key tile, as a kernel
# that skipped a stage of its ring would compute. It must fail the case's
# check, or the check could not see such a fault at that length.
CONTROL_MIN_LK = 2048
# kernel instantiations a flash library may hold: the default library's
# 4 bf16 head dims and 5 fp32 ones, causal or not, stats or not
MAX_INSTANTIATIONS = 36

_SUBJECTS = ("deploy", "api-server", "billing-job", "auth-service", "cache",
             "db-migration", "ingress", "webhook", "release", "audit")
_TEMPLATES = (
    "tool {n} failed: connection refused after {i} retries",
    "error: deployment {n} exceeded progress deadline",
    "no, that's wrong — {n} is still failing and this is useless",
    "permission denied writing to {n}",
    "rate limit hit calling {n}, backing off {i}s",
    "we decided to ship {n} tomorrow because the fix is ready",
    "thanks, {n} works perfectly now",
    "looks good, merging {n}",
    "reading file {n} ({i} bytes)",
    "what does the {n} flag do again?",
)


def attention_bound(B, H, Lq, Lk, Dh, elem_bytes, stats,
                    ops_per_s=PEAK_BF16_OPS_PER_S):
    """The least time the card could take for one attention launch.

    Bytes: q, k, v read once in their dtype (``elem_bytes``), the fp32 bias
    row [B, Lk], and the output written once: in q's dtype (K1) or, with
    ``stats`` (K2), the fp32 acc and the fp32 m and l. Operations: 4 per
    score and head dimension (q . k and p . v). ``bound_ms`` is the larger
    of bytes over HBM_BYTES_PER_S and operations over ``ops_per_s`` (the
    bf16 tensor-core peak; fp32 callers pass the CUDA cores'
    ``CUDA_CORE_OPS_PER_S``, where the fp32 walk runs), the guide's bound;
    ``exp_floor_ms`` is the one exponential per score over SFU_EXP_PER_S,
    a floor the guide's bound does not see."""
    out_bytes = (B * H * Lq * Dh * 4 + 2 * B * H * Lq * 4 if stats
                 else B * H * Lq * Dh * elem_bytes)
    n_bytes = ((B * H * Lq * Dh + 2 * B * H * Lk * Dh) * elem_bytes
               + B * Lk * 4 + out_bytes)
    n_ops = 4 * B * H * Lq * Lk * Dh
    n_exp = B * H * Lq * Lk
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return {"bytes": n_bytes, "operations": n_ops, "exponentials": n_exp,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "exp_floor_ms": n_exp / SFU_EXP_PER_S * 1e3}


_PTXAS_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")
_PTXAS_SMEM = re.compile(r"(\d+) bytes smem")
_KERNEL_ARGS = re.compile(r"(flash_fwd_\w+?)ILi(\d+)ELb([01])ELb([01])E")


def ptxas_report(log: str) -> list:
    """One entry per kernel instantiation in ``nvcc -Xptxas=-v`` output:
    its template (kernel, Dh, causal, stats), registers, static shared
    memory (dynamic shared memory is set at launch and not reported) and
    spill bytes."""
    chunks = _PTXAS_ENTRY.split(log)
    report = []
    for name, body in zip(chunks[1::2], chunks[2::2]):
        args = _KERNEL_ARGS.search(name)
        spill = _PTXAS_SPILL.search(body)
        regs = _PTXAS_REGS.search(body)
        smem = _PTXAS_SMEM.search(body)
        report.append({
            "kernel": args.group(1) if args else name,
            "dh": int(args.group(2)) if args else None,
            "causal": args.group(3) == "1" if args else None,
            "stats": args.group(4) == "1" if args else None,
            "registers": int(regs.group(1)) if regs else None,
            "smem_bytes": int(smem.group(1)) if smem else None,
            "spill_stores": int(spill.group(1)) if spill else None,
            "spill_loads": int(spill.group(2)) if spill else None})
    return report


class SmokeFailure(Exception):
    pass


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def seeded_texts(n: int, seed: int) -> list:
    import numpy as np

    rng = np.random.default_rng(seed)
    return [_TEMPLATES[rng.integers(len(_TEMPLATES))].format(
        n=_SUBJECTS[rng.integers(len(_SUBJECTS))], i=int(rng.integers(2, 500)))
        for _ in range(n)]


def as_prompt(text: str) -> str:
    """The stage-3 prompt shape the serve seam cuts the message out of."""
    return ("You are reviewing an outbound message.\n\nKNOWN FACTS:\n- (none)"
            f"\n\nMESSAGE:\n{text}\n\nIdentify issues in these categories.")


def make_qkv(rng, B, H, Lq, Lk, Dh, dtype, mask_kind, device):
    """Seeded q, k, v [B, H, L, Dh] and a kv_mask [B, Lk] of ``mask_kind``
    (see ``STATS_CASES``), or None when it is False. Every kind keeps the
    last quarter of the batch fully masked and, when B > 2, the first batch
    element fully valid, as the batcher's rows are."""
    import numpy as np
    import torch

    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(device=device, dtype=dtype)
               for s in ((B, H, Lq, Dh), (B, H, Lk, Dh), (B, H, Lk, Dh)))
    if not mask_kind:
        return q, k, v, None
    keys = np.arange(Lk)[None, :]
    if mask_kind == "prefix":
        mask = keys < rng.integers(1, Lk + 1, size=B)[:, None]
    elif mask_kind == "last_tile":
        mask = np.broadcast_to(keys >= (Lk - 1) // 64 * 64, (B, Lk)).copy()
    elif mask_kind == "holes":
        mask = rng.random((B, Lk)) < 0.5
        mask[:, 0] = False  # a hole before the first valid key
    else:
        raise ValueError(f"unknown mask kind {mask_kind!r}")
    mask[-(B // 4 or 1):] = False  # the batcher's zero-pad rows
    if B > 2 and mask_kind == "prefix":
        mask[0] = True
    return q, k, v, torch.from_numpy(mask).to(device)


def k1_errors(out, ref, dt_name: str):
    """(max |out - ref|, the largest over rows of max |out - ref| / max
    |ref| in the row, the error the case is held to). bf16 keeps 8 bits of
    each value, so bf16 is held per row, relative to the row's scale: a row
    that averages 16384 keys has |ref| ~ 0.01, where an absolute 3e-2 would
    pass a kernel that dropped a key tile. fp32 is held absolutely, since
    its error is ~1e-6 and a dropped tile moves a value by ~1e-3."""
    d = (out.float() - ref.float()).abs()
    scale = ref.float().abs().amax(dim=-1).clamp_min(1e-30)
    err = float(d.max())
    rel = float((d.amax(dim=-1) / scale).max())
    return err, rel, rel if dt_name == "bfloat16" else err


def valid_rows(mask, B, Lq, Lk, causal, device):
    """[B, 1, Lq, 1] bool: the query rows that see at least one valid key."""
    import torch

    m = torch.ones((B, Lk), dtype=torch.bool, device=device) \
        if mask is None else mask
    if causal:
        seen = torch.cumsum(m.int(), dim=1)[:, :Lq] > 0
    else:
        seen = m.any(dim=1, keepdim=True).expand(B, Lq)
    return seen[:, None, :, None]


def phase_device() -> dict:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        sys.exit(1)
    import vainplex_openclaw_tpu_torch  # noqa: F401 — fail before any output

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    line = smi.stdout.strip().splitlines()[0]
    print(line, flush=True)
    info = {"phase": "device", "nvidia_smi": line,
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(info)
    return info


def phase_build() -> None:
    from vainplex_openclaw_tpu_torch.ops import _build

    t0 = time.perf_counter()
    results = _build.build(list(_build.SIGNATURES) + [
        ("flash_attention", _build.WIDE_DEFINES)] + [
        ("flash_attention", _build.tile_defines(t)) for t in table_tiles()])
    libraries = {}
    for name, r in results.items():
        print(f"[ptxas {name}]\n{r['ptxas']}", file=sys.stderr, flush=True)
        report = ptxas_report(r["ptxas"])
        registers: dict = {}
        for e in report:
            registers.setdefault(e["kernel"], {}).setdefault(
                str(e["dh"]), []).append(e["registers"])
        libraries[name] = {
            "seconds": round(r["seconds"], 3), "cached": r["cached"],
            "instantiations": len(report),
            "registers": {k: {dh: [min(v), max(v)] for dh, v in d.items()}
                          for k, d in registers.items()},
            "spilling": [e for e in report
                         if e["spill_stores"] or e["spill_loads"]]}
        if len(report) <= 8:  # a small library: every kernel's resources
            libraries[name]["kernels"] = report
        if r["cached"]:
            continue
        check(bool(report), f"{name}: no ptxas report in the build log")
        # K1/K2: (4 bf16 head dims + 5 fp32) x causal or not x stats or
        # not (the wide library: 2 dtypes x causal or not x stats or not)
        check(len(report) <= MAX_INSTANTIATIONS,
              f"{name}: {len(report)} kernel instantiations > "
              f"{MAX_INSTANTIATIONS}")
        check_spills(name, report)
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "table_tiles": [list(t) for t in table_tiles()],
          "libraries": libraries})


def check_spills(name: str, report: list) -> None:
    """Fails on a spill of the bf16 body (``flash_fwd_mma``) at Dh <= 64,
    of the fp32 kernel at any compiled width, or of any other
    ``flash_fwd_*`` kernel than those and the two wide ones (``…_wide``):
    a body under a new name is held as the bf16 one is at every width."""
    def held(e):
        if e["kernel"] == "flash_fwd_mma":
            return e["dh"] is None or e["dh"] <= 64
        if e["kernel"] in ("flash_fwd_mma_wide", "flash_fwd_fp32_wide"):
            return False
        return e["kernel"] == "flash_fwd_fp32" or \
            e["kernel"].startswith("flash_fwd")
    spills = [e for e in report if held(e)
              and (e["spill_stores"] or e["spill_loads"])]
    check(not spills, f"{name}: bf16 kernels at Dh <= 64 or fp32 kernels "
                      f"spill: {spills}")


def table_tiles() -> list:
    """Every (block_q, block_k) a ``cuda:`` row of the committed block
    table names, other than the compiled default: each is a library that
    serving loads, so the build phase builds it."""
    from vainplex_openclaw_tpu_torch.ops import _build
    from vainplex_openclaw_tpu_torch.ops import flash_attention as fa

    rows = fa.load_block_table(fa.TABLE_PATH).get("entries", {})
    return sorted({(e["block_q"], e["block_k"]) for k, e in rows.items()
                   if k.startswith("cuda:")} - {_build.DEFAULT_TILES})


def phase_kernels() -> float:
    import numpy as np
    import torch

    from vainplex_openclaw_tpu_torch.ops import flash_attention as fa
    from vainplex_openclaw_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference, launch_tiles)

    rng = np.random.default_rng(0)
    cases = []
    worst = 0.0
    for name, B, H, Lq, Lk, Dh, causal, mask_kind in KERNEL_CASES:
        for dt_name, dtype in (("bfloat16", torch.bfloat16),
                               ("float32", torch.float32)):
            q, k, v, mask = make_qkv(rng, B, H, Lq, Lk, Dh, dtype, mask_kind,
                                     "cuda")
            # the block table's tile for this shape, as a launch reads it
            # (fp32 and the wide library keep their own)
            tile = launch_tiles(Lq, Lk, dt_name) \
                if Dh <= fa.MAX_HEAD_DIM else (None, None)
            before = fa.launches
            out = flash_attention(q, k, v, mask, causal=causal,
                                  block_q=tile[0], block_k=tile[1])
            check(fa.launches == before + 1,
                  f"{name}/{dt_name}: {fa.launches - before} K1 launches "
                  "for one call")
            ref = flash_attention_reference(q, k, v, mask, causal=causal)
            torch.cuda.synchronize()
            check(out.dtype == q.dtype and out.shape == q.shape,
                  f"{name}/{dt_name}: output {out.dtype} {tuple(out.shape)}")
            check(bool(torch.isfinite(out.float()).all()),
                  f"{name}/{dt_name}: non-finite output")
            # every row, those without a valid key included: the plain
            # version gives them the mean of V
            err, rel, held = k1_errors(out, ref, dt_name)
            check(err <= TOL[dt_name] and held <= TOL[dt_name],
                  f"{name}/{dt_name}: max |kernel - plain| {err}, per row "
                  f"relative {rel} > {TOL[dt_name]}")
            control = None
            if Lk >= CONTROL_MIN_LK and not causal:
                dropped = flash_attention_reference(
                    q, k[:, :, 64:].contiguous(), v[:, :, 64:].contiguous(),
                    None if mask is None else mask[:, 64:].contiguous())
                control = k1_errors(dropped, ref, dt_name)[2]
                check(control > TOL[dt_name],
                      f"{name}/{dt_name}: the check passes the plain version "
                      f"without its first key tile ({control})")
                del dropped
            rows = valid_rows(mask, B, Lq, Lk, causal, "cuda")
            worst = max(worst, err)
            cases.append({"case": name, "dtype": dt_name,
                          "shape": [B, H, Lq, Lk, Dh], "causal": causal,
                          "tile": list(tile) if dt_name == "bfloat16"
                          and Dh <= fa.MAX_HEAD_DIM else None,
                          "mask": mask_kind, "max_abs_err": err,
                          "row_rel_err": rel, "held": held,
                          "control_without_first_tile": control,
                          "rows_without_a_valid_key":
                              int((~rows).sum()) * H,
                          "tol": TOL[dt_name]})
            del q, k, v, mask, out, ref
            torch.cuda.empty_cache()
    unserved = table_rows_unserved(KERNEL_CASES)
    check(not unserved, f"kernels: no case serves the block table's rows "
                        f"{unserved}")
    emit({"phase": "kernels", "kernels": [
        {"name": "flash_attention", "max_abs_err": worst, "cases": cases}]})
    return worst


def table_rows_unserved(cases) -> list:
    """The committed block table's ``cuda:bfloat16`` rows that no case of
    ``cases`` launches with (a row serves a case when the pow2 bucket of
    its Lq or Lk is the row's): each row's tile must be held against the
    plain version at a shape it serves."""
    from vainplex_openclaw_tpu_torch.ops import flash_attention as fa
    from vainplex_openclaw_tpu_torch.ops.similarity import pow2_bucket

    rows = fa.load_block_table(fa.TABLE_PATH).get("entries", {})
    served = {b for c in cases for b in (pow2_bucket(c[3]),
                                         pow2_bucket(c[4]))}
    return sorted(k for k in rows if k.startswith("cuda:bfloat16:")
                  and int(k.split(":")[2]) not in served)


def random_tree(cfg, seed: int) -> dict:
    """A JAX-layout parameter tree from a numpy seed, scaled like
    ``init_params`` (embeddings 0.02, matrices 1/√fan_in, norms ones)."""
    import numpy as np

    from vainplex_openclaw_tpu_torch.models.encoder import (
        param_shapes, unflatten_tree)

    rng = np.random.default_rng(seed)
    flat = {}
    for key, shape in param_shapes(cfg).items():
        if key.endswith("/scale"):
            flat[key] = np.ones(shape, np.float32)
        else:
            std = 0.02 if key.startswith("embed/") else 1 / math.sqrt(shape[0])
            flat[key] = (rng.standard_normal(shape) * std).astype(np.float32)
    return unflatten_tree(flat)


def compare_outputs(a: dict, b: dict) -> float:
    return max(float((a[h].float().cpu() - b[h].float().cpu()).abs().max())
               for h in ("severity", "keep", "mood", "embedding"))


def phase_forward() -> dict:
    import dataclasses

    import numpy as np
    import torch

    from vainplex_openclaw_tpu_torch.models import (
        EncoderConfig, encode_texts, forward, params_from_numpy)
    from vainplex_openclaw_tpu_torch.models.pretrained import load_pretrained
    from vainplex_openclaw_tpu_torch.ops import flash_attention as fa

    record = {"phase": "forward"}
    cfg, p_gpu = load_pretrained()
    _, p_cpu = load_pretrained(device="cpu")
    tokens = torch.from_numpy(encode_texts(seeded_texts(512, seed=0),
                                           cfg.seq_len, cfg.vocab_size))
    with torch.inference_mode():
        gpu = forward(p_gpu, tokens.cuda(), cfg)
        cpu = forward(p_cpu, tokens, cfg)
    err = compare_outputs(gpu, cpu)
    same = bool((gpu["severity"].cpu().argmax(-1)
                 == cpu["severity"].argmax(-1)).all())
    check(same, "shipped checkpoint: severity argmax differs card vs CPU")
    check(err <= 5e-2, f"shipped checkpoint: logits differ by {err} > 5e-2")
    record["shipped"] = {"texts": 512, "argmax_equal": same,
                         "max_abs_err": err, "tol": 5e-2}

    wide = EncoderConfig()
    tree = random_tree(wide, seed=1)
    rng = np.random.default_rng(2)
    lengths = rng.integers(1, wide.seq_len + 1, size=32)
    lengths[-4:] = 0
    tok = rng.integers(2, wide.vocab_size, size=(32, wide.seq_len))
    tok[:, 0] = 1
    tok[np.arange(wide.seq_len)[None, :] >= lengths[:, None]] = 0
    tok = torch.from_numpy(tok.astype(np.int32))
    for dt_name, tol in (("float32", 1e-4), ("bfloat16", 5e-2)):
        c = dataclasses.replace(wide, dtype=dt_name)
        with torch.inference_mode():
            p_card = params_from_numpy(tree, c, "cuda")
            torch.cuda.synchronize()
            fa.launches = 0
            gpu = forward(p_card, tok.cuda(), c)
            torch.cuda.synchronize()
            launches = fa.launches
            cpu = forward(params_from_numpy(tree, c, "cpu"), tok, c)
        check(launches == c.n_layers, f"random weights {dt_name}: K1 "
                                      f"launches {launches} != {c.n_layers}")
        err = compare_outputs(gpu, cpu)
        check(all(bool(torch.isfinite(gpu[h]).all()) for h in gpu),
              f"random weights {dt_name}: non-finite output")
        check(err <= tol, f"random weights {dt_name}: outputs differ by "
                          f"{err} > {tol}")
        record[f"random_{dt_name}"] = {
            "batch": 32, "max_abs_err": err, "tol": tol,
            "k1_launches": launches,
            "k1_shape": [32, c.n_heads, c.seq_len, c.seq_len,
                         c.d_model // c.n_heads]}
    emit(record)
    return record


def serve_round(call, prompts: list, n_threads: int):
    """Every prompt through ``call`` from ``n_threads`` threads; returns
    (verdicts, per-request ms, wall s, errors)."""
    got: list = [None] * len(prompts)
    latency: list = [0.0] * len(prompts)
    errors: list = []

    def worker(w: int) -> None:
        try:
            for i in range(w, len(prompts), n_threads):
                t = time.perf_counter()
                got[i] = call(prompts[i])
                latency[i] = (time.perf_counter() - t) * 1e3
        except Exception as exc:  # noqa: BLE001 — reported by the caller
            errors.append(repr(exc))

    threads = [threading.Thread(target=worker, args=(w,))
               for w in range(n_threads)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(300.0)
    check(not any(t.is_alive() for t in threads), "serve threads hung")
    return got, latency, time.perf_counter() - t0, errors


def device_rows(prof) -> list:
    """(device µs, name, count) of every kernel and copy in a profile. Only
    the device's own events count: a host op's device time repeats the
    time of the kernels it launched, which have rows of their own."""
    from torch.autograd import DeviceType

    rows = []
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CPU:
            continue
        t = (getattr(evt, "self_device_time_total", None)
             or getattr(evt, "self_cuda_time_total", 0.0) or 0.0)
        if t > 0:
            rows.append((t, evt.key, evt.count))
    return rows


def device_busy(prof, wall_s: float) -> dict:
    """Device time of every kernel and copy in a profiled window, its share
    of the window's wall time, and the five largest entries."""
    rows = sorted(device_rows(prof), reverse=True)
    total_us = sum(r[0] for r in rows)
    return {"device_ms": total_us / 1e3,
            "busy_share": total_us / 1e6 / wall_s,
            "top": [{"name": k[:80], "device_ms": t / 1e3, "count": c}
                    for t, k, c in rows[:5]]}


def phase_serve() -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vainplex_openclaw_tpu_torch.models import serve
    from vainplex_openclaw_tpu_torch.models.pretrained import load_pretrained
    from vainplex_openclaw_tpu_torch.ops import flash_attention as fa

    n_requests, n_threads = 256, 32
    prompts = [as_prompt(t) for t in seeded_texts(n_requests, seed=3)]
    oracle_call = serve.make_local_call_llm(
        serve_cfg={"continuousBatching": False}, device="cpu")
    oracle = [oracle_call(p) for p in prompts]

    call = serve.make_local_call_llm()
    batcher = call.batcher
    cfg, _ = load_pretrained()
    # The collector thread's first forward sets up its own cuBLAS handle:
    # one request first, timed on its own, outside the counted run.
    t = time.perf_counter()
    call(as_prompt("warm-up request"))
    first_ms = (time.perf_counter() - t) * 1e3

    batches0, served0 = batcher.batches, batcher.served
    torch.cuda.synchronize()
    fa.launches = 0
    got, latency, wall, errors = serve_round(call, prompts, n_threads)
    launches = fa.launches
    batches = batcher.batches - batches0
    served = batcher.served - served0
    check(not errors, f"serve errors: {errors[:3]}")
    check(served == n_requests, f"served {served} of {n_requests}")
    mismatches = sum(a != b for a, b in zip(got, oracle))
    check(mismatches == 0, f"{mismatches} verdicts differ from the CPU "
                           "one-shot oracle")
    check(launches > 0 and launches == cfg.n_layers * batches,
          f"flash_attention launches {launches} != {cfg.n_layers} layers × "
          f"{batches} batches")
    snap = batcher.timer.snapshot()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        got2, _, wall2, errors2 = serve_round(call, prompts, n_threads)
        torch.cuda.synchronize()
    check(not errors2 and got2 == oracle, "profiled serve round differs")

    lat = sorted(latency)
    record = {"phase": "serve", "requests": n_requests, "threads": n_threads,
              "served": served, "batches": batches,
              "mean_batch": served / batches, "verdict_mismatches": 0,
              "flash_attention_launches": launches,
              "first_request_ms": first_ms,
              "requests_per_s": n_requests / wall,
              "latency_ms": {"p50": lat[len(lat) // 2],
                             "p99": lat[min(len(lat) - 1,
                                            int(0.99 * len(lat)))],
                             "max": lat[-1]},
              "stage_quantiles_ms": snap["quantiles"],
              "stage_ms": snap["stages_ms"],
              "stage_counts": snap["counts"],
              "profiled_round": {"wall_s": wall2,
                                 **device_busy(prof, wall2)}}
    emit(record)
    serve.close_batchers()
    return {"launches": launches,
            "latency": {"requests_per_s": record["requests_per_s"],
                        "p50_ms": record["latency_ms"]["p50"],
                        "p99_ms": record["latency_ms"]["p99"]}}


# ── the port's front door: Gateway → GovernancePlugin → stage 3 ───────────

GATEWAY_TEXTS = 256
GATEWAY_THREADS = 32
GATEWAY_POLICY_CALLS = 5000
# every CONTRADICT_EVERY-th text claims a subject is stopped, against a
# seeded fact that it runs: stage 2 blocks it at the default trust, and
# stage 3 still scores it (the verdicts merge, ``more_restrictive``)
CONTRADICT_EVERY = 16
GATEWAY_FACTS = [{"subject": s, "predicate": "state", "value": "running"}
                 for s in _SUBJECTS[:4]]
GATEWAY_META = {"agent_id": "main", "session_key": "agent:main",
                "channel_id": "twitter"}


def gateway_texts(n: int, seed: int) -> list:
    """``n`` distinct seeded texts; every ``CONTRADICT_EVERY``-th, from the
    sixth on, says one of ``GATEWAY_FACTS``' subjects is stopped."""
    pool = iter(dict.fromkeys(seeded_texts(8 * n, seed)))
    out = []
    for i in range(n):
        if i % CONTRADICT_EVERY == 5:
            subject = GATEWAY_FACTS[(i // CONTRADICT_EVERY)
                                    % len(GATEWAY_FACTS)]["subject"]
            out.append(f"{subject} is stopped after {i} retries")
        else:
            out.append(next(pool))
    check(len(set(out)) == n, "gateway texts are not distinct")
    return out


def governance_gateway(workspace: str, device=None, serve_cfg=None):
    """The port's ``Gateway`` with a config-only ``GovernancePlugin``:
    default builtins, the audit journal at its default, and stage 3 served
    by the local encoder on ``device`` (fail closed)."""
    from vainplex_openclaw_tpu_torch.core import Gateway
    from vainplex_openclaw_tpu_torch.core.api import list_logger
    from vainplex_openclaw_tpu_torch.governance import GovernancePlugin

    lcfg = {"enabled": True, "local": True, "failMode": "closed"}
    if serve_cfg is not None:
        lcfg["serve"] = serve_cfg
    logger = list_logger()
    gw = Gateway(config={"workspace": workspace, "agents": [{"id": "main"}]},
                 logger=logger)
    plugin = GovernancePlugin(device=device)
    gw.load(plugin, plugin_config={"validation": {
        "enabled": True, "facts": GATEWAY_FACTS, "llmValidator": lcfg}},
        logger=logger)
    gw.start()
    return gw, plugin


def gateway_call(gw):
    """``text -> (blocked, content, block_reason)`` through
    ``gw.message_sending``, for ``serve_round``."""
    def call(text: str) -> tuple:
        d = gw.message_sending(text, dict(GATEWAY_META))
        return d.blocked, d.content, d.block_reason

    return call


def latency_summary(latency: list, wall_s: float) -> dict:
    lat = sorted(latency)
    return {"requests_per_s": len(lat) / wall_s,
            "p50_ms": lat[len(lat) // 2],
            "p99_ms": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
            "max_ms": lat[-1]}


def audit_readback(workspace: str) -> dict:
    """The audit day files after ``gw.stop()``: every line parsed, with
    the reader's torn and corrupt counts."""
    from pathlib import Path

    from vainplex_openclaw_tpu_torch.storage.atomic import (JsonlReadReport,
                                                            read_jsonl)

    records, corrupt, torn = [], 0, 0
    for path in sorted((Path(workspace) / "governance" / "audit")
                       .glob("*.jsonl")):
        report = JsonlReadReport()
        records += list(read_jsonl(path, report=report))
        corrupt += report.corrupt_lines
        torn += report.torn_tail is not None
    return {"records": records, "corrupt_lines": corrupt, "torn_tails": torn}


def check_audit(workspace: str, texts: list, leg: str) -> int:
    """One whole audit record for each evaluation of ``texts``."""
    back = audit_readback(workspace)
    recs = back["records"]
    check(back["corrupt_lines"] == 0 and back["torn_tails"] == 0,
          f"{leg}: audit files torn or corrupt: {back['corrupt_lines']} "
          f"corrupt lines, {back['torn_tails']} torn tails")
    check(len(recs) == len(texts), f"{leg}: {len(recs)} audit records for "
                                   f"{len(texts)} evaluations")
    check(len({r["id"] for r in recs}) == len(recs),
          f"{leg}: audit ids repeat")
    check(sorted(r["context"]["messageContent"] for r in recs)
          == sorted(texts), f"{leg}: audit records do not match the texts")
    check(all(r["context"]["hook"] == "message_sending"
              and r["verdict"] == "allow" for r in recs),
          f"{leg}: an audit record is not the allowed message_sending")
    return len(recs)


def bench_user_policies() -> list:
    """``bench.py``'s ``_bench_user_policies`` (``:480-489``): ten
    regex-gated audit policies, which the compiled planner folds into one
    prefilter bank."""
    return [
        {"id": f"p{i}", "priority": 50 + i,
         "scope": {"hooks": ["before_tool_call"]},
         "rules": [{"action": "audit",
                    "conditions": [{"type": "tool", "tools": ["exec"],
                                    "params": {"command":
                                               {"matches": f"pattern-{i}-[a-z]+"}}}]}]}
        for i in range(10)]


def policy_leg(workspace: str, n: int) -> dict:
    """``bench.py``'s ``_bench_policy_eval`` setup (``:451-487``) through
    the port's gateway: one warm-up, then ``n`` timed
    ``before_tool_call("exec", ...)`` calls. Host work only: no stage 3."""
    from vainplex_openclaw_tpu_torch.core import Gateway
    from vainplex_openclaw_tpu_torch.core.api import list_logger
    from vainplex_openclaw_tpu_torch.governance import GovernancePlugin

    gw = Gateway(config={"workspace": workspace, "agents": [{"id": "main"}]},
                 logger=list_logger())
    plugin = GovernancePlugin()
    gw.load(plugin, plugin_config={"policies": bench_user_policies()})
    gw.start()
    ctx = {"agent_id": "main", "session_key": "agent:main:s"}
    gw.before_tool_call("exec", {"command": "ls -la /tmp"}, ctx)
    reasons: dict = {}
    t0 = time.perf_counter()
    for i in range(n):
        d = gw.before_tool_call("exec", {"command": f"ls -la /tmp/dir{i}"},
                                ctx)
        key = (d.block_reason or "allow").split(" (")[0]
        reasons[key] = reasons.get(key, 0) + 1
    ms = (time.perf_counter() - t0) * 1e3 / n
    stages = plugin.engine.timer.stages_ms()
    status = gw.call_method("governance.status")
    audited = plugin.engine.audit_trail.stats()["today"]
    gw.stop()
    evaluations = status["stats"]["totalEvaluations"]
    check(evaluations == n + 1, f"policy leg: {evaluations} evaluations "
                                f"for {n + 1} calls")
    check(reasons.get("Rate limit exceeded", 0) > 0,
          f"policy leg: the rate limiter never denied ({reasons})")
    check(audited == evaluations, f"policy leg: {audited} audit records "
                                  f"for {evaluations} evaluations")
    return {"calls": n, "ms_per_call": ms, "stage_ms": stages,
            "decisions": reasons, "evaluations": evaluations,
            "audited": audited,
            "policy_count": status["policyCount"]}


def gateway_legs(device, texts: list, n_threads: int, root: str,
                 count=None) -> dict:
    """The serial and concurrent legs on ``device`` against the one-shot
    oracle on the CPU. ``count()`` reads the attention kernel's launches
    (None on the CPU, whose plain attention counts nothing)."""
    import os

    from vainplex_openclaw_tpu_torch.models import serve

    record: dict = {}
    ws = {name: os.path.join(root, name)
          for name in ("oracle", "serial", "concurrent")}
    for path in ws.values():
        os.makedirs(path)
    gw, _ = governance_gateway(ws["oracle"], "cpu",
                               {"continuousBatching": False})
    oracle, _, _, errors = serve_round(gateway_call(gw), texts, 1)
    gw.stop()
    check(not errors, f"gateway oracle errors: {errors[:3]}")

    for leg, threads in (("serial", 1), ("concurrent", n_threads)):
        gw, plugin = governance_gateway(ws[leg], device)
        call = plugin.engine.output_validator.llm_validator.call_llm
        batcher = call.batcher
        check(gw.stage_timers.get("serve") is batcher.timer,
              f"{leg}: the serve timer is not registered on the gateway")
        # the collector's first forward sets up its own handles: one
        # request straight to the batcher, outside the counted run
        batcher.submit("warm-up request")
        batches0 = batcher.batches
        if count is not None:
            count(reset=True)
        got, latency, wall, errors = serve_round(gateway_call(gw), texts,
                                                 threads)
        launches = count() if count is not None else None
        batches = batcher.batches - batches0
        check(not errors, f"{leg}: gateway errors: {errors[:3]}")
        want = oracle if leg == "serial" else record["serial"]["decisions"]
        mismatches = sum(a != b for a, b in zip(got, want))
        check(mismatches == 0,
              f"{leg}: {mismatches} decisions differ from the "
              f"{'CPU one-shot oracle' if leg == 'serial' else 'serial leg'}")
        status = gw.call_method("governance.status")
        snap = batcher.timer.snapshot()
        gw.stop()
        audited = check_audit(ws[leg], texts, leg)
        rec = {"decisions": got, "batches": batches,
               "mean_batch": len(texts) / batches if batches else None,
               "launches": launches, "audited": audited,
               "evaluations": status["stats"]["totalEvaluations"],
               "governance_stage_ms": status["stageMs"],
               "serve_stage_quantiles_ms": snap["quantiles"],
               **latency_summary(latency, wall)}
        if leg == "serial":
            check(rec["evaluations"] == len(texts),
                  f"serial: governance.status shows {rec['evaluations']} "
                  f"evaluations for {len(texts)} messages")
        record[leg] = rec
    blocked = sum(d[0] for d in oracle)
    check(0 < blocked < len(texts),
          f"{blocked} of {len(texts)} blocked: both kinds must occur")
    record["blocked"] = blocked
    record["stage3_blocked"] = sum(
        bool(d[0] and d[2] and "local triage encoder" in d[2])
        for d in oracle)
    record["merged"] = sum(
        bool(d[2] and "Contradiction" in d[2]
             and "local triage encoder" in d[2]) for d in oracle)
    serve.close_batchers()
    return record

def phase_gateway(smi: str, served: dict) -> dict:
    """The port's ``Gateway`` → ``GovernancePlugin`` → stage 3 on the card:
    the serial and concurrent legs against the CPU one-shot oracle, K1 =
    n_layers x batches in each, a bare serve round on the same texts and
    threads beside them, and the policy leg on the host."""
    import os
    import tempfile

    import torch

    from vainplex_openclaw_tpu_torch.models import serve
    from vainplex_openclaw_tpu_torch.models.pretrained import load_pretrained
    from vainplex_openclaw_tpu_torch.ops import flash_attention as fa

    cfg, _ = load_pretrained()
    texts = gateway_texts(GATEWAY_TEXTS, seed=17)

    def count(reset: bool = False) -> int:
        torch.cuda.synchronize()
        if reset:
            fa.launches = 0
        return fa.launches

    t_phase = time.perf_counter()
    saved_home = os.environ.get("OPENCLAW_HOME")
    with tempfile.TemporaryDirectory() as root:
        os.environ["OPENCLAW_HOME"] = os.path.join(root, "home")
        try:
            legs = gateway_legs(None, texts, GATEWAY_THREADS, root, count)
            # the bare serve path at the same load: the same texts from
            # the same threads through make_local_call_llm
            call = serve.make_local_call_llm()
            call(as_prompt("warm-up request"))
            batches0 = call.batcher.batches
            count(reset=True)
            _, latency, wall, errors = serve_round(
                call, [as_prompt(t) for t in texts], GATEWAY_THREADS)
            bare_launches = count()
            bare_batches = call.batcher.batches - batches0
            serve.close_batchers()
            check(not errors, f"bare serve errors: {errors[:3]}")
            policy = policy_leg(os.path.join(root, "policy"),
                                GATEWAY_POLICY_CALLS)
        finally:
            if saved_home is None:
                os.environ.pop("OPENCLAW_HOME", None)
            else:
                os.environ["OPENCLAW_HOME"] = saved_home
    for leg, launches, batches in (
            ("serial", legs["serial"]["launches"], legs["serial"]["batches"]),
            ("concurrent", legs["concurrent"]["launches"],
             legs["concurrent"]["batches"]),
            ("bare", bare_launches, bare_batches)):
        check(launches > 0 and launches == cfg.n_layers * batches,
              f"gateway {leg}: flash_attention launches {launches} != "
              f"{cfg.n_layers} layers x {batches} batches")
    bare = {"batches": bare_batches, "launches": bare_launches,
            **latency_summary(latency, wall)}
    conc = legs["concurrent"]
    record = {"phase": "gateway", "nvidia_smi": smi, "texts": len(texts),
              "threads": GATEWAY_THREADS, "blocked": legs["blocked"],
              "stage3_blocked": legs["stage3_blocked"],
              "merged": legs["merged"],
              "serial": {k: v for k, v in legs["serial"].items()
                         if k != "decisions"},
              "concurrent": {k: v for k, v in conc.items()
                             if k != "decisions"},
              "bare_serve": bare,
              "serve_phase": served.get("latency"),
              "governance_host_cost": {
                  "p50_ms": conc["p50_ms"] - bare["p50_ms"],
                  "p99_ms": conc["p99_ms"] - bare["p99_ms"],
                  "requests_per_s_ratio":
                      conc["requests_per_s"] / bare["requests_per_s"]},
              "policy": policy,
              "seconds": time.perf_counter() - t_phase}
    emit(record)
    return {"launches": legs["serial"]["launches"] + conc["launches"],
            "serial_launches": legs["serial"]["launches"],
            "concurrent_launches": conc["launches"]}


def time_ms(fn, n: int = 200, reps: int = 15, warmup: int = 20) -> float:
    """Median over ``reps`` of CUDA-event time per call across ``n``
    back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / n)
    return statistics.median(samples)


def served_library(L: int):
    """The bf16 K1/K2 library a launch at length L loads: the tile the
    block table names for L's bucket (``launch_tiles``), the compiled
    default without a row."""
    from vainplex_openclaw_tpu_torch.ops import _build
    from vainplex_openclaw_tpu_torch.ops import flash_attention as fa

    return _build.load_library("flash_attention",
                               tiles=fa.launch_tiles(L, L, "bfloat16"))


def raw_launch(lib, q, k, v, bias, out, what: str, scale=None):
    """A call that launches K1 from ``lib`` into ``out`` (a tensor), or K2
    into ``out`` = ``(acc, m, l)``, on q, k, v and the bias at q's head dim
    (one ``lib`` takes) and the softmax scale (default: q's head dim's):
    the C entry point alone, with no count and no allocation, for timing.
    A CUDA error raises."""
    import torch

    from vainplex_openclaw_tpu_torch.ops import flash_attention as fa

    B, H, Lq, Dh = q.shape
    Lk = k.shape[2]
    stats = isinstance(out, tuple)
    entry = lib.flash_attention_stats_fwd if stats else lib.flash_attention_fwd
    outs = out if stats else (out,)

    def launch():
        err = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                    *(t.data_ptr() for t in outs), B, H, Lq, Lk, Dh,
                    fa._DTYPE_CODES[q.dtype], 0,
                    Dh ** -0.5 if scale is None else scale,
                    torch.cuda.current_stream().cuda_stream)
        if err:
            raise SmokeFailure(f"{what} launch failed: CUDA error {err}")

    return launch


def device_kernel_ms(fn, n: int = 50) -> dict:
    """Device time of the CUDA kernels that ``n`` calls of ``fn`` launch,
    from the profiler: per call, and per kernel record it kept. ``fn``
    launches one kernel, so ``records`` below ``n`` means the profiler lost
    some and the time per call reads low; both are None without device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    rows = device_rows(prof)
    total_ms = sum(r[0] for r in rows) / 1e3
    records = sum(r[2] for r in rows)
    return {"calls": n, "records": records,
            "ms_per_call": total_ms / n if total_ms > 0 else None,
            "ms_per_record": total_ms / records if total_ms > 0 else None}


def phase_timing() -> dict:
    import numpy as np
    import torch
    import torch.nn.functional as F

    from vainplex_openclaw_tpu_torch.models import encode_texts, forward
    from vainplex_openclaw_tpu_torch.models.pretrained import load_pretrained
    from vainplex_openclaw_tpu_torch.ops import flash_attention as fa

    B, H, L, Dh = 32, 4, 64, 16
    q, k, v, mask = make_qkv(np.random.default_rng(4), B, H, L, L, Dh,
                             torch.bfloat16, "prefix", "cuda")
    bias = fa._bias(mask, B, L, q.device)
    kernel = raw_launch(served_library(L), q, k, v, bias, torch.empty_like(q),
                        "timing")

    def wrapper():
        fa.flash_attention(q, k, v, mask)

    def plain():
        fa.flash_attention_reference(q, k, v, mask)

    sdpa_mask = bias.to(q.dtype)[:, None, None, :]

    def library():
        F.scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask)

    # kernel, plain, plain, kernel and kernel, SDPA, SDPA, kernel: compare
    # within one call, in turns
    kernel_ms = [time_ms(kernel)]
    plain_ms = [time_ms(plain)]
    plain_ms.append(time_ms(plain))
    kernel_ms.append(time_ms(kernel))
    library_ms = [time_ms(library)]
    library_ms.append(time_ms(library))
    kernel_ms.append(time_ms(kernel))
    wrapper_ms = time_ms(wrapper)
    kernel_device = device_kernel_ms(kernel)
    bound = attention_bound(B, H, L, L, Dh, q.element_size(), stats=False)

    cfg, params = load_pretrained()
    tokens = torch.from_numpy(encode_texts(seeded_texts(B, seed=5),
                                           cfg.seq_len, cfg.vocab_size)).cuda()
    torch.cuda.synchronize()
    fa.launches = 0
    with torch.inference_mode():
        forward(params, tokens, cfg)
    torch.cuda.synchronize()
    per_forward = fa.launches
    check(per_forward == cfg.n_layers,
          f"launches per forward {per_forward} != n_layers {cfg.n_layers}")

    record = {"phase": "timing", "shape": [B, H, L, L, Dh],
              "dtype": "bfloat16",
              "kernel_ms": statistics.median(kernel_ms),
              "kernel_ms_runs": kernel_ms,
              "kernel_device": kernel_device,
              "wrapper_ms": wrapper_ms,
              "plain_ms": statistics.median(plain_ms),
              "plain_ms_runs": plain_ms,
              "library_ms": statistics.median(library_ms),
              "library_ms_runs": library_ms, **bound,
              "launches_per_forward": per_forward}
    emit(record)
    return record


def stats_errors(got, want, rows, dt_name: str = "float32"):
    """(max |Δm|, max |Δl|/l, max |Δacc|/l, acc per row) over ``rows``
    [B, 1, Lq, 1]: m absolute; l and the unnormalized acc relative to the
    plain l, since both grow with the key count; in bf16 also acc per row
    relative to the row's largest |acc| (``kernel_search.held_error``: a
    kernel that dropped a key tile of a long row moves l by a few percent,
    its acc by ~sqrt(64 / keys)), else 0."""
    (acc, m, l), (acc_w, m_w, l_w) = got, want
    r = rows[..., 0].expand_as(m)
    scale = l_w.clamp_min(1e-30)
    em = float((m - m_w).abs()[r].max())
    el = float(((l - l_w).abs() / scale)[r].max())
    ea = float(((acc - acc_w).abs().amax(dim=-1) / scale)[r].max())
    ar = 0.0
    if dt_name == "bfloat16":
        ar = float(((acc - acc_w).abs().amax(dim=-1)
                    / acc_w.abs().amax(dim=-1).clamp_min(1e-30))[r].max())
    return em, el, ea, ar


def phase_kernels_stats() -> float:
    import numpy as np
    import torch

    from vainplex_openclaw_tpu_torch.ops import flash_attention as fa
    from vainplex_openclaw_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_stats_reference)

    rng = np.random.default_rng(10)
    cases = []
    worst = 0.0
    for name, B, H, Lq, Lk, Dh, causal, mask_kind in STATS_CASES:
        for dt_name, dtype in (("bfloat16", torch.bfloat16),
                               ("float32", torch.float32)):
            q, k, v, mask = make_qkv(rng, B, H, Lq, Lk, Dh, dtype, mask_kind,
                                     "cuda")
            before = fa.stats_launches
            got = flash_attention(q, k, v, mask, causal=causal,
                                  return_stats=True)
            check(fa.stats_launches == before + 1,
                  f"K2 {name}/{dt_name}: {fa.stats_launches - before} "
                  "launches for one call")
            want = flash_attention_stats_reference(q, k, v, mask,
                                                   causal=causal)
            torch.cuda.synchronize()
            acc, m, l = got
            check(acc.dtype == m.dtype == l.dtype == torch.float32
                  and acc.shape == q.shape and m.shape == l.shape == q.shape[:3],
                  f"K2 {name}/{dt_name}: outputs {acc.dtype} "
                  f"{tuple(acc.shape)} {tuple(m.shape)}")
            check(all(bool(torch.isfinite(t).all()) for t in got),
                  f"K2 {name}/{dt_name}: non-finite output")
            rows = valid_rows(mask, B, Lq, Lk, causal, "cuda")
            em, el, ea, ar = stats_errors(got, want, rows, dt_name)
            err = max(em, el, ea, ar)
            check(err <= TOL[dt_name],
                  f"K2 {name}/{dt_name}: |Δm| {em}, |Δl|/l {el}, "
                  f"|Δacc|/l {ea}, acc per row {ar} > {TOL[dt_name]}")
            control = None
            if Lk >= CONTROL_MIN_LK and not causal:
                dropped = flash_attention_stats_reference(
                    q, k[:, :, 64:].contiguous(), v[:, :, 64:].contiguous(),
                    None if mask is None else mask[:, 64:].contiguous())
                control = max(stats_errors(dropped, want, rows, dt_name))
                check(control > TOL[dt_name],
                      f"K2 {name}/{dt_name}: the check passes the plain "
                      f"version without its first key tile ({control})")
                del dropped
            masked_rows = None
            if mask is not None and not causal:
                empty = ~mask.any(dim=1)
                if bool(empty.any()):
                    # keys past Lk count nothing: l is the real key count
                    check(bool((m[empty] == -1e30).all())
                          and bool((l[empty] == float(Lk)).all()),
                          f"K2 {name}/{dt_name}: a row with no valid key has "
                          f"m {float(m[empty].max())}, l {float(l[empty].max())}")
                    masked_rows = int(empty.sum())
            worst = max(worst, err)
            cases.append({"case": name, "dtype": dt_name,
                          "shape": [B, H, Lq, Lk, Dh], "causal": causal,
                          "mask": mask_kind, "m_abs_err": em, "l_rel_err": el,
                          "acc_rel_err": ea, "acc_row_rel_err": ar,
                          "control_without_first_tile": control,
                          "tol": TOL[dt_name],
                          "rows_without_a_valid_key": masked_rows})
            del q, k, v, mask, got, want, acc, m, l
            torch.cuda.empty_cache()
    emit({"phase": "kernels_stats", "kernels": [
        {"name": "flash_attention_stats", "max_err": worst, "cases": cases}]})
    return worst


# the fp32 kernel at the compiled widths (flash_fwd_fp32), K1 and K2: B=2
# H=2 L=2048 at Dh 64 and 128; the ring phase's fp32 shard (B=8 H=2
# L=4096 Dh 16, K2 32 times there); the long_16384 case (B=1 H=2 L=16384,
# whose plain version fits where B=8's does not); the fp32 legs' shape
# (B=32 H=4 L=64 Dh 16). Each is a KERNEL_CASES and a STATS_CASES shape.
FP32_WALK_SHAPES = [("fp32_walk_dh64", 2, 2, 2048, 2048, 64),
                    ("fp32_walk_dh128", 2, 2, 2048, 2048, 128),
                    ("fp32_walk_ring_shard", 8, 2, 4096, 4096, 16),
                    ("fp32_walk_long_16384", 1, 2, LONG_L, LONG_L, 16),
                    ("fp32_walk_legs", 32, 4, 64, 64, 16)]


def phase_timing_wide(smi: str) -> dict:
    """K1 and K2 at every non-causal ``WIDE_CASES`` shape (head dims 129,
    256 and 384, B=2 H=2 L=2048 at 256 and the ragged Lq=1000 Lk=1999) in
    bf16 and fp32, and the fp32 kernel at the compiled widths at
    ``FP32_WALK_SHAPES``, each timed by :func:`time_attention` beside its
    bound, its plain version and SDPA on the same inputs. Of these only
    the fp32 ones that the ring phase and the fp32 legs launch (but for
    the batch) are main-path shapes (:func:`walk_line`)."""
    t0 = time.perf_counter()
    timed = []
    for i, (name, B, H, Lq, Lk, Dh, causal, _) in enumerate(WIDE_CASES):
        if causal:
            continue
        for dt_name in ("bfloat16", "float32"):
            for stats in (False, True):
                timed.append({"name": name, **time_attention(
                    B, H, Lq, Lk, Dh, dt_name, stats, seed=300 + i, n=20,
                    reps=5)})
    walk = [{"name": name, **time_attention(B, H, Lq, Lk, Dh, "float32",
                                            stats, seed=320 + i, n=20,
                                            reps=5)}
            for i, (name, B, H, Lq, Lk, Dh) in enumerate(FP32_WALK_SHAPES)
            for stats in (False, True)]
    record = {"phase": "timing_wide", "nvidia_smi": smi, "shapes": timed,
              "fp32_walk": walk, "seconds": time.perf_counter() - t0}
    emit(record)
    return record


def wide_line(wide: dict, stats: bool, key: str = "shapes") -> list:
    """The kernels line's shapes of ``phase_timing_wide`` under ``key``
    (the head dims above 128, or the fp32 kernel's ``fp32_walk``) for K1
    or K2: measured ms beside the bound, the plain version and SDPA (for
    K2 ``sdpa_normalized_ms``), with no path or launches (:func:`walk_line`
    adds them where a main path runs the shape)."""
    return [{"name": t["name"], "shape": t["shape"], "dtype": t["dtype"],
             "path": None, "launches": None, "ms": t["kernel_ms"],
             "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
             "plain_ms": t["plain_ms"], "library_ms": t["library_ms"],
             **({"sdpa_normalized_ms": t["sdpa_normalized_ms"]}
                if stats else {})}
            for t in wide[key] if t["stats"] == stats]


def fp32_launches(forwarded: dict, grad: dict, mesh: dict, ring: dict,
                  graft: dict) -> dict:
    """The fp32 kernel's launches on the paths that run it, from each
    phase's own record: ``{"k1"|"k2": [(path, shape, launches)]}``, the
    shape [B, H, Lq, Lk, Dh] of every launch the entry counts (None where
    a path launches at several: the mesh legs' shards, the dryrun's)."""
    k1 = [("forward", forwarded["random_float32"]["k1_shape"],
           forwarded["random_float32"]["k1_launches"]),
          ("grad", grad["float32"]["k1_shape"],
           grad["float32"]["k1_launches"])]
    for path, shapes in (("mesh_tp", [v for v in mesh["tp"]["record"].values()
                                      if isinstance(v, dict)
                                      and "float32" in v]),
                         ("mesh_pp", [mesh["pp"]["record"]])):
        for entry in shapes:
            leg = entry["float32"]
            k1.append((path, leg["reference_k1_shape"],
                       leg["reference_k1_launches"]))
            k1.append((path, None, leg["k1_per_forward"]["counted"]))
    sp4, sp1 = ring["float32"]["k2_shapes"]
    k2 = [("ring", sp4, ring["float32"]["k2_launches"]),
          ("ring", sp1, ring["float32"]["k2_launches_sp1"])]
    k2 += [(path, None, n) for path, n in dryrun_launches(graft, "k2").items()
           if path == "dryrun_ring_flash"]
    return {"k1": k1, "k2": k2}


def fp32_by_path(launched: list) -> dict:
    """``{path: launches}`` of :func:`fp32_launches`' entries."""
    out: dict = {}
    for path, _, n in launched:
        out[path] = out.get(path, 0) + n
    return out


def walk_line(wide: dict, stats: bool, launched: list) -> list:
    """:func:`wide_line` of the fp32 kernel's timed shapes, each with the
    launches of the paths that run its shape but for the batch (which
    only multiplies the blocks), and those paths' shapes."""
    line = wide_line(wide, stats, key="fp32_walk")
    for row in line:
        hits = [(path, shape, n) for path, shape, n in launched
                if shape is not None and shape[1:] == row["shape"][1:]]
        if hits:
            row["path"] = "+".join(dict.fromkeys(p for p, _, _ in hits))
            row["launches"] = sum(n for _, _, n in hits)
            row["launched_shapes"] = [[p, shape, n] for p, shape, n in hits]
    return line


_WORDS = tuple(sorted({w for t in _TEMPLATES + _SUBJECTS
                       for w in t.replace("{n}", "").replace("{i}", "")
                       .replace("-", " ").split() if w.isalpha()}))


def text_of(n_tokens: int, rng) -> str:
    """A message the tokenizer reads as ``n_tokens`` real tokens (the CLS
    token and ``n_tokens - 1`` words)."""
    return " ".join(_WORDS[i] for i in rng.integers(len(_WORDS),
                                                    size=n_tokens - 1))


def long_params(cfg, device):
    import torch

    from vainplex_openclaw_tpu_torch.models.encoder import (
        init_params, params_from_numpy)

    tree = init_params(cfg, torch.Generator().manual_seed(0))
    return params_from_numpy(tree, cfg, device, cast=True)


def phase_ring() -> dict:
    import dataclasses

    import numpy as np
    import torch

    from vainplex_openclaw_tpu_torch.models import encode_texts
    from vainplex_openclaw_tpu_torch.models.long_context import (
        forward_long, long_context_config)
    from vainplex_openclaw_tpu_torch.ops import flash_attention as fa
    from vainplex_openclaw_tpu_torch.parallel.mesh import make_mesh

    cfg16 = long_context_config(LONG_L)
    rng = np.random.default_rng(11)
    lengths = rng.integers(2 * LONG_THRESHOLD, LONG_L, size=8)
    tokens = torch.from_numpy(encode_texts(
        [text_of(int(n), rng) for n in lengths], LONG_L,
        cfg16.vocab_size)).cuda()
    check([int(n) for n in (tokens > 0).sum(dim=1).tolist()]
          == [int(n) for n in lengths], "long texts: token counts differ")
    ring = make_mesh(axes=("dp", "sp"), shape=(1, 4), devices=["cuda:0"] * 4)
    whole = make_mesh(axes=("dp", "sp"), shape=(1, 1), devices=["cuda:0"])
    record = {"phase": "ring", "mesh": "1x4 over one card", "texts": 8,
              "real_tokens": [int(n) for n in lengths]}
    for dt_name in ("float32", "bfloat16"):
        cfg = dataclasses.replace(cfg16, dtype=dt_name)
        params = long_params(cfg, "cuda")
        with torch.inference_mode():
            torch.cuda.synchronize()
            fa.stats_launches = 0
            sp4 = forward_long(params, tokens, cfg, ring)
            torch.cuda.synchronize()
            launches = fa.stats_launches
            fa.stats_launches = 0
            sp1 = forward_long(params, tokens, cfg, whole)
            torch.cuda.synchronize()
            launches_sp1 = fa.stats_launches
        check(launches == cfg.n_layers * 16,
              f"ring {dt_name}: K2 launches {launches} != "
              f"{cfg.n_layers} layers × 4 shards × 4 rotations")
        check(launches_sp1 == cfg.n_layers,
              f"ring {dt_name}: sp=1 K2 launches {launches_sp1} != "
              f"{cfg.n_layers} layers")
        check(all(bool(torch.isfinite(sp4[h].float()).all())
                  for h in ("severity", "keep", "mood", "embedding")),
              f"ring {dt_name}: non-finite output")
        err = compare_outputs(sp4, sp1)
        same = bool((sp4["severity"].argmax(-1)
                     == sp1["severity"].argmax(-1)).all())
        if dt_name == "float32":
            check(err <= 1e-4, f"ring fp32: sp=4 vs sp=1 logits differ by "
                               f"{err} > 1e-4")
        else:
            check(same, "ring bf16: severity argmax differs sp=4 vs sp=1")
        record[dt_name] = {"max_abs_err": err, "argmax_equal": same,
                           "k2_launches": launches,
                           "k2_launches_sp1": launches_sp1,
                           "k2_shapes": [[8, cfg.n_heads, LONG_L // sp,
                                          LONG_L // sp,
                                          cfg.d_model // cfg.n_heads]
                                         for sp in (4, 1)],
                           "tol": 1e-4 if dt_name == "float32" else "argmax"}
    emit(record)
    return record


def phase_serve_long(smi: str) -> dict:
    import tempfile

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vainplex_openclaw_tpu_torch.models import serve
    from vainplex_openclaw_tpu_torch.models.long_context import (
        long_context_config)
    from vainplex_openclaw_tpu_torch.models.pretrained import (
        clear_cache, write_pretrained)
    from vainplex_openclaw_tpu_torch.ops import flash_attention as fa

    cfg = long_context_config(LONG_L)
    rng = np.random.default_rng(12)
    n_long = n_short = 32
    lengths = np.concatenate([
        rng.integers(2 * LONG_THRESHOLD, LONG_L, size=n_long),
        rng.integers(2, LONG_THRESHOLD, size=n_short)])
    lengths = lengths[rng.permutation(len(lengths))]
    prompts = [as_prompt(text_of(int(n), rng)) for n in lengths]
    with tempfile.TemporaryDirectory() as ckpt:
        write_pretrained(ckpt, cfg, long_params(cfg, "cpu"))
        oneshot = serve.make_local_call_llm(
            ckpt, serve_cfg={"continuousBatching": False})
        oracle = [oneshot(p) for p in prompts]
        cpu_oneshot = serve.make_local_call_llm(
            ckpt, serve_cfg={"continuousBatching": False}, device="cpu")
        is_long = lengths >= LONG_THRESHOLD
        picks = [int(np.nonzero(is_long)[0][0]),
                 int(np.nonzero(is_long)[0][-1]),
                 int(np.nonzero(~is_long)[0][0]),
                 int(np.nonzero(~is_long)[0][-1])]
        cpu_verdicts = [cpu_oneshot(prompts[i]) for i in picks]
        check(cpu_verdicts == [oracle[i] for i in picks],
              "serve-long: the card's one-shot verdicts differ from the CPU's")

        call = serve.make_local_call_llm(ckpt, serve_cfg={
            "meshServing": True, "meshShape": [1, 1],
            "meshAxes": ["dp", "sp"],
            "planFamily": "encoder_validator_long", "maxBatch": 8})
        batcher = call.batcher
        check(batcher.long_threshold == LONG_THRESHOLD,
              f"serve-long: threshold {batcher.long_threshold}")
        torch.cuda.synchronize()
        fa.launches = 0
        fa.stats_launches = 0
        got, latency, wall, errors = serve_round(call, prompts, 8)
        k1, k2 = fa.launches, fa.stats_launches
        runs = dict(batcher.mesh_runs)
        check(not errors, f"serve-long errors: {errors[:3]}")
        mismatches = sum(a != b for a, b in zip(got, oracle))
        check(mismatches == 0, f"serve-long: {mismatches} verdicts differ "
                               "from the one-shot path")
        check(batcher.long_routed == n_long,
              f"serve-long: longRouted {batcher.long_routed} != {n_long}")
        check(k2 > 0 and k2 == cfg.n_layers * runs["long"],
              f"serve-long: K2 launches {k2} != {cfg.n_layers} layers × "
              f"{runs['long']} long sub-batches")
        check(k1 > 0 and k1 == cfg.n_layers * runs["forward"],
              f"serve-long: K1 launches {k1} != {cfg.n_layers} layers × "
              f"{runs['forward']} short sub-batches")
        snap = batcher.timer.snapshot()
        stats = batcher.stats()

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            got2, _, wall2, errors2 = serve_round(call, prompts, 8)
            torch.cuda.synchronize()
        check(not errors2 and got2 == oracle, "profiled serve-long round "
                                              "differs")
        serve.close_batchers()
        clear_cache()
    lat = sorted(latency)
    record = {"phase": "serve_long", "nvidia_smi": smi,
              "requests": len(prompts), "long": n_long, "short": n_short,
              "threads": 8, "max_batch": 8, "mesh": stats["mesh"],
              "served": stats["served"], "batches": stats["batches"],
              "long_routed": stats["longRouted"], "sub_batches": runs,
              "verdict_mismatches": 0, "cpu_checked": len(picks),
              "k2_launches": k2, "k1_launches": k1,
              "requests_per_s": len(prompts) / wall,
              "tokens_per_s": float(lengths.sum()) / wall,
              "wall_s": wall,
              "latency_ms": {"p50": lat[len(lat) // 2],
                             "p99": lat[min(len(lat) - 1,
                                            int(0.99 * len(lat)))],
                             "max": lat[-1]},
              "stage_p50_ms": {k: v["p50"]
                               for k, v in snap["quantiles"].items()},
              "stage_ms": snap["stages_ms"], "stage_counts": snap["counts"],
              "profiled_round": {"wall_s": wall2,
                                 **device_busy(prof, wall2)}}
    emit(record)
    return {"launches": k2, "k1_launches": k1}


def sfu_rates() -> dict:
    """The card's own rates of the per-score instructions of the bf16
    kernel that do not run on the FMA pipes (``csrc/sfu_probe.cu``):
    ex2.approx alone, cvt.rn.bf16x2 alone and both interleaved 1:1, on
    every SM at full occupancy (8 blocks of 256 threads each), with CUDA
    events. ``steps_per_s`` counts one ex2, one cvt or one pair per step."""
    import torch

    from vainplex_openclaw_tpu_torch.ops import _build

    lib = _build.load_library("sfu_probe")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, threads, iters = 8 * sms, 256, 2048
    steps = blocks * threads * iters * SFU_PROBE_CHAINS
    out = torch.empty(blocks * threads, dtype=torch.float32, device="cuda")
    rates = {"sms": sms, "steps": steps}
    for op, name in enumerate(("ex2", "cvt_bf16x2", "ex2_and_cvt_bf16x2")):
        def probe(op=op):
            err = lib.sfu_probe(op, blocks, threads, iters, out.data_ptr(),
                                torch.cuda.current_stream().cuda_stream)
            if err:
                raise SmokeFailure(f"sfu_probe {op}: CUDA error {err}")

        ms = time_ms(probe, n=5, reps=5, warmup=2)
        check(bool(torch.isfinite(out).all()), f"sfu_probe {op}: non-finite")
        rates[name] = {"ms": ms, "steps_per_s": steps / ms * 1e3}
    return rates


def phase_timing_stats() -> dict:
    import numpy as np
    import torch
    import torch.nn.functional as F

    from vainplex_openclaw_tpu_torch.ops import flash_attention as fa

    B, H, L, Dh = 8, 2, LONG_L, 16
    q, k, v, _ = make_qkv(np.random.default_rng(13), B, H, L, L, Dh,
                          torch.bfloat16, False, "cuda")
    mask = torch.ones((B, L), dtype=torch.bool, device="cuda")
    bias = fa._bias(mask, B, L, q.device)
    acc = torch.empty((B, H, L, Dh), dtype=torch.float32, device="cuda")
    m = torch.empty((B, H, L), dtype=torch.float32, device="cuda")
    l = torch.empty_like(m)
    lib = served_library(L)
    kernel = raw_launch(lib, q, k, v, bias, (acc, m, l), "K2 timing")
    k1_same_shape = raw_launch(lib, q, k, v, bias, torch.empty_like(q),
                               "K1 timing")

    def plain():
        # one batch element at a time: [B, H, L, L] fp32 scores at once
        # would take 17 GB per temporary
        for b in range(B):
            fa.flash_attention_stats_reference(q[b:b + 1], k[b:b + 1],
                                               v[b:b + 1], mask[b:b + 1])

    def k1_plain():
        for b in range(B):
            fa.flash_attention_reference(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                         mask[b:b + 1])

    sdpa_mask = bias.to(q.dtype)[:, None, None, :]

    def library():
        F.scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask)

    # in turns within this call: K2, plain, plain, K2; K1, SDPA, SDPA, K1;
    # K1's plain version after
    kernel_ms = [time_ms(kernel, n=5, reps=5, warmup=2)]
    plain_ms = [time_ms(plain, n=1, reps=3, warmup=1)]
    plain_ms.append(time_ms(plain, n=1, reps=3, warmup=0))
    kernel_ms.append(time_ms(kernel, n=5, reps=5, warmup=0))
    k1_ms = [time_ms(k1_same_shape, n=5, reps=5, warmup=2)]
    sdpa_ms = [time_ms(library, n=5, reps=5, warmup=2)]
    sdpa_ms.append(time_ms(library, n=5, reps=5, warmup=0))
    k1_ms.append(time_ms(k1_same_shape, n=5, reps=5, warmup=0))
    k1_plain_ms = [time_ms(k1_plain, n=1, reps=3, warmup=1)]
    # the profiler's reading, in short windows, with the records it kept
    k2_device = [device_kernel_ms(kernel, n=5) for _ in range(3)]
    k1_device = [device_kernel_ms(k1_same_shape, n=5) for _ in range(3)]
    # the exponential floor at the rate this card does ex2 in this run
    sfu = sfu_rates()
    exp_floor_measured_ms = (B * H * L * L / sfu["ex2"]["steps_per_s"]
                             * 1e3)

    elem = q.element_size()
    record = {"phase": "timing_stats", "shape": [B, H, L, L, Dh],
              "dtype": "bfloat16", "kv_mask": "every key valid",
              "kernel_ms": statistics.median(kernel_ms),
              "kernel_ms_runs": kernel_ms,
              "kernel_device": k2_device,
              "plain_ms": statistics.median(plain_ms),
              "plain_ms_runs": plain_ms,
              "library_ms": None,
              "sdpa_normalized_ms": statistics.median(sdpa_ms),
              **attention_bound(B, H, L, L, Dh, elem, stats=True),
              "exp_floor_measured_ms": exp_floor_measured_ms,
              "sfu": sfu,
              "launches_per_forward": "n_layers x dp x sp^2 (2 at 1x1)",
              # K1 on the same inputs: SDPA computes exactly its function
              "k1_same_shape": {
                  "kernel_ms": statistics.median(k1_ms),
                  "kernel_ms_runs": k1_ms,
                  "kernel_device": k1_device,
                  "plain_ms": statistics.median(k1_plain_ms),
                  "library_ms": statistics.median(sdpa_ms),
                  "library_ms_runs": sdpa_ms,
                  **attention_bound(B, H, L, L, Dh, elem, stats=False),
                  "exp_floor_measured_ms": exp_floor_measured_ms}}
    emit(record)
    return record


def tiny_batch(cfg, n: int = 64):
    """The first training batch of ``n`` from the ``synthetic_split`` the
    recipe trains on."""
    from vainplex_openclaw_tpu_torch.models.data import (
        TextClassificationData, synthetic_split)

    train_ex, _ = synthetic_split(4096, 512, seed=0)
    data = TextClassificationData(train_ex, n, seq_len=cfg.seq_len,
                                  vocab_size=cfg.vocab_size, seed=0)
    return next(data.epoch(0))


def leaf_grads(masters: dict, cfg, batch: dict, device) -> tuple:
    """(loss, {leaf: grad or None}) of ``loss_fn`` at fp32 copies of
    ``masters`` on ``device``."""
    import torch

    from vainplex_openclaw_tpu_torch.models import train
    from vainplex_openclaw_tpu_torch.models.encoder import (
        flatten_tree, params_from_numpy)

    params = train.init_state(params_from_numpy(masters, cfg, device,
                                                cast=False),
                              train.make_optimizer()).params
    loss = train.loss_fn(params, train.batch_to(batch, torch.device(device)),
                         cfg)
    loss.backward()
    return float(loss.detach()), {k: p.grad for k, p in
                                  flatten_tree(params).items()}


def phase_grad() -> dict:
    import dataclasses

    import torch

    from vainplex_openclaw_tpu_torch.models.encoder import init_params
    from vainplex_openclaw_tpu_torch.models.pretrained import TINY_CONFIG
    from vainplex_openclaw_tpu_torch.ops import flash_attention as fa

    masters = init_params(TINY_CONFIG, torch.Generator().manual_seed(0))
    batch = tiny_batch(TINY_CONFIG)
    record = {"phase": "grad", "batch": 64, "tol": GRAD_TOL}
    for dt_name in ("float32", "bfloat16"):
        cfg = dataclasses.replace(TINY_CONFIG, dtype=dt_name)
        torch.cuda.synchronize()
        fa.launches = 0
        loss, got = leaf_grads(masters, cfg, batch, "cuda")
        torch.cuda.synchronize()
        launches = fa.launches
        ref_loss, want = leaf_grads(masters, cfg, batch, "cpu")
        check(launches == cfg.n_layers,
              f"grad {dt_name}: K1 launches {launches} != {cfg.n_layers}")
        errors, worst_key, worst = {}, None, 0.0
        for key, w in want.items():
            g = got[key]
            check((g is None) == (w is None),
                  f"grad {dt_name}: {key} has a gradient on one side only")
            if w is None:
                continue
            check(bool(torch.isfinite(g).all()),
                  f"grad {dt_name}: {key} non-finite")
            err = float((g.float().cpu() - w.float()).abs().max()) / max(
                float(w.abs().max()), 1e-30)
            errors[key] = err
            if err > worst:
                worst, worst_key = err, key
        attn = {k: float(got[k].abs().max()) for k in got
                if "/attn/" in k and k.rsplit("/", 1)[1] in "qkv"}
        check(len(attn) == 3 * cfg.n_layers and min(attn.values()) > 0,
              f"grad {dt_name}: an attention q/k/v gradient is zero: {attn}")
        check(worst <= GRAD_TOL[dt_name],
              f"grad {dt_name}: {worst_key} differs by {worst} of its max "
              f"|g| > {GRAD_TOL[dt_name]}")
        record[dt_name] = {"loss": loss, "cpu_loss": ref_loss,
                           "k1_launches": launches,
                           "k1_shape": reference_shape(cfg, 64),
                           "worst_leaf": worst_key,
                           "worst_rel_err": worst,
                           "attn_qkv_min_max_abs_grad": min(attn.values()),
                           "rel_err": errors}
    emit(record)
    return record


def phase_train(smi: str) -> dict:
    import tempfile

    import numpy as np
    import torch

    from vainplex_openclaw_tpu_torch.models import serve
    from vainplex_openclaw_tpu_torch.models.data import synthetic_split
    from vainplex_openclaw_tpu_torch.models.pretrained import (
        TINY_CONFIG, clear_cache, load_pretrained, train_and_ship)
    from vainplex_openclaw_tpu_torch.ops import flash_attention as fa

    cfg, steps = TINY_CONFIG, TRAIN_STEPS
    stamps = []

    def log(msg: str) -> None:  # once per epoch, after reading the loss
        stamps.append((time.perf_counter(), msg))

    with tempfile.TemporaryDirectory() as out:
        torch.cuda.synchronize()
        fa.launches = 0
        t0 = time.perf_counter()
        metrics = train_and_ship(out, total_steps=steps, log=log)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = fa.launches
        n_eval = max(64, 4608 // 9)
        eval_batches = -(-n_eval // 64)
        check(launches == cfg.n_layers * (steps + eval_batches),
              f"train: K1 launches {launches} != {cfg.n_layers} × "
              f"({steps} steps + {eval_batches} eval batches)")
        _, heldout = synthetic_split(4608 - n_eval, n_eval, seed=0)
        majority = max(np.bincount([lab["mood"] for _, lab in heldout]))
        majority /= len(heldout)
        for head in ("keep", "severity"):
            check(metrics[f"{head}_accuracy"] >= 0.9,
                  f"train: held-out {head} accuracy "
                  f"{metrics[f'{head}_accuracy']} < 0.9")
        check(metrics["mood_accuracy"] >= majority,
              f"train: mood accuracy {metrics['mood_accuracy']} < majority "
              f"{majority}")
        # ms per step per epoch from the epoch-end stamps (each waits for
        # the epoch's last loss); the first epoch carries the warm-up
        steps_per_epoch = (4608 - n_eval) // 64
        bounds = [t0] + [t for t, _ in stamps]
        per_epoch = [(b - a) * 1e3 / steps_per_epoch
                     for a, b in zip(bounds, bounds[1:])]
        per_epoch[-1] = (bounds[-1] - bounds[-2]) * 1e3 / (
            steps - steps_per_epoch * (len(stamps) - 1))

        # the card-trained checkpoint served on the card and on the CPU
        prompts = [as_prompt(t) for t in seeded_texts(64, seed=21)]
        clear_cache()
        loaded = load_pretrained(out)
        check(loaded is not None and loaded[0] == cfg,
              "train: the shipped checkpoint does not load")
        call = serve.make_local_call_llm(out)
        got, _, serve_wall, errors = serve_round(call, prompts, 8)
        oracle_call = serve.make_local_call_llm(
            out, serve_cfg={"continuousBatching": False}, device="cpu")
        oracle = [oracle_call(p) for p in prompts]
        serve.close_batchers()
        clear_cache()
    check(not errors, f"train serve errors: {errors[:3]}")
    mismatches = sum(a != b for a, b in zip(got, oracle))
    check(mismatches == 0, f"train: {mismatches} served verdicts differ "
                           "from the CPU one-shot path")
    steady = sorted(per_epoch[1:]) or per_epoch
    record = {"phase": "train", "nvidia_smi": smi, "steps": steps,
              "batch": 64, "config": "TINY_CONFIG bf16",
              "eval": metrics, "mood_majority": majority,
              "k1_launches": launches, "wall_s": wall,
              "steps_per_s": steps / wall,
              "ms_per_step_by_epoch": per_epoch,
              "ms_per_step_p50": steady[len(steady) // 2],
              "epoch_log": [m for _, m in stamps],
              "served": len(prompts), "verdict_mismatches": 0,
              "distinct_verdicts": len(set(got)),
              "serve_wall_s": serve_wall}
    emit(record)
    return record


MOE_WIDTHS = dict(vocab_size=512, seq_len=32, d_model=64, n_heads=4,
                  n_layers=2, d_ff=128, n_experts=4)


def phase_train_moe() -> dict:
    import dataclasses

    import torch

    from vainplex_openclaw_tpu_torch.models import train
    from vainplex_openclaw_tpu_torch.models.data import (
        TextClassificationData, synthetic_examples)
    from vainplex_openclaw_tpu_torch.models.encoder import (
        EncoderConfig, forward, init_params, params_from_numpy)
    from vainplex_openclaw_tpu_torch.ops import flash_attention as fa

    cfg, steps = EncoderConfig(**MOE_WIDTHS), MOE_STEPS
    init = params_from_numpy(init_params(cfg, torch.Generator().manual_seed(2)),
                             cfg, "cuda", cast=False)
    state = train.init_state(init, train.make_optimizer())
    data = TextClassificationData(synthetic_examples(2048, seed=5), 64,
                                  seq_len=cfg.seq_len,
                                  vocab_size=cfg.vocab_size, seed=5)
    losses = []
    torch.cuda.synchronize()
    fa.launches = 0
    t0 = time.perf_counter()
    epoch = 0
    while state.step < steps:
        for batch in data.epoch(epoch):
            state, loss = train.train_step(state, batch, cfg)
            losses.append(loss)
            if state.step >= steps:
                break
        epoch += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fa.launches
    losses = [float(x) for x in losses]
    check(launches == cfg.n_layers * steps,
          f"train_moe: K1 launches {launches} != {cfg.n_layers} × {steps}")
    first, last = (sum(losses[:10]) / 10, sum(losses[-10:]) / 10)
    check(all(math.isfinite(x) for x in losses) and last < first,
          f"train_moe: loss {first} -> {last} did not fall")
    batch = train.batch_to(next(data.epoch(epoch + 1)), torch.device("cpu"))
    fp32 = dataclasses.replace(cfg, dtype="float32")
    with torch.no_grad():
        gpu = forward(state.params, batch["tokens"].cuda(), fp32)
        cpu = forward(params_from_numpy(state.params, fp32, "cpu",
                                        cast=False), batch["tokens"], fp32)
        aux_bf16 = float(forward(state.params, batch["tokens"].cuda(),
                                 cfg)["moe_aux"])
    err = compare_outputs(gpu, cpu)
    aux_err = abs(float(gpu["moe_aux"]) - float(cpu["moe_aux"]))
    check(math.isfinite(aux_bf16) and math.isfinite(float(gpu["moe_aux"])),
          "train_moe: moe_aux not finite")
    check(err <= 1e-4 and aux_err <= 1e-4,
          f"train_moe: fp32 forward card vs CPU differs by {err}, moe_aux by "
          f"{aux_err} > 1e-4")
    record = {"phase": "train_moe", "config": {**MOE_WIDTHS,
                                               "dtype": cfg.dtype},
              "steps": steps, "batch": 64, "k1_launches": launches,
              "loss_first10": first, "loss_last10": last,
              "moe_aux_bf16": aux_bf16,
              "moe_aux_fp32": float(gpu["moe_aux"]),
              "fp32_max_abs_err": err, "moe_aux_abs_err": aux_err,
              "wall_s": wall, "steps_per_s": steps / wall}
    emit(record)
    return record


@dataclass
class Finding:
    """A trace-analyzer finding as ``local_triage`` reads it."""
    signal: str
    severity: str
    summary: str
    evidence: list


@dataclass
class Fact:
    """A knowledge fact as ``LocalEmbeddings.sync`` reads it."""
    id: str
    subject: str
    predicate: str
    object: str


def triage_findings(n: int, seed: int) -> list:
    """Findings over the held-out texts of ``synthetic_split``, whose keep
    labels split about two to one, so the keep head keeps some and drops
    some; half carry an exit code as evidence."""
    import numpy as np

    from vainplex_openclaw_tpu_torch.models.data import synthetic_split

    rng = np.random.default_rng(seed)
    severities = ("info", "low", "medium", "high", "critical")
    out = []
    for text, _ in synthetic_split(0, n, seed=seed)[1]:
        evidence = [f"exit {int(rng.integers(0, 3))}"] \
            if rng.random() < 0.5 else []
        out.append(Finding("tool_failure", severities[rng.integers(5)], text,
                           evidence))
    return out


def seeded_facts(n: int, seed: int) -> list:
    import numpy as np

    rng = np.random.default_rng(seed)
    preds = ("emits", "runs-on", "failed-with", "depends-on", "owns")
    return [Fact(f"f{i}", f"{_SUBJECTS[rng.integers(len(_SUBJECTS))]} {i}",
                 preds[rng.integers(len(preds))], text)
            for i, text in enumerate(seeded_texts(n, seed))]


def phase_triage_embed() -> dict:
    import dataclasses
    import tempfile

    import torch

    from vainplex_openclaw_tpu_torch.cortex.trace_analyzer.classifier import (
        keep_logits, local_triage)
    from vainplex_openclaw_tpu_torch.knowledge.embeddings import (
        LocalEmbeddings)
    from vainplex_openclaw_tpu_torch.models import encoder
    from vainplex_openclaw_tpu_torch.models.checkpoint import read_checkpoint
    from vainplex_openclaw_tpu_torch.models.encoder import unflatten_tree
    from vainplex_openclaw_tpu_torch.models.pretrained import (
        DEFAULT_DIR, TINY_CONFIG, clear_cache, write_pretrained)
    from vainplex_openclaw_tpu_torch.ops import flash_attention as fa

    class Log:
        def info(self, *_):
            pass

        warn = error = info

    findings = triage_findings(64, seed=31)
    torch.cuda.synchronize()
    fa.launches = 0
    decisions = {sev: local_triage(findings, min_severity=sev)
                 for sev in ("critical", "medium")}
    card = keep_logits(findings)
    torch.cuda.synchronize()
    triage_launches = fa.launches
    for sev, got in decisions.items():
        want = local_triage(findings, min_severity=sev, device="cpu")
        check(got == want, f"triage_embed: local_triage at {sev} differs "
                           f"card vs CPU ({sum(a != b for a, b in zip(got, want))})")
    # the decisions alone barely see attention: the logits are compared too
    host = keep_logits(findings, device="cpu")
    err = float((card - host).abs().max())
    check(err <= TRIAGE_TOL, f"triage_embed: keep logits differ card vs CPU "
                             f"by {err} > {TRIAGE_TOL}")
    model_kept = int(host.argmax(dim=-1).sum())
    check(len(findings) // 8 <= model_kept <= len(findings) * 7 // 8,
          f"triage_embed: the keep head kept {model_kept} of "
          f"{len(findings)}; the findings do not split it")
    # control: uniform attention (queries zeroed) must leave the tolerance
    real_attention = encoder.flash_attention
    encoder.flash_attention = lambda q, k, v, mask=None, **kw: \
        real_attention(torch.zeros_like(q), k, v, mask, **kw)
    try:
        control_err = float((keep_logits(findings) - host).abs().max())
    finally:
        encoder.flash_attention = real_attention
    check(control_err > TRIAGE_TOL, f"triage_embed: uniform attention moved "
                                    f"the keep logits only {control_err}")
    record = {"phase": "triage_embed", "findings": len(findings),
              "kept": {k: sum(v) for k, v in decisions.items()},
              "model_kept": model_kept,
              "logits_max_abs_err": err, "tol": TRIAGE_TOL,
              "control_max_abs_err": control_err,
              "triage_k1_launches": triage_launches}

    facts = seeded_facts(200, seed=32)
    queries = seeded_texts(24, seed=33)
    with tempfile.TemporaryDirectory() as fp32_dir:
        flat = {k: torch.as_tensor(v).float()
                for k, v in read_checkpoint(DEFAULT_DIR).items()}
        write_pretrained(fp32_dir, dataclasses.replace(TINY_CONFIG,
                                                       dtype="float32"),
                         unflatten_tree(flat))
        for name, ckpt, k in (("float32", fp32_dir, 5), ("bfloat16", None, 1)):
            card = LocalEmbeddings(Log(), checkpoint_dir=ckpt)
            host = LocalEmbeddings(Log(), checkpoint_dir=ckpt, device="cpu")
            torch.cuda.synchronize()
            fa.launches = 0
            card.sync(facts)
            got = [[h["id"] for h in card.search(q, k=k)] for q in queries]
            torch.cuda.synchronize()
            launches = fa.launches
            host.sync(facts)
            want = [[h["id"] for h in host.search(q, k=k)] for q in queries]
            check(got == want, f"triage_embed: {name} search ids differ card "
                               "vs CPU")
            record[f"embed_{name}"] = {"facts": len(facts),
                                       "queries": len(queries), "k": k,
                                       "k1_launches": launches}
        clear_cache()
    emit(record)
    return record


def phase_timing_train(smi: str) -> dict:
    import numpy as np
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from vainplex_openclaw_tpu_torch.models import train
    from vainplex_openclaw_tpu_torch.models.encoder import (
        init_params, params_from_numpy)
    from vainplex_openclaw_tpu_torch.models.pretrained import TINY_CONFIG
    from vainplex_openclaw_tpu_torch.ops import flash_attention as fa

    B, H, L, Dh = 64, 4, 64, 16
    q, k, v, mask = make_qkv(np.random.default_rng(41), B, H, L, L, Dh,
                             torch.bfloat16, "prefix", "cuda")
    bias = fa._bias(mask, B, L, q.device)
    kernel = raw_launch(served_library(L), q, k, v, bias, torch.empty_like(q),
                        "train timing")

    def plain():
        fa.flash_attention_reference(q, k, v, mask)

    sdpa_mask = bias.to(q.dtype)[:, None, None, :]

    def library():
        F.scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask)

    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    fwd = fa.flash_attention(*leaves, mask)
    cot = torch.randn_like(fwd)

    def backward():
        torch.autograd.grad(fwd, leaves, cot, retain_graph=True)

    kernel_ms = [time_ms(kernel)]
    plain_ms = [time_ms(plain), time_ms(plain)]
    kernel_ms.append(time_ms(kernel))
    library_ms = [time_ms(library), time_ms(library)]
    kernel_ms.append(time_ms(kernel))
    backward_ms = time_ms(backward, n=50, reps=7, warmup=5)
    # the profiler drops records: three short windows, read per record
    kernel_device = [device_kernel_ms(kernel, n=5) for _ in range(3)]
    bound = attention_bound(B, H, L, L, Dh, q.element_size(), stats=False)

    # a training step at the recipe's shape, split by what it runs
    cfg = TINY_CONFIG
    state = train.init_state(params_from_numpy(
        init_params(cfg, torch.Generator().manual_seed(0)), cfg, "cuda",
        cast=False), train.make_optimizer())
    batch = tiny_batch(cfg)
    dev_batch = train.batch_to(batch, torch.device("cuda"))
    n = 50

    def host_ms(fn, reps: int = 5) -> float:
        samples = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            samples.append((time.perf_counter() - t) * 1e3 / n)
        return statistics.median(samples)

    def fwd_only():
        train.loss_fn(state.params, dev_batch, cfg)

    def fwd_bwd():
        state.opt_state.zero_grad(set_to_none=True)
        train.loss_fn(state.params, dev_batch, cfg).backward()

    def step():
        nonlocal state
        state, _ = train.train_step(state, batch, cfg)

    for fn in (fwd_only, fwd_bwd, step):
        fn()
    fwd_ms, fwd_bwd_ms, step_ms = host_ms(fwd_only), host_ms(fwd_bwd), \
        host_ms(step)
    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            step()
        torch.cuda.synchronize()
    busy = device_busy(prof, time.perf_counter() - t)
    host = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total,
                  reverse=True)[:8]
    busy["host_top"] = [{"name": e.key[:80], "self_cpu_ms": e.self_cpu_time_total
                         / 1e3, "count": e.count} for e in host]
    record = {"phase": "timing_train", "nvidia_smi": smi,
              "shape": [B, H, L, L, Dh], "dtype": "bfloat16",
              "kernel_ms": statistics.median(kernel_ms),
              "kernel_ms_runs": kernel_ms, "kernel_device": kernel_device,
              "plain_ms": statistics.median(plain_ms),
              "plain_ms_runs": plain_ms,
              "library_ms": statistics.median(library_ms),
              "library_ms_runs": library_ms, **bound,
              "dense_backward_ms": backward_ms,
              "step": {"batch": 64, "config": "TINY_CONFIG bf16",
                       "forward_ms": fwd_ms,
                       "backward_ms": fwd_bwd_ms - fwd_ms,
                       "adamw_and_rest_ms": step_ms - fwd_bwd_ms,
                       "step_ms": step_ms,
                       "k1_backward_ms_per_step": backward_ms * cfg.n_layers,
                       "profiled_20_steps": busy}}
    emit(record)
    return record


# ── the mesh families (each grid repeats cuda:0) ──────────────────────────

MESH_PROMPTS = 64
MESH_THREADS = 8


def card_grid(axes: tuple, shape: tuple):
    """A grid of ``shape`` over ``axes`` that repeats the one card: the
    sharded arithmetic and placement of a mesh, without cross-card copies."""
    from vainplex_openclaw_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(axes=axes, shape=shape,
                     devices=["cuda:0"] * math.prod(shape))


def batcher_call(batcher):
    """A ``call_llm`` over a batcher built directly (a repeated-card grid
    cannot come from a serve config, which takes distinct cards)."""
    from vainplex_openclaw_tpu_torch.models import serve

    def call(prompt: str) -> str:
        return batcher.submit(serve._extract_message(prompt))

    return call


def timed_round(call, prompts: list) -> dict:
    """Requests/s and latency quantiles of one threaded round (after one
    warm-up request), with its verdicts."""
    call(as_prompt("warm-up request"))
    got, latency, wall, errors = serve_round(call, prompts, MESH_THREADS)
    check(not errors, f"serve errors: {errors[:3]}")
    lat = sorted(latency)
    return {"verdicts": got, "requests_per_s": len(prompts) / wall,
            "p50_ms": lat[len(lat) // 2],
            "p99_ms": lat[min(len(lat) - 1, int(0.99 * len(lat)))]}


def mesh_logits(params, tokens, cfg, mesh, family):
    """The mesh forward of ``family`` and the K1 launches it made."""
    import torch

    from vainplex_openclaw_tpu_torch.ops import flash_attention as fa
    from vainplex_openclaw_tpu_torch.parallel import plan

    with torch.inference_mode():
        placed = plan.place_params(params, mesh, family)
        shards = plan.place_tokens(tokens, mesh, family)
        torch.cuda.synchronize()
        fa.launches = 0
        out = plan.serve_forward(placed, shards, cfg, mesh, family)
        torch.cuda.synchronize()
        return out, fa.launches


def counted_forward(params, tokens, cfg) -> tuple:
    """The single-device card forward a mesh leg is held against, and the
    K1 launches it made (one a layer)."""
    import torch

    from vainplex_openclaw_tpu_torch.models import forward
    from vainplex_openclaw_tpu_torch.ops import flash_attention as fa

    with torch.inference_mode():
        torch.cuda.synchronize()
        fa.launches = 0
        want = forward(params, tokens.cuda(), cfg)
        torch.cuda.synchronize()
    check(fa.launches == cfg.n_layers, f"reference forward: K1 launches "
                                       f"{fa.launches} != {cfg.n_layers}")
    return want, fa.launches


def reference_shape(cfg, batch: int) -> list:
    """[B, H, L, L, Dh] of K1 in a single-device forward of ``batch``."""
    return [batch, cfg.n_heads, cfg.seq_len, cfg.seq_len,
            cfg.d_model // cfg.n_heads]


def shipped_params(dtype: str):
    """(cfg, params on the card) of the shipped checkpoint, bf16 as it
    ships or cast to fp32."""
    import dataclasses

    from vainplex_openclaw_tpu_torch.models import params_from_numpy
    from vainplex_openclaw_tpu_torch.models.pretrained import load_pretrained

    cfg, params = load_pretrained()
    if dtype == "bfloat16":
        return cfg, params
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    return cfg32, params_from_numpy(params, cfg32, "cuda")


def k1_per_forward(counted: int, **factors) -> dict:
    """A launch count beside its formula (factors in order)."""
    want = math.prod(factors.values())
    check(counted == want, f"K1 per forward {counted} != "
                           f"{' x '.join(factors)} = {want}")
    return {"counted": counted,
            "formula": " x ".join(f"{k} {v}" for k, v in factors.items()),
            "expected": want}


def phase_mesh_default(smi: str) -> dict:
    """The default ``meshServing: true`` config end to end on one card."""
    import torch

    from vainplex_openclaw_tpu_torch.models import serve
    from vainplex_openclaw_tpu_torch.models.pretrained import load_pretrained
    from vainplex_openclaw_tpu_torch.ops import flash_attention as fa

    cfg, _ = load_pretrained()
    prompts = [as_prompt(t) for t in seeded_texts(MESH_PROMPTS, seed=51)]
    oneshot = serve.make_local_call_llm(
        serve_cfg={"continuousBatching": False})
    oracle = [oneshot(p) for p in prompts]
    single = timed_round(serve.make_local_call_llm(
        serve_cfg={"windowMs": 0.0}), prompts)
    check(single["verdicts"] == oracle, "single-device batcher differs from "
                                        "the one-shot path")
    call = serve.make_local_call_llm(serve_cfg={"meshServing": True,
                                                "windowMs": 0.0})
    batcher = call.batcher
    call(as_prompt("warm-up request"))
    runs0 = batcher.mesh_runs["forward"]
    torch.cuda.synchronize()
    fa.launches = 0
    got, latency, wall, errors = serve_round(call, prompts, MESH_THREADS)
    launches = fa.launches
    runs = batcher.mesh_runs["forward"] - runs0
    check(not errors, f"mesh default errors: {errors[:3]}")
    mismatches = sum(a != b for a, b in zip(got, oracle))
    check(mismatches == 0, f"mesh default: {mismatches} verdicts differ "
                           "from the one-shot card path")
    stats = batcher.stats()
    check(stats["mesh"] == "1x1", f"mesh default: mesh {stats['mesh']}")
    check(launches == cfg.n_layers * runs,
          f"mesh default: K1 launches {launches} != {cfg.n_layers} x {runs}")
    lat = sorted(latency)
    serve.close_batchers()
    record = {"phase": "mesh_default", "nvidia_smi": smi,
              "serve_cfg": {"meshServing": True, "windowMs": 0.0},
              "mesh": stats["mesh"], "requests": len(prompts),
              "distinct_verdicts": len(set(got)),
              "severity3_verdicts": sum('"block"' in v for v in got),
              "verdict_mismatches": 0, "k1_launches": launches,
              "sub_batches": runs,
              "requests_per_s": len(prompts) / wall,
              "p50_ms": lat[len(lat) // 2],
              "single_device": {k: single[k] for k in
                                ("requests_per_s", "p50_ms", "p99_ms")}}
    emit(record)
    return {"prompts": prompts, "oracle": oracle, "single": single,
            "launches": launches}


def phase_mesh_tp(smi: str, base: dict) -> dict:
    """The Megatron validator on (2, 2) and (1, 4) grids over one card."""
    import torch

    from vainplex_openclaw_tpu_torch.models import encode_texts, forward
    from vainplex_openclaw_tpu_torch.models.batching import ContinuousBatcher
    from vainplex_openclaw_tpu_torch.ops import flash_attention as fa
    from vainplex_openclaw_tpu_torch.parallel import sharded_forward

    prompts, oracle = base["prompts"], base["oracle"]
    record = {"phase": "mesh_tp", "nvidia_smi": smi,
              "family": "encoder_validator",
              "single_device": {k: base["single"][k] for k in
                                ("requests_per_s", "p50_ms", "p99_ms")}}
    texts = seeded_texts(MESH_PROMPTS, seed=52)
    served_launches = {}
    for shape in ((2, 2), (1, 4)):
        name = f"{shape[0]}x{shape[1]}"
        mesh = card_grid(("dp", "tp"), shape)
        batcher = ContinuousBatcher(window_ms=0.0, mesh=mesh)
        try:
            runs0 = batcher.mesh_runs["forward"]
            fa.launches = 0
            timed = timed_round(batcher_call(batcher), prompts)
            launches = fa.launches
            runs = batcher.mesh_runs["forward"] - runs0
            stats = batcher.stats()
        finally:
            batcher.close()
        mismatches = sum(a != b for a, b in zip(timed["verdicts"], oracle))
        check(mismatches == 0, f"mesh_tp {name}: {mismatches} verdicts "
                               "differ from the one-shot card path")
        check(stats["mesh"] == name, f"mesh_tp: stats mesh {stats['mesh']}")
        n_layers = shipped_params("bfloat16")[0].n_layers
        check(launches == n_layers * shape[0] * shape[1] * runs,
              f"mesh_tp {name}: served K1 launches {launches} != "
              f"n_layers x dp x tp x {runs} sub-batches")
        entry = {"requests_per_s": timed["requests_per_s"],
                 "p50_ms": timed["p50_ms"], "p99_ms": timed["p99_ms"],
                 "served_k1_launches": launches, "sub_batches": runs,
                 "verdict_mismatches": 0}
        served_launches[name] = launches
        for dt_name, tol in (("float32", 1e-5), ("bfloat16", 5e-2)):
            cfg, params = shipped_params(dt_name)
            tokens = torch.from_numpy(encode_texts(texts, cfg.seq_len,
                                                   cfg.vocab_size))
            want, reference = counted_forward(params, tokens, cfg)
            out, counted = mesh_logits(params, tokens, cfg, mesh,
                                       "encoder_validator")
            err = compare_outputs(out, want)
            same = bool((out["severity"].argmax(-1)
                         == want["severity"].argmax(-1)).all())
            check(err <= tol and same, f"mesh_tp {name} {dt_name}: logits "
                                       f"differ by {err} > {tol} or argmax "
                                       f"differs ({same})")
            entry[dt_name] = {"max_abs_err": err, "argmax_equal": same,
                              "tol": tol,
                              "k1_per_forward": k1_per_forward(
                                  counted, n_layers=cfg.n_layers,
                                  dp=shape[0], tp=shape[1]),
                              "reference_k1_launches": reference,
                              "reference_k1_shape": reference_shape(
                                  cfg, len(texts))}
        record[name] = entry
    # negative control: the attn/o psum replaced by one column's partial
    cfg, params = shipped_params("float32")
    tokens = torch.from_numpy(encode_texts(texts, cfg.seq_len,
                                           cfg.vocab_size))
    with torch.inference_mode():
        want = forward(params, tokens.cuda(), cfg)
    real = sharded_forward.psum
    sharded_forward.psum = lambda parts, device, site: (
        parts[0].to(device) if site == "attn/o" else real(parts, device, site))
    try:
        dropped, _ = mesh_logits(params, tokens, cfg,
                                 card_grid(("dp", "tp"), (2, 2)),
                                 "encoder_validator")
    finally:
        sharded_forward.psum = real
    control = compare_outputs(dropped, want)
    check(control > 1e-5, f"mesh_tp: dropping an attn/o partial moved the "
                          f"fp32 logits only {control}; the check is blind")
    record["control_dropped_attn_o_partial"] = {"max_abs_err": control,
                                                "tol": 1e-5,
                                                "check_fails": True}
    emit(record)
    return {"launches": sum(served_launches.values()),
            "by_shape": served_launches, "record": record}


def phase_mesh_pp(smi: str, base: dict) -> dict:
    """The GPipe validator on two stages over one card, 4 microbatches."""
    import torch

    from vainplex_openclaw_tpu_torch.models import encode_texts
    from vainplex_openclaw_tpu_torch.models.batching import ContinuousBatcher
    from vainplex_openclaw_tpu_torch.ops import flash_attention as fa
    from vainplex_openclaw_tpu_torch.parallel.plan import PLAN_TABLE

    M = PLAN_TABLE["encoder_validator_pp"].microbatches
    mesh = card_grid(("pp",), (2,))
    batcher = ContinuousBatcher(window_ms=0.0, mesh=mesh,
                                plan_family="encoder_validator_pp")
    try:
        runs0 = batcher.mesh_runs["pipeline"]
        micro0 = batcher.timer.counts().get("microbatch", 0)
        batches0 = batcher.batches
        fa.launches = 0
        timed = timed_round(batcher_call(batcher), base["prompts"])
        launches = fa.launches
        runs = batcher.mesh_runs["pipeline"] - runs0
        micro = batcher.timer.counts()["microbatch"] - micro0
        batches = batcher.batches - batches0
    finally:
        batcher.close()
    mismatches = sum(a != b for a, b in zip(timed["verdicts"],
                                            base["oracle"]))
    check(mismatches == 0, f"mesh_pp: {mismatches} verdicts differ from "
                           "the one-shot card path")
    check(micro == M * batches, f"mesh_pp: microbatch count {micro} != "
                                f"{M} x {batches} batches")
    n_layers = shipped_params("bfloat16")[0].n_layers
    check(launches == n_layers * M * runs,
          f"mesh_pp: served K1 launches {launches} != n_layers x M x "
          f"{runs} sub-batches")
    record = {"phase": "mesh_pp", "nvidia_smi": smi,
              "family": "encoder_validator_pp", "mesh": "2 (pp)",
              "microbatches": M, "batches": batches,
              "microbatch_count": micro, "verdict_mismatches": 0,
              "requests_per_s": timed["requests_per_s"],
              "p50_ms": timed["p50_ms"], "p99_ms": timed["p99_ms"],
              "served_k1_launches": launches, "sub_batches": runs,
              "single_device": {k: base["single"][k] for k in
                                ("requests_per_s", "p50_ms", "p99_ms")}}
    texts = seeded_texts(32, seed=53)
    for dt_name, tol in (("float32", 1e-5), ("bfloat16", 5e-2)):
        cfg, params = shipped_params(dt_name)
        tokens = torch.from_numpy(encode_texts(texts, cfg.seq_len,
                                               cfg.vocab_size))
        want, reference = counted_forward(params, tokens, cfg)
        out, counted = mesh_logits(params, tokens, cfg, mesh,
                                   "encoder_validator_pp")
        err = compare_outputs(out, want)
        same = bool((out["severity"].argmax(-1)
                     == want["severity"].argmax(-1)).all())
        check(err <= tol and same, f"mesh_pp {dt_name}: logits differ by "
                                   f"{err} > {tol} or argmax ({same})")
        record[dt_name] = {"max_abs_err": err, "argmax_equal": same,
                           "tol": tol,
                           "k1_per_forward": k1_per_forward(
                               counted, n_layers=cfg.n_layers, M=M),
                           "reference_k1_launches": reference,
                           "reference_k1_shape": reference_shape(
                               cfg, len(texts))}
    emit(record)
    return {"launches": launches, "record": record}


def moe_checkpoint(ckpt: str, dtype: str) -> tuple:
    """The repository's MoE encoder, seeded, written by the port."""
    import torch

    from vainplex_openclaw_tpu_torch.models.encoder import (
        EncoderConfig, init_params)
    from vainplex_openclaw_tpu_torch.models.pretrained import write_pretrained

    cfg = EncoderConfig(**MOE_WIDTHS, dtype=dtype)
    tree = init_params(cfg, torch.Generator().manual_seed(3))
    write_pretrained(ckpt, cfg, tree)
    return cfg


def phase_mesh_ep(smi: str, moe_dir: str) -> dict:
    """The expert-parallel validator on a (2, 2) (dp, ep) grid over one
    card, from the seeded 4-expert fp32 checkpoint."""
    import torch

    from vainplex_openclaw_tpu_torch.models import encode_texts, forward, serve
    from vainplex_openclaw_tpu_torch.models.batching import ContinuousBatcher
    from vainplex_openclaw_tpu_torch.models.pretrained import load_pretrained
    from vainplex_openclaw_tpu_torch.ops import flash_attention as fa

    cfg, params = load_pretrained(moe_dir)
    texts = seeded_texts(MESH_PROMPTS, seed=54)
    prompts = [as_prompt(t) for t in texts]
    oneshot = serve.make_local_call_llm(
        moe_dir, serve_cfg={"continuousBatching": False})
    oracle = [oneshot(p) for p in prompts]
    single = timed_round(serve.make_local_call_llm(
        moe_dir, serve_cfg={"windowMs": 0.0}), prompts)
    check(single["verdicts"] == oracle, "mesh_ep: single-device batcher "
                                        "differs from the one-shot path")
    mesh = card_grid(("dp", "ep"), (2, 2))
    # stepped: known batches of 16, whose single-device aux is the reference
    stepped = ContinuousBatcher(moe_dir, max_batch=16, window_ms=0.0,
                                autostart=False, mesh=mesh,
                                plan_family="encoder_validator_moe")
    tickets = [stepped.enqueue(t) for t in texts]
    fa.launches = 0
    check(stepped.drain() == len(texts), "mesh_ep: drain")
    launches = fa.launches
    got = [t.result for t in tickets]
    mismatches = sum(a != b for a, b in zip(got, oracle))
    check(mismatches == 0, f"mesh_ep: {mismatches} verdicts differ from the "
                           "one-shot card path")
    moe_stats = stepped.stats()["moe"]
    with torch.inference_mode():
        aux = [float(forward(params, torch.from_numpy(encode_texts(
            texts[i:i + 16], cfg.seq_len, cfg.vocab_size)).cuda(),
            cfg)["moe_aux"]) for i in range(0, len(texts), 16)]
    aux_err = abs(moe_stats["auxMean"] - sum(aux) / len(aux))
    check(moe_stats["batches"] == len(aux) and aux_err <= 1e-5,
          f"mesh_ep: auxMean {moe_stats['auxMean']} vs single-device "
          f"{sum(aux) / len(aux)} ({aux_err} > 1e-5)")
    check(launches == cfg.n_layers * 2 * len(aux),
          f"mesh_ep: K1 launches {launches} != n_layers x dp x batches")
    tokens = torch.from_numpy(encode_texts(texts[:32], cfg.seq_len,
                                           cfg.vocab_size))
    with torch.inference_mode():
        want = forward(params, tokens.cuda(), cfg)
    out, counted = mesh_logits(params, tokens, cfg, mesh,
                               "encoder_validator_moe")
    err = compare_outputs(out, want)
    check(err <= 1e-5, f"mesh_ep: fp32 logits differ by {err} > 1e-5")
    threaded = ContinuousBatcher(moe_dir, window_ms=0.0, mesh=mesh,
                                 plan_family="encoder_validator_moe")
    try:
        timed = timed_round(batcher_call(threaded), prompts)
    finally:
        threaded.close()
        serve.close_batchers()
    check(timed["verdicts"] == oracle, "mesh_ep: threaded verdicts differ")
    record = {"phase": "mesh_ep", "nvidia_smi": smi,
              "family": "encoder_validator_moe", "mesh": "2x2 (dp, ep)",
              "config": {**MOE_WIDTHS, "dtype": cfg.dtype},
              "requests": len(prompts), "verdict_mismatches": 0,
              "moe_stats": moe_stats, "single_device_aux_mean":
                  sum(aux) / len(aux), "aux_mean_abs_err": aux_err,
              "aux_tol": 1e-5, "fp32_max_abs_err": err,
              "served_k1_launches": launches,
              "k1_per_forward": k1_per_forward(counted, n_layers=cfg.n_layers,
                                               dp=2),
              "requests_per_s": timed["requests_per_s"],
              "p50_ms": timed["p50_ms"], "p99_ms": timed["p99_ms"],
              "single_device": {k: single[k] for k in
                                ("requests_per_s", "p50_ms", "p99_ms")}}
    emit(record)
    return {"launches": launches}


def phase_embed_mesh(smi: str, moe_dirs: dict) -> dict:
    """Both embeddings families on repeated-card grids against the
    single-device port on the card: fp32 top-5 and bf16 top-1 ids."""
    import dataclasses
    import tempfile

    import torch

    from vainplex_openclaw_tpu_torch.knowledge.embeddings import (
        LocalEmbeddings)
    from vainplex_openclaw_tpu_torch.models.checkpoint import read_checkpoint
    from vainplex_openclaw_tpu_torch.models.encoder import unflatten_tree
    from vainplex_openclaw_tpu_torch.models.pretrained import (
        DEFAULT_DIR, TINY_CONFIG, clear_cache, write_pretrained)
    from vainplex_openclaw_tpu_torch.ops import flash_attention as fa

    class Log:
        def info(self, *_):
            pass

        warn = error = info

    facts = seeded_facts(200, seed=32)
    queries = seeded_texts(24, seed=33)
    record = {"phase": "embed_mesh", "nvidia_smi": smi, "facts": len(facts),
              "queries": len(queries)}
    total = 0
    with tempfile.TemporaryDirectory() as fp32_dir:
        flat = {k: torch.as_tensor(v).float()
                for k, v in read_checkpoint(DEFAULT_DIR).items()}
        write_pretrained(fp32_dir, dataclasses.replace(TINY_CONFIG,
                                                       dtype="float32"),
                         unflatten_tree(flat))
        cases = [("embeddings_forward", ("dp",), (4,), TINY_CONFIG.n_layers,
                  (("float32", fp32_dir, 5), ("bfloat16", None, 1))),
                 ("embeddings_forward_moe", ("dp", "ep"), (1, 2),
                  MOE_WIDTHS["n_layers"],
                  (("float32", moe_dirs["float32"], 5),
                   ("bfloat16", moe_dirs["bfloat16"], 1)))]
        for family, axes, shape, n_layers, legs in cases:
            mesh = card_grid(axes, shape)
            entry = {"mesh": "x".join(map(str, shape)) + f" {axes}"}
            for dt_name, ckpt, k in legs:
                single = LocalEmbeddings(Log(), checkpoint_dir=ckpt)
                meshy = LocalEmbeddings(Log(), checkpoint_dir=ckpt, mesh=mesh,
                                        plan_family=family)
                single.sync(facts)
                want = [[h["id"] for h in single.search(q, k=k)]
                        for q in queries]
                torch.cuda.synchronize()
                fa.launches = 0
                t = time.perf_counter()
                meshy.sync(facts)
                got = [[h["id"] for h in meshy.search(q, k=k)]
                       for q in queries]
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
                launches = fa.launches
                check(got == want, f"embed_mesh {family} {dt_name}: search "
                                   "ids differ from the single-device port")
                forwards = 1 + meshy.query_cache_misses
                check(launches == n_layers * shape[0] * forwards,
                      f"embed_mesh {family} {dt_name}: K1 launches "
                      f"{launches} != n_layers x dp x {forwards} forwards")
                total += launches
                entry[dt_name] = {"k": k, "k1_launches": launches,
                                  "forwards": forwards,
                                  "sync_and_search_s": wall,
                                  "shard_commits":
                                      meshy.timer.counts().get("shard", 0)}
            record[family] = entry
        clear_cache()
    record["k1_launches"] = total
    emit(record)
    return {"launches": total}


def time_attention(B, H, Lq, Lk, Dh, dt_name: str, stats: bool,
                   seed: int, n: int = 200, reps: int = 15) -> dict:
    """K1 (or K2 with ``stats``) at head dim ``Dh`` in one dtype,
    prefix-masked (all keys valid at B = 1), beside its plain version,
    SDPA (the normalized output: K1's function, so K1's ``library_ms``
    and K2's ``sdpa_normalized_ms``) and the bound, in turns within this
    call (``time_ms`` of ``n`` calls, ``reps`` times); the kernel's output
    held against the plain version's. Above a compiled width the kernel
    runs on q, k and v zero-padded as a launch pads them (the wide library
    above 128) with the scale of ``Dh``; the bound is ``Dh``'s."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from vainplex_openclaw_tpu_torch.ops import _build
    from vainplex_openclaw_tpu_torch.ops import flash_attention as fa

    dtype = getattr(torch, dt_name)
    q, k, v, mask = make_qkv(np.random.default_rng(seed), B, H, Lq, Lk, Dh,
                             dtype, "prefix" if B > 1 else False, "cuda")
    bias = fa._bias(mask, B, Lk, q.device)
    width = fa.kernel_head_dim(Dh, dt_name)
    if width > fa.MAX_HEAD_DIM:
        lib = _build.load_library("flash_attention",
                                  defines=_build.WIDE_DEFINES)
    else:
        lib = _build.load_library("flash_attention",
                                  tiles=fa.launch_tiles(Lq, Lk, dt_name))
    qp, kp, vp = (fa._pad_head_dim(t, width) for t in (q, k, v))
    if stats:
        got = (torch.empty((B, H, Lq, width), dtype=torch.float32,
                           device="cuda"),
               torch.empty((B, H, Lq), dtype=torch.float32, device="cuda"),
               torch.empty((B, H, Lq), dtype=torch.float32, device="cuda"))
        plain = functools.partial(fa.flash_attention_stats_reference, q, k,
                                  v, mask)
    else:
        got = torch.empty_like(qp)
        plain = functools.partial(fa.flash_attention_reference, q, k, v,
                                  mask)
    kernel = raw_launch(lib, qp, kp, vp, bias, got,
                        f"{'K2' if stats else 'K1'} timing", Dh ** -0.5)

    sdpa_mask = bias.to(dtype)[:, None, None, :]
    timed = functools.partial(time_ms, n=n, reps=reps)
    kernel_ms = [timed(kernel)]
    plain_ms = [timed(plain) for _ in range(2)]
    kernel_ms.append(timed(kernel))
    library_ms = [timed(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=sdpa_mask)) for _ in range(2)]
    kernel_ms.append(timed(kernel))
    want = plain()
    if stats:
        rows = valid_rows(mask, B, Lq, Lk, False, "cuda")
        err = max(stats_errors((got[0][..., :Dh], *got[1:]), want, rows,
                               dt_name))
    else:
        err = k1_errors(got[..., :Dh], want, dt_name)[2]
    check(err <= TOL[dt_name], f"{'K2' if stats else 'K1'} at "
                               f"{[B, H, Lq, Lk, Dh]} {dt_name}: {err}")
    ops = PEAK_BF16_OPS_PER_S if dt_name == "bfloat16" \
        else CUDA_CORE_OPS_PER_S
    sdpa = ({"library_ms": None,
             "sdpa_normalized_ms": statistics.median(library_ms)} if stats
            else {"library_ms": statistics.median(library_ms)})
    return {"shape": [B, H, Lq, Lk, Dh], "dtype": dt_name, "stats": stats,
            "err": err, "kernel_ms": statistics.median(kernel_ms),
            "kernel_ms_runs": kernel_ms,
            "plain_ms": statistics.median(plain_ms), **sdpa,
            **attention_bound(B, H, Lq, Lk, Dh, q.element_size(), stats,
                              ops_per_s=ops)}


def time_k1(B: int, H: int, L: int, Dh: int, seed: int, n: int = 200,
            reps: int = 15) -> dict:
    """K1 at one shape (bf16, prefix mask) timed by :func:`time_attention`,
    and the wrapper the mesh paths call (bias, dtype dispatch) held
    against the plain version on the same inputs."""
    import numpy as np
    import torch

    from vainplex_openclaw_tpu_torch.ops import flash_attention as fa

    record = time_attention(B, H, L, L, Dh, "bfloat16", False, seed, n=n,
                            reps=reps)
    q, k, v, mask = make_qkv(np.random.default_rng(seed), B, H, L, L, Dh,
                             torch.bfloat16, "prefix", "cuda")
    wrapper_err = k1_errors(fa.flash_attention(q, k, v, mask),
                            fa.flash_attention_reference(q, k, v, mask),
                            "bfloat16")[2]
    check(wrapper_err <= TOL["bfloat16"],
          f"K1 wrapper at {[B, H, L, Dh]}: {wrapper_err}")
    return {**record, "wrapper_row_rel_err": wrapper_err}


def phase_timing_mesh(smi: str) -> dict:
    """K1 at the shard shapes the mesh phases launch: a tp=2 column of a
    dp=2 row at the serve bucket (B=16, H=2) and a pipeline microbatch
    (B=8, H=4)."""
    record = {"phase": "timing_mesh", "nvidia_smi": smi,
              "tp2_shard": time_k1(16, 2, 64, 16, seed=61),
              "pp_microbatch": time_k1(8, 4, 64, 16, seed=62)}
    emit(record)
    return record


def phase_mesh(smi: str) -> dict:
    """Every mesh family, each grid repeating the one card."""
    import tempfile

    from vainplex_openclaw_tpu_torch.models.pretrained import clear_cache

    seconds: dict = {}

    def timed(name: str, fn, *args):
        t = time.perf_counter()
        result = fn(*args)
        seconds[name] = time.perf_counter() - t
        return result

    t0 = time.perf_counter()
    out = {"default": timed("mesh_default", phase_mesh_default, smi)}
    out["tp"] = timed("mesh_tp", phase_mesh_tp, smi, out["default"])
    out["pp"] = timed("mesh_pp", phase_mesh_pp, smi, out["default"])
    with tempfile.TemporaryDirectory() as root:
        moe_dirs = {}
        for dt_name in ("float32", "bfloat16"):
            moe_dirs[dt_name] = f"{root}/moe-{dt_name}"
            moe_checkpoint(moe_dirs[dt_name], dt_name)
        out["ep"] = timed("mesh_ep", phase_mesh_ep, smi, moe_dirs["float32"])
        out["embed"] = timed("embed_mesh", phase_embed_mesh, smi, moe_dirs)
        clear_cache()
    out["timing"] = timed("timing_mesh", phase_timing_mesh, smi)
    emit({"phase": "mesh_seconds", "nvidia_smi": smi, "seconds": seconds,
          "total": time.perf_counter() - t0})
    return out


# ── sharded training and the MoE long path (each grid repeats cuda:0) ──────

# (name, cfg widths, family, axes, shape): the three settings of train_mesh
TRAIN_MESH_SETTINGS = (
    ("tiny_tp_2x2", "tiny", "encoder_validator", ("dp", "tp"), (2, 2)),
    ("tiny_tp_1x4", "tiny", "encoder_validator", ("dp", "tp"), (1, 4)),
    ("moe_ep_2x2", "moe", "encoder_validator_moe", ("dp", "ep"), (2, 2)),
)
TRAIN_MESH_BATCH = 64
TRAIN_MESH_STEPS = 3
# fp32 on the card: the loss and the params after AdamW on the same
# gradient; gradients relative to each leaf's max |g| (GRAD_TOL)
TRAIN_LOSS_TOL = 1e-5
TRAIN_PARAM_TOL = 1e-6
# the graft's dense config (__graft_entry__.py:106-108) and its recipe of
# 30 sharded steps at batch 2·dp with a held-out split (:157-199)
GRAFT_DENSE = dict(d_model=128, n_heads=8, n_layers=2, d_ff=256, seq_len=64,
                   vocab_size=1024)
GRAFT_STEPS = 30
LONG_MOE_BATCH = 8


def mesh_k1_per_forward(cfg, axes: tuple, shape: tuple) -> int:
    """K1 launches of one forward of the ``forward`` runner: each dp row
    runs ``attend`` once per layer on every tp column that owns a head
    (min(tp, heads) of them), or once on the row under ep."""
    dp, col = shape
    per_row = min(col, cfg.n_heads) if axes[1] == "tp" else 1
    return cfg.n_layers * dp * per_row


def mesh_k1_shape(cfg, batch: int, axes: tuple, shape: tuple) -> tuple:
    """(B, H, L, Dh) of one of those launches."""
    dp, col = shape
    heads = cfg.n_heads // min(col, cfg.n_heads) if axes[1] == "tp" \
        else cfg.n_heads
    return batch // dp, heads, cfg.seq_len, cfg.d_model // cfg.n_heads


def train_batch(cfg, n: int, seed: int = 5):
    """A batch of ``n`` labelled synthetic examples at ``cfg``'s widths."""
    from vainplex_openclaw_tpu_torch.models.data import (
        TextClassificationData, synthetic_examples)

    data = TextClassificationData(synthetic_examples(4 * n, seed=seed), n,
                                  seq_len=cfg.seq_len,
                                  vocab_size=cfg.vocab_size, seed=seed)
    return list(data.epoch(0))


def copy_grad_errors(placement, want: dict) -> tuple:
    """(worst leaf, its error): every grid position's gradient against its
    block of the whole gradient ``want``, relative to the whole leaf's max
    |g|; a copy that holds only its own part of the sum fails it."""
    from vainplex_openclaw_tpu_torch.models.encoder import flatten_tree

    worst_key, worst = None, 0.0
    for i, j, tree in placement.positions():
        for key, p in flatten_tree(tree).items():
            w = want[key].float()
            block = placement.cut(key, w, i, j).cpu()
            err = float((p.grad.float().cpu() - block).abs().max()) / max(
                float(w.abs().max()), 1e-30)
            if err > worst or worst_key is None:
                worst_key, worst = key, err
    return worst_key, worst


def gathered(state, of=lambda p: p) -> dict:
    """``{path_key: tensor}`` of a sharded state's leaves (or ``of(leaf)``)
    gathered whole on the CPU."""
    from vainplex_openclaw_tpu_torch.models.encoder import flatten_tree

    return {k: v.detach().clone() for k, v in
            flatten_tree(state.params.map(of).gather()).items()}


def train_mesh_setting(name: str, widths: str, family: str, axes: tuple,
                       shape: tuple) -> dict:
    """One setting of train_mesh: the sharded card step against the
    single-device card step from the same fp32 masters and batch."""
    import dataclasses
    import tempfile

    import torch

    from vainplex_openclaw_tpu_torch.models import train
    from vainplex_openclaw_tpu_torch.models.encoder import (
        EncoderConfig, flatten_tree, init_params, params_from_numpy)
    from vainplex_openclaw_tpu_torch.models.pretrained import TINY_CONFIG
    from vainplex_openclaw_tpu_torch.ops import flash_attention as fa
    from vainplex_openclaw_tpu_torch.parallel import plan, sharded_train

    base = TINY_CONFIG if widths == "tiny" else EncoderConfig(**MOE_WIDTHS)
    mesh = card_grid(axes, shape)
    masters = init_params(base, torch.Generator().manual_seed(6))
    batches = train_batch(base, TRAIN_MESH_BATCH)[:TRAIN_MESH_STEPS + 1]
    record = {"family": family, "mesh": "x".join(map(str, shape))
              + f" {axes}", "batch": TRAIN_MESH_BATCH,
              "config": "TINY_CONFIG" if widths == "tiny" else MOE_WIDTHS}
    want_k1 = mesh_k1_per_forward(base, axes, shape)

    def sharded_state(tree=masters):
        return train.init_state(plan.place_params(tree, mesh, family),
                                train.make_optimizer())

    def single_state(cfg):
        return train.init_state(params_from_numpy(masters, cfg, "cuda",
                                                  cast=False),
                                train.make_optimizer())

    for dt_name in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, dtype=dt_name)
        single = single_state(cfg)
        single, loss_s = train.train_step(single, batches[0], cfg)
        grads_s = {k: p.grad.detach().clone()
                   for k, p in flatten_tree(single.params).items()}
        params_s = {k: p.detach().clone()
                    for k, p in flatten_tree(single.params).items()}
        state = sharded_state()
        torch.cuda.synchronize()
        fa.launches = 0
        state, loss_p = train.train_step(state, batches[0], cfg)
        torch.cuda.synchronize()
        launches = fa.launches
        check(launches == want_k1,
              f"train_mesh {name} {dt_name}: K1 launches per step "
              f"{launches} != {want_k1}")
        grads_p = gathered(state, lambda p: p.grad)
        worst_key, worst = copy_grad_errors(state.params, grads_s)
        check(worst <= GRAD_TOL[dt_name],
              f"train_mesh {name} {dt_name}: gradient of {worst_key} "
              f"differs by {worst} of its max |g| > {GRAD_TOL[dt_name]}")
        loss_err = abs(float(loss_p) - float(loss_s))
        entry = {"loss": float(loss_p), "single_device_loss": float(loss_s),
                 "loss_abs_err": loss_err, "k1_launches_per_step": launches,
                 "k1_formula": want_k1, "worst_grad_leaf": worst_key,
                 "worst_grad_rel_err": worst,
                 "grad_tol": GRAD_TOL[dt_name]}
        if dt_name == "float32":
            check(loss_err <= TRAIN_LOSS_TOL,
                  f"train_mesh {name}: loss {float(loss_p)} vs single-device "
                  f"{float(loss_s)}")
            # AdamW per copy equals AdamW on one device fed the same
            # (gathered) gradient; against the single-device step itself,
            # the elements whose gradient is not within 1e-6 of zero (Adam
            # normalizes g by |g| + 1e-8, so near zero it reads fp32 noise)
            ref = single_state(cfg)
            for k, p in flatten_tree(ref.params).items():
                p.grad = grads_p[k].cuda()
            ref.opt_state.step()
            params_p = gathered(state)
            same_grad = max(float((params_p[k] - p.detach().cpu())
                                  .abs().max())
                            for k, p in flatten_tree(ref.params).items())
            conditioned = max(float(((params_p[k] - params_s[k].cpu()).abs()
                                     * (grads_s[k].cpu().abs() > 1e-6))
                                    .max()) for k in params_s)
            unconditioned = max(float((params_p[k] - params_s[k].cpu())
                                      .abs().max()) for k in params_s)
            check(same_grad <= TRAIN_PARAM_TOL and
                  conditioned <= TRAIN_PARAM_TOL,
                  f"train_mesh {name}: params after AdamW differ by "
                  f"{same_grad} (same gradient) / {conditioned} (|g| > "
                  f"1e-6) > {TRAIN_PARAM_TOL}")
            entry.update({"params_same_grad_max_abs_err": same_grad,
                          "params_vs_single_step_max_abs_err_g_gt_1e-6":
                              conditioned,
                          "params_vs_single_step_max_abs_err": unconditioned,
                          "param_tol": TRAIN_PARAM_TOL})
            for batch in batches[1:TRAIN_MESH_STEPS]:
                state, _ = train.train_step(state, batch, cfg)
            bad = sharded_train.unequal_copies(state.params)
            check(state.step == TRAIN_MESH_STEPS and not bad,
                  f"train_mesh {name}: copies differ after "
                  f"{TRAIN_MESH_STEPS} steps: {bad[:3]}")
            entry["copies_bit_equal_after_steps"] = TRAIN_MESH_STEPS
            # the control: each copy's own part of the gradient, no sum
            control = sharded_state()
            loss = train.loss_fn(control.params, train.batch_to(
                batches[0], torch.device("cuda")), cfg)
            loss.backward()
            sharded_train.fill_missing_grads(control.params)
            _, control_err = copy_grad_errors(control.params, grads_s)
            check(control_err > GRAD_TOL[dt_name],
                  f"train_mesh {name}: the step without the cross-copy sum "
                  f"passes the gradient check ({control_err})")
            entry["control_worst_grad_rel_err"] = control_err
            # save, restore onto a fresh placement, one more step each
            with tempfile.TemporaryDirectory() as ckpt:
                train.save_state(ckpt, state)
                fresh = sharded_state(init_params(
                    base, torch.Generator().manual_seed(9)))
                restored = train.restore_state(ckpt, fresh)
            nxt = batches[TRAIN_MESH_STEPS]
            state, loss_a = train.train_step(state, nxt, cfg)
            restored, loss_b = train.train_step(restored, nxt, cfg)
            a, b = gathered(state), gathered(restored)
            check(float(loss_a) == float(loss_b),
                  f"train_mesh {name}: the loss of the step after restore "
                  f"is not bit-exact ({float(loss_a)} vs {float(loss_b)})")
            # the params after that step: equal where the backward is
            # deterministic (the embedding gather's backward accumulates
            # with atomics on the CPU at this size)
            entry["restore_step_loss"] = [float(loss_a), float(loss_b)]
            entry["restore_step_params_max_abs_diff"] = max(
                float((a[k] - b[k]).abs().max()) for k in a)
            sharded = sharded_state()
            alone = single_state(cfg)
            entry["ms_per_step"] = wall_ms(
                lambda: train.train_step(sharded, batches[0], cfg), reps=10)
            entry["single_device_ms_per_step"] = wall_ms(
                lambda: train.train_step(alone, batches[0], cfg), reps=10)
        record[dt_name] = entry
    record["k1_shape"] = list(mesh_k1_shape(base, TRAIN_MESH_BATCH, axes,
                                            shape))
    return record


def graft_recipe() -> dict:
    """30 sharded steps of the graft's dense config on (2, 2) over (dp, tp)
    at batch 2·dp: the held-out keep loss must fall."""
    import torch

    from vainplex_openclaw_tpu_torch.models import train
    from vainplex_openclaw_tpu_torch.models.data import (
        TextClassificationData, synthetic_examples)
    from vainplex_openclaw_tpu_torch.models.encoder import (
        EncoderConfig, init_params)
    from vainplex_openclaw_tpu_torch.ops import flash_attention as fa
    from vainplex_openclaw_tpu_torch.parallel import plan

    cfg = EncoderConfig(**GRAFT_DENSE)
    shape = (2, 2)
    mesh = card_grid(("dp", "tp"), shape)
    B = max(shape[0] * 2, 2)
    n_train = max(128, 4 * B)
    examples = synthetic_examples(n_train + 32, seed=5)
    train_data = TextClassificationData(examples[:n_train], batch_size=B,
                                        seq_len=cfg.seq_len,
                                        vocab_size=cfg.vocab_size, seed=5)
    heldout = TextClassificationData(examples[n_train:], batch_size=B,
                                     seq_len=cfg.seq_len,
                                     vocab_size=cfg.vocab_size, seed=5)
    state = train.init_state(plan.place_params(
        init_params(cfg, torch.Generator().manual_seed(0)), mesh,
        "encoder_validator"), train.make_optimizer())
    ev0 = train.evaluate(state.params, heldout, cfg)
    torch.cuda.synchronize()
    fa.launches = 0
    t = time.perf_counter()
    epoch = 0
    while state.step < GRAFT_STEPS:
        for batch in train_data.epoch(epoch):
            state, _ = train.train_step(state, batch, cfg)
            if state.step >= GRAFT_STEPS:
                break
        epoch += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = fa.launches
    ev1 = train.evaluate(state.params, heldout, cfg)
    want = GRAFT_STEPS * mesh_k1_per_forward(cfg, ("dp", "tp"), shape)
    check(launches == want, f"graft recipe: K1 launches {launches} != {want}")
    check(ev1["keep_loss"] < ev0["keep_loss"],
          f"graft recipe: held-out keep loss {ev0['keep_loss']} -> "
          f"{ev1['keep_loss']} did not fall")
    return {"config": {**GRAFT_DENSE, "dtype": cfg.dtype},
            "mesh": "2x2 ('dp', 'tp')", "batch": B, "steps": GRAFT_STEPS,
            "k1_launches": launches, "keep_loss": [ev0["keep_loss"],
                                                   ev1["keep_loss"]],
            "keep_accuracy": [ev0["keep_accuracy"], ev1["keep_accuracy"]],
            "severity_accuracy": ev1["severity_accuracy"],
            "wall_s": wall, "ms_per_step": wall * 1e3 / GRAFT_STEPS,
            "k1_shape": list(mesh_k1_shape(cfg, B, ("dp", "tp"), shape))}


def phase_train_mesh(smi: str) -> dict:
    """Sharded training on grids that repeat the one card."""
    t0 = time.perf_counter()
    record = {"phase": "train_mesh", "nvidia_smi": smi,
              "grad_tol": GRAD_TOL}
    for name, widths, family, axes, shape in TRAIN_MESH_SETTINGS:
        record[name] = train_mesh_setting(name, widths, family, axes, shape)
    record["graft_recipe"] = graft_recipe()
    record["k1_launches"] = sum(
        record[name][dt]["k1_launches_per_step"]
        for name, *_ in TRAIN_MESH_SETTINGS for dt in ("float32", "bfloat16")
    ) + record["graft_recipe"]["k1_launches"]
    record["timing"] = {
        "dp_tp_shard": time_k1(*record["tiny_tp_2x2"]["k1_shape"], seed=63),
        "dp_ep_row": time_k1(*record["moe_ep_2x2"]["k1_shape"], seed=64)}
    record["seconds"] = time.perf_counter() - t0
    emit(record)
    return record


def phase_long_moe(smi: str) -> dict:
    """The MoE encoder through ``forward_long`` on (1, 4) over (dp, sp)
    against the single-device card forward."""
    import dataclasses

    import torch

    from vainplex_openclaw_tpu_torch.models import encode_texts, forward
    from vainplex_openclaw_tpu_torch.models.encoder import (
        EncoderConfig, init_params, params_from_numpy)
    from vainplex_openclaw_tpu_torch.models.long_context import forward_long
    from vainplex_openclaw_tpu_torch.ops import flash_attention as fa

    base = EncoderConfig(**MOE_WIDTHS)
    tree = init_params(base, torch.Generator().manual_seed(7))
    tokens = torch.from_numpy(encode_texts(
        seeded_texts(LONG_MOE_BATCH, seed=71), base.seq_len,
        base.vocab_size)).cuda()
    mesh = card_grid(("dp", "sp"), (1, 4))
    record = {"phase": "long_moe", "nvidia_smi": smi,
              "config": MOE_WIDTHS, "mesh": "1x4 ('dp', 'sp')",
              "batch": LONG_MOE_BATCH}
    for dt_name in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, dtype=dt_name)
        params = params_from_numpy(tree, cfg, "cuda")
        with torch.inference_mode():
            torch.cuda.synchronize()
            fa.stats_launches = 0
            out = forward_long(params, tokens, cfg, mesh)
            torch.cuda.synchronize()
            launches = fa.stats_launches
            want = forward(params, tokens, cfg)
        want_k2 = cfg.n_layers * 1 * 4 * 4
        check(launches == want_k2, f"long_moe {dt_name}: K2 launches "
                                   f"{launches} != n_layers x dp x sp^2")
        check(all(bool(torch.isfinite(out[h].float()).all())
                  for h in ("severity", "keep", "mood", "embedding")),
              f"long_moe {dt_name}: non-finite output")
        err = compare_outputs(out, want)
        aux_err = abs(float(out["moe_aux"]) - float(want["moe_aux"]))
        same = bool((out["severity"].argmax(-1)
                     == want["severity"].argmax(-1)).all())
        check(same, f"long_moe {dt_name}: severity argmax differs")
        if dt_name == "float32":
            check(err <= 1e-5 and aux_err <= 1e-5,
                  f"long_moe fp32: logits differ by {err}, moe_aux by "
                  f"{aux_err} > 1e-5")
        record[dt_name] = {"max_abs_err": err, "moe_aux": float(out["moe_aux"]),
                           "moe_aux_abs_err": aux_err, "argmax_equal": same,
                           "k2_launches": launches,
                           "tol": 1e-5 if dt_name == "float32" else "argmax"}
    record["k2_launches"] = sum(record[d]["k2_launches"]
                                for d in ("float32", "bfloat16"))
    emit(record)
    return record


# ── the batched similarity twins ─────────────────────────────────────────

SIM_JACCARD_N = (64, 512, 4096)
SIM_DIM = 1024
# K3's legs, (L, pairs): batch_levenshtein_ratio's default length, the trace
# analyzer's doom-loop detector (signals.py: length=LEVENSHTEIN_CAP + 12 over
# at least BATCH_SIMILARITY_MIN = 32 pairs, bucketed to a power of two) and
# a length past the 512 that K3 once refused, where the 500-character cap
# in UTF-8 reaches 2000 bytes
SIM_LEN = 128
DETECTOR_LEN = 512
LONG_LEV_LEN = 2048
LEV_LEGS = ((SIM_LEN, 32), (SIM_LEN, 256), (SIM_LEN, 4096),
            (DETECTOR_LEN, 32), (DETECTOR_LEN, 256), (DETECTOR_LEN, 4096),
            (LONG_LEV_LEN, 32))
DETECTOR_EDGES = (31, 32, 33, 63, 64, 65, 500)  # a's lengths at word edges
# K3's bound counts the bit-parallel recurrence (Myers 1999, Hyyrö's form)
# as the kernel's inner step runs it: one word step advances 32 DP cells
# with Xv = Eq | VN (1), Xh = ((Eq & VP) + VP + carry-in) ^ VP | Eq (5),
# HP = VN | ~(Xh | VP) (3), HN = VP & Xh (1), HP and HN shifted up by one
# with the bit from the word below (2 each), VP = HN | ~(Xv | HP) (3) and
# VN = HP & Xv (1): 18 operations; forming Eq and passing the carry and the
# shifted bits between words are not counted. The rate is the data sheet's
# 67e12 a second for the CUDA cores outside the tensor cores, deliberately
# generous: the INT32 pipe is 64 lanes per SM and clock (132 SMs x ~1.98
# GHz = 16.7e12), and a three-input LOP3 does two of the operations counted
# here in one instruction, so the larger rate keeps the bound a least time
# whatever the kernel issues.
K3_OPS_PER_WORD_STEP = 18
# The per-cell bound of the one-thread-per-pair DP kernel, kept as
# dp_cell_bound_ms: per DP cell a compare, two adds and two mins at the
# same rate
K3_OPS_PER_CELL = 5
CUDA_CORE_OPS_PER_S = 67e12
BOUND_SLACK = 1.05  # a kernel_ms below bound_ms / BOUND_SLACK fails
K3_SOURCE = "vainplex_openclaw_tpu_torch/ops/csrc/levenshtein.cu"
# _batch_levenshtein_jax, the jitted DP K3 stands in for
K3_REPLACES = "vainplex_openclaw_tpu/ops/similarity.py:273"
_COMMAND_WORDS = ("git", "commit", "-m", "push", "--force", "origin", "main",
                  "npm", "run", "test", "build", "pytest", "-q", "tests/",
                  "docker", "compose", "up", "-d", "kubectl", "apply", "-f",
                  "deploy.yaml", "cat", "/var/log/app.log", "|", "grep",
                  "ERROR", "rm", "-rf", "/tmp/cache", "curl", "-sS",
                  "http://localhost:8080/health", "python3", "-c",
                  "'import sys; print(sys.path)'", "&&", "ls", "-la", "cd",
                  "src/api", "sed", "-i", "'s/v1/v2/g'", "config.toml")
_MULTIBYTE = "aé€𝄞"  # 1, 2, 3 and 4 bytes in UTF-8


def seeded_multi_hot(n: int, seed: int):
    """``n`` multi-hot rows of ``SIM_DIM`` bits, 0 to 12 bits a row (an
    empty row among them), over a narrow band of bit indices so that rows
    overlap."""
    import numpy as np

    rng = np.random.default_rng(seed)
    X = np.zeros((n, SIM_DIM), np.float32)
    for i in range(n):
        X[i, rng.integers(0, 48, size=rng.integers(0, 13))] = 1.0
    X[n // 2] = 0.0
    return X


def seeded_pairs(n: int, seed: int) -> list:
    """``n`` string pairs of 0 to 200 characters over a 4-letter alphabet
    (long strings pass the 128-byte window), an empty pair and an equal pair
    among them."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def word() -> str:
        return "".join("acgt"[c] for c in rng.integers(
            0, 4, size=rng.integers(0, 201)))

    pairs = [(word(), word()) for _ in range(n)]
    pairs[0] = ("", "")
    pairs[1] = (pairs[2][0], pairs[2][0])
    return pairs


def near_duplicate(s: str, rng, alphabet: str, keep_length: bool) -> str:
    """``s`` after 1 to 5 random edits from ``alphabet``: substitutions
    only when ``keep_length``, else substitutions, insertions and
    deletions."""
    out = list(s)
    for _ in range(int(rng.integers(1, 6))):
        kind = (0 if keep_length else 1 if not out
                else int(rng.integers(0, 3)))
        ch = alphabet[int(rng.integers(len(alphabet)))]
        at = int(rng.integers(0, len(out) + (kind == 1)))
        if kind == 0:
            out[at] = ch
        elif kind == 1:
            out.insert(at, ch)
        else:
            del out[at]
    return "".join(out)


_ASCII = "".join(map(chr, range(32, 127)))


def seeded_command(rng, length: int) -> str:
    """A shell command of ``length`` characters from ``_COMMAND_WORDS``."""
    words = []
    while len(" ".join(words)) < length:
        words.append(_COMMAND_WORDS[int(rng.integers(len(_COMMAND_WORDS)))])
    return " ".join(words)[:length]


def detector_pairs(n: int, seed: int) -> list:
    """``n`` pairs shaped like the doom-loop detector's: ASCII commands of
    1 to 500 characters, the odd pairs near-duplicates of their partner a
    few edits apart (the retries it looks for), the even ones independent;
    an empty pair (the bucket's padding), an equal pair, and pairs whose
    first string is ``DETECTOR_EDGES`` long, partnered with a substitution
    of itself."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pairs = []
    for i in range(n):
        a = seeded_command(rng, int(rng.integers(1, 501)))
        b = (near_duplicate(a, rng, _ASCII, keep_length=False)[:500]
             if i % 2 else seeded_command(rng, int(rng.integers(1, 501))))
        pairs.append((a, b or "x"))
    pairs[0] = ("", "")
    pairs[1] = (pairs[3][0], pairs[3][0])
    for i, edge in enumerate(DETECTOR_EDGES):
        a = seeded_command(rng, edge)
        pairs[2 + 2 * i] = (a, near_duplicate(a, rng, _ASCII, keep_length=True))
    return pairs


def multibyte_pairs(n: int, seed: int) -> list:
    """``n`` pairs of 480 to 500 characters of 1- to 4-byte UTF-8 (up to
    2000 bytes, 63 words of 32 tokens), half near-duplicates; the first
    pair is 500 four-byte characters against a near-duplicate."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def text() -> str:
        return "".join(rng.choice(list(_MULTIBYTE), size=int(
            rng.integers(480, 501)), p=(0.1, 0.2, 0.3, 0.4)))

    pairs = []
    for i in range(n):
        a = text()
        pairs.append((a, near_duplicate(a, rng, _MULTIBYTE, False)[:500]
                      if i % 2 else text()))
    pairs[0] = ("𝄞" * 500, near_duplicate("𝄞" * 500, rng, _MULTIBYTE, True))
    return pairs


def lev_leg_pairs(L: int, n: int) -> list:
    """The seeded pairs of one K3 leg."""
    if L == SIM_LEN:
        return seeded_pairs(n, seed=80 + n)
    if L == DETECTOR_LEN:
        return detector_pairs(n, seed=90 + n)
    return multibyte_pairs(n, seed=100 + n)


def jaccard_numpy(Xa, Xb):
    """The JAX package's numpy formulation of the Jaccard block."""
    import numpy as np

    inter = Xa @ Xb.T
    union = Xa.sum(axis=1)[:, None] + Xb.sum(axis=1)[None, :] - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(union > 0, inter / union, 1.0)


def levenshtein_numpy(A, B, len_a, len_b):
    """The JAX package's vectorized numpy row DP
    (``_batch_levenshtein_numpy``)."""
    import numpy as np

    n, L = A.shape
    idx = np.arange(L + 1, dtype=np.int32)
    prev = np.broadcast_to(idx, (n, L + 1)).copy()
    for i in range(1, L + 1):
        cost = (A != B[:, i - 1][:, None]).astype(np.int32)
        tent = np.empty_like(prev)
        tent[:, 0] = i
        tent[:, 1:] = np.minimum(prev[:, 1:] + 1, prev[:, :-1] + cost)
        curr = np.minimum.accumulate(tent - idx, axis=1) + idx
        prev = np.where((i <= len_b)[:, None], curr, prev)
    return prev[np.arange(n), len_a]


def wall_ms(fn, reps: int = 5) -> float:
    """Median host-clock ms of ``fn`` up to the card's end of its work
    (``torch.cuda.synchronize``), after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t) * 1e3)
    return statistics.median(samples)


def levenshtein_bound(L: int, len_a, len_b) -> dict:
    """The least time the card could take for K3 on the pairs of ``L``
    int32 tokens whose lengths are ``len_a`` and ``len_b``: bytes read
    once and written once, and ``K3_OPS_PER_WORD_STEP`` integer operations
    for each word step of the bit-parallel recurrence that these inputs
    need (the sum of len_b · ⌈len_a / 32⌉) at ``CUDA_CORE_OPS_PER_S``.
    The bytes are the tokens the distance depends on, a pair's first
    len_a of a and first len_b of b (none where either length is 0: the
    distance is then the other length), both lengths, and the distance.
    ``dp_cell_bound_ms`` is the per-cell reading of the same bytes and
    ``K3_OPS_PER_CELL`` operations for each DP cell (len_a · len_b)."""
    import numpy as np

    la = np.clip(np.asarray(len_a, np.int64), 0, L)
    lb = np.clip(np.asarray(len_b, np.int64), 0, L)
    n = len(la)
    tokens = int(np.where((la > 0) & (lb > 0), la + lb, 0).sum())
    n_bytes = tokens * 4 + 2 * n * 4 + n * 4
    word_steps = int((lb * ((la + 31) // 32)).sum())
    cells = int((la * lb).sum())
    n_ops = K3_OPS_PER_WORD_STEP * word_steps
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / CUDA_CORE_OPS_PER_S * 1e3
    t_cells = K3_OPS_PER_CELL * cells / CUDA_CORE_OPS_PER_S * 1e3
    return {"bytes": n_bytes, "operations": n_ops, "word_steps": word_steps,
            "cells": cells, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "dp_cell_bound_ms": max(t_bytes, t_cells)}


def check_bound(kernel_ms: float, bound_ms: float, what: str) -> None:
    """A kernel read faster than its bound means the bound counts the
    wrong work: fail."""
    check(kernel_ms >= bound_ms / BOUND_SLACK,
          f"{what}: kernel_ms {kernel_ms} is below bound_ms {bound_ms} / "
          f"{BOUND_SLACK}: the bound's count is wrong")


def detector_split(sim, pairs: list, L: int, reps: int = 5) -> dict:
    """Where one ``batch_levenshtein_ratio`` call's time goes, by its
    stages, each timed on the host clock up to ``torch.cuda.synchronize``
    (medians of ``reps``): tokenizing both sides with their lengths, the
    copy of the four bucketed arrays to the card, K3, and the distances'
    copy back."""
    import numpy as np
    import torch

    def tokenize():
        A = sim.tokenize_fixed([a for a, _ in pairs], L)
        B = sim.tokenize_fixed([b for _, b in pairs], L)
        return (A, B, (A > 0).sum(axis=1).astype(np.int32),
                (B > 0).sum(axis=1).astype(np.int32))

    host = tokenize()
    stages = {
        "tokenize_ms": tokenize,
        "copy_in_ms": lambda: [torch.from_numpy(x).cuda() for x in host],
    }
    dev = stages["copy_in_ms"]()
    stages["kernel_ms"] = lambda: sim.levenshtein_rows(*dev)
    out = stages["kernel_ms"]()
    stages["copy_out_ms"] = lambda: out.cpu().numpy()
    split = {name: wall_ms(fn, reps=reps) for name, fn in stages.items()}
    split["sum_ms"] = sum(split.values())
    return split


def levenshtein_leg(sim, L: int, n: int) -> dict:
    """One K3 leg: ``n`` seeded pairs at length ``L`` through
    ``batch_levenshtein_ratio`` on the card with K3 counted from 0 (one
    launch), the ratios bit-identical to numpy's, the distances equal to
    the plain version's and numpy's (and the ratios of the first pairs to
    the scalar DP where its characters are the batch's bytes), then the
    call, K3 and the plain version timed beside the bound."""
    import numpy as np
    import torch

    pairs = lev_leg_pairs(L, n)
    torch.cuda.synchronize()
    sim.launches = 0
    got = sim.batch_levenshtein_ratio(pairs, length=L)
    torch.cuda.synchronize()
    launches = sim.launches
    check(launches == 1, f"similarity: K3 launches {launches} != 1 "
                         f"for {n} pairs at L={L}")
    A = sim.tokenize_fixed([a for a, _ in pairs], L)
    B = sim.tokenize_fixed([b for _, b in pairs], L)
    la = (A > 0).sum(axis=1).astype(np.int32)
    lb = (B > 0).sum(axis=1).astype(np.int32)
    dist = levenshtein_numpy(A, B, la, lb)
    max_len = np.maximum(la, lb)
    with np.errstate(divide="ignore", invalid="ignore"):
        want = np.where(max_len > 0, 1.0 - dist / max_len,
                        1.0).astype(np.float32)
    check(got.dtype == np.float32 and np.array_equal(
        got.view(np.int32), want.view(np.int32)),
          f"similarity: Levenshtein at {n} pairs, L={L}, is not "
          "bit-identical to numpy")
    # the scalar DP counts characters: over L=128 bytes of the 4-letter
    # pairs, and over the detector's ASCII, they are the batch's bytes
    n_scalar = 0 if L == LONG_LEV_LEN else 256 if L == SIM_LEN else 16
    scalar = np.array([sim.levenshtein_ratio(a[:L], b[:L])
                       for a, b in pairs[:n_scalar]], np.float32)
    check(np.array_equal(got[:n_scalar], scalar),
          f"similarity: Levenshtein at {n} pairs, L={L}, differs from the "
          "scalar DP")
    Ad, Bd, lad, lbd = (torch.from_numpy(x).cuda() for x in (A, B, la, lb))
    kernel = sim.levenshtein_rows(Ad, Bd, lad, lbd)
    plain = sim.levenshtein_rows_reference(Ad, Bd, lad, lbd)
    torch.cuda.synchronize()
    err = int((kernel - plain).abs().max())
    check(err == 0 and np.array_equal(kernel.cpu().numpy(), dist),
          f"similarity: K3 at {n} pairs, L={L}, differs from its plain "
          f"version by {err} or from numpy")
    # the plain version runs ~11 launches a DP row: fewer repeats at 2048
    plain_reps = (1, 3, 1) if L == LONG_LEV_LEN else (5, 5, 2)
    leg = {
        "length": L, "pairs": n, "bit_identical": True,
        "scalar_checked": n_scalar, "k3_launches": launches,
        "distinct_values": int(len(np.unique(got))), "max_abs_err": err,
        "max_len_a": int(la.max()), "max_words": int((la.max() + 31) // 32),
        "ms": wall_ms(lambda: sim.batch_levenshtein_ratio(pairs, length=L)),
        "kernel_ms": time_ms(lambda: sim.levenshtein_rows(Ad, Bd, lad, lbd),
                             n=20, reps=5, warmup=3),
        "plain_ms": time_ms(lambda: sim.levenshtein_rows_reference(
            Ad, Bd, lad, lbd), n=plain_reps[0], reps=plain_reps[1],
            warmup=plain_reps[2]),
        **levenshtein_bound(L, la, lb)}
    check_bound(leg["kernel_ms"], leg["bound_ms"], f"K3 at L={L}, {n} pairs")
    if (L, n) == (DETECTOR_LEN, 4096):
        leg["split"] = detector_split(sim, pairs, L)
    return leg


# K3's Eq on tokens the legs' byte strings never hold, (L, a's tokens, b's
# tokens): a band of a outside 0..256 takes the ballot path; a inside it
# with b outside it reads the Peq table's zero row, and b's 251..256 its
# last rows (at kWords 4 and 16, the words that end a warp's table)
K3_OUTSIDE = (-7, 300, 2**31 - 1, -2**31, 65536)
K3_TABLE = (0, 1, 97, 251, 252, 253, 254, 255, 256)
K3_TOKEN_CASES = {
    "ballot_L512": (DETECTOR_LEN, K3_OUTSIDE, K3_OUTSIDE),
    "table_b_outside_L128": (SIM_LEN, K3_TABLE, K3_TABLE + K3_OUTSIDE),
    "table_b_outside_L512": (DETECTOR_LEN, K3_TABLE, K3_TABLE + K3_OUTSIDE),
}


def k3_tokens(sim, L: int, a_tokens, b_tokens, n: int = 64,
              seed: int = 174) -> dict:
    """K3 on ``n`` rows of a drawn from ``a_tokens`` and b a copy of a with
    a fifth of its tokens redrawn from ``b_tokens`` (small sets, so
    distances stay short of the lengths), against the plain version and
    numpy; random lengths, an empty a and an empty b among them."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    a_tokens = np.array(a_tokens, np.int64)
    b_tokens = np.array(b_tokens, np.int64)
    A = a_tokens[rng.integers(0, len(a_tokens), size=(n, L))].astype(np.int32)
    B = A.copy()
    flips = rng.random((n, L)) < 0.2
    B[flips] = b_tokens[rng.integers(0, len(b_tokens), size=int(flips.sum()))]
    la = rng.integers(0, L + 1, size=n).astype(np.int32)
    lb = np.clip(la + rng.integers(-40, 41, size=n), 0, L).astype(np.int32)
    la[0], lb[1] = 0, 0
    dist = levenshtein_numpy(A, B, la, lb)
    Ad, Bd, lad, lbd = (torch.from_numpy(x).cuda() for x in (A, B, la, lb))
    kernel = sim.levenshtein_rows(Ad, Bd, lad, lbd)
    plain = sim.levenshtein_rows_reference(Ad, Bd, lad, lbd)
    err = int((kernel - plain).abs().max())
    check(err == 0 and np.array_equal(kernel.cpu().numpy(), dist),
          f"similarity: K3 on tokens {a_tokens.tolist()} / "
          f"{b_tokens.tolist()} at L={L} differs from its plain version by "
          f"{err} or from numpy")
    return {"length": L, "pairs": n, "max_abs_err": err,
            "distinct_values": int(len(np.unique(dist)))}


def phase_similarity(smi: str) -> dict:
    """Both batched similarity twins on the card, bit-identical to the
    numpy formulations, K3 against its plain version at every leg of
    ``LEV_LEGS``, and their times."""
    import numpy as np
    import torch

    from vainplex_openclaw_tpu_torch.ops import similarity as sim

    record = {"phase": "similarity", "nvidia_smi": smi, "jaccard": {},
              "levenshtein": {}}
    for n in SIM_JACCARD_N:
        X = seeded_multi_hot(n, seed=70 + n)
        got = sim.jaccard_from_rows(X)
        want = jaccard_numpy(X, X).astype(np.float32)
        check(got.dtype == np.float32 and np.array_equal(
            got.view(np.int32), want.view(np.int32)),
              f"similarity: Jaccard at N={n} is not bit-identical to numpy")
        Xd = torch.from_numpy(X).cuda()
        record["jaccard"][str(n)] = {
            "dim": SIM_DIM, "bit_identical": True,
            "distinct_values": int(len(np.unique(got))),
            "ms": wall_ms(lambda: sim.jaccard_from_rows(X)),
            "block_ms": time_ms(lambda: sim._jaccard_block(Xd, Xd), n=20,
                                reps=5, warmup=3)}
    for L, n in LEV_LEGS:
        record["levenshtein"][f"L{L}_n{n}"] = levenshtein_leg(sim, L, n)
    record["k3_launches"] = sum(leg["k3_launches"] for leg in
                                record["levenshtein"].values())
    record["levenshtein_tokens"] = {
        name: k3_tokens(sim, *case) for name, case in K3_TOKEN_CASES.items()}
    emit(record)
    return record


# ── versioned serving and the trace analyzer's classification ─────────

LIFECYCLE_PROMPTS = 256
LIFECYCLE_THREADS = 8
# (stamps landed, target) for each swap of the stream under load: the
# negated twin after ~96 stamps, the rollback target after ~192
SWAP_SCHEDULE = ((96, "v2"), (192, None))
PAGING_HOPS = 8
COLD_RESTORES = 5
MESH_SWAP_TEXTS = 48
# Two extra rounds and a factor of 2 for the promotion's pinned-bench leg:
# the twin does the incumbent's exact work, and single p50s of a host-bound
# millisecond call move by more than the default 1.25 between rounds.
PROMOTION_SETTINGS = {"benchRounds": 5, "benchFactor": 2.0}
CLASSIFY_FINDINGS = 64


def negated_twin(out_dir: str) -> None:
    """The shipped checkpoint with its severity head negated (argmax →
    argmin on every input, so every verdict changes), written by the
    port's checkpoint writer."""
    import torch

    from vainplex_openclaw_tpu_torch.models.checkpoint import read_checkpoint
    from vainplex_openclaw_tpu_torch.models.encoder import unflatten_tree
    from vainplex_openclaw_tpu_torch.models.pretrained import (
        DEFAULT_DIR, TINY_CONFIG, write_pretrained)

    flat = {k: torch.as_tensor(v).float()
            for k, v in read_checkpoint(DEFAULT_DIR).items()}
    flat["heads/severity"] = -flat["heads/severity"]
    write_pretrained(out_dir, TINY_CONFIG, unflatten_tree(flat))


def tree_bytes(tree) -> int:
    """Bytes held by the tensors of a parameter tree."""
    from vainplex_openclaw_tpu_torch.models.encoder import flatten_tree

    return sum(t.numel() * t.element_size()
               for t in flatten_tree(tree).values())


def version_audit(tickets: list, oracle: dict) -> dict:
    """Over ``tickets`` (index i → ticket of text i): ``dropped``, those not
    done or failed, and ``mis_versioned``, those whose verdict is not the
    oracle verdict of text i under the ticket's stamped version."""
    dropped = mis = 0
    for i, tk in enumerate(tickets):
        if tk is None or not tk.done.is_set() or tk.error is not None:
            dropped += 1
        elif tk.result != oracle[tk.version][i]:
            mis += 1
    return {"dropped": dropped, "mis_versioned": mis}


def quantiles_ms(samples: list) -> dict:
    s = sorted(samples)
    return {"p50": s[len(s) // 2],
            "p99": s[min(len(s) - 1, int(0.99 * len(s)))], "n": len(s)}


def swap_stream(batcher, registry, texts: list, schedule: tuple) -> dict:
    """Every text from ``LIFECYCLE_THREADS`` threads through ``batcher``
    (enqueue, then wait for the ticket), while a controller thread calls
    ``swap_to`` once each ``schedule`` entry's count of stamps has landed
    (a target of None: ``registry.rollback_target()``)."""
    n = len(texts)
    tickets: list = [None] * n
    latency: list = [0.0] * n
    lock = threading.Lock()
    stamped = [0]
    errors: list = []
    swaps: list = []

    def worker(w: int) -> None:
        try:
            for i in range(w, n, LIFECYCLE_THREADS):
                t = time.perf_counter()
                tk = batcher.enqueue(texts[i])
                with lock:
                    stamped[0] += 1
                tickets[i] = tk
                if not tk.done.wait(120.0):
                    raise TimeoutError(f"ticket {i} not served in 120 s")
                latency[i] = (time.perf_counter() - t) * 1e3
        except Exception as exc:  # noqa: BLE001 — reported by the caller
            errors.append(repr(exc))

    def controller() -> None:
        try:
            for at, target in schedule:
                deadline = time.perf_counter() + 120.0
                while True:
                    with lock:
                        if stamped[0] >= at:
                            seen = stamped[0]
                            break
                    if time.perf_counter() > deadline:
                        raise TimeoutError(f"{at} stamps never landed")
                    time.sleep(0.0002)
                res = batcher.swap_to(target or registry.rollback_target())
                swaps.append({"after_stamps": seen, **res})
        except Exception as exc:  # noqa: BLE001 — reported by the caller
            errors.append(repr(exc))

    threads = [threading.Thread(target=worker, args=(w,))
               for w in range(LIFECYCLE_THREADS)]
    threads.append(threading.Thread(target=controller))
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(300.0)
    wall = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads), "lifecycle threads hung")
    check(not errors, f"lifecycle stream errors: {errors[:3]}")
    return {"tickets": tickets, "swaps": swaps, "wall_s": wall,
            "requests_per_s": n / wall, "latency_ms": quantiles_ms(latency)}


def fresh_thread_ms(fn) -> list:
    """Host ms of two back-to-back calls of ``fn`` (each up to a
    synchronize) on a thread of their own: what a thread's first forward
    costs beyond its second."""
    import torch

    out: list = []

    def run() -> None:
        for _ in range(2):
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t) * 1e3)

    thread = threading.Thread(target=run)
    thread.start()
    thread.join(60.0)
    check(len(out) == 2, "fresh-thread probe did not finish")
    return out


def swap_protocol(batcher, texts: list) -> list:
    """The deterministic swap and rollback (the batcher stepped by hand):
    half the texts stamped v1, one batch served, swap to v2 (its drain
    serves the rest of v1), the other half stamped v2, then the rollback.
    Returns [(stamp, verdict)] in text order."""
    half = len(texts) // 2
    tickets = [batcher.enqueue(t) for t in texts[:half]]
    batcher.step()
    batcher.swap_to("v2")
    tickets += [batcher.enqueue(t) for t in texts[half:]]
    batcher.drain()
    batcher.swap_to(batcher.registry.rollback_target())
    check(all(tk.done.is_set() and tk.error is None for tk in tickets),
          "lifecycle: the stepped swap dropped a request")
    return [(tk.version, tk.result) for tk in tickets]


def phase_lifecycle(smi: str) -> dict:
    """Versioned serving of the shipped checkpoint (v1) and its negated
    twin (v2) on the card: a hot swap and rollback under load, LRU paging
    against cold restores, the promotion gate, and the swap on a (1, 2)
    grid that repeats the card."""
    import os
    import tempfile

    import torch

    from vainplex_openclaw_tpu_torch.models.batching import ContinuousBatcher
    from vainplex_openclaw_tpu_torch.models.checkpoint import (
        restore_checkpoint)
    from vainplex_openclaw_tpu_torch.models.pretrained import DEFAULT_DIR
    from vainplex_openclaw_tpu_torch.models.registry import (
        BENCH_REPEATS, ModelRegistry, clear_registries)
    from vainplex_openclaw_tpu_torch.ops import _build
    from vainplex_openclaw_tpu_torch.ops import flash_attention as fa
    from vainplex_openclaw_tpu_torch.parallel import plan

    t_phase = time.perf_counter()
    record = {"phase": "lifecycle", "nvidia_smi": smi}
    texts = seeded_texts(LIFECYCLE_PROMPTS, seed=81)
    tmp = tempfile.TemporaryDirectory()
    neg_dir = os.path.join(tmp.name, "negated")
    negated_twin(neg_dir)
    try:
        # ── hot swap and rollback under load ──────────────────────────
        reg = ModelRegistry({"enabled": True, **PROMOTION_SETTINGS},
                            name="chip:lifecycle")
        reg.register("v1")
        reg.register("v2", neg_dir)
        cfg = reg.checkout("v1")[0]
        # one card forward per version over every text
        oracle = {v: reg._score(v, texts) for v in ("v1", "v2")}
        check(all(a != b for a, b in zip(oracle["v1"], oracle["v2"])),
              "lifecycle: the negated head left a verdict unchanged")
        # A swap's drain serves on its caller's thread. Before any thread
        # but this one has served in this phase: the first and second
        # replay of 8 texts on a new thread, for a one-time cost per thread.
        record["fresh_thread_score_ms"] = fresh_thread_ms(
            lambda: reg._score("v1", texts[:8]))

        def stream(schedule):
            batcher = ContinuousBatcher(registry=reg, max_batch=32,
                                        window_ms=2.0)
            batcher.submit("warm-up request")  # outside the counted run
            torch.cuda.synchronize()
            builds0, batches0 = _build.builds, batcher.batches
            fa.launches = 0
            run = swap_stream(batcher, reg, texts, schedule)
            batcher.close()  # joins the collector: the counters are final
            torch.cuda.synchronize()
            run.update(launches=fa.launches,
                       batches=batcher.batches - batches0,
                       builds=_build.builds - builds0,
                       audit=version_audit(run["tickets"], oracle))
            return run

        plain = stream(())
        swapped = stream(SWAP_SCHEDULE)
        for name, run in (("without a swap", plain), ("through the swaps",
                                                      swapped)):
            check(run["audit"] == {"dropped": 0, "mis_versioned": 0},
                  f"lifecycle {name}: {run['audit']}")
            check(run["builds"] == 0, f"lifecycle {name}: {run['builds']} "
                                      "kernel builds")
            check(run["launches"] == cfg.n_layers * run["batches"],
                  f"lifecycle {name}: K1 launches {run['launches']} != "
                  f"{cfg.n_layers} layers x {run['batches']} batches")
        stamps = [tk.version for tk in swapped["tickets"]]
        check(len(swapped["swaps"]) == 2 and reg.active() == "v1"
              and reg.stats()["rollbacks"] == 1
              and 0 < stamps.count("v2") < len(stamps),
              f"lifecycle: swaps {len(swapped['swaps'])}, active "
              f"{reg.active()}, v2 stamps {stamps.count('v2')}")
        record["swap"] = {
            "requests": len(texts), "threads": LIFECYCLE_THREADS,
            "stamps": {v: stamps.count(v) for v in ("v1", "v2")},
            **swapped["audit"], "kernel_builds": swapped["builds"],
            "batches": swapped["batches"],
            "k1_launches": swapped["launches"],
            "swaps": [{k: s[k] for k in ("version", "after_stamps",
                                         "drained", "stages", "totalMs")}
                      for s in swapped["swaps"]],
            "requests_per_s": swapped["requests_per_s"],
            "latency_ms": swapped["latency_ms"],
            "no_swap": {"requests_per_s": plain["requests_per_s"],
                        "latency_ms": plain["latency_ms"],
                        "batches": plain["batches"],
                        "k1_launches": plain["launches"]}}

        # ── the promotion gate over the stream's shadow ring ──────────
        reg.register("v1b")  # the shipped directory again: a twin
        torch.cuda.synchronize()
        fa.launches = 0
        twin = reg.promotion_report("v1b")
        negated = reg.promotion_report("v2")
        torch.cuda.synchronize()
        promo_launches = fa.launches
        check(twin["verdictRegressions"] == 0 and twin["promote"],
              f"lifecycle: the twin was refused: {twin}")
        reg.promote("v1b", report=twin)
        check(negated["verdictRegressions"] >= 1 and not negated["promote"],
              f"lifecycle: the negated head passed the gate: {negated}")
        try:
            reg.promote("v2", report=negated)
            refused = False
        except RuntimeError:
            refused = True
        check(refused, "lifecycle: promote() did not refuse the negated head")
        scores = 2 * 2 * (1 + PROMOTION_SETTINGS["benchRounds"]
                          * BENCH_REPEATS)
        check(promo_launches == cfg.n_layers * scores,
              f"lifecycle: promotion K1 launches {promo_launches} != "
              f"{cfg.n_layers} layers x {scores} replays")
        record["promotion"] = {
            **PROMOTION_SETTINGS, "k1_launches": promo_launches,
            **{name: {k: rep[k] for k in (
                "replayed", "verdictRegressions", "candidateP50Ms",
                "incumbentP50Ms", "benchOk", "promote")}
               for name, rep in (("twin", twin), ("negated", negated))}}

        # ── LRU paging: one resident version ──────────────────────────
        preg = ModelRegistry({"enabled": True, "maxResidentVersions": 1},
                             name="chip:paging")
        preg.register("v1")
        preg.register("v2", neg_dir)
        pager = preg._pager
        evictions, wakes = [], []
        real_hibernate, real_note_wake = pager.hibernate, pager.note_wake

        def measured_hibernate(version):
            torch.cuda.synchronize()
            placed = version in preg._placed
            before = torch.cuda.memory_allocated()
            ok = real_hibernate(version)
            freed = before - torch.cuda.memory_allocated()
            evictions.append({
                "version": version, "placed": placed, "freed_bytes": freed,
                "tree_bytes": tree_bytes(preg._versions[version].params)})
            return ok

        def measured_note_wake(version, ms):
            wakes.append(ms)
            real_note_wake(version, ms)

        pager.hibernate, pager.note_wake = measured_hibernate, \
            measured_note_wake
        probe = texts[:32]
        torch.cuda.synchronize()
        fa.launches = 0
        first = {v: preg._score(v, probe) for v in ("v1", "v2")}
        for hop in range(PAGING_HOPS):
            v = ("v1", "v2")[hop % 2]
            check(preg._score(v, probe) == first[v],
                  f"lifecycle: woken {v} changed its verdicts (hop {hop})")
        torch.cuda.synchronize()
        paging_launches = fa.launches
        check(paging_launches == cfg.n_layers * (2 + PAGING_HOPS),
              f"lifecycle: paging K1 launches {paging_launches}")
        paging = preg.stats()["paging"]
        # Both versions start resident in the pager, so the first checkout
        # evicts v2 before it was ever placed (nothing to free) and v2's
        # first placement counts as a wake, as in the JAX registry; every
        # later checkout wakes one version and evicts the other's tree.
        placed_evictions = [e for e in evictions if e["placed"]]
        check(len(evictions) == paging["evictions"] == PAGING_HOPS + 2
              and len(placed_evictions) == PAGING_HOPS + 1
              and paging["wakes"] == len(wakes) == PAGING_HOPS + 1,
              f"lifecycle: {len(evictions)} evictions, paging {paging}")
        short = [e for e in placed_evictions
                 if e["freed_bytes"] < e["tree_bytes"]]
        check(not short, f"lifecycle: evictions freed less than the tree: "
                         f"{short}")
        host = preg._versions["v1"].params
        like = plan.map_tree(
            lambda _k, t: torch.empty((), dtype=t.dtype, device=preg.device),
            host)
        cold = []
        for _ in range(COLD_RESTORES):
            t = time.perf_counter()
            tree = restore_checkpoint(DEFAULT_DIR, like=like)
            torch.cuda.synchronize()
            cold.append((time.perf_counter() - t) * 1e3)
            del tree
        cold_median = statistics.median(cold)
        # Gated on the wakes this phase timed; the registry's bucketed
        # histogram can read below them, so it is kept as information.
        wake_q = quantiles_ms(wakes)
        check(wake_q["p99"] < cold_median,
              f"lifecycle: wake p99 {wake_q['p99']} ms not below the "
              f"cold restore median {cold_median} ms")
        record["paging"] = {
            "maxResidentVersions": 1, "hops": PAGING_HOPS,
            "evictions": evictions, "wakes": paging["wakes"],
            "wake_p50_ms": wake_q["p50"], "wake_p99_ms": wake_q["p99"],
            "wake_ms": wakes,
            "registry_hist_wake_p50_ms": paging["wakeP50Ms"],
            "registry_hist_wake_p99_ms": paging["wakeP99Ms"],
            "cold_restore_ms": cold, "cold_restore_median_ms": cold_median,
            "k1_launches": paging_launches}

        # ── the swap on a (1, 2) dp x tp grid over the card ───────────
        swap_texts = texts[:MESH_SWAP_TEXTS]
        runs = {}
        for name, mesh in (("single", None),
                           ("mesh", card_grid(("dp", "tp"), (1, 2)))):
            mreg = ModelRegistry({"enabled": True,
                                  "maxResidentVersions": 1},
                                 name=f"chip:swap-{name}")
            mreg.register("v1")
            mreg.register("v2", neg_dir)
            batcher = ContinuousBatcher(registry=mreg, max_batch=8,
                                        window_ms=0.0, autostart=False,
                                        mesh=mesh)
            torch.cuda.synchronize()
            fa.launches = 0
            got = swap_protocol(batcher, swap_texts)
            torch.cuda.synchronize()
            runs[name] = {"verdicts": got, "launches": fa.launches,
                          "batches": batcher.batches, "registry": mreg}
            batcher.close()
        check(runs["mesh"]["verdicts"] == runs["single"]["verdicts"],
              "lifecycle: the mesh swap's verdicts differ from the single "
              "device swap's")
        want = [oracle[v][i] for i, (v, _) in
                enumerate(runs["single"]["verdicts"])]
        check([r for _, r in runs["single"]["verdicts"]] == want,
              "lifecycle: the stepped swap is mis-versioned")
        per_batch = mesh_k1_per_forward(cfg, ("dp", "tp"), (1, 2))
        check(runs["mesh"]["launches"] == per_batch * runs["mesh"]["batches"],
              f"lifecycle: mesh K1 launches {runs['mesh']['launches']} != "
              f"{per_batch} x {runs['mesh']['batches']} batches")
        mreg = runs["mesh"]["registry"]
        with plan._sharded_lock:
            keys = {ck[0] for ck in plan._sharded_params}
        paged = [v for v in ("v1", "v2") if mreg.is_paged(v)]
        stale = [v for v in paged if mreg.placement_key(v) in keys]
        check(paged == ["v2"] and not stale,
              f"lifecycle: paged {paged}, placements left for {stale}")
        record["mesh_swap"] = {
            "grid": "1x2 (dp, tp) over cuda:0", "texts": len(swap_texts),
            "verdicts_equal_single_device": True,
            "k1_launches": runs["mesh"]["launches"],
            "k1_per_batch": per_batch, "batches": runs["mesh"]["batches"],
            "paged": paged, "stale_placements": stale}
        for v in ("v1", "v2"):
            plan.drop_sharded_params(mreg.placement_key(v))
    finally:
        clear_registries()
        tmp.cleanup()
    record["k1_launches"] = (record["swap"]["k1_launches"]
                             + record["swap"]["no_swap"]["k1_launches"]
                             + record["promotion"]["k1_launches"]
                             + record["paging"]["k1_launches"]
                             + record["mesh_swap"]["k1_launches"])
    record["seconds"] = time.perf_counter() - t_phase
    emit(record)
    return record


def phase_classify(smi: str) -> dict:
    """``classify_findings`` with the local triage head on the card: its
    ``kept`` flags against ``local_triage`` on the card and on the CPU."""
    import torch

    from vainplex_openclaw_tpu_torch.cortex.trace_analyzer.classifier import (
        classify_findings, local_triage)
    from vainplex_openclaw_tpu_torch.models.pretrained import load_pretrained
    from vainplex_openclaw_tpu_torch.ops import flash_attention as fa

    cfg, _ = load_pretrained()
    findings = triage_findings(CLASSIFY_FINDINGS, seed=41)
    torch.cuda.synchronize()
    fa.launches = 0
    t = time.perf_counter()
    out = classify_findings(findings, {}, use_local_triage=True,
                            device="cuda")
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    launches = fa.launches
    kept = [c.kept for c in out]
    check(launches == cfg.n_layers,
          f"classify: K1 launches {launches} != {cfg.n_layers} layers x 1 "
          "forward")
    card, host = local_triage(findings), local_triage(findings, device="cpu")
    check(kept == card == host,
          f"classify: kept differs from local_triage (card "
          f"{sum(a != b for a, b in zip(kept, card))}, CPU "
          f"{sum(a != b for a, b in zip(kept, host))})")
    check(0 < sum(kept) < len(kept), f"classify: kept {sum(kept)} of "
                                     f"{len(kept)}; the findings do not split")
    check(all(c.severity == f.severity and c.action_type == "manual_review"
              for c, f in zip(out, findings)),
          "classify: a finding left rule severity without an LLM")
    record = {"phase": "classify", "nvidia_smi": smi,
              "findings": len(findings), "kept": sum(kept),
              "k1_launches": launches, "ms": ms}
    emit(record)
    return record


# ── the replica fleet (replicas share cuda:0) ────────────────────────────

FLEET_SEED = 17
FLEET_REPLICA_COUNTS = (1, 2, 4)
FLEET_OPS_PER_REPLICA = 300
# offered ops/s per replica at fixed size, bench_fleet_serve's rate
FLEET_RATE_PER_REPLICA = 900.0
FLEET_AUTOSCALE_OPS = 2000
# the diurnal trace's low rate (ops/s); its peak is 4x, past what the
# replicas together serve on one host, so the autoscaler has to act
FLEET_AUTOSCALE_RATE = 800.0
FLEET_CANARY_OPS = 600
FLEET_FAILOVER_OPS = 400
FLEET_FAILOVER_AFTER = 200  # ops submitted before the worker fails
FLEET_WAIT_S = 120.0


def fleet_ops(n: int, seed: int, **kw) -> list:
    from vainplex_openclaw_tpu_torch.slo.workload import (
        generate_fleet_workload)

    return generate_fleet_workload(seed, n, tenants=4, **kw)


def timed_fleet_class():
    """A ``ReplicaFleet`` whose default factory (the scoped shared batchers
    on the card) also books every batcher it builds and the host ms of
    each batcher's first two batches, with the thread that ran them."""
    from vainplex_openclaw_tpu_torch.cluster.fleet import ReplicaFleet

    class TimedFleet(ReplicaFleet):
        def _default_batcher_factory(self, rid, worker_id):
            batcher, scope = super()._default_batcher_factory(rid, worker_id)
            if not hasattr(self, "built"):
                self.built, self.first_batches = [], {}
            self.built.append((rid, batcher))
            firsts = self.first_batches.setdefault(rid, [])
            real = batcher._run_batch

            def run(batch, _real=real, _firsts=firsts):
                t = time.perf_counter()
                _real(batch)
                if len(_firsts) < 2:
                    _firsts.append({
                        "ms": (time.perf_counter() - t) * 1e3,
                        "rows": len(batch),
                        "thread": threading.current_thread().name})

            batcher._run_batch = run
            return batcher, scope

    return TimedFleet


def fleet_reap(fleet) -> None:
    """One pass of ``pump(now)``: step (and reap) each replica whose window
    is due, without spinning on a batch a collector thread holds."""
    now = time.perf_counter()
    for rid, row in fleet.occupancy().items():
        if row["alive"] and row["pending"] > 0 and (
                row["pending"] >= row["maxBatch"]
                or now - row["oldestAt"] >= fleet._window_s):
            fleet.step_replica(rid)


def fleet_drive(fleet, ops, delivered: dict, on_submitted=None) -> dict:
    """Open loop on the real clock: each op is submitted at its arrival
    time (from the start of the run), the replicas are reaped between
    arrivals, and the run ends with a drain. Latency runs from an op's
    scheduled arrival to its delivery."""
    arrival: dict = {}
    start = time.perf_counter()
    for n, op in enumerate(ops):
        due = start + op.arrival
        while True:
            now = time.perf_counter()
            if now >= due:
                break
            fleet_reap(fleet)
            time.sleep(min(0.0002, max(0.0, due - now)))
        arrival[op.index] = due
        fleet.submit({"i": op.index, "text": op.content,
                      "tenant": f"tenant{op.tenant}"})
        if on_submitted is not None:
            on_submitted(n + 1)
    fleet_await(fleet, delivered, len(ops))
    end = max((d["at"] for d in delivered.values()), default=start)
    lat = [(delivered[i]["at"] - arrival[i]) * 1e3 for i in delivered
           if i in arrival]
    return {"wall_s": end - start,
            "requests_per_s": len(delivered) / max(end - start, 1e-9),
            "latency_ms": quantiles_ms(lat) if lat else None}


def fleet_await(fleet, delivered: dict, n: int) -> None:
    """Drain the fleet until ``n`` requests are delivered (or
    ``FLEET_WAIT_S`` passed)."""
    deadline = time.perf_counter() + FLEET_WAIT_S
    while len(delivered) < n and time.perf_counter() < deadline:
        fleet.drain()
        time.sleep(0.0005)


def fleet_collect(delivered: dict, counts: dict):
    """``on_result`` that books each delivery once with its time, and
    counts every delivery, so a second one shows."""
    def on_result(op, obs):
        i = op["i"]
        counts[i] = counts.get(i, 0) + 1
        delivered.setdefault(i, dict(obs, at=time.perf_counter()))
    return on_result


def fleet_audit(ops, delivered: dict, counts: dict, oracle: dict) -> dict:
    """Dropped (never delivered or failed), served twice, and verdicts off
    the one-shot oracle of the version that served them."""
    dropped = sum(1 for op in ops if op.index not in delivered
                  or "verdict" not in delivered[op.index])
    twice = sum(1 for c in counts.values() if c > 1)
    wrong = sum(1 for op in ops if op.index in delivered
                and "verdict" in delivered[op.index]
                and delivered[op.index]["verdict"] != oracle[
                    delivered[op.index].get("version") or "v0"][op.content])
    return {"dropped": dropped, "served_twice": twice,
            "verdict_mismatches": wrong}


def fleet_leg(name: str, cfg: dict, ops: list, oracle: dict, workers,
              smi: str, warm: bool = True, script=None) -> dict:
    """One fleet leg on the card: build, warm each initial replica's
    collector thread outside the counted run, drive ``ops`` (``script``
    acts on the fleet mid-run), drain, and check every verdict, the
    delivery counts and K1's launches against the batches fired."""
    import torch

    from vainplex_openclaw_tpu_torch.events.transport import MemoryTransport
    from vainplex_openclaw_tpu_torch.models.pretrained import TINY_CONFIG
    from vainplex_openclaw_tpu_torch.ops import flash_attention as fa

    delivered, counts = {}, {}
    fleet = timed_fleet_class()(
        cfg, transport=MemoryTransport(), workers=workers,
        on_result=fleet_collect(delivered, counts))
    warm_ms = {}
    try:
        if warm:
            for rid, batcher in fleet.built:
                t = time.perf_counter()
                batcher.submit("warm-up request")
                warm_ms[rid] = (time.perf_counter() - t) * 1e3
        torch.cuda.synchronize()
        batches0 = {id(b): b.batches for _, b in fleet.built}
        fa.launches = 0
        run = fleet_drive(fleet, ops, delivered,
                          script(fleet) if script is not None else None)
        fleet.drain()
        stats = fleet.stats()
        built = list(fleet.built)
    finally:
        fleet.close()  # joins every collector: the counters are final
    torch.cuda.synchronize()
    launches = fa.launches
    batches = sum(b.batches - batches0.get(id(b), 0) for _, b in built)
    audit = fleet_audit(ops, delivered, counts, oracle)
    check(audit == {"dropped": 0, "served_twice": 0,
                    "verdict_mismatches": 0}, f"fleet {name}: {audit}")
    check(stats["shed"] == 0 and stats["served"] == len(ops)
          and stats["routed"] == stats["served"] + stats["redelivered"],
          f"fleet {name}: routed {stats['routed']}, served "
          f"{stats['served']}, shed {stats['shed']}, redelivered "
          f"{stats['redelivered']} of {len(ops)} ops")
    check(launches == TINY_CONFIG.n_layers * batches,
          f"fleet {name}: K1 launches {launches} != "
          f"{TINY_CONFIG.n_layers} layers x {batches} batches")
    per_replica = {rid: {"batches": row["batches"],
                         "mean_batch": row["meanBatch"]}
                   for rid, row in stats["replicas"].items()}
    return {"leg": name, "nvidia_smi": smi, "ops": len(ops),
            "offered_ops_s": len(ops) / max(ops[-1].arrival, 1e-9),
            **run, **audit, "routed": stats["routed"],
            "served": stats["served"], "shed": stats["shed"],
            "redelivered": stats["redelivered"],
            "batches": batches, "k1_launches": launches,
            "replicas_built": [rid for rid, _ in built],
            "per_replica": per_replica,
            "warm_up_ms": warm_ms, "first_batches": fleet.first_batches,
            "stats": stats}


def single_batcher_leg(ops: list, oracle: dict, smi: str) -> dict:
    """The same ops through the one shared batcher of the serve path (no
    fleet): enqueued at arrival time, each ticket's delivery booked when
    the driver sees it done."""
    import torch

    from vainplex_openclaw_tpu_torch.models import serve
    from vainplex_openclaw_tpu_torch.models.pretrained import TINY_CONFIG
    from vainplex_openclaw_tpu_torch.ops import flash_attention as fa

    batcher = serve.shared_batcher(None, {"admission": None})
    batcher.submit("warm-up request")
    torch.cuda.synchronize()
    batches0 = batcher.batches
    fa.launches = 0
    open_tickets, lat, verdicts = [], [], {}
    start = time.perf_counter()

    def reap():
        now = time.perf_counter()
        while open_tickets and open_tickets[0][2].done.is_set():
            op, due, tk = open_tickets.pop(0)
            lat.append((now - due) * 1e3)
            verdicts[op.index] = tk.result

    for op in ops:
        due = start + op.arrival
        while time.perf_counter() < due:
            reap()
            time.sleep(0.0002)
        open_tickets.append((op, due, batcher.enqueue(op.content,
                                                      f"tenant{op.tenant}")))
    deadline = time.perf_counter() + FLEET_WAIT_S
    while open_tickets and time.perf_counter() < deadline:
        reap()
        time.sleep(0.0002)
    wall = time.perf_counter() - start
    serve.close_batchers()
    torch.cuda.synchronize()
    batches = batcher.batches - batches0
    wrong = sum(1 for op in ops if verdicts.get(op.index)
                != oracle["v0"][op.content])
    check(len(verdicts) == len(ops) and wrong == 0,
          f"fleet single batcher: {len(verdicts)} of {len(ops)} served, "
          f"{wrong} verdicts off the oracle")
    check(fa.launches == TINY_CONFIG.n_layers * batches,
          f"fleet single batcher: K1 launches {fa.launches}")
    return {"leg": "single_batcher", "nvidia_smi": smi, "ops": len(ops),
            "wall_s": wall, "requests_per_s": len(ops) / wall,
            "latency_ms": quantiles_ms(lat), "batches": batches,
            "mean_batch": len(ops) / max(batches, 1),
            "k1_launches": fa.launches}


def one_shot_oracle(texts: set, checkpoint_dir=None, device=None) -> dict:
    """text -> verdict of the one-shot path (one forward a text) on the
    card (or ``device``), the serve path's equivalence oracle."""
    from vainplex_openclaw_tpu_torch.models import serve

    call = serve.make_local_call_llm(
        checkpoint_dir, serve_cfg={"continuousBatching": False},
        device=device)
    return {t: call(t) for t in sorted(texts)}


def phase_fleet(smi: str) -> dict:
    """The port's ``ReplicaFleet`` on the card, its replicas' batchers and
    collector threads all on cuda:0, on the real clock: fixed 1, 2 and 4
    replicas at load proportional to their count (beside the single
    shared batcher on the same ops), the autoscaler on the diurnal
    profile, a fleet-wide canary with activate and rollback, and a
    worker's failover with requests in flight."""
    import os
    import tempfile

    from vainplex_openclaw_tpu_torch.cluster.fleet import FLEET_DEFAULTS
    from vainplex_openclaw_tpu_torch.models.registry import clear_registries
    from vainplex_openclaw_tpu_torch.sitrep.collectors import (
        collect_model_registry)

    t_phase = time.perf_counter()
    record = {"phase": "fleet", "nvidia_smi": smi,
              "fleet_defaults": dict(FLEET_DEFAULTS)}
    fixed_ops = {n: fleet_ops(FLEET_OPS_PER_REPLICA * n, FLEET_SEED + n,
                              profile="diurnal",
                              base_rate=FLEET_RATE_PER_REPLICA * n,
                              peak_factor=1.0, period_s=1.0)
                 for n in FLEET_REPLICA_COUNTS}
    auto_ops = fleet_ops(FLEET_AUTOSCALE_OPS, FLEET_SEED, profile="diurnal",
                         base_rate=FLEET_AUTOSCALE_RATE)
    canary_ops = fleet_ops(FLEET_CANARY_OPS, FLEET_SEED + 10,
                           profile="diurnal")
    failover_ops = fleet_ops(FLEET_FAILOVER_OPS, FLEET_SEED + 11,
                             profile="burst")
    tmp = tempfile.TemporaryDirectory()
    neg_dir = os.path.join(tmp.name, "negated")
    negated_twin(neg_dir)
    all_ops = [op for ops in fixed_ops.values() for op in ops] + auto_ops \
        + canary_ops + failover_ops
    t = time.perf_counter()
    oracle = {"v0": one_shot_oracle({op.content for op in all_ops})}
    oracle["v2"] = one_shot_oracle({op.content for op in canary_ops},
                                   neg_dir)
    record["oracle_s"] = time.perf_counter() - t
    check(all(oracle["v0"][op.content] != oracle["v2"][op.content]
              for op in canary_ops),
          "fleet: the negated head left a verdict unchanged")
    legs = {}
    try:
        # ── fixed replicas, load proportional to their count ──────────
        for n in FLEET_REPLICA_COUNTS:
            legs[f"fixed_{n}"] = fleet_leg(
                f"fixed_{n}", {"replicas": n, "minReplicas": n,
                               "maxReplicas": n},
                fixed_ops[n], oracle, lambda: ["w0", "w1", "w2", "w3"], smi)
        legs["single_batcher"] = single_batcher_leg(fixed_ops[1], oracle,
                                                    smi)

        # ── the autoscaler on the diurnal profile ─────────────────────
        auto = fleet_leg("autoscale", {"autoscale": True}, auto_ops, oracle,
                         lambda: ["w0", "w1", "w2", "w3"], smi)
        events = auto["stats"]["autoscaler"]["scaleEvents"]
        auto["schedule"] = [
            {k: e.get(k) for k in ("atOp", "action", "reason", "replicas",
                                   "queued", "rid")} for e in events]
        auto["decisions"] = auto["stats"]["autoscaler"]["decisions"]
        auto["spawn_first_batches"] = {
            e["rid"]: auto["first_batches"].get(e["rid"])
            for e in events if e["action"] == "spawn"}
        legs["autoscale"] = auto

        # ── fleet-wide canary, activate and rollback ──────────────────
        def canary_script(fleet):
            fleet.registry.register("v2", neg_dir)
            fleet.set_model_canary("v2", 0.5)
            third = len(canary_ops) // 3

            def on_submitted(n):
                if n == third:
                    fleet.activate_model("v2")
                elif n == 2 * third:
                    fleet.activate_model(fleet.registry.rollback_target(),
                                         reason="rollback")
            return on_submitted

        canary = fleet_leg("canary", {"replicas": 2, "modelRegistry": True},
                           canary_ops, oracle, lambda: ["w0", "w1"], smi,
                           script=canary_script)
        ops_view = collect_model_registry({}, {})
        item = next((i for i in ops_view["items"]
                     if i["registry"] == "fleet:cluster.fleet"), None)
        check(item is not None and item["active"] == "v0"
              and item["swaps"] >= 2 and item["rollbacks"] == 1,
              f"fleet canary: /ops model registry {ops_view['summary']}, "
              f"{item and {k: item[k] for k in ('active', 'swaps')}}")
        stamps = canary["stats"]["modelRegistry"]["versions"]
        check(stamps["v2"]["served"] > 0 and stamps["v0"]["served"] > 0,
              f"fleet canary: served by version {stamps}")
        canary["mis_versioned"] = canary["verdict_mismatches"]
        canary["sitrep"] = {"summary": ops_view["summary"],
                            **{k: item[k] for k in (
                                "registry", "active", "swaps", "rollbacks",
                                "promotions")},
                            "served": {v: s["served"]
                                       for v, s in item["versions"].items()}}
        legs["canary"] = canary

        # ── failover with requests in flight ──────────────────────────
        live = ["w0", "w1", "w2"]
        failover_rec = {}

        def failover_script(fleet):
            def on_submitted(n):
                if n == FLEET_FAILOVER_AFTER:
                    occ = fleet.occupancy()
                    victim = max(sorted(occ), key=lambda r: occ[r]["pending"])
                    worker = occ[victim]["workerId"]
                    failover_rec["pending_at_failure"] = {
                        r: occ[r]["pending"] for r in sorted(occ)}
                    live.remove(worker)
                    failover_rec.update(fleet.on_worker_failed(
                        worker, "killed with requests in flight"))
            return on_submitted

        failover = fleet_leg("failover", {"replicas": 3, "maxReplicas": 3},
                             failover_ops, oracle, lambda: list(live), smi,
                             script=failover_script)
        check(failover_rec.get("redelivered", 0) > 0,
              f"fleet failover: nothing in flight was redelivered "
              f"({failover_rec})")
        failover["failover"] = {k: failover_rec[k] for k in (
            "worker", "replicasLost", "respawned", "redelivered",
            "pending_at_failure")}
        legs["failover"] = failover
    finally:
        clear_registries()
        tmp.cleanup()
    for leg in legs.values():
        leg.pop("stats", None)
        emit({"phase": "fleet_leg", **leg})
    record["legs"] = {name: {k: leg[k] for k in (
        "requests_per_s", "latency_ms", "batches", "k1_launches")}
        for name, leg in legs.items()}
    record["k1_launches"] = sum(leg["k1_launches"] for leg in legs.values())
    record["seconds"] = time.perf_counter() - t_phase
    emit(record)
    return record


# ── the trace analyzer ───────────────────────────────────────────────

# A fleet's scheduled run: bench.py's chain shape (synth_events, 14 events
# a chain) and doom loops of failing exec retries, ~22,000 events under the
# analyzer's default maxEventsPerRun of 100,000; the second run adds 10%
# new chains a day later
TRACE_BENCH_CHAINS = 1000
TRACE_DOOM_CHAINS = 64
TRACE_DOOM_RETRIES = 65
TRACE_NEW_BENCH_CHAINS = 100
TRACE_NEW_DOOM_CHAINS = 6
TRACE_BASE_TS = 1_700_000_000_000.0
TRACE_DAY_MS = 86_400_000.0
TRACE_STEP_MS = 1000.0
TRACE_SEED = 111
TRACE_RUNS = ("run1", "run2")
TRACE_CLOCK = 1_700_100_000.0  # the analyzers' fixed clock (s)
TRACE_CONFIG = {"classify": {"enabled": True, "useLocalTriage": True},
                "cluster": {"incremental": True}}
# signals.py: BATCH_SIMILARITY_MIN ASCII pairs take K3, at
# LEVENSHTEIN_CAP + 12 tokens a row
TRACE_BATCH_MIN = 32
TRACE_K3_LEN = 512
TRACE_REWRITE_P = 0.15  # a retry that rewrites half its command's words
# the report's timing fields, which alone may differ card vs CPU
TRACE_TIMING_KEYS = ("durationMs", "eventsPerMinute", "stageMs")
# The clusterer's growing window: run 1 fills the 512-signal kept window,
# so the main corpus's run 2 computes no new x kept block. The cluster leg
# stays under the cap: chains of two failing calls whose errors share one
# of a few phrases and differ in their words, then 10% new chains a day
# later, whose signals join the window. No classify: it launches neither
# kernel, only the clusterer's Jaccard blocks.
TRACE_CLUSTER_CHAINS = 400
TRACE_CLUSTER_NEW_CHAINS = 40
TRACE_CLUSTER_CONFIG = {"classify": {"enabled": False},
                        "cluster": {"incremental": True}}
_CLUSTER_PHRASES = ("permission denied while opening",
                    "disk quota exceeded when writing",
                    "connection reset by peer during",
                    "certificate verify failed for")
_CLUSTER_WORDS = ("artifact", "bucket", "volume", "ledger", "replica",
                  "socket", "manifest", "archive", "tenant", "snapshot",
                  "shard", "registry", "mirror", "cache", "journal",
                  "index")
_DOOM_ERRORS = (
    "npm ERR! code ELIFECYCLE: build script exited with status 1",
    "fatal: unable to access origin: connection refused",
    "error: container api exited: OOMKilled (memory limit reached)",
    "ModuleNotFoundError: No module named requests in worker process",
)


class TraceChain:
    """Raw Schema-A events of one session, ``TRACE_STEP_MS`` apart,
    appended to ``out`` (the shape of the tests' ``EventFactory``, with no
    ``seq``: a ``MemoryTraceSource`` numbers events by their place in the
    list, so a second run over a longer list reads only the new ones)."""

    def __init__(self, out: list, agent: str, session: str,
                 start_ts: float):
        self.out, self.agent, self.session = out, agent, session
        self.ts, self.n = start_ts, 0

    def event(self, etype: str, payload: dict) -> None:
        self.ts += TRACE_STEP_MS
        self.n += 1
        self.out.append({"id": f"{self.session}-{self.n}", "ts": self.ts,
                         "agent": self.agent, "session": self.session,
                         "type": etype, "payload": payload})

    def msg_in(self, text: str) -> None:
        self.event("msg.in", {"content": text})

    def msg_out(self, text: str) -> None:
        self.event("msg.out", {"content": text})

    def call(self, tool: str, params: dict, error=None) -> None:
        self.event("tool.call", {"tool_name": tool, "params": params})
        self.event("tool.result", {"tool_name": tool, "error": error,
                                   "result": None if error else "ok"})


def trace_corpus(first_bench: int, n_bench: int, first_doom: int,
                 n_doom: int, start_ts: float, seed: int) -> list:
    """Raw events: ``n_bench`` chains of bench.py's shape (a fix request, 3
    failing ``kubectl rollout status`` calls, a false completion claim, a
    correction, a read) and ``n_doom`` doom loops of
    ``TRACE_DOOM_RETRIES`` failing ``exec`` calls whose ASCII commands of
    200 to 500 characters change by a few edits a retry, or, at
    ``TRACE_REWRITE_P``, by half their words (a pair below the 0.8
    threshold), topped up with words where they fall under 200."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out: list = []
    for c in range(first_bench, first_bench + n_bench):
        ch = TraceChain(out, f"agent{c % 4}", f"s{c}", start_ts)
        ch.msg_in(f"please fix the deployment issue number {c}")
        ch.msg_out("looking into it now")
        for _ in range(3):
            ch.call("exec", {"command": f"kubectl rollout status app{c % 7}"},
                    "error: deployment exceeded progress deadline")
        ch.msg_out("I've successfully restarted the deployment.")
        ch.msg_in("no, that's wrong — it is still failing and this is "
                  "useless")
        ch.msg_out("my apologies, let me fix that properly")
        ch.call("read", {"path": f"/var/log/app{c}.log"})
        ch.msg_out("the root cause is a bad liveness probe")
    for d in range(first_doom, first_doom + n_doom):
        ch = TraceChain(out, f"agent{d % 4}", f"doom{d}", start_ts)
        ch.msg_in("ship the release build to staging and make sure it "
                  "passes")
        command = seeded_command(rng, int(rng.integers(200, 501)))
        for _ in range(TRACE_DOOM_RETRIES):
            ch.call("exec", {"command": command},
                    _DOOM_ERRORS[d % len(_DOOM_ERRORS)])
            if rng.random() < TRACE_REWRITE_P:
                words = command.split(" ")
                for i in rng.choice(len(words), size=len(words) // 2,
                                    replace=False):
                    words[i] = _COMMAND_WORDS[int(rng.integers(
                        len(_COMMAND_WORDS)))]
                command = " ".join(words)[:500]
            else:
                command = near_duplicate(command, rng, _ASCII,
                                         keep_length=False)[:500]
            if len(command) < 200:
                command += " " + seeded_command(rng, 199 - len(command))
        ch.msg_out("the build still fails; I stopped retrying")
    return out


def trace_corpora(seed: int = TRACE_SEED) -> tuple:
    """The first run's events and the second run's new ones."""
    first = trace_corpus(0, TRACE_BENCH_CHAINS, 0, TRACE_DOOM_CHAINS,
                         TRACE_BASE_TS, seed)
    new = trace_corpus(TRACE_BENCH_CHAINS, TRACE_NEW_BENCH_CHAINS,
                       TRACE_DOOM_CHAINS, TRACE_NEW_DOOM_CHAINS,
                       TRACE_BASE_TS + TRACE_DAY_MS, seed + 1)
    return first, new


def trace_cluster_corpus(first: int, n: int, start_ts: float,
                         seed: int) -> list:
    """Raw events of the cluster leg: ``n`` chains, each two failing
    ``exec`` calls whose errors are one of ``_CLUSTER_PHRASES`` (by chain)
    and three of ``_CLUSTER_WORDS`` (seeded), so that their feature rows
    differ and fall on both sides of the clusterer's 0.5 threshold."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out: list = []
    for c in range(first, first + n):
        ch = TraceChain(out, f"agent{c % 4}", f"sync{c}", start_ts)
        ch.msg_in("run the nightly sync job")
        phrase = _CLUSTER_PHRASES[c % len(_CLUSTER_PHRASES)]
        for _ in range(2):
            words = rng.choice(len(_CLUSTER_WORDS), size=3, replace=False)
            ch.call("exec", {"command": f"sync --target store{c}"},
                    f"{phrase} " + " ".join(_CLUSTER_WORDS[int(w)]
                                            for w in words))
        ch.msg_out("the sync job could not finish")
    return out


def trace_cluster_corpora(seed: int = TRACE_SEED) -> tuple:
    """The cluster leg's first run's events and the second run's new ones."""
    first = trace_cluster_corpus(0, TRACE_CLUSTER_CHAINS, TRACE_BASE_TS, seed)
    new = trace_cluster_corpus(TRACE_CLUSTER_CHAINS, TRACE_CLUSTER_NEW_CHAINS,
                               TRACE_BASE_TS + TRACE_DAY_MS, seed + 1)
    return first, new


def trace_k1_shape(cfg, n_findings: int) -> list:
    """[B, H, L, Dh] of the triage forward over ``n_findings`` findings."""
    from vainplex_openclaw_tpu_torch.ops.similarity import pow2_bucket

    return [pow2_bucket(n_findings), cfg.n_heads, cfg.seq_len,
            cfg.d_model // cfg.n_heads]


def trace_k1_unheld(shapes) -> list:
    """The [B, H, L, Dh] of ``shapes`` that no non-causal ``KERNEL_CASES``
    case (Lq = Lk = L) holds against the plain version."""
    held = {(B, H, Lq, Dh) for _, B, H, Lq, Lk, Dh, causal, _
            in KERNEL_CASES if Lq == Lk and not causal}
    return [list(s) for s in shapes if tuple(s) not in held]


def trace_k3_windows(raws: list) -> list:
    """The pair counts of the windows that take K3, from the raw events:
    per session, each ``tool.call`` with the ``tool.result`` of its tool
    in the next three events; consecutive calls that both failed, of one
    tool, with both commands non-empty ASCII strings (over the
    500-character cap) count as a pair; a session with at least
    ``TRACE_BATCH_MIN`` pairs is one K3 launch."""
    by_session: dict = {}
    for raw in raws:
        by_session.setdefault((raw["session"], raw["agent"]), []).append(raw)
    windows = []
    for events in by_session.values():
        events = sorted(events, key=lambda e: e["ts"])
        attempts = []
        for i, e in enumerate(events):
            if e["type"] != "tool.call":
                continue
            tool = e["payload"].get("tool_name")
            result = next((r for r in events[i + 1:i + 4]
                           if r["type"] == "tool.result"
                           and r["payload"].get("tool_name") == tool), None)
            command = (e["payload"].get("params") or {}).get("command")
            attempts.append((tool, bool(result and result["payload"].get(
                "error")), command if isinstance(command, str) else ""))
        pairs = sum(
            1 for (ta, ea, ca), (tb, eb, cb) in zip(attempts, attempts[1:])
            if ea and eb and ta == tb and ca and cb
            and ca[:500].isascii() and cb[:500].isascii())
        if pairs >= TRACE_BATCH_MIN:
            windows.append(pairs)
    return windows


class RecordingLogger:
    """The logger an analyzer writes to: ``(level, message)`` records."""

    def __init__(self):
        self.records: list = []

    def info(self, msg):
        self.records.append(("info", msg))

    def warn(self, msg):
        self.records.append(("warn", msg))

    def error(self, msg):
        self.records.append(("error", msg))

    def messages(self, level: str) -> list:
        return [m for lv, m in self.records if lv == level]


class RecordingApi:
    """The part of a gateway's plugin API ``register_trace_analyzer`` uses."""

    def __init__(self):
        self.logger = RecordingLogger()
        self.commands: dict = {}
        self.services: dict = {}

    def register_command(self, cmd) -> None:
        self.commands[cmd.name] = cmd

    def register_service(self, svc) -> None:
        self.services[svc.id] = svc


def trace_files(state_dir: str) -> dict:
    """The report (parsed, less its timing fields), the cluster state and
    the processing state (bytes) an analyzer run left in ``state_dir``."""
    from vainplex_openclaw_tpu_torch.cortex.trace_analyzer import (
        clusters, report)

    def read(name: str) -> bytes:
        with open(os.path.join(state_dir, name), "rb") as f:
            return f.read()

    rep = json.loads(read(report.REPORT_FILE))
    for key in TRACE_TIMING_KEYS:
        rep["runStats"].pop(key, None)
    return {"report": rep, "clusters": read(clusters.CLUSTER_STATE_FILE),
            "state": read(report.STATE_FILE)}


def trace_run(raws: list, state_dir: str, device: str,
              config: dict = TRACE_CONFIG, log=None) -> dict:
    """One ``TraceAnalyzer(config).run()`` over ``raws`` on ``device`` with
    K1 and K3 counted from 0, its wall time, its report, its log (``log``,
    a ``RecordingLogger``, or a new one), the files it left, and the
    clusterer's new x kept blocks: ``[new rows, kept rows]`` of each
    Jaccard call given two row sets."""
    import torch

    from vainplex_openclaw_tpu_torch.cortex.trace_analyzer import (
        MemoryTraceSource, TraceAnalyzer, clusters)
    from vainplex_openclaw_tpu_torch.ops import flash_attention as fa
    from vainplex_openclaw_tpu_torch.ops import similarity as sim

    log = RecordingLogger() if log is None else log
    analyzer = TraceAnalyzer(config, state_dir, log,
                             source=MemoryTraceSource(raws),
                             clock=lambda: TRACE_CLOCK, device=device)
    blocks: list = []
    jaccard = clusters.jaccard_from_rows

    def recorded(Xa, Xb=None, device=None):
        if Xb is not None:
            blocks.append([len(Xa), len(Xb)])
        return jaccard(Xa, Xb, device=device)

    if device == "cuda":
        torch.cuda.synchronize()
    fa.launches = sim.launches = 0
    clusters.jaccard_from_rows = recorded
    try:
        t = time.perf_counter()
        rep = analyzer.run()
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t
    finally:
        clusters.jaccard_from_rows = jaccard
    return {"report": rep, "k1": fa.launches, "k3": sim.launches,
            "wall_s": wall, "log": log, "files": trace_files(state_dir),
            "blocks": blocks}


def trace_profile(raws: list, state_dir: str, device: str) -> dict:
    """One more ``trace_run`` over ``raws``, into its own state dir, with
    the host's parts of the stages timed on the host's clock (the triage
    tokenizer, K3's tokenizer, the report's assembly and its write) and
    each K1 and K3 call between CUDA events on the card (on the host's
    clock on the CPU): where a run's time goes. Not a timed run: the
    wrappers add their own cost. ``report`` is the report less its timing
    fields."""
    import importlib

    import torch

    from vainplex_openclaw_tpu_torch.models import encoder
    from vainplex_openclaw_tpu_torch.ops import similarity as sim

    pkg = "vainplex_openclaw_tpu_torch.cortex.trace_analyzer"
    analyzer = importlib.import_module(f"{pkg}.analyzer")
    classifier = importlib.import_module(f"{pkg}.classifier")
    host = {"triage_tokenize": (classifier, "encode_texts"),
            "k3_tokenize": (sim, "tokenize_fixed"),
            "report_assemble": (analyzer, "assemble_report"),
            "report_save": (analyzer, "save_report")}
    kernels = {"k1": (encoder, "flash_attention"),
               "k3": (sim, "levenshtein_rows")}
    ms = dict.fromkeys(list(host) + list(kernels), 0.0)
    pending: list = []

    def on_host(key, fn):
        def timed(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                ms[key] += (time.perf_counter() - t) * 1e3
        return timed

    def on_device(key, fn):
        if device != "cuda":
            return on_host(key, fn)

        def timed(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            pending.append((key, start, end))
            return out
        return timed

    saved = [(mod, name, getattr(mod, name))
             for mod, name in list(host.values()) + list(kernels.values())]
    try:
        for key, (mod, name) in host.items():
            setattr(mod, name, on_host(key, getattr(mod, name)))
        for key, (mod, name) in kernels.items():
            setattr(mod, name, on_device(key, getattr(mod, name)))
        run = trace_run(raws, state_dir, device)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    for key, start, end in pending:  # trace_run synchronized the card
        ms[key] += start.elapsed_time(end)
    return {"wall_s": run["wall_s"], "report": run["files"]["report"],
            "duration_ms": run["report"]["runStats"]["durationMs"],
            "stage_ms": run["report"]["runStats"]["stageMs"],
            "ms": ms, "launches": {"k1": run["k1"], "k3": run["k3"]}}


def trace_summary(run: dict) -> dict:
    rep = run["report"]
    rs = rep["runStats"]
    return {"events": rs["events"], "chains": rs["chains"],
            "signals": rs["signals"], "findings": len(rep["findings"]),
            "kept": sum(f["kept"] for f in rep["findings"]),
            "outputs": len(rep["outputs"]),
            "clusters": len(rep["failureClusters"]),
            "clustered_signals": sum(c["size"]
                                     for c in rep["failureClusters"]),
            "clusters_truncated": rep["failureClustersTruncated"],
            "events_per_min": rs["eventsPerMinute"],
            "duration_ms": rs["durationMs"], "stage_ms": rs["stageMs"],
            "wall_s": run["wall_s"], "k1_launches": run["k1"],
            "k3_launches": run["k3"]}


def trace_k3_timing(raws: list) -> dict:
    """K3 at the analyzer's shape: the first doom window's pairs as the
    detector hands them to ``batch_levenshtein_ratio`` (bucketed to a
    power of two, ``TRACE_K3_LEN`` tokens), beside its plain version and
    the bound, the kernel held against the plain version."""
    import numpy as np
    import torch

    from vainplex_openclaw_tpu_torch.ops import similarity as sim

    session = next(r["session"] for r in raws
                   if r["session"].startswith("doom"))
    commands = [r["payload"]["params"]["command"] for r in raws
                if r["session"] == session and r["type"] == "tool.call"]
    pairs = list(zip(commands, commands[1:]))
    pairs += [("", "")] * (sim.pow2_bucket(len(pairs)) - len(pairs))
    A = sim.tokenize_fixed([a for a, _ in pairs], TRACE_K3_LEN)
    B = sim.tokenize_fixed([b for _, b in pairs], TRACE_K3_LEN)
    la = (A > 0).sum(axis=1).astype(np.int32)
    lb = (B > 0).sum(axis=1).astype(np.int32)
    Ad, Bd, lad, lbd = (torch.from_numpy(x).cuda() for x in (A, B, la, lb))
    kernel = sim.levenshtein_rows(Ad, Bd, lad, lbd)
    plain = sim.levenshtein_rows_reference(Ad, Bd, lad, lbd)
    err = int((kernel - plain).abs().max())
    check(err == 0, f"trace_analyzer: K3 at {len(pairs)} x {TRACE_K3_LEN} "
                    f"differs from its plain version by {err}")
    record = {"shape": [len(pairs), TRACE_K3_LEN], "max_abs_err": err,
              "kernel_ms": time_ms(lambda: sim.levenshtein_rows(
                  Ad, Bd, lad, lbd), n=20, reps=5, warmup=3),
              "plain_ms": time_ms(lambda: sim.levenshtein_rows_reference(
                  Ad, Bd, lad, lbd), n=5, reps=5, warmup=2),
              **levenshtein_bound(TRACE_K3_LEN, la, lb)}
    check_bound(record["kernel_ms"], record["bound_ms"],
                f"K3 at {record['shape']}")
    return record


def phase_trace_analyzer(smi: str) -> dict:
    """The port's ``TraceAnalyzer`` at a scheduled run's size on the card:
    a warm-up run, then two timed runs on one state dir (the second over
    10% new chains), each against the same runs on the CPU: reports (less
    their timing fields), cluster-state and processing-state files equal;
    K1 n_layers and K3 one launch per ``trace_k3_windows`` window a run,
    K1 at a bucket the kernels phase holds; no ``clustering failed``;
    clusters non-empty and within the 512-signal cap. Then the cluster
    leg, whose second run's signals join the kept window (a new x kept
    block, card against CPU); a profiled copy of run 1; ``/trace-analyze``
    through ``register_trace_analyzer``; and K1 and K3 timed at the run's
    shapes."""
    import tempfile

    from vainplex_openclaw_tpu_torch.cortex.trace_analyzer import (
        MemoryTraceSource, TraceAnalyzer, clusters)
    from vainplex_openclaw_tpu_torch.cortex.trace_analyzer.analyzer import (
        register_trace_analyzer)
    from vainplex_openclaw_tpu_torch.models.pretrained import load_pretrained
    from vainplex_openclaw_tpu_torch.ops.similarity import pow2_bucket

    t0 = time.perf_counter()
    cfg, _ = load_pretrained()
    first, new = trace_corpora()
    legs = tuple(zip(TRACE_RUNS, (first, first + new)))
    expected_k3 = dict(zip(TRACE_RUNS, (trace_k3_windows(first),
                                        trace_k3_windows(new))))
    c_first, c_new = trace_cluster_corpora()
    c_legs = tuple(zip(TRACE_RUNS, (c_first, c_first + c_new)))
    with tempfile.TemporaryDirectory() as tmp:
        TraceAnalyzer(TRACE_CONFIG, os.path.join(tmp, "warm"),
                      RecordingLogger(), source=MemoryTraceSource(first),
                      clock=lambda: TRACE_CLOCK, device="cuda").run()
        runs = {dev: {name: trace_run(raws, os.path.join(tmp, dev), dev)
                      for name, raws in legs} for dev in ("cuda", "cpu")}
        c_runs = {dev: {name: trace_run(raws, os.path.join(tmp, f"c_{dev}"),
                                        dev, TRACE_CLUSTER_CONFIG)
                        for name, raws in c_legs} for dev in ("cuda", "cpu")}
        profile = trace_profile(first, os.path.join(tmp, "profile"), "cuda")
        api = RecordingApi()
        analyzer = TraceAnalyzer(TRACE_CONFIG, os.path.join(tmp, "command"),
                                 api.logger, source=MemoryTraceSource(new),
                                 clock=lambda: TRACE_CLOCK, device="cuda")
        register_trace_analyzer(api, analyzer, wall_timers=False)
        text = api.commands["trace-analyze"].handler({})["text"]
    record = {"phase": "trace_analyzer", "nvidia_smi": smi,
              "corpus": {"bench_chains": TRACE_BENCH_CHAINS,
                         "doom_chains": TRACE_DOOM_CHAINS,
                         "doom_retries": TRACE_DOOM_RETRIES,
                         "new_chains": TRACE_NEW_BENCH_CHAINS
                         + TRACE_NEW_DOOM_CHAINS,
                         "events": len(first), "new_events": len(new)}}
    for name, _ in legs:
        card, host = runs["cuda"][name], runs["cpu"][name]
        trace_equal(card, host, name)
        windows = expected_k3[name]
        check(card["k3"] == len(windows),
              f"trace_analyzer: {name}: K3 launches {card['k3']} != "
              f"{len(windows)} windows of >= {TRACE_BATCH_MIN} pairs")
        n_findings = len(card["report"]["findings"])
        check(card["k1"] == cfg.n_layers * (n_findings > 0),
              f"trace_analyzer: {name}: K1 launches {card['k1']} != "
              f"{cfg.n_layers} layers x 1 triage forward")
        summary = trace_summary(card)
        check(0 < summary["clusters"] and summary["clustered_signals"]
              <= clusters.MAX_CLUSTER_SIGNALS,
              f"trace_analyzer: {name}: {summary['clusters']} clusters of "
              f"{summary['clustered_signals']} signals")
        record[name] = {
            "card": summary, "cpu": trace_summary(host),
            "k3_windows": windows,
            "k3_buckets": sorted({pow2_bucket(n) for n in windows}),
            "k1_shape": trace_k1_shape(cfg, n_findings),
            "cluster_blocks": card["blocks"],
            "equal_card_cpu": ["report", "clusters", "state"]}
    unheld = trace_k1_unheld([record[name]["k1_shape"] for name in TRACE_RUNS])
    check(not unheld, f"trace_analyzer: K1 launched at {unheld}, which no "
                      "kernels case holds against the plain version")
    record["cluster_leg"] = trace_cluster_leg(c_runs, len(c_new))
    check(profile["launches"] == {"k1": runs["cuda"]["run1"]["k1"],
                                  "k3": runs["cuda"]["run1"]["k3"]},
          f"trace_analyzer: the profiled run launched {profile['launches']}")
    check(profile.pop("report") == runs["cuda"]["run1"]["files"]["report"],
          "trace_analyzer: the profiled run's report differs from run 1's")
    record["profile_run1"] = profile
    rs2 = runs["cuda"]["run2"]["report"]["runStats"]
    head = text.splitlines()[0]
    check(head.startswith("🔍 trace analysis:") and "failed" not in head
          and f"{len(new)} events" in head
          and f"{rs2['signals']} signals" in head,
          f"trace_analyzer: /trace-analyze answered {text[:200]!r}")
    record["command_text"] = head
    B, H, L, Dh = record["run1"]["k1_shape"]
    # the plain version at a bucket of thousands: fewer calls a sample
    record["k1_timing"] = time_k1(B, H, L, Dh, seed=121, n=20, reps=5)
    record["k3_timing"] = trace_k3_timing(first)
    record["seconds"] = time.perf_counter() - t0
    emit(record)
    return record


def trace_equal(card: dict, host: dict, name: str) -> None:
    """A card run's files equal the CPU's, and neither logged a clustering
    or detector failure."""
    for part in ("report", "clusters", "state"):
        check(card["files"][part] == host["files"][part],
              f"trace_analyzer: {name}'s {part} differs card vs CPU")
    for dev, run in (("card", card), ("CPU", host)):
        bad = [m for m in run["log"].messages("error")
               if "clustering failed" in m or "detector" in m]
        check(not bad, f"trace_analyzer: {name} on the {dev}: {bad}")


def trace_cluster_leg(c_runs: dict, n_new_chains: int) -> dict:
    """The cluster leg's checks: card and CPU files equal on both runs; no
    signal truncated; run 1 one block over its whole window, run 2 one
    block of new rows (at most two a new chain) against more kept rows;
    no kernel launched; clusters non-empty."""
    out = {}
    for name in TRACE_RUNS:
        card, host = c_runs["cuda"][name], c_runs["cpu"][name]
        trace_equal(card, host, f"cluster leg {name}")
        summary = trace_summary(card)
        check(summary["clusters_truncated"] == 0 and summary["clusters"] > 0,
              f"trace_analyzer: cluster leg {name}: "
              f"{summary['clusters']} clusters, "
              f"{summary['clusters_truncated']} signals truncated")
        check(card["blocks"] == host["blocks"] and len(card["blocks"]) == 1,
              f"trace_analyzer: cluster leg {name}: blocks {card['blocks']} "
              f"on the card, {host['blocks']} on the CPU")
        check(card["k1"] == card["k3"] == 0,
              f"trace_analyzer: cluster leg {name} launched K1 {card['k1']}, "
              f"K3 {card['k3']}")
        out[name] = {"card": summary, "cpu": trace_summary(host),
                     "blocks": card["blocks"],
                     "equal_card_cpu": ["report", "clusters", "state"]}
    (r1, k1), = out["run1"]["blocks"]
    (r2, k2), = out["run2"]["blocks"]
    check(r1 == k1 and 0 < r2 <= 2 * n_new_chains and r2 < k2 and k2 > k1,
          f"trace_analyzer: cluster leg blocks {[r1, k1]}, then {[r2, k2]}: "
          "run 2's new signals did not join the kept window")
    return out


# ── worker profile: the cluster worker's gateway on the card ─────────

WORKER_ID = "w0"
WORKER_TENANTS = 8
WORKER_OPS = 320
WORKER_SEED = 29
# the lifecycle's resident cap, below the tenants: workspaces hibernate
# and wake
WORKER_MAX_RESIDENT = 3
WORKER_START = 1_700_050_000.0  # the gateways' virtual clock (s)
WORKER_CHANNEL = "twitter"  # external: stage 3 scores every send
# (kind, cumulative probability): JAX's ``dispatch_op`` kinds
# (``cluster/worker.py:60-77``), then ``message_sending`` (``send``),
# ``before_message_write`` (``write``) and a tool call whose params hold a
# vault placeholder (``tool_vault``)
WORKER_KIND_CDF = (("msg_in", 0.20), ("msg_out", 0.32), ("tool_ok", 0.40),
                   ("tool_denied", 0.45), ("tool_secret", 0.53),
                   ("send", 0.87), ("write", 0.93), ("tool_vault", 1.0))
WORKER_SECRET_SHARE = 0.35  # the sends and writes that carry a secret
WORKER_MESSAGES = (
    "let's talk about the payment gateway hardening",
    "we decided to use the simpler rollout because it ships faster",
    "I'm waiting for the infra team to approve the quota first",
    "the cache migration is done and deployed ✅",
    "I'll draft the migration plan tonight",
    "wir haben beschlossen, die Migration schrittweise zu machen",
    "warten auf das Security-Review, vorher geht nichts",
    "on a décidé de passer par la file de messages",
    "我们决定采用灰度发布方案",
    "решено, делаем поэтапный деплой",
    "back to the database migration plan",
    "careful, the rollout is risky and urgent",
    "let me check the logs before the release",
    "the dashboard shows normal traffic levels this morning",
)
WORKER_SAFE_PATHS = ("docs/readme.md", "src/app.py", "notes/todo.txt")
WORKER_DENIED_PATHS = ("config/.env", "keys/server.pem",
                       "secrets/prod-credentials.json")
_ALNUM = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789"
_SECRET_FORMS = (
    "{text}; use key {secret}",
    "{text}, reach me at {secret}",
    "{text} (pay into {secret})",
    "{text}, token {secret}",
)
# the lines of /cortexstatus that read the host's clock
_STATUS_TIMING = re.compile(r"stage (?:ms|p99 ms):")
_STATUS_WAKE = re.compile(r"wakeP99=\S+ms")


class VirtualClock:
    """The seconds both gateways of a run read: advanced by the op script
    only."""

    def __init__(self, t: float):
        self.t = t

    def __call__(self) -> float:
        return self.t


def worker_secret(rng, kind: str) -> str:
    """A seeded credential (``sk-`` or ``ghp_``), email or IBAN: each a
    match of one builtin redaction pattern."""
    def pick(n: int) -> str:
        return "".join(_ALNUM[int(i)] for i in rng.integers(len(_ALNUM),
                                                            size=n))

    if kind == "api_key":
        return "sk-" + pick(24)
    if kind == "github":
        return "ghp_" + pick(36)
    if kind == "email":
        return f"ops.{pick(6).lower()}{int(rng.integers(100))}@example.org"
    return "DE" + "".join(str(int(d)) for d in rng.integers(10, size=20))


def worker_ops(n: int, seed: int, tenants: int = WORKER_TENANTS) -> dict:
    """The seeded op stream: ``{"ops": [...], "secrets": [...]}``. Each op
    is ``{"kind", "tenant", "dt", "content"}`` (``dt``: seconds the clock
    moves before it). Sends and writes draw from ``gateway_texts`` (every
    16th contradicts a fact) and carry, at ``WORKER_SECRET_SHARE``, a
    fresh secret; each ``tool_secret`` exports a fresh API key; a
    ``tool_vault`` names the ``tool_secret`` op whose placeholder its params
    hold (the first ``tool_vault`` before any ``tool_secret`` becomes
    one). Every secret is distinct."""
    import numpy as np

    rng = np.random.default_rng(seed)
    texts = iter(gateway_texts(n, seed))
    ops, secrets, last_secret_op = [], [], None
    for i in range(n):
        r = rng.random()
        kind = next(k for k, c in WORKER_KIND_CDF if r < c)
        if kind == "tool_vault" and last_secret_op is None:
            kind = "tool_secret"
        op = {"kind": kind, "tenant": int(rng.integers(tenants)),
              "dt": float(rng.choice([0.5, 1.0, 2.0, 5.0]))}
        if kind in ("msg_in", "msg_out"):
            op["content"] = WORKER_MESSAGES[int(rng.integers(
                len(WORKER_MESSAGES)))]
        elif kind == "tool_ok":
            op["content"] = WORKER_SAFE_PATHS[int(rng.integers(3))]
        elif kind == "tool_denied":
            op["content"] = WORKER_DENIED_PATHS[int(rng.integers(3))]
        elif kind == "tool_secret":
            secret = worker_secret(rng, "api_key")
            secrets.append(secret)
            op["content"] = f"export API_KEY={secret}"
            op["secret"] = secret
            last_secret_op = i
        elif kind == "tool_vault":
            op["ref"] = last_secret_op
        else:
            text = next(texts)
            if rng.random() < WORKER_SECRET_SHARE:
                secret = worker_secret(rng, ("api_key", "github", "email",
                                             "iban")[int(rng.integers(4))])
                secrets.append(secret)
                text = _SECRET_FORMS[int(rng.integers(
                    len(_SECRET_FORMS)))].format(text=text, secret=secret)
            op["content"] = text
        ops.append(op)
    check(len(set(secrets)) == len(secrets), "worker secrets repeat")
    return {"ops": ops, "secrets": secrets}


def worker_gateway(root: str, device, clock, trace_raws: list,
                   serve_cfg=None) -> tuple:
    """The cluster worker's gateway (JAX's ``build_worker_gateway``,
    ``cluster/worker.py:80-136``) on the port: ``GovernancePlugin`` with
    redaction, the credential guard and its audit journal at ``root``,
    plus stage 3 local over ``GATEWAY_FACTS`` (fail closed) on ``device``;
    ``CortexPlugin`` with every language pack, journal, lifecycle (at most
    ``WORKER_MAX_RESIDENT`` tenants resident) and its trace analyzer
    (``TRACE_CONFIG``, on ``device``) over ``trace_raws``. Both plugins
    read ``clock``; the analyzer keeps its state in ``root``."""
    from vainplex_openclaw_tpu_torch.core import Gateway
    from vainplex_openclaw_tpu_torch.core.api import list_logger
    from vainplex_openclaw_tpu_torch.cortex import (CortexPlugin,
                                                    MemoryTraceSource)
    from vainplex_openclaw_tpu_torch.governance import GovernancePlugin

    lcfg = {"enabled": True, "local": True, "failMode": "closed"}
    if serve_cfg is not None:
        lcfg["serve"] = serve_cfg
    logger = list_logger()
    gw = Gateway(config={"workspace": root, "agents": [{"id": WORKER_ID}],
                         "cluster": {"workerPrefix": f"{WORKER_ID}:"}},
                 logger=logger, clock=clock)
    gov = GovernancePlugin(workspace=root, clock=clock, device=device)
    gw.load(gov, plugin_config={
        "redaction": {"enabled": True},
        "builtinPolicies": {"credentialGuard": True,
                            "rateLimiter": {"maxPerMinute": 10_000_000}},
        "storage": {"journal": True},
        "validation": {"enabled": True, "facts": GATEWAY_FACTS,
                       "llmValidator": lcfg}}, logger=logger)
    cortex = CortexPlugin(workspace=root, clock=clock, wall_timers=False,
                          trace_source=MemoryTraceSource(trace_raws),
                          device=device)
    gw.load(cortex, plugin_config={
        "languages": "all",
        "traceAnalyzer": {"enabled": True, **TRACE_CONFIG},
        "registerTools": False,
        "storage": {"journal": True,
                    "lifecycle": {"maxResident": WORKER_MAX_RESIDENT}}},
        logger=logger)
    gw.start()
    return gw, gov, cortex


def worker_ctx(root: str, tenant: int) -> dict:
    return {"agent_id": WORKER_ID, "session_key": f"agent:{WORKER_ID}:t{tenant}",
            "workspace": os.path.join(root, "tenants", f"t{tenant}"),
            "channel_id": WORKER_CHANNEL}


def worker_dispatch(gw, op: dict, ctx: dict, placeholders: dict,
                    tool_params: list):
    """One op through the gateway, as JAX's ``dispatch_op`` runs its kinds
    (``msg_in``, ``msg_out``, the ``read`` tool, ``tool_result_persist``
    of ``exec``), plus ``send``, ``write`` and ``tool_vault``. Returns the
    op's result; a ``tool_vault`` call's params, as the tool received them,
    go to ``tool_params``."""
    from vainplex_openclaw_tpu_torch.governance.redaction import (
        PLACEHOLDER_RE)

    kind, content = op["kind"], op.get("content")
    if kind == "msg_in":
        return gw.message_received(content, ctx)
    if kind == "msg_out":
        return gw.message_sent(content, ctx)
    if kind in ("tool_ok", "tool_denied"):
        d, persisted = gw.run_tool("read", {"path": content},
                                   lambda p: f"contents of {p['path']}", ctx)
        return [d.blocked, d.block_reason, persisted]
    if kind == "tool_secret":
        out = gw.tool_result_persist("exec", content, ctx)
        m = PLACEHOLDER_RE.search(out) if isinstance(out, str) else None
        placeholders[op["index"]] = m.group(0) if m else None
        return out
    if kind == "tool_vault":
        placeholder = placeholders[op["ref"]]
        check(placeholder is not None, f"op {op['index']}: the tool result "
                                       "it names carries no placeholder")

        def tool(params):
            tool_params.append(params)
            return "deployed"

        d, persisted = gw.run_tool(
            "exec", {"command": f"deploy --env {placeholder}"}, tool, ctx)
        return [d.blocked, d.block_reason, persisted]
    decide = gw.message_sending if kind == "send" else gw.before_message_write
    d = decide(content, ctx)
    return [d.blocked, d.content, d.block_reason]


def worker_tree(path: str) -> dict:
    """``{relative path: bytes}`` of every file under ``path``; a gzip'd
    cold journal segment by its content (its header holds the wall time
    and the writer's pid)."""
    import gzip

    out = {}
    for dirpath, _, names in os.walk(path):
        for name in names:
            full = os.path.join(dirpath, name)
            with open(full, "rb") as f:
                data = f.read()
            out[os.path.relpath(full, path)] = (
                gzip.decompress(data) if name.endswith(".gz") else data)
    return out


def worker_status_text(text: str, root: str) -> str:
    """/cortexstatus less the host's clock: the stage lines and the wake
    p99 dropped, the root written as ``<root>``."""
    lines = [_STATUS_WAKE.sub("wakeP99=<ms>", line)
             for line in text.replace(root, "<root>").splitlines()
             if not _STATUS_TIMING.search(line)]
    return "\n".join(lines)


def worker_run(device, script: dict, root: str, trace_raws: list,
               serve_cfg=None, count=None) -> dict:
    """Every op of ``script`` through a fresh worker gateway at ``root``,
    then ``session_start`` and ``before_compaction`` for every tenant,
    ``/trace-analyze`` and ``/cortexstatus``; after ``stop()`` the files.
    ``count(reset=...)`` reads K1 and K3 (None: nothing counted)."""
    from vainplex_openclaw_tpu_torch.storage import journal
    from vainplex_openclaw_tpu_torch.utils import ids
    from vainplex_openclaw_tpu_torch.utils.stage_timer import StageTimer

    os.makedirs(root)
    clock = VirtualClock(WORKER_START)
    ids._ID_RNG.seed(WORKER_SEED)
    gw, gov, cortex = worker_gateway(root, device, clock, trace_raws,
                                     serve_cfg)
    batcher = getattr(gov.engine.output_validator.llm_validator.call_llm,
                      "batcher", None)
    if batcher is not None:
        # the collector's first forward sets up its handles: one request
        # straight to the batcher, outside the counted run
        batcher.submit("warm-up request")
    batches0 = batcher.batches if batcher is not None else 0
    # each tenant's ingest StageTimer, kept across hibernation, and the
    # host ms of each hibernation (flush, ship, close)
    ingest = StageTimer()
    hibernate = cortex._hibernate_workspace
    hibernate_ms: list = []

    def keep_timer(ws: str) -> None:
        tr = cortex._trackers.get(ws)
        if tr is not None:
            ingest.absorb(tr.timer.state())
        t = time.perf_counter()
        hibernate(ws)
        hibernate_ms.append((time.perf_counter() - t) * 1e3)

    cortex._hibernate_workspace = keep_timer
    if count is not None:
        count(reset=True)
    results, placeholders, tool_params = [], {}, []
    host_ms: dict = {}
    t_run = time.perf_counter()
    for i, op in enumerate(script["ops"]):
        clock.t += op["dt"]
        ctx = worker_ctx(root, op["tenant"])
        t = time.perf_counter()
        results.append(worker_dispatch(gw, dict(op, index=i), ctx,
                                       placeholders, tool_params))
        host_ms.setdefault(op["kind"], []).append(
            (time.perf_counter() - t) * 1e3)
    run_s = time.perf_counter() - t_run
    hooks = []
    for tenant in range(WORKER_TENANTS):
        clock.t += 1.0
        ctx = worker_ctx(root, tenant)
        hooks.append(gw.session_start(dict(ctx)))
        hooks.append(gw.before_compaction(dict(ctx), messages=[
            {"role": "user", "content": m} for m in WORKER_MESSAGES[:4]]))
    t = time.perf_counter()
    trace_text = gw.command("/trace-analyze")["text"]
    trace_s = time.perf_counter() - t
    launches = count() if count is not None else None
    status = worker_status_text(gw.command("/cortexstatus")["text"], root)
    for tr in cortex._trackers.values():
        ingest.absorb(tr.timer.state())
    batches = (batcher.batches - batches0) if batcher is not None else None
    lifecycle = cortex.lifecycle.stats()
    # wake, and the snapshot shipping and segment tiering of the
    # hibernated workspaces, absorbed into the manager's timer
    lifecycle_timer = cortex.lifecycle.timer.snapshot()
    evaluations = gw.call_method("governance.status")["stats"][
        "totalEvaluations"]
    gw.stop()
    journal.reset_journals()
    return {"results": results, "hooks": hooks, "tool_params": tool_params,
            "trace_text": trace_text, "status": status,
            "lifecycle": lifecycle, "lifecycle_timer": lifecycle_timer,
            "evaluations": evaluations,
            "batches": batches, "launches": launches,
            "files": trace_files(root),
            "tenants": {t: worker_tree(os.path.join(root, "tenants", f"t{t}"))
                        for t in range(WORKER_TENANTS)},
            "tree": worker_tree(root),
            "host_ms": host_ms, "hibernate_ms": hibernate_ms,
            "run_s": run_s, "trace_s": trace_s,
            "ingest": ingest.snapshot()}


def worker_leaks(script: dict, run: dict) -> list:
    """``(secret, where)`` for every seeded secret found in a sent or
    written content, a persisted tool result, or any file under the run's
    root: the audit files and journals, the tenants' cortex files and the
    analyzer's."""
    places = []
    for op, res in zip(script["ops"], run["results"]):
        if op["kind"] in ("send", "write"):
            places.append(("sent content", str(res[1])))
        elif op["kind"] == "tool_secret":
            places.append(("tool result", str(res)))
        elif op["kind"] in ("tool_ok", "tool_vault"):
            places.append(("tool result", str(res[2])))
    for path, data in run["tree"].items():
        places.append((path, data.decode("utf-8", "replace")))
    return [(secret, where) for secret in script["secrets"]
            for where, text in places if secret in text]


def worker_check(script: dict, card: dict, oracle: dict) -> dict:
    """The phase's checks of a card run against the CPU oracle's."""
    leg = "worker_profile"
    from vainplex_openclaw_tpu_torch.governance.redaction import (
        PLACEHOLDER_RE)

    for i, (got, want) in enumerate(zip(card["results"], oracle["results"])):
        check(got == want, f"{leg}: op {i} ({script['ops'][i]['kind']}) "
                           f"gave {str(got)[:200]} on the card, "
                           f"{str(want)[:200]} on the CPU")
    check(len(card["results"]) == len(script["ops"]),
          f"{leg}: {len(card['results'])} results")
    check(card["hooks"] == oracle["hooks"],
          f"{leg}: session_start/before_compaction results differ")
    for tenant, tree in card["tenants"].items():
        check(tree == oracle["tenants"][tenant],
              f"{leg}: tenant {tenant}'s workspace differs card vs CPU: "
              f"{sorted(set(tree) ^ set(oracle['tenants'][tenant]))}")
        for name in ("threads.json", "BOOTSTRAP.md", "narrative.md",
                     "hot-snapshot.md"):
            check(os.path.join("memory", "reboot", name) in tree,
                  f"{leg}: tenant {tenant} has no {name}")
        check(any(path.startswith("journal") for path in tree),
              f"{leg}: tenant {tenant} has no journal")
    for name in ("decisions.json", "commitments.json"):
        check(any(os.path.join("memory", "reboot", name) in tree
                  for tree in card["tenants"].values()),
              f"{leg}: no tenant has a {name}")
    check(card["status"] == oracle["status"],
          f"{leg}: /cortexstatus differs card vs CPU")
    check(card["files"] == oracle["files"],
          f"{leg}: the /trace-analyze files differ card vs CPU")
    head = card["trace_text"].splitlines()[0]
    check(head.startswith("🔍 trace analysis:") and "failed" not in head,
          f"{leg}: /trace-analyze answered {card['trace_text'][:200]!r}")
    leaks = worker_leaks(script, card)
    check(not leaks, f"{leg}: {len(leaks)} seeded secrets leaked, first "
                     f"in {leaks[0][1] if leaks else None}")
    vault_ops = [op for op in script["ops"] if op["kind"] == "tool_vault"]
    check(len(card["tool_params"]) == len(vault_ops) > 0,
          f"{leg}: {len(card['tool_params'])} vault tool calls ran for "
          f"{len(vault_ops)} ops")
    for op, params in zip(vault_ops, card["tool_params"]):
        live = script["ops"][op["ref"]]["secret"]
        check(live in params["command"]
              and not PLACEHOLDER_RE.search(params["command"]),
              f"{leg}: the tool got {params['command'][:80]!r}, not the "
              "live secret")
    for op, res in zip(script["ops"], card["results"]):
        if op["kind"] in ("tool_ok", "tool_denied"):
            denied = op["kind"] == "tool_denied"
            check(res[0] == denied and (not denied
                                        or "Credential Guard" in res[1]),
                  f"{leg}: read {op['content']!r} gave {res[:2]}")
    lc = card["lifecycle"]
    check(lc["evictions"] > 0 and lc["wakes"] > 0,
          f"{leg}: lifecycle {lc['evictions']} hibernations, "
          f"{lc['wakes']} wakes")
    check(card["evaluations"] == oracle["evaluations"],
          f"{leg}: {card['evaluations']} evaluations on the card, "
          f"{oracle['evaluations']} on the CPU")
    back = audit_readback(card["root"])
    recs = back["records"]
    check(back["corrupt_lines"] == 0 and back["torn_tails"] == 0
          and len(recs) == card["evaluations"]
          and len({r["id"] for r in recs}) == len(recs),
          f"{leg}: {len(recs)} audit records ({back['corrupt_lines']} "
          f"corrupt, {back['torn_tails']} torn) for {card['evaluations']} "
          "evaluations")
    sends = [(op, res) for op, res in zip(script["ops"], oracle["results"])
             if op["kind"] == "send"]
    blocked = sum(bool(res[0]) for _, res in sends)
    stage3 = sum(bool(res[0] and res[2] and "local triage encoder" in res[2])
                 for _, res in sends)
    redacted = sum("[REDACTED:" in str(res[1]) for _, res in sends)
    check(0 < blocked < len(sends) and stage3 > 0 and redacted > 0,
          f"{leg}: of {len(sends)} sends {blocked} blocked, {stage3} by "
          f"stage 3, {redacted} redacted")
    return {"sends": len(sends), "blocked": blocked, "stage3_blocked": stage3,
            "redacted": redacted, "secrets": len(script["secrets"]),
            "vault_calls": len(vault_ops), "audit_records": len(recs),
            "lifecycle": {k: v for k, v in lc.items()
                          if k not in ("wakeP50Ms", "wakeP99Ms")}}


def worker_legs(device, script: dict, root: str, trace_raws: list,
                count=None) -> dict:
    """The run on ``device`` (continuous batching) and the CPU oracle (the
    one-shot path), each on its own root, and the checks between them."""
    runs = {}
    for leg, dev, serve_cfg, counter in (
            ("card", device, None, count),
            ("oracle", "cpu", {"continuousBatching": False}, None)):
        path = os.path.join(root, leg)
        runs[leg] = worker_run(dev, script, path, trace_raws, serve_cfg,
                               counter)
        runs[leg]["root"] = path
    return {"runs": runs,
            "checks": worker_check(script, runs["card"], runs["oracle"])}


def phase_worker_profile(smi: str) -> dict:
    """The cluster worker's gateway on the card: the port's ``Gateway``
    with JAX's worker-profile configs (redaction, the credential guard,
    stage 3 local; cortex with every pack, journal, lifecycle and its
    trace analyzer over the 10% new chains of ``trace_corpora``), one
    seeded stream of ``WORKER_OPS`` ops over ``WORKER_TENANTS`` tenants,
    then session_start and before_compaction for each, ``/trace-analyze``
    and ``/cortexstatus``, against the same gateway on the CPU with the
    one-shot path: every result equal, no seeded secret leaked, the vault
    placeholder resolved in the tool's params, tenant trees byte-equal,
    hibernations and wakes, one whole audit record per evaluation, the
    analyzer's files equal; K1 = n_layers x (batches + triage forwards)
    at buckets the kernels phase holds, K3 one launch per window."""
    import tempfile

    import torch

    from vainplex_openclaw_tpu_torch.models import serve
    from vainplex_openclaw_tpu_torch.models.pretrained import load_pretrained
    from vainplex_openclaw_tpu_torch.ops import flash_attention as fa
    from vainplex_openclaw_tpu_torch.ops import similarity as sim
    from vainplex_openclaw_tpu_torch.ops.similarity import pow2_bucket

    t0 = time.perf_counter()
    cfg, _ = load_pretrained()
    _, new = trace_corpora()
    script = worker_ops(WORKER_OPS, WORKER_SEED)
    windows = trace_k3_windows(new)
    buckets: list = []
    forward = fa._forward

    def count(reset: bool = False) -> dict:
        torch.cuda.synchronize()
        if reset:
            fa.launches = sim.launches = 0
        return {"k1": fa.launches, "k3": sim.launches}

    def record_bucket(q, *args, **kwargs):
        if q.is_cuda:
            buckets.append(list(q.shape))
        return forward(q, *args, **kwargs)

    saved_home = os.environ.get("OPENCLAW_HOME")
    with tempfile.TemporaryDirectory() as root:
        os.environ["OPENCLAW_HOME"] = os.path.join(root, "home")
        fa._forward = record_bucket
        try:
            legs = worker_legs(None, script, root, new, count)
        finally:
            fa._forward = forward
            serve.close_batchers()
            if saved_home is None:
                os.environ.pop("OPENCLAW_HOME", None)
            else:
                os.environ["OPENCLAW_HOME"] = saved_home
    card = legs["runs"]["card"]
    report = card["files"]["report"]
    triage = int(len(report["findings"]) > 0)
    k1, k3 = card["launches"]["k1"], card["launches"]["k3"]
    check(k1 == cfg.n_layers * (card["batches"] + triage),
          f"worker_profile: K1 launches {k1} != {cfg.n_layers} layers x "
          f"({card['batches']} batches + {triage} triage forward)")
    check(k3 == len(windows), f"worker_profile: K3 launches {k3} != "
                              f"{len(windows)} windows")
    shapes = [list(s) for s in dict.fromkeys(map(tuple, buckets))]
    unheld = trace_k1_unheld(shapes)
    check(not unheld, f"worker_profile: K1 launched at {unheld}, which no "
                      "kernels case holds against the plain version")
    sends = card["host_ms"]["send"]
    ingest_ms = card["host_ms"]["msg_in"] + card["host_ms"]["msg_out"]
    triage_shape = (trace_k1_shape(cfg, len(report["findings"]))
                    if triage else None)
    record = {"phase": "worker_profile", "nvidia_smi": smi,
              "ops": len(script["ops"]), "tenants": WORKER_TENANTS,
              "max_resident": WORKER_MAX_RESIDENT,
              "trace_events": len(new), **legs["checks"],
              "batches": card["batches"], "k1_launches": k1,
              "k3_launches": k3, "k3_windows": windows,
              "k3_buckets": sorted({pow2_bucket(n) for n in windows}),
              "k1_shapes": shapes, "triage_shape": triage_shape,
              "message_sending": latency_summary(sends, sum(sends) / 1e3),
              "ingest_host_ms": {"ops": len(ingest_ms),
                                 **quantiles_ms(ingest_ms)},
              "host_ms_per_op": {kind: sum(v) / len(v)
                                 for kind, v in card["host_ms"].items()},
              "cortex_stage_ms": card["ingest"]["stages_ms"],
              "cortex_stage_quantiles_ms": card["ingest"]["quantiles"],
              "lifecycle_stage_ms": card["lifecycle_timer"]["stages_ms"],
              "lifecycle_stage_counts": card["lifecycle_timer"]["counts"],
              "wake_ms": {"p50": card["lifecycle"]["wakeP50Ms"],
                          "p99": card["lifecycle"]["wakeP99Ms"]},
              "hibernate_ms": {"sum": sum(card["hibernate_ms"]),
                               **quantiles_ms(card["hibernate_ms"])},
              "ops_s": card["run_s"], "trace_analyze_s": card["trace_s"],
              "oracle_ops_s": legs["runs"]["oracle"]["run_s"],
              "seconds": time.perf_counter() - t0}
    emit(record)
    return record


# ── the cluster: supervisor, ring, workers and the fleet under them ──

CLUSTER_SEED = 31
CLUSTER_OPS = 360
CLUSTER_TENANTS = 8
CLUSTER_BASE_T = 1_753_772_400.0  # the storm's settable clock (s)
CLUSTER_ROUTE_FAULT_STEP = 37
# the worker's ack boundary is the journals' only commit trigger, so a
# crash loses exactly the un-acked ops and redelivery replays exactly them
CLUSTER_JOURNAL = {"maxBatchRecords": 1_000_000, "windowMs": 0.0}
CLUSTER_FLEET = {"replicas": 3, "maxBatch": 8, "windowMs": 0.0,
                 "ackEvery": 4}
CLUSTER_PUMP_EVERY = 6
CLUSTER_PROCESS_OPS = 240
CLUSTER_PROCESS_KILL_AFTER = 120
CLUSTER_SERVE_REQUESTS = 32
CLUSTER_SERVE_THREADS = 8
CLUSTER_TRACKER_FILES = ("threads.json", "decisions.json",
                         "commitments.json")


def cluster_ops(n: int, seed: int, root: str) -> list:
    """``generate_workload``'s gateway mix as the cluster's ops: each op
    routed by its tenant's workspace, its ids seeded per op."""
    from vainplex_openclaw_tpu_torch.slo.workload import generate_workload

    return [{"i": op.index, "at": CLUSTER_BASE_T + op.arrival,
             "ws": os.path.join(root, "tenants", f"tenant{op.tenant}"),
             "wsKey": f"tenant{op.tenant}", "kind": op.kind,
             "content": op.content, "ids": f"{seed}:{op.index}"}
            for op in generate_workload(seed, n, CLUSTER_TENANTS)]


def cluster_verdicts(ops: list, results: dict, leg: str) -> dict:
    """Every op has a final observation; each denial blocks, each secret
    comes back redacted, nothing else blocks (the JAX storms' accounting)."""
    missing = [op["i"] for op in ops if results.get(op["i"]) is None]
    check(not missing, f"cluster {leg}: ops {missing[:8]} have no result")
    kinds = {op["i"]: op["kind"] for op in ops}
    count = {"denials": 0, "redactions": 0, "false_blocks": 0}
    for i, kind in kinds.items():
        obs = results[i]
        count["denials"] += kind == "tool_denied" and bool(obs.get("blocked"))
        count["redactions"] += (kind == "tool_secret"
                                and bool(obs.get("redacted")))
        count["false_blocks"] += kind == "tool_ok" and bool(obs.get("blocked"))
    want = {"denials": sum(k == "tool_denied" for k in kinds.values()),
            "redactions": sum(k == "tool_secret" for k in kinds.values()),
            "false_blocks": 0}
    check(count == want, f"cluster {leg}: verdicts {count} != {want}")
    return count


def cluster_tenant_files(root: str) -> dict:
    """Root-normalized bytes of every tenant's tracker files."""
    out = {}
    for t in range(CLUSTER_TENANTS):
        for name in CLUSTER_TRACKER_FILES:
            path = os.path.join(root, "tenants", f"tenant{t}", "memory",
                                "reboot", name)
            if os.path.exists(path):
                with open(path, "rb") as f:
                    out[f"tenant{t}/{name}"] = f.read().replace(
                        root.encode(), b"ROOT")
    return out


def flush_cluster(sup) -> None:
    """Deliver and commit everything, then make each live worker's tenant
    files current (a tracker flush compacts its streams)."""
    sup.drain()
    for state in sup.workers().values():
        if state.alive:
            for trackers in list(state.handle.cortex._trackers.values()):
                trackers.flush()


def fleet_replica_book(fleet, book: dict) -> None:
    """Every replica batcher the fleet has built so far, by identity: the
    dead and the retired leave the fleet's table but keep their counts."""
    with fleet._lock:
        for rep in fleet._replicas.values():
            book.setdefault(id(rep.batcher), rep.batcher)


def cluster_fleet_audit(fleet, ops: list, delivered: dict, counts: dict,
                        oracle: dict, leg: str) -> dict:
    """Dropped, served twice and verdicts off the one-shot oracle; the
    fleet's routed = served + redelivered."""
    from types import SimpleNamespace

    stats = fleet.stats()
    audit = fleet_audit([SimpleNamespace(index=op["i"], content=op["content"])
                         for op in ops], delivered, counts, {"v0": oracle})
    check(audit == {"dropped": 0, "served_twice": 0,
                    "verdict_mismatches": 0}, f"cluster {leg}: {audit}")
    check(stats["shed"] == 0 and stats["served"] == len(ops)
          and stats["routed"] == stats["served"] + stats["redelivered"],
          f"cluster {leg}: fleet routed {stats['routed']}, served "
          f"{stats['served']}, redelivered {stats['redelivered']}, shed "
          f"{stats['shed']} of {len(ops)}")
    return {**audit, "routed": stats["routed"], "served": stats["served"],
            "redelivered": stats["redelivered"],
            "fleet_failovers": [{k: f[k] for k in (
                "worker", "replicasLost", "respawned", "redelivered")}
                for f in stats["failovers"]]}


def warm_replicas(book: dict, device) -> dict:
    """One request on each replica batcher outside the counted run (its
    collector's first batch), and each batcher's batches after it."""
    if str(device) != "cpu":
        for batcher in book.values():
            batcher.submit("warm-up request")
    return {key: b.batches for key, b in book.items()}


def cluster_storm(device, root: str, n: int, seed: int, oracle: dict,
                  chaos: bool, count=None) -> dict:
    """JAX's fleet storm shape on the port: a ``ClusterSupervisor`` over 3
    in-process workers with ``fleetServing`` armed (the port's default
    batcher factory on ``device``), a settable clock and JAX's fault plan
    (``cluster.route`` at one step, ``journal.fsync`` 5%,
    ``journal.append`` 2% torn). Each op also goes to the fleet as a
    stage-3 request. With ``chaos``: the worker hosting the fullest
    replica is failed over, the fullest replica is retired under load,
    and one survivor is retired with ``retire_worker`` before the final
    drain."""
    import random

    from vainplex_openclaw_tpu_torch.analysis.witness import ProtocolWitness
    from vainplex_openclaw_tpu_torch.cluster import ClusterSupervisor
    from vainplex_openclaw_tpu_torch.core.api import list_logger
    from vainplex_openclaw_tpu_torch.resilience.faults import (FaultPlan,
                                                               FaultSpec,
                                                               installed)
    from vainplex_openclaw_tpu_torch.storage.journal import reset_journals

    leg = "storm" if chaos else f"storm ({device}, no chaos)"
    reset_journals()
    clock = VirtualClock(CLUSTER_BASE_T)
    ws_results: dict = {}
    delivered: dict = {}
    counts: dict = {}
    sup = ClusterSupervisor(
        root, {"workers": 3, "ackEveryOps": 6, "deterministicIds": True,
               "heartbeatMissLimit": 2, "fleetServing": True,
               "fleet": dict(CLUSTER_FLEET)},
        clock=clock, wall_timers=False, settable_clock=clock,
        journal_cfg=CLUSTER_JOURNAL, logger=list_logger(),
        on_result=lambda op, obs: ws_results.__setitem__(op["i"], obs))
    try:
        fleet = sup.enable_fleet(on_result=fleet_collect(delivered, counts),
                                 device=device)
        book: dict = {}
        fleet_replica_book(fleet, book)
        batches0 = warm_replicas(book, device)
        witness = ProtocolWitness()
        witness.arm_supervisor(sup)
        ops = cluster_ops(n, seed, root)
        rng = random.Random(f"clusterstorm:{seed}")
        kill_step = rng.randrange(n // 4, n // 2) if chaos else None
        retire_step = rng.randrange(n // 2, 3 * n // 4) if chaos else None
        chaos_log: list = []
        plan = FaultPlan([
            FaultSpec("cluster.route", steps=(CLUSTER_ROUTE_FAULT_STEP,)),
            FaultSpec("journal.fsync", rate=0.05),
            FaultSpec("journal.append", rate=0.02, mode="torn")], seed=seed)
        launches0 = count(reset=True) if count is not None else None
        t0 = time.perf_counter()
        with installed(plan):
            for step, op in enumerate(ops):
                sup.submit(op)
                sup.tick()
                fleet.submit({"i": step, "text": op["content"],
                              "tenant": op["wsKey"], "at": clock.t})
                if step == kill_step:
                    occ = fleet.occupancy()
                    rid = max(sorted(occ), key=lambda r: occ[r]["pending"])
                    worker = occ[rid]["workerId"]
                    chaos_log.append({"chaos": "kill", "step": step,
                                      "rid": rid, "worker": worker,
                                      "pending": occ[rid]["pending"]})
                    sup.failover(worker, reason="chaos kill")
                    fleet_replica_book(fleet, book)
                if step == retire_step:
                    occ = fleet.occupancy()
                    live = [r for r in sorted(occ) if occ[r]["alive"]]
                    rid = max(live, key=lambda r: (occ[r]["pending"], r))
                    chaos_log.append({"chaos": "retire_replica",
                                      "step": step, "rid": rid,
                                      "pending": occ[rid]["pending"]})
                    fleet.retire_replica(rid, reason="chaos scale-down")
                if step % CLUSTER_PUMP_EVERY == CLUSTER_PUMP_EVERY - 1:
                    fleet.pump()
        # the planned retirement runs after the fault plan: a write fault
        # at its barrier would abort a handoff, and the worker would stay
        if chaos:
            survivor = sup.stats()["membership"]["live"][0]
            chaos_log.append({"chaos": "retire_worker", "worker": survivor,
                              **sup.retire_worker(survivor)})
            fleet_replica_book(fleet, book)
        fleet_await(fleet, delivered, n)
        flush_cluster(sup)
        wall = time.perf_counter() - t0
        launches = count() if count is not None else None
        audit = cluster_fleet_audit(fleet, ops, delivered, counts, oracle,
                                    leg)
        verdicts = cluster_verdicts(ops, ws_results, leg)
        stats = sup.stats()
        check(stats["fencedRecords"] == 0,
              f"cluster {leg}: {stats['fencedRecords']} fenced records")
        violations = witness.violations()
        check(not violations, f"cluster {leg}: protocol {violations[:3]}")
        if chaos:
            check(len(stats["failovers"]) == 1 and stats["membership"][
                "dead"] == [chaos_log[0]["worker"]]
                and stats["membership"]["retired"] == [survivor]
                and chaos_log[-1]["retired"],
                f"cluster {leg}: membership {stats['membership']}, "
                f"failovers {len(stats['failovers'])}, {chaos_log}")
        timer = sup.timer.snapshot()
        fired = dict(plan.fired)
    finally:
        sup.stop()
        reset_journals()
    batches = sum(b.batches - batches0.get(key, 0)
                  for key, b in book.items())
    return {"leg": leg, "device": str(device), "ops": n, "wall_s": wall,
            "ops_per_s": n / wall, "chaos": chaos_log, "fired": fired,
            **verdicts, **audit, "batches": batches,
            "replicas_built": len(book),
            "launches": (None if launches is None else
                         {k: launches[k] - launches0[k] for k in launches}),
            "route_ms": timer["stages_ms"].get("route"),
            "recover_ms": timer["stages_ms"].get("recover"),
            "rebalance_ms": timer["stages_ms"].get("rebalance"),
            "handoff_ms": timer["stages_ms"].get("handoff"),
            "stage_counts": timer["counts"],
            "failovers": [{k: f[k] for k in (
                "worker", "workspacesMoved", "replayedRecords",
                "redelivered", "durationMs")} for f in stats["failovers"]],
            "handoffs": [{k: h[k] for k in (
                "ws", "from", "to", "replayedRecords", "redelivered",
                "durationMs")} for h in stats["handoffs"]],
            "route_faults": stats["routeFaults"],
            "redelivered_ops": stats["redelivered"],
            "leases": {os.path.basename(ws): lease["epoch"]
                       for ws, lease in stats["leases"].items()},
            "tenant_files": cluster_tenant_files(root)}


def cluster_process(device, root: str, n: int, kill_after: int, seed: int,
                    oracle: dict, count=None) -> dict:
    """``worker_mode="process"``: 3 workers in their own processes (none
    touches the card), the fleet's replicas in this one on ``device``, on
    the real clock; a real SIGKILL of one worker after ``kill_after`` ops,
    then ``drain``. Every op answers (a redelivered op may answer twice,
    with the same answer), the fleet's verdicts equal the oracle, the
    children's stage timers merge, and ``stop`` leaves no child."""
    import multiprocessing as mp

    from vainplex_openclaw_tpu_torch.cluster import ClusterSupervisor
    from vainplex_openclaw_tpu_torch.core.api import list_logger

    answers: dict = {}
    delivered: dict = {}
    counts: dict = {}
    t_start = time.perf_counter()
    sup = ClusterSupervisor(
        root, {"workers": 3, "ackEveryOps": 4, "heartbeatDeadlineS": 5.0,
               "fleetServing": True, "fleet": dict(CLUSTER_FLEET)},
        worker_mode="process", journal_cfg={"fsync": "os"},
        logger=list_logger(),
        on_result=lambda op, obs: answers.setdefault(op["i"], []).append(
            obs))
    procs = [s.handle.proc for s in sup.workers().values()]
    try:
        fleet = sup.enable_fleet(on_result=fleet_collect(delivered, counts),
                                 device=device)
        book: dict = {}
        fleet_replica_book(fleet, book)
        batches0 = warm_replicas(book, device)
        ops = cluster_ops(n, seed, root)
        launches0 = count(reset=True) if count is not None else None
        start_s = time.perf_counter() - t_start
        t0 = time.perf_counter()
        victim, kill_ms = None, None
        for step, op in enumerate(ops):
            if step == kill_after:
                victim = sup.stats()["membership"]["live"][0]
                t_kill = time.perf_counter()
                sup.workers()[victim].handle.kill()
                sup.tick()
                kill_ms = (time.perf_counter() - t_kill) * 1e3
                fleet_replica_book(fleet, book)
            sup.submit(op)
            sup.tick()
            fleet.submit({"i": step, "text": op["content"],
                          "tenant": op["wsKey"]})
            if step % CLUSTER_PUMP_EVERY == CLUSTER_PUMP_EVERY - 1:
                fleet.pump()
        sup.drain(timeout_s=60.0)
        fleet_await(fleet, delivered, n)
        wall = time.perf_counter() - t0
        launches = count() if count is not None else None
        stats = sup.stats()
        check(len(stats["failovers"]) == 1
              and stats["membership"]["dead"] == [victim],
              f"cluster process: failovers {len(stats['failovers'])}, "
              f"membership {stats['membership']}")
        split = [i for i, obs in answers.items()
                 if any(o != obs[0] for o in obs)]
        check(not split, f"cluster process: ops {split[:8]} answered "
                         "differently twice")
        verdicts = cluster_verdicts(ops, {i: obs[-1] for i, obs in
                                          answers.items()}, "process")
        audit = cluster_fleet_audit(fleet, ops, delivered, counts, oracle,
                                    "process")
        failover = stats["failovers"][0]
    finally:
        sup.stop()
    edges = sup.stage_snapshots()
    check("cluster" in edges and len(edges) > 1,
          f"cluster process: stage_snapshots merged only {sorted(edges)}")
    left = [p.name for p in procs if p.is_alive()] + [
        p.name for p in mp.active_children() if p.name.startswith("cluster-")]
    check(not left, f"cluster process: children left after stop: {left}")
    batches = sum(b.batches - batches0.get(key, 0)
                  for key, b in book.items())
    return {"leg": "process", "device": str(device), "ops": n,
            "start_s": start_s, "wall_s": wall, "ops_per_s": n / wall,
            "victim": victim, "kill_ms": kill_ms,
            "failover_ms": failover["durationMs"],
            "failover": {k: failover[k] for k in (
                "workspacesMoved", "replayedRecords", "redelivered")},
            "answered_twice": sum(1 for obs in answers.values()
                                  if len(obs) > 1),
            **verdicts, **audit, "batches": batches,
            "merged_edges": len(edges),
            "merged_edge_kinds": sorted({e.split(":")[0] for e in edges}),
            "launches": (None if launches is None else
                         {k: launches[k] - launches0[k] for k in launches})}


def cluster_worker_serve(device, root: str, n: int, oracle: dict,
                         count=None) -> dict:
    """Two ``InProcessWorker``s, each with ``serve_cfg`` (the shipped
    checkpoint, ``SERVE_DEFAULTS``) on ``device``: ``n`` requests through
    each worker's ``gw.serve_batcher`` from several threads equal the
    oracle; ``stop()`` of one drains and closes exactly its scope (the
    requests it held are answered), and the other still serves."""
    from concurrent.futures import ThreadPoolExecutor

    from vainplex_openclaw_tpu_torch.cluster import InProcessWorker
    from vainplex_openclaw_tpu_torch.models import serve

    texts = [f"worker {w} request {i}: {t}" for w in ("a", "b")
             for i, t in enumerate(seeded_texts(n, CLUSTER_SEED))]
    oracle.update(one_shot_oracle(set(texts) - set(oracle), device=device))
    workers = [InProcessWorker(wid, os.path.join(root, wid),
                               journal_cfg=CLUSTER_JOURNAL, serve_cfg={},
                               device=device)
               for wid in ("wa", "wb")]
    a, b = workers
    try:
        batchers = [w.gw.serve_batcher for w in workers]
        for batcher in batchers if str(device) != "cpu" else ():
            batcher.submit("warm-up request")
        batches0 = [bt.batches for bt in batchers]
        launches0 = count(reset=True) if count is not None else None
        t0 = time.perf_counter()
        with ThreadPoolExecutor(CLUSTER_SERVE_THREADS) as pool:
            got = [list(pool.map(bt.submit, texts[k * n:(k + 1) * n]))
                   for k, bt in enumerate(batchers)]
        wall = time.perf_counter() - t0
        wrong = sum(1 for k in range(2) for t, v in zip(
            texts[k * n:(k + 1) * n], got[k]) if v != oracle[t])
        check(wrong == 0, f"cluster worker_serve: {wrong} verdicts off the "
                          "oracle")
        held = [batchers[0].enqueue(t) for t in texts[:4]]
        a.stop()
        with serve._batchers_lock:
            scopes = sorted({key[0] for key in serve._batchers})
        check(batchers[0]._closed and not batchers[1]._closed
              and a.serve_scope not in scopes and b.serve_scope in scopes,
              f"cluster worker_serve: after wa.stop() scopes {scopes}, "
              f"closed {[bt._closed for bt in batchers]}")
        check(all(tk.done.is_set() and tk.result == oracle[t]
                  for tk, t in zip(held, texts[:4])),
              "cluster worker_serve: wa.stop() did not drain its queue")
        after = batchers[1].submit(texts[n])
        check(after == oracle[texts[n]],
              "cluster worker_serve: wb stopped serving with wa")
        launches = count() if count is not None else None
    finally:
        for w in workers:
            w.stop()
    batches = sum(bt.batches - b0 for bt, b0 in zip(batchers, batches0))
    return {"leg": "worker_serve", "device": str(device),
            "requests": 2 * n + len(held) + 1, "wall_s": wall,
            "requests_per_s": 2 * n / wall, "batches": batches,
            "scopes": [w.serve_scope.replace(root, "<root>")
                       for w in workers],
            "launches": (None if launches is None else
                         {k: launches[k] - launches0[k] for k in launches})}


def cluster_threads(before: set, wait_s: float = 5.0) -> list:
    """Names of the threads started since ``before`` still alive after up
    to ``wait_s``."""
    deadline = time.perf_counter() + wait_s
    while True:
        left = [t for t in threading.enumerate()
                if t.ident not in before and t.is_alive()]
        if not left or time.perf_counter() > deadline:
            return [t.name for t in left]
        time.sleep(0.05)


def cluster_legs(device, root: str, n_storm: int = CLUSTER_OPS,
                 n_process: int = CLUSTER_PROCESS_OPS,
                 kill_after: int = CLUSTER_PROCESS_KILL_AFTER,
                 n_serve: int = CLUSTER_SERVE_REQUESTS,
                 count=None) -> dict:
    """The cluster phase's three legs on ``device``, and the storm once
    more on the CPU with no kill and no retire, whose tenant files the
    chaos storm's must equal; at the end no thread the legs started is
    left."""
    before = {t.ident for t in threading.enumerate()}
    storm_ops = cluster_ops(n_storm, CLUSTER_SEED, root)
    process_ops = cluster_ops(n_process, CLUSTER_SEED + 1, root)
    t = time.perf_counter()
    oracle = one_shot_oracle({op["content"] for op in storm_ops + process_ops},
                             device=device)
    oracle_s = time.perf_counter() - t
    storm = cluster_storm(device, os.path.join(root, "storm"), n_storm,
                          CLUSTER_SEED, oracle, chaos=True, count=count)
    host = cluster_storm("cpu", os.path.join(root, "host"), n_storm,
                         CLUSTER_SEED, oracle, chaos=False)
    files, host_files = storm["tenant_files"], host["tenant_files"]
    differ = sorted(k for k in set(files) | set(host_files)
                    if files.get(k) != host_files.get(k))
    check(files and not differ, f"cluster storm: tenant files {differ} "
          "differ from the CPU storm's with no kill and no retire")
    process = cluster_process(device, os.path.join(root, "process"),
                              n_process, kill_after, CLUSTER_SEED + 1,
                              oracle, count)
    worker_serve = cluster_worker_serve(device, os.path.join(root, "serve"),
                                        n_serve, oracle, count)
    left = cluster_threads(before)
    check(not left, f"cluster: threads left after the phase: {left}")
    return {"storm": storm, "host_storm": host, "process": process,
            "worker_serve": worker_serve, "oracle_s": oracle_s}


def phase_cluster(smi: str) -> dict:
    """The port's cluster on the card: a ``ClusterSupervisor`` with its
    ring, lease table and workers (each the port's worker profile), and
    ``fleetServing`` arming the port's ``ReplicaFleet`` on cuda:0 under
    the supervisor's failover and retirement. Three legs (``storm``,
    ``process``, ``worker_serve``, see :func:`cluster_legs`); K1 = n_layers
    x the batches of every replica batcher of each leg, at buckets the
    kernels phase holds."""
    import tempfile

    import torch

    from vainplex_openclaw_tpu_torch.models import serve
    from vainplex_openclaw_tpu_torch.models.pretrained import load_pretrained
    from vainplex_openclaw_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    cfg, _ = load_pretrained()
    buckets: list = []
    forward = fa._forward

    def count(reset: bool = False) -> dict:
        torch.cuda.synchronize()
        if reset:
            fa.launches = 0
        return {"k1": fa.launches}

    def record_bucket(q, *args, **kwargs):
        if q.is_cuda:
            buckets.append(list(q.shape))
        return forward(q, *args, **kwargs)

    saved_home = os.environ.get("OPENCLAW_HOME")
    with tempfile.TemporaryDirectory() as root:
        os.environ["OPENCLAW_HOME"] = os.path.join(root, "home")
        fa._forward = record_bucket
        try:
            legs = cluster_legs(None, root, count=count)
        finally:
            fa._forward = forward
            serve.close_batchers()
            if saved_home is None:
                os.environ.pop("OPENCLAW_HOME", None)
            else:
                os.environ["OPENCLAW_HOME"] = saved_home
    k1 = {}
    for name in ("storm", "process", "worker_serve"):
        leg = legs[name]
        k1[name] = leg["launches"]["k1"]
        check(k1[name] == cfg.n_layers * leg["batches"],
              f"cluster {name}: K1 launches {k1[name]} != {cfg.n_layers} "
              f"layers x {leg['batches']} batches")
    shapes = [list(s) for s in dict.fromkeys(map(tuple, buckets))]
    unheld = trace_k1_unheld(shapes)
    check(not unheld, f"cluster: K1 launched at {unheld}, which no kernels "
                      "case holds against the plain version")
    storm, process = legs["storm"], legs["process"]
    host = legs.pop("host_storm")
    storm.pop("tenant_files")
    record = {"phase": "cluster", "nvidia_smi": smi,
              "tenant_files_equal_cpu": len(host.pop("tenant_files")),
              "host_storm_ops_per_s": host["ops_per_s"],
              "host_storm_batches": host["batches"],
              **legs, "k1_launches": sum(k1.values()), "k1_by_leg": k1,
              "k1_shapes": shapes, "seconds": time.perf_counter() - t0}
    emit(record)
    return record


# ── knowledge_slo: the five-plugin gateway, knowledge on the card ────

KNOWLEDGE_SEED = 0          # generate_workload's seed, and the id RNG's
KNOWLEDGE_TENANTS = 4
KNOWLEDGE_FILL_MAX = 20_000  # ops the fill may take before the phase fails
KNOWLEDGE_MORE_OPS = 500
KNOWLEDGE_QUERIES = 32
KNOWLEDGE_THREAD_QUERIES = 16  # during the second sync: half repeats
KNOWLEDGE_QUERY_SEED = 43
# scores card vs CPU: tests/test_torch_triage_embeddings.py's tolerance
# for the bf16 LocalEmbeddings vectors (unit vectors, so it bounds a
# score's difference too)
KNOWLEDGE_SCORE_TOL = 5e-2
KNOWLEDGE_STAGES = ("extract", "sync", "search", "decay")
# bench.py's bench_slo_report settings, and JAX's sim test size
SLO_BENCH = {"n_ops": 2000, "seed": 0, "tenants": 6, "saturation": 1.0,
             "mode": "wall", "admission": True, "watermark": 32}
SLO_LEGS = (("saturation_1", {}), ("saturation_2", {"saturation": 2.0}),
            ("workers_2", {"workers": 2}))
SLO_SIM = {"seed": 11, "n_ops": 260, "tenants": 4, "saturation": 2.0,
           "mode": "sim"}


def knowledge_queries(n: int, seed: int) -> list:
    """Seeded ``/knowledge`` queries: half name an item the workload's
    messages mention ("item 17"), half are the first words of another
    seed's messages."""
    import random

    from vainplex_openclaw_tpu_torch.slo.workload import generate_workload

    rng = random.Random(seed)
    texts = [op.content for op in generate_workload(seed, 4 * n, 4)
             if op.kind in ("msg_in", "msg_out")]
    return [f"item {rng.randrange(6000)}" if i % 2 == 0
            else " ".join(rng.choice(texts).split()[:4]) for i in range(n)]


def knowledge_events(transport) -> list:
    """``[subject, envelope]`` of every event the memory transport holds,
    in publish order (its sequence included). A message without a stable
    id gets a ``uuid4`` event id (in the JAX package too), which is
    replaced by ``"uuid"``."""
    out = []
    for subject, event, _ in list(transport._events):
        env = event.to_dict()
        if not str(env["id"]).startswith("evt-"):
            env["id"] = "uuid"
        out.append([subject, env])
    return out


def recording_search(emb, searches: list):
    """``emb.search`` that appends each query's thread, hits and every live
    fact's score against the query's cached vector (so a hit of another
    run can be scored on this one) to ``searches``."""
    search = emb.search

    def recorded(query, k=5):
        hits = search(query, k=k)
        with emb._lock:
            q = emb._query_cache.get(query)
            scores = ({} if q is None else dict(zip(
                emb._ids[:emb._size],
                (emb._arena[:emb._size] @ q).tolist())))
        searches.append({"thread": threading.current_thread().name,
                         "query": query,
                         "hits": [[h["id"], h["score"]] for h in hits],
                         "scores": scores})
        return hits

    return recorded


def knowledge_run(device, root: str, more_ops: int = KNOWLEDGE_MORE_OPS,
                  n_queries: int = KNOWLEDGE_QUERIES,
                  n_thread: int = KNOWLEDGE_THREAD_QUERIES,
                  count=None) -> dict:
    """One run of the knowledge leg on ``device``: JAX's five-plugin
    gateway (``slo.harness._build_gateway``: virtual clock, wall timers
    off) fed ``generate_workload`` through ``dispatch_op`` until the fact
    store holds ``maxFacts``; a sync; ``n_queries`` ``/knowledge <query>``
    commands; ``more_ops`` more ops (each new fact prunes one); a second
    sync (which removes the pruned facts from the arena) while a thread
    runs ``n_thread`` queries, half of them repeats; a decay tick. The
    count is set to 0 before the first op and read after the thread."""
    import random
    from pathlib import Path

    from vainplex_openclaw_tpu_torch.cluster.worker import dispatch_op
    from vainplex_openclaw_tpu_torch.slo import harness
    from vainplex_openclaw_tpu_torch.slo.workload import generate_workload
    from vainplex_openclaw_tpu_torch.utils import ids

    ids._ID_RNG.seed(KNOWLEDGE_SEED)
    clock = harness._SimClock()
    base_t = clock.t
    ws = Path(root)
    gw, _ = harness._build_gateway(ws, KNOWLEDGE_TENANTS, clock, False, 32,
                                   device=device)
    plugin = gw.plugins["knowledge-engine"].module
    transport = gw.plugins["eventstore"].module.transport
    emb = plugin.embeddings
    cap = plugin.fact_store.config["maxFacts"]
    ctxs = {t: harness._tenant_ctx(ws, t)
            for t in range(KNOWLEDGE_TENANTS)}
    for t in range(KNOWLEDGE_TENANTS):
        gw.session_start(ctxs[t])

    forwards, searches, removed = [], [], []
    embed, remove = emb._embed, emb.remove

    def counted_embed(texts):
        forwards.append(len(texts))
        return embed(texts)

    def counted_remove(dead):
        removed.append(len(dead))
        return remove(dead)

    emb._embed, emb.search, emb.remove = (counted_embed,
                                          recording_search(emb, searches),
                                          counted_remove)
    ops = generate_workload(KNOWLEDGE_SEED, KNOWLEDGE_FILL_MAX + more_ops,
                            KNOWLEDGE_TENANTS)
    at = 0

    def drive(n: int) -> None:
        nonlocal at
        for op in ops[at:at + n]:
            clock.t = base_t + op.arrival
            dispatch_op(gw, op.kind, op.content, ctxs[op.tenant])
        at += n

    if count is not None:
        count(reset=True)
    while plugin.fact_store.count() < cap:
        check(at < KNOWLEDGE_FILL_MAX, f"knowledge: {at} ops left the store "
              f"at {plugin.fact_store.count()} facts of {cap}")
        drive(1)
    fill_ops, at_cap = at, plugin.fact_store.count()
    syncs = []
    t = time.perf_counter()
    syncs.append({"facts": plugin.maintenance.run_embeddings_sync(),
                  "ms": (time.perf_counter() - t) * 1e3})
    queries = knowledge_queries(n_queries, KNOWLEDGE_QUERY_SEED)
    texts, query_ms = [], []
    for q in queries:
        t = time.perf_counter()
        texts.append(gw.command("/knowledge", args=q)["text"])
        query_ms.append((time.perf_counter() - t) * 1e3)
    first_ids = {f.id for f in plugin.fact_store.snapshot()}
    drive(more_ops)
    pruned = len(first_ids - {f.id for f in plugin.fact_store.snapshot()})
    rng = random.Random(KNOWLEDGE_QUERY_SEED + 1)
    thread_queries = [rng.choice(queries) if i % 2 else f"{q} again"
                      for i, q in enumerate(
                          knowledge_queries(n_thread, KNOWLEDGE_QUERY_SEED + 2))]
    errors: list = []

    def ask():
        try:
            for q in thread_queries:
                gw.command("/knowledge", args=q)
        except BaseException as exc:  # noqa: BLE001 — the phase reports it
            errors.append(repr(exc))

    asker = threading.Thread(target=ask, name="knowledge-queries")
    misses_before = emb.query_cache_misses
    asker.start()
    t = time.perf_counter()
    syncs.append({"facts": plugin.maintenance.run_embeddings_sync(),
                  "ms": (time.perf_counter() - t) * 1e3})
    asker.join()
    launches = count() if count is not None else None
    check(not errors, f"knowledge: the query thread failed: {errors}")
    plugin.maintenance.run_decay()
    snap = plugin.timer.snapshot()
    facts = [f.to_dict() for f in plugin.fact_store.snapshot()]
    events = knowledge_events(transport)
    stats = plugin.stats()
    gw.stop()
    return {"fill_ops": fill_ops, "more_ops": more_ops, "cap": cap,
            "facts_at_cap": at_cap, "pruned_after_sync": pruned,
            "syncs": syncs, "forwards": forwards,
            "sync_forwards": len(forwards) - emb.query_cache_misses,
            "query_forwards": emb.query_cache_misses,
            "thread_misses": emb.query_cache_misses - misses_before,
            "removed": removed, "searches": searches, "texts": texts,
            "query_ms": query_ms, "launches": launches,
            "stage_ms": {k: snap["stages_ms"].get(k) for k in KNOWLEDGE_STAGES},
            "stage_counts": {k: snap["counts"].get(k)
                             for k in KNOWLEDGE_STAGES},
            "stats": {k: stats[k] for k in ("facts", "embedded",
                                            "queryCache")},
            "facts": facts, "files": worker_tree(str(ws / "knowledge")),
            "events": events}


def knowledge_search_differs(card: dict, host: dict,
                             tol: float = KNOWLEDGE_SCORE_TOL) -> list:
    """The sequential queries whose hits on the card are not the CPU's:
    a different query order or hit count, a hit whose card score is off
    the CPU's score of that fact by more than ``tol``, or a hit that is
    not the CPU's hit at that rank and scores (on the CPU) more than
    ``tol`` below it. In bf16 two facts that score within the noise of
    each other may trade ranks; every other difference is named."""
    seq = [s for s in card["searches"] if s["thread"] != "knowledge-queries"]
    ref = [s for s in host["searches"] if s["thread"] != "knowledge-queries"]
    if [s["query"] for s in seq] != [s["query"] for s in ref]:
        return ["query order"]
    out = []
    for got, want in zip(seq, ref):
        if len(got["hits"]) != len(want["hits"]):
            out.append(f"{got['query']!r}: {len(got['hits'])} hits, "
                       f"{len(want['hits'])} on the CPU")
            continue
        for rank, ((cid, cscore), (hid, hscore)) in enumerate(
                zip(got["hits"], want["hits"])):
            mine = want["scores"].get(cid)
            if mine is None or abs(cscore - mine) > tol or (
                    cid != hid and hscore - mine > tol):
                out.append(f"{got['query']!r} rank {rank}: {cid} "
                           f"({cscore}) where the CPU has {hid} ({hscore})")
    return out


def knowledge_check(card: dict, host: dict, n_layers: int) -> dict:
    """The card's knowledge run against the CPU's: facts (as JSON and the
    files), events, syncs, removals and searches; K1 = n_layers x the
    forwards when the card counted."""
    for key in ("fill_ops", "facts_at_cap", "pruned_after_sync", "removed",
                "stats"):
        check(card[key] == host[key], f"knowledge: {key} {card[key]} on the "
                                      f"card, {host[key]} on the CPU")
    check(card["facts_at_cap"] == card["cap"],
          f"knowledge: the fill stopped at {card['facts_at_cap']} facts")
    check(card["pruned_after_sync"] > 0 and sum(card["removed"]) > 0,
          "knowledge: no fact pruned after the first sync, or none removed "
          "from the arena")
    check([s["facts"] for s in card["syncs"]]
          == [s["facts"] for s in host["syncs"]],
          f"knowledge: syncs {[s['facts'] for s in card['syncs']]} on the "
          f"card, {[s['facts'] for s in host['syncs']]} on the CPU")
    check(json.dumps(card["facts"]) == json.dumps(host["facts"]),
          "knowledge: the facts differ from the CPU's")
    differ = sorted(k for k in set(card["files"]) | set(host["files"])
                    if card["files"].get(k) != host["files"].get(k))
    check(card["files"] and not differ,
          f"knowledge: fact files {differ} differ from the CPU's")
    check(card["events"] == host["events"],
          f"knowledge: {len(card['events'])} events on the card differ from "
          f"the CPU's {len(host['events'])}")
    # each /knowledge text's fact lines (the store's substring matches)
    lines = [t.split("  semantic:")[0].split("  stages:")[0]
             for t in card["texts"]]
    check(lines == [t.split("  semantic:")[0].split("  stages:")[0]
                    for t in host["texts"]],
          "knowledge: the /knowledge fact lines differ from the CPU's")
    differ = knowledge_search_differs(card, host)
    check(not differ, f"knowledge: searches differ from the CPU's: "
                      f"{differ[:4]}")
    seq = [s for s in card["searches"] if s["thread"] != "knowledge-queries"]
    ref = [s for s in host["searches"] if s["thread"] != "knowledge-queries"]
    exact = sum(1 for a, b in zip(seq, ref)
                if [h[0] for h in a["hits"]] == [h[0] for h in b["hits"]])
    score_err = max((abs(a[1] - b[1]) for x, y in zip(seq, ref)
                     for a, b in zip(x["hits"], y["hits"]) if a[0] == b[0]),
                    default=0.0)
    check(all(math.isfinite(h[1]) for s in card["searches"]
              for h in s["hits"]), "knowledge: a non-finite score")
    check(len(card["forwards"]) == card["sync_forwards"]
          + card["query_forwards"] and card["sync_forwards"] == len(
              [s for s in card["syncs"] if s["facts"]]),
          f"knowledge: {len(card['forwards'])} forwards for "
          f"{card['sync_forwards']} syncs and {card['query_forwards']} "
          "uncached queries")
    if card["launches"] is not None:
        k1 = card["launches"]["k1"]
        want = n_layers * (card["sync_forwards"] + card["query_forwards"])
        check(k1 == want, f"knowledge: K1 launches {k1} != {n_layers} layers "
                          f"x ({card['sync_forwards']} sync + "
                          f"{card['query_forwards']} query forwards)")
    return {"ids_in_order": exact, "queries": len(seq),
            "score_max_abs_err": score_err}


def knowledge_leg(device, root: str, count=None, **kw) -> dict:
    """The knowledge run on ``device`` and on the CPU, held together."""
    import os as _os

    from vainplex_openclaw_tpu_torch.models.pretrained import load_pretrained

    cfg, _ = load_pretrained(device="cpu")
    card = knowledge_run(device, _os.path.join(root, "card"), count=count,
                         **kw)
    host = knowledge_run("cpu", _os.path.join(root, "host"), **kw)
    held = knowledge_check(card, host, cfg.n_layers)
    return {"card": card, "host": host, **held}


def slo_legs(device, bench: dict = SLO_BENCH, legs=SLO_LEGS,
             sim: dict = SLO_SIM) -> dict:
    """``run_slo_report`` on ``device``: each wall leg with no verdict
    lost, no false block and the expected denials and redactions (each
    above 0), shedding at saturation 2 equal to the sitrep's count; and
    the sim report on ``device`` equal to the CPU's as sorted JSON."""
    from vainplex_openclaw_tpu_torch.slo import run_slo_report

    out = {}
    for name, over in legs:
        t = time.perf_counter()
        rep = run_slo_report(**{**bench, **over}, device=device)
        v = rep["verdicts"]
        check(v["losses"] == 0 and v["false_blocks"] == 0,
              f"slo {name}: {v['losses']} verdicts lost, "
              f"{v['false_blocks']} false blocks")
        check(v["observed_denials"] == v["expected_denials"] > 0
              and v["observed_redactions"] == v["expected_redactions"] > 0,
              f"slo {name}: verdicts {v}")
        shed = (rep.get("admission") or {}).get("shed", 0)
        if over.get("saturation", bench["saturation"]) > 1.0 \
                and not over.get("workers"):
            check(shed > 0 and shed == rep["sitrep"]["gatewayShed"],
                  f"slo {name}: shed {shed}, sitrep "
                  f"{rep['sitrep'].get('gatewayShed')}")
        out[name] = {"seconds": time.perf_counter() - t,
                     "e2e": {k: rep["e2e"].get(k)
                             for k in ("count", "p50", "p95", "p99")},
                     "throughput_ops_s": rep["throughput_ops_s"],
                     "capacity_ops_s": rep["capacity_ops_s"],
                     "offered_ops_s": rep["offered_ops_s"],
                     "shed": shed, "verdicts": v,
                     "workload": rep["workload"]["checksum"]}
    card = run_slo_report(**sim, device=device)
    host = run_slo_report(**sim, device="cpu")
    check(json.dumps(card, sort_keys=True) == json.dumps(host, sort_keys=True),
          "slo: the sim report on the card differs from the CPU's")
    out["sim"] = {"equal_cpu": True, "shed": card["admission"].get("shed"),
                  "verdicts": card["verdicts"],
                  "workload": card["workload"]["checksum"]}
    return out


def phase_knowledge_slo(smi: str) -> dict:
    """The full five-plugin gateway of JAX's SLO harness on the port, with
    the knowledge engine's fact embeddings on the card (the knowledge
    leg: :func:`knowledge_leg`), then ``run_slo_report`` on the card
    (:func:`slo_legs`); K1 at the first sync's bucket timed beside its
    bound, plain version and SDPA. NATS is not driven (the card's machine
    has no ``nats`` client package)."""
    import importlib.util
    import tempfile

    import torch

    from vainplex_openclaw_tpu_torch.models.pretrained import load_pretrained
    from vainplex_openclaw_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    cfg, _ = load_pretrained()
    buckets: list = []
    forward = fa._forward

    def count(reset: bool = False) -> dict:
        torch.cuda.synchronize()
        if reset:
            fa.launches = 0
        return {"k1": fa.launches}

    def record_bucket(q, *args, **kwargs):
        if q.is_cuda:
            buckets.append(list(q.shape))
        return forward(q, *args, **kwargs)

    saved_home = os.environ.get("OPENCLAW_HOME")
    with tempfile.TemporaryDirectory() as root:
        os.environ["OPENCLAW_HOME"] = os.path.join(root, "home")
        fa._forward = record_bucket
        try:
            leg = knowledge_leg(None, os.path.join(root, "knowledge"),
                                count=count)
            knowledge_s = time.perf_counter() - t0
            slo = slo_legs(None)
        finally:
            fa._forward = forward
            if saved_home is None:
                os.environ.pop("OPENCLAW_HOME", None)
            else:
                os.environ["OPENCLAW_HOME"] = saved_home
    shapes = [list(s) for s in dict.fromkeys(map(tuple, buckets))]
    unheld = trace_k1_unheld(shapes)
    check(not unheld, f"knowledge: K1 launched at {unheld}, which no kernels "
                      "case holds against the plain version")
    card = leg["card"]
    k1_by_bucket: dict = {}
    for shape in buckets:
        k1_by_bucket[str(shape[0])] = k1_by_bucket.get(str(shape[0]), 0) + 1
    check(sum(k1_by_bucket.values()) == card["launches"]["k1"],
          f"knowledge: K1 by bucket {k1_by_bucket} against "
          f"{card['launches']['k1']} launches")
    sync_b = trace_k1_shape(cfg, card["syncs"][0]["facts"])
    timed = time_k1(*sync_b, seed=47)
    record = {
        "phase": "knowledge_slo", "nvidia_smi": smi,
        "nats": "not driven" + ("" if importlib.util.find_spec("nats")
                                else ": no nats client package installed"),
        "knowledge": {
            "fill_ops": card["fill_ops"], "more_ops": card["more_ops"],
            "facts": card["cap"], "pruned_after_sync":
                card["pruned_after_sync"], "removed": card["removed"],
            "syncs": card["syncs"], "cpu_sync_ms":
                [s["ms"] for s in leg["host"]["syncs"]],
            "forwards": card["forwards"], "query_ms": quantiles_ms(
                card["query_ms"]),
            "cpu_query_ms": quantiles_ms(leg["host"]["query_ms"]),
            "thread_misses": card["thread_misses"],
            "stage_ms": card["stage_ms"], "stage_counts":
                card["stage_counts"], "events": len(card["events"]),
            "fact_files": sorted(card["files"]),
            "ids_in_order": leg["ids_in_order"], "queries": leg["queries"],
            "score_max_abs_err": leg["score_max_abs_err"],
            "score_tol": KNOWLEDGE_SCORE_TOL, "seconds": knowledge_s},
        "k1_launches": card["launches"]["k1"], "k1_shapes": shapes,
        "k1_by_bucket": k1_by_bucket,
        "k1_sync_shape": {k: timed[k] for k in (
            "shape", "kernel_ms", "kernel_ms_runs", "plain_ms",
            "library_ms", "bound_ms", "bound_by", "exp_floor_ms", "err")},
        "slo": slo, "seconds": time.perf_counter() - t0}
    emit(record)
    return record


# ── governance_install: 2FA, ERC-8004 and brainplex on the card ──────

INSTALL_SEED = 53
INSTALL_SERIAL_TEXTS = 64
INSTALL_THREADS = 8
INSTALL_THREAD_TEXTS = 128
INSTALL_2FA_THREADS = 4
INSTALL_2FA_ROUNDS = 4
INSTALL_APPROVERS = ("@alice:loopback", "@bob:loopback")
INSTALL_INTRUDER = "@mallory:loopback"
INSTALL_ROOM = "!approvals:loopback"
INSTALL_POLL_S = 0.05
INSTALL_WINDOW_MS = 100  # every thread of a round joins its one batch
INSTALL_WAIT_S = 30.0    # the longest the phase waits for one step
# agent -> token, and token -> (owner, feedback count, reputation score):
# one excellent, one mixed and one unproven agent on the loopback chain
INSTALL_TOKENS = {"main": 8004, "forge": 42, "scout": 7}
INSTALL_CHAIN = {8004: (0x8004AA, 12, 85), 42: (0x42BB, 3, 45),
                 7: (0x7CC, 0, 0)}
INSTALL_AGENTS = ("main", "forge", "scout")
INSTALL_MESSAGES = 48
INSTALL_QUERIES = 8
# the brainplex leg's doom loops and bench chains for /trace-analyze
INSTALL_TRACE = {"n_bench": 12, "n_doom": 3}
# brainplex's cortex config turns the trace analyzer on without its
# classify stage; the operator's one edit after init that turns local
# triage on, so /trace-analyze runs K1 as well as K3
INSTALL_CORTEX_EDIT = {"traceAnalyzer": {"classify": {
    "enabled": True, "useLocalTriage": True}}}
_BACKUP_STAMP = re.compile(r"\.backup-\d{8}-\d{6}$")
_INSTALL_TIMING = (re.compile(r" in \d+(?:\.\d+)?ms \(\d+ ev/min\)"),
                   re.compile(r"avg=\S+µs"), re.compile(r"\d+(?:\.\d+)?ms"))


class _Loopback:
    """An HTTP server on 127.0.0.1 (any free port) on a daemon thread; the
    phase fails if it cannot bind."""

    def _serve(self, handler, name: str) -> None:
        from http.server import ThreadingHTTPServer

        try:
            self.server = ThreadingHTTPServer(("127.0.0.1", 0), handler)
        except OSError as exc:
            raise SmokeFailure(f"loopback {name} cannot bind: {exc}")
        self.server.daemon_threads = True
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       name=f"loopback-{name}", daemon=True)
        self.thread.start()

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.server.server_port}"

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(5.0)


def _reply_json(handler, body: dict) -> None:
    data = json.dumps(body).encode()
    handler.send_response(200)
    handler.send_header("Content-Type", "application/json")
    handler.send_header("Content-Length", str(len(data)))
    handler.end_headers()
    handler.wfile.write(data)


class LoopbackHomeserver(_Loopback):
    """The Matrix client-server calls the 2FA loop makes, on 127.0.0.1:
    ``PUT .../send/m.room.message/<txn>`` (recorded, with its time) and
    ``GET .../messages`` (``dir=b`` gives the newest token, ``dir=f``
    pages forward from ``from``). ``post`` puts an ``m.text`` event in the
    room; ``gets`` counts the GETs received."""

    def __init__(self):
        from http.server import BaseHTTPRequestHandler
        from urllib.parse import parse_qs, urlparse

        self.sent: list = []
        self.events: list = []
        self.gets = 0
        self.lock = threading.Lock()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_PUT(self):
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length) or b"{}")
                with outer.lock:
                    outer.sent.append({"path": self.path,
                                       "t": time.perf_counter(),
                                       "auth": self.headers.get(
                                           "Authorization"), **body})
                    n = len(outer.sent)
                _reply_json(self, {"event_id": f"$put{n}"})

            def do_GET(self):
                q = parse_qs(urlparse(self.path).query)
                limit = int(q.get("limit", ["10"])[0])
                with outer.lock:
                    outer.gets += 1
                    n = len(outer.events)
                    if q.get("dir") == ["b"]:
                        chunk, end = outer.events[max(0, n - limit):], n
                    else:
                        start = int(q.get("from", ["s0"])[0][1:])
                        chunk = outer.events[start:start + limit]
                        end = start + len(chunk)
                _reply_json(self, {"chunk": chunk, "start": "s0",
                                   "end": f"s{end}"})

        self._serve(Handler, "homeserver")

    def post(self, body: str, sender: str) -> int:
        """One ``m.text`` event from ``sender``; returns the GETs counted
        when it landed."""
        with self.lock:
            self.events.append({"type": "m.room.message", "sender": sender,
                                "event_id": f"$ev{len(self.events)}",
                                "content": {"msgtype": "m.text",
                                            "body": body}})
            return self.gets

    def wait(self, cond, what: str) -> None:
        deadline = time.perf_counter() + INSTALL_WAIT_S
        while not cond():
            check(time.perf_counter() < deadline,
                  f"governance_install: timed out waiting for {what}")
            time.sleep(0.002)

    def wait_sent(self, n: int) -> dict:
        self.wait(lambda: len(self.sent) >= n, f"approval prompt {n}")
        return self.sent[n - 1]

    def wait_polled(self, gets: int) -> None:
        """Until a second GET after ``gets``: the poller has read the room
        past the event posted then and handled what it read."""
        self.wait(lambda: self.gets >= gets + 2, "the poller")


class LoopbackChain(_Loopback):
    """A JSON-RPC ``eth_call`` endpoint on 127.0.0.1 for the identity
    registry: ``ownerOf(uint256)`` and ``getAgentProfile(uint256)``
    answered from ``INSTALL_CHAIN`` (an unknown token has the zero
    owner); ``calls`` counts the requests."""

    def __init__(self, chain: dict = INSTALL_CHAIN):
        from http.server import BaseHTTPRequestHandler

        from vainplex_openclaw_tpu_torch.governance.security import erc8004

        self.calls = 0
        self.lock = threading.Lock()
        outer = self

        def word(v: int) -> str:
            return erc8004.encode_uint256(v)

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length))
                data = req["params"][0]["data"]
                entry = chain.get(int(data[10:], 16), (0, 0, 0))
                if data.startswith(erc8004.SELECTOR_OWNER_OF):
                    result = "0x" + word(entry[0])
                else:
                    result = "0x" + "".join(word(v) for v in entry)
                with outer.lock:
                    outer.calls += 1
                _reply_json(self, {"jsonrpc": "2.0", "id": req["id"],
                                   "result": result})

        self._serve(Handler, "chain")


def install_secret(seed: int = INSTALL_SEED) -> str:
    """A base32 TOTP secret from ``seed``."""
    import base64
    import random

    raw = random.Random(seed).randbytes(20)
    return base64.b32encode(raw).decode().rstrip("=")


def install_governance_config(creds_path: str, rpc_url: str,
                              secret: str) -> dict:
    """JAX's governance config with every section on: stage 3 local over
    ``GATEWAY_FACTS`` (fail closed), a ``2fa`` effect on ``exec``, 2FA
    through the Matrix room in ``creds_path`` and ERC-8004 at
    ``rpc_url``."""
    return {
        "builtinPolicies": {"rateLimiter": {"maxPerMinute": 1_000_000}},
        "policies": [{"id": "gate-exec", "rules": [{
            "id": "exec-2fa", "conditions": [{"type": "tool",
                                              "name": "exec"}],
            "effect": {"action": "2fa", "reason": "exec needs approval"}}]}],
        "validation": {"enabled": True, "facts": GATEWAY_FACTS,
                       "llmValidator": {"enabled": True, "local": True,
                                        "failMode": "closed"}},
        "twoFa": {"enabled": True, "totpSecret": secret,
                  "approvers": list(INSTALL_APPROVERS),
                  "matrixCredsPath": creds_path,
                  "matrixPollIntervalSeconds": INSTALL_POLL_S,
                  "batchWindowMs": INSTALL_WINDOW_MS, "timeoutSeconds": 60},
        "erc8004": {"enabled": True, "rpcUrl": rpc_url,
                    "agentTokens": dict(INSTALL_TOKENS)},
    }


def install_ctx(agent: str) -> dict:
    return {"agent_id": agent, "session_key": f"agent:{agent}",
            "channel_id": "twitter"}


def install_prompt(sent: dict) -> str:
    """An approval prompt with its command lines sorted (the threads of a
    round join their batch in any order)."""
    lines = sent["body"].split("\n")
    head = [ln for ln in lines if not re.match(r"\d+\. ", ln)]
    cmds = sorted(re.sub(r"^\d+\. ", "", ln) for ln in lines
                  if re.match(r"\d+\. ", ln))
    return "\n".join(head[:2] + cmds + head[2:])


def install_2fa_round(gw, hs, totp, agent: str, n_threads: int,
                      code_offset: float) -> dict:
    """``n_threads`` threads each call ``exec`` as ``agent`` at once (one
    batch), then once more (the session approval); the phase waits for
    the batch's prompt and posts an approver's code for ``now +
    code_offset``. Each first call's ms from request to allow, and the
    prompt's and the code's times."""
    barrier = threading.Barrier(n_threads + 1)
    out: list = [None] * n_threads
    errors: list = []

    def call(i: int) -> None:
        try:
            barrier.wait()
            row = []
            for k in range(2):
                t = time.perf_counter()
                d = gw.before_tool_call(
                    "exec", {"command": f"deploy {agent} w{i} #{k}"},
                    install_ctx(agent))
                row.append([d.blocked, d.block_reason,
                            (time.perf_counter() - t) * 1e3, t])
            out[i] = row
        except Exception as exc:  # noqa: BLE001 — the phase reports it
            errors.append(repr(exc))

    threads = [threading.Thread(target=call, args=(i,),
                                name=f"install-exec-{i}")
               for i in range(n_threads)]
    sent0 = len(hs.sent)
    for t in threads:
        t.start()
    barrier.wait()
    prompt = hs.wait_sent(sent0 + 1)
    t_code = time.perf_counter()
    hs.post(totp.generate(time.time() + code_offset), INSTALL_APPROVERS[0])
    for t in threads:
        t.join(INSTALL_WAIT_S)
    check(not any(t.is_alive() for t in threads) and not errors,
          f"governance_install: a 2FA thread hung or failed: {errors[:2]}")
    check(len(hs.sent) == sent0 + 1, "governance_install: a round sent "
                                     f"{len(hs.sent) - sent0} prompts")
    return {"decisions": [[r[:2] for r in row] for row in out],
            "ms": [row[0][2] for row in out],
            "to_prompt_ms": (prompt["t"] - min(row[0][3] for row in out))
            * 1e3, "prompt_to_code_ms": (t_code - prompt["t"]) * 1e3,
            "prompt": install_prompt(prompt), "path": prompt["path"],
            "auth": prompt["auth"]}


def install_refused_round(gw, hs, plugin, totp, agent: str) -> dict:
    """One ``exec`` call as ``agent``: the intruder posts a valid code (the
    call stays blocked, the batch pending), an approver posts a wrong one
    (one attempt counted), then the batch times out."""
    out: list = []
    t = threading.Thread(target=lambda: out.append(gw.before_tool_call(
        "exec", {"command": f"deploy {agent}"}, install_ctx(agent))),
        name="install-exec-refused")
    sent0 = len(hs.sent)
    t.start()
    prompt = hs.wait_sent(sent0 + 1)
    approval = plugin.approval_2fa
    hs.wait_polled(hs.post(totp.generate(time.time()), INSTALL_INTRUDER))
    pending_after_intruder = approval.pending_count()
    alive_after_intruder = t.is_alive()
    near = {totp.generate(time.time() + d * 30) for d in range(-3, 4)}
    wrong = next(f"{c:06d}" for c in range(10 ** 6)
                 if f"{c:06d}" not in near)
    hs.wait_polled(hs.post(wrong, INSTALL_APPROVERS[1]))
    batch = approval._batches.get(agent)
    attempts = batch.attempts if batch is not None else None
    check(alive_after_intruder and t.is_alive() and batch is not None
          and pending_after_intruder == 1 and attempts == 1,
          f"governance_install: the refused round: alive "
          f"{alive_after_intruder}/{t.is_alive()}, pending "
          f"{pending_after_intruder}, attempts {attempts}")
    approval.timeout_batch(batch)
    t.join(INSTALL_WAIT_S)
    check(not t.is_alive() and out, "governance_install: the refused call "
                                    "did not return after its timeout")
    d = out[0]
    check(d.blocked and d.block_reason == "2FA approval timed out",
          f"governance_install: the refused call gave {d.blocked} "
          f"{d.block_reason!r}")
    return {"decision": [d.blocked, d.block_reason], "attempts": attempts,
            "prompt": install_prompt(prompt)}


def install_audit(ws: str) -> list:
    """Each audit record's hook, agent, tool, params, message, verdict and
    reason, sorted."""
    back = audit_readback(ws)
    check(back["corrupt_lines"] == 0 and back["torn_tails"] == 0,
          "governance_install: audit files torn or corrupt")
    rows = []
    for r in back["records"]:
        c = r["context"]
        rows.append(json.dumps([c.get("hook"), c.get("agentId"),
                                c.get("toolName"), c.get("toolParams"),
                                c.get("messageContent"), r["verdict"],
                                r["reason"]], sort_keys=True))
    return sorted(rows)


def install_threads_left(before: set) -> list:
    """The poller and timer threads started since ``before`` that are
    still alive after a short join."""
    left = []
    for t in threading.enumerate():
        if t.ident in before:
            continue
        if t.name == "matrix-2fa-poller" or isinstance(t, threading.Timer):
            t.join(2.0)
            if t.is_alive():
                left.append(t.name)
    return left


def install_governance_run(device, root: str, count=None,
                           serial: int = INSTALL_SERIAL_TEXTS,
                           threaded: int = INSTALL_THREAD_TEXTS,
                           rounds: int = INSTALL_2FA_ROUNDS) -> dict:
    """Leg A on ``device``: the port's ``Gateway`` with
    ``install_governance_config`` against a loopback homeserver and
    chain. ``serial`` external sends one at a time, ``threaded`` from
    ``INSTALL_THREADS`` threads; ``rounds`` 2FA rounds of
    ``INSTALL_2FA_THREADS`` threads; the refused round; then
    ``before_agent_start`` twice for every agent. ``count(reset=...)``
    reads K1 from just before the first send to just after the last."""
    from vainplex_openclaw_tpu_torch.core import Gateway
    from vainplex_openclaw_tpu_torch.core.api import list_logger
    from vainplex_openclaw_tpu_torch.governance import GovernancePlugin
    from vainplex_openclaw_tpu_torch.governance.approval import Totp

    os.makedirs(root)
    before = {t.ident for t in threading.enumerate()}
    hs, chain = LoopbackHomeserver(), LoopbackChain()
    try:
        creds_path = os.path.join(root, "matrix-creds.json")
        with open(creds_path, "w", encoding="utf-8") as f:
            json.dump({"homeserver": hs.url, "accessToken": "syt_loopback",
                       "roomId": INSTALL_ROOM, "userId": "@claw:loopback"},
                      f)
        secret = install_secret()
        ws = os.path.join(root, "ws")
        logger = list_logger()
        gw = Gateway(config={"workspace": ws,
                             "agents": [{"id": a} for a in INSTALL_AGENTS]},
                     logger=logger)
        plugin = GovernancePlugin(device=device)
        gw.load(plugin, plugin_config=install_governance_config(
            creds_path, chain.url, secret), logger=logger)
        gw.start()
        llm = plugin.engine.output_validator.llm_validator
        batcher = llm.call_llm.batcher
        check(plugin.approval_2fa is not None and plugin.erc8004 is not None
              and "matrix-2fa-poller" in {s.id for _, s in gw.services},
              "governance_install: 2FA, the poller or ERC-8004 not built")
        served: list = []
        call_llm = llm.call_llm

        def recorded(prompt: str) -> str:
            verdict = call_llm(prompt)
            served.append([prompt, verdict])
            return verdict

        llm.call_llm = recorded
        batcher.submit("warm-up request")
        batches0 = batcher.batches
        texts = gateway_texts(serial + threaded, seed=INSTALL_SEED)
        decide = gateway_call(gw)
        if count is not None:
            count(reset=True)
        got, lat_s, wall_s, errors = serve_round(decide, texts[:serial], 1)
        check(not errors, f"governance_install: serial sends: {errors[:2]}")
        got_t, lat_t, wall_t, errors = serve_round(decide, texts[serial:],
                                                   INSTALL_THREADS)
        check(not errors, f"governance_install: threaded sends: "
                          f"{errors[:2]}")
        launches = count() if count is not None else None
        batches = batcher.batches - batches0
        totp = Totp(secret)
        rounds_out = [install_2fa_round(gw, hs, totp, f"ops{r}",
                                        INSTALL_2FA_THREADS, 30.0 * (r % 2))
                      for r in range(rounds)]
        refused = install_refused_round(gw, hs, plugin, totp, "ops-x")
        lookups: list = []
        lookup = plugin.erc8004.lookup_reputation

        def timed_lookup(token_id: int) -> dict:
            t = time.perf_counter()
            rep = lookup(token_id)
            lookups.append([token_id, (time.perf_counter() - t) * 1e3,
                            bool(rep.get("from_cache"))])
            return rep

        plugin.erc8004.lookup_reputation = timed_lookup
        agents = list(INSTALL_AGENTS) + [f"ops{r}" for r in range(rounds)]
        contexts = [[a, k, [r["prepend_context"] for r in
                            gw.before_agent_start(install_ctx(a)) if r]]
                    for k in range(2) for a in agents]
        rpc_calls = chain.calls
        warnings = [m for lv, m in logger.records
                    if lv in ("warn", "error") and "[2fa]" in m]
        evaluations = gw.call_method("governance.status")["stats"][
            "totalEvaluations"]
        gw.stop()
    finally:
        hs.close()
        chain.close()
    left = install_threads_left(before)
    check(not left, f"governance_install: threads left after stop: {left}")
    return {"decisions": dict(zip(texts, got + got_t)), "served": served,
            "batches": batches, "launches": launches,
            "serial": latency_summary(lat_s, wall_s),
            "threaded": latency_summary(lat_t, wall_t),
            "rounds": rounds_out, "refused": refused,
            "contexts": contexts, "lookups": lookups, "rpc_calls": rpc_calls,
            "warnings": warnings, "evaluations": evaluations,
            "audit": install_audit(ws), "puts": len(hs.sent),
            "put_auth": sorted({s["auth"] for s in hs.sent})}


def install_governance_check(card: dict, host: dict, oracle: dict,
                             n_layers: int) -> dict:
    """Leg A on the card against the CPU's run and the one-shot oracle."""
    leg = "governance_install"
    for key in ("decisions", "contexts", "audit", "evaluations", "refused",
                "rpc_calls", "puts", "put_auth"):
        check(card[key] == host[key], f"{leg}: {key} differ card vs CPU")
    check([r["decisions"] for r in card["rounds"]]
          == [r["decisions"] for r in host["rounds"]]
          and [r["prompt"] for r in card["rounds"]]
          == [r["prompt"] for r in host["rounds"]],
          f"{leg}: the 2FA rounds differ card vs CPU")
    for r in card["rounds"]:
        check(all(not d[0] for row in r["decisions"] for d in row),
              f"{leg}: an approved call stayed blocked: {r['decisions']}")
        check(r["auth"] == "Bearer syt_loopback"
              and "%21approvals%3Aloopback" in r["path"],
              f"{leg}: the prompt PUT went to {r['path']}")
    mismatched = [p for p, v in card["served"] if oracle.get(p) != v]
    check(card["served"] and not mismatched,
          f"{leg}: {len(mismatched)} stage-3 verdicts differ from the "
          "one-shot oracle")
    check(sorted(card["served"]) == sorted(host["served"]),
          f"{leg}: stage-3 prompts or verdicts differ card vs CPU")
    blocked = sum(bool(d[0]) for d in card["decisions"].values())
    check(0 < blocked < len(card["decisions"]),
          f"{leg}: {blocked} of {len(card['decisions'])} sends blocked")
    onchain = [c for _, _, cs in card["contexts"] for c in cs
               if "onchain=" in c]
    check(len(onchain) == 2 * len(INSTALL_TOKENS)
          and card["rpc_calls"] == 2 * len(INSTALL_TOKENS),
          f"{leg}: {len(onchain)} onchain contexts, {card['rpc_calls']} "
          "RPC calls")
    cached = [hit for _, _, hit in card["lookups"]]
    check(cached == [False] * len(INSTALL_TOKENS) + [True]
          * len(INSTALL_TOKENS), f"{leg}: lookups cached {cached}")
    check(any("Unauthorized approval attempt by " + INSTALL_INTRUDER in m
              for m in card["warnings"]),
          f"{leg}: no unauthorised attempt logged: {card['warnings']}")
    if card["launches"] is not None:
        check(card["launches"]["k1"] == n_layers * card["batches"] > 0,
              f"{leg}: K1 launches {card['launches']['k1']} != {n_layers} "
              f"layers x {card['batches']} batches")
    ms = [m for r in card["rounds"] for m in r["ms"]]
    return {"blocked": blocked, "sends": len(card["decisions"]),
            "stage3_verdicts": len(card["served"]),
            "approval_ms": quantiles_ms(ms),
            "to_prompt_ms": quantiles_ms([r["to_prompt_ms"]
                                          for r in card["rounds"]]),
            "prompt_to_code_ms": quantiles_ms([r["prompt_to_code_ms"]
                                               for r in card["rounds"]]),
            "erc_uncached_ms": [m for _, m, hit in card["lookups"]
                                if not hit],
            "erc_cached_ms": [m for _, m, hit in card["lookups"] if hit],
            "onchain": sorted(set(onchain))}


def install_messages(n: int, seed: int) -> list:
    """``n`` seeded messages of ``generate_workload``'s ``msg_in`` and
    ``msg_out`` ops, as ``(kind, content, agent)``."""
    from vainplex_openclaw_tpu_torch.slo.workload import generate_workload

    out = []
    for op in generate_workload(seed, 8 * n, len(INSTALL_AGENTS)):
        if op.kind in ("msg_in", "msg_out"):
            out.append((op.kind, op.content, INSTALL_AGENTS[op.tenant]))
        if len(out) == n:
            return out
    raise SmokeFailure(f"governance_install: only {len(out)} messages")


def install_text(text: str) -> str:
    """A command's text less the host's clock: a stage line dropped, each
    ms and µs figure written as ``<t>``."""
    lines = [ln for ln in text.splitlines()
             if not ln.strip().startswith("stages:")]
    text = "\n".join(lines)
    for pattern in _INSTALL_TIMING:
        text = pattern.sub("<t>", text)
    return text


def install_brainplex_run(device, root: str, raws: list, count=None,
                          n_messages: int = INSTALL_MESSAGES,
                          n_queries: int = INSTALL_QUERIES) -> dict:
    """Leg B on ``device``: the port's ``brainplex init --full --yes`` in
    ``root/home`` (``OPENCLAW_HOME``), over an ``openclaw.json`` that
    lists ``INSTALL_AGENTS``; a second init; the operator's edit
    (``INSTALL_CORTEX_EDIT``); then the five port plugins loaded from the
    written files on a virtual clock, ``n_messages`` messages, an
    embeddings sync, ``n_queries`` ``/knowledge`` queries,
    ``/trace-analyze`` over ``raws``, a tool call the credential guard
    blocks, ``/governance`` and ``/ops``. ``count(reset=...)`` reads K1
    and K3 from the first message to the last command."""
    import contextlib
    import io

    from vainplex_openclaw_tpu_torch.brainplex import cli
    from vainplex_openclaw_tpu_torch.brainplex.configurator import \
        validate_generated
    from vainplex_openclaw_tpu_torch.config.loader import (
        deep_merge, read_openclaw_config)
    from vainplex_openclaw_tpu_torch.core import Gateway
    from vainplex_openclaw_tpu_torch.core.api import list_logger
    from vainplex_openclaw_tpu_torch.cortex import (CortexPlugin,
                                                    MemoryTraceSource)
    from vainplex_openclaw_tpu_torch.events import EventStorePlugin
    from vainplex_openclaw_tpu_torch.governance import GovernancePlugin
    from vainplex_openclaw_tpu_torch.knowledge import KnowledgeEnginePlugin
    from vainplex_openclaw_tpu_torch.sitrep import SitrepPlugin
    from vainplex_openclaw_tpu_torch.storage import journal
    from vainplex_openclaw_tpu_torch.storage.atomic import (read_json,
                                                            write_json_atomic)
    from vainplex_openclaw_tpu_torch.utils import ids

    leg = "governance_install brainplex"
    home = os.path.join(root, "home")
    os.makedirs(home)
    config_path = os.path.join(home, "openclaw.json")
    with open(config_path, "w", encoding="utf-8") as f:
        json.dump({"agents": {"list": [{"id": a} for a in INSTALL_AGENTS]}},
                  f, indent=2)
    saved_home = os.environ.get("OPENCLAW_HOME")
    os.environ["OPENCLAW_HOME"] = home
    try:
        argv = ["init", "--full", "--yes", "--config", config_path,
                "--no-color"]
        printed = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            code = cli.main(argv)
        init_ms = (time.perf_counter() - t) * 1e3
        again = io.StringIO()
        with contextlib.redirect_stdout(again):
            code_again = cli.main(argv)
        check(code == 0 and code_again == 0 and "nothing to do"
              in again.getvalue(), f"{leg}: init exited {code}, then "
                                   f"{code_again}: {again.getvalue()!r}")
        written = {_BACKUP_STAMP.sub(".backup-<stamp>", k): v
                   for k, v in worker_tree(home).items()}
        merged = read_openclaw_config()
        plugins = merged.get("plugins") or {}
        configs = {pid: read_json(entry["configPath"])
                   for pid, entry in plugins.items()}
        check(sorted(plugins) == ["cortex", "eventstore", "governance",
                                  "knowledge-engine", "sitrep"]
              and all(isinstance(c, dict) for c in configs.values()),
              f"{leg}: openclaw.json lists {sorted(plugins)}")
        problems = validate_generated(configs)
        check(not problems, f"{leg}: generated configs fail the port's "
                            f"manifests: {problems}")
        check(any(".backup-" in p for p in written),
              f"{leg}: no backup of openclaw.json: {sorted(written)}")
        cortex_path = plugins["cortex"]["configPath"]
        write_json_atomic(cortex_path, deep_merge(configs["cortex"],
                                                  INSTALL_CORTEX_EDIT))

        ids._ID_RNG.seed(INSTALL_SEED)
        clock = VirtualClock(WORKER_START)
        ws = os.path.join(root, "ws")
        logger = list_logger()
        gw = Gateway(config={**merged, "workspace": ws}, logger=logger,
                     clock=clock)
        made = {
            "governance": lambda: GovernancePlugin(
                workspace=ws, clock=clock, device=device),
            "cortex": lambda: CortexPlugin(
                workspace=ws, clock=clock, wall_timers=False,
                trace_source=MemoryTraceSource(raws), device=device),
            "eventstore": lambda: EventStorePlugin(clock=clock),
            "knowledge-engine": lambda: KnowledgeEnginePlugin(
                workspace=ws, clock=clock, wall_timers=False,
                device=device),
            "sitrep": lambda: SitrepPlugin(workspace=ws, clock=clock,
                                           wall_timers=False)}
        for pid, entry in plugins.items():
            gw.load(made[pid](), plugin_config=entry, logger=logger)
        gw.start()
        knowledge = gw.plugins["knowledge-engine"].module
        emb = knowledge.embeddings
        forwards, searches = [], []
        embed = emb._embed

        def counted_embed(texts):
            forwards.append(len(texts))
            return embed(texts)

        emb._embed = counted_embed
        emb.search = recording_search(emb, searches)
        if count is not None:
            count(reset=True)
        for agent in INSTALL_AGENTS:
            gw.session_start(install_ctx(agent))
        for kind, content, agent in install_messages(n_messages,
                                                     INSTALL_SEED):
            clock.t += 1.0
            if kind == "msg_in":
                gw.message_received(content, install_ctx(agent))
            else:
                gw.message_sent(content, install_ctx(agent))
        t = time.perf_counter()
        synced = knowledge.maintenance.run_embeddings_sync()
        sync_ms = (time.perf_counter() - t) * 1e3
        texts = [gw.command("/knowledge", args=q)["text"]
                 for q in knowledge_queries(n_queries, INSTALL_SEED)]
        trace_text = gw.command("/trace-analyze")["text"]
        guard = gw.before_tool_call("read", {"file_path": "/app/.env"},
                                    install_ctx("main"))
        governance_text = gw.command("/governance")["text"]
        ops_text = gw.command("/ops")["text"]
        launches = count() if count is not None else None
        trace = trace_files(ws)
        facts = [f.to_dict() for f in knowledge.fact_store.snapshot()]
        gw.stop()
        journal.reset_journals()
    finally:
        if saved_home is None:
            os.environ.pop("OPENCLAW_HOME", None)
        else:
            os.environ["OPENCLAW_HOME"] = saved_home
    return {"init_code": code, "printed": printed.getvalue(),
            "printed_again": again.getvalue(), "init_ms": init_ms,
            "written": written, "configs": configs, "synced": synced,
            "sync_ms": sync_ms, "forwards": forwards,
            "query_forwards": emb.query_cache_misses, "searches": searches,
            "texts": texts, "trace_text": trace_text,
            "trace": trace, "findings": len(trace["report"]["findings"]),
            "guard": [guard.blocked, guard.block_reason],
            "governance_text": governance_text, "ops_text": ops_text,
            "facts": facts, "launches": launches}


def install_brainplex_check(card: dict, host: dict, n_layers: int,
                            windows: list) -> dict:
    """Leg B on the card against the CPU's run: the written files
    byte-equal, each command's text equal less the host's clock (the
    /knowledge semantic lines by :func:`knowledge_search_differs`), the
    credential guard's denial; K1 = n_layers x (sync + uncached query +
    triage forwards), K3 one launch a window."""
    leg = "governance_install brainplex"
    check(card["written"] == host["written"],
          f"{leg}: written files differ card vs CPU: "
          f"{sorted(set(card['written']) ^ set(host['written']))}")
    check(card["printed"] == host["printed"] and "enabled 5 plugins"
          in card["printed"], f"{leg}: init printed {card['printed']!r}")
    check(card["synced"] == host["synced"] > 0
          and card["facts"] == host["facts"],
          f"{leg}: synced {card['synced']} facts on the card, "
          f"{host['synced']} on the CPU")
    lines = [t.split("  semantic:")[0] for t in card["texts"]]
    check(lines == [t.split("  semantic:")[0] for t in host["texts"]],
          f"{leg}: the /knowledge fact lines differ card vs CPU")
    differ = knowledge_search_differs(card, host)
    check(not differ, f"{leg}: searches differ: {differ[:4]}")
    for key in ("trace_text", "governance_text", "ops_text"):
        check(install_text(card[key]) == install_text(host[key]),
              f"{leg}: {key} differs card vs CPU:\n{card[key][:400]}\n"
              f"{host[key][:400]}")
    check(card["trace"] == host["trace"],
          f"{leg}: the /trace-analyze files differ card vs CPU")
    check(card["trace_text"].startswith("🔍 trace analysis:")
          and card["findings"] > 0, f"{leg}: /trace-analyze answered "
                                    f"{card['trace_text'][:200]!r}")
    check(card["guard"][0] and "Credential Guard" in str(card["guard"][1]),
          f"{leg}: the credential guard gave {card['guard']}")
    sync_forwards = len(card["forwards"]) - card["query_forwards"]
    check(sync_forwards == 1, f"{leg}: {len(card['forwards'])} forwards "
                              f"for {card['query_forwards']} queries")
    if card["launches"] is not None:
        k1, k3 = card["launches"]["k1"], card["launches"]["k3"]
        want = n_layers * (len(card["forwards"]) + 1)
        check(k1 == want, f"{leg}: K1 launches {k1} != {n_layers} layers x "
                          f"({len(card['forwards'])} embedding + 1 triage "
                          "forwards)")
        check(k3 == len(windows), f"{leg}: K3 launches {k3} != "
                                  f"{len(windows)} windows")
    return {"synced": card["synced"], "findings": card["findings"],
            "queries": len(card["texts"]),
            "query_forwards": card["query_forwards"],
            "written": sorted(card["written"])}


def install_legs(device, root: str, raws: list, count=None,
                 governance_kw=None, brainplex_kw=None) -> dict:
    """Both legs on ``device`` and then on the CPU, in this process; each
    leg's card run held against its CPU run. The brainplex runs share one
    root, emptied between them, so their paths are equal."""
    import shutil

    from vainplex_openclaw_tpu_torch.models import serve
    from vainplex_openclaw_tpu_torch.models.pretrained import load_pretrained

    cfg, _ = load_pretrained(device="cpu")
    gov = {}
    for leg, dev, counter in (("card", device, count), ("host", "cpu", None)):
        gov[leg] = install_governance_run(
            dev, os.path.join(root, f"governance_{leg}"), counter,
            **(governance_kw or {}))
        serve.close_batchers()
    oracle = one_shot_oracle({p for p, _ in gov["card"]["served"]},
                             device=device)
    serve.close_batchers()
    held_a = install_governance_check(gov["card"], gov["host"], oracle,
                                      cfg.n_layers)
    bp = {}
    bp_root = os.path.join(root, "brainplex")
    for leg, dev, counter in (("card", device, count), ("host", "cpu", None)):
        if os.path.exists(bp_root):
            shutil.rmtree(bp_root)
        bp[leg] = install_brainplex_run(dev, bp_root, raws, counter,
                                        **(brainplex_kw or {}))
    held_b = install_brainplex_check(bp["card"], bp["host"], cfg.n_layers,
                                     trace_k3_windows(raws))
    return {"governance": gov, "brainplex": bp, "oracle": oracle,
            "held_governance": held_a, "held_brainplex": held_b}


def install_raws() -> list:
    """The brainplex leg's trace events: ``INSTALL_TRACE``'s bench chains
    and doom loops, a day after the trace phases' corpora."""
    return trace_corpus(0, INSTALL_TRACE["n_bench"], 0,
                        INSTALL_TRACE["n_doom"],
                        TRACE_BASE_TS + 2 * TRACE_DAY_MS, INSTALL_SEED)


def phase_governance_install(smi: str) -> dict:
    """The port's governance with every section on, and the configs its
    own ``brainplex init`` writes served by its five plugins, on the card
    and then on the CPU (:func:`install_legs`); K1 only at buckets the
    kernels phase holds."""
    import tempfile

    import torch

    from vainplex_openclaw_tpu_torch.models.pretrained import load_pretrained
    from vainplex_openclaw_tpu_torch.ops import flash_attention as fa
    from vainplex_openclaw_tpu_torch.ops import similarity as sim

    t0 = time.perf_counter()
    cfg, _ = load_pretrained()
    raws = install_raws()
    buckets: list = []
    forward = fa._forward
    counting = [False]  # between a leg's reset and its read

    def count(reset: bool = False) -> dict:
        torch.cuda.synchronize()
        if reset:
            fa.launches = sim.launches = 0
        counting[0] = reset
        return {"k1": fa.launches, "k3": sim.launches}

    def record_bucket(q, *args, **kwargs):
        if q.is_cuda and counting[0]:
            buckets.append(list(q.shape))
        return forward(q, *args, **kwargs)

    saved_home = os.environ.get("OPENCLAW_HOME")
    with tempfile.TemporaryDirectory() as root:
        os.environ["OPENCLAW_HOME"] = os.path.join(root, "home")
        fa._forward = record_bucket
        try:
            legs = install_legs(None, root, raws, count)
        finally:
            fa._forward = forward
            if saved_home is None:
                os.environ.pop("OPENCLAW_HOME", None)
            else:
                os.environ["OPENCLAW_HOME"] = saved_home
    shapes = [list(s) for s in dict.fromkeys(map(tuple, buckets))]
    unheld = trace_k1_unheld(shapes)
    check(not unheld, f"governance_install: K1 launched at {unheld}, which "
                      "no kernels case holds against the plain version")
    gov, bp = legs["governance"]["card"], legs["brainplex"]["card"]
    k1 = gov["launches"]["k1"] + bp["launches"]["k1"]
    k1_by_bucket: dict = {}
    for shape in buckets:
        k1_by_bucket[str(shape[0])] = k1_by_bucket.get(str(shape[0]), 0) + 1
    check(sum(k1_by_bucket.values()) == k1,
          f"governance_install: K1 by bucket {k1_by_bucket} against {k1} "
          "launches")
    a, b = legs["held_governance"], legs["held_brainplex"]
    record = {
        "phase": "governance_install", "nvidia_smi": smi,
        "governance": {
            "sends": a["sends"], "blocked": a["blocked"],
            "stage3_verdicts": a["stage3_verdicts"],
            "oracle_equal": True, "cpu_equal": True,
            "serial": gov["serial"], "threaded": gov["threaded"],
            "threads": INSTALL_THREADS,
            "batches": gov["batches"], "k1_launches": gov["launches"]["k1"],
            "approval_rounds": len(gov["rounds"]),
            "approval_threads": INSTALL_2FA_THREADS,
            "approval_ms": a["approval_ms"],
            "to_prompt_ms": a["to_prompt_ms"],
            "prompt_to_code_ms": a["prompt_to_code_ms"],
            "refused": gov["refused"]["decision"],
            "refused_attempts": gov["refused"]["attempts"],
            "erc_uncached_ms": a["erc_uncached_ms"],
            "erc_cached_ms": a["erc_cached_ms"], "onchain": a["onchain"],
            "cpu_serial_requests_per_s":
                legs["governance"]["host"]["serial"]["requests_per_s"],
            "cpu_threaded_requests_per_s":
                legs["governance"]["host"]["threaded"]["requests_per_s"]},
        "brainplex": {
            "init_ms": bp["init_ms"],
            "cpu_init_ms": legs["brainplex"]["host"]["init_ms"],
            "written": b["written"], "operator_edit": INSTALL_CORTEX_EDIT,
            "synced": b["synced"], "sync_ms": bp["sync_ms"],
            "cpu_sync_ms": legs["brainplex"]["host"]["sync_ms"],
            "queries": b["queries"], "query_forwards": b["query_forwards"],
            "findings": b["findings"], "trace_events": len(raws),
            "k1_launches": bp["launches"]["k1"],
            "k3_launches": bp["launches"]["k3"],
            "k3_windows": trace_k3_windows(raws)},
        "k1_launches": k1, "k3_launches": bp["launches"]["k3"],
        "k1_shapes": shapes, "k1_by_bucket": k1_by_bucket,
        "seconds": time.perf_counter() - t0}
    emit(record)
    return record


# ── chaos: fault plans on the checkpoint and state writers ───────────

CHAOS_STEPS = 60
CHAOS_SAVE_EVERY = 10
CHAOS_BATCH = 64
CHAOS_INIT_SEED = 7  # JAX's PRNGKey seed of the init (init_params_from_seed)
# (site, the call of that site that fails): the train leg's plan
CHAOS_TRAIN_FAULTS = (("checkpoint.write", 2), ("checkpoint.rename", 4))
# (site, call, mode): the trace leg's plan. The analyzer's writes, in
# order: the cluster state (a fault there is caught and logged), the
# report, the processing state.
CHAOS_TRACE_FAULTS = (("file.write", 1, "torn"), ("file.rename", 2, "error"))
# a leaf of the resumed state against the uninterrupted one where an op
# on the path had no deterministic CUDA mode (else they are bit-equal)
CHAOS_TOL = TRAIN_PARAM_TOL


def chaos_schedule(total: int, save_every: int, faults) -> dict:
    """What ``train_loop(total_steps=total, save_every=save_every)``
    restarted on one checkpoint directory until it ends does under a plan
    that fails each ``(site, n)`` of ``faults`` at that site's n-th call,
    from the plan alone: each run's first and last step, the site that
    ended it (None for the last) and the latest complete save after it;
    the steps run (replays included) and the steps replayed. A save is
    one ``checkpoint.write`` then one ``checkpoint.rename`` call, at every
    multiple of ``save_every`` and once more at the end."""
    fire = dict(faults)
    calls = {"checkpoint.write": 0, "checkpoint.rename": 0}
    saved, runs, steps = 0, [], 0
    while True:
        start, end, fault = saved, saved, None
        points = [p for p in range(start + 1, total + 1)
                  if p % save_every == 0] + [total]
        for point in points:
            end = point
            for site in ("checkpoint.write", "checkpoint.rename"):
                calls[site] += 1
                if calls[site] == fire.get(site):
                    fault = site
                    break
            if fault:
                break
            saved = point
        steps += end - start
        runs.append({"from": start, "to": end, "fault": fault,
                     "latest": saved})
        if fault is None:
            return {"runs": runs, "steps": steps, "replayed": steps - total}


def chaos_plan(specs):
    """A port ``FaultPlan`` of ``(site, call[, mode])`` specs."""
    from vainplex_openclaw_tpu_torch.resilience import FaultPlan, FaultSpec

    return FaultPlan([FaultSpec(site, steps=(n,), mode=(rest or ("error",))[0])
                      for site, n, *rest in specs], seed=0)


def ckpt_listing(ckpt_dir: str) -> dict:
    """A checkpoint directory's visible steps, its ``*.tmp`` files and the
    visible steps without a manifest."""
    from vainplex_openclaw_tpu_torch.models import checkpoint

    steps = checkpoint.all_steps(ckpt_dir)
    return {"steps": steps,
            "tmp": sorted(f for f in os.listdir(ckpt_dir)
                          if f.endswith(".tmp")),
            "no_manifest": [s for s in steps if not os.path.exists(
                os.path.join(ckpt_dir, f"step-{s}.manifest.json"))]}


def chaos_train_leg(device: str = "cuda", steps: int = CHAOS_STEPS,
                    save_every: int = CHAOS_SAVE_EVERY,
                    batch: int = CHAOS_BATCH) -> dict:
    """``triage-tiny`` from the JAX-key init, ``steps`` AdamW steps of
    ``batch`` on ``device``: once straight through, once under
    ``CHAOS_TRAIN_FAULTS`` restarted on its directory after each
    ``FaultError`` until it ends, both under
    ``torch.use_deterministic_algorithms(True)``. After each fault: no
    ``*.tmp`` file, the latest step the schedule's, every visible step's
    manifest present. Then one fault at each site, K1 launched n_layers x
    the schedule's steps, and the final params, AdamW moments and counts
    of the two runs bit-equal (each leaf within ``CHAOS_TOL`` instead
    where an op warned that it has no deterministic mode)."""
    import tempfile
    import warnings

    import numpy as np
    import torch

    from vainplex_openclaw_tpu_torch.models import checkpoint, train
    from vainplex_openclaw_tpu_torch.models.data import (
        TextClassificationData, synthetic_split)
    from vainplex_openclaw_tpu_torch.models.encoder import (
        flatten_tree, init_params_from_seed, params_from_numpy)
    from vainplex_openclaw_tpu_torch.models.pretrained import TINY_CONFIG
    from vainplex_openclaw_tpu_torch.ops import flash_attention as fa
    from vainplex_openclaw_tpu_torch.resilience import FaultError, installed

    cfg = TINY_CONFIG
    init = init_params_from_seed(cfg, CHAOS_INIT_SEED)
    train_ex, _ = synthetic_split(4096, 512, seed=0)
    schedule = chaos_schedule(steps, save_every, CHAOS_TRAIN_FAULTS)

    def loop(ckpt_dir: str):
        state = train.init_state(params_from_numpy(init, cfg, device,
                                                   cast=False),
                                 train.make_optimizer())
        data = TextClassificationData(train_ex, batch, seq_len=cfg.seq_len,
                                      vocab_size=cfg.vocab_size, seed=0)
        return train.train_loop(state, data, cfg, total_steps=steps,
                                ckpt_dir=ckpt_dir, save_every=save_every)

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    runs = []
    with tempfile.TemporaryDirectory() as tmp, \
            warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            t = time.perf_counter()
            straight = loop(os.path.join(tmp, "straight"))
            sync()
            straight_s = time.perf_counter() - t
            chaos_dir = os.path.join(tmp, "chaos")
            plan = chaos_plan(CHAOS_TRAIN_FAULTS)
            sync()
            fa.launches = 0
            t = time.perf_counter()
            with installed(plan):
                for want in schedule["runs"]:
                    try:
                        state, fault = loop(chaos_dir), None
                    except FaultError as exc:
                        state, fault = None, str(exc)
                    listing = ckpt_listing(chaos_dir)
                    runs.append({"fault": fault, **listing,
                                 "latest": checkpoint.latest_step(chaos_dir)})
                    check((fault is None) == (want["fault"] is None)
                          and (fault is None
                               or f"[fault:{want['fault']}]" in fault),
                          f"chaos: run {len(runs)} ended with {fault}, the "
                          f"plan's schedule says {want['fault']}")
                    check(not listing["tmp"] and not listing["no_manifest"]
                          and runs[-1]["latest"] == want["latest"],
                          f"chaos: after run {len(runs)}: {runs[-1]}, the "
                          f"schedule's latest step {want['latest']}")
            sync()
            chaos_s = time.perf_counter() - t
            launches = fa.launches
        finally:
            torch.use_deterministic_algorithms(was[0], warn_only=was[1])
    nondeterministic = sorted({str(w.message) for w in caught
                               if "deterministic" in str(w.message)})
    check(state is not None, "chaos: the last run did not end")
    check(plan.fired == {site: 1 for site, _ in CHAOS_TRAIN_FAULTS},
          f"chaos: the plan fired {plan.fired}")
    want_k1 = cfg.n_layers * schedule["steps"]
    check(launches == want_k1,
          f"chaos: K1 launches {launches} != {cfg.n_layers} layers x "
          f"{schedule['steps']} steps run")
    check(state.step == straight.step == steps,
          f"chaos: steps {state.step} and {straight.step} != {steps}")
    got, want = (flatten_tree(s.to_tree()) for s in (state, straight))
    unequal = {}
    for key, w in want.items():
        g = got[key]
        g, w = (torch.as_tensor(np.asarray(x) if not torch.is_tensor(x)
                                else x.detach()).cpu() for x in (g, w))
        if not torch.equal(g, w):
            unequal[key] = float((g.double() - w.double()).abs().max())
    if nondeterministic:
        bad = {k: e for k, e in unequal.items() if e > CHAOS_TOL}
        check(not bad, f"chaos: resumed leaves beyond {CHAOS_TOL}: {bad}")
    else:
        check(not unequal, f"chaos: resumed leaves differ from the "
                           f"uninterrupted run: {unequal}")
    return {"steps": steps, "save_every": save_every, "batch": batch,
            "config": "TINY_CONFIG bf16, init JAX PRNGKey(7)",
            "plan": [list(f) for f in CHAOS_TRAIN_FAULTS],
            "fired": dict(plan.fired), "runs": runs,
            "schedule": schedule, "steps_run": schedule["steps"],
            "replayed_steps": schedule["replayed"],
            "k1_launches": launches, "k1_formula": want_k1,
            "leaves": len(want), "unequal_leaves": unequal,
            "bit_equal": not unequal, "nondeterministic_ops": nondeterministic,
            "straight_s": straight_s, "chaos_s": chaos_s}


def state_files(state_dir: str) -> dict:
    """Each analyzer file in ``state_dir``: "absent", "parses" or "torn";
    and every other file there (a ``.tmp<pid>`` left behind)."""
    from vainplex_openclaw_tpu_torch.cortex.trace_analyzer import (
        clusters, report)

    names = (report.REPORT_FILE, report.STATE_FILE,
             clusters.CLUSTER_STATE_FILE)
    out = {}
    for name in names:
        path = os.path.join(state_dir, name)
        if not os.path.exists(path):
            out[name] = "absent"
            continue
        try:
            with open(path, encoding="utf-8") as f:
                json.load(f)
            out[name] = "parses"
        except ValueError:
            out[name] = "torn"
    others = sorted(set(os.listdir(state_dir)) - set(names)) \
        if os.path.isdir(state_dir) else []
    return {"files": out, "others": others}


def chaos_trace_leg(raws: list, devices=("cuda", "cpu")) -> dict:
    """The analyzer's run over ``raws`` on each device under
    ``CHAOS_TRACE_FAULTS`` (a torn write, a failed rename), then again
    without a plan on the same state dir. After the faulted run every
    state and report file parses or is absent and nothing else is left;
    the exception, the faults fired, the error log, the files' states and,
    after the rerun, the report (less its timing fields), the cluster
    state and the processing state are equal on every device."""
    import tempfile

    from vainplex_openclaw_tpu_torch.resilience import FaultError, installed

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for i, dev in enumerate(devices):
            state_dir = os.path.join(tmp, f"{i}_{dev}")
            plan = chaos_plan(CHAOS_TRACE_FAULTS)
            log = RecordingLogger()
            t = time.perf_counter()
            with installed(plan):
                try:
                    trace_run(raws, state_dir, dev, log=log)
                    raised = None
                except FaultError as exc:
                    raised = str(exc)
            faulted_s = time.perf_counter() - t
            left = state_files(state_dir)
            check(raised is not None and plan.fired == {
                site: 1 for site, *_ in CHAOS_TRACE_FAULTS},
                f"chaos trace {dev}: raised {raised}, fired {plan.fired}")
            check("torn" not in left["files"].values() and not left["others"],
                  f"chaos trace {dev}: the faulted run left {left}")
            rerun = trace_run(raws, state_dir, dev)
            out[dev] = {"raised": raised, "fired": dict(plan.fired),
                        "errors": log.messages("error"), "left": left,
                        "faulted_s": faulted_s, "rerun": rerun}
    first = out[devices[0]]
    for dev in devices[1:]:
        for key in ("raised", "fired", "errors", "left"):
            check(out[dev][key] == first[key],
                  f"chaos trace: {key} {first[key]} on {devices[0]}, "
                  f"{out[dev][key]} on {dev}")
        for part in ("report", "clusters", "state"):
            check(out[dev]["rerun"]["files"][part]
                  == first["rerun"]["files"][part],
                  f"chaos trace: the rerun's {part} differs {devices[0]} "
                  f"vs {dev}")
    return {"plan": [list(f) for f in CHAOS_TRACE_FAULTS],
            "events": len(raws), "raised": first["raised"],
            "fired": first["fired"], "errors": first["errors"],
            "left_after_fault": first["left"],
            "equal_across": list(devices),
            "faulted_s": {d: out[d]["faulted_s"] for d in devices},
            "rerun": {d: trace_summary(out[d]["rerun"]) for d in devices}}


def phase_chaos(smi: str) -> dict:
    """The fault plans on the card: the train leg (``chaos_train_leg``)
    and the trace leg (``chaos_trace_leg`` over run 1 of
    ``trace_corpora``, card against CPU)."""
    t0 = time.perf_counter()
    trained = chaos_train_leg()
    traced = chaos_trace_leg(trace_corpora()[0])
    record = {"phase": "chaos", "nvidia_smi": smi, "train": trained,
              "trace": traced, "seconds": time.perf_counter() - t0}
    emit(record)
    return record


# ── the offline search loops ─────────────────────────────────────────

SEARCH_LENGTHS = (64, LONG_L)  # the serve bucket and the long family's
SEARCH_STEPS = 4  # serially dependent K1 calls per timed round (JAX's)
SEARCH_ROUNDS = 3
# every candidate tile against the plain versions at the point shape and
# at the served shapes: the kernels phase's bf16 bound, per row
POINT_TOL = TOL["bfloat16"]
# the long serve shape (B, H, L, Dh): serve_long's long sub-batch
LONG_SERVE = (8, 2, LONG_L, 16)
# plan_search on the card: JAX's defaults time 12 queries (~40 ms), which
# host noise decides; each (1, 1) sweep times this many requests and
# queries, and runs PLAN_RUNS times: a row is written only where every
# run's gate passed the same candidate
PLAN_SEARCH_CARD = {"requests": 256, "queries": 256}
PLAN_RUNS = 3
OUT_DIR = os.environ.get("CHIP_SMOKE_OUT",
                         os.path.join("build", "chip_smoke"))


def search_launches(steps: int, rounds: int) -> int:
    """K1 launches a candidate's timed rounds make: one per step."""
    return steps * rounds


def served_cases(lengths) -> list:
    """The bf16 ``KERNEL_CASES`` a block-table row of a bucket in
    ``lengths`` would serve (the pow2 bucket of Lq or Lk is one of
    them), plus the long serve shape: where a searched tile is held
    against the plain version before its row may be written. Not the
    ``TRACE_TRIAGE_CASES``, ``WORKER_SERVE_CASES``,
    ``KNOWLEDGE_SYNC_CASES`` or ``INSTALL_SYNC_CASES``: they differ from
    ``serve_path`` only in the batch, which a tile does not see, and the
    search's check walks one (batch, head) slice at a time (65,536 of them
    at B=16384). Nor the wide cases: the wide library has its own tiles."""
    from vainplex_openclaw_tpu_torch.ops.similarity import pow2_bucket

    buckets = {pow2_bucket(L) for L in lengths}
    cases = [c for c in KERNEL_CASES if c not in TRACE_TRIAGE_CASES
             and c not in WORKER_SERVE_CASES + KNOWLEDGE_SYNC_CASES
             + INSTALL_SYNC_CASES
             and c not in WIDE_CASES + WIDE_STREAMED_Q_CASES
             and {pow2_bucket(c[3]), pow2_bucket(c[4])} & buckets]
    B, H, L, Dh = LONG_SERVE
    if pow2_bucket(L) in buckets:
        cases.append(("long_serve", B, H, L, L, Dh, False, False))
    return cases


def card_rows(table: dict) -> dict:
    """``table`` with only the rows one card may write: every row of
    another device family as it is, and ``cuda:`` rows of a 1x1 grid or
    one device. A grid that repeats the one card checks the search, but
    its rows are not rows of a grid of distinct cards."""
    keep = {k: e for k, e in table["entries"].items()
            if k.split(":")[0] != "cuda" or k.split(":")[1] in ("1x1", "1")}
    return {**table, "entries": keep}


def agreed_sweeps(runs: list) -> dict:
    """The last of ``runs`` (``plan_search.search`` results over the same
    grids) with a sweep left improved only where every run's gate passed
    the same candidate: a winner of one run can be that run's noise."""
    last = runs[-1]
    sweeps = {}
    for key, sweep in last["sweeps"].items():
        won = {r["sweeps"][key]["best"].get("candidate")
               if r["sweeps"][key]["improved"] else None for r in runs}
        if sweep["improved"] and len(won) == 1:
            sweeps[key] = sweep
        else:
            sweeps[key] = {k: v for k, v in sweep.items() if k != "entry"}
            sweeps[key]["improved"] = False
    return {**last, "sweeps": sweeps}


def write_out(name: str, table: dict) -> str:
    path = os.path.join(OUT_DIR, name)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(table, f, indent=1)
        f.write("\n")
    return path


def hold_tile(tile: tuple, cases: list, rng) -> list:
    """K1 and K2 at ``tile`` against their plain versions at each case
    (bf16, ``kernel_search.parity_errors``: per row, the control from
    ``CONTROL_MIN_LK`` keys); fails the run on a miss, or on a control
    the check passes."""
    import torch

    from vainplex_openclaw_tpu_torch.ops import kernel_search as ks

    rows = []
    for name, B, H, Lq, Lk, Dh, causal, mask_kind in cases:
        q, k, v, mask = make_qkv(rng, B, H, Lq, Lk, Dh, torch.bfloat16,
                                 mask_kind, "cuda")
        control = Lk >= CONTROL_MIN_LK and not causal
        e = ks.parity_errors(q, k, v, tile, mask, causal=causal,
                             control=control)
        what = f"kernel_search {tile[0]}x{tile[1]} at {name}"
        check(e["k1"] <= POINT_TOL and e["k2"] <= POINT_TOL,
              f"{what}: K1 {e['k1']}, K2 {e['k2']} > {POINT_TOL}")
        if control:
            check(e["k1_control"] > POINT_TOL and e["k2_control"] > POINT_TOL,
                  f"{what}: the check passes the plain version without its "
                  f"first key tile ({e['k1_control']}, {e['k2_control']})")
        rows.append({"case": name, "k1": e["k1"], "k2": e["k2"],
                     "k1_control": e.get("k1_control"),
                     "k2_control": e.get("k2_control")})
        del q, k, v, mask
        torch.cuda.empty_cache()
    return rows


def phase_kernel_search(smi: str, ex2_per_s: float) -> dict:
    """The tile search on the card: every candidate library built in one
    parallel call, then ``kernel_search.search`` from the compiled default
    (no table, so 64x64 is the incumbent at each length); then every tile
    held against the plain versions at each shape a row of the searched
    buckets would serve, and K1 and K2 timed at the long serve shape at
    every tile."""
    import numpy as np
    import torch

    from vainplex_openclaw_tpu_torch.ops import _build
    from vainplex_openclaw_tpu_torch.ops import flash_attention as fa
    from vainplex_openclaw_tpu_torch.ops import kernel_search as ks

    committed = fa.load_block_table(fa.TABLE_PATH)
    prev = os.environ.get(fa.TABLE_ENV)
    os.environ[fa.TABLE_ENV] = os.devnull  # no table: 64x64 incumbents
    fa.clear_table_cache()
    try:
        tiles = sorted({t for L in SEARCH_LENGTHS
                        for t in ks.candidate_pairs(L, family="cuda")})
        t0 = time.perf_counter()
        built = _build.build([("flash_attention", _build.tile_defines(t))
                              for t in tiles])
        build_s = time.perf_counter() - t0
        for name, r in built.items():
            check_spills(name, ptxas_report(r["ptxas"]))
        builds0 = _build.builds
        results = ks.search(SEARCH_LENGTHS, dtype="bfloat16",
                            steps=SEARCH_STEPS, rounds=SEARCH_ROUNDS,
                            device="cuda")
        check(_build.builds == builds0,
              "kernel_search built a library after the parallel build")
    finally:
        if prev is None:
            os.environ.pop(fa.TABLE_ENV, None)
        else:
            os.environ[fa.TABLE_ENV] = prev
        fa.clear_table_cache()
    want = search_launches(SEARCH_STEPS, SEARCH_ROUNDS)
    for key, res in results.items():
        for c in res["candidates"]:
            tile = f"{c['block_q']}x{c['block_k']}"
            check("error" not in c, f"kernel_search {key} {tile}: "
                                    f"{c.get('error')}")
            check(c["k1_err"] <= POINT_TOL and c["k2_err"] <= POINT_TOL,
                  f"kernel_search {key} {tile}: K1 {c['k1_err']}, K2 "
                  f"{c['k2_err']} > {POINT_TOL}")
            if c["seq_len"] >= ks.CONTROL_MIN_L:
                check(c["k1_control"] > POINT_TOL and
                      c["k2_control"] > POINT_TOL,
                      f"kernel_search {key} {tile}: the check passes the "
                      f"plain version without its first key tile")
            check(c["retraces"] == 0, f"kernel_search {key} {tile}: "
                                      f"{c['retraces']} builds while timed")
            check(c["launches"] == want, f"kernel_search {key} {tile}: "
                                         f"{c['launches']} launches != {want}")
            emit({"phase": "kernel_search_point", "bucket": key,
                  "point": [*ks.POINT_SHAPE[:2], c["seq_len"],
                            ks.POINT_SHAPE[2]],
                  "tile": [c["block_q"], c["block_k"]], "ms": c["ms"],
                  "spread": c["spread"], "k1_err": c["k1_err"],
                  "k2_err": c["k2_err"], "max_abs_err": c["max_abs_err"],
                  "k1_control": c.get("k1_control"),
                  "k2_control": c.get("k2_control"), "tol": POINT_TOL,
                  "builds_timed": c["retraces"], "launches": c["launches"],
                  "expected_launches": want})
    winners = {key: [res["best"]["block_q"], res["best"]["block_k"]]
               for key, res in results.items()}

    # every tile at every shape a row of the searched buckets would serve
    cases = served_cases(SEARCH_LENGTHS)
    held = {f"{t[0]}x{t[1]}": hold_tile(t, cases, np.random.default_rng(17))
            for t in tiles}
    emit({"phase": "kernel_search_held", "cases": [c[0] for c in cases],
          "tol": POINT_TOL,
          "worst": {t: {"k1": max(r["k1"] for r in rows),
                        "k2": max(r["k2"] for r in rows),
                        "control_min": min(
                            min(r["k1_control"], r["k2_control"])
                            for r in rows if r["k1_control"] is not None)}
                    for t, rows in held.items()}})

    table = ks.to_table(results, base_table=committed, provenance={
        "card": smi, "run": "chip_smoke.py phase kernel_search",
        "point": f"B={ks.POINT_SHAPE[0]} H={ks.POINT_SHAPE[1]} "
                 f"Dh={ks.POINT_SHAPE[2]} bf16, {SEARCH_STEPS} steps x "
                 f"{SEARCH_ROUNDS} rounds, incumbent 64x64, margin "
                 f"{ks.MIN_GAIN} and each record's spread"})
    findings = ks.validate_table(table)
    check(findings == [], f"searched block table: {findings}")
    written = write_out("flash_block_table.json", table)

    # the long serve shape (every key valid), each tile in turns with 64x64
    B, H, L, Dh = LONG_SERVE
    q, k, v, _ = make_qkv(np.random.default_rng(13), B, H, L, L, Dh,
                          torch.bfloat16, False, "cuda")
    mask = torch.ones((B, L), dtype=torch.bool, device=q.device)

    def at(tile, stats):
        return lambda: fa.flash_attention(q, k, v, mask, return_stats=stats,
                                          block_q=tile[0], block_k=tile[1])

    order = [fa.DEFAULT_TILES] + [t for t in tiles
                                  if t != fa.DEFAULT_TILES] + \
        [fa.DEFAULT_TILES]
    served: dict = {}
    for t in order:
        row = served.setdefault(f"{t[0]}x{t[1]}", {"k1_ms": [], "k2_ms": []})
        row["k1_ms"].append(time_ms(at(t, False), n=5, reps=3, warmup=1))
        row["k2_ms"].append(time_ms(at(t, True), n=5, reps=3, warmup=1))
    family = next(iter(results.values()))["family"]
    long_tile = tuple(winners[ks.bucket_key(LONG_L, family=family)])
    base = served["64x64"]
    record = {"phase": "kernel_search", "nvidia_smi": smi,
              "build_seconds": build_s, "libraries_built": len(built),
              "lengths": list(SEARCH_LENGTHS), "winners": winners,
              "improved": {k: r["improved"] for k, r in results.items()},
              "table_findings": findings, "table_written": written,
              "served_long": {
                  "shape": [B, H, L, L, Dh], "tile": list(long_tile),
                  "held": {t: next(r for r in rows
                                   if r["case"] == "long_serve")
                           for t, rows in held.items()},
                  "ms": {t: {m: statistics.median(v) for m, v in r.items()}
                         for t, r in served.items()},
                  "ms_64x64_runs": base,
                  "exp_floor_measured_ms": B * H * L * L / ex2_per_s * 1e3}}
    emit(record)
    return record


def phase_plan_search(smi: str) -> dict:
    """The placement search on the card: both families at (1, 1), whose
    rows may be written, ``PLAN_RUNS`` times, a row kept only where every
    run passed the same candidate (``agreed_sweeps``); and once at (2, 1)
    over the repeated card as a check of the harness only; then
    ``meshShape: null`` served with the committed table resolves the plan
    ``plan_provenance`` reports."""
    from vainplex_openclaw_tpu_torch.models import serve
    from vainplex_openclaw_tpu_torch.parallel import plan
    from vainplex_openclaw_tpu_torch.parallel import plan_search as ps

    t0 = time.perf_counter()
    card = {"device": "cuda", **PLAN_SEARCH_CARD}
    ones = [ps.search({**card, "shapes": ((1, 1),)})
            for _ in range(PLAN_RUNS)]
    two = ps.search({**card, "shapes": ((2, 1),), "repeatDevice": True})
    runs = [(f"1x1 run {i + 1}", r) for i, r in enumerate(ones)]
    for grid, res in runs + [("2x1 over one card", two)]:
        for key, sweep in res["sweeps"].items():
            for c in sweep["candidates"]:
                what = f"plan_search {key} {c.get('candidate', 'incumbent')}"
                check("error" not in c, f"{what}: {c.get('error')}")
                check(c["mismatches"] == 0, f"{what}: {c['mismatches']} "
                                            "results differ from the oracle")
                check(c["retraces"] == 0, f"{what}: {c['retraces']} builds "
                                          "while timed")
                check((c["k1_launches"], c["k2_launches"]) ==
                      (c["k1_expected"], c["k2_expected"]),
                      f"{what}: launches {c['k1_launches']}, "
                      f"{c['k2_launches']} != {c['k1_expected']}, "
                      f"{c['k2_expected']}")
            best = sweep["best"]
            emit({"phase": "plan_search_point", "grid": grid, "key": key,
                  "improved": sweep["improved"],
                  "sketch_rejected": sweep["sketch_rejected"],
                  "baseline_rps": sweep["baseline"]["rps"],
                  "best": best.get("candidate", "incumbent"),
                  "best_rps": best["rps"],
                  "candidates": [[c.get("candidate", "incumbent"), c["rps"],
                                  c["k1_launches"]]
                                 for c in sweep["candidates"]]})
    agreed = agreed_sweeps(ones)
    # the search decides its own keys afresh: a committed row of a key it
    # swept survives only if this run's sweeps agree on it again
    committed = {k: v for k, v in plan.load_plan_table(
        plan.PLAN_TABLE_PATH).items() if not k.startswith("_")}
    committed["entries"] = {k: e for k, e in committed["entries"].items()
                            if k not in agreed["sweeps"]}
    table = card_rows(ps.to_table(agreed, base_table=committed))
    won = sorted(k for k, sweep in agreed["sweeps"].items()
                 if sweep["improved"])
    table["provenance"]["cuda_rows"] = (
        f"chip_smoke.py phase plan_search at (1, 1) on {smi}, "
        f"{PLAN_SEARCH_CARD['requests']} requests and "
        f"{PLAN_SEARCH_CARD['queries']} queries a candidate, {PLAN_RUNS} "
        f"runs: " + (", ".join(won) if won else
                     "no candidate cleared the gate in every run"))
    findings = ps.validate_plan_table(table)
    check(findings == [], f"searched plan table: {findings}")
    harness = ps.validate_plan_table(ps.to_table(two, base_table=table))
    check(harness == [], f"the repeated-card table: {harness}")
    written = write_out("plan_table.json", table)
    search_s = time.perf_counter() - t0

    # the committed table on the card: meshShape null
    prompts = [as_prompt(t) for t in seeded_texts(16, seed=61)]
    oneshot = serve.make_local_call_llm(
        serve_cfg={"continuousBatching": False})
    call = serve.make_local_call_llm(serve_cfg={
        "meshServing": True, "meshShape": None, "windowMs": 0.0})
    batcher = call.batcher
    resolved = plan.resolve_plan(batcher.plan_family, batcher.mesh,
                                 searched=batcher.searched_plans)
    prov = plan.plan_provenance(batcher.plan_family, batcher.mesh)
    check(resolved.source == prov["plan_source"] and
          resolved.table_key in ("", prov["plan_table_key"]),
          f"meshShape null serves {resolved.source} {resolved.table_key}, "
          f"plan_provenance reports {prov}")
    got = [call(p) for p in prompts]
    check(got == [oneshot(p) for p in prompts],
          "meshShape null: verdicts differ from the one-shot path")
    mesh = "x".join(str(d) for d in batcher.mesh.dims)
    serve.close_batchers()
    record = {"phase": "plan_search", "nvidia_smi": smi,
              "search_seconds": search_s,
              "improved": {name: {k: s["improved"]
                                  for k, s in res["sweeps"].items()}
                           for name, res in runs + [("2x1", two)]},
              "agreed": won,
              "rows_written": sorted(k for k in table["entries"]
                                     if k.startswith("cuda:")),
              "table_findings": findings, "table_written": written,
              "auto_mesh": {"mesh": mesh, **prov,
                            "bucket_min": resolved.bucket_min,
                            "gather": resolved.gather,
                            "verdicts": len(got)}}
    emit(record)
    return record


# ── the graft entry points (graft_entry) ───────────────────────────────────

GRAFT_DRYRUN_SIZES = (8, 4)
ENTRY_TOL = 5e-2  # entry()'s bf16 forward: kernel against plain attention
# (case, dtype, stats, dryrun leg): head-dim-8 cases of KERNEL_CASES (K1)
# or STATS_CASES (K2, ``stats``) timed beside their bound: the dryrun's
# ring+flash shard in fp32, the one shape a main path launches at Dh 8
# (in the leg named), and the kernels phases' Dh 8 cases (no leg)
DH8_TIMED = (
    ("dryrun_ring_shard_dh8", "float32", True, "ring_flash"),
    ("head_dim_8", "bfloat16", False, None),
    ("head_dim_8_long", "bfloat16", False, None),
    ("head_dim_8_long", "bfloat16", True, None),
)


def graft_dryrun(n: int) -> dict:
    """``dryrun_multichip(n)`` on the card's grid: every leg's own checks,
    and each leg's K1 and K2 launches equal to the formula count it
    records beside them (``expected``), the counts set to 0 just
    before."""
    import torch

    from vainplex_openclaw_tpu_torch import graft_entry
    from vainplex_openclaw_tpu_torch.ops import flash_attention as fa

    torch.cuda.synchronize()
    fa.launches = fa.stats_launches = 0
    t = time.perf_counter()
    try:
        report = graft_entry.dryrun_multichip(n)  # prints its line
    except AssertionError as exc:
        raise SmokeFailure(f"dryrun_multichip({n}): {exc}") from exc
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    k1, k2 = fa.launches, fa.stats_launches
    got = {leg: {"k1": r["k1_launches"], "k2": r["k2_launches"]}
           for leg, r in report["legs"].items()}
    want = {leg: r["expected"] for leg, r in report["legs"].items()}
    check(got == want, f"dryrun_multichip({n}): launches per leg {got} != "
                       f"the formulas {want}")
    check(k1 == sum(w["k1"] for w in want.values())
          and k2 == sum(w["k2"] for w in want.values()),
          f"dryrun_multichip({n}): K1 {k1}, K2 {k2} launched in all")
    check(k1 > 0 and k2 > 0, f"dryrun_multichip({n}): a kernel never ran")
    check(report["grid"] in ("repeated", "distinct"),
          f"dryrun_multichip({n}) ran on a {report['grid']} grid")
    return {"grid": report["grid"], "line": report["line"], "wall_s": wall,
            "k1_launches": k1, "k2_launches": k2, "legs": report["legs"]}


def phase_graft_entry(smi: str) -> dict:
    """``graft_entry.entry()`` and ``dryrun_multichip(n)`` on the card."""
    import unittest.mock

    import torch

    from vainplex_openclaw_tpu_torch import graft_entry
    from vainplex_openclaw_tpu_torch.models import encoder
    from vainplex_openclaw_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    fn, args = graft_entry.entry()
    cfg = encoder.EncoderConfig()
    with torch.inference_mode():
        torch.cuda.synchronize()
        fa.launches = fa.stats_launches = 0
        out = fn(*args)
        torch.cuda.synchronize()
        k1 = fa.launches
        # the same forward with the plain attention, on the card
        with unittest.mock.patch.object(encoder, "flash_attention",
                                        fa.flash_attention_reference):
            want = fn(*args)
            torch.cuda.synchronize()
        plain_launches = fa.launches - k1
        forward_ms = time_ms(lambda: fn(*args), n=20, reps=5, warmup=3)
    check(k1 == cfg.n_layers, f"entry(): K1 launched {k1} != n_layers "
                              f"{cfg.n_layers}")
    check(plain_launches == 0, f"entry(): the plain forward launched K1 "
                               f"{plain_launches} times")
    errs = {}
    for h in ("severity", "keep", "mood", "embedding"):
        check(bool(torch.isfinite(out[h]).all()), f"entry(): non-finite {h}")
        errs[h] = float((out[h].float() - want[h].float()).abs().max())
        check(errs[h] <= ENTRY_TOL, f"entry(): {h} differs from the plain "
                                    f"attention's by {errs[h]}")
        if h != "embedding":
            check(bool((out[h].argmax(-1) == want[h].argmax(-1)).all()),
                  f"entry(): {h} argmax differs")
    B, L = args[1].shape
    record = {"phase": "graft_entry", "nvidia_smi": smi,
              "entry": {"k1_launches": k1, "max_abs_err": errs,
                        "tol": ENTRY_TOL, "forward_ms": forward_ms,
                        "k1": time_k1(B, cfg.n_heads, L,
                                      cfg.d_model // cfg.n_heads, seed=81)}}
    for n in GRAFT_DRYRUN_SIZES:
        record[f"dryrun_{n}"] = graft_dryrun(n)
    record["dh8_timing"] = {}
    for i, (case, dt, stats, leg) in enumerate(DH8_TIMED):
        shape = {c[0]: c[1:6] for c in (STATS_CASES if stats
                                         else KERNEL_CASES)}[case]
        record["dh8_timing"][f"{case}_{'k2' if stats else 'k1'}"] = {
            **time_attention(*shape, dt, stats, seed=90 + i), "leg": leg}
    record["seconds"] = time.perf_counter() - t0
    emit(record)
    return record


def dh8_line(graft: dict, stats: bool) -> list:
    """The kernels line's head-dim-8 shapes of K1 or K2: measured ms beside
    the bound, the plain version and SDPA (for K2 ``sdpa_normalized_ms``:
    no library call returns acc, m and l), and the main path that
    launches the shape with its launches, the same count as that path's
    ``launches_by_path`` entry; both null where no main path launches
    it."""
    by_path = dryrun_launches(graft, "k2" if stats else "k1")
    line = []
    for name, t in graft["dh8_timing"].items():
        if t["stats"] != stats:
            continue
        path = t["leg"] and f"dryrun_{t['leg']}"
        line.append({"name": name, "shape": t["shape"], "dtype": t["dtype"],
                     "path": path, "launches": by_path.get(path),
                     "ms": t["kernel_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"],
                     "exp_floor_ms": t["exp_floor_ms"],
                     "plain_ms": t["plain_ms"],
                     "library_ms": t["library_ms"],
                     **({"sdpa_normalized_ms": t["sdpa_normalized_ms"]}
                        if stats else {})})
    return line


def trace_k1_line(traced: dict) -> dict:
    """The kernels line's K1 at the trace analyzer's triage bucket."""
    t = traced["k1_timing"]
    return {"shape": t["shape"], "launches": sum(
        traced[run]["card"]["k1_launches"] for run in TRACE_RUNS),
            "ms": t["kernel_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "plain_ms": t["plain_ms"],
            "library_ms": t["library_ms"]}


def trace_k3_line(traced: dict) -> dict:
    """The kernels line's K3 at the doom-loop detector's window."""
    t = traced["k3_timing"]
    return {"shape": t["shape"], "launches": sum(
        traced[run]["card"]["k3_launches"] for run in TRACE_RUNS),
            "ms": t["kernel_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "plain_ms": t["plain_ms"],
            "library_ms": None}


def dryrun_launches(graft: dict, kernel: str) -> dict:
    """``{"dryrun_<leg>": n}``: K1's (``"k1"``) or K2's launches in each
    dryrun leg that launched it, at n = 8 and 4 together."""
    legs = graft[f"dryrun_{GRAFT_DRYRUN_SIZES[0]}"]["legs"]
    counts = {leg: sum(graft[f"dryrun_{n}"]["legs"][leg][f"{kernel}_launches"]
                       for n in GRAFT_DRYRUN_SIZES) for leg in legs}
    return {f"dryrun_{leg}": c for leg, c in counts.items() if c}


def main() -> int:
    # cuBLAS reads its workspace setting once, at the first product; the
    # chaos phase's deterministic mode needs this one
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    info = phase_device()
    try:
        import torch

        torch.backends.cuda.matmul.allow_tf32 = False  # fp32 stays fp32
        torch.backends.cudnn.allow_tf32 = False
        phase_build()
        worst = phase_kernels()
        forwarded = phase_forward()
        served = phase_serve()
        gateway = phase_gateway(info["nvidia_smi"], served)
        timing = phase_timing()
        worst_stats = phase_kernels_stats()
        wide = phase_timing_wide(info["nvidia_smi"])
        ring = phase_ring()
        served_long = phase_serve_long(info["nvidia_smi"])
        timing_stats = phase_timing_stats()
        grad = phase_grad()
        trained = phase_train(info["nvidia_smi"])
        trained_moe = phase_train_moe()
        triage = phase_triage_embed()
        timing_train = phase_timing_train(info["nvidia_smi"])
        mesh = phase_mesh(info["nvidia_smi"])
        train_mesh = phase_train_mesh(info["nvidia_smi"])
        long_moe = phase_long_moe(info["nvidia_smi"])
        similarity = phase_similarity(info["nvidia_smi"])
        lifecycle = phase_lifecycle(info["nvidia_smi"])
        fleet = phase_fleet(info["nvidia_smi"])
        classified = phase_classify(info["nvidia_smi"])
        traced = phase_trace_analyzer(info["nvidia_smi"])
        worker = phase_worker_profile(info["nvidia_smi"])
        cluster = phase_cluster(info["nvidia_smi"])
        knowledge = phase_knowledge_slo(info["nvidia_smi"])
        installed = phase_governance_install(info["nvidia_smi"])
        chaos = phase_chaos(info["nvidia_smi"])
        searched = phase_kernel_search(
            info["nvidia_smi"], timing_stats["sfu"]["ex2"]["steps_per_s"])
        phase_plan_search(info["nvidia_smi"])
        graft = phase_graft_entry(info["nvidia_smi"])
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr, flush=True)
        return 1
    k1_long = timing_stats["k1_same_shape"]
    k3 = similarity["levenshtein"][f"L{DETECTOR_LEN}_n4096"]
    k3_l128 = similarity["levenshtein"][f"L{SIM_LEN}_n4096"]
    # K1's exponential floors at the ex2 rate timing_stats measured (the
    # long shape's is in that record); derived, so not on the kernels line
    ex2_per_s = timing_stats["sfu"]["ex2"]["steps_per_s"]
    emit({"phase": "exp_floor_measured", "ex2_per_s": ex2_per_s,
          "serve_shape": timing["shape"],
          "serve_ms": timing["exponentials"] / ex2_per_s * 1e3,
          "train_shape": timing_train["shape"],
          "train_ms": timing_train["exponentials"] / ex2_per_s * 1e3})
    from vainplex_openclaw_tpu_torch.ops.flash_attention import launch_tiles

    fp32 = fp32_launches(forwarded, grad, mesh, ring, graft)
    tiles = {"serve": list(launch_tiles(64, 64, "bfloat16")),
             "long": list(launch_tiles(LONG_L, LONG_L, "bfloat16"))}
    emit({"kernels": [{
        "name": "flash_attention", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": served["launches"],
        "tiles": tiles, "search_winners": searched["winners"],
        "max_abs_err": worst, "ms": timing["kernel_ms"],
        "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"], "library_ms": timing["library_ms"],
        "launches_by_path": {
            "serve": served["launches"],
            "gateway": gateway["launches"],
            "serve_long": served_long["k1_launches"],
            "grad": grad["float32"]["k1_launches"]
            + grad["bfloat16"]["k1_launches"],
            "train": trained["k1_launches"],
            "train_moe": trained_moe["k1_launches"],
            "triage": triage["triage_k1_launches"],
            "embed": triage["embed_float32"]["k1_launches"]
            + triage["embed_bfloat16"]["k1_launches"],
            "mesh_default": mesh["default"]["launches"],
            "mesh_tp": mesh["tp"]["launches"],
            "mesh_pp": mesh["pp"]["launches"],
            "mesh_ep": mesh["ep"]["launches"],
            "embed_mesh": mesh["embed"]["launches"],
            "train_mesh": train_mesh["k1_launches"],
            "lifecycle": lifecycle["k1_launches"],
            "fleet": fleet["k1_launches"],
            "classify": classified["k1_launches"],
            "trace_analyzer": sum(traced[run]["card"]["k1_launches"]
                                  for run in TRACE_RUNS),
            "worker_profile": worker["k1_launches"],
            "cluster": cluster["k1_launches"],
            "knowledge": knowledge["k1_launches"],
            "governance_install": installed["k1_launches"],
            "chaos": chaos["train"]["k1_launches"]
            + chaos["trace"]["rerun"]["cuda"]["k1_launches"],
            "graft_entry": graft["entry"]["k1_launches"],
            **dryrun_launches(graft, "k1")},
        "entry_shape": {"shape": graft["entry"]["k1"]["shape"],
                        "launches": graft["entry"]["k1_launches"],
                        "ms": graft["entry"]["k1"]["kernel_ms"],
                        "bound_ms": graft["entry"]["k1"]["bound_ms"],
                        "bound_by": graft["entry"]["k1"]["bound_by"],
                        "plain_ms": graft["entry"]["k1"]["plain_ms"],
                        "library_ms": graft["entry"]["k1"]["library_ms"]},
        "trace_analyzer_shape": trace_k1_line(traced),
        "knowledge_sync_shape": {
            "shape": knowledge["k1_sync_shape"]["shape"],
            "launches_by_bucket": knowledge["k1_by_bucket"],
            **{k: knowledge["k1_sync_shape"][k] for k in (
                "kernel_ms", "bound_ms", "bound_by", "exp_floor_ms",
                "plain_ms", "library_ms")}},
        "dh8_shapes": dh8_line(graft, stats=False),
        "wide_shapes": wide_line(wide, stats=False),
        "fp32_walk_shapes": walk_line(wide, False, fp32["k1"]),
        "fp32_launches_by_path": fp32_by_path(fp32["k1"]),
        "shard_shapes": [
            {"path": path, "shape": t["shape"], "launches": launches,
             "ms": t["kernel_ms"], "bound_ms": t["bound_ms"],
             "bound_by": t["bound_by"], "plain_ms": t["plain_ms"],
             "library_ms": t["library_ms"]}
            for path, t, launches in (
                ("mesh_tp 2x2", mesh["timing"]["tp2_shard"],
                 mesh["tp"]["by_shape"]["2x2"]),
                ("mesh_pp", mesh["timing"]["pp_microbatch"],
                 mesh["pp"]["launches"]),
                ("train_mesh tiny_tp_2x2",
                 train_mesh["timing"]["dp_tp_shard"],
                 train_mesh["tiny_tp_2x2"]["float32"]["k1_launches_per_step"]
                 + train_mesh["tiny_tp_2x2"]["bfloat16"][
                     "k1_launches_per_step"]),
                ("train_mesh moe_ep_2x2", train_mesh["timing"]["dp_ep_row"],
                 train_mesh["moe_ep_2x2"]["float32"]["k1_launches_per_step"]
                 + train_mesh["moe_ep_2x2"]["bfloat16"][
                     "k1_launches_per_step"]))],
        "train_shape": {"shape": timing_train["shape"],
                        "launches": trained["k1_launches"],
                        "ms": timing_train["kernel_ms"],
                        "bound_ms": timing_train["bound_ms"],
                        "bound_by": timing_train["bound_by"],
                        "plain_ms": timing_train["plain_ms"],
                        "library_ms": timing_train["library_ms"],
                        "dense_backward_ms":
                            timing_train["dense_backward_ms"]},
        "long_shape": {"shape": timing_stats["shape"],
                       "launches": served_long["k1_launches"],
                       "ms": k1_long["kernel_ms"],
                       "bound_ms": k1_long["bound_ms"],
                       "bound_by": k1_long["bound_by"],
                       "plain_ms": k1_long["plain_ms"],
                       "library_ms": k1_long["library_ms"]}},
        {"name": "flash_attention_stats", "route": "cuda", "source": SOURCE,
         "replaces": REPLACES_STATS, "launches": served_long["launches"],
         "tiles": {"long": tiles["long"]},
         "max_abs_err": worst_stats, "ms": timing_stats["kernel_ms"],
         "plain_ms": timing_stats["plain_ms"],
         "bound_ms": timing_stats["bound_ms"],
         "bound_by": timing_stats["bound_by"], "library_ms": None,
         "sdpa_normalized_ms": timing_stats["sdpa_normalized_ms"],
         "launches_by_path": {"serve_long": served_long["launches"],
                              "long_moe": long_moe["k2_launches"],
                              **dryrun_launches(graft, "k2")},
         "dh8_shapes": dh8_line(graft, stats=True),
         "wide_shapes": wide_line(wide, stats=True),
         "fp32_walk_shapes": walk_line(wide, True, fp32["k2"]),
         "fp32_launches_by_path": fp32_by_path(fp32["k2"])},
        {"name": "levenshtein", "route": "cuda", "source": K3_SOURCE,
         "replaces": K3_REPLACES, "launches": similarity["k3_launches"],
         "max_abs_err": max(r["max_abs_err"] for r in
                            similarity["levenshtein"].values()),
         "ms": k3["kernel_ms"], "plain_ms": k3["plain_ms"],
         "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"],
         "library_ms": None, "shape": [4096, DETECTOR_LEN],
         "launches_by_path": {
             "similarity": similarity["k3_launches"],
             "trace_analyzer": sum(traced[run]["card"]["k3_launches"]
                                   for run in TRACE_RUNS),
             "worker_profile": worker["k3_launches"],
             "governance_install": installed["k3_launches"],
             "chaos": chaos["trace"]["rerun"]["cuda"]["k3_launches"]},
         "trace_analyzer_shape": trace_k3_line(traced),
         "dp_cell_bound_ms": k3["dp_cell_bound_ms"],
         "l128_shape": {"shape": [4096, SIM_LEN], "ms": k3_l128["kernel_ms"],
                        "plain_ms": k3_l128["plain_ms"],
                        "bound_ms": k3_l128["bound_ms"],
                        "bound_by": k3_l128["bound_by"],
                        "dp_cell_bound_ms": k3_l128["dp_cell_bound_ms"]},
         "legs": {name: {"launches": leg["k3_launches"],
                         "ms": leg["kernel_ms"], "bound_ms": leg["bound_ms"]}
                  for name, leg in similarity["levenshtein"].items()}}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
