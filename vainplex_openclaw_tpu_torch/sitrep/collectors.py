"""Sitrep collectors (reference: openclaw-sitrep/src/collectors/*).

A copy of ``vainplex_openclaw_tpu/sitrep/collectors.py`` under the same
names, kept here so the port imports nothing of the JAX package. Every
collector returns what the JAX package's returns on the same state; the
one that reads in-process state, ``collect_model_registry``, reads the
port's registry book (``models.registry.all_registries``), so a gateway
that serves from the port shows its registries, a fleet's
(``fleet:cluster.fleet``) among them, in ``/ops``.

Six reference built-ins — systemd_timers (shells out to systemctl), nats
(event-store status probe), goals, threads (reads Cortex threads.json),
errors (audit denials + hook errors), calendar — plus custom shell-command
collectors. Each runs through ``safe_collect`` so a broken collector
degrades to an error entry, never a crashed sitrep.

The port keeps the deprecated reference plugin as the system's OWN
observability plane with ops built-ins (and ``journal``):

- ``gateway`` — degraded plugins, tripped breakers, per-hook skip/error
  counters, admission-control shed counts (``Gateway.get_status``);
- ``stage_quantiles`` — p50/p95/p99 per stage for every StageTimer edge
  registered with the gateway;
- ``resilience`` — NATS outbox/replay/drop counters, torn-tail/quarantine
  counts, audit spill/flush failures;
- ``slo`` — threshold rollup: configured per-edge/per-stage p99 budgets
  compared against the live quantiles.
"""

from __future__ import annotations

import json
import subprocess
import time
from pathlib import Path
from typing import Callable

from ..storage.atomic import read_json, read_jsonl


def collect_systemd_timers(config: dict, ctx: dict) -> dict:
    try:
        proc = subprocess.run(
            ["systemctl", "list-timers", "--no-pager", "--no-legend"],
            capture_output=True, text=True, timeout=config.get("timeoutS", 5))
    except (OSError, subprocess.TimeoutExpired) as exc:
        return {"status": "error", "items": [], "summary": f"systemctl unavailable: {exc}"}
    items = []
    for line in proc.stdout.splitlines():
        parts = line.split()
        if len(parts) >= 2:
            items.append({"raw": line.strip(), "unit": next(
                (p for p in parts if p.endswith(".timer")), parts[-1])})
    return {"status": "ok", "items": items, "summary": f"{len(items)} timers"}


def collect_nats(config: dict, ctx: dict) -> dict:
    status_fn = ctx.get("eventstore_status")
    if status_fn is None:
        return {"status": "skipped", "items": [], "summary": "no event store wired"}
    s = status_fn()
    health = "ok" if s.get("healthy") else "warn"
    return {"status": health,
            "items": [s],
            "summary": (f"{s.get('transport', '?')} published={s.get('published', 0)} "
                        f"failures={s.get('publish_failures', 0)}")}


def collect_goals(config: dict, ctx: dict) -> dict:
    path = Path(config.get("path") or (Path(ctx.get("workspace", ".")) / "goals.json"))
    data = read_json(path)
    if data is None:
        return {"status": "skipped", "items": [], "summary": "no goals file"}
    goals = data.get("goals", data) if isinstance(data, dict) else data
    items = [g for g in goals if isinstance(g, dict)]
    open_goals = [g for g in items if g.get("status", "open") == "open"]
    return {"status": "ok", "items": items, "summary": f"{len(open_goals)} open goals"}


def collect_threads(config: dict, ctx: dict) -> dict:
    """Reads the Cortex threads.json directly — the suite's file-mediated
    cross-plugin convention."""
    workspace = Path(ctx.get("workspace", "."))
    data = read_json(workspace / "memory" / "reboot" / "threads.json")
    if not isinstance(data, dict):
        return {"status": "skipped", "items": [], "summary": "no thread data"}
    threads = data.get("threads") or []
    open_threads = [t for t in threads if t.get("status") == "open"]
    waiting = [t for t in open_threads if t.get("waiting_for")]
    return {"status": "warn" if waiting else "ok",
            "items": [{"title": t["title"], "priority": t.get("priority"),
                       "waiting_for": t.get("waiting_for")} for t in open_threads],
            "summary": f"{len(open_threads)} open ({len(waiting)} blocked)"}


def collect_errors(config: dict, ctx: dict) -> dict:
    workspace = Path(ctx.get("workspace", "."))
    audit_dir = workspace / "governance" / "audit"
    denials = []
    if audit_dir.exists():
        files = sorted(audit_dir.glob("*.jsonl"))[-2:]
        for f in files:
            for rec in read_jsonl(f):
                if rec.get("verdict") == "deny":
                    denials.append({"reason": rec.get("reason"),
                                    "tool": (rec.get("context") or {}).get("toolName")})
    status = "warn" if denials else "ok"
    return {"status": status, "items": denials[-20:],
            "summary": f"{len(denials)} recent policy denials"}


def collect_calendar(config: dict, ctx: dict) -> dict:
    path = config.get("path")
    if not path:
        return {"status": "skipped", "items": [], "summary": "no calendar configured"}
    data = read_json(path)
    events = (data or {}).get("events", []) if isinstance(data, dict) else (data or [])
    return {"status": "ok", "items": events[:20], "summary": f"{len(events)} events"}


# ── ops-plane collectors ──────────────────────────────────


def collect_gateway(config: dict, ctx: dict) -> dict:
    """Gateway health: degraded plugins, breakers, hook skip/error
    counters, and admission shed counts — the degradation surface on one pane
    of glass.

    Health reflects CURRENT conditions only (degraded plugins, tripped
    breakers, queue depth over the admission watermark) — those clear when
    the system recovers. Lifetime counters (hook errors, handler skips,
    total sheds) stay visible in the items/summary but never latch the
    report to warn forever over one long-past incident."""
    status_fn = ctx.get("gateway_status")
    if status_fn is None:
        return {"status": "skipped", "items": [], "summary": "no gateway wired"}
    s = status_fn()
    degraded = s.get("degraded") or []
    breakers = s.get("breakers") or {}
    hooks = s.get("hooks") or {}
    hook_errors = sum(h.get("errors", 0) for h in hooks.values())
    handler_skips = sum(h.get("skipped", 0) for h in hooks.values())
    adm = s.get("admission") or {}
    shed = adm.get("shed", 0)
    over_watermark = (adm.get("enabled")
                      and adm.get("queueDepth", 0) > adm.get("highWatermark", 0))
    # get_status lists any breaker with lifetime failures, including long-
    # recovered CLOSED ones — only a non-closed state is a CURRENT problem.
    tripped = [f"{pid}/{hook}"
               for pid, hooks_ in breakers.items()
               for hook, st in hooks_.items()
               if st.get("state") != "closed"]
    items = [{"plugins": s.get("plugins", []), "degraded": degraded,
              "breakers": breakers, "trippedBreakers": tripped,
              "hookErrors": hook_errors,
              "handlerSkips": handler_skips, "admission": adm}]
    worst = degraded or tripped or over_watermark
    return {"status": "warn" if worst else "ok",
            "items": items,
            "shed": shed,
            "summary": (f"{len(s.get('plugins', []))} plugins, "
                        f"{len(degraded)} degraded, {handler_skips} handler "
                        f"skips, {shed} shed, {hook_errors} hook errors"
                        + (", SHEDDING" if over_watermark else ""))}


def collect_stage_quantiles(config: dict, ctx: dict) -> dict:
    """p50/p95/p99 per stage for every registered StageTimer edge, read
    via ``snapshot()`` so ms/counts/quantiles per edge are torn-free."""
    timers_fn = ctx.get("stage_timers")
    if timers_fn is None:
        return {"status": "skipped", "items": [], "summary": "no gateway wired"}
    snaps = timers_fn()
    if not snaps:
        return {"status": "skipped", "items": [],
                "summary": "no stage timers registered"}
    items = []
    for edge in sorted(snaps):
        snap = snaps[edge]
        for stage, qd in snap["quantiles"].items():
            items.append({"edge": edge, "stage": stage,
                          "count": snap["counts"].get(stage, 0),
                          "totalMs": snap["stages_ms"].get(stage, 0.0),
                          **qd})
    return {"status": "ok", "items": items,
            "summary": f"{len(snaps)} edges, {len(items)} stages"}


def collect_resilience(config: dict, ctx: dict) -> dict:
    """Resilience counters in one place: event-transport outbox/replay/drop +
    torn-tail/quarantine, and governance audit spill/flush failures."""
    items = []
    worries = []
    es_fn = ctx.get("eventstore_status")
    if es_fn is not None:
        s = es_fn()
        row = {"source": "eventstore"}
        for key in ("outbox_len", "outbox_dropped", "replayed", "reconnects",
                    "corrupt_lines", "torn_tails", "quarantined_files",
                    "publish_failures"):
            if key in s:
                row[key] = s[key]
        items.append(row)
        for key in ("outbox_dropped", "corrupt_lines", "torn_tails",
                    "quarantined_files"):
            if row.get(key):
                worries.append(f"{key}={row[key]}")
    gov_fn = ctx.get("governance_status")
    if gov_fn is not None:
        audit = (gov_fn() or {}).get("audit") or {}
        row = {"source": "audit", **audit}
        items.append(row)
        for key in ("spilled", "flushFailures"):
            if audit.get(key):
                worries.append(f"audit.{key}={audit[key]}")
    if not items:
        return {"status": "skipped", "items": [],
                "summary": "no resilience surfaces wired"}
    return {"status": "warn" if worries else "ok", "items": items,
            "summary": (", ".join(worries) if worries
                        else f"{len(items)} surfaces clean")}


def collect_journal(config: dict, ctx: dict) -> dict:
    """Group-commit journal health: pending/uncompacted records,
    commit group sizes, fsync + compaction counters, spill/replay/repair
    visibility per registered journal. Warns on CURRENT backlog or any
    counted loss/damage signal (spills, commit/compaction failures, replay
    repairs) — a repaired torn tail must be seen, not silently absorbed."""
    status_fn = ctx.get("gateway_status")
    if status_fn is None:
        return {"status": "skipped", "items": [], "summary": "no gateway wired"}
    journals = (status_fn() or {}).get("journal") or {}
    if not journals:
        return {"status": "skipped", "items": [],
                "summary": "no journals registered"}
    items = []
    worries = []
    for name in sorted(journals):
        s = journals[name]
        replay = s.get("replay") or {}
        items.append({"name": name, "fsync": s.get("fsync"),
                      "pending": s.get("pendingRecords", 0),
                      "uncompacted": s.get("uncompactedRecords", 0),
                      "commits": s.get("commits", 0),
                      "avgGroupSize": s.get("avgGroupSize", 0.0),
                      "fsyncs": s.get("fsyncs", 0),
                      "compactions": s.get("compactions", 0),
                      "rotations": s.get("rotations", 0),
                      "spilled": s.get("spilled", 0),
                      "commitFailures": s.get("commitFailures", 0),
                      "compactionFailures": s.get("compactionFailures", 0),
                      "replay": replay,
                      "walBytes": s.get("walBytes", 0),
                      "lastError": s.get("lastError")})
        for key in ("spilled", "commitFailures", "compactionFailures",
                    "fsyncFailures"):
            if s.get(key):
                worries.append(f"{name}.{key}={s[key]}")
        for key in ("torn_tails", "corrupt_lines", "read_errors"):
            if replay.get(key):
                worries.append(f"{name}.replay.{key}={replay[key]}")
    total_pending = sum(i["pending"] + i["uncompacted"] for i in items)
    return {"status": "warn" if worries else "ok", "items": items,
            "summary": (", ".join(worries) if worries else
                        f"{len(items)} journals clean, "
                        f"{total_pending} records in flight")}


def collect_cluster(config: dict, ctx: dict) -> dict:
    """Sharded-gateway health: membership, per-worker
    liveness/breaker state/heartbeat misses, lease epochs, the last
    failover AND the last planned handoff, plus the route log's transport
    kind/health. Warns on any fencing rejection (a zombie tried to write —
    the fence held, but an operator should know a partitioned worker is
    still running), on any worker not closed (dead, OR a breaker
    half-open/open), and on a degraded route log (unhealthy transport,
    backed-up outbox, open/half-open breaker — a degraded schedule narrows
    redelivery coverage, which matters BEFORE the next failover needs
    it)."""
    status_fn = ctx.get("cluster_status")
    if status_fn is None:
        return {"status": "skipped", "items": [],
                "summary": "no cluster wired (single-process gateway)"}
    s = status_fn()
    workers = s.get("workers") or {}
    membership = s.get("membership") or {}
    dead = membership.get("dead") or []
    fenced = s.get("fencedRecords") or 0
    unhealthy = [wid for wid, row in workers.items()
                 if (row.get("breaker") or {}).get("state", "closed")
                 != "closed"]
    last = s.get("lastFailover")
    last_handoff = s.get("lastHandoff")
    route_log = s.get("routeLog") or {}
    worries = []
    if fenced:
        worries.append(f"fencedRecords={fenced}")
    for wid in unhealthy:
        worries.append(
            f"{wid}.breaker={(workers[wid].get('breaker') or {}).get('state')}")
    if dead:
        worries.append(f"dead={dead}")
    if route_log:
        rl_kind = route_log.get("kind", "?")
        if route_log.get("healthy") is False:
            worries.append(f"routeLog({rl_kind}) unhealthy")
        if route_log.get("outboxDepth"):
            worries.append(
                f"routeLog outbox={route_log.get('outboxDepth')}")
        rl_breaker = route_log.get("breaker")
        if rl_breaker and rl_breaker != "closed":
            worries.append(f"routeLog breaker={rl_breaker}")
    epochs = {ws: lease.get("epoch")
              for ws, lease in (s.get("leases") or {}).items()}
    # Replica-fleet panel: per-worker replica health, mesh
    # config, bucket-window occupancy, and the autoscaler's last decision
    # WITH its reason — every scale event must be explainable from /ops.
    # Warns only on CURRENT conditions: replicas dead right now (corpses
    # pending respawn) and an SLO breach in the live p99 window — retired
    # replicas are history, not a worry.
    fleet = s.get("fleet") or {}
    fleet_panel = None
    if fleet:
        freps = fleet.get("replicas") or {}
        by_worker: dict = {}
        for rid, row in freps.items():
            by_worker.setdefault(row.get("worker"), []).append(
                {"rid": rid, "alive": row.get("alive"),
                 "pending": row.get("pending"),
                 "windowOpen": row.get("windowOpen"),
                 "maxBatch": row.get("maxBatch"),
                 "mesh": row.get("mesh"),
                 "meanBatch": row.get("meanBatch")})
        auto = fleet.get("autoscaler") or {}
        fleet_panel = {
            "byWorker": {w: rows for w, rows in sorted(by_worker.items())},
            "membership": fleet.get("membership"),
            "openWindows": sum(1 for r in freps.values()
                               if r.get("windowOpen")),
            "p99Ms": fleet.get("p99Ms"),
            "p99BudgetMs": fleet.get("p99BudgetMs"),
            "sloBreached": fleet.get("sloBreached"),
            "autoscaler": {"enabled": auto.get("enabled"),
                           "cooldown": auto.get("cooldown"),
                           "lastDecision": auto.get("lastDecision")},
            "served": fleet.get("served"), "shed": fleet.get("shed"),
            "redelivered": fleet.get("redelivered"),
            "inflight": fleet.get("inflight"),
            "watermark": fleet.get("watermark"),
            "lastFailover": fleet.get("lastFailover")}
        fdead = (fleet.get("membership") or {}).get("dead") or []
        if fdead:
            worries.append(f"fleet.dead={fdead}")
        if fleet.get("sloBreached"):
            worries.append(
                f"fleet p99 {fleet.get('p99Ms')}ms over budget "
                f"{fleet.get('p99BudgetMs')}ms")
    items = [{"membership": membership, "workers": workers,
              "leaseEpochs": epochs, "lastFailover": last,
              "lastHandoff": last_handoff,
              "handoffAborts": s.get("handoffAborts"),
              "ingressShed": s.get("ingressShed"),
              "admission": s.get("admission"),
              "routed": s.get("routed"), "redelivered": s.get("redelivered"),
              "routeFaults": s.get("routeFaults"),
              "inflight": s.get("inflight"),
              "fencedRecords": fenced, "routeLog": route_log,
              "fleet": fleet_panel}]
    live = membership.get("live") or []
    summary = (f"{len(live)} live / {len(dead)} dead workers, "
               f"{len(epochs)} leases, routed={s.get('routed', 0)}")
    if route_log.get("kind"):
        summary += f", routeLog={route_log['kind']}"
    if last:
        summary += (f", last failover: {last.get('worker')} "
                    f"({last.get('workspacesMoved')} ws, "
                    f"{last.get('replayedRecords')} replayed, "
                    f"{last.get('durationMs')}ms)")
    if last_handoff:
        summary += (f", last handoff: {last_handoff.get('ws')} "
                    f"{last_handoff.get('from')}→{last_handoff.get('to')} "
                    f"({last_handoff.get('replayedRecords')} replayed, "
                    f"{last_handoff.get('durationMs')}ms)")
    if fleet_panel is not None:
        n_alive = len((fleet_panel.get("membership") or {}).get("alive")
                      or [])
        summary += (f", fleet: {n_alive} replicas "
                    f"({fleet_panel['openWindows']} windows open), "
                    f"served={fleet_panel.get('served', 0)}")
        decision = (fleet_panel.get("autoscaler") or {}).get("lastDecision")
        if decision:
            summary += (f", autoscaler: {decision.get('action')} "
                        f"({decision.get('reason')})")
    if worries:
        summary += " — " + ", ".join(worries)
    return {"status": "warn" if worries else "ok", "items": items,
            "summary": summary}


def collect_lifecycle(config: dict, ctx: dict) -> dict:
    """Workspace lifecycle health: resident/hibernated counts,
    wake quantiles and eviction counters per registered LifecycleManager,
    plus the per-journal tiering view (cold segments/bytes, demote
    backlog, ship counters). Warns ONLY on current conditions — a
    non-empty demote backlog is the one live signal that the tier is
    falling behind. Lifetime counters (wakes, evictions, hibernate/
    demote/ship failures) stay visible in the items and summary but never
    latch the report to warn forever over one long-past incident — the
    same rule collect_gateway applies to its error counters."""
    status_fn = ctx.get("gateway_status")
    if status_fn is None:
        return {"status": "skipped", "items": [], "summary": "no gateway wired"}
    s = status_fn() or {}
    managers = s.get("lifecycle") or {}
    journals = s.get("journal") or {}
    tiers = {name: (j.get("lifecycle") or {})
             for name, j in journals.items() if j.get("lifecycle")}
    if not managers and not tiers:
        return {"status": "skipped", "items": [],
                "summary": "no lifecycle managers registered"}
    items = []
    worries = []
    resident = hibernated = wakes = 0
    wake_p99 = None
    for name in sorted(managers):
        m = managers[name]
        items.append({"manager": name, **m})
        resident += m.get("resident", 0)
        hibernated += m.get("hibernated", 0)
        wakes += m.get("wakes", 0)
        if m.get("wakeP99Ms") is not None:
            wake_p99 = max(wake_p99 or 0.0, m["wakeP99Ms"])
    cold_segments = cold_bytes = backlog = 0
    failures = 0
    for name in sorted(tiers):
        t = tiers[name]
        items.append({"journal": name, **t})
        cold_segments += t.get("coldSegments", 0)
        cold_bytes += t.get("coldBytes", 0)
        backlog += t.get("demoteBacklog", 0)
        failures += (t.get("demoteFailures", 0) or 0) + \
            (t.get("shipFailures", 0) or 0)
        if t.get("demoteBacklog"):
            worries.append(f"{name}.demoteBacklog={t['demoteBacklog']}")
    summary = (f"{resident} resident / {hibernated} hibernated, "
               f"{wakes} wakes"
               + (f" (p99 {wake_p99}ms)" if wake_p99 is not None else "")
               + f", tier: {cold_segments} cold segments "
                 f"({cold_bytes} B)")
    if failures:
        summary += f", {failures} lifetime ship/demote failures"
    if worries:
        summary += " — " + ", ".join(worries)
    return {"status": "warn" if worries else "ok", "items": items,
            "summary": summary}


def _adversarial_line(config: dict, ctx: dict):
    """Last adversarial-pack run, from the state file the
    adversarial runner drops in the workspace. Returns ``(info, warn)`` —
    ``info`` is None when no run has been recorded. Any verdict loss,
    false block, or busted isolation budget warns: an attack the rig did
    not survive is a standing condition until rerun clean."""
    ws = ctx.get("workspace")
    if not ws:
        return None, False
    from ..slo.adversarial import read_adversarial_state
    state = read_adversarial_state(ws, config.get("adversarial"))
    if state is None:
        return None, False
    packs = ",".join(state.get("packs") or []) or "none"
    survived = bool(state.get("survived"))
    line = (f"adversarial: {packs} (seed {state.get('seed')}) — "
            f"{state.get('attackOps', 0)} attack ops, "
            + ("survived" if survived else "FAILED"))
    if state.get("verdictLosses", 0) or state.get("falseBlocks", 0):
        line += (f", {state.get('verdictLosses', 0)} verdict losses, "
                 f"{state.get('falseBlocks', 0)} false blocks")
    if state.get("victimP99Ms") is not None:
        line += (f", victim p99 {state['victimP99Ms']}ms = "
                 f"{state.get('victimP99Factor')}x vs "
                 f"{state.get('victimBudgetFactor')}x budget")
    info = dict(state)
    info["line"] = line
    return info, not survived


def _with_adversarial(result: dict, config: dict, ctx: dict) -> dict:
    adv, warn = _adversarial_line(config, ctx)
    if adv is not None:
        result["adversarial"] = adv
        result["summary"] += f"; {adv['line']}"
        if warn and result["status"] != "error":
            result["status"] = "warn"
    return result


def collect_slo(config: dict, ctx: dict) -> dict:
    """SLO-threshold rollup: p99 budgets (ms) from config against live
    stage quantiles. Keys: ``"edge:stage"`` beats ``"edge"`` beats
    ``defaultP99Ms``. A breach warns; a breach past 2× its budget errors
    (the rollup drives the report's headline health). When the workspace
    carries an adversarial-run state file the result gains an
    ``adversarial`` line — rendered even on the skipped paths, since the
    last attack run's verdict doesn't need a live gateway to matter."""
    timers_fn = ctx.get("stage_timers")
    if timers_fn is None:
        return _with_adversarial(
            {"status": "skipped", "items": [], "summary": "no gateway wired"},
            config, ctx)
    thresholds = config.get("p99Ms") or {}
    default = config.get("defaultP99Ms")
    snaps = timers_fn()
    if not snaps:
        # Same condition, same verdict as collect_stage_quantiles: an
        # "ok" here would imply budgets were validated when none could be.
        return _with_adversarial(
            {"status": "skipped", "items": [],
             "summary": "no stage timers registered"}, config, ctx)
    checked = 0
    breaches = []
    hard = False
    for edge in sorted(snaps):
        for stage, qd in snaps[edge]["quantiles"].items():
            budget = thresholds.get(f"{edge}:{stage}",
                                    thresholds.get(edge, default))
            if budget is None:
                continue
            checked += 1
            p99 = qd.get("p99")
            if p99 is not None and p99 > budget:
                breaches.append({"edge": edge, "stage": stage,
                                 "p99Ms": p99, "budgetMs": budget})
                hard = hard or p99 > 2 * budget
    status = "error" if hard else ("warn" if breaches else "ok")
    return _with_adversarial(
        {"status": status, "items": breaches,
         "summary": f"{checked} SLOs checked, {len(breaches)} breached"},
        config, ctx)


def collect_pattern_safety(config: dict, ctx: dict) -> dict:
    """ReDoS screening rollup: patterns demoted to their
    interpreter paths by EITHER screened surface — the governance planner
    (policy regexes) or cortex MergedPatterns (builtin/custom message
    patterns). Demotion preserves verdicts/matches, but a demoted pattern
    is a loaded pathological regex an operator should replace — it warns
    for as long as it is loaded (unlike lifetime counters, this IS a
    current condition)."""
    gov_fn = ctx.get("governance_status")
    cortex_fn = ctx.get("cortex_pattern_safety")
    if gov_fn is None and cortex_fn is None:
        return {"status": "skipped", "items": [],
                "summary": "no screened surface wired"}
    items = []
    checked = False
    if gov_fn is not None:
        ps = (gov_fn() or {}).get("patternSafety") or {}
        checked = checked or bool(ps.get("checked"))
        items += [{**e, "source": "governance"}
                  for e in ps.get("unsafePatterns") or []]
    if cortex_fn is not None:
        checked = True
        items += [{**e, "source": "cortex"} for e in cortex_fn() or []]
    if not checked:
        return {"status": "skipped", "items": [],
                "summary": "interpreter mode: nothing compiled to screen"}
    return {"status": "warn" if items else "ok",
            "items": items,
            "summary": (f"{len(items)} unsafe pattern(s) demoted to "
                        f"interpreter path" if items
                        else "all compiled patterns screened clean")}


def collect_model_registry(config: dict, ctx: dict) -> dict:
    """Versioned serving health: per-registry version book
    (active/previous/canary/pins), swap + rollback + promotion counters,
    and the weight-paging view (resident vs paged versions, wake
    quantiles). In-process and I/O-free — registries self-register by
    name (the port's models/registry.all_registries), exactly like the
    gateway's StageTimer book. Warns only on a live condition: a canary armed with
    a zero fraction serves nobody — a rollout someone forgot to open."""
    from ..models.registry import all_registries

    registries = all_registries()
    if not registries:
        return {"status": "skipped", "items": [],
                "summary": "no model registries registered"}
    items = []
    worries = []
    versions = swaps = paged = 0
    for name in sorted(registries):
        s = registries[name].stats()
        items.append({"registry": name, **s})
        versions += len(s.get("versions") or {})
        swaps += s.get("swaps", 0)
        paged += len((s.get("paging") or {}).get("paged") or [])
        canary = s.get("canary") or {}
        if canary.get("version") and not canary.get("fraction"):
            worries.append(f"{name}: canary {canary['version']} armed at "
                           "fraction 0 (serves no traffic)")
    summary = (f"{len(items)} registr{'y' if len(items) == 1 else 'ies'}, "
               f"{versions} version(s), {swaps} swap(s), {paged} paged")
    if worries:
        return {"status": "warn", "items": items,
                "summary": summary + "; " + "; ".join(worries)}
    return {"status": "ok", "items": items, "summary": summary}


BUILTIN_COLLECTORS: dict[str, Callable] = {
    "systemd_timers": collect_systemd_timers,
    "nats": collect_nats,
    "goals": collect_goals,
    "threads": collect_threads,
    "errors": collect_errors,
    "calendar": collect_calendar,
    "gateway": collect_gateway,
    "stage_quantiles": collect_stage_quantiles,
    "resilience": collect_resilience,
    "journal": collect_journal,
    "cluster": collect_cluster,
    "lifecycle": collect_lifecycle,
    "slo": collect_slo,
    "pattern_safety": collect_pattern_safety,
    "model_registry": collect_model_registry,
}


def run_custom_collector(definition: dict, timeout_s: float = 10.0) -> dict:
    proc = subprocess.run(definition["command"], shell=True, capture_output=True,
                          text=True, timeout=definition.get("timeoutS", timeout_s))
    output = proc.stdout.strip()
    try:
        items = json.loads(output)
        if not isinstance(items, list):
            items = [items]
    except json.JSONDecodeError:
        items = [{"raw": line} for line in output.splitlines()[:20]]
    status = "ok" if proc.returncode == 0 else "error"
    return {"status": status, "items": items,
            "summary": f"exit={proc.returncode}, {len(items)} items"}


def safe_collect(name: str, fn: Callable, config: dict, ctx: dict, logger) -> dict:
    if not config.get("enabled", False):
        return {"status": "skipped", "items": [], "summary": "disabled", "duration_ms": 0}
    start = time.perf_counter()
    try:
        result = fn(config, ctx)
    except Exception as exc:  # noqa: BLE001 — one collector must not kill the sitrep
        logger.warn(f"collector {name} failed: {exc}")
        result = {"status": "error", "items": [], "summary": f"error: {exc}",
                  "error": str(exc)}
    result["duration_ms"] = round((time.perf_counter() - start) * 1000, 2)
    return result
