"""Seeded adversarial workload packs on the soak rig.

The port's copy of ``vainplex_openclaw_tpu/slo/adversarial.py``, kept here
so the port imports nothing of the JAX package; in sim mode a report is
equal to the JAX package's.

The SLO harness proves graceful degradation under *friendly* overload;
this module drives hostile and degenerate traffic through the SAME
machinery. Every pack is an ordinary list of :class:`..slo.workload.Op` —
it rides the existing harness, admission controller and gateway paths
unchanged — and every pack is a pure function of its seed
(``random.Random(f"adv:{pack}:{seed}")``), so a run is a replayable
artifact: same seed, same workload digest, and in sim mode the same report
bit for bit.

Five shipped packs:

- ``redos_storm`` — ``analysis/redos.py``'s screen run in reverse.
  Near-miss pump probes (``stress_inputs``) for every SHIPPED pattern
  (cortex language packs, base moods, builtin-policy regexes — all
  screened clean), plus the exponential attack strings
  (``worst_case_inputs``) of a corpus of classic catastrophic patterns
  the screen demotes. The demoted patterns never reach the hot path, so
  their pump payloads land as plain message content — the storm proves
  the demotion screen's linearity guarantee under fire: no policy-match
  stage p99 blowup vs the friendly baseline.
- ``credential_stuffing`` — dense bursts of credential-shaped tool calls
  against the governance guard, salted with legitimate reads so the gate
  pins zero false blocks alongside zero missed denials.
- ``unicode_pathology`` — İ/ı and Σ/ς/σ case-fold edges, emoji ZWJ
  floods, combining-mark floods, non-BMP math alphanumerics, and
  MB-scale single messages that clear the long-context routing
  threshold.
- ``fence_thrash`` — zombie writers holding stale lease epochs, replayed
  against a thrashing fence through the real :class:`..storage.Journal`
  commit-time fence check. Every write must be rejected, counted, and
  leave the committed snapshot byte-identical.
- ``tenant_skew`` — one tenant offering ``skewFactor``× its fair share
  inside a contiguous window, gated on *victim-tenant* p99 isolation
  (deterministic sim A/B vs a no-attack control), not global p99.

``run_adversarial_report`` and ``run_redos_stage_gate`` take ``device``
(None = the card), which goes to the knowledge plugin of the harness's
gateways.
"""

from __future__ import annotations

import json
import random
from pathlib import Path

from ..device import DeviceLike
from .workload import (ALL_LANGS, DENIED_PATHS, SAFE_PATHS, Op, _message,
                       _pick_kind, generate_workload, workload_digest)

# Every knob the adversarial plane reads, in one place.
ADVERSARIAL_DEFAULTS = {
    "packs": ("redos_storm", "credential_stuffing", "unicode_pathology",
              "fence_thrash", "tenant_skew"),
    "attackShare": 0.30,            # fraction of ops that are attack ops
    "attackTenant": 0,              # the tenant the skew attacker rides
    "skewFactor": 100.0,            # offered rate vs per-tenant fair share
    "victimP99FactorBudget": 3.0,   # victim p99 vs no-attack control (sim)
    "redosP99FactorBudget": 5.0,    # match-stage p99 vs friendly (wall)
    "pumpLength": 48,               # ReDoS pump repetitions per probe
    "probeMaxChars": 4096,          # cap per storm message
    "zwjFloodLen": 192,             # emoji ZWJ flood sequence count
    "megaMessageBytes": 1 << 20,    # MB-scale single message (UTF-8 bytes)
    "megaMessages": 2,              # how many of them per run
    "fenceEpochLag": 3,             # zombies trail the fence ≤ this many epochs
    "stateFile": ".adversarial.json",  # sitrep handoff artifact
}

# Classic catastrophic shapes standing in for operator-supplied patterns:
# the screen must flag every one (tests pin it), so they are demoted at
# compile time and their attack strings hit the serving path as inert
# message bodies.
DEMOTED_PATTERN_CORPUS = (
    r"(a+)+$",
    r"(?:\s*x?)+y",
    r"(a|aa)+b",
    r"([a-z]+)*d",
    r"(?:ab|a.)+z",
)

_ZOMBIE_KIND = "zombie_write"


def shipped_patterns() -> list:
    """Every (pattern, flags) the repo ships on the hot match path: cortex
    language packs + base moods + builtin governance policies — the same
    enumeration ``analysis.default_pack_findings`` screens, so the storm
    and the lint can't cover different pattern sets."""
    out: list = []
    from ..cortex.patterns import BASE_MOODS, PACKS
    for pack in PACKS.values():
        for attr in ("decision", "close", "wait", "topic"):
            for pattern in getattr(pack, attr):
                out.append((pattern, pack.flags))
        for pattern in pack.moods.values():
            out.append((pattern, pack.flags))
    for pattern in BASE_MOODS.values():
        out.append((pattern, 0))
    from ..analysis import _builtin_policies
    from ..governance.policy_plan import iter_policy_patterns
    for policy in _builtin_policies():
        for pattern in iter_policy_patterns(policy):
            out.append((pattern, 0))
    return out


def _redos_probes(cfg: dict) -> list:
    """Deterministic probe corpus: linear stress probes for every shipped
    (screened-clean) pattern + exponential pumps for the demoted corpus."""
    from ..analysis.redos import pattern_safe, stress_inputs, worst_case_inputs

    pump = int(cfg["pumpLength"])
    probes: set = set()
    for pattern, flags in shipped_patterns():
        if pattern_safe(pattern, flags):
            probes.update(stress_inputs(pattern, flags, pump=pump))
        # An unsafe shipped pattern is demoted off the hot path —
        # nothing to probe here.
    for pattern in DEMOTED_PATTERN_CORPUS:
        probes.update(worst_case_inputs(pattern, pump=pump))
    cap = int(cfg["probeMaxChars"])
    return sorted(p[:cap] for p in probes)


def _pack_redos_storm(rng: random.Random, n: int, tenants: int,
                      span: float, cfg: dict) -> list:
    probes = _redos_probes(cfg)
    ops = []
    for _ in range(n):
        content = probes[rng.randrange(len(probes))]
        kind = "msg_in" if rng.random() < 0.7 else "msg_out"
        ops.append(Op(0, rng.random() * span, rng.randrange(tenants), kind,
                      "en", content, pack="redos_storm"))
    return ops


def _pack_credential_stuffing(rng: random.Random, n: int, tenants: int,
                              span: float, cfg: dict) -> list:
    """Burst-shaped guard hammering. Every hostile path provably matches
    the builtin credential guard (``\\.(env|pem|key)$`` or a
    credentials/secrets segment) — a path the guard ignored would surface
    as a verdict loss, which is exactly the gate."""
    ops = []
    t = rng.random() * span * 0.05
    made = 0
    while made < n:
        burst = min(n - made, rng.randint(6, 18))
        for _ in range(burst):
            tok = f"{rng.randrange(1_000_000):06d}"
            r = rng.random()
            if r < 0.78:
                kind = "tool_denied"
                content = rng.choice((
                    f"creds/{tok}.env", f"keys/{tok}.pem",
                    f"deploy/{tok}.key", f"vault/credentials-{tok}.json",
                    f"secrets/{tok}.txt", rng.choice(DENIED_PATHS)))
            elif r < 0.92:
                kind = "tool_ok"      # legitimate read under fire:
                content = rng.choice(SAFE_PATHS)  # the false-block probe
            else:
                kind = "tool_secret"
                content = f"export API_KEY=sk-{tok}{'b' * 16}"
            ops.append(Op(0, t % span, rng.randrange(tenants), kind, "en",
                          content, pack="credential_stuffing"))
            t += rng.expovariate(1.0) * 0.02   # inside a burst: ~50x rate
            made += 1
        t += rng.expovariate(1.0) * max(span / 40.0, 0.5)
    return ops


def _pack_unicode_pathology(rng: random.Random, n: int, tenants: int,
                            span: float, cfg: dict) -> list:
    zwj = int(cfg["zwjFloodLen"])
    mega_bytes = int(cfg["megaMessageBytes"])
    mega_n = min(int(cfg["megaMessages"]), n)
    builders = (
        lambda r: "İstanbul İIıi naïve ﬁt " * (8 + r.randrange(24)),
        lambda r: "ΣΊΣΥΦΟΣ ςσΣ ΒΑΣΙΛΕΥΣ " * (8 + r.randrange(24)),
        lambda r: "👩‍💻" * (zwj // 2) + "🏳️‍🌈" * (zwj // 2),
        lambda r: "ẞßss Maße MASSE " * (8 + r.randrange(24)),
        lambda r: "e" + "́" * (64 + r.randrange(zwj)),
        lambda r: "𝕬𝖇𝖈𝖉𝖊 " * (16 + r.randrange(32)),
        lambda r: ("‮" + "אבגד ابجد " * (8 + r.randrange(16))),
    )
    ops = []
    for i in range(n):
        if i < mega_n:
            # MB-scale single message: non-BMP chars, 4 UTF-8 bytes each —
            # far past the longContext.thresholdTokens routing knee.
            content = "𝖆" * (mega_bytes // 4)
        else:
            content = builders[rng.randrange(len(builders))](rng)
        ops.append(Op(0, rng.random() * span, rng.randrange(tenants),
                      "msg_in", "en", content, pack="unicode_pathology"))
    return ops


def _pack_fence_thrash(rng: random.Random, n: int, tenants: int,
                       span: float, cfg: dict) -> list:
    lag = max(1, int(cfg["fenceEpochLag"]))
    ops = []
    for _ in range(n):
        payload = {"lag": 1 + rng.randrange(lag),
                   "records": 1 + rng.randrange(3)}
        ops.append(Op(0, rng.random() * span, rng.randrange(tenants),
                      _ZOMBIE_KIND, "en",
                      json.dumps(payload, sort_keys=True,
                                 separators=(",", ":")),
                      pack="fence_thrash"))
    return ops


def _pack_tenant_skew(rng: random.Random, n: int, tenants: int,
                      span: float, cfg: dict) -> list:
    """One tenant at ``skewFactor``× its fair share: the friendly workload
    offers ~1 op per unit time across ``tenants`` tenants, so fair share is
    ``1/tenants`` — the attacker arrives at ``skewFactor/tenants`` inside a
    contiguous window. Victims keep their normal mix; the gate reads THEIR
    p99."""
    attacker = int(cfg["attackTenant"]) % max(tenants, 1)
    rate = float(cfg["skewFactor"]) / max(tenants, 1)
    window = n / max(rate, 1e-9)
    start = rng.random() * max(span - window, 0.0)
    ops = []
    t = start
    for i in range(n):
        t += rng.expovariate(rate)
        kind = _pick_kind(rng.random())
        lang = rng.choice(ALL_LANGS)
        if kind in ("msg_in", "msg_out"):
            content = _message(rng, lang, i)
        elif kind == "tool_ok":
            content = rng.choice(SAFE_PATHS)
        elif kind == "tool_denied":
            content = rng.choice(DENIED_PATHS)
        else:
            content = f"export API_KEY=sk-{'c' * 20}{i % 10}"
        ops.append(Op(0, t, attacker, kind, lang, content,
                      pack="tenant_skew"))
    return ops


PACK_GENERATORS = {
    "redos_storm": _pack_redos_storm,
    "credential_stuffing": _pack_credential_stuffing,
    "unicode_pathology": _pack_unicode_pathology,
    "fence_thrash": _pack_fence_thrash,
    "tenant_skew": _pack_tenant_skew,
}


def adversarial_config(config: dict = None) -> dict:
    cfg = dict(ADVERSARIAL_DEFAULTS)
    cfg.update(config or {})
    return cfg


def generate_adversarial_workload(seed: int = 0, n_ops: int = 2000,
                                  tenants: int = 4, packs=None,
                                  config: dict = None) -> list:
    """Friendly background + interleaved attack ops, merged by arrival and
    re-indexed. Pure function of (seed, args): the friendly component is
    ``generate_workload(seed, …)`` verbatim, each pack draws from its own
    ``adv:<pack>:<seed>`` stream, and the merge is a stable sort — the
    bit-reproducibility contract ``workload_digest`` checksums."""
    cfg = adversarial_config(config)
    names = tuple(packs) if packs is not None else tuple(cfg["packs"])
    for name in names:
        if name not in PACK_GENERATORS:
            raise ValueError(f"unknown adversarial pack {name!r} "
                             f"(have {sorted(PACK_GENERATORS)})")
    share = min(max(float(cfg["attackShare"]), 0.0), 0.9)
    n_attack = int(n_ops * share) if names else 0
    n_attack = max(n_attack, len(names)) if names else 0
    n_friendly = max(1, n_ops - n_attack)
    friendly = generate_workload(seed, n_friendly, tenants)
    span = friendly[-1].arrival if friendly else float(n_friendly)
    per, extra = divmod(n_attack, len(names)) if names else (0, 0)
    attack: list = []
    for j, name in enumerate(names):
        count = per + (1 if j < extra else 0)
        rng = random.Random(f"adv:{name}:{seed}")
        attack.extend(PACK_GENERATORS[name](rng, count, tenants, span, cfg))
    merged = sorted(friendly + attack, key=lambda op: op.arrival)
    for i, op in enumerate(merged):
        op.index = i
    return merged


def unicode_pressure(ops, threshold_tokens: int = 1024) -> dict:
    """Deterministic workload-side statistics for the unicode pack: how
    many messages would clear the long-context routing threshold
    under a conservative ≥1 token per 4 chars estimate."""
    sizes = [len(op.content) for op in ops
             if getattr(op, "pack", "") == "unicode_pathology"]
    eligible = sum(1 for s in sizes if s // 4 >= int(threshold_tokens))
    return {"ops": len(sizes),
            "maxMessageChars": max(sizes, default=0),
            "thresholdTokens": int(threshold_tokens),
            "longRouteEligible": eligible}


class FenceArena:
    """The fence_thrash pack's target: a workspace whose fence keeps
    advancing while zombie journals hold stale epochs — the partitioned
    old-owner regime the cluster lease path must always reject.

    Per zombie op: the fence ratchets to a new epoch (the thrash), a
    fresh :class:`Journal` pins the PREVIOUS-lag epoch, appends, and must
    see ``commit() is False`` + the batch counted in ``fencedRecords``, a
    follow-up append die with :class:`FencedWriteError`, ``compact()``
    refused, and the legitimately-committed snapshot byte-identical.
    ``stats()`` is FS-free (the harness tempdir is gone by report time):
    every check happens inside :meth:`handle`."""

    def __init__(self, root: Path, cfg: dict = None):
        from ..cluster.ring import FENCE_FILE
        from ..storage.atomic import write_json_atomic
        from ..storage.journal import Journal

        self._cfg = adversarial_config(cfg)
        self.ws = Path(root) / "fence-arena"
        self.ws.mkdir(parents=True, exist_ok=True)
        self._fence_file = self.ws / FENCE_FILE
        self._state_file = self.ws / "state.json"
        self._journal_cfg = {"maxBatchRecords": 1_000_000, "windowMs": 0.0}
        self.epoch = 1
        self.attempts = 0          # zombie append attempts (records)
        self.writes = 0            # zombie ops replayed
        self.rejected = 0          # ops fully fenced out
        self.anomalies: list = []  # any accept/miscount — must stay empty
        write_json_atomic(self._fence_file,
                          {"epoch": self.epoch, "owner": "sup",
                           "grantedAt": 0.0}, indent=None, durable=True)
        owner = Journal(self.ws / "journal", self._journal_cfg, wall=False)
        owner.register_snapshot("arena:state", self._state_file, indent=None)
        owner.set_fence(self._fence_file, self.epoch)
        owner.append("arena:state", {"verdicts": 7, "owner": "legit"})
        if not owner.commit():
            self.anomalies.append("baseline commit failed")
        owner.close()
        self._baseline = self._state_file.read_bytes()

    def handle(self, op) -> None:
        from ..storage.atomic import write_json_atomic
        from ..storage.journal import FencedWriteError, Journal

        payload = json.loads(op.content)
        lag = max(1, int(payload.get("lag", 1)))
        records = max(1, int(payload.get("records", 1)))
        # The thrash: the legitimate owner re-granted — fence moves on.
        self.epoch += 1
        write_json_atomic(self._fence_file,
                          {"epoch": self.epoch, "owner": "sup",
                           "grantedAt": 0.0}, indent=None, durable=True)
        zombie = Journal(self.ws / "journal", self._journal_cfg, wall=False)
        zombie.register_snapshot("arena:state", self._state_file, indent=None)
        zombie.set_fence(self._fence_file, max(self.epoch - lag, 0))
        ok = True
        self.writes += 1
        self.attempts += records
        zombie.append("arena:state", {"verdicts": -1, "owner": "zombie",
                                      "epoch": self.epoch - lag})
        if zombie.commit():
            ok = False
            self.anomalies.append(f"zombie commit accepted at epoch lag {lag}")
        if zombie.stats().get("fencedRecords", 0) < 1:
            ok = False
            self.anomalies.append("fenced batch not counted")
        for _ in range(records - 1):
            try:
                zombie.append("arena:state", {"owner": "zombie"})
                ok = False
                self.anomalies.append("append after fencing did not raise")
            except FencedWriteError:
                pass
        if zombie.compact() is not False:
            ok = False
            self.anomalies.append("fenced compact not refused")
        zombie.close()
        if self._state_file.read_bytes() != self._baseline:
            ok = False
            self.anomalies.append("committed snapshot bytes changed")
        if ok:
            self.rejected += 1

    def stats(self) -> dict:
        return {"zombieWrites": self.writes,
                "zombieAppends": self.attempts,
                "rejected": self.rejected,
                "leaked": self.writes - self.rejected,
                "fenceEpoch": self.epoch,
                "anomalies": list(self.anomalies)}


def _victim_p99(report: dict, attacker: int, tenants: int) -> float:
    """Worst victim-tenant p99 from a report's e2e.byTenant block."""
    by_tenant = (report.get("e2e") or {}).get("byTenant") or {}
    worst = 0.0
    for t in range(tenants):
        if t == attacker:
            continue
        q = by_tenant.get(f"tenant{t}") or {}
        worst = max(worst, float(q.get("p99", 0.0)))
    return worst


def run_adversarial_report(seed: int = 0, n_ops: int = 1200,
                           tenants: int = 4, packs=None,
                           saturation: float = 1.2, mode: str = "sim",
                           admission: bool = True, watermark: int = 32,
                           config: dict = None, control: bool = True,
                           workspace=None, device: DeviceLike = None) -> dict:
    """One adversarial soak through the real pipeline: the merged
    friendly+attack stream rides :func:`..slo.harness._run_single_report`
    unchanged, zombie ops detour to a :class:`FenceArena`, and the report
    gains an ``adversarial`` section with the isolation verdicts.

    ``control=True`` additionally runs the no-attack twin (the friendly
    component alone, same seed/saturation/mode) and scores the
    victim-tenant p99 factor against ``victimP99FactorBudget`` — in sim
    mode a fully deterministic A/B. ``workspace`` (optional) gets the
    sitrep handoff state file so ``/ops`` can render the last run."""
    from .harness import _run_single_report

    cfg = adversarial_config(config)
    names = tuple(packs) if packs is not None else tuple(cfg["packs"])
    ops = generate_adversarial_workload(seed, n_ops, tenants, packs=names,
                                        config=cfg)
    digest = workload_digest(ops)
    report = _run_single_report(
        ops, digest, seed=seed, tenants=tenants, saturation=saturation,
        mode=mode, admission=admission, watermark=watermark,
        metric="adversarial_slo_report",
        zombie_factory=(lambda root: FenceArena(root, cfg))
        if "fence_thrash" in names else None, device=device)
    fence = report.pop("fence", None)

    attacker = int(cfg["attackTenant"]) % max(tenants, 1)
    adversarial = {
        "packs": list(names),
        "attackOps": sum((digest.get("byPack") or {}).values()),
        "byPack": digest.get("byPack") or {},
        "verdictLosses": report["verdicts"]["losses"],
        "falseBlocks": report["verdicts"]["false_blocks"],
    }
    if fence is not None:
        adversarial["fence"] = fence
    if "unicode_pathology" in names:
        adversarial["unicode"] = unicode_pressure(ops)
    if control:
        n_friendly = sum(1 for op in ops if not op.pack)
        control_ops = generate_workload(seed, n_friendly, tenants)
        control_report = _run_single_report(
            control_ops, workload_digest(control_ops), seed=seed,
            tenants=tenants, saturation=saturation, mode=mode,
            admission=admission, watermark=watermark,
            metric="adversarial_control_report", device=device)
        victim = _victim_p99(report, attacker, tenants)
        control_victim = _victim_p99(control_report, attacker, tenants)
        budget = float(cfg["victimP99FactorBudget"])
        factor = victim / control_victim if control_victim > 0 else 0.0
        adversarial["isolation"] = {
            "attackTenant": attacker,
            "victimP99Ms": round(victim, 4),
            "controlVictimP99Ms": round(control_victim, 4),
            "factor": round(factor, 4),
            "budgetFactor": budget,
            "withinBudget": bool(factor <= budget),
        }
        adversarial["control"] = {
            "checksum": control_report["workload"]["checksum"],
            "e2eP99Ms": (control_report["e2e"] or {}).get("p99"),
        }
    adversarial["survived"] = bool(
        adversarial["verdictLosses"] == 0
        and adversarial["falseBlocks"] == 0
        and (fence is None or (fence["leaked"] == 0
                               and not fence["anomalies"]))
        and (not control
             or adversarial["isolation"]["withinBudget"]))
    report["adversarial"] = adversarial
    if workspace is not None:
        write_adversarial_state(workspace, report, cfg)
    return report


def run_redos_stage_gate(seed: int = 0, n_ops: int = 700, tenants: int = 4,
                         saturation: float = 0.8,
                         config: dict = None,
                         device: DeviceLike = None) -> dict:
    """The ReDoS acceptance gate: wall-mode A/B on the pattern-match
    stages. Sim mode models service times per KIND, so a regex blowup
    would be invisible there — this gate pays for a real clock and reads
    the measured ``governance:evaluate`` and cortex ``extract``/``mood``
    p99 under the storm vs the friendly baseline. The budget factor is
    generous (CI boxes are noisy); a catastrophic pattern reaching the
    hot path is orders of magnitude, not a factor of five."""
    from .harness import run_slo_report

    cfg = adversarial_config(config)
    budget = float(cfg["redosP99FactorBudget"])
    friendly = run_slo_report(seed=seed, n_ops=n_ops, tenants=tenants,
                              saturation=saturation, mode="wall",
                              device=device)
    attack = run_adversarial_report(seed=seed, n_ops=n_ops, tenants=tenants,
                                    packs=("redos_storm",),
                                    saturation=saturation, mode="wall",
                                    config=cfg, control=False,
                                    device=device)

    def match_p99(report: dict) -> dict:
        stages = report.get("stages") or {}
        out = {"governance:evaluate":
               float((stages.get("governance") or {})
                     .get("evaluate", {}).get("p99", 0.0))}
        for watch in ("extract", "mood"):
            worst = 0.0
            for edge, st in stages.items():
                if edge.startswith("cortex:"):
                    worst = max(worst,
                                float((st.get(watch) or {}).get("p99", 0.0)))
            out[f"cortex:{watch}"] = worst
        return out

    base = match_p99(friendly)
    storm = match_p99(attack)
    factors = {k: round(storm[k] / base[k], 4) if base[k] > 0 else 0.0
               for k in base}
    return {
        "metric": "redos_stage_gate",
        "seed": seed,
        "baselineP99Ms": {k: round(v, 4) for k, v in base.items()},
        "stormP99Ms": {k: round(v, 4) for k, v in storm.items()},
        "factors": factors,
        "budgetFactor": budget,
        "withinBudget": all(f <= budget for f in factors.values()),
        "stormVerdictLosses": attack["verdicts"]["losses"],
        "stormFalseBlocks": attack["verdicts"]["false_blocks"],
    }


# ── sitrep handoff (the `adversarial` line in the slo collector) ──────

def write_adversarial_state(workspace, report: dict,
                            config: dict = None) -> Path:
    """Persist the last adversarial run's one-line summary where the slo
    collector can find it. Deliberately timestamp-free: the artifact is a
    pure function of the run, like everything else in this module."""
    from ..storage.atomic import write_json_atomic

    cfg = adversarial_config(config)
    adv = report.get("adversarial") or {}
    isolation = adv.get("isolation") or {}
    state = {
        "packs": adv.get("packs") or [],
        "seed": report.get("seed"),
        "mode": report.get("mode"),
        "checksum": (report.get("workload") or {}).get("checksum"),
        "attackOps": adv.get("attackOps", 0),
        "survived": bool(adv.get("survived")),
        "verdictLosses": adv.get("verdictLosses", 0),
        "falseBlocks": adv.get("falseBlocks", 0),
        "victimP99Ms": isolation.get("victimP99Ms"),
        "victimP99Factor": isolation.get("factor"),
        "victimBudgetFactor": isolation.get("budgetFactor"),
    }
    path = Path(workspace) / str(cfg["stateFile"])
    write_json_atomic(path, state, indent=None, durable=False)
    return path


def read_adversarial_state(workspace, config: dict = None):
    from ..storage.atomic import read_json

    cfg = adversarial_config(config)
    data = read_json(Path(workspace) / str(cfg["stateFile"]), None)
    return data if isinstance(data, dict) else None
