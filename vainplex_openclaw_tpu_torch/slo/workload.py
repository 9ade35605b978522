"""Deterministic workload generation for the fleet SLO harness.

A copy of ``vainplex_openclaw_tpu/slo/workload.py``'s ``Op``,
``generate_workload`` (the gateway mix every cluster storm draws its ops
from), ``generate_fleet_workload``, ``generate_serve_texts`` and
``workload_digest`` (with the phrase, path and kind tables they draw
from), kept here so the port imports nothing of the JAX package.
Everything is a pure function of the seed, and the same seed draws
byte-identical traffic in both packages.
"""

from __future__ import annotations

import hashlib
import json
import random
from dataclasses import dataclass

# One phrase family per pack, built from the packs' own trigger regexes
# (cortex/patterns.py). Each entry: (decision, commitment-ish/wait, close,
# topic, noise). Commitments are detected by the (en/de) commitment
# tracker; other languages still exercise threads/moods/topics.
LANG_PHRASES = {
    "en": ("we decided to use the simpler rollout because it ships faster",
           "I'm waiting for the infra team to approve the quota first",
           "the cache migration is done and deployed ✅",
           "let's talk about the payment gateway hardening",
           "the dashboard shows normal traffic levels this morning"),
    "de": ("wir haben beschlossen, die Migration schrittweise zu machen",
           "warten auf das Security-Review, vorher geht nichts",
           "das Deployment ist erledigt und läuft",
           "zurück zu dem Thema Datenbank Umzug",
           "das Protokoll von gestern ist im Ordner"),
    "fr": ("on a décidé de passer par la file de messages",
           "en attente de la validation du budget",
           "c'est fait, le correctif est déployé",
           "parlons de la rotation des clés d'accès",
           "la réunion est reportée à demain matin"),
    "es": ("decidido: vamos a hacer el despliegue azul-verde",
           "esperando a que el equipo de datos libere la tabla",
           "está hecho y ya funciona en producción",
           "hablemos de la migración de la base de datos",
           "el informe semanal ya está en la carpeta"),
    "pt": ("decidido, vamos fazer a troca do balanceador",
           "aguardando o time de infra liberar o acesso",
           "está feito e já funciona",
           "vamos falar de a rotação de segredos",
           "o relatório semanal está na pasta compartilhada"),
    "it": ("abbiamo deciso, facciamo il rollout graduale",
           "in attesa di la revisione di sicurezza",
           "è fatto e ora funziona",
           "parliamo di il piano di migrazione",
           "il report settimanale è nella cartella condivisa"),
    "zh": ("我们决定采用灰度发布方案", "部署还在等待安全审核",
           "数据迁移搞定了，已经上线了", "关于 支付网关 的改造",
           "普通的消息没有什么特别的内容"),
    "ja": ("リリース方針は段階的に決定しました", "セキュリティレビュー待ちです",
           "移行は完了しました、デプロイ済みです", "決済ゲートウェイについて話しましょう",
           "これはただの雑談メッセージです"),
    "ko": ("점진적 배포로 하기로 했습니다", "보안 검토를 기다리는 중입니다",
           "마이그레이션 완료, 배포됐습니다", "결제 게이트웨이에 관해 봅시다",
           "오늘 점심 메뉴가 괜찮았습니다"),
    "ru": ("решено, делаем поэтапный деплой", "ждём одобрения бюджета, сначала ревью",
           "готово, миграция сделана и работает", "вернёмся к плану миграции базы",
           "обычное сообщение без особого содержания"),
}
ALL_LANGS = tuple(LANG_PHRASES)

# Emoji/notation tail appended to a slice of messages: multibyte + ZWJ
# sequences keep the folding/prefilter path honest about non-BMP input.
_EMOJI = ("🚀", "✅", "⚠️", "👩🏽‍💻", "𝕬𝖇𝖈", "🔥🔥", "…—…")

SAFE_PATHS = ("README.md", "src/app.py", "docs/plan.md", "notes/today.txt")
# Every entry must trip the builtin credential guard (\.(env|pem|key)$ or a
# credentials/secrets path segment): a storm pins observed == expected
# denials, so a path the guard ignores would read as a verdict loss.
DENIED_PATHS = ("/home/user/.env", "secrets.pem", "config/credentials.json",
                "deploy/prod.key")

# (kind, cumulative probability). Verdict-bearing kinds: tool_ok and
# tool_denied go through before_tool_call, tool_secret through
# tool_result_persist, all on NEVER_SHED hooks.
_KIND_CDF = (("msg_in", 0.42), ("msg_out", 0.68), ("tool_ok", 0.83),
             ("tool_denied", 0.91), ("tool_secret", 1.0))


@dataclass
class Op:
    index: int
    arrival: float          # unit-rate arrival time (mean 1 op / time unit)
    tenant: int
    kind: str
    lang: str
    content: str
    pack: str = ""          # adversarial pack tag; "" = friendly

    def to_tuple(self) -> tuple:
        # The pack tag rides the tuple ONLY when set, so a friendly
        # workload's digest does not depend on the field.
        base = (self.index, round(self.arrival, 6), self.tenant, self.kind,
                self.lang, self.content)
        return base + (self.pack,) if self.pack else base


def _pick_kind(r: float) -> str:
    for kind, cum in _KIND_CDF:
        if r < cum:
            return kind
    return _KIND_CDF[-1][0]


def _message(rng: random.Random, lang: str, i: int) -> str:
    phrases = LANG_PHRASES[lang]
    r = rng.random()
    if r < 0.58:
        body = phrases[4] + f" item {i}"          # neutral chatter
    elif r < 0.70:
        body = phrases[3] + f" v{rng.randrange(8)}"  # topic
    elif r < 0.82:
        body = phrases[0]                          # decision
    elif r < 0.90:
        body = phrases[1]                          # wait / blocked
    else:
        body = phrases[2]                          # close / done
    if rng.random() < 0.22:
        body += " " + rng.choice(_EMOJI)
    return body


def generate_workload(seed: int = 0, n_ops: int = 2000,
                      tenants: int = 4, uniform_tenants: bool = False) -> list:
    """Deterministic op list, sorted by unit-rate arrival time.

    ``uniform_tenants`` flattens the zipf tenant skew (with many uniform
    workspaces, a cluster's measured efficiency attributes to ring balance
    and routing overhead rather than to one deliberately heavy tenant that
    no sharding could split). Draw count is identical either way, so the
    default workloads do not depend on it."""
    rng = random.Random(f"slo:{seed}")
    weights = ([1.0] * tenants if uniform_tenants
               else [1.0 / (i + 1) ** 1.1 for i in range(tenants)])  # skewed
    total_w = sum(weights)
    ops: list[Op] = []
    t = 0.0
    burst_left = 0
    for i in range(n_ops):
        if burst_left > 0:
            burst_left -= 1
            t += rng.expovariate(1.0) * 0.04   # inside a burst: ~25x rate
        elif rng.random() < 0.10:
            burst_left = rng.randint(4, 16)    # burst begins
            t += rng.expovariate(1.0)
        else:
            t += rng.expovariate(1.0)
        r = rng.random() * total_w
        tenant = tenants - 1
        for ti, w in enumerate(weights):
            if r < w:
                tenant = ti
                break
            r -= w
        kind = _pick_kind(rng.random())
        lang = rng.choice(ALL_LANGS)
        if kind in ("msg_in", "msg_out"):
            content = _message(rng, lang, i)
        elif kind == "tool_ok":
            content = rng.choice(SAFE_PATHS)
        elif kind == "tool_denied":
            content = rng.choice(DENIED_PATHS)
        else:  # tool_secret: a credential that MUST come back redacted
            content = f"export API_KEY=sk-{'a' * 20}{i % 10}"
        ops.append(Op(i, t, tenant, kind, lang, content))
    return ops


def generate_fleet_workload(seed: int = 0, n_ops: int = 2000,
                            tenants: int = 4, profile: str = "diurnal",
                            base_rate: float = 400.0,
                            peak_factor: float = 4.0,
                            period_s: float = 1.0) -> list:
    """Stage-3 validator traffic for the replica fleet: message
    texts (the fleet serves verdicts, so every op is a validation) on
    rate-modulated arrivals in virtual SECONDS.

    Profiles:

    - ``diurnal`` — the arrival rate rides one raised-cosine day: ``lo`` at
      the edges, ``lo * peak_factor`` mid-trace. One trace therefore holds
      exactly the autoscaler's A/B story: under-provisioned at the peak
      unless it spawns, over-provisioned after unless it retires.
    - ``burst`` — flat baseline punctuated by seeded flash crowds (~20x
      rate for 8–48 requests), the window-thrash regime for routing.

    A separate rng stream (``fleet:<profile>:<seed>``)."""
    import math

    if profile not in ("diurnal", "burst"):
        raise ValueError(f"unknown fleet workload profile {profile!r}")
    rng = random.Random(f"fleet:{profile}:{seed}")
    lo = float(base_rate)
    hi = lo * float(peak_factor)
    ops: list[Op] = []
    t = 0.0
    burst_left = 0
    for i in range(n_ops):
        if profile == "diurnal":
            phase = min(1.0, t / float(period_s))
            rate = lo + (hi - lo) * 0.5 * (1.0 - math.cos(
                2.0 * math.pi * phase))
            t += rng.expovariate(rate)
        else:
            if burst_left > 0:
                burst_left -= 1
                t += rng.expovariate(lo * 20.0)
            elif rng.random() < 0.04:
                burst_left = rng.randint(8, 48)
                t += rng.expovariate(lo)
            else:
                t += rng.expovariate(lo)
        tenant = rng.randrange(tenants)
        lang = rng.choice(ALL_LANGS)
        ops.append(Op(i, t, tenant, "validate", lang,
                      _message(rng, lang, i)))
    return ops


def generate_serve_texts(seed: int = 0, n: int = 256) -> list:
    """Seeded validator-prompt texts: the fleet workload's message mix
    without arrival times — callers drive their own submission schedule.
    A separate rng stream (``serve-texts:<seed>``)."""
    rng = random.Random(f"serve-texts:{seed}")
    return [_message(rng, rng.choice(ALL_LANGS), i) for i in range(int(n))]


def workload_digest(ops: list) -> dict:
    """Checksum + mix breakdown — the deterministic identity of a run."""
    blob = json.dumps([op.to_tuple() for op in ops],
                      ensure_ascii=False, separators=(",", ":"))
    by_kind: dict[str, int] = {}
    by_tenant: dict[str, int] = {}
    by_pack: dict[str, int] = {}
    langs: set[str] = set()
    for op in ops:
        by_kind[op.kind] = by_kind.get(op.kind, 0) + 1
        key = f"tenant{op.tenant}"
        by_tenant[key] = by_tenant.get(key, 0) + 1
        langs.add(op.lang)
        if getattr(op, "pack", ""):
            by_pack[op.pack] = by_pack.get(op.pack, 0) + 1
    digest = {
        "checksum": hashlib.sha256(blob.encode("utf-8")).hexdigest()[:16],
        "ops": len(ops),
        "byKind": dict(sorted(by_kind.items())),
        "byTenant": dict(sorted(by_tenant.items())),
        "languages": sorted(langs),
    }
    if by_pack:
        # Adversarial runs only: friendly digests keep their shape, attack
        # runs add the per-pack breakdown.
        digest["byPack"] = dict(sorted(by_pack.items()))
    return digest
