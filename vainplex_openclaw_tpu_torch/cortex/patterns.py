"""Language packs + pattern registry (RFC-004; reference:
cortex/src/patterns/lang-*.ts ×10, registry.ts, patterns.ts).

Each pack carries decision/close/wait/topic signal regexes, a topic
blacklist, high-impact keywords, mood regexes, and noise prefixes. The
registry merges the selected packs (``"both"`` = en+de, ``"all"`` = all 10)
plus custom user patterns, and pre-compiles the merged sets once.
Requirement R-033: all-language matching must stay <2 ms/message — hence the
single merged+compiled pattern lists, no per-message compilation.

The port's copy of ``vainplex_openclaw_tpu/cortex/patterns.py``: the same
packs, ``MergedPatterns``, ``fold_lower`` and ``resolve_language_codes``,
the compiled (prefilter-bank) path and the interpreter path, with the ReDoS
screen through the port's ``analysis/redos.py``. One deviation, in the
fold-unsafe guard (``_build_fold_unsafe_search``): the JAX module builds
it from ``re._compiler._equivalences``, a table Python 3.12 no longer has,
so there its guard holds only ``İ`` and ``Σ`` and the compiled path drops
matches the interpreter finds (JAX's compiled path finds no decision in
"we decıded to go"). The port reads that table where it exists, else
``re._casefix._EXTRA_CASES``, the table Python 3.12 keeps instead. The
compiled path then returns what the interpreter path returns on every
Python this runs on, the contract ``tests/test_cortex_perf_equiv.py``
states for the JAX package; ``tests/test_torch_cortex.py`` holds the port
to it.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import NamedTuple, Optional

from ..analysis.redos import pattern_safe, unsafe_report
from ..governance.util import ALTERNATION_UNSAFE

MOODS = ("frustrated", "excited", "tense", "productive", "exploratory")


@dataclass(frozen=True)
class LanguagePack:
    code: str
    name: str
    decision: tuple[str, ...]
    close: tuple[str, ...]
    wait: tuple[str, ...]
    topic: tuple[str, ...]  # each with one capture group for the topic
    topic_blacklist: tuple[str, ...]
    high_impact: tuple[str, ...]
    moods: dict = field(default_factory=dict)  # mood → pattern
    noise_prefixes: tuple[str, ...] = ()
    flags: int = re.IGNORECASE


PACKS: dict[str, LanguagePack] = {}


def _pack(**kw) -> None:
    pack = LanguagePack(**kw)
    PACKS[pack.code] = pack


_pack(
    code="en", name="English",
    decision=(r"(?:decided|decision|agreed|let'?s do|the plan is|approach:|we(?:'ll| will) go with)",),
    close=(r"(?:^|\s)(?:is |it'?s |that'?s |all )?(?:done|fixed|solved|closed|resolved)(?:\s|[.!]|$)",
           r"(?:^|\s)(?:it |that )works(?:\s|[.!]|$)", r"✅"),
    wait=(r"(?:waiting (?:for|on)|blocked (?:by|on)|need\b.*\bfirst)",),
    topic=(r"(?:back to|now about|regarding|let'?s (?:talk about|discuss|look at))\s+(?:the\s+)?(\w[\w\s-]{3,40})",),
    topic_blacklist=("it", "that", "this", "the", "them", "what", "which", "there",
                     "nothing", "something", "everything", "me", "you", "him", "her",
                     "us", "today", "tomorrow", "yesterday"),
    high_impact=("architecture", "security", "migration", "delete", "production",
                 "deploy", "breaking", "major", "critical", "strategy", "budget", "contract"),
    moods={"frustrated": r"(?:fuck|shit|damn|sucks|annoying)",
           "excited": r"(?:nice|awesome|brilliant|sick|great news)",
           "tense": r"(?:careful|risky|urgent)",
           "productive": r"(?:done|fixed|works|deployed|shipped)",
           "exploratory": r"(?:what if|idea|maybe|experiment)"},
    noise_prefixes=("i", "we", "he", "she", "it", "nothing", "something"),
)

_pack(
    code="de", name="Deutsch",
    decision=(r"(?:entschieden|beschlossen|machen wir|wir machen|der plan ist|ansatz:)",),
    close=(r"(?:^|\s)(?:ist |schon )?(?:erledigt|gefixt|gelöst|fertig|behoben)(?:\s|[.!]|$)",
           r"(?:^|\s)(?:es |das )funktioniert(?:\s|[.!]|$)"),
    wait=(r"(?:warte(?:n)? auf|blockiert durch|brauche(?:n)?\b.*\berst)",),
    topic=(r"(?:zurück zu|jetzt zu|bzgl\.?|wegen|lass uns (?:über|mal))\s+(?:dem?|die|das)?\s*(\w[\w\s-]{3,40})",),
    topic_blacklist=("das", "die", "der", "es", "was", "hier", "dort", "nichts",
                     "etwas", "alles", "mir", "dir", "ihm", "uns", "heute", "morgen",
                     "gestern", "noch", "schon", "jetzt", "dann", "also", "aber", "oder"),
    high_impact=("architektur", "sicherheit", "migration", "löschen", "produktion",
                 "kritisch", "strategie", "vertrag"),
    moods={"frustrated": r"(?:mist|nervig|genervt|schon wieder|zum kotzen)",
           "excited": r"(?:geil|krass|boom|perfekt|mega)",
           "tense": r"(?:vorsicht|heikel|kritisch|dringend|achtung|gefährlich)",
           "productive": r"(?:erledigt|fertig|gebaut|läuft)",
           "exploratory": r"(?:was wäre wenn|könnte man|idee|vielleicht)"},
    noise_prefixes=("ich", "wir", "du", "er", "sie", "es", "nichts", "etwas"),
)

_pack(
    code="fr", name="Français",
    decision=(r"(?:décidé|décision|convenu|on (?:fait|va faire)|le plan est|approche\s*:)",),
    close=(r"(?:^|\s)(?:c'?est )?(?:fait|réglé|résolu|terminé|corrigé|fini)(?:\s|[.!]|$)",
           r"(?:^|\s)ça (?:marche|fonctionne)(?:\s|[.!]|$)"),
    wait=(r"(?:en attente de|attends?\b.*\b(?:de|que)|bloqué par|besoin de\b.*\bd'abord)",),
    topic=(r"(?:revenons (?:à|sur)|concernant|à propos de|parlons de)\s+(?:l[ae']\s*|les\s+)?(\w[\w\s-]{3,40})",),
    topic_blacklist=("ça", "cela", "ceci", "le", "la", "les", "quoi", "rien",
                     "tout", "moi", "toi", "lui", "nous", "aujourd'hui", "demain", "hier"),
    high_impact=("architecture", "sécurité", "migration", "supprimer", "production",
                 "déploiement", "critique", "stratégie", "budget", "contrat"),
    moods={"frustrated": r"(?:merde|putain|chiant|galère)",
           "excited": r"(?:génial|super|excellent|parfait)",
           "tense": r"(?:attention|risqué|urgent|prudent)",
           "productive": r"(?:fait|réglé|déployé|corrigé)",
           "exploratory": r"(?:et si|idée|peut-être|essayons)"},
    noise_prefixes=("je", "nous", "il", "elle", "on", "rien"),
)

_pack(
    code="es", name="Español",
    decision=(r"(?:decidido|decisión|acordado|hagamos|vamos a hacer|el plan es|enfoque\s*:)",),
    close=(r"(?:^|\s)(?:está |ya )?(?:hecho|arreglado|resuelto|terminado|listo|solucionado)(?:\s|[.!]|$)",
           r"(?:^|\s)(?:eso |ya )funciona(?:\s|[.!]|$)"),
    wait=(r"(?:esperando (?:a|por)|bloqueado por|necesito\b.*\bprimero)",),
    topic=(r"(?:volviendo a|sobre|respecto a|hablemos de)\s+(?:el\s+|la\s+|los\s+)?(\w[\w\s-]{3,40})",),
    topic_blacklist=("eso", "esto", "el", "la", "los", "qué", "nada", "algo",
                     "todo", "mí", "ti", "él", "nosotros", "hoy", "mañana", "ayer"),
    high_impact=("arquitectura", "seguridad", "migración", "borrar", "producción",
                 "desplegar", "crítico", "estrategia", "presupuesto", "contrato"),
    moods={"frustrated": r"(?:mierda|joder|molesto|fastidio)",
           "excited": r"(?:genial|increíble|perfecto|excelente)",
           "tense": r"(?:cuidado|arriesgado|urgente)",
           "productive": r"(?:hecho|arreglado|desplegado|funciona)",
           "exploratory": r"(?:y si|idea|quizás|experimento)"},
    noise_prefixes=("yo", "nosotros", "él", "ella", "nada", "algo"),
)

_pack(
    code="pt", name="Português",
    decision=(r"(?:decidido|decisão|combinado|vamos fazer|o plano é|abordagem\s*:)",),
    close=(r"(?:^|\s)(?:está |já )?(?:feito|consertado|resolvido|concluído|pronto|fechado)(?:\s|[.!]|$)",
           r"(?:^|\s)(?:isso |já )funciona(?:\s|[.!]|$)"),
    wait=(r"(?:esperando (?:por|o)|aguardando|bloqueado por|preciso\b.*\bprimeiro)",),
    topic=(r"(?:voltando (?:a|ao)|sobre|a respeito de|vamos falar de)\s+(?:o\s+|a\s+|os\s+)?(\w[\w\s-]{3,40})",),
    topic_blacklist=("isso", "isto", "o", "a", "os", "quê", "nada", "algo",
                     "tudo", "mim", "ti", "ele", "nós", "hoje", "amanhã", "ontem"),
    high_impact=("arquitetura", "segurança", "migração", "apagar", "produção",
                 "implantar", "crítico", "estratégia", "orçamento", "contrato"),
    moods={"frustrated": r"(?:merda|droga|chato|saco)",
           "excited": r"(?:ótimo|incrível|perfeito|excelente|massa)",
           "tense": r"(?:cuidado|arriscado|urgente)",
           "productive": r"(?:feito|consertado|implantado|funciona)",
           "exploratory": r"(?:e se|ideia|talvez|experimento)"},
    noise_prefixes=("eu", "nós", "ele", "ela", "nada", "algo"),
)

_pack(
    code="it", name="Italiano",
    decision=(r"(?:deciso|decisione|concordato|facciamo|il piano è|approccio\s*:)",),
    close=(r"(?:^|\s)(?:è |già )?(?:fatto|sistemato|risolto|finito|chiuso|completato)(?:\s|[.!]|$)",
           r"(?:^|\s)(?:questo |ora )funziona(?:\s|[.!]|$)"),
    wait=(r"(?:in attesa di|aspetto\b|bloccato da|serve\b.*\bprima)",),
    topic=(r"(?:tornando a|riguardo a|parliamo di|vediamo)\s+(?:il\s+|la\s+|i\s+)?(\w[\w\s-]{3,40})",),
    topic_blacklist=("questo", "quello", "il", "la", "i", "cosa", "niente",
                     "qualcosa", "tutto", "me", "te", "lui", "noi", "oggi", "domani", "ieri"),
    high_impact=("architettura", "sicurezza", "migrazione", "cancellare", "produzione",
                 "deploy", "critico", "strategia", "budget", "contratto"),
    moods={"frustrated": r"(?:merda|cavolo|fastidioso|palle)",
           "excited": r"(?:fantastico|ottimo|perfetto|grandioso)",
           "tense": r"(?:attenzione|rischioso|urgente)",
           "productive": r"(?:fatto|sistemato|deployato|funziona)",
           "exploratory": r"(?:e se|idea|forse|esperimento)"},
    noise_prefixes=("io", "noi", "lui", "lei", "niente", "qualcosa"),
)

_pack(
    code="zh", name="中文", flags=0,
    decision=(r"(?:决定|已决定|方案[是为]|我们[用采]|确定了|就这么[定办])",
              r"(?:敲定|拍板|最终[选方]|采用|选择了)"),
    close=(r"(?:完成|搞定|解决了|已[关修]|修好了|结束了)",
           r"(?:好了|没问题了|可以了|OK了|行了)"),
    wait=(r"(?:等待|被.*阻塞|需要.*才能|还差|卡在|依赖于|前提是)",),
    topic=(r"(?:关于|回到|讨论|说[说到]|看看)\s*([一-鿿\w]{2,20})",
           r"(?:至于|针对|聊聊)\s*([一-鿿\w]{2,20})"),
    topic_blacklist=("这个", "那个", "什么", "哪个", "这里", "那里", "我", "你", "他",
                     "她", "我们", "他们", "没有", "东西", "事情", "今天", "明天", "昨天"),
    high_impact=("架构", "安全", "迁移", "删除", "生产", "部署", "关键", "策略",
                 "预算", "合同", "重大"),
    moods={"frustrated": r"(?:靠|妈的|烦死|崩溃|要命)",
           "excited": r"(?:太好了|牛|厉害|完美|太棒了)",
           "tense": r"(?:小心|危险|紧急|注意|风险)",
           "productive": r"(?:搞定|完成|修好|部署了|上线了)",
           "exploratory": r"(?:如果|或许|想法|试试|可以考虑)"},
    noise_prefixes=("我", "你", "他", "她", "我们", "没有"),
)

_pack(
    code="ja", name="日本語", flags=0,
    decision=(r"(?:決定|決めました|決まりました|方針は|计划|プランは|にしましょう|で行きましょう)",),
    close=(r"(?:完了|終わりました|解決しました|直しました|できました|修正済み)",),
    wait=(r"(?:待ち|待っています|ブロックされて|が必要です|依存して)",),
    topic=(r"(?:について|に関して|の話|を見ましょう)\s*([぀-ヿ一-鿿\w]{2,20})",
           r"([぀-ヿ一-鿿\w]{2,20})\s*(?:について|に関して)"),
    topic_blacklist=("これ", "それ", "あれ", "何", "私", "あなた", "彼", "彼女",
                     "今日", "明日", "昨日", "もの", "こと"),
    high_impact=("アーキテクチャ", "セキュリティ", "移行", "削除", "本番", "デプロイ",
                 "重要", "戦略", "予算", "契約"),
    moods={"frustrated": r"(?:くそ|イライラ|最悪|うざい)",
           "excited": r"(?:素晴らしい|最高|完璧|すごい)",
           "tense": r"(?:注意|危険|緊急|リスク)",
           "productive": r"(?:完了|修正|デプロイ|動きました)",
           "exploratory": r"(?:もし|アイデア|たぶん|試して)"},
    noise_prefixes=("私", "僕", "彼", "彼女", "何も"),
)

_pack(
    code="ko", name="한국어", flags=0,
    decision=(r"(?:결정|정했|합의|하기로 했|계획은|방침은|으로 갑시다)",),
    close=(r"(?:완료|끝났|해결했|고쳤|됐습니다|수정했)",),
    wait=(r"(?:기다리|대기 중|막혀|차단|필요합니다.*먼저|의존)",),
    topic=(r"(?:관해서?|대해서?|이야기|돌아가서|봅시다)\s*([가-힯\w]{2,20})",
           r"([가-힯\w]{2,20})\s*(?:에 관해|에 대해)"),
    topic_blacklist=("이것", "그것", "저것", "무엇", "나", "너", "우리", "그",
                     "오늘", "내일", "어제", "것"),
    high_impact=("아키텍처", "보안", "마이그레이션", "삭제", "프로덕션", "배포",
                 "중요", "전략", "예산", "계약"),
    moods={"frustrated": r"(?:젠장|짜증|최악|빡치)",
           "excited": r"(?:대박|멋지|완벽|최고)",
           "tense": r"(?:조심|위험|긴급|주의)",
           "productive": r"(?:완료|수정|배포|됩니다)",
           "exploratory": r"(?:만약|아이디어|아마|실험)"},
    noise_prefixes=("나", "너", "그", "그녀", "우리", "아무것도"),
)

_pack(
    code="ru", name="Русский",
    decision=(r"(?:решено|решили|договорились|план таков|давай(?:те)? сделаем|подход\s*:)",),
    close=(r"(?:^|\s)(?:уже )?(?:готово|сделано|исправлено|решено|закрыто|починил)(?:\s|[.!]|$)",
           r"(?:^|\s)(?:это |теперь )работает(?:\s|[.!]|$)"),
    wait=(r"(?:жд[уём]\b|ожидаем|заблокировано|нужно\b.*\bсначала|зависит от)",),
    topic=(r"(?:вернёмся к|насчёт|по поводу|давай(?:те)? обсудим|поговорим о)\s+(\w[\w\s-]{3,40})",),
    topic_blacklist=("это", "то", "что", "ничего", "всё", "я", "ты", "он", "она",
                     "мы", "сегодня", "завтра", "вчера"),
    high_impact=("архитектура", "безопасность", "миграция", "удалить", "продакшн",
                 "деплой", "критично", "стратегия", "бюджет", "контракт"),
    moods={"frustrated": r"(?:блин|чёрт|бесит|достало)",
           "excited": r"(?:отлично|круто|супер|идеально)",
           "tense": r"(?:осторожно|рискованно|срочно)",
           "productive": r"(?:готово|сделано|задеплоил|работает)",
           "exploratory": r"(?:а что если|идея|может быть|эксперимент)"},
    noise_prefixes=("я", "мы", "он", "она", "ничего", "что-то"),
)

BUILTIN_LANGUAGES = tuple(PACKS)

# Universal emoji moods, language-independent (reference registry.ts BASE_MOOD)
BASE_MOODS = {
    "frustrated": r"(?:wtf|argh)",
    "excited": r"(?:🎯|🚀)",
    "tense": r"(?:⚠️|‼️)",
    "productive": r"(?:✅)",
    "exploratory": r"(?:🤔|💡)",
}


def resolve_language_codes(selection) -> list[str]:
    """``"both"`` = en+de (historical default), ``"all"`` = all 10."""
    if selection in (None, "both"):
        return ["en", "de"]
    if selection == "all":
        return list(BUILTIN_LANGUAGES)
    if isinstance(selection, str):
        return [selection]
    return [c for c in selection if c in PACKS]


def _compile_custom(patterns: object, category: str, logger=None) -> list[re.Pattern]:
    """Compile custom user regexes: non-strings and empty strings are
    filtered, invalid regexes are skipped with a warning (reference
    registry semantics — a bad custom pattern must not take down the
    builtins, but the user must be able to see why theirs never fires)."""
    out = []
    for p in patterns if isinstance(patterns, (list, tuple)) else []:
        if not isinstance(p, str) or not p:
            continue
        try:
            out.append(re.compile(p, re.IGNORECASE))
        except re.error as exc:
            if logger is not None:
                logger.warn(f"custom {category} pattern {p!r} rejected: {exc}")
    return out


_CJK = re.compile(r"[぀-ヿ㐀-鿿가-힯]")


try:  # Python ≥3.11 moved the regex parser; 3.10 ships it as sre_parse
    from re import _constants as _sre_c
    from re import _parser as _sre_parse
except ImportError:  # pragma: no cover — version-dependent import only
    import sre_constants as _sre_c
    import sre_parse as _sre_parse

# str.lower() is the screen's case folder, but regex IGNORECASE matching
# diverges from it in two ways: str.lower's full-casing specials (İ → "i̇",
# Σ → context-sensitive final sigma), and sre's case-equivalence classes
# (sre_compile._equivalences: ı↔i, ſ↔s, µ↔μ, ς↔σ, the Greek symbol
# variants, historic-Cyrillic letter forms ↔ в/д/о/с/т/ъ/ѣ/ꙋ, …) which
# fold characters str.lower() keeps distinct. Divergence needs TWO
# DIFFERENT class members meeting — one in a screen literal, one in the
# text — so soundness requires at most ONE unguarded member per class: the
# smallest codepoint (ASCII i/s, modern Cyrillic — what the builtin pack
# literals actually use) stays unguarded, every other member both poisons
# screen literals and, when present in a message, bypasses the screens
# entirely (walk all members: the always-correct, never-fast direction).
# Screen misses stay PROOF of member misses. Built from sre's own table so
# new interpreter versions can't silently widen IGNORECASE past the guard:
# ``_equivalences`` up to Python 3.11, ``re._casefix._EXTRA_CASES`` (each
# lowercase codepoint → the others that fold with it) from 3.12 on.


def equivalence_classes() -> list[tuple[int, ...]]:
    """sre's case-equivalence classes, each sorted: from
    ``_equivalences`` where the interpreter has it, else from
    ``re._casefix._EXTRA_CASES``; empty where it has neither."""
    try:  # Python ≥3.11 moved sre_compile under re._compiler
        from re import _compiler as sre_c
    except ImportError:  # pragma: no cover — version-dependent import only
        import sre_compile as sre_c
    table = getattr(sre_c, "_equivalences", None)
    if table:
        return sorted(tuple(sorted(cls)) for cls in table)
    try:
        from re import _casefix
    except ImportError:  # pragma: no cover — version-dependent import only
        return []
    return sorted({tuple(sorted((c,) + others))
                   for c, others in _casefix._EXTRA_CASES.items()})


def _build_fold_unsafe_search():
    chars = {"İ", "Σ"}  # str.lower full-casing specials
    for cls in equivalence_classes():
        chars.update(chr(c) for c in cls[1:])
    return re.compile("[" + "".join(map(re.escape, sorted(chars))) + "]").search


_FOLD_UNSAFE_SEARCH = _build_fold_unsafe_search()


def _fold_unsafe(text: str) -> bool:
    return _FOLD_UNSAFE_SEARCH(text) is not None


_UNSET = object()  # "compute fold_lower(text) yourself" default


def fold_lower(text: str) -> Optional[str]:
    """The screen-ready lowercase of ``text``, or None when it carries
    fold-unsafe chars (screens must be bypassed). The ingest hot path
    computes this once per message and passes it to both
    ``extract_signals`` and ``detect_mood`` — the guard scan and the
    lowercase copy are not free on every-message traffic."""
    return None if _fold_unsafe(text) else text.lower()


def _required_literals(seq) -> Optional[list[str]]:
    """Literal strings (lowercased) such that every match of ``seq`` contains
    at least one — or None when no such set can be proven.

    Walks the sre parse tree: a concatenation requires each of its parts, so
    the single most selective part's literals suffice (longest-min-length set
    wins); an alternation requires the union over branches (every branch must
    contribute, or the whole node proves nothing); repeats count only when
    min ≥ 1; anchors, classes, backrefs and lookarounds contribute nothing
    but break literal runs. Literals that fold unsafely (see above) poison
    their candidate set."""
    candidates: list[list[str]] = []
    run: list[str] = []
    repeats = {_sre_c.MAX_REPEAT, _sre_c.MIN_REPEAT}
    if hasattr(_sre_c, "POSSESSIVE_REPEAT"):  # 3.11+
        repeats.add(_sre_c.POSSESSIVE_REPEAT)

    def flush_run() -> None:
        if not run:
            return
        raw = "".join(run)
        run.clear()
        # Fold-safety must be judged on the RAW chars: İ.lower() already
        # expands, so checking after lowering would miss it.
        if not _fold_unsafe(raw) and all(len(c.lower()) == 1 for c in raw):
            candidates.append([raw.lower()])

    for op, av in seq:
        if op is _sre_c.LITERAL:
            run.append(chr(av))
            continue
        flush_run()
        sub = None
        if op is _sre_c.SUBPATTERN:
            sub = _required_literals(av[3])
        elif op is _sre_c.BRANCH:
            union: Optional[list[str]] = []
            for branch in av[1]:
                got = _required_literals(branch)
                if not got:
                    union = None
                    break
                union.extend(got)
            sub = union
        elif op in repeats:
            if av[0] >= 1:  # traversed at least once
                sub = _required_literals(av[2])
        elif op is _sre_c.ASSERT:  # positive lookaround still reads the text
            sub = _required_literals(av[1])
        # IN/ANY/AT/NOT_LITERAL/GROUPREF/ASSERT_NOT…: prove nothing, fail
        # nothing — the surrounding concatenation may still carry a literal.
        if sub:
            candidates.append(sub)
    flush_run()
    if not candidates:
        return None
    return max(candidates, key=lambda lits: min(len(l) for l in lits))


class PrefilterBank(NamedTuple):
    """Required-literal screen over one signal category (the same
    miss-skips-all-members contract as governance/policy_plan.py's banks,
    rebuilt on substring screening because CPython's re gives combined
    alternations no Hyperscan-style literal dispatch — measured on this
    engine, a 40-branch combined alternation scan costs MORE than 40
    separate member scans).

    ``literals`` is the union of per-member required-literal sets, swept
    with ``lit in text.lower()`` (C substring scan, <0.1 µs each). A union
    MISS — the common case — proves no screened member can match anywhere,
    collapsing the walk to ``unscreened``: members that are backref-unsafe
    (same exclusion rule as the governance banks) or yielded no provable
    literal. A union HIT re-attributes per member through ``member_lits``
    (parallel to ``members``; None = always walk), so typically only the one
    or two members whose own literals are present pay a regex walk — in the
    original member order, keeping match output identical to the
    interpreter. ``literals`` is None when nothing could be screened.

    ``ascii_literals`` is the ASCII subset of the union: a non-ASCII
    literal can never be a substring of an ASCII message, and
    ``str.isascii()`` is an O(1) flag check in CPython, so an ASCII message
    sweeps only that subset — with all ten packs merged, that skips every
    CJK/Cyrillic/accented literal (roughly half the union) on the most
    common traffic."""

    literals: Optional[tuple[str, ...]]
    ascii_literals: tuple
    members: tuple
    member_lits: tuple
    unscreened: tuple

    def walk_list(self, low: Optional[str]):
        """Members that still need their regex walked against the text.
        ``low`` is the lowercased text, or None to bypass screening (fold-
        unsafe text). ``any(map(low.__contains__, …))`` keeps the sweep
        loop in C — measured ~30% over a genexp on this hot path."""
        if low is None or self.literals is None:
            return self.members
        lits = self.ascii_literals if low.isascii() else self.literals
        if not any(map(low.__contains__, lits)):
            return self.unscreened
        return [rx for rx, mlits in zip(self.members, self.member_lits)
                if mlits is None or any(map(low.__contains__, mlits))]


def _build_bank(members: list[re.Pattern]) -> PrefilterBank:
    union: list[str] = []
    member_lits = []
    unscreened = []
    for rx in members:
        lits = None
        # ReDoS-catastrophic members are demoted to the
        # interpreter path: never screened, always walked member-by-member
        # exactly as extract_signals_interp would — identical matches, and
        # the pattern stays out of the compiled dispatch (reported via
        # MergedPatterns.unsafe / cortexstatus / sitrep).
        if (not ALTERNATION_UNSAFE.search(rx.pattern)
                and pattern_safe(rx.pattern, rx.flags)):
            try:
                lits = _required_literals(_sre_parse.parse(rx.pattern, rx.flags))
            except Exception:  # noqa: BLE001 — a screen is an optimization only
                lits = None
        if lits:
            union.extend(lits)
            member_lits.append(tuple(lits))
        else:
            unscreened.append(rx)
            member_lits.append(None)
    if len(unscreened) == len(members):
        return PrefilterBank(None, (), tuple(members), tuple(member_lits), ())
    deduped = tuple(dict.fromkeys(union))
    return PrefilterBank(deduped, tuple(l for l in deduped if l.isascii()),
                         tuple(members), tuple(member_lits), tuple(unscreened))


class MergedPatterns:
    """Pre-compiled merged view over the selected packs + custom patterns.

    ``custom`` may carry per-category regex lists (``decision``/``close``/
    ``wait``/``topic``), extra ``blacklist`` words and ``keywords``, and a
    ``mode``: ``"extend"`` (default — customs append to the builtins) or
    ``"override"`` (a category with at least one VALID custom pattern
    replaces the builtin set for that category; empty or all-invalid custom
    lists leave the builtins alone). Reference: cortex patterns-custom
    semantics (patterns-registry.ts / patterns-custom.test.ts).

    ``compiled=True`` (the default; config ``cortex.compiledPatterns``)
    additionally builds per-category and per-mood ``PrefilterBank``s so the
    per-message ingest hot path pays one lowercase plus a handful of C
    substring sweeps per category instead of one regex scan per member
    pattern. ``compiled=False`` restores the interpreter path
    end-to-end — ``extract_signals_interp`` / ``detect_mood_interp``
    semantics and the naive thread matching in ``ThreadTracker``."""

    def __init__(self, codes: list[str], custom: Optional[dict] = None,
                 logger=None, compiled: bool = True):
        self.codes = [c for c in codes if c in PACKS]
        packs = [PACKS[c] for c in self.codes]
        custom = custom or {}
        override = custom.get("mode") == "override"

        def compile_all(attr: str) -> list[re.Pattern]:
            compiled_custom = _compile_custom(custom.get(attr, []), attr, logger)
            if override and compiled_custom:
                return compiled_custom
            out = []
            for pack in packs:
                out += [re.compile(p, pack.flags) for p in getattr(pack, attr)]
            return out + compiled_custom

        self.decision = compile_all("decision")
        self.close = compile_all("close")
        self.wait = compile_all("wait")
        self.topic = compile_all("topic")
        def custom_words(key: str) -> list[str]:
            # a bare string here is a config mistake, not a word list —
            # iterating it would add single letters (same non-list guard as
            # _compile_custom)
            raw = custom.get(key, [])
            if not isinstance(raw, (list, tuple)):
                return []
            return [w.lower() for w in raw if isinstance(w, str) and w]

        self.topic_blacklist = {w.lower() for pack in packs for w in pack.topic_blacklist}
        self.topic_blacklist |= set(custom_words("blacklist"))
        self.high_impact = [w.lower() for pack in packs for w in pack.high_impact]
        self.high_impact += custom_words("keywords")
        self.noise_prefixes = {w.lower() for pack in packs for w in pack.noise_prefixes}
        self.moods: dict[str, list[re.Pattern]] = {m: [] for m in MOODS}
        for mood, base in BASE_MOODS.items():
            self.moods[mood].append(re.compile(base, re.IGNORECASE))
        for pack in packs:
            for mood, pattern in pack.moods.items():
                self.moods[mood].append(re.compile(pattern, pack.flags))

        # ReDoS screen over every member that will run per
        # message, builtin or custom: unsafe entries are kept (dropping a
        # pattern would change match results — the user's regex still fires
        # on the inputs it was written for) but demoted out of the compiled
        # banks by _build_bank and REPORTED — here, in cortexstatus, and on
        # the sitrep ops pane — so a pathological custom pattern is a
        # visible operational fact, not a latent stall.
        self.unsafe: list[dict] = []
        for cat in ("decision", "close", "wait", "topic"):
            for rx in getattr(self, cat):
                issue = unsafe_report(rx.pattern, rx.flags)
                if issue:
                    self.unsafe.append({"category": cat,
                                        "pattern": rx.pattern, "issue": issue})
        for mood, rxs in self.moods.items():
            for rx in rxs:
                issue = unsafe_report(rx.pattern, rx.flags)
                if issue:
                    self.unsafe.append({"category": f"mood:{mood}",
                                        "pattern": rx.pattern, "issue": issue})
        if self.unsafe and logger is not None:
            for entry in self.unsafe:
                logger.warn(
                    f"pattern {entry['pattern']!r} ({entry['category']}) "
                    f"screens ReDoS-unsafe ({entry['issue']}); demoted to "
                    f"the interpreter path")

        self.compiled = bool(compiled)
        # Banks are built even when compiled=False (load-time cost only);
        # the flag gates DISPATCH, so flipping ``compiledPatterns`` selects
        # a code path, never a data shape.
        self.prefilter: dict[str, PrefilterBank] = {
            cat: _build_bank(getattr(self, cat))
            for cat in ("decision", "close", "wait", "topic")
        }
        # Mood banks preserve MOODS priority order: detect_mood answers with
        # the FIRST mood whose bank hits, exactly like the interpreter loop.
        self.mood_banks: tuple = tuple(
            (mood, _build_bank(self.moods[mood])) for mood in MOODS)

    def detect_mood(self, text: str, low=_UNSET) -> str:
        if not self.compiled:
            return self.detect_mood_interp(text)
        if low is _UNSET:
            low = fold_lower(text)
        for mood, bank in self.mood_banks:
            if any(rx.search(text) for rx in bank.walk_list(low)):
                return mood
        return "neutral"

    def detect_mood_interp(self, text: str) -> str:
        """Per-member interpreter walk — the equivalence oracle for
        ``detect_mood`` (tests/test_cortex_perf_equiv.py)."""
        for mood in MOODS:
            if any(rx.search(text) for rx in self.moods[mood]):
                return mood
        return "neutral"

    def is_noise_topic(self, topic: str) -> bool:
        t = topic.strip().lower()
        # CJK topics carry word-level meaning per character — the zh/ja/ko
        # packs deliberately capture 2-char topics (安全, 部署, 보안), so the
        # fragment floor is 2 there and 3 for alphabetic scripts.
        min_len = 2 if _CJK.search(t) else 3
        if len(t) < min_len or len(t) > 60:
            return True  # fragments and run-on captures are never topics
        if "\n" in t:
            return True  # a capture spanning lines grabbed prose, not a topic
        if t in self.topic_blacklist:
            return True  # exact entry — incl. multi-word custom phrases
        words = t.split()  # non-empty: len(t) >= 2 on a stripped string
        if all(w in self.topic_blacklist for w in words):
            return True  # every word blacklisted — "that something"
        return words[0] in self.noise_prefixes

    def infer_priority(self, text: str) -> str:
        lower = text.lower()
        return "high" if any(kw in lower for kw in self.high_impact) else "medium"
