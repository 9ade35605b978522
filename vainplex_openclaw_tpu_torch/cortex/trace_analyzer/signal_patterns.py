"""Signal-detection language packs ×10: a copy of
``vainplex_openclaw_tpu/cortex/trace_analyzer/signal_patterns.py``.

Per language: correction indicators + short negatives, dissatisfaction
indicators + satisfaction overrides + resolution indicators, completion
claims. Merged+compiled once per analyzer run.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field


@dataclass(frozen=True)
class SignalPack:
    code: str
    correction: tuple[str, ...]
    short_negatives: tuple[str, ...]
    dissatisfaction: tuple[str, ...]
    satisfaction_overrides: tuple[str, ...]
    resolution: tuple[str, ...]
    completion_claims: tuple[str, ...]
    flags: int = re.IGNORECASE


SIGNAL_PACKS: dict[str, SignalPack] = {}


def _sp(**kw) -> None:
    pack = SignalPack(**kw)
    SIGNAL_PACKS[pack.code] = pack


_sp(code="en",
    correction=(r"\b(?:no[,.]? (?:that'?s|it'?s|you)|that'?s (?:wrong|not right|incorrect)|"
                r"actually[, ]|not (?:what|true)|you (?:mis|got it wrong)|wrong\b|incorrect\b)",),
    short_negatives=(r"^\s*(?:no|nope|nah)\s*[.!]?\s*$",),
    dissatisfaction=(r"(?:doesn'?t work|still (?:broken|failing|not working)|useless|"
                     r"give up|forget it|this is (?:wrong|bad)|not helpful|frustrat)",),
    satisfaction_overrides=(r"(?:thanks|thank you|works now|perfect|great|solved|fixed it)",),
    resolution=(r"(?:fixed|sorted|here'?s the corrected|my apologies|let me fix|corrected)",),
    completion_claims=(r"(?:successfully|completed|is (?:now )?(?:done|ready|deployed|fixed)|"
                       r"I(?:'ve| have) (?:finished|completed|deployed|fixed|created|updated))",))

_sp(code="de",
    correction=(r"(?:nein[,.]? das|das (?:ist|stimmt) (?:falsch|nicht)|eigentlich|"
                r"falsch\b|nicht richtig|du irrst)",),
    short_negatives=(r"^\s*(?:nein|nö|ne)\s*[.!]?\s*$",),
    dissatisfaction=(r"(?:funktioniert nicht|immer noch kaputt|nutzlos|vergiss es|"
                     r"gib'?s auf|das bringt nichts|frustrierend)",),
    satisfaction_overrides=(r"(?:danke|läuft jetzt|perfekt|super|gelöst|behoben)",),
    resolution=(r"(?:behoben|korrigiert|entschuldigung|hier die korrektur)",),
    completion_claims=(r"(?:erfolgreich|abgeschlossen|ist (?:jetzt )?(?:fertig|bereit|erledigt)|"
                       r"ich habe .{0,30}(?:erstellt|behoben|aktualisiert|deployed))",))

_sp(code="fr",
    correction=(r"(?:non[,.]? c'?est|c'?est (?:faux|incorrect)|en fait|pas (?:vrai|ça)|tu te trompes)",),
    short_negatives=(r"^\s*non\s*[.!]?\s*$",),
    dissatisfaction=(r"(?:ne (?:marche|fonctionne) pas|toujours cassé|inutile|laisse tomber|frustrant)",),
    satisfaction_overrides=(r"(?:merci|ça marche|parfait|génial|résolu|corrigé)",),
    resolution=(r"(?:corrigé|réparé|désolé|voici la correction)",),
    completion_claims=(r"(?:avec succès|terminé|est (?:maintenant )?(?:prêt|fait|déployé)|"
                       r"j'?ai (?:fini|terminé|créé|corrigé|déployé))",))

_sp(code="es",
    correction=(r"(?:no[,.]? eso|eso (?:es|está) (?:mal|incorrecto)|en realidad|no es (?:así|cierto)|te equivocas)",),
    short_negatives=(r"^\s*no\s*[.!]?\s*$",),
    dissatisfaction=(r"(?:no funciona|sigue (?:roto|fallando)|inútil|olvídalo|déjalo|frustrante)",),
    satisfaction_overrides=(r"(?:gracias|ya funciona|perfecto|genial|resuelto|arreglado)",),
    resolution=(r"(?:arreglado|corregido|disculpa|aquí está la corrección)",),
    completion_claims=(r"(?:con éxito|completado|está (?:ahora )?(?:listo|hecho|desplegado)|"
                       r"he (?:terminado|completado|creado|arreglado|desplegado))",))

_sp(code="pt",
    correction=(r"(?:não[,.]? isso|isso (?:é|está) (?:errado|incorreto)|na verdade|não é (?:assim|verdade)|você errou)",),
    short_negatives=(r"^\s*não\s*[.!]?\s*$",),
    dissatisfaction=(r"(?:não funciona|continua (?:quebrado|falhando)|inútil|esquece|deixa|frustrante)",),
    satisfaction_overrides=(r"(?:obrigad[oa]|funciona agora|perfeito|ótimo|resolvido|consertado)",),
    resolution=(r"(?:consertado|corrigido|desculpa|aqui está a correção)",),
    completion_claims=(r"(?:com sucesso|concluído|está (?:agora )?(?:pronto|feito|implantado)|"
                       r"eu (?:terminei|concluí|criei|consertei|implantei))",))

_sp(code="it",
    correction=(r"(?:no[,.]? (?:questo|quello)|(?:è|questo è) (?:sbagliato|errato)|in realtà|non è (?:così|vero)|ti sbagli)",),
    short_negatives=(r"^\s*no\s*[.!]?\s*$",),
    dissatisfaction=(r"(?:non funziona|ancora (?:rotto|guasto)|inutile|lascia (?:stare|perdere)|frustrante)",),
    satisfaction_overrides=(r"(?:grazie|ora funziona|perfetto|ottimo|risolto|sistemato)",),
    resolution=(r"(?:sistemato|corretto|scusa|ecco la correzione)",),
    completion_claims=(r"(?:con successo|completato|è (?:ora )?(?:pronto|fatto|deployato)|"
                       r"ho (?:finito|completato|creato|sistemato|deployato))",))

_sp(code="zh", flags=0,
    correction=(r"(?:不对|不是这样|错了|其实|搞错了|你理解错)",),
    short_negatives=(r"^\s*(?:不|不是|没有)\s*[。!]?\s*$",),
    dissatisfaction=(r"(?:不行|还是(?:坏的|不行|报错)|没用|算了|放弃|太烦了)",),
    satisfaction_overrides=(r"(?:谢谢|可以了|好了|完美|解决了|修好了)",),
    resolution=(r"(?:修好了|改好了|抱歉|已修复|更正)",),
    completion_claims=(r"(?:成功|已完成|已经(?:部署|修复|创建|更新)|做完了|搞定了)",))

_sp(code="ja", flags=0,
    correction=(r"(?:違います|間違って|そうじゃなくて|実は|誤解です)",),
    short_negatives=(r"^\s*(?:いいえ|いや|違う)\s*[。!]?\s*$",),
    dissatisfaction=(r"(?:動きません|まだ(?:壊れて|ダメ|エラー)|役に立たない|もういい|諦め)",),
    satisfaction_overrides=(r"(?:ありがとう|動きました|完璧|解決しました|直りました)",),
    resolution=(r"(?:修正しました|直しました|すみません|訂正)",),
    completion_claims=(r"(?:成功|完了しました|(?:デプロイ|修正|作成|更新)(?:しました|済み)|できました)",))

_sp(code="ko", flags=0,
    correction=(r"(?:아니요|틀렸|그게 아니|사실은|잘못 이해)",),
    short_negatives=(r"^\s*(?:아니|아뇨|아니요)\s*[.!]?\s*$",),
    dissatisfaction=(r"(?:안 돼|여전히 (?:고장|안 됨|에러)|소용없|됐어|포기)",),
    satisfaction_overrides=(r"(?:감사|고마워|이제 돼|완벽|해결|고쳤)",),
    resolution=(r"(?:고쳤습니다|수정했습니다|죄송|정정)",),
    completion_claims=(r"(?:성공|완료했|(?:배포|수정|생성|업데이트)했|다 됐)",))

_sp(code="ru",
    correction=(r"(?:нет[,.]? это|это (?:неверно|неправильно|не так)|на самом деле|ты ошиб)",),
    short_negatives=(r"^\s*(?:нет|не)\s*[.!]?\s*$",),
    dissatisfaction=(r"(?:не работает|всё ещё (?:сломано|падает)|бесполезно|забудь|сдаюсь|бесит)",),
    satisfaction_overrides=(r"(?:спасибо|теперь работает|отлично|идеально|решено|починил)",),
    resolution=(r"(?:исправлено|починил|извините|вот исправление)",),
    completion_claims=(r"(?:успешно|завершено|(?:готово|сделано|задеплоено)|"
                       r"я (?:закончил|создал|исправил|обновил|задеплоил))",))


@dataclass
class CompiledSignalPatterns:
    correction: list = field(default_factory=list)
    short_negatives: list = field(default_factory=list)
    dissatisfaction: list = field(default_factory=list)
    satisfaction_overrides: list = field(default_factory=list)
    resolution: list = field(default_factory=list)
    completion_claims: list = field(default_factory=list)


def compile_signal_patterns(codes) -> CompiledSignalPatterns:
    out = CompiledSignalPatterns()
    for code in codes:
        pack = SIGNAL_PACKS.get(code)
        if pack is None:
            continue
        for attr in ("correction", "short_negatives", "dissatisfaction",
                     "satisfaction_overrides", "resolution", "completion_claims"):
            getattr(out, attr).extend(re.compile(p, pack.flags)
                                      for p in getattr(pack, attr))
    return out
