"""The port's ``governance/approval/`` against the JAX package's.

TOTP codes at seeded times and secrets; one seeded script of requests,
batch closes, codes (valid, of the neighbouring periods, wrong, malformed,
replayed, from an intruder), clock advances, timeouts and cleanups through
each package's ``Approval2FA`` with ``wall_timers=False`` on one virtual
clock: every return value, every notification, every log line and every
command's resolution equal, with the batch ids (``uuid4``) named by their
order of appearance. The Matrix notifier and poller with one scripted
``http_put``/``http_get`` (a PUT failure and its retry, forward pagination,
event-id dedupe, non-text events, a failing poll and its retries) give
equal calls, codes and stats. ``CODE_RE`` is JAX's: six digits inside room
chatter count as a code attempt, and three such messages lock a pending
batch out (pinned in both packages). ``load_matrix_credentials`` reads
each file as JAX's does.
"""

from __future__ import annotations

import base64
import json
import random
import re

import pytest

from helpers import FakeClock
from vainplex_openclaw_tpu.core import api as jax_api
from vainplex_openclaw_tpu.governance.approval import approval2fa as jax_2fa
from vainplex_openclaw_tpu.governance.approval import matrix as jax_matrix
from vainplex_openclaw_tpu.governance.approval import poller as jax_poller
from vainplex_openclaw_tpu.governance.approval import totp as jax_totp
from vainplex_openclaw_tpu.resilience import policy as jax_policy
from vainplex_openclaw_tpu_torch.core import api as port_api
from vainplex_openclaw_tpu_torch.governance import approval as port_approval
from vainplex_openclaw_tpu_torch.governance.approval import \
    approval2fa as port_2fa
from vainplex_openclaw_tpu_torch.governance.approval import \
    matrix as port_matrix
from vainplex_openclaw_tpu_torch.governance.approval import \
    poller as port_poller
from vainplex_openclaw_tpu_torch.governance.approval import totp as port_totp
from vainplex_openclaw_tpu_torch.resilience import policy as port_policy

PACKAGES = {
    "jax": (jax_api, jax_2fa, jax_matrix, jax_poller, jax_totp, jax_policy),
    "port": (port_api, port_2fa, port_matrix, port_poller, port_totp,
             port_policy),
}
APPROVERS = ["@alice:m.org", "@bob:m.org"]
INTRUDER = "@mallory:m.org"
START = 1_700_000_000.0
UUID_RE = re.compile(r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-"
                     r"[0-9a-f]{12}")


def seeded_secret(seed: int, n: int = 20) -> str:
    raw = random.Random(seed).randbytes(n)
    return base64.b32encode(raw).decode().rstrip("=")


# ── TOTP ─────────────────────────────────────────────────────────────


@pytest.mark.parametrize("seed", range(4))
def test_totp_codes_equal_jax(seed):
    rng = random.Random(seed)
    secret = seeded_secret(seed, n=rng.choice((10, 16, 20, 32)))
    times = [0.0, 29.999, 30.0, 59.0] + [rng.uniform(0, 4e9)
                                         for _ in range(60)]
    jax_t = jax_totp.Totp(secret)
    port_t = port_totp.Totp(secret)
    assert [port_t.generate(t) for t in times] == \
        [jax_t.generate(t) for t in times]
    for digits, period, algorithm in ((8, 60, "sha256"), (6, 30, "sha512")):
        a = jax_totp.Totp(secret, digits, period, algorithm)
        b = port_totp.Totp(secret, digits, period, algorithm)
        assert [b.generate(t) for t in times] == [a.generate(t) for t in times]


@pytest.mark.parametrize("seed", range(3))
def test_totp_validate_equals_jax(seed):
    rng = random.Random(100 + seed)
    secret = seeded_secret(100 + seed)
    for _ in range(20):
        now = rng.uniform(1e9, 2e9)
        clock = FakeClock(now)
        a = jax_totp.Totp(secret, clock=clock)
        b = port_totp.Totp(secret, clock=clock)
        tokens = [a.generate(now + d * 30) for d in (-2, -1, 0, 1, 2)]
        tokens += ["12345", "1234567", "12a456", f"{rng.randrange(10**6):06d}"]
        for window in (0, 1, 2):
            assert [b.validate(t, window) for t in tokens] == \
                [a.validate(t, window) for t in tokens]
        assert b.current_period() == a.current_period()


def test_generated_secrets_decode_in_both():
    for n in (10, 20, 32):
        secret = port_approval.generate_base32_secret(n)
        assert re.fullmatch(r"[A-Z2-7]+", secret)
        assert jax_totp.Totp(secret).key == port_totp.Totp(secret).key
        assert len(port_totp.Totp(secret).key) == n


# ── Approval2FA on one seeded script ─────────────────────────────────


def approval_script(seed: int, n: int = 80) -> list:
    """Seeded ops: ``request`` (agent, tool, params), ``close`` (agent),
    ``code`` (kind, sender, agent, or ``any``), ``advance`` (seconds),
    ``timeout`` (agent) and ``cleanup``."""
    rng = random.Random(seed)
    agents = ("main", "forge", "scout")
    ops = []
    for _ in range(n):
        r = rng.random()
        agent = rng.choice(agents)
        if r < 0.32:
            ops.append(("request", agent, rng.choice(("exec", "write",
                                                      "deploy")),
                        {"command": f"cmd-{rng.randrange(1000)}",
                         "n": rng.randrange(5)}))
        elif r < 0.42:
            ops.append(("close", agent))
        elif r < 0.72:
            kind = rng.choice(("now", "now", "prev", "next", "old", "wrong",
                               "malformed", "replay"))
            sender = rng.choice(APPROVERS * 4 + [INTRUDER])
            ops.append(("code", kind, sender, rng.choice(agents + ("any",))))
        elif r < 0.86:
            ops.append(("advance", rng.choice((1.0, 10.0, 31.0, 65.0, 400.0,
                                               700.0))))
        elif r < 0.94:
            ops.append(("timeout", agent))
        else:
            ops.append(("cleanup",))
    return ops


def code_for(kind: str, totp, now: float, last: list) -> str:
    if kind == "malformed":
        return "12a456"
    if kind == "replay" and last:
        return last[-1]
    offset = {"now": 0, "prev": -30, "next": 30, "old": -95}.get(kind)
    if offset is None:  # wrong: not a code of any period near now
        near = {totp.generate(now + d * 30) for d in range(-3, 4)}
        return next(f"{c:06d}" for c in range(10**6) if f"{c:06d}" not in near)
    return totp.generate(now + offset)


def run_approval(name: str, seed: int) -> dict:
    api, mod2fa = PACKAGES[name][0], PACKAGES[name][1]
    clock = FakeClock(START)
    logger = api.list_logger()
    notes = []
    cfg = {"totpSecret": seeded_secret(seed), "approvers": APPROVERS,
           "batchWindowMs": 50, "timeoutSeconds": 300,
           "sessionDurationMinutes": 10, "maxAttempts": 3,
           "cooldownSeconds": 60}
    a = mod2fa.Approval2FA(cfg, logger, clock=clock, wall_timers=False)
    a.set_notify_fn(lambda agent, conv, msg: notes.append([agent, conv, msg]))
    batches, out, used = [], [], []
    for op in approval_script(seed):
        kind = op[0]
        if kind == "request":
            _, agent, tool, params = op
            res = a.request(agent, f"agent:{agent}", tool, params, "gated",
                            wait=False)
            b = a._batches.get(agent)
            if b is not None and all(b is not x for x in batches):
                batches.append(b)
            out.append(["request", res])
        elif kind == "close":
            b = a._batches.get(op[1])
            if b is not None:
                a.close_batch(b)
            out.append(["close", b is not None])
        elif kind == "code":
            _, ckind, sender, agent = op
            code = code_for(ckind, a.totp, clock(), used)
            if agent == "any":
                res = a.try_resolve_any(code, sender)
            else:
                res = a.try_resolve(code, sender, f"agent:{agent}")
            if res["status"] == "approved":
                used.append(code)
            out.append(["code", ckind, res])
        elif kind == "advance":
            clock.advance(op[1])
            out.append(["advance", clock()])
        elif kind == "timeout":
            b = a._batches.get(op[1])
            if b is not None:
                a.timeout_batch(b)
            out.append(["timeout", b is not None])
        else:
            a.cleanup_expired()
            out.append(["cleanup"])
        out[-1].append(a.pending_count())
    ids = {b.id: f"batch{i}" for i, b in enumerate(batches)}

    def unid(obj):
        text = json.dumps(obj, sort_keys=True)
        for bid, name_ in ids.items():
            text = text.replace(bid, name_)
        assert not UUID_RE.search(text)
        return json.loads(text)

    resolved = [[b.closed, b.attempts,
                 [[c.tool_name, c.params,
                   c.future.result() if c.future.done() else None]
                  for c in b.commands]] for b in batches]
    return unid({"out": out, "notes": notes, "resolved": resolved,
                 "log": [[lvl, msg] for lvl, msg in logger.records],
                 "state": [sorted(a._cooldowns.items()),
                           sorted(a._session_approvals.items()),
                           a._last_used_token]})


@pytest.mark.parametrize("seed", range(8))
def test_approval_script_equals_jax(seed):
    jax_run = run_approval("jax", seed)
    port_run = run_approval("port", seed)
    assert port_run == jax_run
    statuses = {o[2]["status"] for o in jax_run["out"] if o[0] == "code"}
    assert "approved" in statuses or "no_pending" in statuses


def test_the_scripts_reach_every_status():
    statuses, notes = set(), 0
    for seed in range(8):
        run = run_approval("port", seed)
        statuses |= {o[2]["status"] for o in run["out"] if o[0] == "code"}
        notes += len(run["notes"])
    # "cooldown" from try_resolve needs a batch that outlives its agent's
    # denial, which no sequence of the public calls makes
    assert statuses == {"approved", "invalid", "unauthorized", "replay",
                        "denied_cooldown", "no_pending"}
    assert notes > 0


@pytest.mark.parametrize("name", sorted(PACKAGES))
def test_missing_secret_raises_in_both(name):
    api, mod2fa = PACKAGES[name][0], PACKAGES[name][1]
    with pytest.raises(ValueError, match="2FA requires totpSecret"):
        mod2fa.Approval2FA({"enabled": True}, api.list_logger())


def test_defaults_and_summaries_equal_jax():
    assert port_2fa.DEFAULT_2FA_CONFIG == jax_2fa.DEFAULT_2FA_CONFIG
    for params in ({}, None, {"command": "ls"}, {"command": "y" * 500},
                   {"a": 1, "b": [1, 2], "c": {"d": "é"}}):
        for limit in (120, 10):
            assert port_2fa.summarize_params(params, limit) == \
                jax_2fa.summarize_params(params, limit)


def test_a_blocking_request_resolves_in_both():
    """``wait=True`` on a thread, resolved by a code from this thread; and
    the waiter's own timeout, which denies."""
    import threading

    for name in PACKAGES:
        api, mod2fa = PACKAGES[name][0], PACKAGES[name][1]
        clock = FakeClock(START)
        a = mod2fa.Approval2FA({"totpSecret": seeded_secret(1),
                                "approvers": APPROVERS}, api.list_logger(),
                               clock=clock, wall_timers=False)
        got = []
        t = threading.Thread(target=lambda: got.append(a.request(
            "main", "agent:main", "exec", {"command": "x"})))
        t.start()
        for _ in range(1000):
            if a.pending_count():
                break
            threading.Event().wait(0.005)
        assert a.try_resolve(a.totp.generate(), APPROVERS[0],
                             "agent:main")["status"] == "approved"
        t.join(timeout=10)
        assert not t.is_alive() and got == [{}]
        denied = a.request("scout", "agent:scout", "exec", {}, wait=True,
                           wait_timeout=0.01)
        assert denied == {"block": True,
                          "block_reason": "2FA approval timed out"}
        assert a.pending_count() == 0


# ── the Matrix notifier and poller ───────────────────────────────────

CREDS = {"homeserver": "https://m.org/", "accessToken": "syt_tok",
         "roomId": "!approvals:m.org", "userId": "@bot:m.org"}
TXN_RE = re.compile(r"claw2fa-[0-9a-f]{8}-")


def run_notifier(name: str) -> dict:
    api, matrix = PACKAGES[name][0], PACKAGES[name][2]
    calls, script = [], iter([OSError("reset"), {"event_id": "$1"},
                              {"event_id": "$2"}, OSError("down"),
                              OSError("still down"), {}, ValueError("x"),
                              {"event_id": "$3"}])

    def put(url, headers, body, timeout=10.0):
        calls.append([TXN_RE.sub("claw2fa-<nonce>-", url), headers, body])
        r = next(script)
        if isinstance(r, Exception):
            raise r
        return r

    logger = api.list_logger()
    n = matrix.MatrixNotifier(CREDS, logger, http_put=put,
                              clock=FakeClock(START))
    sent = [n.send("🔒 APPROVAL REQUIRED (1 command)"),
            n.send("second"), n.send("lost", retries=1),
            n.send("bare"), n.send("third", retries=3)]
    n.notify_fn()("main", "agent:main", "via adapter")
    return {"sent": sent, "calls": calls,
            "log": [[lvl, msg] for lvl, msg in logger.records]}


def test_notifier_equals_jax():
    jax_run, port_run = run_notifier("jax"), run_notifier("port")
    assert port_run == jax_run
    urls = [c[0] for c in port_run["calls"]]
    assert urls[0] == urls[1]  # the retry reuses its txn id
    # five sends and the adapter's call, which the spent script fails
    assert len(set(urls)) == 6


def msg(i: int, body: str, sender: str = APPROVERS[0],
        msgtype: str = "m.text", type_: str = "m.room.message",
        event_id=True) -> dict:
    ev = {"type": type_, "sender": sender,
          "content": {"msgtype": msgtype, "body": body}}
    if event_id:
        ev["event_id"] = f"$e{i}"
    return ev


POLL_SCRIPT = [
    {"chunk": [msg(0, "old history 999999")], "end": "s1"},
    {"chunk": [msg(1, "code is 123456 thanks"), msg(2, "424242"),
               msg(3, "notice 777777", msgtype="m.notice"),
               msg(4, "555555", type_="m.reaction")], "end": "s2"},
    {"chunk": [msg(2, "424242"), msg(5, "no code here"),
               msg(6, "111111", sender=INTRUDER)], "end": "s3"},
    OSError("502"), {"chunk": [msg(7, "987654")], "end": None},
    OSError("a"), OSError("b"), OSError("c"),
    {"chunk": [msg(8, "1234567 and 12345"), msg(9, "x 654321 y 222222",
                                                event_id=False)]},
    {"chunk": [], "end": "s/4+5"},
    {"chunk": [msg(10, "000001")], "end": "s5"},
]


def run_poller(name: str, script=POLL_SCRIPT, creds=CREDS) -> dict:
    api, poller_mod, policy = (PACKAGES[name][0], PACKAGES[name][3],
                               PACKAGES[name][5])
    calls, codes, it = [], [], iter(script)

    def get(url, headers, timeout=10.0):
        calls.append([url, headers])
        r = next(it)
        if isinstance(r, Exception):
            raise r
        return r

    logger = api.list_logger()
    retry = policy.RetryPolicy(max_attempts=3, base_delay_s=0.25,
                               max_delay_s=2.0, seed=0, sleep=lambda s: None)
    p = poller_mod.MatrixPoller(creds, lambda c, s: codes.append([c, s]),
                                logger, interval_s=0.01, http_get=get,
                                retry=retry)
    results = []
    for _ in range(8):
        try:
            results.append(p.poll_with_retry())
        except Exception as exc:  # noqa: BLE001 — recorded, as the loop logs it
            results.append(f"raised {exc}")
    return {"results": results, "calls": calls, "codes": codes,
            "stats": p.stats(), "seen": list(p._seen), "since": p._since,
            "log": [[lvl, m] for lvl, m in logger.records]}


def test_poller_equals_jax():
    jax_run, port_run = run_poller("jax"), run_poller("port")
    assert port_run == jax_run
    assert port_run["calls"][0][0].endswith("/messages?dir=b&limit=1")
    assert "dir=f&from=s1" in port_run["calls"][1][0]
    assert "%21approvals%3Am.org" in port_run["calls"][0][0]
    assert [c for c, _ in port_run["codes"]] == [
        "123456", "424242", "111111", "987654", "654321", "000001"]
    assert port_run["stats"]["pollFailures"] == 1
    assert "from=s%2F4%2B5" in port_run["calls"][-1][0]


def test_poller_seen_cap_equals_jax():
    """More event ids than ``SEEN_CAP``: the oldest are forgotten, so a
    replay of the first event dispatches again in both."""
    cap = port_poller.SEEN_CAP
    assert cap == jax_poller.SEEN_CAP
    script = [{"chunk": [], "end": "s0"},
              {"chunk": [msg(i, f"{i:06d}") for i in range(cap + 5)],
               "end": "s1"},
              {"chunk": [msg(0, "000000"), msg(cap + 4, "x")], "end": "s2"}]
    jax_run = run_poller("jax", script + [OSError("end")] * 12)
    port_run = run_poller("port", script + [OSError("end")] * 12)
    assert port_run == jax_run
    assert len(port_run["seen"]) == cap
    assert port_run["codes"][-1] == ["000000", APPROVERS[0]]


@pytest.mark.parametrize("name", sorted(PACKAGES))
def test_poller_thread_starts_and_stops(name):
    api, poller_mod = PACKAGES[name][0], PACKAGES[name][3]
    p = poller_mod.MatrixPoller(CREDS, lambda c, s: None, api.list_logger(),
                                interval_s=0.01,
                                http_get=lambda u, h, timeout=10.0: {
                                    "chunk": [], "end": "s"})
    p.start()
    p.start()  # idempotent
    thread = p._thread
    assert thread.name == "matrix-2fa-poller" and thread.daemon
    p.stop()
    thread.join(timeout=5)
    assert not thread.is_alive() and p._thread is None


# ── CODE_RE: JAX's, with its cost ────────────────────────────────────

CHATTER = ("ticket 123456 is closed", "build 20240101 done",
           "see PR #424242", "at 10:30:00 run 987654.", "version 1.234567",
           "call 555-123456", "x123456", "123456x", "１２３４５６",
           "codes 111111 222222")


def test_code_re_is_jax_and_finds_codes_in_chatter():
    assert port_poller.CODE_RE.pattern == jax_poller.CODE_RE.pattern
    found = [(m.group(1) if (m := port_poller.CODE_RE.search(t)) else None)
             for t in CHATTER]
    assert found == [(m.group(1) if (m := jax_poller.CODE_RE.search(t))
                      else None) for t in CHATTER]
    # incidental six-digit chatter counts as a code: a ticket id, a PR
    # number, a run id, a fractional part, a phone suffix, and the first
    # of two codes; a glued or eight-digit number does not
    assert found == ["123456", None, "424242", "987654", "234567", "123456",
                     None, None, "１２３４５６", "111111"]


@pytest.mark.parametrize("name", sorted(PACKAGES))
def test_chatter_burns_a_pending_batch(name):
    """Three chatter messages from an approver lock a pending batch out:
    the poller dispatches each as a code attempt, the third denies the
    batch's commands and starts the cooldown. Pinned as JAX's behaviour
    (a known risk of the reference's matching, kept in the port)."""
    api, mod2fa, _, poller_mod = PACKAGES[name][:4]
    clock = FakeClock(START)
    a = mod2fa.Approval2FA({"totpSecret": seeded_secret(5),
                            "approvers": APPROVERS}, api.list_logger(),
                           clock=clock, wall_timers=False)
    a.request("main", "agent:main", "exec", {"command": "deploy"},
              wait=False)
    near = {a.totp.generate(clock() + d * 30) for d in (-1, 0, 1)}
    texts = [t for t in ("ticket 123456 is closed", "see PR #424242",
                         "run 987654 failed", "call 555-131313")
             if port_poller.CODE_RE.search(t).group(1) not in near][:3]
    script = [{"chunk": [], "end": "s0"},
              {"chunk": [msg(i, t) for i, t in enumerate(texts)],
               "end": "s1"}]
    statuses = []
    p = poller_mod.MatrixPoller(
        CREDS, lambda code, sender: statuses.append(
            a.try_resolve_any(code, sender)["status"]),
        api.list_logger(), http_get=lambda u, h, timeout=10.0: script.pop(0))
    p.poll_once()
    assert p.poll_once() == 3
    assert statuses == ["invalid", "invalid", "denied_cooldown"]
    assert a.pending_count() == 0
    assert a.request("main", "agent:main", "exec", {}, wait=False)[
        "block_reason"].startswith("2FA cooldown active")


# ── credentials ──────────────────────────────────────────────────────

CRED_FILES = {
    "valid": json.dumps(CREDS),
    "no_user": json.dumps({k: v for k, v in CREDS.items() if k != "userId"}),
    "no_token": json.dumps({k: v for k, v in CREDS.items()
                            if k != "accessToken"}),
    "empty_room": json.dumps({**CREDS, "roomId": ""}),
    "list": json.dumps([CREDS]),
    "number": "7",
    "broken": '{"homeserver": ',
    "empty": "",
}


@pytest.mark.parametrize("case", sorted(CRED_FILES) + ["missing"])
def test_load_matrix_credentials_equals_jax(tmp_path, case):
    path = tmp_path / "creds.json"
    if case != "missing":
        path.write_text(CRED_FILES[case], encoding="utf-8")
    got = port_poller.load_matrix_credentials(str(path))
    assert got == jax_poller.load_matrix_credentials(str(path))
    assert (got is not None) == (case in ("valid", "no_user"))
