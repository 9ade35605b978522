"""The port's ``governance/security/`` against the JAX package's.

The hand-rolled ABI codec (``encode_uint256``, the address, uint256 and
agent-profile decoders, ``classify_tier``) under ``hypothesis``: equal
results, or the same exception type, on any input. ``ERC8004Provider`` on
one scripted ``rpc_post`` and one virtual clock: lookups that hit, miss,
expire, evict the least recently used entry, meet a zero owner, a short
profile, an RPC exception (which fails open and is not cached) and a
``None`` result; equal results, equal RPC payloads, equal log lines and an
equal cache. ``AgentProofRestClient`` on one scripted ``http_request``:
the key file present, missing and empty, single and batch lookups, the
feedback queue's bound and its flush with retries; equal results and
calls.
"""

from __future__ import annotations

import random

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from helpers import FakeClock
from vainplex_openclaw_tpu.core import api as jax_api
from vainplex_openclaw_tpu.governance import security as jax_security
from vainplex_openclaw_tpu.governance.security import erc8004 as jax_erc
from vainplex_openclaw_tpu_torch.core import api as port_api
from vainplex_openclaw_tpu_torch.governance import security as port_security
from vainplex_openclaw_tpu_torch.governance.security import \
    erc8004 as port_erc

PACKAGES = {"jax": (jax_api, jax_security, jax_erc),
            "port": (port_api, port_security, port_erc)}

HEX = "0123456789abcdefABCDEF"


def both(fn_name: str, *args):
    """``fn_name`` of each package on ``args``: the result, or the
    exception's type."""
    out = []
    for mod in (jax_erc, port_erc):
        try:
            out.append(("ok", getattr(mod, fn_name)(*args)))
        except Exception as exc:  # noqa: BLE001 — compared between packages
            out.append(("raised", type(exc).__name__))
    return out


hex_strings = st.one_of(
    st.text(HEX, max_size=260),
    st.text(HEX, max_size=260).map(lambda s: "0x" + s),
    st.text(max_size=80))


@settings(max_examples=300, deadline=None)
@given(st.integers(min_value=-(2 ** 260), max_value=2 ** 260))
def test_encode_uint256_equals_jax(value):
    a, b = both("encode_uint256", value)
    assert a == b
    if 0 <= value < 2 ** 256:
        assert len(a[1]) == 64 and int(a[1], 16) == value


@settings(max_examples=300, deadline=None)
@given(hex_strings)
def test_decoders_equal_jax(hex_str):
    for name in ("decode_address", "decode_uint256", "decode_agent_profile"):
        a, b = both(name, hex_str)
        assert a == b


@settings(max_examples=200, deadline=None)
@given(st.integers(0, 2 ** 256 - 1), st.integers(0, 2 ** 256 - 1),
       st.integers(0, 2 ** 160 - 1))
def test_profile_round_trip_equals_jax(count, score, owner):
    word = "0x" + port_erc.encode_uint256(owner) + \
        port_erc.encode_uint256(count) + port_erc.encode_uint256(score)
    got = port_erc.decode_agent_profile(word)
    assert got == jax_erc.decode_agent_profile(word)
    assert got == {"owner": "0x" + format(owner, "040x"),
                   "feedback_count": count, "reputation_score": score}


@settings(max_examples=300, deadline=None)
@given(st.integers(-50, 200), st.integers(0, 5))
def test_classify_tier_equals_jax(score, count):
    assert port_erc.classify_tier(score, count) == \
        jax_erc.classify_tier(score, count)


def test_constants_equal_jax():
    for name in ("DEFAULT_IDENTITY_REGISTRY", "DEFAULT_RPC_URL",
                 "SELECTOR_OWNER_OF", "SELECTOR_GET_AGENT_PROFILE",
                 "ZERO_ADDRESS"):
        assert getattr(port_erc, name) == getattr(jax_erc, name)
    assert port_security.__all__ == jax_security.__all__


# ── ERC8004Provider: cache, TTL, LRU, fail-open ──────────────────────


def chain(seed: int) -> dict:
    """token -> (owner, feedback count, score), or the failure to raise."""
    rng = random.Random(seed)
    out = {}
    for token in range(1, 13):
        r = rng.random()
        if r < 0.15:
            out[token] = "zero"
        elif r < 0.25:
            out[token] = "raise"
        elif r < 0.32:
            out[token] = "short"
        elif r < 0.38:
            out[token] = "none"
        else:
            out[token] = (rng.getrandbits(160), rng.choice((0, 1, 7, 40)),
                          rng.randrange(101))
    return out


def rpc_for(data: dict, calls: list, flaky: set):
    def rpc_post(url, payload, timeout=10.0):
        calls.append([url, payload])
        call = payload["params"][0]["data"]
        selector, token = call[:10], int(call[10:], 16)
        entry = data.get(token, "zero")
        if entry == "raise" or (token in flaky and len(calls) % 3 == 0):
            raise OSError(f"rpc down for {token}")
        if entry == "none":
            return {"jsonrpc": "2.0", "id": 1}
        if entry == "zero":
            return {"result": "0x" + "0" * 64}
        if selector == port_erc.SELECTOR_OWNER_OF:
            owner = 0xABC if entry == "short" else entry[0]
            return {"result": "0x" + port_erc.encode_uint256(owner)}
        if entry == "short":
            return {"result": "0x" + "1" * 100}
        owner, count, score = entry
        return {"result": "0x" + "".join(port_erc.encode_uint256(v)
                                         for v in (owner, count, score))}

    return rpc_post


def run_provider(name: str, seed: int) -> dict:
    api, _, erc = PACKAGES[name]
    rng = random.Random(1000 + seed)
    data = chain(seed)
    calls = []
    clock = FakeClock()
    logger = api.list_logger()
    cfg = {"rpcUrl": "http://127.0.0.1:8545", **(
        {"identityRegistry": "0x" + "12" * 20} if seed % 2 else {})}
    p = erc.ERC8004Provider(cfg, logger, rpc_post=rpc_for(data, calls,
                                                           {3, 5, 8}),
                            clock=clock, cache_max=4, cache_ttl_s=600.0)
    out = []
    for _ in range(60):
        r = rng.random()
        if r < 0.8:
            token = rng.randrange(1, 14)
            out.append(["lookup", token, p.lookup_reputation(token)])
        else:
            out.append(["advance", clock.advance(rng.choice((30.0, 300.0,
                                                             601.0)))])
        out[-1].append(sorted(p._cache))
    cache = {k: [v.result, v.expiry, v.last_access]
             for k, v in sorted(p._cache.items())}
    return {"out": out, "calls": calls, "cache": cache,
            "log": logger.records, "registry": p.registry,
            "rpc_url": p.rpc_url}


@pytest.mark.parametrize("seed", range(6))
def test_provider_equals_jax(seed):
    jax_run, port_run = run_provider("jax", seed), run_provider("port", seed)
    assert port_run == jax_run
    results = [o[2] for o in port_run["out"] if o[0] == "lookup"]
    assert any(r.get("from_cache") for r in results)
    assert any(r.get("error") == "rpc_unavailable" for r in results)


def test_an_rpc_failure_is_not_cached_and_fails_open():
    for name in PACKAGES:
        api, _, erc = PACKAGES[name]
        calls = []
        state = {"down": True}

        def rpc_post(url, payload, timeout=10.0):
            calls.append(payload)
            if state["down"]:
                raise TimeoutError("no route")
            if payload["params"][0]["data"].startswith(
                    erc.SELECTOR_OWNER_OF):
                return {"result": "0x" + erc.encode_uint256(0xBEEF)}
            return {"result": "0x" + "".join(erc.encode_uint256(v)
                                             for v in (0xBEEF, 12, 85))}

        logger = api.list_logger()
        p = erc.ERC8004Provider({}, logger, rpc_post=rpc_post,
                                clock=FakeClock())
        assert p.lookup_reputation(7) == {"exists": False,
                                          "error": "rpc_unavailable"}
        assert p._cache == {} and len(calls) == 1
        assert logger.messages("warn") == ["[erc8004] eth_call failed: "
                                           "no route"]
        state["down"] = False
        first = p.lookup_reputation(7)
        assert first == {"exists": True, "owner": "0x" + format(0xBEEF, "040x"),
                         "feedback_count": 12, "reputation_score": 85,
                         "tier": "excellent"}
        assert p.lookup_reputation(7) == {**first, "from_cache": True}
        assert len(calls) == 3
        assert calls[0]["params"][0]["to"] == erc.DEFAULT_IDENTITY_REGISTRY


def test_provider_without_a_logger_fails_open():
    for _, _, erc in PACKAGES.values():
        def down(url, payload, timeout=10.0):
            raise OSError("down")

        p = erc.ERC8004Provider(None, None, rpc_post=down)
        assert p.lookup_reputation(1) == {"exists": False,
                                          "error": "rpc_unavailable"}
        assert p.rpc_url == erc.DEFAULT_RPC_URL


# ── AgentProofRestClient ─────────────────────────────────────────────


def run_agentproof(name: str, tmp_path, key: str | None, seed: int) -> dict:
    api, security, _ = PACKAGES[name]
    rng = random.Random(seed)
    key_path = tmp_path / f"{name}-key"
    if key is not None:
        key_path.write_text(key, encoding="utf-8")
    calls = []

    def http_request(method, url, headers, body=None, timeout=10.0):
        calls.append([method, url, headers, body])
        r = rng.random()
        if r < 0.3:
            raise ConnectionError(f"refused {len(calls)}")
        if url.endswith(":batch"):
            ids = body["agentIds"]
            return {"results": {a: {"score": len(a)} for a in ids[::2]}}
        if url.endswith("/reputation"):
            return {"agent": url.split("/")[-2], "score": len(calls)}
        return {"ok": True}

    logger = api.list_logger()
    client = security.AgentProofRestClient(
        {"baseUrl": "https://agentproof.example/api/",
         "apiKeyPath": str(key_path)}, logger, http_request=http_request,
        clock=FakeClock(), max_queue=5)
    out = []
    for i in range(12):
        out.append(client.lookup(f"agent-{i % 3}"))
    out.append(client.lookup_batch(["a", "bb", "ccc", "dddd"]))
    out.append(client.lookup_batch(["x"]))
    for i in range(8):
        client.queue_feedback(f"agent-{i}", "good" if i % 2 else "bad",
                              detail=f"d{i}")
    out.append(client.queued)
    for retries in (2, 1, 3, 2):
        out.append(client.flush_feedback(max_retries=retries))
        out.append(client.queued)
    out.append(list(client._feedback_queue))
    log = [[lvl, m.replace(str(tmp_path), "<tmp>").replace(f"{name}-key",
                                                           "<key>")]
           for lvl, m in logger.records]
    return {"out": out, "calls": calls, "log": log}


@pytest.mark.parametrize("key", ["secret-key\n", None, "  "])
@pytest.mark.parametrize("seed", range(2))
def test_agentproof_equals_jax(tmp_path, key, seed):
    jax_run = run_agentproof("jax", tmp_path, key, seed)
    port_run = run_agentproof("port", tmp_path, key, seed)
    assert port_run == jax_run
    if key is not None and key.strip():
        assert port_run["calls"]
        assert port_run["calls"][0][2] == {"Authorization":
                                           "Bearer secret-key"}
    else:
        assert port_run["calls"] == []


def test_agentproof_without_a_base_url_calls_nothing():
    for api, security, _ in PACKAGES.values():
        calls = []
        client = security.AgentProofRestClient(
            {"apiKeyPath": None}, api.list_logger(),
            http_request=lambda *a, **k: calls.append(a))
        assert client.lookup("x") is None
        assert client.lookup_batch(["x", "y"]) == {"x": None, "y": None}
        client.queue_feedback("x", "good")
        assert client.flush_feedback() == 0 and client.queued == 1
        assert calls == []
