"""ERC-8004 on-chain agent reputation over raw JSON-RPC ``eth_call``
(reference: governance/src/security/erc8004-client.ts:13-200+,
erc8004-provider.ts).

Zero chain dependencies: hand-rolled ABI encode/decode, DI'd ``rpc_post``
(zero-egress environments and tests stub it), LRU+TTL cache, tier
classification, read-only (the feedback write path was removed upstream).
An RPC failure is not cached and fails open (``rpc_unavailable``).

A copy of ``vainplex_openclaw_tpu/governance/security/erc8004.py``, kept
here so the port imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from typing import Callable, Optional

DEFAULT_IDENTITY_REGISTRY = "0x8004A169FB4a3325136EB29fA0ceB6D2e539a432"
DEFAULT_RPC_URL = "https://mainnet.base.org"

SELECTOR_OWNER_OF = "0x6352211e"            # ownerOf(uint256)
SELECTOR_GET_AGENT_PROFILE = "0xc0c53b8b"   # getAgentProfile(uint256)

ZERO_ADDRESS = "0x" + "0" * 40


def encode_uint256(value: int) -> str:
    return format(int(value), "x").zfill(64)


def decode_address(hex_str: str) -> str:
    clean = hex_str[2:] if hex_str.startswith("0x") else hex_str
    if len(clean) < 64:
        return ZERO_ADDRESS
    return "0x" + clean[24:64]


def decode_uint256(hex_str: str) -> int:
    clean = hex_str[2:] if hex_str.startswith("0x") else hex_str
    if not clean or set(clean) == {"0"}:
        return 0
    return int(clean, 16)


def decode_agent_profile(hex_str: str) -> dict:
    """Lenient decode of [address owner, uint256 feedbackCount,
    uint256 reputationScore]; short responses → safe defaults."""
    clean = hex_str[2:] if hex_str.startswith("0x") else hex_str
    if len(clean) < 192:
        return {"owner": ZERO_ADDRESS, "feedback_count": 0, "reputation_score": 0}
    return {
        "owner": decode_address("0x" + clean[0:64]),
        "feedback_count": decode_uint256("0x" + clean[64:128]),
        "reputation_score": decode_uint256("0x" + clean[128:192]),
    }


def classify_tier(score: int, feedback_count: int) -> str:
    if feedback_count == 0:
        return "unproven"
    if score >= 80:
        return "excellent"
    if score >= 60:
        return "good"
    if score >= 40:
        return "mixed"
    return "poor"


@dataclass
class _CacheEntry:
    result: dict
    expiry: float
    last_access: float


def _default_rpc_post(url: str, payload: dict, timeout: float = 10.0) -> dict:
    from urllib.request import Request, urlopen

    req = Request(url, data=json.dumps(payload).encode(),
                  headers={"Content-Type": "application/json"})
    with urlopen(req, timeout=timeout) as resp:  # noqa: S310 — operator-configured RPC
        return json.loads(resp.read().decode())


class ERC8004Provider:
    def __init__(self, config: Optional[dict] = None, logger=None,
                 rpc_post: Callable = _default_rpc_post,
                 clock: Callable[[], float] = time.time,
                 cache_max: int = 256, cache_ttl_s: float = 600.0):
        config = config or {}
        self.rpc_url = config.get("rpcUrl", DEFAULT_RPC_URL)
        self.registry = config.get("identityRegistry", DEFAULT_IDENTITY_REGISTRY)
        self.logger = logger
        self.rpc_post = rpc_post
        self.clock = clock
        self.cache_max = cache_max
        self.cache_ttl_s = cache_ttl_s
        self._cache: dict[int, _CacheEntry] = {}

    def _eth_call(self, to: str, data: str) -> Optional[str]:
        payload = {"jsonrpc": "2.0", "id": 1, "method": "eth_call",
                   "params": [{"to": to, "data": data}, "latest"]}
        try:
            response = self.rpc_post(self.rpc_url, payload)
        except Exception as exc:  # noqa: BLE001 — chain reads are best-effort
            if self.logger is not None:
                self.logger.warn(f"[erc8004] eth_call failed: {exc}")
            return None
        return response.get("result")

    def _cache_get(self, token_id: int) -> Optional[dict]:
        entry = self._cache.get(token_id)
        now = self.clock()
        if entry is None or entry.expiry <= now:
            self._cache.pop(token_id, None)
            return None
        entry.last_access = now
        return entry.result

    def _cache_put(self, token_id: int, result: dict) -> None:
        now = self.clock()
        if len(self._cache) >= self.cache_max:
            evict = min(self._cache, key=lambda k: self._cache[k].last_access)
            del self._cache[evict]
        self._cache[token_id] = _CacheEntry(result, now + self.cache_ttl_s, now)

    def lookup_reputation(self, token_id: int) -> dict:
        cached = self._cache_get(token_id)
        if cached is not None:
            return {**cached, "from_cache": True}

        owner_hex = self._eth_call(self.registry,
                                   SELECTOR_OWNER_OF + encode_uint256(token_id))
        if owner_hex is None:
            return {"exists": False, "error": "rpc_unavailable"}
        owner = decode_address(owner_hex)
        if owner == ZERO_ADDRESS:
            result = {"exists": False, "tier": "unknown"}
            self._cache_put(token_id, result)
            return result

        profile_hex = self._eth_call(self.registry,
                                     SELECTOR_GET_AGENT_PROFILE + encode_uint256(token_id))
        profile = decode_agent_profile(profile_hex or "")
        result = {
            "exists": True,
            "owner": owner,
            "feedback_count": profile["feedback_count"],
            "reputation_score": profile["reputation_score"],
            "tier": classify_tier(profile["reputation_score"], profile["feedback_count"]),
        }
        self._cache_put(token_id, result)
        return result
