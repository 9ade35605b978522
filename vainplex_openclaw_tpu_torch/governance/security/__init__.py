"""External reputation providers (reference: governance/src/security/).

The port's copy of ``vainplex_openclaw_tpu/governance/security/``, host code
only (no kernel); the port imports nothing of the JAX package."""

from .erc8004 import (
    ERC8004Provider,
    decode_address,
    decode_agent_profile,
    decode_uint256,
    encode_uint256,
)
from .agentproof import AgentProofRestClient

__all__ = [
    "AgentProofRestClient",
    "ERC8004Provider",
    "decode_address",
    "decode_agent_profile",
    "decode_uint256",
    "encode_uint256",
]
