"""Human-in-the-loop 2FA approval (reference: governance/src/approval-2fa.ts,
matrix-poller.ts; TOTP per RFC 6238 implemented on stdlib hmac — the
reference uses the otpauth package).

The port's copy of ``vainplex_openclaw_tpu/governance/approval/``: JAX's
names, defaults and messages, host code only (no kernel); the port imports
nothing of the JAX package."""

from .approval2fa import Approval2FA, DEFAULT_2FA_CONFIG
from .totp import Totp, generate_base32_secret
from .poller import MatrixPoller

__all__ = ["Approval2FA", "DEFAULT_2FA_CONFIG", "MatrixPoller", "Totp",
           "generate_base32_secret"]
