"""Redaction subsystem (RFC-007; reference: governance/src/redaction/).

Three pieces: PatternRegistry (built-in + custom compiled patterns in
category priority order), RedactionVault (hash placeholders with TTL, never
persisted), RedactionEngine (recursive deep scan + string scan). Hook
layering lives in ``hooks.py``.

The port's copy of ``vainplex_openclaw_tpu/governance/redaction/``: JAX's
names, defaults, patterns, hook priorities and failModes, host code only
(no kernel); the port imports nothing of the JAX package.
"""

from .engine import RedactionEngine, ScanResult
from .hooks import DEFAULT_REDACTION_CONFIG, RedactionState, init_redaction, register_redaction_hooks
from .registry import BUILTIN_PATTERNS, PatternRegistry
from .vault import PLACEHOLDER_RE, RedactionVault

__all__ = [
    "BUILTIN_PATTERNS",
    "DEFAULT_REDACTION_CONFIG",
    "PLACEHOLDER_RE",
    "PatternRegistry",
    "RedactionEngine",
    "RedactionState",
    "RedactionVault",
    "ScanResult",
    "init_redaction",
    "register_redaction_hooks",
]
