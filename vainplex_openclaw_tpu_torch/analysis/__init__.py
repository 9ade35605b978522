"""Runtime witnesses for the port's benches and tests, the ReDoS screen,
and ``_builtin_policies``, the enumeration of every builtin governance
policy that the screen and the adversarial ReDoS pack cover (a copy of
``vainplex_openclaw_tpu/analysis/__init__.py``'s, kept here so the port
imports nothing of the JAX package)."""

from .witness import RetraceWitness, launch_counters

__all__ = ["RetraceWitness", "launch_counters"]


def _builtin_policies() -> list:
    """EVERY builtin policy, through the canonical enumeration
    (``get_builtin_policies``) with all features enabled. The enable-all
    config is built by introspecting the enumerator's own
    ``config.get("…")`` reads (every builder accepts a truthy non-dict and
    falls back to its defaults), so a newly added builtin is screened the
    day it lands."""
    import inspect
    import re as _re
    from ..governance.builtin_policies import get_builtin_policies
    keys = set(_re.findall(r'config\.get\("(\w+)"\)',
                           inspect.getsource(get_builtin_policies)))
    # Known builders, kept as a floor in case the enumerator's config
    # plumbing is ever refactored away from config.get literals.
    keys |= {"nightMode", "credentialGuard", "productionSafeguard",
             "rateLimiter"}
    return get_builtin_policies({k: True for k in sorted(keys)})
