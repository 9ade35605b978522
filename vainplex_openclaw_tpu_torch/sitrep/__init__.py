"""Situation-report generation (reference: packages/openclaw-sitrep —
deprecated upstream in favor of openclaw-leuko, still part of the capability
surface: interval aggregation of 6 collectors + custom commands into
sitrep.json with a health rollup).

The port's copy of ``vainplex_openclaw_tpu/sitrep``: its ``/ops`` reads the
port's model registries."""

from .plugin import SitrepPlugin
from .aggregator import generate_sitrep

__all__ = ["SitrepPlugin", "generate_sitrep"]
