"""Runtime witnesses for the port's benches and tests."""

from .witness import RetraceWitness, launch_counters

__all__ = ["RetraceWitness", "launch_counters"]
