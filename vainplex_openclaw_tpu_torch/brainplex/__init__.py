"""brainplex — the installer CLI (reference: packages/brainplex).

Standalone entry point (``python -m vainplex_openclaw_tpu_torch.brainplex.cli
init``): discovers the OpenClaw install, generates per-plugin default
configs, plans and executes plugin enablement, and merges plugin entries
into openclaw.json — atomically, never overwriting existing configs, with
timestamped backups.

The port's copy of ``vainplex_openclaw_tpu/brainplex/``. The configs it
writes are the ones the port's five plugins (``governance``, ``cortex``,
``events``, ``knowledge``, ``sitrep``) load; it imports nothing of the JAX
package.
"""
