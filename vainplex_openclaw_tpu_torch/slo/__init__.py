"""SLO load harness: deterministic seeded multi-tenant traffic through the
full gateway→governance→cortex→knowledge→events pipeline, with
p50/p95/p99 per stage and end-to-end, admission-control degradation at
saturation, and bit-reproducible simulated-time runs (``run_slo_report``);
the replica fleet's rate-modulated validator traffic in virtual time
(``run_fleet_slo_report``); and the five seeded attack packs
(``adversarial.py``) as ordinary ``Op`` streams, with
``run_adversarial_report`` gating zero verdict losses and victim-tenant
p99 isolation against a deterministic no-attack control.

The port's copy of ``vainplex_openclaw_tpu/slo/``; its exports are the JAX
package's, with ``generate_serve_texts`` besides."""

from .adversarial import (ADVERSARIAL_DEFAULTS, generate_adversarial_workload,
                          read_adversarial_state, run_adversarial_report,
                          run_redos_stage_gate, write_adversarial_state)
from .harness import (run_fleet_slo_report, run_slo_report, sim_severity,
                      slo_stage_records)
from .workload import (generate_fleet_workload, generate_serve_texts,
                       generate_workload, workload_digest)

__all__ = ["ADVERSARIAL_DEFAULTS", "generate_adversarial_workload",
           "generate_fleet_workload", "generate_serve_texts",
           "generate_workload", "read_adversarial_state",
           "run_adversarial_report", "run_fleet_slo_report",
           "run_redos_stage_gate", "run_slo_report", "sim_severity",
           "slo_stage_records", "workload_digest", "write_adversarial_state"]
