"""The replica fleet's half of the JAX package's SLO harness: rate-modulated
(diurnal/burst) validator traffic in virtual seconds
(``generate_fleet_workload``) driven through a real ``ReplicaFleet`` in
virtual time (``run_fleet_slo_report``), bit-reproducible per seed, and
the gateway mix the cluster storms draw from (``generate_workload``). The
gateway harness and the adversarial packs are not ported yet, apart from
the sitrep's reader of the adversarial state file."""

from .adversarial import read_adversarial_state
from .harness import run_fleet_slo_report, sim_severity
from .workload import (generate_fleet_workload, generate_serve_texts,
                       generate_workload, workload_digest)

__all__ = ["generate_fleet_workload",
           "generate_serve_texts", "generate_workload", "read_adversarial_state",
           "run_fleet_slo_report", "sim_severity", "workload_digest"]
