"""Workspace-sharded multi-worker gateway with lease-fenced failover, and
the replica fleet that serves stage-3 traffic on the card beside it.

The port's copy of ``vainplex_openclaw_tpu/cluster``, under JAX's names:
a :class:`ClusterSupervisor` shards tenant workspaces over in-process or
process workers (``worker.py``) on a consistent-hash ring with an
epoch-fenced lease table (``ring.py``), publishes every op on a route log
(memory, file or NATS transport), and moves workspaces by
failover (fence, journal replay, redelivery) or planned handoff. Each
worker runs the port's worker profile: governance with redaction and
cortex over the workspace journals. ``cluster.fleetServing`` arms the
port's :class:`ReplicaFleet` under the supervisor: its replicas are
scoped shared batchers on the card, a worker's failover redelivers their
in-flight requests to survivors, and ``retire_worker`` drains them first.

``cluster.enabled: false`` (the default) keeps the single-process gateway
path untouched; nothing here is built unless asked.
"""

from .fleet import FLEET_DEFAULTS, ReplicaFleet, autoscale_decision
from .ring import FENCE_FILE, HashRing, LeaseTable
from .supervisor import (CLUSTER_DEFAULTS, SHEDDABLE_KINDS,
                         ClusterSupervisor, build_route_transport)
from .worker import (InProcessWorker, ProcessWorker, WorkerCrashed,
                     build_worker_gateway, dispatch_op)

__all__ = [
    "CLUSTER_DEFAULTS",
    "ClusterSupervisor",
    "FENCE_FILE",
    "FLEET_DEFAULTS",
    "HashRing",
    "InProcessWorker",
    "LeaseTable",
    "ProcessWorker",
    "ReplicaFleet",
    "SHEDDABLE_KINDS",
    "WorkerCrashed",
    "autoscale_decision",
    "build_route_transport",
    "build_worker_gateway",
    "dispatch_op",
]
