"""The replica fleet: stage-3 validator traffic routed across replica
batchers on the card. The JAX package's ring, supervisor and worker are
not ported yet; the fleet runs standalone over an event transport."""

from .fleet import FLEET_DEFAULTS, ReplicaFleet, autoscale_decision

__all__ = ["FLEET_DEFAULTS", "ReplicaFleet", "autoscale_decision"]
