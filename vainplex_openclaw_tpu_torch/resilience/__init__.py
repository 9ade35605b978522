"""Admission control for the serve queue, and deterministic fault
injection for the port's checkpoint and state writers."""

from .faults import (
    FaultError,
    FaultPlan,
    FaultSpec,
    active_plan,
    clear_plan,
    install_plan,
    installed,
    maybe_fail,
    write_with_faults,
)

__all__ = [
    "FaultError",
    "FaultPlan",
    "FaultSpec",
    "active_plan",
    "clear_plan",
    "install_plan",
    "installed",
    "maybe_fail",
    "write_with_faults",
]
