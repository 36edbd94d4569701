"""Fault tolerance for the port's read path: the structured failure
values (:mod:`repro_torch.fault.errors`) and the deterministic
fault-injection harness (:mod:`repro_torch.fault.injection`), copies of
the reference's.  Retry and health scoring (``repro.fault.retry``,
``repro.fault.health``) come with the cluster (ROADMAP item M8).

Like ``obs``, the package sits at the bottom of the layering: it
imports nothing of the port but ``repro_torch.obs``.
"""

from repro_torch.fault.errors import (
    InjectedFault,
    IntegrityError,
    OwnerError,
    OwnerFailure,
)
from repro_torch.fault.injection import (
    KINDS,
    SITES,
    FaultEvent,
    FaultPlan,
    FaultSpec,
    active,
    corrupt,
    maybe_fail,
)

__all__ = [
    "KINDS",
    "SITES",
    "FaultEvent",
    "FaultPlan",
    "FaultSpec",
    "InjectedFault",
    "IntegrityError",
    "OwnerError",
    "OwnerFailure",
    "active",
    "corrupt",
    "maybe_fail",
]
