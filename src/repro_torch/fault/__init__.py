"""Fault tolerance for the port's query and serving path, copies of the
reference's ``repro.fault``:

* :mod:`repro_torch.fault.errors` — structured failure values
  (:class:`OwnerError`, :class:`OwnerFailure`, :class:`IntegrityError`,
  :class:`InjectedFault`);
* :mod:`repro_torch.fault.injection` — the deterministic fault-injection
  harness (:class:`FaultPlan` / :class:`FaultSpec` plus the
  ``maybe_fail`` / ``corrupt`` site hooks);
* :mod:`repro_torch.fault.retry` — bounded retry with exponential backoff
  and per-owner deadlines (:class:`RetryPolicy`, :func:`call_guarded`);
* :mod:`repro_torch.fault.health` — consecutive-failure + latency-EWMA
  health scoring driving replica failover (:class:`HealthTracker`).

Like ``obs``, the package sits at the bottom of the layering: it
imports nothing of the port but ``repro_torch.obs``.
"""

from repro_torch.fault.errors import (
    InjectedFault,
    IntegrityError,
    OwnerError,
    OwnerFailure,
)
from repro_torch.fault.health import HealthPolicy, HealthTracker
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
from repro_torch.fault.retry import (
    DEFAULT_POLICY,
    FAIL_FAST,
    GuardedOutcome,
    RetryPolicy,
    call_guarded,
)

__all__ = [
    "DEFAULT_POLICY",
    "FAIL_FAST",
    "KINDS",
    "SITES",
    "FaultEvent",
    "FaultPlan",
    "FaultSpec",
    "GuardedOutcome",
    "HealthPolicy",
    "HealthTracker",
    "InjectedFault",
    "IntegrityError",
    "OwnerError",
    "OwnerFailure",
    "RetryPolicy",
    "active",
    "call_guarded",
    "corrupt",
    "maybe_fail",
]
