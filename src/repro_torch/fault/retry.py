"""Bounded retry with exponential backoff and per-owner deadlines.

A copy of ``repro.fault.retry`` with its imports rewritten to the port, which
imports nothing of ``repro``.

:func:`call_guarded` is the single retry loop used by every fan-out
site (shard visits, federation member visits).  It turns an arbitrary
callable's failure into a structured
:class:`~repro_torch.fault.errors.OwnerError` *value* instead of letting the
exception kill the plan, and counts retries / terminal failures into
the ``deepmap_fault_*`` metric families.

Backoff is computed, not drawn: ``backoff_s * multiplier**(attempt-1)``
capped at ``max_backoff_s`` — deterministic, so fault tests replay
identically.  Deadlines are cooperative: the loop checks the monotonic
clock *between* attempts (it cannot interrupt a stuck callable — that
is what the delay-injection site plus small deadlines simulate in
tests).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

from repro_torch import obs
from repro_torch.fault.errors import OwnerError


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Retry/backoff/deadline knobs for one fan-out site.

    ``max_attempts`` counts the first try (1 = no retry).
    ``deadline_s`` bounds the *total* wall time across attempts for one
    owner; ``None`` disables the deadline.  The default policy retries
    twice with 1 ms initial backoff — fast enough for tests, real
    deployments tune it per store.
    """

    max_attempts: int = 3
    backoff_s: float = 0.001
    backoff_multiplier: float = 2.0
    max_backoff_s: float = 0.05
    deadline_s: Optional[float] = None

    def __post_init__(self) -> None:
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.backoff_s < 0 or self.max_backoff_s < 0:
            raise ValueError("backoff must be >= 0")
        if self.backoff_multiplier < 1.0:
            raise ValueError("backoff_multiplier must be >= 1")
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError("deadline_s must be > 0")

    def backoff(self, attempt: int) -> float:
        """Sleep before ``attempt`` (1-based retry index)."""
        if attempt < 1:
            return 0.0
        return min(
            self.backoff_s * (self.backoff_multiplier ** (attempt - 1)),
            self.max_backoff_s,
        )


#: Policy used when a store is built without explicit fault tuning.
DEFAULT_POLICY = RetryPolicy()

#: No retries, no deadline — the legacy fail-fast behaviour, used for
#: mutation fan-out where retrying a half-applied write is unsafe.
FAIL_FAST = RetryPolicy(max_attempts=1)


@dataclasses.dataclass(frozen=True)
class GuardedOutcome:
    """Result of :func:`call_guarded`: exactly one of ``value`` /
    ``error`` is meaningful (``ok`` tells which); ``retries`` counts
    attempts beyond the first; ``latency_s`` the total wall time."""

    ok: bool
    value: object
    error: Optional[OwnerError]
    retries: int
    latency_s: float


def call_guarded(
    fn: Callable[[int], object],
    *,
    owner: str,
    site: str,
    policy: RetryPolicy = DEFAULT_POLICY,
) -> GuardedOutcome:
    """Run ``fn(attempt_index)`` under ``policy``, capturing failure.

    ``fn`` receives the 0-based attempt index so callers can
    distinguish "use the already-dispatched handle" (attempt 0) from
    "re-dispatch fresh" (attempts >= 1) — a consumed async handle must
    not be collected twice.

    Never raises for ``fn``'s failures: returns a
    :class:`GuardedOutcome` whose ``error`` is the structured
    :class:`OwnerError` after the last attempt (or a deadline kill).
    ``BaseException``s that are not ``Exception`` (KeyboardInterrupt,
    SystemExit) propagate.
    """
    reg = obs.registry()
    start = time.monotonic()
    last: Optional[BaseException] = None
    attempt = 0
    while attempt < policy.max_attempts:
        if policy.deadline_s is not None and attempt > 0:
            if time.monotonic() - start >= policy.deadline_s:
                break
        if attempt > 0:
            reg.counter(
                "deepmap_fault_retries_total",
                "Retry attempts (beyond the first try), by site.",
            ).inc(site=site)
            pause = policy.backoff(attempt)
            if pause > 0.0:
                time.sleep(pause)
        try:
            value = fn(attempt)
        except Exception as exc:  # noqa: BLE001 — captured as OwnerError
            last = exc
            attempt += 1
            continue
        latency = time.monotonic() - start
        if policy.deadline_s is not None and latency >= policy.deadline_s:
            # The attempt "succeeded" but blew the owner deadline —
            # treat as failure so slow owners degrade instead of
            # stalling the plan (delay-injection exercises this).
            err = OwnerError(
                owner=owner, site=site, attempts=attempt + 1,
                error_type="DeadlineExceeded",
                message=f"owner exceeded deadline of {policy.deadline_s}s",
                deadline_exceeded=True,
            )
            _note_terminal(reg, site, deadline=True)
            return GuardedOutcome(
                ok=False, value=None, error=err,
                retries=attempt, latency_s=latency,
            )
        return GuardedOutcome(
            ok=True, value=value, error=None,
            retries=attempt, latency_s=latency,
        )
    latency = time.monotonic() - start
    deadline_hit = (
        policy.deadline_s is not None
        and latency >= policy.deadline_s
        and attempt < policy.max_attempts
    )
    if last is None:
        error_type, message = "DeadlineExceeded", (
            f"owner exceeded deadline of {policy.deadline_s}s before any attempt"
        )
    else:
        error_type, message = type(last).__name__, str(last)
    err = OwnerError(
        owner=owner, site=site, attempts=max(attempt, 1),
        error_type=error_type, message=message,
        deadline_exceeded=deadline_hit,
    )
    _note_terminal(reg, site, deadline=deadline_hit)
    return GuardedOutcome(
        ok=False, value=None, error=err,
        retries=max(attempt - 1, 0), latency_s=latency,
    )


def _note_terminal(reg, site: str, *, deadline: bool) -> None:
    reg.counter(
        "deepmap_fault_owner_errors_total",
        "Terminal owner failures after retries, by site and cause.",
    ).inc(site=site, cause="deadline" if deadline else "error")
