"""Structured failure values for the fault-tolerant query path.

A copy of ``repro.fault.errors`` with its imports rewritten to the port, which
imports nothing of ``repro``.

A failing owner (shard, federation member, device engine, artifact
file) must surface as *data* the caller can reason about, not as a
bare traceback that kills the plan.  :class:`OwnerError` is that
value: which owner failed, at which site, after how many attempts,
and why.  ``on_error('raise')`` plans wrap the captured errors in
:class:`OwnerFailure`; ``on_error('partial')`` plans carry them as
``ExplainStats.owners_failed`` evidence instead.

:class:`IntegrityError` is the checksum-verification failure raised by
the persistence layer — a corrupt artifact must fail loudly at load
time, never serve wrong values.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


class InjectedFault(RuntimeError):
    """Deterministic failure raised by the injection harness
    (:mod:`repro_torch.fault.injection`) at an instrumented site."""

    def __init__(self, site: str, owner: str | None = None):
        self.site = site
        self.owner = owner
        super().__init__(
            f"injected fault at site {site!r}"
            + (f" (owner {owner!r})" if owner is not None else "")
        )


class IntegrityError(ValueError):
    """A persisted artifact failed checksum verification (or is
    missing/truncated).  Raised at load time so corruption can never
    silently serve wrong values."""


@dataclasses.dataclass(frozen=True)
class OwnerError:
    """One owner's terminal failure, after retries — a value, not an
    exception, so partial-mode plans can carry it as evidence.

    ``owner`` names the failing unit (``"shard:3"``, ``"member:1"``,
    ``"store"``); ``site`` the instrumented failure site; ``attempts``
    how many tries were made (0 = the owner was already quarantined and
    never tried); ``error_type``/``message`` describe the last cause;
    ``deadline_exceeded`` marks a per-owner deadline kill rather than a
    raised error.
    """

    owner: str
    site: str
    attempts: int
    error_type: str
    message: str
    deadline_exceeded: bool = False

    def describe(self) -> str:
        """Compact one-line form for explain output and error text."""
        why = "deadline exceeded" if self.deadline_exceeded else self.error_type
        return f"{self.owner}@{self.site}: {why} after {self.attempts} attempt(s)"


class OwnerFailure(RuntimeError):
    """Raised by ``on_error('raise')`` plans when one or more owners
    failed terminally.  Carries the structured :class:`OwnerError`
    values on ``.owners`` so callers can still inspect what failed."""

    def __init__(self, owners: Tuple[OwnerError, ...]):
        self.owners = tuple(owners)
        detail = "; ".join(o.describe() for o in self.owners)
        super().__init__(
            f"{len(self.owners)} owner(s) failed: {detail} — use "
            f"Query.on_error('partial') for degraded results"
        )
