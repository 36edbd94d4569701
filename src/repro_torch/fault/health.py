"""Per-owner health scoring for replica failover.

A copy of ``repro.fault.health`` with its imports rewritten to the port, which
imports nothing of ``repro``.

:class:`HealthTracker` keeps, per owner: a consecutive-failure count, a
latency EWMA, and a quarantine flag.  ``fail_threshold`` consecutive
failures quarantine the owner; while quarantined it is skipped by
:meth:`pick` (failover) until a *probe* — every ``probe_every``-th pick
that would have skipped it routes one request through it deliberately.
A successful probe clears the quarantine; a failed probe re-arms it.

Scoring is pick-count driven, not wall-clock driven, so fault tests
replay deterministically.  The tracker is thread-safe (fan-out pool
threads record results concurrently) and emits
``deepmap_fault_quarantines_total`` / ``deepmap_fault_probes_total``.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence

from repro_torch import obs


@dataclasses.dataclass(frozen=True)
class HealthPolicy:
    """Quarantine/probe knobs.

    ``fail_threshold`` consecutive failures quarantine an owner;
    every ``probe_every``-th skip of a quarantined owner routes one
    probe request through it instead.  ``ewma_alpha`` is the latency
    smoothing factor (higher = more reactive).
    """

    fail_threshold: int = 2
    probe_every: int = 8
    ewma_alpha: float = 0.3

    def __post_init__(self) -> None:
        if self.fail_threshold < 1:
            raise ValueError("fail_threshold must be >= 1")
        if self.probe_every < 1:
            raise ValueError("probe_every must be >= 1")
        if not (0.0 < self.ewma_alpha <= 1.0):
            raise ValueError("ewma_alpha must be in (0, 1]")


@dataclasses.dataclass
class _OwnerHealth:
    consecutive_failures: int = 0
    quarantined: bool = False
    ewma_latency_s: Optional[float] = None
    skips_since_probe: int = 0
    successes: int = 0
    failures: int = 0


class HealthTracker:
    """Tracks owner health and answers "which replica should serve?".

    Owners are opaque string names (``"member:0"``...).  The tracker
    never raises on unknown owners — first contact lazily registers
    them healthy.
    """

    def __init__(self, policy: HealthPolicy = HealthPolicy()):
        self.policy = policy
        self._lock = threading.Lock()
        self._owners: Dict[str, _OwnerHealth] = {}  # guarded-by: _lock

    def _get(self, owner: str) -> _OwnerHealth:
        # Callers hold self._lock.
        state = self._owners.get(owner)
        if state is None:
            state = _OwnerHealth()
            # Lazy registration; every caller holds self._lock (see the
            # method contract above).
            self._owners[owner] = state  # deeplint: ignore[lock-discipline]
        return state

    # ------------------------------------------------------------ recording
    def record_success(self, owner: str, latency_s: float) -> bool:
        """Record a successful call; returns True if this recovered the
        owner out of quarantine (a successful probe)."""
        with self._lock:
            state = self._get(owner)
            recovered = state.quarantined
            state.quarantined = False
            state.consecutive_failures = 0
            state.skips_since_probe = 0
            state.successes += 1
            if state.ewma_latency_s is None:
                state.ewma_latency_s = float(latency_s)
            else:
                a = self.policy.ewma_alpha
                state.ewma_latency_s = (
                    a * float(latency_s) + (1.0 - a) * state.ewma_latency_s
                )
        if recovered:
            obs.registry().counter(
                "deepmap_fault_recoveries_total",
                "Owners recovered out of quarantine by a successful probe.",
            ).inc(owner=owner)
        return recovered

    def record_failure(self, owner: str) -> bool:
        """Record a failed call; returns True if this call *newly*
        quarantined the owner (threshold crossed)."""
        with self._lock:
            state = self._get(owner)
            state.failures += 1
            state.consecutive_failures += 1
            newly = (
                not state.quarantined
                and state.consecutive_failures >= self.policy.fail_threshold
            )
            if newly:
                state.quarantined = True
                state.skips_since_probe = 0
        if newly:
            obs.registry().counter(
                "deepmap_fault_quarantines_total",
                "Owners quarantined (consecutive failures, or corrupt "
                "artifacts at load).",
            ).inc(owner=owner)
        return newly

    # ------------------------------------------------------------- querying
    def is_quarantined(self, owner: str) -> bool:
        """Whether the owner is currently quarantined."""
        with self._lock:
            state = self._owners.get(owner)
            return bool(state is not None and state.quarantined)

    def latency(self, owner: str) -> Optional[float]:
        """Latency EWMA in seconds (None before first success)."""
        with self._lock:
            state = self._owners.get(owner)
            return None if state is None else state.ewma_latency_s

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        """Point-in-time health view for explain/debug output."""
        with self._lock:
            return {
                name: {
                    "quarantined": s.quarantined,
                    "consecutive_failures": s.consecutive_failures,
                    "ewma_latency_s": s.ewma_latency_s,
                    "successes": s.successes,
                    "failures": s.failures,
                }
                for name, s in self._owners.items()
            }

    # -------------------------------------------------------------- routing
    def pick(self, owners: Sequence[str], preferred: int) -> int:
        """Choose a serving replica among ``owners``.

        Starts from index ``preferred`` (the caller's primary or
        round-robin choice) and fails over to the next healthy owner in
        ring order.  Quarantined owners are skipped, except that every
        ``probe_every``-th skip deliberately routes through the
        quarantined owner as a probe (counted in
        ``deepmap_fault_probes_total``).  If *every* owner is
        quarantined, returns ``preferred`` — serving a possibly-dead
        replica beats refusing outright, and a success will recover it.
        """
        n = len(owners)
        if n == 0:
            raise ValueError("pick() needs at least one owner")
        preferred = int(preferred) % n
        probe_owner: Optional[str] = None
        choice = preferred
        with self._lock:
            for step in range(n):
                idx = (preferred + step) % n
                state = self._owners.get(owners[idx])
                if state is None or not state.quarantined:
                    choice = idx
                    break
                state.skips_since_probe += 1
                if state.skips_since_probe >= self.policy.probe_every:
                    state.skips_since_probe = 0
                    probe_owner = owners[idx]
                    choice = idx
                    break
            else:
                choice = preferred
        if probe_owner is not None:
            obs.registry().counter(
                "deepmap_fault_probes_total",
                "Probe requests routed through quarantined owners.",
            ).inc(owner=probe_owner)
        return choice

    def healthy(self, owners: Sequence[str]) -> List[str]:
        """The subset of ``owners`` not currently quarantined."""
        with self._lock:
            out = []
            for name in owners:
                state = self._owners.get(name)
                if state is None or not state.quarantined:
                    out.append(name)
            return out
