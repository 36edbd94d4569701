"""Deterministic fault-injection harness for the read/serving path.

A copy of ``repro.fault.injection`` with its imports rewritten to the port, which
imports nothing of ``repro``.

The training substrate has had injection for a while
(``train/fault_tolerance.py``'s ``fail_at``); this module brings the
same discipline to the query path.  A :class:`FaultPlan` is a list of
:class:`FaultSpec` rules — *at site X (optionally for owner Y), fire
kind K* — activated as a context manager around the code under test::

    plan = FaultPlan([FaultSpec(site="shard_collect", owner="shard:0",
                                kind="raise", times=1)])
    with plan.activate():
        store.query().where_keys(ks).on_error("partial").execute()
    assert plan.fired  # events were recorded

Everything is deterministic: specs fire by matching-event index
(``after``/``times`` windows) and, when ``probability < 1``, by a
counter-seeded RNG — ``(seed, spec_index, event_index)`` — so a run
replays identically regardless of wall clock, thread timing, or host.

Instrumented sites consult the active plan through the module-level
helpers; with no plan active they cost one attribute read:

* :func:`maybe_fail` — raise :class:`~repro_torch.fault.errors.InjectedFault`
  (kind ``"raise"``) or sleep (kind ``"delay"``) at a site;
* :func:`corrupt` — deterministically flip one byte of an artifact
  payload (kind ``"corrupt"``, ``artifact_read`` site).

Sites instrumented in the port: ``engine_dispatch`` (device inference
dispatch) and ``artifact_read`` (persistence layer reads).  The
reference's ``shard_collect`` and ``member_collect`` stay valid site
names and come with the sharded store and the federation (ROADMAP item
M8).  Every fired event counts into
``deepmap_fault_injected_total{site,kind}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.fault.errors import InjectedFault

#: The instrumented injection sites (specs may only name these).
SITES = ("shard_collect", "member_collect", "engine_dispatch", "artifact_read")

#: Supported fault kinds.
KINDS = ("raise", "delay", "corrupt")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One injection rule: *at ``site`` (for ``owner``), fire ``kind``*.

    ``owner=None`` matches every owner at the site.  The rule fires on
    matching events with index ``>= after``, at most ``times`` times
    (``None`` = unbounded), each firing gated by a seeded coin when
    ``probability < 1``.  ``delay_s`` is the sleep for ``kind="delay"``.
    """

    site: str
    kind: str = "raise"
    owner: Optional[str] = None
    times: Optional[int] = None
    after: int = 0
    probability: float = 1.0
    delay_s: float = 0.0

    def __post_init__(self) -> None:
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}; have {SITES}")
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; have {KINDS}")
        if not (0.0 <= self.probability <= 1.0):
            raise ValueError("probability must be in [0, 1]")
        if self.times is not None and self.times < 0:
            raise ValueError("times must be >= 0")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """Record of one fired fault (for assertions and bench reports)."""

    site: str
    kind: str
    owner: Optional[str]
    spec_index: int
    event_index: int


class FaultPlan:
    """A set of :class:`FaultSpec` rules plus their firing state.

    Thread-safe: instrumented sites are hit from fan-out pool threads.
    Activation is process-global (one plan at a time, nesting
    disallowed) — the harness targets tests and benchmarks, not
    concurrent production traffic.
    """

    def __init__(self, specs: Sequence[FaultSpec], seed: int = 0):
        self.specs = tuple(specs)
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._seen: List[int] = [0] * len(self.specs)   # guarded-by: _lock
        self._fired: List[int] = [0] * len(self.specs)  # guarded-by: _lock
        self._events: List[FaultEvent] = []             # guarded-by: _lock

    # ----------------------------------------------------------- inspection
    @property
    def events(self) -> Tuple[FaultEvent, ...]:
        """Every fired event, in firing order."""
        with self._lock:
            return tuple(self._events)

    @property
    def fired(self) -> int:
        """Total events fired across all specs."""
        with self._lock:
            return sum(self._fired)

    def fired_at(self, site: str) -> int:
        """Events fired at one site."""
        with self._lock:
            return sum(1 for e in self._events if e.site == site)

    # ------------------------------------------------------------- matching
    def _coin(self, spec_index: int, event_index: int) -> bool:
        spec = self.specs[spec_index]
        if spec.probability >= 1.0:
            return True
        # Counter-seeded: deterministic in (seed, spec, event), immune
        # to thread interleaving and draw order.
        rng = np.random.default_rng((self.seed, spec_index, event_index))
        return bool(rng.random() < spec.probability)

    def _arm(self, site: str, owner: Optional[str], kinds: Tuple[str, ...]
             ) -> Optional[Tuple[FaultSpec, FaultEvent]]:
        """Find the first matching spec that fires for this event (and
        record it); None when nothing fires."""
        owner = None if owner is None else str(owner)
        with self._lock:
            for i, spec in enumerate(self.specs):
                if spec.site != site or spec.kind not in kinds:
                    continue
                if spec.owner is not None and owner is not None \
                        and spec.owner != owner:
                    continue
                if spec.owner is not None and owner is None:
                    continue
                idx = self._seen[i]
                self._seen[i] = idx + 1
                if idx < spec.after:
                    continue
                if spec.times is not None and self._fired[i] >= spec.times:
                    continue
                if not self._coin(i, idx):
                    continue
                self._fired[i] += 1
                event = FaultEvent(
                    site=site, kind=spec.kind, owner=owner,
                    spec_index=i, event_index=idx,
                )
                self._events.append(event)
                return spec, event
        return None

    # ------------------------------------------------------------ lifecycle
    @contextlib.contextmanager
    def activate(self):
        """Install this plan as the process-wide active plan."""
        global _ACTIVE
        with _ACTIVATION_LOCK:
            if _ACTIVE is not None:
                raise RuntimeError("a FaultPlan is already active (no nesting)")
            _ACTIVE = self
        try:
            yield self
        finally:
            with _ACTIVATION_LOCK:
                _ACTIVE = None


_ACTIVE: Optional[FaultPlan] = None
_ACTIVATION_LOCK = threading.Lock()


def active() -> Optional[FaultPlan]:
    """The currently-activated plan (None almost always)."""
    return _ACTIVE


def _record(event: FaultEvent) -> None:
    obs.registry().counter(
        "deepmap_fault_injected_total",
        "Faults fired by the injection harness, by site and kind.",
    ).inc(site=event.site, kind=event.kind)


def maybe_fail(site: str, owner=None) -> None:
    """Instrumentation hook: raise or delay if the active plan says so.

    No-op (one global read) when no plan is active — safe to leave in
    hot paths.  ``kind="raise"`` raises :class:`InjectedFault`;
    ``kind="delay"`` sleeps ``delay_s`` then returns (the slow-owner
    case for deadline tests).
    """
    plan = _ACTIVE
    if plan is None:
        return
    hit = plan._arm(site, None if owner is None else str(owner),
                    ("raise", "delay"))
    if hit is None:
        return
    spec, event = hit
    _record(event)
    if spec.kind == "delay":
        time.sleep(spec.delay_s)
        return
    raise InjectedFault(site, None if owner is None else str(owner))


def corrupt(site: str, owner, data: bytes) -> bytes:
    """Instrumentation hook for artifact reads: deterministically flip
    one byte of ``data`` if a ``kind="corrupt"`` spec fires (checksum
    verification must then reject the artifact).  Empty payloads pass
    through untouched."""
    plan = _ACTIVE
    if plan is None or not data:
        return data
    hit = plan._arm(site, None if owner is None else str(owner), ("corrupt",))
    if hit is None:
        return data
    _record(hit[1])
    flipped = bytearray(data)
    flipped[len(flipped) // 2] ^= 0x01
    return bytes(flipped)
