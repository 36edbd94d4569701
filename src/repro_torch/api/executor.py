"""Streaming operator-pipeline executor.

A copy of ``repro.api.executor`` with its imports rewritten to the port, which
imports nothing of ``repro``.

Every plan compiles to the same small operator IR regardless of store
type:

    KeySource -> (ShardScatter) -> Infer -> Exist -> AuxMerge
              -> Filter -> Decode -> Gather

and is executed **morsel-at-a-time**: the key stream is cut into
chunks — sized adaptively between morsels from per-operator timings
(:func:`next_morsel_rows`), or fixed by ``Query.morsel(n)`` — and each
chunk's device work is enqueued through the store's
``_dispatch_lookup`` hook before the previous chunk's host half
(existence fallback, aux merge, predicate filter, decode) is collected
— so model-backed stores overlap device inference of morsel *i+1* with
host work of morsel *i*.  :func:`execute_plans` extends the same
window **across plans**: while plan A's host half runs, plans B..'s
device work keeps executing, which is where multi-plan pipelines win
over running ``execute_plan`` in a loop.  Plan compilation artifacts
(key-source materializations, projection subsets, predicate code
tables) come from the store's per-store
:class:`~repro_torch.api.cache.PlanCache`, so repeated plans skip the
existence-index scan and predicate compiles entirely.

The store-specific middle stages stay behind the two protocol hooks
(``_dispatch_lookup``/``_collect_lookup``); the sharded store
implements scatter + thread-pool fan-out inside its hook, the
federated store per-member scatter — the executor stays oblivious.

Value predicates (``Query.where``) ride the same hooks: with
``plan.pushdown`` (default) the store evaluates them below decode
(code-level on DeepMapping stores — non-matching rows are never
decoded; overlay-view on baselines) and returns a ``match`` selector;
with ``pushdown=False`` the executor runs the **post-hoc reference
path** — decode everything, filter on decoded values — kept for
byte-equality testing and as the semantics oracle.

Aggregates (``Query.group_by(...).agg(...)``) run **below decode** by
default: each morsel's collect calls the store's
``_collect_aggregate`` hook, which returns a partial aggregation state
instead of decoded rows (code-space on DeepMapping stores — a
count-only group-by decodes zero rows; fan-out merge on
sharded/federated stores; decode-then-aggregate on baselines), and the
Gather operator merges states instead of concatenating columns.  With
``pushdown=False`` the morsels flow as decoded rows and the gatherer
aggregates them post-hoc — the decode-then-aggregate reference the
differential suite compares against.  Key-equi joins (``Query.join``)
wrap the finalized morsel stream: each morsel's candidate rows probe
the right store's existence index through the same
dispatch/collect hooks (with a dispatch-ahead window, so right-store
inference overlaps left host work), non-matching rows are dropped via
the ``match`` selector, and right columns scatter into the morsel.

Plan execution defaults the sharded fan-out ON (overlapping per-shard
inference — ``Query.fanout(False)`` restores serial visits); the
legacy ``store.lookup`` shim stays serial for bit-for-bit continuity.
:func:`execute_plan_staged` keeps the pre-streaming one-shot path as a
reference implementation for the equivalence suite.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.api.cache import plan_fingerprint
from repro_torch.api.plan import (
    DEFAULT_MORSEL,
    AggregateResult,
    ExplainStats,
    OperatorStats,
    Predicate,
    QueryPlan,
    QueryResult,
    aggregate_columns,
    aggregate_rows,
    columns_with_predicates,
    evaluate_predicates,
    finalize_agg_state,
    merge_agg_states,
)
from repro_torch.api.protocol import _check_index_agreement
from repro_torch.fault.errors import OwnerError, OwnerFailure

#: Morsels in flight ahead of the host half, per plan.  Matches the
#: store-level DISPATCH_WINDOW so device residency stays bounded.
MORSEL_WINDOW = 2

#: Adaptive morsel sizing bounds (rows).  Powers of two so resized
#: morsels keep hitting the inference engine's power-of-two batch
#: buckets instead of forcing fresh compiles.
ADAPT_MIN = 1 << 12
ADAPT_MAX = 1 << 20

#: Stage fields mirrored into ``deepmap_executor_stage_seconds_total``
#: and rendered as per-operator child spans under each collect span.
_STAGE_FIELDS = (
    ("exist", "exist_s"),
    ("aux_merge", "aux_s"),
    ("filter", "filter_s"),
    ("decode", "decode_s"),
    ("aggregate", "agg_s"),
)

#: Per-morsel operator-time targets (seconds).  Below the low mark the
#: fixed per-morsel overhead (dispatch bookkeeping, stats merging)
#: dominates and the window doubles; above the high mark a morsel is
#: too coarse to overlap well (and pins too much on device) and the
#: window halves.
ADAPT_LOW_S = 0.004
ADAPT_HIGH_S = 0.032


def next_morsel_rows(rows: int, operator_seconds: float) -> int:
    """Adaptive-sizing rule: the next morsel's row count given the last
    full morsel's summed per-operator time.

    Deterministic in its inputs (double under :data:`ADAPT_LOW_S`,
    halve over :data:`ADAPT_HIGH_S`, else hold) and bounded to
    ``[ADAPT_MIN, ADAPT_MAX]``; growth stays power-of-two-aligned so
    the device batch buckets stay warm.  Pure so the equivalence suite
    can test it directly.
    """
    if operator_seconds < ADAPT_LOW_S and rows < ADAPT_MAX:
        return min(rows * 2, ADAPT_MAX)
    if operator_seconds > ADAPT_HIGH_S and rows > ADAPT_MIN:
        return max(rows // 2, ADAPT_MIN)
    return rows


#: First-morsel operator-time target: the geometric midpoint of the
#: adaptive band (~11.3 ms) — a seed landing there needs no resizing.
SEED_TARGET_S = (ADAPT_LOW_S * ADAPT_HIGH_S) ** 0.5

#: Assumed effective batched-inference throughput (flop/s) for the
#: cost model below.  Calibrated so a ~300 KB model (the common
#: build in this repo's benchmarks) seeds at :data:`DEFAULT_MORSEL` —
#: the seed only moves the start for models meaningfully bigger or
#: smaller, and adaptive resizing corrects any residual error.
SEED_THROUGHPUT_FLOPS = 1e12


def seed_morsel_rows(model_bytes: int, max_rows: int = ADAPT_MAX) -> int:
    """Cost-model seed for the FIRST morsel of an adaptive plan.

    A row through an MLP of ``model_bytes`` float32 parameters costs
    about ``model_bytes / 2`` flops (two flops per weight, four bytes
    per weight); at :data:`SEED_THROUGHPUT_FLOPS` that gives an
    estimated per-row time, and the seed is the power of two whose
    morsel lands nearest :data:`SEED_TARGET_S` — so adaptive resizing
    starts inside (or next to) the target band instead of walking
    there from a fixed 2^16.  Clamped to ``[ADAPT_MIN, min(ADAPT_MAX,
    max_rows)]`` with a power-of-two floor so the device batch buckets
    stay warm.  ``model_bytes <= 0`` (baseline stores have no model)
    returns :data:`DEFAULT_MORSEL` — their seed is unchanged.  Pure so
    the seeding rule is unit-testable.
    """
    if model_bytes <= 0:
        return DEFAULT_MORSEL
    per_row_s = (model_bytes / 2) / SEED_THROUGHPUT_FLOPS
    want = int(SEED_TARGET_S / per_row_s)
    cap = min(ADAPT_MAX, max(int(max_rows), ADAPT_MIN))
    rows = ADAPT_MIN
    while rows * 2 <= min(want, cap):
        rows *= 2
    return rows


class _FailedDispatch:
    """Handle slot for a morsel whose dispatch raised under
    ``on_error='partial'`` — collect time turns it into a degraded
    morsel instead of killing the plan."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


@dataclasses.dataclass
class MorselResult:
    """One collected morsel of a streaming plan.

    ``keys``/``values``/``exists`` are aligned with the morsel's slice
    of the key stream; ``match`` is the pushed-down predicate selector
    (``None`` = no predicates — every existing row is a result row).
    For below-decode aggregate plans ``agg`` carries the morsel's
    partial aggregation state instead — ``values``/``exists`` are
    empty and the gatherer merges states rather than rows.
    """

    index: int
    start: int
    keys: np.ndarray
    values: Dict[str, np.ndarray]
    exists: np.ndarray
    match: Optional[np.ndarray]
    stats: ExplainStats
    agg: Optional[Dict[tuple, list]] = None


def _describe_failure(exc: BaseException) -> Tuple[dict, ...]:
    """Normalize an executor-level failure into ``owners_failed``
    evidence entries (multi-owner failures keep per-owner detail)."""
    if isinstance(exc, OwnerFailure):
        return tuple(o.describe() for o in exc.owners)
    return (OwnerError(
        owner="store", site=getattr(exc, "site", "dispatch"),
        attempts=1, error_type=type(exc).__name__, message=str(exc),
    ).describe(),)


def _resolve_keys(store, plan: QueryPlan) -> Tuple[np.ndarray, float]:
    """KeySource operator: materialize the plan's key stream."""
    t0 = time.perf_counter()
    if plan.kind == "point":
        keys = np.asarray(plan.keys, dtype=np.int64)
    elif plan.kind == "range":
        keys = store._range_keys(int(plan.lo), int(plan.hi))
    else:  # scan
        keys = store._all_keys()
    return keys, time.perf_counter() - t0


class PlanStream:
    """One plan's morsel state machine.

    Splits the key stream into morsels and drives the store's
    dispatch/collect hooks with an explicit in-flight window.  The
    multiplexers (:func:`stream_plan`, :func:`execute_plans`) call
    :meth:`dispatch_one` / :meth:`collect_one` in whatever order keeps
    the most device work in flight.

    Plan compilation consults the store's per-store
    :class:`~repro_torch.api.cache.PlanCache`: a repeated range/scan plan
    reuses its materialized key stream and resolved projection instead
    of re-scanning the existence index (``cache_state`` records the
    outcome as explain evidence).  Morsel sizes are **adaptive** by
    default — resized between morsels by :func:`next_morsel_rows` from
    the collected morsel's per-operator timings — unless the plan
    forces a fixed size (``Query.morsel(n)``).
    """

    def __init__(self, store, plan: QueryPlan):
        self.store = store
        self.plan = plan
        self._t_plan0 = time.perf_counter()
        self.fixed = plan.morsel is not None
        self._morsel_rows = plan.morsel_rows()
        if not self.fixed:
            # Cost-model seed (satellite of the device-residency work):
            # start adaptive sizing from the store's model footprint
            # instead of a fixed 2^16.  Baselines (no "model" component)
            # keep the DEFAULT_MORSEL seed bit-for-bit.
            self._morsel_rows = seed_morsel_rows(
                int(store.size_breakdown().get("model", 0)),
                max_rows=getattr(
                    getattr(store, "config", None), "inference_batch",
                    ADAPT_MAX,
                ),
            )
        self.fanout = True if plan.fanout is None else plan.fanout
        self.preds: Tuple[Predicate, ...] = (
            plan.predicates if plan.pushdown else ()
        )
        #: Below-decode aggregation: with pushdown (default) every
        #: morsel collects through ``_collect_aggregate`` and returns a
        #: partial state; ``pushdown=False`` keeps rows flowing and the
        #: gatherer aggregates post-hoc (the reference path).
        self.agg_below = bool(plan.aggregates) and plan.pushdown
        #: Dispatch capability: the store will evaluate these pushdown
        #: predicates in-kernel (match bits ride the inference call), so
        #: the executor's host Filter stage is expected to be a no-op.
        self.kernel_filter = bool(self.preds) and bool(
            store.supports_kernel_filter(self.preds)
        )
        #: range/scan keys come from the existence index, so every key
        #: is known to exist — the hint baseline partition pruning needs.
        self.keys_exist = plan.kind != "point"
        fp = plan_fingerprint(plan)
        cache = store.plan_cache()
        version = store.mutation_version()
        entry = cache.get(fp, version)
        if entry is not None and plan.kind != "point" and entry.keys is None:
            # The key stream exceeded the cache's byte budget and was
            # dropped at put time — resolve it fresh.
            entry = None
        self.cache_state = "bypass" if fp is None else (
            "hit" if entry is not None else "miss"
        )
        if entry is not None:
            t0 = time.perf_counter()
            self.keys = (
                np.asarray(plan.keys, dtype=np.int64)
                if plan.kind == "point"
                else entry.keys
            )
            self.columns = entry.columns
            self.route_s = time.perf_counter() - t0
        else:
            self.keys, self.route_s = _resolve_keys(store, plan)
            # Post-hoc filtering evaluates on decoded values, so the
            # predicate columns must be decoded even when the projection
            # excludes them (_finalize_morsel drops them after filtering).
            # Aggregate plans project exactly the group-by + aggregate
            # columns (plan.columns is None by construction).
            self.columns = (
                aggregate_columns(plan.group_by, plan.aggregates)
                if plan.aggregates
                else plan.columns
            )
            if plan.predicates and not plan.pushdown:
                self.columns = columns_with_predicates(
                    self.columns, plan.predicates
                )
            cache.put(
                fp,
                version,
                None if plan.kind == "point" else self.keys,
                self.columns,
            )
        now = time.perf_counter()
        obs.tracer().add_span(
            "key_source", now - self.route_s, now, track="host",
            kind=plan.kind, cache=self.cache_state,
        )
        self.sizes: List[int] = []  # dispatched morsel sizes (evidence)
        self._cursor = 0
        self._dispatched = 0
        self._dispatched_any = False
        # (seq, start, rows, target, handle, t_dispatch) per in-flight
        # morsel — t_dispatch anchors the retroactive device-track span.
        self._inflight: List[Tuple[int, int, int, int, object, float]] = []

    # ------------------------------------------------------------- state
    @property
    def dispatch_done(self) -> bool:
        """True once the whole key stream has been dispatched (a
        zero-length stream still dispatches ONE empty morsel)."""
        return self._dispatched_any and self._cursor >= self.keys.shape[0]

    @property
    def done(self) -> bool:
        """True once every dispatched morsel has been collected."""
        return self.dispatch_done and not self._inflight

    @property
    def inflight(self) -> int:
        """Number of dispatched-but-uncollected morsels."""
        return len(self._inflight)

    # ------------------------------------------------------------- steps
    def dispatch_one(self) -> bool:
        """Enqueue the next morsel's device work; False when drained."""
        if self.dispatch_done:
            return False
        target = self._morsel_rows
        chunk = self.keys[self._cursor : self._cursor + target]
        t_dispatch = time.perf_counter()
        try:
            handle = self.store._dispatch_lookup(
                chunk,
                self.columns,
                fanout=self.fanout,
                predicates=self.preds,
                keys_exist=self.keys_exist,
                on_error=self.plan.on_error,
            )
        except Exception as exc:
            # Multi-owner stores capture dispatch failures themselves;
            # this is the single-owner (or totally-failed) case.
            if self.plan.on_error != "partial":
                raise
            handle = _FailedDispatch(exc)
        rows = int(chunk.shape[0])
        self._inflight.append(
            (self._dispatched, self._cursor, rows, target, handle, t_dispatch)
        )
        self.sizes.append(rows)
        self._cursor += rows
        self._dispatched += 1
        self._dispatched_any = True
        return True

    def collect_one(self) -> MorselResult:
        """Block on the oldest in-flight morsel's host half.

        Under adaptive sizing, a collected **full** morsel's summed
        per-operator time feeds :func:`next_morsel_rows` to resize
        subsequent dispatches (partial tail morsels carry no signal).

        Telemetry is emitted here (never in the hot per-key loops):
        a retroactive **device-track** span ``infer_dispatch`` covering
        [dispatch(seq) → collect-start(seq)] — the window in which the
        morsel's device work ran while the host drained earlier morsels
        — plus a **host-track** ``collect`` span for the blocking host
        half, per-operator child spans reconstructed from the morsel's
        stage timings, and the morsel counters/histograms.
        """
        if not self._inflight:
            raise RuntimeError("collect_one with no morsel in flight")
        seq, start, rows, target, handle, t_dispatch = self._inflight.pop(0)
        t_collect0 = time.perf_counter()
        agg: Optional[Dict[tuple, list]] = None
        if isinstance(handle, _FailedDispatch):
            values, exists, match, stats, agg = self._degraded(rows, handle.exc)
        else:
            try:
                if self.agg_below:
                    agg, stats = self.store._collect_aggregate(
                        handle, self.plan.group_by, self.plan.aggregates
                    )
                    values = {}
                    exists = np.zeros(0, dtype=bool)
                    match = None
                else:
                    values, exists, match, stats = (
                        self.store._collect_lookup(handle)
                    )
            except Exception as exc:
                if self.plan.on_error != "partial":
                    raise
                # OwnerFailure here means even partial degradation was
                # impossible inside the store (every owner failed);
                # degrade the whole morsel at this level instead.
                values, exists, match, stats, agg = self._degraded(rows, exc)
        t_collect1 = time.perf_counter()
        self._emit_morsel(seq, rows, stats, t_dispatch, t_collect0, t_collect1)
        if not self.fixed and rows == target:
            operator_s = (
                stats.infer_s + stats.exist_s + stats.aux_s
                + stats.filter_s + stats.decode_s + stats.agg_s
            )
            self._morsel_rows = next_morsel_rows(target, operator_s)
        if self.done:
            self._emit_plan(t_collect1)
        return MorselResult(
            index=seq,
            start=start,
            keys=self.keys[start : start + rows],
            values=values,
            exists=exists,
            match=match,
            stats=stats,
            agg=agg,
        )

    # ---------------------------------------------------------- degraded
    def _degraded(self, rows: int, exc: BaseException):
        """Degrade one morsel under ``on_error='partial'`` — row form
        (typed placeholder columns) or aggregate form (empty partial
        state), matching the plan's collect mode."""
        if self.agg_below:
            stats = ExplainStats(
                plan=("degraded",),
                owners_failed=_describe_failure(exc),
                keys_unresolved=rows,
            )
            obs.registry().counter(
                "deepmap_fault_degraded_morsels_total",
                "Morsels answered with every row unreachable "
                "(on_error='partial' full-owner failure).",
            ).inc(kind=self.plan.kind)
            return {}, np.zeros(0, dtype=bool), None, stats, {}
        values, exists, match, stats = self._degraded_morsel(rows, exc)
        return values, exists, match, stats, None

    def _degraded_morsel(self, rows: int, exc: BaseException):
        """Synthesize a fully-degraded morsel under ``on_error=
        'partial')``: every row unreachable (``exists=False``, typed
        placeholder values), with the failure carried as
        ``owners_failed``/``keys_unresolved`` evidence.

        Column dtypes come from a zero-length probe lookup — the
        protocol guarantees typed empty columns for empty batches
        without touching inference.  If even the probe fails there is
        nothing typed to return: the original failure propagates."""
        try:
            probe = self.store._collect_lookup(self.store._dispatch_lookup(
                np.zeros(0, dtype=np.int64), self.columns,
                fanout=False, predicates=self.preds,
            ))
        except Exception:
            raise exc
        values = {
            c: np.zeros(rows, dtype=arr.dtype) for c, arr in probe[0].items()
        }
        exists = np.zeros(rows, dtype=bool)
        match = np.zeros(rows, dtype=bool) if self.preds else None
        stats = ExplainStats(
            plan=("degraded",),
            owners_failed=_describe_failure(exc),
            keys_unresolved=rows,
        )
        obs.registry().counter(
            "deepmap_fault_degraded_morsels_total",
            "Morsels answered with every row unreachable "
            "(on_error='partial' full-owner failure).",
        ).inc(kind=self.plan.kind)
        return values, exists, match, stats

    # --------------------------------------------------------- telemetry
    def _emit_morsel(
        self, seq: int, rows: int, stats: ExplainStats,
        t_dispatch: float, t_collect0: float, t_collect1: float,
    ) -> None:
        reg = obs.registry()
        trc = obs.tracer()
        if not (reg.enabled or trc.enabled):
            return
        kind = self.plan.kind
        trc.add_span(
            "infer_dispatch", t_dispatch, t_collect0, track="device",
            morsel=seq, rows=rows, kind=kind,
        )
        trc.add_span(
            "collect", t_collect0, t_collect1, track="host",
            morsel=seq, rows=rows, kind=kind,
        )
        # Operator child spans are a *reconstruction*: the store hooks
        # report stage durations, not wall endpoints, so the children
        # are laid out sequentially from collect-start in pipeline
        # order.  Gaps under the collect span are un-attributed host
        # overhead (scatter bookkeeping, stats merging).
        t = t_collect0
        for op, field in _STAGE_FIELDS:
            d = getattr(stats, field)
            if d > 0:
                trc.add_span(f"op:{op}", t, t + d, track="host", morsel=seq)
                t += d
        reg.counter(
            "deepmap_executor_morsels_total",
            "Morsels collected, by plan kind.",
        ).inc(kind=kind)
        reg.histogram(
            "deepmap_executor_morsel_rows",
            "Rows per collected morsel.",
            buckets=obs.SIZE_BUCKETS,
        ).observe(rows, kind=kind)
        reg.histogram(
            "deepmap_executor_morsel_seconds",
            "Host collect latency per morsel.",
        ).observe(t_collect1 - t_collect0, kind=kind)
        stages = reg.counter(
            "deepmap_executor_stage_seconds_total",
            "Cumulative per-operator seconds, from store stage timings.",
        )
        if stats.infer_s > 0:
            stages.inc(stats.infer_s, stage="infer")
        for op, field in _STAGE_FIELDS:
            d = getattr(stats, field)
            if d > 0:
                stages.inc(d, stage=op)

    def _emit_plan(self, t_end: float) -> None:
        """Plan-level span + counters, once, when the last morsel of
        this stream is collected (covers both ``execute_plan`` and bare
        ``stream_plan`` consumers)."""
        reg = obs.registry()
        kind = self.plan.kind
        obs.tracer().add_span(
            "plan", self._t_plan0, t_end, track="plans",
            kind=kind, morsels=self._dispatched, cache=self.cache_state,
        )
        reg.counter(
            "deepmap_executor_plans_total", "Plans fully executed, by kind."
        ).inc(kind=kind)
        reg.histogram(
            "deepmap_executor_plan_seconds",
            "End-to-end plan latency (first dispatch to last collect).",
        ).observe(t_end - self._t_plan0, kind=kind)
        reg.counter(
            "deepmap_executor_stage_seconds_total",
            "Cumulative per-operator seconds, from store stage timings.",
        ).inc(self.route_s, stage="key_source")


# --------------------------------------------------------------- finalize
def _finalize_morsel(plan: QueryPlan, morsel: MorselResult) -> MorselResult:
    """The ONE place ``pushdown(False)`` semantics live: filter on the
    decoded values (the byte-equality oracle for pushdown) and drop
    the pred-only columns, so every consumer (``stream_plan``,
    ``execute_plan``, ``execute_plans``) sees the same match contract
    — never silently unfiltered rows.  Also enforces the range/scan
    existence-index invariant for every morsel consumer, streaming
    included — relaxed by exactly the rows a degraded morsel reports
    unreachable (``keys_unresolved``): a partial result may miss keys
    whose owner is down, but never MORE than the evidence admits."""
    if morsel.agg is not None:
        # Below-decode aggregate morsel: no rows to filter or check —
        # the partial state already reflects existence + predicates.
        return morsel
    if plan.kind != "point":
        missing = int(morsel.exists.shape[0] - morsel.exists.sum())
        if missing > int(morsel.stats.keys_unresolved):
            _check_index_agreement(f"{plan.kind} plan", morsel.exists)
    if plan.predicates and not plan.pushdown:
        morsel.match = evaluate_predicates(
            plan.predicates, morsel.values, morsel.exists, morsel.stats
        )
        if plan.columns is not None:
            morsel.values = {c: morsel.values[c] for c in plan.columns}
    return morsel


def _stream_run(run: PlanStream, window: int) -> Iterator[MorselResult]:
    while not run.done:
        while run.inflight < window and run.dispatch_one():
            pass
        yield _finalize_morsel(run.plan, run.collect_one())


# ------------------------------------------------------------------- join
def _dispatch_join(plan: QueryPlan, morsel: MorselResult):
    """JoinProbe dispatch half: enqueue the right-store lookup for one
    finalized morsel's candidate rows (existing + predicate-matched).
    The probe keys go through ``JoinSpec.key`` (vectorized left-key →
    right-key map; identity when ``None``) and scatter through the
    right store's own dispatch hook — existence index, sharding and
    fan-out included — so the probe IS a point plan on the right."""
    spec = plan.join
    sel = morsel.exists if morsel.match is None else morsel.match
    sel_idx = np.flatnonzero(sel)
    left = morsel.keys[sel_idx]
    probe = (
        left
        if spec.key is None
        else np.asarray(spec.key(left), dtype=np.int64)
    )
    try:
        handle = spec.store._dispatch_lookup(
            probe, spec.columns, fanout=True, on_error=plan.on_error
        )
    except Exception as exc:
        if plan.on_error != "partial":
            raise
        handle = _FailedDispatch(exc)
    return morsel, sel_idx, probe, handle


def _degraded_join(plan: QueryPlan, probe: np.ndarray, exc: BaseException):
    """Right-store failure under ``on_error='partial'``: every probe
    unresolved — the candidate rows drop out of the join (typed empty
    right columns via a zero-length probe, as ``_degraded_morsel``)."""
    spec = plan.join
    try:
        pvals, _, _, _ = spec.store._collect_lookup(
            spec.store._dispatch_lookup(
                np.zeros(0, dtype=np.int64), spec.columns, fanout=False
            )
        )
    except Exception:
        raise exc
    n = int(probe.shape[0])
    rvalues = {c: np.zeros(n, dtype=arr.dtype) for c, arr in pvals.items()}
    rexists = np.zeros(n, dtype=bool)
    stats = ExplainStats(
        owners_failed=_describe_failure(exc), keys_unresolved=n
    )
    obs.registry().counter(
        "deepmap_fault_degraded_morsels_total",
        "Morsels answered with every row unreachable "
        "(on_error='partial' full-owner failure).",
    ).inc(kind="join")
    return rvalues, rexists, stats


def _collect_join(plan: QueryPlan, entry) -> MorselResult:
    """JoinProbe collect half: resolve the right-store lookup, narrow
    ``match`` to rows whose probe key exists on the right, and scatter
    the right columns into the morsel (prefixed with ``JoinSpec.prefix``
    on name collision).  Right-store stage timings and decode counts
    merge into the morsel's stats; ``join_probes`` records the probes."""
    morsel, sel_idx, probe, handle = entry
    spec = plan.join
    rows = int(morsel.keys.shape[0])
    morsel.stats.join_probes += int(probe.shape[0])
    if isinstance(handle, _FailedDispatch):
        rvalues, rexists, rstats = _degraded_join(plan, probe, handle.exc)
    else:
        try:
            rvalues, rexists, _, rstats = spec.store._collect_lookup(handle)
        except Exception as exc:
            if plan.on_error != "partial":
                raise
            rvalues, rexists, rstats = _degraded_join(plan, probe, exc)
    match = (
        morsel.exists if morsel.match is None else morsel.match
    ).copy()
    match[sel_idx[~rexists]] = False
    morsel.match = match
    for c, arr in rvalues.items():
        name = spec.prefix + c if c in morsel.values else c
        full = np.zeros(rows, dtype=arr.dtype)
        full[sel_idx] = arr
        morsel.values[name] = full
    morsel.stats.merge_timings(rstats)
    return morsel


def _join_stream(
    plan: QueryPlan, stream: Iterator[MorselResult], window: int
) -> Iterator[MorselResult]:
    """Wrap a finalized morsel stream with the join operator, keeping
    up to ``window`` right-store probes in flight ahead of the collect
    — right-store device work overlaps left host halves the same way
    morsel dispatch overlaps collect within one plan."""
    pending: List[tuple] = []
    for morsel in stream:
        pending.append(_dispatch_join(plan, morsel))
        while len(pending) > window:
            yield _collect_join(plan, pending.pop(0))
    while pending:
        yield _collect_join(plan, pending.pop(0))


def _apply_join(plan: QueryPlan, morsel: MorselResult) -> MorselResult:
    """Synchronous join step (dispatch + collect back-to-back) for
    consumers that interleave several plans (:func:`execute_plans`)."""
    if plan.join is None:
        return morsel
    return _collect_join(plan, _dispatch_join(plan, morsel))


def stream_plan(
    store, plan: QueryPlan, window: int = MORSEL_WINDOW
) -> Iterator[MorselResult]:
    """Execute ``plan`` as a morsel stream (generator).

    Keeps up to ``window`` morsels' device work in flight ahead of the
    host half; yields morsels in key-stream order (post-hoc predicates
    already applied as ``match`` selectors, join probes resolved with
    their own dispatch-ahead window).  Callers that only need the
    final relation should use :func:`execute_plan`; streaming
    consumers (the serving engine, federated gathers) get bounded
    memory and early rows from this form.
    """
    stream = _stream_run(PlanStream(store, plan), window)
    if plan.join is not None:
        stream = _join_stream(plan, stream, window)
    return stream


def _concat(parts: List[np.ndarray]) -> np.ndarray:
    return parts[0] if len(parts) == 1 else np.concatenate(parts)


class _Gatherer:
    """Gather operator: accumulate finalized morsels (post-hoc filter
    already applied by :func:`_finalize_morsel`) into one QueryResult."""

    def __init__(self, plan: QueryPlan):
        self.plan = plan
        self.stats = ExplainStats(kind=plan.kind)
        self.key_parts: List[np.ndarray] = []
        self.exists_parts: List[np.ndarray] = []
        self.value_parts: Dict[str, List[np.ndarray]] = {}
        self.agg_state: Dict[tuple, list] = {}
        self.inner_plan: Tuple[str, ...] = ()
        self.t0 = time.perf_counter()

    def add(self, morsel: MorselResult) -> None:
        """Fold one finalized morsel into the accumulating result."""
        t0 = time.perf_counter()
        if self.plan.aggregates:
            if morsel.agg is not None:
                # Below-decode morsel: merge the store's partial state.
                merge_agg_states(
                    self.agg_state, morsel.agg, self.plan.aggregates
                )
            else:
                # pushdown(False) reference: aggregate the decoded rows.
                aggregate_rows(
                    self.agg_state,
                    self.plan.group_by,
                    self.plan.aggregates,
                    morsel.values,
                    morsel.exists if morsel.match is None else morsel.match,
                )
            if not self.inner_plan:
                self.inner_plan = morsel.stats.plan
            self.stats.merge_timings(morsel.stats)
            self.stats.morsels += 1
            self.stats.agg_s += time.perf_counter() - t0
            return
        if morsel.match is not None:
            sel = morsel.match
            self.key_parts.append(morsel.keys[sel])
            self.exists_parts.append(morsel.exists[sel])
            for c, arr in morsel.values.items():
                self.value_parts.setdefault(c, []).append(arr[sel])
        else:
            self.key_parts.append(morsel.keys)
            self.exists_parts.append(morsel.exists)
            for c, arr in morsel.values.items():
                self.value_parts.setdefault(c, []).append(arr)
        if not self.inner_plan:
            self.inner_plan = morsel.stats.plan
        self.stats.merge_timings(morsel.stats)
        self.stats.morsels += 1
        self.stats.gather_s += time.perf_counter() - t0

    def finish(self, run: PlanStream):
        """Concatenate the accumulated morsels and assemble the final
        :class:`~repro_torch.api.plan.ExplainStats` (operator rows, plan
        stages, cache + morsel-size evidence).  Aggregate plans
        finalize the folded state instead — :class:`AggregateResult`."""
        if self.plan.aggregates:
            return self._finish_aggregate(run)
        t0 = time.perf_counter()
        keys = (
            _concat(self.key_parts)
            if self.key_parts
            else np.zeros(0, dtype=np.int64)
        )
        exists = (
            _concat(self.exists_parts)
            if self.exists_parts
            else np.zeros(0, dtype=bool)
        )
        values = {c: _concat(parts) for c, parts in self.value_parts.items()}
        stats = self.stats
        stats.gather_s += time.perf_counter() - t0
        stats.num_keys = int(run.keys.shape[0])
        stats.num_rows = int(exists.sum())
        stats.route_s += run.route_s
        stats.plan_cache = run.cache_state
        stats.morsel_sizes = tuple(run.sizes)
        filtered = bool(self.plan.predicates)
        # Kernel-filter evidence: the capability flag says the store
        # *promised* in-kernel evaluation; ``stats.kernel_filtered``
        # (or-merged across morsels) says at least one morsel delivered.
        kfilter = filtered and (run.kernel_filter or stats.kernel_filtered)
        stats.plan = (
            (run.plan.source_stage(),)
            + self.inner_plan
            + (
                (
                    f"filter[{'kernel:' if kfilter else ''}"
                    f"{','.join(stats.predicates)}]",
                )
                if filtered
                else ()
            )
            + (
                (
                    f"join[{type(self.plan.join.store).__name__},"
                    f"{stats.join_probes} probes]",
                )
                if self.plan.join is not None
                else ()
            )
            + (f"gather[{stats.morsels} morsels]",)
            + (
                (f"degraded[{len(stats.owners_failed)} owners]",)
                if stats.owners_failed
                else ()
            )
        )
        stats.total_s = time.perf_counter() - self.t0
        n = stats.num_keys
        ops = [OperatorStats("key_source", 0, n, stats.route_s)]
        if stats.shards_visited:
            ops.append(OperatorStats("shard_scatter", n, n, 0.0))
        ops.append(OperatorStats("infer", n, n, stats.infer_s))
        ops.append(OperatorStats("exist", n, n, stats.exist_s))
        ops.append(OperatorStats("aux_merge", n, n, stats.aux_s))
        if filtered:
            # Under the in-kernel path the host stage only patches
            # aux-overridden rows, so filter_s collapses toward zero;
            # the renamed operator row records why.
            ops.append(OperatorStats(
                "filter[kernel]" if kfilter else "filter",
                n, stats.rows_matched, stats.filter_s,
            ))
        ops.append(
            OperatorStats("decode", stats.rows_decoded, stats.rows_decoded,
                          stats.decode_s)
        )
        if self.plan.join is not None:
            ops.append(OperatorStats(
                "join", stats.join_probes, int(keys.shape[0]), 0.0
            ))
        ops.append(OperatorStats("gather", n, keys.shape[0], stats.gather_s))
        stats.operators = tuple(ops)
        return QueryResult(keys=keys, values=values, exists=exists, explain=stats)

    def _finish_aggregate(self, run: PlanStream) -> AggregateResult:
        """Finalize the folded aggregation state: deterministic group
        order, plan stages (the store-level ``aggregate[...]`` stage is
        kept when the inner plan recorded one; the post-hoc reference
        path records its own ``aggregate[host,...]``), operator rows
        with the decode evidence that proves where aggregation ran."""
        t0 = time.perf_counter()
        plan = self.plan
        stats = self.stats
        groups, aggs = finalize_agg_state(
            self.agg_state, plan.group_by, plan.aggregates
        )
        stats.gather_s += time.perf_counter() - t0
        stats.groups_emitted = len(self.agg_state)
        stats.num_keys = int(run.keys.shape[0])
        stats.num_rows = stats.groups_emitted
        stats.route_s += run.route_s
        stats.plan_cache = run.cache_state
        stats.morsel_sizes = tuple(run.sizes)
        filtered = bool(plan.predicates)
        kfilter = filtered and (run.kernel_filter or stats.kernel_filtered)
        has_agg_stage = any(
            s.startswith("aggregate[") for s in self.inner_plan
        )
        mode = "store" if run.agg_below else "host"
        stats.plan = (
            (plan.source_stage(),)
            + self.inner_plan
            + (
                (
                    f"filter[{'kernel:' if kfilter else ''}"
                    f"{','.join(stats.predicates)}]",
                )
                if filtered and not run.agg_below
                else ()
            )
            + (
                ()
                if has_agg_stage
                else (
                    f"aggregate[{mode},{len(plan.group_by)} keys,"
                    f"{len(plan.aggregates)} aggs]",
                )
            )
            + (f"gather[{stats.morsels} morsels]",)
            + (
                (f"degraded[{len(stats.owners_failed)} owners]",)
                if stats.owners_failed
                else ()
            )
        )
        stats.total_s = time.perf_counter() - self.t0
        n = stats.num_keys
        ops = [OperatorStats("key_source", 0, n, stats.route_s)]
        if stats.shards_visited:
            ops.append(OperatorStats("shard_scatter", n, n, 0.0))
        ops.append(OperatorStats("infer", n, n, stats.infer_s))
        ops.append(OperatorStats("exist", n, n, stats.exist_s))
        ops.append(OperatorStats("aux_merge", n, n, stats.aux_s))
        if filtered:
            ops.append(OperatorStats(
                "filter[kernel]" if kfilter else "filter",
                n, stats.rows_matched, stats.filter_s,
            ))
        ops.append(
            OperatorStats("decode", stats.rows_decoded, stats.rows_decoded,
                          stats.decode_s)
        )
        ops.append(OperatorStats(
            "aggregate", n, stats.groups_emitted, stats.agg_s
        ))
        ops.append(OperatorStats(
            "gather", stats.groups_emitted, stats.groups_emitted,
            stats.gather_s,
        ))
        stats.operators = tuple(ops)
        return AggregateResult(
            group_by=plan.group_by,
            groups=groups,
            aggregates=aggs,
            explain=stats,
        )


def execute_plan(store, plan: QueryPlan):
    """Run ``plan`` against ``store`` -> :class:`QueryResult` (the
    morsel stream, fully gathered), or :class:`AggregateResult` for
    ``group_by``/``agg`` plans."""
    run = PlanStream(store, plan)
    stream: Iterator[MorselResult] = _stream_run(run, MORSEL_WINDOW)
    if plan.join is not None:
        stream = _join_stream(plan, stream, MORSEL_WINDOW)
    gatherer = _Gatherer(plan)
    for morsel in stream:
        gatherer.add(morsel)
    return gatherer.finish(run)


def execute_plans(
    pairs: Sequence[Tuple[object, QueryPlan]],
    window: int = MORSEL_WINDOW,
    max_inflight: int = 16,
) -> List:
    """Run several plans — possibly against several stores — through
    ONE interleaved morsel pipeline.

    Dispatch is round-robin across plans: every live plan keeps up to
    ``window`` morsels of device work in flight, and collections
    rotate, so while one plan's host half (aux merge, filter, decode)
    runs, every other plan's device inference keeps executing.  This is
    the cross-plan overlap ``execute_plan`` in a loop cannot give: a
    serial loop drains plan *i* completely (device idle during its last
    host half) before plan *i+1* dispatches anything.

    ``window`` bounds residency per plan; ``max_inflight`` bounds the
    FLEET — the aggregate morsels in flight never exceed it, so a
    64-plan batch cannot pin 64x``window`` morsels on device (top-up is
    round-robin one morsel at a time, keeping the budget fair across
    plans).

    Results arrive in input order, each identical to what
    ``execute_plan`` would have produced alone.
    """
    max_inflight = max(1, int(max_inflight))
    runs = [PlanStream(store, plan) for store, plan in pairs]
    gatherers = [_Gatherer(plan) for _, plan in pairs]
    results: List[Optional[object]] = [None] * len(runs)
    live = list(range(len(runs)))
    rounds = 0
    while live:
        # Phase 1: top up every live plan's dispatch window — device
        # work from ALL plans is enqueued before any host half blocks —
        # round-robin one morsel per pass, under the global budget.
        # The starting plan rotates per round so a fleet larger than
        # the budget cannot starve its tail: budget freed by the head
        # plans' collections is offered to a different plan each time.
        total = sum(runs[i].inflight for i in live)
        start = rounds % len(live)
        order = live[start:] + live[:start]
        topped = True
        while topped and total < max_inflight:
            topped = False
            for i in order:
                if total >= max_inflight:
                    break
                run = runs[i]
                if run.inflight < window and run.dispatch_one():
                    total += 1
                    topped = True
        # Phase 2: collect one morsel per live plan, round-robin.
        still = []
        for i in live:
            run = runs[i]
            if run.inflight:
                gatherers[i].add(_apply_join(
                    run.plan,
                    _finalize_morsel(run.plan, run.collect_one()),
                ))
            if run.done:
                results[i] = gatherers[i].finish(run)
            else:
                still.append(i)
        live = still
        rounds += 1
    return results  # type: ignore[return-value]


def execute_plan_staged(store, plan: QueryPlan):
    """Legacy one-shot path (pre-streaming executor), kept as the
    reference implementation for the byte-equality suite: the whole
    key stream answered as a single batch through
    ``_lookup_with_stats``, predicates applied post-hoc.  Aggregates
    run post-hoc over the decoded batch (always decode-then-aggregate
    here — the staged path IS a reference) and joins resolve as one
    synchronous probe."""
    t0 = time.perf_counter()
    keys, route_s = _resolve_keys(store, plan)
    num_keys = int(keys.shape[0])
    selected = (
        aggregate_columns(plan.group_by, plan.aggregates)
        if plan.aggregates
        else plan.columns
    )
    need = columns_with_predicates(selected, plan.predicates)
    fanout = True if plan.fanout is None else plan.fanout
    values, exists, stats = store._lookup_with_stats(keys, need, fanout=fanout)
    if plan.kind != "point":
        _check_index_agreement(f"{plan.kind} plan", exists)
    match = (
        evaluate_predicates(plan.predicates, values, exists, stats)
        if plan.predicates
        else None
    )
    if plan.aggregates:
        state: Dict[tuple, list] = {}
        t_agg = time.perf_counter()
        aggregate_rows(
            state, plan.group_by, plan.aggregates, values,
            exists if match is None else match,
        )
        stats.agg_s += time.perf_counter() - t_agg
        groups, aggs = finalize_agg_state(state, plan.group_by, plan.aggregates)
        stats.kind = plan.kind
        stats.groups_emitted = len(state)
        stats.plan = (plan.source_stage(),) + stats.plan + (
            f"aggregate[host,{len(plan.group_by)} keys,"
            f"{len(plan.aggregates)} aggs]",
        )
        stats.num_keys = num_keys
        stats.num_rows = len(state)
        stats.route_s += route_s
        stats.total_s = time.perf_counter() - t0
        return AggregateResult(
            group_by=plan.group_by, groups=groups, aggregates=aggs,
            explain=stats,
        )
    if plan.join is not None:
        left_names = set(values)
        morsel = _apply_join(
            plan,
            MorselResult(0, 0, keys, values, exists, match, stats),
        )
        match, values = morsel.match, morsel.values
        keys, exists = keys[match], exists[match]
        values = {
            c: arr[match]
            for c, arr in values.items()
            if selected is None or c in selected or c not in left_names
        }
    elif match is not None:
        keys, exists = keys[match], exists[match]
        values = {
            c: arr[match]
            for c, arr in values.items()
            if selected is None or c in selected
        }
    stats.kind = plan.kind
    stats.plan = (plan.source_stage(),) + stats.plan
    stats.num_keys = num_keys
    stats.num_rows = int(exists.sum())
    stats.route_s += route_s
    stats.total_s = time.perf_counter() - t0
    return QueryResult(keys=keys, values=values, exists=exists, explain=stats)
