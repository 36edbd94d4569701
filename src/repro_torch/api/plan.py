"""Query-plan IR for the unified store API.

A copy of ``repro.api.plan`` with its imports rewritten to the port, which
imports nothing of ``repro``.

A :class:`QueryPlan` is the small declarative description the
:class:`~repro_torch.api.query.Query` builder compiles to and the streaming
executor (`repro_torch.api.executor`) runs.  Plans have one *key source*
(explicit keys, a key range, or a full scan), an optional column
projection (pushed down so unselected columns are neither decoded nor —
for DeepMapping stores — even evaluated by their private model heads),
an optional conjunction of **value predicates** (pushed down so
non-matching rows are never decoded on model-backed stores), a shard
fan-out override, and a morsel size controlling how the executor
chunks the key stream.

Execution produces a :class:`QueryResult` carrying per-plan
:class:`ExplainStats` — the replacement for the mutable ``last_stats``
side-channel: every result owns its own immutable stats object, so
concurrent queries on one store cannot trample each other's timings.
Stats now include a per-operator breakdown (:class:`OperatorStats`
rows) mirroring the executor's operator IR:

    KeySource -> (ShardScatter) -> Infer -> Exist -> AuxMerge
              -> Filter -> Decode -> Gather

This module is dependency-light on purpose (numpy only): the store
implementations import it, so it must not import them back.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Tuple

import numpy as np

#: Valid ``QueryPlan.kind`` values.
PLAN_KINDS = ("point", "range", "scan")

#: Valid ``Predicate.op`` values (vectorized numpy comparisons).
PREDICATE_OPS = ("==", "!=", "<", "<=", ">", ">=", "in")

#: Valid ``AggSpec.func`` values.  ``count`` works on any column set;
#: ``sum``/``min``/``max`` need a numeric column and resolve values
#: through per-column code→value tables on the learned stores.
AGG_FUNCS = ("count", "sum", "min", "max")

#: Default executor morsel size (rows per streamed chunk).  Matches the
#: default ``DeepMappingConfig.inference_batch`` so one morsel maps to
#: one device chunk on the model-backed stores.
DEFAULT_MORSEL = 1 << 16

#: Valid ``QueryPlan.on_error`` modes: ``"raise"`` turns any terminal
#: owner failure into :class:`~repro_torch.fault.errors.OwnerFailure`;
#: ``"partial"`` returns the healthy owners' rows with
#: ``owners_failed``/``keys_unresolved`` evidence on the stats.
ERROR_MODES = ("raise", "partial")


@dataclasses.dataclass(frozen=True)
class Predicate:
    """One value predicate ``column <op> value`` (conjunctions are
    tuples of these on the plan).

    ``op`` is one of :data:`PREDICATE_OPS`; ``"in"`` takes an iterable
    ``value``.  Evaluation is vectorized numpy either over decoded
    values (:meth:`mask`) or — the DeepMapping pushdown — over a
    column's decode map once, yielding a boolean table indexed by code
    (:meth:`code_table`), so per-row evaluation is a single gather on
    int32 argmax codes *before* any row is decoded.
    """

    column: str
    op: str
    value: object

    def __post_init__(self) -> None:
        if self.op not in PREDICATE_OPS:
            raise ValueError(f"unknown predicate op {self.op!r}; have {PREDICATE_OPS}")
        if self.op == "in":
            if isinstance(self.value, (str, bytes)):
                # tuple("NEW") would silently become ('N','E','W')
                raise ValueError(
                    f"'in' needs an iterable of values, got the single "
                    f"string {self.value!r}; use '==' or pass a list"
                )
            # freeze the membership list so the plan stays hashable
            object.__setattr__(self, "value", tuple(self.value))

    def _coerced(self, arr: np.ndarray):
        """Align the literal with the column dtype (str literals vs a
        bytes column, as produced by non-dictionary object columns)."""
        v = self.value
        if arr.dtype.kind == "S":
            enc = lambda x: x.encode("utf-8") if isinstance(x, str) else x  # noqa: E731
            return tuple(enc(x) for x in v) if self.op == "in" else enc(v)
        return v

    def mask(self, arr: np.ndarray) -> np.ndarray:
        """Vectorized evaluation over an array of column values."""
        arr = np.asarray(arr)
        v = self._coerced(arr)
        if self.op == "==":
            out = arr == v
        elif self.op == "!=":
            out = arr != v
        elif self.op == "<":
            out = arr < v
        elif self.op == "<=":
            out = arr <= v
        elif self.op == ">":
            out = arr > v
        elif self.op == ">=":
            out = arr >= v
        else:  # in
            out = np.isin(arr, np.asarray(list(v)))
        return np.asarray(out, dtype=bool)

    def code_table(self, decode_map: np.ndarray) -> np.ndarray:
        """Boolean table over codes: ``table[code]`` == predicate holds
        for ``decode_map[code]``.  One evaluation per *distinct value*
        instead of per row — the learned-store pushdown."""
        return self.mask(decode_map)

    def describe(self) -> str:
        """Compact ``column<op>value`` form for explain output."""
        return f"{self.column}{self.op}{self.value!r}"


def columns_with_predicates(
    columns: Optional[Tuple[str, ...]],
    predicates: Tuple[Predicate, ...],
) -> Optional[Tuple[str, ...]]:
    """The decode set for post-hoc predicate evaluation: the selected
    columns extended by predicate-only columns (``None`` = all columns,
    which already includes them).  The one definition every post-hoc
    site shares, so the pushdown-vs-posthoc byte-equality oracle can
    never silently compare different projections."""
    if columns is None or not predicates:
        return columns
    return tuple(columns) + tuple(
        p.column for p in predicates if p.column not in columns
    )


def evaluate_predicates(
    predicates: Tuple[Predicate, ...],
    values: Dict[str, np.ndarray],
    exists: np.ndarray,
    stats: "ExplainStats",
) -> np.ndarray:
    """AND-conjunction of ``predicates`` over decoded ``values`` —
    THE post-hoc evaluator (executor morsels, the staged reference
    path, and the stores' generic overlay-view fallback all call this
    one function, so conjunction semantics cannot drift).  Records
    ``filter_s``/``predicates``/``rows_matched`` on ``stats`` and
    returns the row selector (``exists`` AND every predicate)."""
    t0 = time.perf_counter()
    match = exists.copy()
    for p in predicates:
        match &= p.mask(values[p.column])
    stats.filter_s += time.perf_counter() - t0
    stats.predicates = tuple(p.describe() for p in predicates)
    stats.rows_matched += int(match.sum())
    return match


@dataclasses.dataclass(frozen=True)
class AggSpec:
    """One aggregate in a ``group_by(...).agg(...)`` plan.

    ``func`` is one of :data:`AGG_FUNCS`.  ``count`` takes no column
    (it counts existing/matching rows); ``sum``/``min``/``max`` name
    the numeric column they reduce.  On code-space stores the reduction
    runs over aux-corrected argmax codes: counts never touch values at
    all, and ``sum``/``min``/``max`` gather through a code→value table
    (the column's decode map cast to the accumulator dtype), so no row
    is ever decoded — see DESIGN.md §Aggregation & joins.
    """

    func: str
    column: Optional[str] = None

    def __post_init__(self) -> None:
        if self.func not in AGG_FUNCS:
            raise ValueError(f"unknown aggregate {self.func!r}; have {AGG_FUNCS}")
        if self.func == "count" and self.column is not None:
            raise ValueError("count takes no column (rows have no nulls)")
        if self.func != "count" and self.column is None:
            raise ValueError(f"{self.func} needs a column")

    def name(self) -> str:
        """Result-dict key: ``count`` or ``func(column)``."""
        return "count" if self.func == "count" else f"{self.func}({self.column})"


@dataclasses.dataclass(frozen=True, eq=False)
class JoinSpec:
    """Key-equi join against another store's existence index.

    ``store`` is any :class:`~repro_torch.api.protocol.MappingStore`; for
    each surviving left morsel the executor maps the left keys through
    ``key`` (``None`` = identity; e.g. ``lambda k: k // 8`` recovers
    the orderkey from a packed lineitem key), scatters the probe keys
    through the right store's own dispatch/collect hooks (existence
    index + shard/member scatter included), and keeps only rows whose
    probe key exists on the right — an inner join streamed morsel by
    morsel, store to store.  ``columns`` projects the right side
    (``None`` = all right columns); a right column whose name collides
    with a left output column is prefixed with ``prefix``.

    Identity-based equality/hash on purpose: the spec holds a live
    store object, and two plans joining the same store instance are
    the same join.
    """

    store: object
    key: Optional[object] = None
    columns: Optional[Tuple[str, ...]] = None
    prefix: str = "r."


def aggregate_columns(
    group_by: Tuple[str, ...], aggregates: Tuple[AggSpec, ...]
) -> Tuple[str, ...]:
    """The store-side projection an aggregate plan needs: group-by
    columns plus every aggregated column, deduplicated in order."""
    cols = list(group_by)
    for spec in aggregates:
        if spec.column is not None and spec.column not in cols:
            cols.append(spec.column)
    return tuple(cols)


def agg_value_table(column: str, decode_map: np.ndarray) -> np.ndarray:
    """Code→value table for ``sum``/``min``/``max`` below decode: the
    column's decode map cast to the exact accumulator dtype (int64 for
    integer/bool columns — exact; float64 for float columns), frozen
    read-only.  Rejects non-numeric columns, the same contract the
    row-space reference path (:func:`aggregate_rows`) enforces."""
    dm = np.asarray(decode_map)
    if dm.dtype.kind not in "biuf":
        raise ValueError(
            f"sum/min/max need a numeric column; {column!r} has dtype {dm.dtype}"
        )
    table = dm.astype(np.float64 if dm.dtype.kind == "f" else np.int64)
    table.setflags(write=False)
    return table


def _agg_numeric(column: str, arr: np.ndarray) -> np.ndarray:
    """Row values cast to the accumulator dtype (see
    :func:`agg_value_table` — both paths must reduce in the same
    dtype or sums could differ by overflow/rounding)."""
    arr = np.asarray(arr)
    if arr.dtype.kind not in "biuf":
        raise ValueError(
            f"sum/min/max need a numeric column; {column!r} has dtype {arr.dtype}"
        )
    return arr.astype(np.float64 if arr.dtype.kind == "f" else np.int64)


def _agg_combine(func: str, a, b):
    """Fold one accumulator pair (associative + commutative, so morsel
    and shard merge order cannot change results)."""
    if func in ("count", "sum"):
        return a + b
    return min(a, b) if func == "min" else max(a, b)


def agg_partials(
    aggregates: Tuple[AggSpec, ...],
    ginv: np.ndarray,
    num_groups: int,
    value_arrays,
) -> list:
    """Per-group partial aggregates for one chunk.

    ``ginv`` maps each selected row to its group index in
    ``[0, num_groups)`` (every group non-empty); ``value_arrays`` is
    aligned with ``aggregates`` (``None`` for ``count``, else the
    selected rows' values in accumulator dtype — decoded values on the
    reference path, code→value-table gathers on the code-space path).
    Returns one array of length ``num_groups`` per spec.
    """
    partials = []
    order = starts = None
    for spec, vals in zip(aggregates, value_arrays):
        if spec.func == "count":
            partials.append(np.bincount(ginv, minlength=num_groups).astype(np.int64))
            continue
        if spec.func == "sum":
            acc = np.zeros(num_groups, dtype=vals.dtype)
            np.add.at(acc, ginv, vals)
            partials.append(acc)
            continue
        if order is None:
            order = np.argsort(ginv, kind="stable")
            starts = np.searchsorted(ginv[order], np.arange(num_groups))
        op = np.minimum if spec.func == "min" else np.maximum
        partials.append(op.reduceat(vals[order], starts))
    return partials


def fold_agg_partials(
    state: Dict[tuple, list],
    group_tuples,
    aggregates: Tuple[AggSpec, ...],
    partials,
) -> Dict[tuple, list]:
    """Fold one chunk's per-group partials into the running state
    (``state[group-value-tuple][i]`` accumulates ``aggregates[i]``).
    Keys are *decoded* group values, never codes: codes are per-store
    (shards and federation members own independent codecs), decoded
    values are the one vocabulary every source shares."""
    for j, g in enumerate(group_tuples):
        acc = state.get(g)
        if acc is None:
            state[g] = [p[j] for p in partials]
        else:
            for i, spec in enumerate(aggregates):
                acc[i] = _agg_combine(spec.func, acc[i], partials[i][j])
    return state


def aggregate_rows(
    state: Dict[tuple, list],
    group_by: Tuple[str, ...],
    aggregates: Tuple[AggSpec, ...],
    values: Dict[str, np.ndarray],
    sel: np.ndarray,
) -> Dict[tuple, list]:
    """Decode-then-aggregate reference: fold the selected rows of one
    decoded morsel into ``state``.  THE row-space aggregation path —
    the default store hook, the ``pushdown=False`` executor reference,
    and the test oracles all route here, so code-space results have a
    single definition to be value-identical to."""
    idx = np.flatnonzero(sel)
    if idx.size == 0:
        return state
    if group_by:
        uniqs, invs, dims = [], [], []
        for c in group_by:
            u, inv = np.unique(np.asarray(values[c])[idx], return_inverse=True)
            uniqs.append(u)
            invs.append(inv)
            dims.append(len(u))
        combined = np.ravel_multi_index(invs, dims) if len(invs) > 1 else invs[0]
        ug, ginv = np.unique(combined, return_inverse=True)
        coords = np.unravel_index(ug, dims)
        labels = [u[c].tolist() for u, c in zip(uniqs, coords)]
        group_tuples = list(zip(*labels))
    else:
        ug = np.zeros(1, dtype=np.int64)
        ginv = np.zeros(idx.size, dtype=np.int64)
        group_tuples = [()]
    value_arrays = [
        None if spec.column is None
        else _agg_numeric(spec.column, np.asarray(values[spec.column])[idx])
        for spec in aggregates
    ]
    partials = agg_partials(aggregates, ginv, len(ug), value_arrays)
    return fold_agg_partials(state, group_tuples, aggregates, partials)


def merge_agg_states(
    state: Dict[tuple, list],
    other: Dict[tuple, list],
    aggregates: Tuple[AggSpec, ...],
) -> Dict[tuple, list]:
    """Merge a morsel/shard/member partial state into the running one
    (group-wise :func:`_agg_combine` — order-insensitive)."""
    for g, accs in other.items():
        mine = state.get(g)
        if mine is None:
            state[g] = list(accs)
        else:
            for i, spec in enumerate(aggregates):
                mine[i] = _agg_combine(spec.func, mine[i], accs[i])
    return state


def finalize_agg_state(
    state: Dict[tuple, list],
    group_by: Tuple[str, ...],
    aggregates: Tuple[AggSpec, ...],
):
    """Deterministic result arrays from the folded state: groups sorted
    by their value tuple, one array per group column and per aggregate
    (keyed by :meth:`AggSpec.name`)."""
    order = sorted(state)
    groups = {
        c: np.asarray([g[i] for g in order]) for i, c in enumerate(group_by)
    }
    aggs = {
        spec.name(): np.asarray([state[g][i] for g in order])
        for i, spec in enumerate(aggregates)
    }
    return groups, aggs


@dataclasses.dataclass(frozen=True)
class QueryPlan:
    """Declarative query description — what to fetch, not how.

    ``kind`` selects the key source: ``"point"`` answers the explicit
    ``keys`` array, ``"range"`` every existing key in ``[lo, hi)``,
    ``"scan"`` every existing key.  ``columns`` is the projection
    (``None`` = all columns); ``predicates`` is an AND-conjunction of
    value predicates — a plan with predicates returns ONLY matching
    rows (``exists`` all-True).  ``pushdown`` routes predicate
    evaluation into the store hooks (code-level on DeepMapping stores,
    overlay-view on baselines); ``pushdown=False`` keeps the post-hoc
    reference path: decode everything, filter after — byte-identical
    results, more rows decoded.  ``fanout`` overrides the sharded
    store's parallel lookup fan-out; ``morsel`` **forces a fixed**
    executor chunk size (``None`` = adaptive sizing seeded at
    :data:`DEFAULT_MORSEL`, resized between morsels from per-operator
    timings).  ``cache`` routes plan compilation through the store's
    :class:`~repro_torch.api.cache.PlanCache` (``False`` = always recompile
    — the warm-vs-cold reference path).
    """

    kind: str
    keys: Optional[np.ndarray] = None
    lo: Optional[int] = None
    hi: Optional[int] = None
    columns: Optional[Tuple[str, ...]] = None
    predicates: Tuple[Predicate, ...] = ()
    pushdown: bool = True
    fanout: Optional[bool] = None
    morsel: Optional[int] = None
    cache: bool = True
    on_error: str = "raise"
    group_by: Tuple[str, ...] = ()
    aggregates: Tuple[AggSpec, ...] = ()
    join: Optional[JoinSpec] = None

    def __post_init__(self) -> None:
        if self.kind not in PLAN_KINDS:
            raise ValueError(f"unknown plan kind {self.kind!r}; have {PLAN_KINDS}")
        if self.kind == "point" and self.keys is None:
            raise ValueError("point plan needs keys")
        if self.kind == "range" and (self.lo is None or self.hi is None):
            raise ValueError("range plan needs lo and hi")
        if self.morsel is not None and self.morsel < 1:
            raise ValueError("morsel size must be >= 1")
        if self.on_error not in ERROR_MODES:
            raise ValueError(
                f"unknown on_error mode {self.on_error!r}; have {ERROR_MODES}"
            )
        if self.group_by and not self.aggregates:
            raise ValueError("group_by(...) needs agg(...)")
        if self.aggregates and self.columns is not None:
            raise ValueError(
                "select() conflicts with agg(...): aggregates define the output"
            )
        if self.aggregates and self.join is not None:
            raise ValueError("agg(...) and join(...) cannot combine in one plan")

    def source_stage(self) -> str:
        """Human-readable key-source stage name for explain output."""
        if self.kind == "point":
            return f"keys[{0 if self.keys is None else len(self.keys)}]"
        if self.kind == "range":
            return f"range[{self.lo},{self.hi})"
        return "scan"

    def morsel_rows(self) -> int:
        """Initial executor chunk size (fixed when ``morsel`` is set)."""
        return DEFAULT_MORSEL if self.morsel is None else int(self.morsel)


@dataclasses.dataclass(frozen=True)
class OperatorStats:
    """One executed operator's row in the explain output."""

    name: str
    rows_in: int
    rows_out: int
    seconds: float


def _union(a: Tuple[str, ...], b: Tuple[str, ...]) -> Tuple[str, ...]:
    """Order-preserving union of two evidence tuples."""
    seen = dict.fromkeys(a)
    seen.update(dict.fromkeys(b))
    return tuple(seen)


@dataclasses.dataclass
class ExplainStats:
    """Per-plan execution report (the paper's Fig. 7 latency breakdown,
    plus pushdown, fan-out, and per-operator evidence).

    ``plan`` lists the executed pipeline stages in order; ``operators``
    is the structured per-operator breakdown (rows in/out + seconds)
    the executor assembles after the morsel stream drains.
    ``heads_evaluated``/``heads_skipped`` record which model private
    heads ran (DeepMapping stores only — baselines always report all
    heads skipped since they have no model); ``columns_decoded``/
    ``columns_skipped`` record the decode projection every store type
    honours; ``predicates`` the pushed-down value filters and
    ``rows_decoded`` how many rows actually reached a decode call
    (strictly fewer than ``num_keys`` under selective pushdown).
    ``partitions_pruned`` counts baseline partitions skipped by the
    dictionary zone maps; ``plan_cache`` reports the plan-cache
    outcome (``"hit"``/``"miss"``/``"bypass"``) and ``morsel_sizes``
    the dispatched morsel row counts (adaptive sizing evidence).
    Timings are seconds; under shard fan-out / morsel merging the
    per-stage times are summed (CPU time), while ``total_s`` is wall
    clock.  See DESIGN.md §Explain-stats reference for the full
    field-by-field table.
    """

    kind: str = ""
    plan: Tuple[str, ...] = ()
    operators: Tuple[OperatorStats, ...] = ()
    num_keys: int = 0
    num_rows: int = 0
    morsels: int = 0
    shards_visited: int = 0
    #: Distinct shard ids behind ``shards_visited`` (sharded stores
    #: populate ints; the federation namespaces them per member, e.g.
    #: ``"m1:2"``; morsel merging unions them so disjoint morsels that
    #: each touch one shard still aggregate to the true fan-out).
    shard_ids: Tuple = ()
    async_fanout: bool = False
    heads_evaluated: Tuple[str, ...] = ()
    heads_skipped: Tuple[str, ...] = ()
    columns_decoded: Tuple[str, ...] = ()
    columns_skipped: Tuple[str, ...] = ()
    predicates: Tuple[str, ...] = ()
    rows_decoded: int = 0
    rows_matched: int = 0
    #: True when the pushed-down predicates were evaluated *in-kernel*
    #: (fused kernel tier emitted match bits with the codes), so the
    #: host filter stage only patched aux-overridden rows.  ``filter_s``
    #: then measures that patch, not a per-row table gather.
    kernel_filtered: bool = False
    partitions_pruned: int = 0
    plan_cache: str = ""
    morsel_sizes: Tuple[int, ...] = ()
    #: Terminal owner failures this plan degraded around, as compact
    #: ``OwnerError.describe()`` strings ("shard:2@shard_collect: ...").
    #: Non-empty only for ``on_error='partial'`` results.
    owners_failed: Tuple[str, ...] = ()
    #: Retry attempts (beyond each first try) spent across owners.
    retries: int = 0
    #: Requested keys whose owner failed terminally — *unreachable*,
    #: not absent: they report ``exists=False`` with placeholder values
    #: but may well exist on the failed owner.
    keys_unresolved: int = 0
    #: Result groups emitted by a ``group_by(...).agg(...)`` plan (set
    #: on the final plan stats; per-morsel partials leave it 0 — a
    #: group seen by many morsels is still one emitted group).
    groups_emitted: int = 0
    #: Probe keys scattered into the right store's existence index by
    #: a ``join(...)`` plan (summed across morsels).
    join_probes: int = 0
    route_s: float = 0.0
    infer_s: float = 0.0
    exist_s: float = 0.0
    aux_s: float = 0.0
    filter_s: float = 0.0
    decode_s: float = 0.0
    agg_s: float = 0.0
    gather_s: float = 0.0
    total_s: float = 0.0

    def merge_timings(self, other: "ExplainStats") -> None:
        """Accumulate another stats object's stage timings, counters,
        and pushdown evidence (shard fan-out / morsel / server batch
        aggregation).  Evidence tuples are unioned — a shard or morsel
        must never make the aggregate under-report which heads ran or
        which columns were decoded — and ``shards_visited`` keeps the
        widest fan-out seen rather than being dropped."""
        self.route_s += other.route_s
        self.infer_s += other.infer_s
        self.exist_s += other.exist_s
        self.aux_s += other.aux_s
        self.filter_s += other.filter_s
        self.decode_s += other.decode_s
        self.agg_s += other.agg_s
        self.gather_s += other.gather_s
        self.rows_decoded += other.rows_decoded
        self.rows_matched += other.rows_matched
        self.partitions_pruned += other.partitions_pruned
        self.retries += other.retries
        self.keys_unresolved += other.keys_unresolved
        self.join_probes += other.join_probes
        # one group seen by N morsels is still one group — keep the max
        self.groups_emitted = max(self.groups_emitted, other.groups_emitted)
        self.owners_failed = _union(self.owners_failed, other.owners_failed)
        self.shard_ids = tuple(
            dict.fromkeys(self.shard_ids + other.shard_ids)
        )
        # Distinct-id union when shards are tracked (disjoint morsels
        # each touching one shard still sum to the true fan-out); the
        # max keeps a count-only side (a store reporting no ids) from
        # being dropped.
        self.shards_visited = max(
            len(self.shard_ids), self.shards_visited, other.shards_visited
        )
        self.async_fanout = self.async_fanout or other.async_fanout
        self.heads_evaluated = _union(self.heads_evaluated, other.heads_evaluated)
        self.heads_skipped = _union(self.heads_skipped, other.heads_skipped)
        self.columns_decoded = _union(self.columns_decoded, other.columns_decoded)
        self.columns_skipped = _union(self.columns_skipped, other.columns_skipped)
        self.predicates = _union(self.predicates, other.predicates)
        self.kernel_filtered = self.kernel_filtered or other.kernel_filtered


@dataclasses.dataclass
class QueryResult:
    """Executed plan output.

    ``values`` maps column name -> decoded array aligned with ``keys``;
    ``exists`` is the existence mask (all-True for range/scan results,
    whose keys come from the existence index).  Rows where ``exists``
    is False carry placeholder values — callers must respect the mask,
    the same contract as the legacy ``lookup``.  Plans with value
    predicates return only matching rows: ``keys``/``values`` are
    filtered and ``exists`` is all-True.
    """

    keys: np.ndarray
    values: Dict[str, np.ndarray]
    exists: np.ndarray
    explain: ExplainStats

    @property
    def num_rows(self) -> int:
        """Existing result rows (``exists.sum()``)."""
        return int(self.exists.sum())


@dataclasses.dataclass
class AggregateResult:
    """Executed ``group_by(...).agg(...)`` plan output.

    ``groups`` maps each group-by column to its per-group value array;
    ``aggregates`` maps each :meth:`AggSpec.name` to the per-group
    aggregate array, all aligned and sorted by group-value tuple (so
    two executions — or the code-space and reference paths — produce
    positionally comparable arrays).  A global aggregate (no group-by
    columns) emits exactly one group with empty ``groups``.
    """

    group_by: Tuple[str, ...]
    groups: Dict[str, np.ndarray]
    aggregates: Dict[str, np.ndarray]
    explain: ExplainStats

    @property
    def num_groups(self) -> int:
        """Emitted result groups."""
        first = next(iter(self.aggregates.values()), None)
        return 0 if first is None else int(len(first))
