"""Fluent query builder over any :class:`~repro_torch.api.protocol.MappingStore`.

A copy of ``repro.api.query`` with its imports rewritten to the port, which
imports nothing of ``repro``.

    values, exists = store.query().where_keys(ks).execute()
    res = store.query().select("status").where_range(0, 10**6).execute()
    res = store.query().where("status", "==", "F").scan().execute()
    for morsel in store.query().scan().stream(): ...

A builder compiles to a :class:`~repro_torch.api.plan.QueryPlan` (inspect it
with :meth:`Query.plan`) and executes through the streaming operator
pipeline; the result's ``explain`` field reports the executed
operators, pushdown evidence, and the latency breakdown.  Value
predicates (:meth:`where`) are pushed down by default — DeepMapping
stores evaluate them on per-head argmax codes before any row is
decoded; :meth:`pushdown` ``(False)`` switches to the post-hoc
reference filter (decode everything, filter after), kept for
byte-equality testing.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from repro_torch.api.plan import AggSpec, JoinSpec, Predicate, QueryPlan


class Query:
    """One query under construction.  Builder methods return ``self``;
    exactly one key source (``where_keys`` / ``where_range`` /
    ``scan``) must be chosen before :meth:`execute`."""

    def __init__(self, store):
        self._store = store
        self._kind: Optional[str] = None
        self._keys: Optional[np.ndarray] = None
        self._lo: Optional[int] = None
        self._hi: Optional[int] = None
        self._columns: Optional[Tuple[str, ...]] = None
        self._predicates: Tuple[Predicate, ...] = ()
        self._pushdown: bool = True
        self._fanout: Optional[bool] = None
        self._morsel: Optional[int] = None
        self._cache: bool = True
        self._on_error: str = "raise"
        self._group_by: Tuple[str, ...] = ()
        self._aggregates: Tuple[AggSpec, ...] = ()
        self._join: Optional[JoinSpec] = None

    # ------------------------------------------------------------ projection
    def select(self, *columns: str) -> "Query":
        """Project to the given columns (pushdown: unselected columns
        are not decoded, and DeepMapping stores skip their private
        model heads).  Accepts names or one iterable of names."""
        if len(columns) == 1 and not isinstance(columns[0], str):
            columns = tuple(columns[0])
        if not columns:
            raise ValueError("select() needs at least one column")
        self._check_columns(columns)
        self._columns = tuple(dict.fromkeys(columns))  # dedup, keep order
        return self

    def _check_columns(self, columns: Sequence[str]) -> None:
        known = set(self._store.columns)
        unknown = [c for c in columns if c not in known]
        if unknown:
            raise ValueError(
                f"unknown column(s) {unknown}; store has {sorted(known)}"
            )

    # ------------------------------------------------------------ predicates
    def where(self, column: str, op: str, value) -> "Query":
        """Add a value predicate ``column <op> value`` (AND-combined
        with earlier ``where`` calls).  Pushed down below decode by
        default: the result contains only matching rows, and on
        DeepMapping stores non-matching rows are never decoded — the
        predicate evaluates on per-head argmax codes (aux-corrected),
        with aux/overlay rows filtered through the same path."""
        self._check_columns((column,))
        self._predicates += (Predicate(column=column, op=op, value=value),)
        return self

    def pushdown(self, enabled: bool) -> "Query":
        """``False`` = post-hoc reference filter: decode every row,
        then filter on decoded values.  Byte-identical results to the
        pushed-down path (the equivalence suite checks this); strictly
        more rows decoded."""
        self._pushdown = bool(enabled)
        return self

    # ----------------------------------------------------------- aggregation
    def group_by(self, *columns: str) -> "Query":
        """Group the result by the given columns (follow with
        :meth:`agg`).  On code-space stores the grouping runs below
        decode: rows group by their aux-corrected argmax codes and only
        the distinct group *labels* are decoded, so a count-only
        group-by reports ``rows_decoded == 0``.  Zero columns (the
        default when only :meth:`agg` is called) is a global aggregate:
        one group."""
        if len(columns) == 1 and not isinstance(columns[0], str):
            columns = tuple(columns[0])
        self._check_columns(columns)
        self._group_by = tuple(dict.fromkeys(columns))
        return self

    def agg(self, *specs) -> "Query":
        """Add aggregates: ``"count"`` or ``(func, column)`` pairs with
        ``func`` in :data:`~repro_torch.api.plan.AGG_FUNCS` (``AggSpec``
        objects also accepted).  ``sum``/``min``/``max`` need a numeric
        column and resolve per-group values through code→value tables
        below decode; :meth:`execute` then returns an
        :class:`~repro_torch.api.plan.AggregateResult`."""
        parsed = []
        for spec in specs:
            if isinstance(spec, AggSpec):
                parsed.append(spec)
            elif isinstance(spec, str):
                parsed.append(AggSpec(func=spec))
            else:
                func, column = spec
                parsed.append(AggSpec(func=func, column=column))
        for spec in parsed:
            if spec.column is not None:
                self._check_columns((spec.column,))
        self._aggregates += tuple(parsed)
        return self

    # ------------------------------------------------------------------ join
    def join(self, store, key=None, columns=None, prefix: str = "r.") -> "Query":
        """Inner key-equi join against another store: each surviving
        left row's key is mapped through ``key`` (``None`` = identity)
        and probed into ``store``'s existence index; matching rows keep
        the right store's ``columns`` (``None`` = all), streamed morsel
        by morsel store-to-store (shard/member scatter included).
        Right columns colliding with left output names are prefixed
        with ``prefix``."""
        if columns is not None:
            if isinstance(columns, str):
                columns = (columns,)
            known = set(store.columns)
            unknown = [c for c in columns if c not in known]
            if unknown:
                raise ValueError(
                    f"unknown join column(s) {unknown}; right store has "
                    f"{sorted(known)}"
                )
            columns = tuple(dict.fromkeys(columns))
        if key is not None and not callable(key):
            raise ValueError("join key must be a callable mapping left keys")
        self._join = JoinSpec(store=store, key=key, columns=columns, prefix=prefix)
        return self

    # ------------------------------------------------------------ key source
    def _set_kind(self, kind: str) -> None:
        if self._kind is not None:
            raise ValueError(
                f"key source already set to {self._kind!r}; a query has "
                f"exactly one of where_keys/where_range/scan"
            )
        self._kind = kind

    def where_keys(self, keys: Sequence[int]) -> "Query":
        """Point lookups for the given keys (request order preserved)."""
        self._set_kind("point")
        self._keys = np.asarray(keys, dtype=np.int64)
        return self

    def where_range(self, lo: int, hi: int) -> "Query":
        """Every existing key in ``[lo, hi)``, ascending."""
        self._set_kind("range")
        self._lo, self._hi = int(lo), int(hi)
        return self

    def scan(self) -> "Query":
        """Every existing key, ascending."""
        self._set_kind("scan")
        return self

    # ------------------------------------------------------------- execution
    def fanout(self, enabled: bool) -> "Query":
        """Override the sharded store's parallel lookup fan-out (the
        plan executor defaults it ON; single stores ignore it)."""
        self._fanout = bool(enabled)
        return self

    def morsel(self, rows: int) -> "Query":
        """Force a FIXED executor morsel size (rows per streamed
        chunk).  Without it the executor sizes morsels adaptively:
        seeded at :data:`~repro_torch.api.plan.DEFAULT_MORSEL` and resized
        between morsels from per-operator timings (bounded,
        power-of-two aligned — see ``executor.next_morsel_rows``)."""
        self._morsel = int(rows)
        return self

    def cached(self, enabled: bool) -> "Query":
        """``False`` bypasses the store's plan cache: key-source
        materializations, projection subsets, and predicate code
        tables are recompiled for this plan (the warm-vs-cold
        reference path; results are byte-identical either way)."""
        self._cache = bool(enabled)
        return self

    def on_error(self, mode: str) -> "Query":
        """Failure semantics when an owner (shard, federation member,
        engine) fails terminally after retries.  ``"raise"`` (default)
        raises :class:`~repro_torch.fault.errors.OwnerFailure`; ``"partial"``
        returns the healthy owners' rows byte-identical to a full run —
        unreachable keys report ``exists=False`` — with the failures
        recorded on ``explain`` (``owners_failed``, ``retries``,
        ``keys_unresolved``) so absent and unreachable stay
        distinguishable."""
        self._on_error = str(mode)
        return self

    def plan(self) -> QueryPlan:
        """Compile to the IR without executing."""
        if self._kind is None:
            raise ValueError(
                "no key source; call where_keys/where_range/scan first"
            )
        return QueryPlan(
            kind=self._kind,
            keys=self._keys,
            lo=self._lo,
            hi=self._hi,
            columns=self._columns,
            predicates=self._predicates,
            pushdown=self._pushdown,
            fanout=self._fanout,
            morsel=self._morsel,
            cache=self._cache,
            on_error=self._on_error,
            group_by=self._group_by,
            aggregates=self._aggregates,
            join=self._join,
        )

    def execute(self):
        """Compile and run the plan through the streaming executor.

        Returns a :class:`~repro_torch.api.plan.QueryResult` — or an
        :class:`~repro_torch.api.plan.AggregateResult` when :meth:`agg`
        aggregates are set.
        """
        from repro_torch.api.executor import execute_plan  # local: keep import light

        return execute_plan(self._store, self.plan())

    def stream(self) -> Iterator:
        """Morsel-at-a-time execution: yields
        :class:`~repro_torch.api.executor.MorselResult` chunks as their host
        halves complete, while later morsels' device work stays in
        flight.  Predicate ``match`` selectors are left on the morsels
        for the caller (use :meth:`execute` for a filtered relation)."""
        from repro_torch.api.executor import stream_plan

        return stream_plan(self._store, self.plan())
