"""The formal ``MappingStore`` protocol — one lookup contract over
interchangeable store structures (learned-index tradition: RMI exposes
one ``lookup`` over trees of models; NeurStore one model-store API).

A copy of ``repro.api.protocol`` with its imports rewritten to the port, which
imports nothing of ``repro``.

The port's :class:`~repro_torch.core.hybrid.DeepMappingStore` subclasses
:class:`MappingStore` (the sharded store and the baselines follow with
ROADMAP items M7 and M8) and is exercised by the port's conformance
cases (``tests/test_torch_query.py``).

Conformance contract (what the suite checks):

1. ``lookup(keys, columns) -> (values, exists)``: values aligned with
   the request, NULL rows carry placeholder values and must be masked
   by ``exists``; zero-length key batches return typed empty columns
   and never reach inference/stack paths.
2. ``insert`` raises on existing keys and mutates nothing on reject;
   ``update`` raises on missing keys likewise; ``delete`` is
   idempotent.  All accept zero-length batches as no-ops.
3. ``range_lookup(lo, hi)`` / ``scan()`` return ``(keys, values)`` with
   keys ascending and every key existing.
4. ``size_breakdown()`` maps component name -> bytes and sums to
   ``size_bytes()``.
5. ``save(path)`` then ``type(store).load(path)`` (or ``repro_torch.open``)
   round-trips: identical query results.
6. ``query()`` plans execute byte-identically to the direct methods,
   including after interleaved insert/delete/update, and projection
   pushdown (``select``) never changes selected-column bytes.
7. Value-predicate pushdown (``where``) returns byte-identical rows to
   the post-hoc reference filter (``pushdown(False)``), including
   rows answered by the aux table / modification overlay
   (``tests/test_streaming_executor.py``).
"""

from __future__ import annotations

import abc
import time
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.api.cache import PlanCache
from repro_torch.api.plan import (
    ExplainStats,
    aggregate_rows,
    columns_with_predicates,
    evaluate_predicates,
)

#: Methods every conforming store must expose (used by the suite's
#: surface check; behavioural checks live in the parametrized tests).
CONFORMANCE_METHODS = (
    "lookup",
    "insert",
    "delete",
    "update",
    "range_lookup",
    "scan",
    "size_breakdown",
    "size_bytes",
    "save",
    "load",
    "query",
)


def _check_index_agreement(kind: str, exists: np.ndarray) -> None:
    """Keys sourced from the existence index must all exist; a miss
    means the index and the lookup path disagree.  A real error — not
    an ``assert``, which vanishes under ``python -O`` (the executor
    raises the same way)."""
    if not bool(exists.all()):
        raise RuntimeError(
            f"{kind} produced keys missing from the store: existence "
            f"index and lookup path disagree"
        )


class MappingStore(abc.ABC):
    """Abstract base of every key->row store (learned or baseline)."""

    # Lazily-created instance state (see mutation_version / plan_cache);
    # declared here so the typed surface knows their types.
    _mutation_version: int
    _plan_cache: PlanCache

    # ------------------------------------------------------------- required
    @property
    @abc.abstractmethod
    def columns(self) -> Tuple[str, ...]:
        """Value column names, in the store's canonical order."""

    @abc.abstractmethod
    def lookup(
        self, keys: np.ndarray, columns: Optional[Tuple[str, ...]] = None
    ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
        """Batched exact-match lookup -> ``(values, exists)``."""

    @abc.abstractmethod
    def insert(self, keys: np.ndarray, columns: Dict[str, np.ndarray]) -> None:
        """Insert new rows; raises ``ValueError`` if any key exists."""

    @abc.abstractmethod
    def delete(self, keys: np.ndarray) -> None:
        """Delete rows (idempotent: missing keys are ignored)."""

    @abc.abstractmethod
    def update(self, keys: np.ndarray, columns: Dict[str, np.ndarray]) -> None:
        """Overwrite existing rows; raises ``ValueError`` on missing keys."""

    @abc.abstractmethod
    def size_breakdown(self) -> Dict[str, int]:
        """Bytes per storage component (the paper's Fig. 6 accounting)."""

    @abc.abstractmethod
    def save(self, path: str) -> None:
        """Persist to ``path`` (atomic).  ``type(store).load`` restores."""

    @classmethod
    @abc.abstractmethod
    def load(cls, path: str, pool=None) -> "MappingStore":
        """Restore a store saved by :meth:`save`."""

    @abc.abstractmethod
    def _range_keys(self, lo: int, hi: Optional[int]) -> np.ndarray:
        """Existing keys in ``[lo, hi)`` ascending (``hi=None`` =
        unbounded) — the key source for range/scan plans."""

    # ------------------------------------------------------ shared surface
    def _all_keys(self) -> np.ndarray:
        return self._range_keys(0, None)

    def range_lookup(
        self, lo: int, hi: int, columns: Optional[Tuple[str, ...]] = None
    ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        """Paper §IV-E first approach: range-filter the existence index,
        then answer the collected keys by batched lookup."""
        keys = self._range_keys(int(lo), int(hi))
        values, exists = self.lookup(keys, columns)
        _check_index_agreement("range", exists)
        return keys, values

    def scan(
        self, columns: Optional[Tuple[str, ...]] = None
    ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        """Full relation scan -> ``(keys, values)``, keys ascending."""
        keys = self._all_keys()
        values, exists = self.lookup(keys, columns)
        _check_index_agreement("scan", exists)
        return keys, values

    def size_bytes(self) -> int:
        """Total storage footprint (sum of :meth:`size_breakdown`)."""
        return sum(self.size_breakdown().values())

    def query(self):
        """Start a plan-based query: ``store.query().select(...)
        .where_keys(ks) | .where_range(lo, hi) | .scan() .execute()``."""
        from repro_torch.api.query import Query  # local: avoids import cycle

        return Query(self)

    # ------------------------------------------------ plan-cache integration
    def mutation_version(self) -> object:
        """Opaque token that changes on every logical mutation.

        The plan cache stamps each artifact with this token and drops
        it on mismatch, so ``insert``/``delete``/``update`` (including
        a decode-map-growing insert) can never serve stale compiled
        plans.  Stores call :meth:`_note_mutation` from their mutators;
        composite stores (sharded, federated) combine member tokens.
        Comparison is by equality only — the value has no ordering.
        """
        return getattr(self, "_mutation_version", 0)

    def _note_mutation(self) -> None:
        """Advance :meth:`mutation_version` (call from every mutator)."""
        self._mutation_version = getattr(self, "_mutation_version", 0) + 1

    def plan_cache(self) -> PlanCache:
        """This store's lazily-created :class:`~repro_torch.api.cache.PlanCache`.

        The streaming executor consults it for repeated-plan artifacts
        (key-source materializations, projection subsets); DeepMapping
        stores additionally memoize predicate code tables through it.
        ``store.plan_cache().clear()`` forces the cold path.
        """
        cache = getattr(self, "_plan_cache", None)
        if cache is None:
            cache = self._plan_cache = PlanCache()
        return cache

    # ------------------------------------------- async lookup pipeline hooks
    def _dispatch_lookup(
        self, keys, columns=None, fanout=None, predicates=(), keys_exist=False,
        on_error="raise",
    ):
        """Begin an async lookup; :meth:`_collect_lookup` finishes it.

        Model-backed stores override the pair so device inference for
        one morsel overlaps host aux-merge/decode of another (the
        streaming executor and serving engine dispatch morsel *i+1*
        before collecting morsel *i* — across plans, not just within
        one).  The default defers everything to collect time — baseline
        stores have no device stage to overlap, so dispatch/collect
        degenerates to a plain call.  ``predicates`` is the pushed-down
        value-filter conjunction (see :class:`~repro_torch.api.plan.Predicate`);
        ``keys_exist`` asserts every requested key exists (the executor
        sets it for range/scan plans, whose keys come from the
        existence index) — stores may exploit it to skip work (baseline
        partition pruning) but must never rely on it for point plans.
        ``on_error`` is the plan's failure mode (``"raise"``/
        ``"partial"``); multi-owner stores degrade around failed owners
        under ``"partial"``, single-owner stores ignore it (the
        executor handles their partial fallback)."""
        return (keys, columns, fanout, tuple(predicates), keys_exist)

    def _collect_lookup(self, handle):
        """Finish a lookup begun by :meth:`_dispatch_lookup` ->
        ``(values, exists, match, ExplainStats)``.

        ``match`` is ``None`` when no predicates were pushed down;
        otherwise a bool row-selector aligned with the request keys
        (``exists`` AND every predicate holds) — the executor keeps
        only those rows.  The default evaluates predicates on the
        store's ordinary lookup output, i.e. for the baselines on the
        **modification-overlay view**: inserted/updated rows are
        filtered by their overlay values, deleted rows by ``exists``."""
        keys, columns, fanout, predicates, _keys_exist = handle
        if not predicates:
            values, exists, stats = self._lookup_with_stats(
                keys, columns, fanout=fanout
            )
            stats.rows_decoded += int(np.asarray(keys).shape[0])
            return values, exists, None, stats
        selected = tuple(columns) if columns is not None else tuple(self.columns)
        need = columns_with_predicates(selected, predicates)
        values, exists, stats = self._lookup_with_stats(keys, need, fanout=fanout)
        match = evaluate_predicates(predicates, values, exists, stats)
        stats.rows_decoded += int(np.asarray(keys).shape[0])
        if len(need) != len(selected):
            values = {c: values[c] for c in selected}
        return values, exists, match, stats

    def _collect_aggregate(self, handle, group_by, aggregates):
        """Finish an *aggregate* lookup begun by :meth:`_dispatch_lookup`
        -> ``(state, ExplainStats)``.

        ``state`` maps decoded group-value tuples to accumulator lists
        (one per :class:`~repro_torch.api.plan.AggSpec`), foldable across
        morsels/shards/members with
        :func:`~repro_torch.api.plan.merge_agg_states` — keyed by decoded
        VALUES, never codes, because composite stores aggregate over
        members with independent codecs.  The default is the
        decode-then-aggregate reference: collect the rows the ordinary
        way and fold them through
        :func:`~repro_torch.api.plan.aggregate_rows` (baseline stores, which
        decode to answer at all, use this directly).  Code-space stores
        override it to aggregate argmax codes below decode."""
        values, exists, match, stats = self._collect_lookup(handle)
        sel = exists if match is None else match
        t0 = time.perf_counter()
        state: Dict[tuple, list] = {}
        aggregate_rows(state, group_by, aggregates, values, sel)
        stats.agg_s += time.perf_counter() - t0
        return state, stats

    def supports_kernel_filter(self, predicates: tuple = ()) -> bool:
        """Dispatch capability flag: ``True`` when the pushed-down
        ``predicates`` would be evaluated *inside* the store's device
        kernel (match bits emitted alongside codes + exist bits), so
        the executor's host ``Filter`` stage is redundant and may be
        skipped.  The default is ``False`` — baseline stores filter on
        the host.  Advisory only: the executor still honours the
        ``match`` column returned by :meth:`_collect_lookup`, so a
        store that answers ``True`` but falls back to host filtering
        for some chunk remains correct."""
        return False

    # ------------------------------------------------- executor stats hook
    def _lookup_with_stats(
        self,
        keys: np.ndarray,
        columns: Optional[Tuple[str, ...]] = None,
        fanout: Optional[bool] = None,
    ) -> Tuple[Dict[str, np.ndarray], np.ndarray, ExplainStats]:
        """Lookup plus per-call :class:`ExplainStats` (no mutable
        side-channel).  Default wraps :meth:`lookup` with coarse
        timing; model-backed stores override with real stage
        breakdowns.  ``fanout`` is advisory (sharded stores only)."""
        t0 = time.perf_counter()
        values, exists = self.lookup(keys, columns)
        stats = ExplainStats(
            plan=("lookup",),
            heads_skipped=tuple(self.columns),  # no model heads ran
            columns_decoded=tuple(values),
            columns_skipped=tuple(c for c in self.columns if c not in values),
        )
        stats.decode_s = time.perf_counter() - t0
        return values, exists, stats
