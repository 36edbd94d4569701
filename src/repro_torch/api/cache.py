"""Per-store plan-compilation cache (the adaptive-execution layer's
memory).

A copy of ``repro.api.cache`` with its imports rewritten to the port, which
imports nothing of ``repro``.

The streaming executor recompiles the same artifacts on every
``execute()`` of a repeated plan: the range/scan **key-source
materialization** (an existence-index scan), the resolved **projection
subset** (selected columns extended by post-hoc predicate columns),
and — on DeepMapping stores — the per-predicate boolean **code tables**
over a column's decode map.  Learned-index practice (RMI, NeurStore)
keeps learned/compiled artifacts resident across queries instead of
rebuilding them per call; :class:`PlanCache` does the same for plan
artifacts.

Every :class:`~repro_torch.api.protocol.MappingStore` owns one lazily-created
``PlanCache`` (``store.plan_cache()``).  Entries are keyed by a **plan
fingerprint** (:func:`plan_fingerprint` — the plan minus its execution
knobs) and validated against the store's **mutation version**
(``store.mutation_version()``): every ``insert``/``delete``/``update``
bumps the version, so a cached key stream or code table can never
outlive the state it was computed from.  ``ValueCodec.extend`` growing
a decode map only ever happens inside ``insert``/``update``, so the
version bump covers decode-map growth too; the code-table memo
additionally checks decode-map object identity as a second fence.

The cache is bounded (LRU over plan entries, hard cap on predicate
tables) and advisory: a miss or an unfingerprintable plan (e.g. an
unhashable predicate literal) falls back to recomputation — never to
an error.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch import obs

#: LRU capacity for plan-level entries (fingerprint -> artifacts).
PLAN_ENTRIES = 64

#: Byte budget for cached key-stream materializations.  Entries pin
#: O(num_rows) int64 arrays (a scan of a 100M-row store is 800 MB), so
#: the LRU must bound BYTES, not just entry count — varying-bound range
#: plans on a huge store would otherwise pin ``PLAN_ENTRIES`` full key
#: streams.
KEY_BYTES_BUDGET = 256 * 1024 * 1024

#: Hard cap on memoized predicate/aggregate code tables (ad-hoc
#: predicate churn must not grow the cache without bound; tables are
#: tiny, so a full clear on overflow is cheaper than LRU bookkeeping).
PRED_TABLES = 64

#: Per-key cap on code-table variants.  A cache shared across
#: federation members (or store generations) holds one entry per
#: distinct (version, decode-map) pair under the same predicate/column
#: key; a small list avoids two members at different versions
#: thrashing a single slot.
TABLE_VARIANTS = 8


def plan_fingerprint(plan) -> Optional[Tuple]:
    """Cache key for a plan's compiled artifacts, or ``None`` when the
    plan cannot be fingerprinted (unhashable predicate literal) or has
    caching disabled.

    The fingerprint covers exactly what determines the cached
    artifacts: the key source (``range``/``scan`` bounds — point plans
    carry their keys explicitly, so only their projection/predicate
    artifacts are shared), the projection, the predicate conjunction,
    and the pushdown switch (post-hoc plans extend the decode set by
    predicate columns).  Execution knobs (morsel size, fan-out, error
    mode) are deliberately excluded: adaptive morsel resizing or
    switching to ``on_error='partial')`` must not bust the cache.
    """
    if not plan.cache:
        return None
    if plan.kind == "point":
        source: Tuple = ("point",)
    elif plan.kind == "range":
        source = ("range", int(plan.lo), int(plan.hi))
    else:
        source = ("scan",)
    fp = source + (
        plan.columns,
        plan.predicates,
        plan.pushdown,
        plan.group_by,
        plan.aggregates,
    )
    # ``plan.join`` is deliberately excluded: the cached artifacts (key
    # stream, resolved projection, code tables) describe the LEFT side
    # only — the right store answers probes through its own hooks, so a
    # plan with and without a join shares its compiled left half.
    try:
        hash(fp)
    except TypeError:  # unhashable predicate literal — skip the cache
        return None
    return fp


class _PlanEntry:
    """One cached plan's artifacts (``keys`` is ``None`` for point
    plans — their key stream arrives with the plan)."""

    __slots__ = ("version", "keys", "columns")

    def __init__(self, version, keys: Optional[np.ndarray], columns):
        self.version = version
        self.keys = keys
        self.columns = columns


class PlanCache:
    """Bounded per-store memo of plan-compilation artifacts.

    Three memo surfaces:

    * :meth:`get`/:meth:`put` — plan-level artifacts (key-source
      materialization, resolved projection subset), LRU-bounded;
    * :meth:`pred_table` — predicate -> boolean code table over a
      column's decode map (the DeepMapping pushdown compile);
    * :attr:`hits`/:attr:`misses`/:attr:`bypass` — cache telemetry
      (the benchmark's warm-vs-cold evidence), mirrored into the
      metrics registry as ``deepmap_plan_cache_events_total{outcome}``.

    Every entry records the store's mutation version at compute time
    and is dropped on mismatch, so stale artifacts are structurally
    unreachable.

    All state mutations are guarded by one lock: the sharded and
    federated stores' collect halves run on ``LazyFanoutPool`` threads,
    so concurrent ``get``/``put``/``pred_table`` calls on a single
    store's cache are routine, not exotic.  The predicate code-table
    *compute* runs outside the lock (a duplicated compute under a race
    is benign; serializing ``Predicate.code_table`` is not).
    """

    def __init__(
        self,
        plan_entries: int = PLAN_ENTRIES,
        pred_tables: int = PRED_TABLES,
        key_bytes_budget: int = KEY_BYTES_BUDGET,
    ):
        """Create an empty cache with the given capacity bounds."""
        self._plan_entries = int(plan_entries)
        self._pred_tables = int(pred_tables)
        self._key_bytes_budget = int(key_bytes_budget)
        self._key_bytes = 0  # guarded-by: _lock
        self._plans: "OrderedDict[Tuple, _PlanEntry]" = OrderedDict()  # guarded-by: _lock
        # key -> list of (version, decode_map, table) variants; keys are
        # Predicate objects (filter tables) or ("agg", column) tuples
        # (aggregate value tables)
        self._tables: Dict = {}  # guarded-by: _lock
        self._lock = threading.Lock()
        self.hits = 0  # guarded-by: _lock
        self.misses = 0  # guarded-by: _lock
        self.bypass = 0  # guarded-by: _lock
        self.table_hits = 0  # guarded-by: _lock
        self.table_misses = 0  # guarded-by: _lock

    def _note(self, outcome: str) -> None:
        obs.counter(
            "deepmap_plan_cache_events_total",
            "Plan-cache lookups by outcome (hit/miss/bypass).",
        ).inc(outcome=outcome)

    # -------------------------------------------------------- plan entries
    def get(self, fingerprint: Optional[Tuple], version) -> Optional[_PlanEntry]:
        """Look up a plan entry; a version mismatch evicts and misses;
        an unfingerprintable plan (``None``) counts as a bypass."""
        if fingerprint is None:
            with self._lock:
                self.bypass += 1
            self._note("bypass")
            return None
        with self._lock:
            entry = self._plans.get(fingerprint)
            if entry is not None and entry.version != version:
                self._evict(fingerprint)
                entry = None
            if entry is None:
                self.misses += 1
            else:
                self._plans.move_to_end(fingerprint)
                self.hits += 1
        self._note("miss" if entry is None else "hit")
        return entry

    def _evict(self, fingerprint: Tuple) -> None:  # holds-lock: _lock
        entry = self._plans.pop(fingerprint)
        if entry.keys is not None:
            self._key_bytes -= int(entry.keys.nbytes)

    def put(
        self,
        fingerprint: Optional[Tuple],
        version,
        keys: Optional[np.ndarray],
        columns,
    ) -> None:
        """Insert a plan entry (LRU-evicting over BOTH the entry count
        and the key-stream byte budget — key materializations are
        O(num_rows) and must not pin unbounded memory).

        Cached key arrays are frozen (``writeable=False``) so a
        downstream consumer can never corrupt a shared stream.  A
        single key stream larger than the whole budget is not cached
        at all (columns still are).
        """
        if fingerprint is None:
            return
        nbytes = 0
        if keys is not None:
            keys = np.asarray(keys)
            keys.flags.writeable = False
            nbytes = int(keys.nbytes)
            if nbytes > self._key_bytes_budget:
                keys, nbytes = None, 0
        with self._lock:
            while self._plans and (
                len(self._plans) >= self._plan_entries
                or self._key_bytes + nbytes > self._key_bytes_budget
            ):
                self._evict(next(iter(self._plans)))
            self._key_bytes += nbytes
            self._plans[fingerprint] = _PlanEntry(version, keys, columns)

    # ----------------------------------------- predicate/aggregate tables
    def _table_memo(self, key, decode_map: np.ndarray, version, compute) -> np.ndarray:
        """Shared memo for code-indexed tables (predicate filter tables
        and aggregate value tables).

        An entry matches on the store's mutation version AND the decode
        map — by object identity first (``ValueCodec.extend`` swaps in
        a new, larger array), falling back to an ``array_equal``
        content check so a cache shared across federation members lets
        member B reuse the table member A compiled when their
        vocabularies coincide (the cross-member sharing this repo's
        federation sets up).  Up to :data:`TABLE_VARIANTS` variants per
        key accommodate members at different versions/vocabularies.
        The compute itself runs outside the lock — two racing threads
        may both build the same table (benign), but neither blocks the
        other.
        """
        with self._lock:
            variants = self._tables.get(key, ())
            for entry in variants:
                if entry[0] == version and (
                    entry[1] is decode_map
                    or (
                        entry[1].dtype == decode_map.dtype
                        and np.array_equal(entry[1], decode_map)
                    )
                ):
                    self.table_hits += 1
                    return entry[2]
            self.table_misses += 1
        table = compute()
        with self._lock:
            if sum(len(v) for v in self._tables.values()) >= self._pred_tables:
                self._tables.clear()
            variants = self._tables.setdefault(key, [])
            if len(variants) >= TABLE_VARIANTS:
                del variants[0]
            variants.append((version, decode_map, table))
        return table

    def pred_table(self, pred, decode_map: np.ndarray, version) -> np.ndarray:
        """Memoized boolean code table for one predicate over
        ``decode_map`` (see ``Predicate.code_table``); version- and
        decode-map-fenced through :meth:`_table_memo`.  Unhashable
        predicate literals compute uncached."""
        try:
            hash(pred)
        except TypeError:  # unhashable literal (e.g. an array) — skip memo
            return pred.code_table(decode_map)
        return self._table_memo(
            pred, decode_map, version, lambda: pred.code_table(decode_map)
        )

    def agg_table(self, column: str, decode_map: np.ndarray, version) -> np.ndarray:
        """Memoized code→value table for ``sum``/``min``/``max`` below
        decode (see :func:`~repro_torch.api.plan.agg_value_table`): the
        column's decode map cast once to the accumulator dtype, fenced
        exactly like the predicate tables."""
        from repro_torch.api.plan import agg_value_table

        return self._table_memo(
            ("agg", column),
            decode_map,
            version,
            lambda: agg_value_table(column, decode_map),
        )

    # ------------------------------------------------------------- control
    def clear(self) -> None:
        """Drop every cached artifact (the benchmark's cold path)."""
        with self._lock:
            self._plans.clear()
            self._tables.clear()
            self._key_bytes = 0

    def __len__(self) -> int:
        """Number of live plan entries (predicate tables excluded)."""
        with self._lock:
            return len(self._plans)
