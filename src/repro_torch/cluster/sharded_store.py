"""``ShardedDeepMappingStore`` — a fleet of per-partition DeepMapping
stores behind one ``DeepMappingStore``-shaped facade.

The port of ``repro.cluster.sharded_store``.  Every shard of a fleet
lives on one device, resolved by
:func:`~repro_torch.device.resolve_device` (CUDA unless ``device=``
says otherwise); build and retrain train the shards in a thread pool,
so the kernels launch from several host threads at once.  The manifest
is written by the port's own msgpack codec, field for field and byte
for byte as the reference writes it, so a cluster saved by either
package opens in the other.

Mesh scatter (``repro.cluster.mesh_scatter``, ROADMAP item M11) is not
ported: with fewer than two devices the reference declines it too
(``MeshShardRunner.maybe_build`` returns ``None``), so every batch here
takes the per-shard dispatch the reference takes on one device, and
the plan evidence reads ``fanout`` or ``serial``.

Rationale (ROADMAP north star; RMI's tree-of-models; NeurStore's
many-small-models storage): K small memorization MLPs each owning a
key partition build faster (parallel, independent training), retrain
locally (only dirty shards pay Algorithm-3/4/5 debt), and bound lookup
tail latency (each shard's aux table and bitvector stay small).

Invariants the router relies on:

* routing is a pure function of the key — a key's owning shard never
  changes between build and retrain (the partitioner is immutable);
* every key belongs to exactly ONE shard, so scatter/gather is a
  permutation and `(values, exists)` match a single store built on the
  same table (NULL rows carry per-shard placeholder values — callers
  must respect the ``exists`` mask, same contract as the single store);
* all shards charge decompressed partitions to one shared
  :class:`~repro_torch.storage.pool.MemoryPool`, so cluster memory pressure
  is bounded globally, not per shard.

On-disk layout (atomic tmp+rename, shards reuse ``core/serialize.py``):

    cluster/
      manifest.msgpack   — version, partitioner state, shard dirs,
                           per-shard counters
      shard_00000/       — one ``core.serialize`` store directory
      shard_00001/
      ...
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.api.plan import ExplainStats, merge_agg_states
from repro_torch.api.protocol import MappingStore
from repro_torch.api.routing import LazyFanoutPool
from repro_torch.cluster.partitioner import Partitioner, make_partitioner
from repro_torch.cluster.router import ShardRouter
from repro_torch.core.hybrid import DeepMappingConfig, DeepMappingStore
from repro_torch.core.inference import EngineCache
from repro_torch.core.serialize import (
    clean_stale_tmp,
    fsync_dir,
    load_store,
    pack_meta,
    read_artifact,
    save_store,
    unpack_meta,
)
from repro_torch.core.table import Table
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.fault import injection as fault_injection
from repro_torch.fault.errors import IntegrityError, OwnerFailure
from repro_torch.fault.retry import DEFAULT_POLICY, RetryPolicy, call_guarded
from repro_torch.storage import MemoryPool

#: v2 wraps the manifest in a crc32 envelope and records per-shard
#: columns/rows so quarantined shards keep the facade's accounting
#: coherent; v1 manifests still load (no verification, no quarantine
#: metadata).
MANIFEST_VERSION = 2


@dataclasses.dataclass
class _PendingShardedLookup:
    """Scattered lookup in flight: every shard's device inference is
    already enqueued (serial dispatch is cheap); collection gathers
    per-shard host halves, in parallel under fan-out."""

    keys: np.ndarray
    batches: list
    handles: list          # parallel to batches; (False, exc) on a
                           # dispatch-time failure (retried at collect)
    route_s: float
    use_fanout: bool
    columns: Optional[Tuple[str, ...]]
    predicates: tuple = ()
    keys_exist: bool = False
    on_error: str = "raise"


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    """Cluster-level knobs (per-shard knobs stay in DeepMappingConfig)."""

    num_shards: int = 4
    policy: str = "range"          # "range" (planner-balanced) | "hash"
    seed: int = 0                  # hash-policy mixing seed
    max_workers: Optional[int] = None  # build/retrain thread pool size
    #: The reference's switch for scattering device inference across a
    #: multi-device mesh, kept for parity: the port has no mesh scatter
    #: yet (ROADMAP item M11), which the reference declines on one
    #: device too, so nothing here reads it and either value serves
    #: every batch through the per-shard dispatch.
    mesh_scatter: bool = True


class _QuarantinedIndex:
    """Existence-index shim for a quarantined shard: every consult
    refuses loudly (scans/mutations must not silently skip the shard's
    keys)."""

    def __init__(self, owner: "QuarantinedShard"):
        self._owner = owner

    def keys_in_range(self, lo, hi):
        raise self._owner.refusal()

    def test(self, keys):
        raise self._owner.refusal()


class _QuarantinedAux:
    """Aux-table shim: zero rows, so fleet accounting stays additive."""

    num_rows = 0


class _QuarantinedSpec:
    """Spec shim carrying the column names recorded in the manifest."""

    def __init__(self, tasks: Tuple[str, ...]):
        self.tasks = tasks


class QuarantinedShard:
    """Placeholder for a shard whose on-disk artifacts failed checksum
    verification at load (``load_sharded_store(..., on_corrupt=
    'quarantine')``).

    The cluster facade stays serviceable over the healthy K-1 shards:
    point lookups routed here fail as a structured owner failure —
    degradable via ``Query.on_error('partial')`` — while scans and
    mutations touching this shard's key range raise
    :class:`~repro_torch.fault.errors.IntegrityError` loudly (a scan that
    silently dropped a shard's rows would be a wrong answer, not a
    degraded one).  Accounting (rows from the manifest, zero bytes)
    keeps fleet totals coherent; re-saving a cluster holding one of
    these refuses, so a corrupt shard can never be laundered back to
    disk as healthy."""

    def __init__(
        self,
        shard_id: int,
        reason: str,
        columns: Tuple[str, ...] = (),
        num_rows: int = 0,
    ):
        self.shard_id = int(shard_id)
        self.reason = str(reason)
        self.spec = _QuarantinedSpec(tuple(columns))
        self.num_rows = int(num_rows)
        self.raw_bytes = 0
        self.modified_bytes = 0
        self.vexist = _QuarantinedIndex(self)
        self.aux = _QuarantinedAux()

    def refusal(self) -> IntegrityError:
        return IntegrityError(
            f"shard {self.shard_id} is quarantined (corrupt at load: "
            f"{self.reason}); restore it from a replica or rebuild, or "
            f"use Query.on_error('partial') for point lookups over the "
            f"healthy shards"
        )

    # Protocol surface: every data path refuses with the same evidence.
    def _dispatch_lookup(self, keys, columns=None, **kwargs):
        raise self.refusal()

    def _collect_lookup(self, pending):
        raise self.refusal()

    def insert(self, keys, columns):
        raise self.refusal()

    def delete(self, keys):
        raise self.refusal()

    def update(self, keys, columns):
        raise self.refusal()

    def retrain(self, verbose: bool = False):
        raise self.refusal()

    def materialize(self):
        raise self.refusal()

    # Accounting/bookkeeping surface the facade aggregates over.
    def mutation_version(self) -> int:
        return 0

    def should_retrain(self) -> bool:
        return False

    def size_breakdown(self) -> Dict[str, int]:
        return {}


class ShardedDeepMappingStore(MappingStore):
    """K independent :class:`DeepMappingStore` shards behind a router.

    Conforms to the :class:`~repro_torch.api.protocol.MappingStore` protocol —
    drop-in for the single store everywhere the serving layer cares.
    Plan execution (``store.query()``) fans per-shard lookups out on a
    thread pool so scatter/gather overlaps per-shard inference; the
    legacy ``lookup`` shim stays serial for bit-for-bit continuity.
    """

    def __init__(
        self,
        partitioner: Partitioner,
        shards: List[DeepMappingStore],
        cluster: ClusterConfig,
        pool: MemoryPool,
        retry: RetryPolicy = DEFAULT_POLICY,
    ):
        if partitioner.num_shards != len(shards):
            raise ValueError(
                f"partitioner maps to {partitioner.num_shards} shards, "
                f"got {len(shards)} stores"
            )
        self.partitioner = partitioner
        self.router = ShardRouter(partitioner)
        self.shards = shards
        self.cluster = cluster
        self.pool = pool
        self.retry = retry
        self._fanout = LazyFanoutPool(cluster.max_workers, "shard-lookup")
        # One engine cache for the fleet: shard engines share a single
        # EngineStats, so identical (architecture, bucket) signatures
        # count as ONE compile cluster-wide and operators read one
        # counter set.  Shards warm from build keep their weight caches.
        self.engines = EngineCache()
        for s in shards:
            if not isinstance(s, QuarantinedShard):
                self.engines.adopt(s)

    # ------------------------------------------------------------------ build
    @classmethod
    def build(
        cls,
        table: Table,
        config: DeepMappingConfig = DeepMappingConfig(),
        cluster: ClusterConfig = ClusterConfig(),
        pool: Optional[MemoryPool] = None,
        verbose: bool = False,
        device: DeviceLike = None,
    ) -> "ShardedDeepMappingStore":
        """Partition ``table`` and train every shard (thread pool), every
        shard on ``device`` (CUDA by default).

        The planner may return fewer than ``cluster.num_shards`` shards
        on tiny/degenerate tables (quantile boundaries collapse); hash
        partitioning of a small table raises if a shard would be empty
        — lower ``num_shards`` or use the range policy there.
        """
        dev = resolve_device(device)
        partitioner = make_partitioner(
            cluster.policy, table.keys, cluster.num_shards, seed=cluster.seed
        )
        pool = pool if pool is not None else MemoryPool(1 << 30)
        router = ShardRouter(partitioner)
        batches = {b.shard_id: b for b in router.scatter(table.keys)}
        missing = [i for i in range(partitioner.num_shards) if i not in batches]
        if missing:
            raise ValueError(
                f"shards {missing} would be empty; lower num_shards or "
                f"use the 'range' policy (planner guarantees non-empty)"
            )
        sub_tables = [
            table.take(batches[i].positions) for i in range(partitioner.num_shards)
        ]

        def build_one(i: int) -> DeepMappingStore:
            return DeepMappingStore.build(
                sub_tables[i], config, pool=pool, verbose=False, device=dev
            )

        with ThreadPoolExecutor(max_workers=cluster.max_workers) as ex:
            shards = list(ex.map(build_one, range(partitioner.num_shards)))
        store = cls(partitioner, shards, cluster, pool)
        if verbose:
            rows = [s.num_rows for s in shards]
            print(
                f"[cluster] built {len(shards)} {cluster.policy} shards, "
                f"rows/shard min={min(rows)} max={max(rows)}, "
                f"ratio {store.compression_ratio():.4f}"
            )
        return store

    # ---------------------------------------------------------------- lookup
    @property
    def columns(self) -> Tuple[str, ...]:
        return self._healthy_shard().spec.tasks

    def _healthy_shard(self):
        """First non-quarantined shard (delegation target for typed
        zero-batch probes and column metadata)."""
        for s in self.shards:
            if not isinstance(s, QuarantinedShard):
                return s
        return self.shards[0]

    def quarantined_shards(self) -> List[int]:
        """Shard ids refused at load for failing checksum verification."""
        return [
            i for i, s in enumerate(self.shards)
            if isinstance(s, QuarantinedShard)
        ]

    def _dispatch_lookup(
        self,
        keys: np.ndarray,
        columns: Optional[Tuple[str, ...]] = None,
        fanout: Optional[bool] = None,
        predicates: tuple = (),
        keys_exist: bool = False,
        on_error: str = "raise",
    ) -> _PendingShardedLookup:
        """Scatter the batch and enqueue every shard's device inference
        (cheap serial dispatch — the device work itself overlaps);
        ``_collect_lookup`` gathers the host halves.  ``predicates``
        push down into every shard (code-level argmax filtering), so a
        scattered predicate plan never decodes a non-matching row on
        any shard; ``keys_exist`` forwards to every shard.

        A shard whose dispatch itself raises (a dying device engine)
        does not kill the plan here: the failure is captured in the
        handle slot and retried — then degraded around or surfaced as
        :class:`OwnerFailure`, per ``on_error`` — at collect time."""
        keys = np.asarray(keys, dtype=np.int64)
        t0 = time.perf_counter()
        batches = self.router.scatter(keys)
        route_s = time.perf_counter() - t0
        use_fanout = bool(fanout) and len(batches) > 1
        handles = []
        for b in batches:
            try:
                handles.append((True, self.shards[b.shard_id]._dispatch_lookup(
                    b.keys, columns, predicates=predicates,
                    keys_exist=keys_exist,
                )))
            except Exception as exc:  # captured; retried at collect
                handles.append((False, exc))
        return _PendingShardedLookup(
            keys=keys, batches=batches, handles=handles, route_s=route_s,
            use_fanout=use_fanout, columns=columns, predicates=predicates,
            keys_exist=keys_exist, on_error=on_error,
        )

    def _collect_lookup(
        self, pending: _PendingShardedLookup
    ) -> Tuple[Dict[str, np.ndarray], np.ndarray, Optional[np.ndarray], ExplainStats]:
        keys, batches = pending.keys, pending.batches
        route_s, use_fanout = pending.route_s, pending.use_fanout
        preds = pending.predicates
        if not batches:
            # Zero-length request: delegate to one healthy shard for
            # typed empty columns + per-head stats (no scatter, no
            # inference).
            probe_shard = self._healthy_shard()
            values, exists, match, stats = probe_shard._collect_lookup(
                probe_shard._dispatch_lookup(
                    keys[:0], pending.columns, predicates=preds
                )
            )
            stats.plan = ("scatter[0]",) + stats.plan
            stats.route_s += route_s
            exists = np.zeros(keys.shape[0], dtype=bool)
            return values, exists, exists.copy() if preds else None, stats

        def visit(batch_handle):
            batch, (ok, payload) = batch_handle
            shard = self.shards[batch.shard_id]
            owner = f"shard:{batch.shard_id}"

            def attempt(i: int):
                # Injection site sits inside the guarded attempt so a
                # `times=1` spec fails attempt 0 and the retry recovers.
                fault_injection.maybe_fail("shard_collect", owner)
                if i == 0:
                    if not ok:
                        raise payload  # dispatch-time failure = try 0
                    handle = payload
                else:
                    # The first try consumed (part of) the dispatched
                    # handle; retries re-dispatch fresh.
                    handle = shard._dispatch_lookup(
                        batch.keys, pending.columns,
                        predicates=preds, keys_exist=pending.keys_exist,
                    )
                return shard._collect_lookup(handle)

            t0 = time.perf_counter()
            outcome = call_guarded(
                attempt, owner=owner, site="shard_collect", policy=self.retry
            )
            t1 = time.perf_counter()
            # Per-shard telemetry, labeled by shard id — emitted from
            # the fan-out pool threads, which is exactly why the
            # registry (and PlanCache) increments are locked.
            reg = obs.registry()
            reg.counter(
                "deepmap_shard_visits_total", "Lookup batches per shard."
            ).inc(shard=batch.shard_id)
            if not outcome.ok:
                return batch, None, None, None, None, outcome
            reg.counter(
                "deepmap_shard_keys_total", "Keys answered per shard."
            ).inc(int(batch.keys.shape[0]), shard=batch.shard_id)
            reg.histogram(
                "deepmap_shard_collect_seconds",
                "Per-shard collect (host-half) latency.",
            ).observe(t1 - t0, shard=batch.shard_id)
            obs.tracer().add_span(
                "shard_collect", t0, t1, track="shards",
                shard=batch.shard_id, rows=int(batch.keys.shape[0]),
            )
            vals, exists, match, stats = outcome.value
            return batch, vals, exists, match, stats, outcome

        pairs = list(zip(batches, pending.handles))
        if use_fanout:
            parts = self._fanout.map(visit, pairs, owners=len(self.shards))
        else:
            parts = [visit(p) for p in pairs]

        healthy = [p for p in parts if p[5].ok]
        errors = tuple(p[5].error for p in parts if not p[5].ok)
        if errors and (pending.on_error != "partial" or not healthy):
            # 'raise' mode, or nothing survived to degrade to — either
            # way the structured owner evidence rides on the exception.
            raise OwnerFailure(errors)

        agg = ExplainStats(
            shards_visited=len(batches),
            shard_ids=tuple(int(b.shard_id) for b in batches),
            async_fanout=use_fanout,
            route_s=route_s,
            retries=sum(p[5].retries for p in parts),
            owners_failed=tuple(e.describe() for e in errors),
            keys_unresolved=sum(
                int(p[0].keys.shape[0]) for p in parts if not p[5].ok
            ),
        )
        for p in healthy:
            # merge_timings unions the pushdown evidence tuples, so a
            # shard that skipped different heads/columns than its peers
            # cannot make the aggregate under-report.
            agg.merge_timings(p[4])
        agg.plan = (
            f"scatter[{len(batches)} shards]",
            "fanout" if use_fanout else "serial",
        ) + healthy[0][4].plan

        t1 = time.perf_counter()
        if errors:
            values, exists, _covered = ShardRouter.gather_partial(
                keys.shape[0], [(b, v, e) for b, v, e, _, _, _ in healthy]
            )
        else:
            values, exists = ShardRouter.gather(
                keys.shape[0], [(b, v, e) for b, v, e, _, _, _ in healthy]
            )
        match = None
        if preds:
            # Failed shards' positions stay False: unreachable rows are
            # excluded from filtered results (evidence keeps the count).
            match = np.zeros(keys.shape[0], dtype=bool)
            for b, _, _, m, _, _ in healthy:
                match[b.positions] = m
        agg.route_s += time.perf_counter() - t1
        return values, exists, match, agg

    def _collect_aggregate(self, pending: _PendingShardedLookup, group_by, aggregates):
        """Scattered ``group_by(...).agg(...)``: every shard folds its
        batch in code space (:meth:`DeepMappingStore._collect_aggregate`
        — zero rows decoded), and the facade merges the per-shard
        partial states.  States key on decoded group values, so shards
        with independent codecs (codes are NOT comparable across
        shards) merge exactly.  Failed shards degrade under
        ``on_error='partial'`` with the usual ``owners_failed``/
        ``keys_unresolved`` evidence — their batches' rows are simply
        absent from every group."""
        keys, batches = pending.keys, pending.batches
        route_s, use_fanout = pending.route_s, pending.use_fanout
        preds = pending.predicates
        if not batches:
            probe_shard = self._healthy_shard()
            state, stats = probe_shard._collect_aggregate(
                probe_shard._dispatch_lookup(
                    keys[:0], pending.columns, predicates=preds
                ),
                group_by, aggregates,
            )
            stats.plan = ("scatter[0]",) + stats.plan
            stats.route_s += route_s
            return state, stats

        def visit(batch_handle):
            batch, (ok, payload) = batch_handle
            shard = self.shards[batch.shard_id]
            owner = f"shard:{batch.shard_id}"

            def attempt(i: int):
                fault_injection.maybe_fail("shard_collect", owner)
                if i == 0:
                    if not ok:
                        raise payload  # dispatch-time failure = try 0
                    handle = payload
                else:
                    handle = shard._dispatch_lookup(
                        batch.keys, pending.columns,
                        predicates=preds, keys_exist=pending.keys_exist,
                    )
                return shard._collect_aggregate(handle, group_by, aggregates)

            outcome = call_guarded(
                attempt, owner=owner, site="shard_collect", policy=self.retry
            )
            obs.registry().counter(
                "deepmap_shard_visits_total", "Lookup batches per shard."
            ).inc(shard=batch.shard_id)
            if not outcome.ok:
                return batch, None, None, outcome
            state, stats = outcome.value
            return batch, state, stats, outcome

        pairs = list(zip(batches, pending.handles))
        if use_fanout:
            parts = self._fanout.map(visit, pairs, owners=len(self.shards))
        else:
            parts = [visit(p) for p in pairs]

        healthy = [p for p in parts if p[3].ok]
        errors = tuple(p[3].error for p in parts if not p[3].ok)
        if errors and (pending.on_error != "partial" or not healthy):
            raise OwnerFailure(errors)

        agg = ExplainStats(
            shards_visited=len(batches),
            shard_ids=tuple(int(b.shard_id) for b in batches),
            async_fanout=use_fanout,
            route_s=route_s,
            retries=sum(p[3].retries for p in parts),
            owners_failed=tuple(e.describe() for e in errors),
            keys_unresolved=sum(
                int(p[0].keys.shape[0]) for p in parts if not p[3].ok
            ),
        )
        state: Dict[tuple, list] = {}
        for p in healthy:
            agg.merge_timings(p[2])
            merge_agg_states(state, p[1], aggregates)
        agg.plan = (
            f"scatter[{len(batches)} shards]",
            "fanout" if use_fanout else "serial",
        ) + healthy[0][2].plan
        return state, agg

    def _lookup_with_stats(
        self,
        keys: np.ndarray,
        columns: Optional[Tuple[str, ...]] = None,
        fanout: Optional[bool] = None,
    ) -> Tuple[Dict[str, np.ndarray], np.ndarray, ExplainStats]:
        """Algorithm 1, scattered: route each key to its shard, answer
        per-shard batches (in parallel when ``fanout``), gather results
        back in request order — the dispatch/collect pair back-to-back."""
        values, exists, _, stats = self._collect_lookup(
            self._dispatch_lookup(keys, columns, fanout)
        )
        return values, exists, stats

    def lookup(
        self, keys: np.ndarray, columns: Optional[Tuple[str, ...]] = None
    ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
        """Legacy serial shim (prefer ``store.query()``, whose executor
        fans out and returns per-plan ``ExplainStats``)."""
        values, exists, _stats = self._lookup_with_stats(keys, columns, fanout=False)
        return values, exists

    def _range_keys(self, lo: int, hi: Optional[int]) -> np.ndarray:
        """Range scatter (§IV-E): only shards whose ranges overlap
        ``[lo, hi)`` scan their existence index (all shards under hash
        partitioning), in parallel on the fan-out pool; merged
        ascending.  ``hi=None`` scans all shards unbounded (the scan
        plan's key source)."""
        if hi is None:
            sids: List[int] = list(range(len(self.shards)))
        else:
            sids = [int(s) for s in self.partitioner.shards_for_range(int(lo), int(hi))]

        def scan_one(s: int) -> np.ndarray:
            return self.shards[s].vexist.keys_in_range(lo, hi)

        if len(sids) > 1:
            parts = self._fanout.map(scan_one, sids, owners=len(self.shards))
        else:
            parts = [scan_one(s) for s in sids]
        parts = [p for p in parts if p.size]
        if not parts:
            return np.zeros(0, dtype=np.int64)
        merged = np.concatenate(parts)
        if self.partitioner.policy != "range":
            # Range shards are disjoint and visited in key order, so
            # their concatenation is already ascending; hash shards
            # interleave the domain and need the sort.
            merged = np.sort(merged, kind="stable")
        return merged

    # ------------------------------------------------ modifications (Alg 3-5)
    def insert(self, keys: np.ndarray, columns: Dict[str, np.ndarray]) -> None:
        """Algorithm 3 per shard.  Validates against ALL shards before
        mutating ANY, so a duplicate key cannot leave the cluster
        half-inserted."""
        keys = np.asarray(keys, dtype=np.int64)
        if np.unique(keys).size != keys.size:
            # Checked at the facade: a per-shard duplicate raise could
            # otherwise leave earlier shards mutated.
            raise ValueError("duplicate keys in insert batch")
        batches = self.router.scatter(keys)
        for b in batches:
            if self.shards[b.shard_id].vexist.test(b.keys).any():
                raise ValueError("insert of existing key; use update()")
        for b in batches:
            self.shards[b.shard_id].insert(
                b.keys, ShardRouter.take_columns(columns, b.positions)
            )
        self._note_mutation()

    def delete(self, keys: np.ndarray) -> None:
        """Algorithm 4 per shard (idempotent, like the single store)."""
        keys = np.asarray(keys, dtype=np.int64)
        for b in self.router.scatter(keys):
            self.shards[b.shard_id].delete(b.keys)
        self._note_mutation()

    def update(self, keys: np.ndarray, columns: Dict[str, np.ndarray]) -> None:
        """Algorithm 5 per shard; all-exist validated before mutating."""
        keys = np.asarray(keys, dtype=np.int64)
        batches = self.router.scatter(keys)
        for b in batches:
            if not self.shards[b.shard_id].vexist.test(b.keys).all():
                raise ValueError("update of non-existing key; use insert()")
        for b in batches:
            self.shards[b.shard_id].update(
                b.keys, ShardRouter.take_columns(columns, b.positions)
            )
        self._note_mutation()

    def mutation_version(self):
        """Facade counter + per-shard tokens: direct mutations of a
        shard (bypassing the facade) still invalidate cached plans, and
        the facade bump on :meth:`retrain` keeps a rebuilt shard's
        reset counter from colliding with an earlier cluster state."""
        return (
            getattr(self, "_mutation_version", 0),
            tuple(s.mutation_version() for s in self.shards),
        )

    # ------------------------------------------------------- lazy retrain
    def dirty_shards(self) -> List[int]:
        """Shard ids whose modified-bytes debt crossed the threshold."""
        return [i for i, s in enumerate(self.shards) if s.should_retrain()]

    def should_retrain(self) -> bool:
        return bool(self.dirty_shards())

    def retrain(
        self, shard_ids: Optional[Sequence[int]] = None, verbose: bool = False
    ) -> List[int]:
        """Rebuild ONLY the given (default: dirty) shards, in place.

        This is the sharding payoff over the single store's whole-
        relation retrain: modification debt is paid per partition.
        Returns the retrained shard ids.
        """
        ids = list(shard_ids) if shard_ids is not None else self.dirty_shards()

        def retrain_one(i: int) -> DeepMappingStore:
            return self.shards[i].retrain(verbose=False)

        if ids:
            with ThreadPoolExecutor(max_workers=self.cluster.max_workers) as ex:
                rebuilt = list(ex.map(retrain_one, ids))
            for i, store in zip(ids, rebuilt):
                self.shards[i] = store
                self.engines.adopt(store)  # rebuilt shard joins fleet stats
            self._note_mutation()  # a fresh shard's reset counter must
            # not recreate an earlier cluster-wide version token
        if verbose:
            print(f"[cluster] retrained shards {ids}")
        return ids

    # ------------------------------------------------------------- teardown
    def close(self) -> None:
        """Release the lookup fan-out pool's threads (idempotent; the
        store remains usable — a later fan-out lazily re-creates the
        pool).  Without it, pool threads live until interpreter exit."""
        self._fanout.close()

    def __enter__(self) -> "ShardedDeepMappingStore":
        """Context-manager entry; :meth:`close` runs on exit."""
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        """Close the fan-out pool on scope exit."""
        self.close()

    # ---------------------------------------------------------- persistence
    def save(self, path: str) -> None:
        """Protocol persistence — the manifest directory-of-stores
        format (atomic tmp+rename)."""
        save_sharded_store(self, path)

    @classmethod
    def load(
        cls,
        path: str,
        pool: Optional[MemoryPool] = None,
        on_corrupt: str = "raise",
        device: DeviceLike = None,
    ) -> "ShardedDeepMappingStore":
        """Open a cluster saved by either package, every shard on
        ``device`` (see :func:`load_sharded_store`)."""
        return load_sharded_store(
            path, pool=pool, on_corrupt=on_corrupt, device=device
        )

    def materialize(self) -> Table:
        """Reconstruct the full logical table, ascending key order."""
        tables = [s.materialize() for s in self.shards]
        keys = np.concatenate([t.keys for t in tables])
        order = np.argsort(keys, kind="stable")
        columns = {
            name: np.concatenate([t.columns[name] for t in tables])[order]
            for name in tables[0].columns
        }
        return Table(keys=keys[order], columns=columns)

    # ------------------------------------------------------------- accounting
    @property
    def num_shards(self) -> int:
        return len(self.shards)

    @property
    def num_rows(self) -> int:
        return sum(s.num_rows for s in self.shards)

    @property
    def raw_bytes(self) -> int:
        return sum(s.raw_bytes for s in self.shards)

    @property
    def modified_bytes(self) -> int:
        return sum(s.modified_bytes for s in self.shards)

    def size_breakdown(self) -> Dict[str, int]:
        total: Dict[str, int] = {}
        for s in self.shards:
            for k, v in s.size_breakdown().items():
                total[k] = total.get(k, 0) + v
        return total

    def size_bytes(self) -> int:
        return sum(self.size_breakdown().values())

    def compression_ratio(self) -> float:
        return self.size_bytes() / max(1, self.raw_bytes)

    def memorized_fraction(self) -> float:
        aux_rows = sum(s.aux.num_rows for s in self.shards)
        return 1.0 - aux_rows / max(1, self.num_rows)


# ------------------------------------------------------------- serialization
def save_sharded_store(store: ShardedDeepMappingStore, path: str) -> None:
    """Directory-of-stores format: manifest + one ``core.serialize``
    directory per shard.  Atomic (tmp + rename), like the single-store
    format; the manifest is written LAST, crc32-enveloped, after every
    shard directory landed (a manifest's presence marks the save
    complete)."""
    bad = store.quarantined_shards()
    if bad:
        raise IntegrityError(
            f"refusing to save: shards {bad} are quarantined (corrupt at "
            f"load) — saving would persist placeholders as data loss"
        )
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    shard_dirs = [f"shard_{i:05d}" for i in range(store.num_shards)]
    for shard, d in zip(store.shards, shard_dirs):
        save_store(shard, os.path.join(tmp, d))

    manifest = {
        "version": MANIFEST_VERSION,
        "partitioner": store.partitioner.to_state(),
        "cluster": {
            "num_shards": store.num_shards,
            "policy": store.cluster.policy,
            "seed": store.cluster.seed,
            # governs build/retrain AND lookup fan-out pools — an
            # operator's concurrency cap must survive reload
            "max_workers": store.cluster.max_workers,
        },
        "shards": shard_dirs,
        # Quarantine metadata: lets a QuarantinedShard placeholder keep
        # the facade's columns and row accounting coherent when one
        # shard directory fails verification on a later load.
        "columns": list(store.columns),
        "shard_rows": [int(s.num_rows) for s in store.shards],
    }
    with open(os.path.join(tmp, "manifest.msgpack"), "wb") as f:
        f.write(pack_meta(manifest))
        f.flush()
        os.fsync(f.fileno())
    fsync_dir(tmp)

    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
    fsync_dir(os.path.dirname(os.path.abspath(path)))


def load_sharded_store(
    path: str,
    pool: Optional[MemoryPool] = None,
    on_corrupt: str = "raise",
    device: DeviceLike = None,
) -> ShardedDeepMappingStore:
    """Load a saved cluster, verifying every shard's checksums, every
    shard onto ``device`` (CUDA by default).

    ``on_corrupt='raise'`` (default) propagates the first shard's
    :class:`~repro_torch.fault.errors.IntegrityError`; ``'quarantine'``
    replaces corrupt shards with :class:`QuarantinedShard` placeholders
    — the healthy K-1 shards keep serving (point lookups degrade via
    ``Query.on_error('partial')``), each quarantine warns and counts
    into ``deepmap_fault_quarantines_total`` — and still raises when
    EVERY shard is corrupt (nothing left to serve)."""
    if on_corrupt not in ("raise", "quarantine"):
        raise ValueError(
            f"on_corrupt must be 'raise' or 'quarantine', got {on_corrupt!r}"
        )
    clean_stale_tmp(path)
    manifest = unpack_meta(
        read_artifact(path, "manifest.msgpack", None),
        os.path.join(path, "manifest.msgpack"),
    )
    if manifest["version"] > MANIFEST_VERSION:
        raise ValueError(f"cluster manifest {manifest['version']} newer than reader")
    dev = resolve_device(device)
    pool = pool if pool is not None else MemoryPool(1 << 30)
    partitioner = Partitioner.from_state(manifest["partitioner"])
    columns = tuple(manifest.get("columns", ()))
    shard_dirs = manifest["shards"]
    shard_rows = manifest.get("shard_rows", [0] * len(shard_dirs))
    shards: List[DeepMappingStore] = []
    corrupt = 0
    for i, d in enumerate(shard_dirs):
        try:
            shards.append(load_store(os.path.join(path, d), pool=pool, device=dev))
        except (IntegrityError, OSError, ValueError, KeyError) as err:
            if on_corrupt != "quarantine":
                raise
            corrupt += 1
            warnings.warn(
                f"quarantining shard {i} ({os.path.join(path, d)}): {err}",
                RuntimeWarning,
                stacklevel=2,
            )
            owner = f"shard:{i}"  # bounded by the manifest's shard count
            obs.registry().counter(
                "deepmap_fault_quarantines_total",
                "Owners quarantined (consecutive failures, or corrupt "
                "artifacts at load).",
            ).inc(owner=owner)
            shards.append(
                QuarantinedShard(
                    i, str(err), columns=columns, num_rows=int(shard_rows[i])
                )
            )
    if corrupt and corrupt == len(shard_dirs):
        raise IntegrityError(
            f"every shard of {path!r} failed verification; nothing to serve"
        )
    cluster = ClusterConfig(
        num_shards=manifest["cluster"]["num_shards"],
        policy=manifest["cluster"]["policy"],
        seed=manifest["cluster"]["seed"],
        # .get: PR-1-era manifests predate the field
        max_workers=manifest["cluster"].get("max_workers"),
    )
    return ShardedDeepMappingStore(partitioner, shards, cluster, pool)
