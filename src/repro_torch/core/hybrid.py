"""The DeepMapping hybrid structure ``M̂ = ⟨M, T_aux, V_exist, f_decode⟩``
(paper §IV) with Algorithm 1 lookup and Algorithm 3/4/5 modifications —
the port of ``repro.core.hybrid``.

A :class:`DeepMappingStore` owns:

* ``params``/``spec``  — the multi-task memorization MLP ``M`` (tensors
                         on the store's device);
* ``aux``              — :class:`~repro_torch.core.aux_table.AuxTable` (``T_aux``);
* ``vexist``           — :class:`~repro_torch.core.bitvector.BitVector`;
* ``codecs``           — per-column :class:`~repro_torch.core.encoding.ValueCodec`
                         (``f_decode``);
* ``encoder``          — digit featurizer for keys.

Eq. 1 of the paper is :meth:`compression_ratio`.  A store is built by
training a model on the table, or from given weights (``spec`` +
``params``), or loaded from the reference's v2 directory layout
(:meth:`DeepMappingStore.load`, ``repro_torch.open``).  It is a
:class:`~repro_torch.api.protocol.MappingStore`: ``store.query()`` plans
run through the streaming executor, and a ``where`` conjunction ships
its predicate code tables into the fused lookup kernel (K1), which
returns a match bit per key.

Modification semantics follow the paper exactly: inserts/updates/deletes
are materialized in the auxiliary structures without touching ``M``;
:meth:`should_retrain` triggers lazily once modified bytes exceed a
threshold.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.api.plan import ExplainStats, agg_partials, fold_agg_partials
from repro_torch.api.protocol import MappingStore
from repro_torch.core import model as model_lib
from repro_torch.core import trainer as trainer_lib
from repro_torch.core.aux_table import AuxTable
from repro_torch.core.bitvector import BitVector
from repro_torch.core.encoding import KeyEncoder, ValueCodec, build_codecs
from repro_torch.core.inference import InferenceEngine
from repro_torch.core.model import MLPSpec
from repro_torch.core.table import Table
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.ref import MAX_PREDS
from repro_torch.storage import MemoryPool


@dataclasses.dataclass(frozen=True)
class DeepMappingConfig:
    """Build-time knobs. ``shared``/``private`` give the default manual
    architecture."""

    base: int = 10
    # Beyond-paper: residue feature positions (multi-digit key % r).
    residues: Tuple[int, ...] = ()
    auto_residues: bool = False   # detect per-column periods at build
    shared: Tuple[int, ...] = (256, 256)
    private: Tuple[int, ...] = (64,)
    codec: str = "zstd"                    # DM-Z; "lzma" = DM-L
    partition_bytes: int = 128 * 1024
    dtype: str = "float32"
    train: trainer_lib.TrainConfig = dataclasses.field(
        default_factory=trainer_lib.TrainConfig
    )
    # Retrain once this many raw bytes have been inserted/deleted/updated
    # (paper's DM-Z1 uses 200 MB). None disables auto-trigger.
    retrain_after_modified_bytes: Optional[int] = None
    inference_batch: int = 1 << 16
    # Route inference through the fused CUDA kernels — the counterpart
    # of the reference's ``use_pallas``.  The SAME engine evaluates
    # build-time misclassification and serves lookups, so T_aux always
    # corrects exactly the deployed model.  False takes the plain
    # ``jit_*`` tiers, as the reference does with ``use_pallas=False``.
    use_kernels: bool = True


#: Device chunks in flight ahead of the host half.  Bounds device
#: residency for huge scan/range batches (the window slides forward as
#: chunks are collected) while still double-buffering the pipeline.
DISPATCH_WINDOW = 2


@dataclasses.dataclass
class _PendingLookup:
    """Handle returned by ``_dispatch_lookup``: device inference for the
    first ``DISPATCH_WINDOW`` chunks is enqueued; the host half
    (existence fallback, aux merge, decode) runs at ``_collect_lookup``
    time, which tops the window up as it drains."""

    keys: np.ndarray
    wanted: Tuple[str, ...]            # heads to evaluate (selected + predicate)
    decode: Tuple[str, ...]            # columns to decode (selected only)
    skipped: Tuple[str, ...]
    preds: tuple                       # [(wanted idx, code table, describe), ...]
    tickets: list                      # [(start, InferTicket), ...] in flight
    next_start: int                    # first key offset not yet dispatched
    dispatch_s: float
    #: ((column, bool code table), ...) shipped to the engine so the
    #: fused kernel evaluates the predicate conjunction in-kernel: one
    #: table per predicate column (its predicates ANDed), none when the
    #: columns outnumber the kernel's ``MAX_PREDS`` slots.
    kernel_tables: tuple = ()


class DeepMappingStore(MappingStore):
    """Hybrid learned KV store for one relation (single packed key)."""

    def __init__(
        self,
        encoder: KeyEncoder,
        spec: MLPSpec,
        params: Dict,
        codecs: Dict[str, ValueCodec],
        aux: AuxTable,
        vexist: BitVector,
        raw_bytes: int,
        num_rows: int,
        config: DeepMappingConfig,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.encoder = encoder
        self.spec = spec
        self.params = model_lib._map_tree(params, lambda t: t.to(self.device))
        self.codecs = codecs
        self.aux = aux
        self.vexist = vexist
        self.raw_bytes = int(raw_bytes)
        self.num_rows = int(num_rows)
        self.config = config
        self.modified_bytes = 0
        self._bytes_per_row = raw_bytes / max(1, num_rows)
        # Lazy — build() attaches the warm engine it evaluated T_aux with.
        self._engine: Optional[InferenceEngine] = None

    @property
    def engine(self) -> InferenceEngine:
        if self._engine is None:
            self._engine = InferenceEngine.for_store(self)
        return self._engine

    def attach_engine(self, engine: InferenceEngine) -> None:
        """Adopt an externally built engine; its bitvector binding (and
        device word cache) is refreshed to this store's."""
        engine.bind_vexist(self.vexist)
        self._engine = engine

    # ------------------------------------------------------------------ build
    @classmethod
    def build(
        cls,
        table: Table,
        config: DeepMappingConfig = DeepMappingConfig(),
        pool: Optional[MemoryPool] = None,
        spec: Optional[MLPSpec] = None,
        params: Optional[Dict] = None,
        verbose: bool = False,
        device: DeviceLike = None,
    ) -> "DeepMappingStore":
        """Train (or accept) a mapping model and assemble the hybrid, on
        ``device``.

        Passing ``spec``+``params`` (a params tree of tensors or numpy
        arrays in the reference layout) skips training; ``spec`` alone
        trains that architecture."""
        dev = resolve_device(device)
        residues = config.residues
        if config.auto_residues:
            from repro_torch.core.encoding import detect_residues

            residues = tuple(sorted(set(residues) | set(
                detect_residues(table.keys, table.columns, config.base)
            )))
            if verbose and residues:
                print(f"[build] auto-detected residue periods: {residues}")
        encoder = KeyEncoder(table.max_key, base=config.base, residues=residues)
        codecs = build_codecs(table.columns)
        if spec is None:
            spec = MLPSpec(
                base=config.base,
                width=encoder.width,
                shared=tuple(config.shared),
                private={n: tuple(config.private) for n in table.columns},
                out_cards={n: codecs[n].cardinality for n in table.columns},
                dtype=config.dtype,
            )
        elif spec.width != encoder.width or spec.base != encoder.base:
            raise ValueError(
                f"spec (base {spec.base}, width {spec.width}) does not match the "
                f"table's key encoder (base {encoder.base}, width {encoder.width})"
            )
        codes = np.stack([codecs[t].codes for t in spec.tasks], axis=1)
        if params is None:
            params, _, hist = trainer_lib.train(
                spec, encoder.digits(table.keys), codes, config.train, device=dev
            )
            if verbose:
                print(f"[build] trained {len(hist)} epochs, final loss {hist[-1]:.5f}")
        params = model_lib._map_tree(params, lambda a: torch.as_tensor(a).to(dev))
        # Misclassification evaluation runs through the SAME engine that
        # will serve lookups, so T_aux always corrects exactly the
        # deployed model; the warm weight cache is adopted below.
        engine = InferenceEngine(
            encoder, spec, params,
            use_kernels=config.use_kernels, max_bucket=config.inference_batch,
            device=dev,
        )
        wrong = trainer_lib.evaluate_misclassified_engine(
            engine, table.keys, codes, batch=config.inference_batch
        )
        aux = AuxTable.build(
            table.keys[wrong],
            codes[wrong],
            codec=config.codec,
            partition_bytes=config.partition_bytes,
            pool=pool,
        )
        vexist = BitVector.from_keys(table.keys)
        store = cls(
            encoder=encoder,
            spec=spec,
            params=engine.params,
            codecs=codecs,
            aux=aux,
            vexist=vexist,
            raw_bytes=table.raw_size_bytes(),
            num_rows=table.num_rows,
            config=config,
            device=dev,
        )
        store.attach_engine(engine)
        if verbose:
            memorized = 1.0 - wrong.mean() if wrong.size else 1.0
            print(
                f"[build] memorized {memorized:.1%} of {table.num_rows} rows; "
                f"ratio {store.compression_ratio():.4f}"
            )
        return store

    # ---------------------------------------------------------------- lookup
    def _infer_codes(
        self, keys: np.ndarray, tasks: Optional[Tuple[str, ...]] = None
    ) -> np.ndarray:
        """Model predictions for (possibly out-of-capacity) keys, through
        the engine (cached padded weights, buckets, pipelined chunks)."""
        keys = np.asarray(keys, dtype=np.int64)
        return self.engine.infer(keys, tasks)

    @property
    def columns(self) -> Tuple[str, ...]:
        return self.spec.tasks

    def _dispatch_lookup(
        self,
        keys: np.ndarray,
        columns: Optional[Tuple[str, ...]] = None,
        fanout: Optional[bool] = None,
        predicates: tuple = (),
        keys_exist: bool = False,
        on_error: str = "raise",
    ) -> _PendingLookup:
        """Stage 1 of Algorithm 1: enqueue device inference (+ fused
        existence test) for the first chunks of the batch and return.
        The host half runs in :meth:`_collect_lookup`; a caller that
        dispatches batch *i+1* before collecting batch *i* overlaps
        device inference with host aux-merge + decode.  At most
        ``DISPATCH_WINDOW`` chunks are in flight (collect tops the
        window up), so a full-relation scan never pins the whole key
        set on device.  ``fanout`` is accepted for protocol parity
        (nothing to fan out here).

        ``predicates`` are pushed below decode: each compiles here to a
        boolean *code table* over the column's decode map (one
        vectorized evaluation per distinct value, not per row), the
        predicate head joins the inference task set even when the
        projection excludes it, and at collect time rows are filtered
        on their aux-corrected argmax codes — non-matching rows are
        never decoded.  ``keys_exist`` is accepted for hook parity (the
        fused existence test is already device-cheap here); so is
        ``on_error`` — a single-owner store has no healthy subset to
        degrade to, so the executor owns its partial fallback."""
        keys = np.asarray(keys, dtype=np.int64)
        t0 = time.perf_counter()
        selected, wanted, skipped, preds, ktables = self._plan_lookup(
            columns, predicates
        )
        pending = _PendingLookup(
            keys=keys, wanted=wanted, decode=selected, skipped=skipped,
            preds=preds, tickets=[], next_start=0, dispatch_s=0.0,
            kernel_tables=ktables,
        )
        if keys.shape[0] and wanted:
            while (
                len(pending.tickets) < DISPATCH_WINDOW
                and pending.next_start < keys.shape[0]
            ):
                self._dispatch_next_chunk(pending)
        pending.dispatch_s = time.perf_counter() - t0
        return pending

    def _plan_lookup(
        self, columns: Optional[Tuple[str, ...]], predicates: tuple
    ) -> tuple:
        """Shared planning half of :meth:`_dispatch_lookup`: resolve the
        projection/predicate head sets and compile the predicate code
        tables once.  Returns ``(selected, wanted, skipped, preds,
        kernel_tables)`` where ``kernel_tables`` pairs each predicate
        column with the AND of its predicates' boolean tables for the
        in-kernel filter path (empty when the columns outnumber
        ``MAX_PREDS``: the host then filters every row)."""
        all_tasks = self.spec.tasks
        selected = tuple(t for t in all_tasks if columns is None or t in columns)
        pred_cols = frozenset(p.column for p in predicates)
        wanted = tuple(
            t for t in all_tasks if t in pred_cols or t in selected
        )
        skipped = tuple(t for t in all_tasks if t not in wanted)
        preds = tuple(
            (wanted.index(p.column), self._pred_table(p), p.describe())
            for p in predicates
        )
        by_column: Dict[str, np.ndarray] = {}
        for p, (_, table, _) in zip(predicates, preds):
            prev = by_column.get(p.column)
            by_column[p.column] = table if prev is None else prev & table
        ktables = tuple(by_column.items()) if len(by_column) <= MAX_PREDS else ()
        return selected, wanted, skipped, preds, ktables

    def _pred_table(self, pred) -> np.ndarray:
        """Memoized boolean code table for one predicate (see
        ``Predicate.code_table``), resident in the store's
        :class:`~repro_torch.api.cache.PlanCache`: a morselized plan
        dispatches per chunk, but the full-vocabulary predicate
        evaluation is paid once per (predicate, decode map), not per
        morsel, and survives across repeated plans.  Invalidated by the
        mutation version AND decode-map identity (``extend()`` swaps in
        a new array); benign race under the shard fan-out — worst case
        is one duplicate compute."""
        codec = self.codecs[pred.column]
        return self.plan_cache().pred_table(
            pred, codec.decode_map, self.mutation_version()
        )

    def _dispatch_next_chunk(self, pending: _PendingLookup) -> None:
        bs = self.config.inference_batch
        start = pending.next_start
        pending.tickets.append((
            start,
            self.engine.dispatch(
                pending.keys[start : start + bs], pending.wanted,
                want_exists=True,
                pred_tables=pending.kernel_tables or None,
            ),
        ))
        pending.next_start = min(start + bs, pending.keys.shape[0])

    def supports_kernel_filter(self, predicates: tuple = ()) -> bool:
        """True when ``predicates`` would be evaluated in-kernel: every
        predicate column is a model head, the columns fit the kernel's
        ``MAX_PREDS`` table slots, and the full wanted head set fits the
        resident ``fused`` tier (the streamed and jit tiers filter on the
        host).  Checked per plan by the executor to skip its host
        ``Filter`` stage."""
        if not self.config.use_kernels or not predicates:
            return False
        if any(p.column not in self.spec.tasks for p in predicates):
            return False
        if len({p.column for p in predicates}) > MAX_PREDS:
            return False
        return self.engine.kernel_filter_capable(self.spec.tasks)

    def _collect_lookup(
        self, pending: _PendingLookup
    ) -> Tuple[Dict[str, np.ndarray], np.ndarray, Optional[np.ndarray], ExplainStats]:
        """Stage 2 of Algorithm 1: per chunk, block on the device
        result, apply the aux-table override, filter on argmax codes
        (value-predicate pushdown), and decode the surviving rows —
        while later chunks keep executing on the device.  Returns
        ``(values, exists, match, stats)``; ``match`` is ``None``
        without predicates."""
        keys, wanted, skipped = pending.keys, pending.wanted, pending.skipped
        decode_cols, preds = pending.decode, pending.preds
        all_tasks = self.spec.tasks
        n_chunks = max(
            1, -(-keys.shape[0] // self.config.inference_batch)
        ) if pending.tickets else 0
        fused = bool(pending.tickets) and pending.tickets[0][1].path == "fused"
        kfilter = self._kernel_filtering(pending)
        stats = ExplainStats(
            heads_evaluated=wanted,
            heads_skipped=skipped,
            columns_decoded=decode_cols,
            columns_skipped=tuple(t for t in all_tasks if t not in decode_cols),
            predicates=tuple(d for _, _, d in preds),
            plan=(
                f"infer[{len(wanted)}/{len(all_tasks)} heads,"
                f"{pending.tickets[0][1].path if pending.tickets else 'none'}]",
                "exist[fused]" if fused else "exist",
                "aux_merge",
            )
            + (
                (
                    f"filter[{'kernel,' if kfilter else ''}"
                    f"{','.join(d for _, _, d in preds)}]",
                )
                if preds
                else ()
            )
            + (
                f"decode[{','.join(decode_cols)}]",
                f"pipeline[{max(1, n_chunks)} chunks]",
            ),
        )
        stats.kernel_filtered = kfilter
        stats.infer_s = pending.dispatch_s

        if not pending.tickets:
            # Zero keys or empty projection: typed empty/zero columns,
            # host existence only — never reaches the device.
            t1 = time.perf_counter()
            exists = self.vexist.test(keys)
            t2 = time.perf_counter()
            values = {
                t: self.codecs[t].decode(np.zeros(keys.shape[0], dtype=np.int32))
                for t in decode_cols
            }
            stats.exist_s = t2 - t1
            stats.decode_s = time.perf_counter() - t2
            return values, exists, exists.copy() if preds else None, stats

        dec_idx = [wanted.index(t) for t in decode_cols]
        exists_parts, match_parts = [], []
        value_parts = {t: [] for t in decode_cols}
        for codes, exists, match in self._iter_corrected_chunks(pending, stats):
            t5 = time.perf_counter()
            if match is None:
                # line 13: decode — selected columns only.
                for t, wi in zip(decode_cols, dec_idx):
                    safe = np.where(exists, codes[:, wi], 0)
                    value_parts[t].append(self.codecs[t].decode(safe))
                stats.rows_decoded += int(exists.shape[0])
            else:
                # line 13: decode ONLY the matching rows.
                hit = np.flatnonzero(match)
                for t, wi in zip(decode_cols, dec_idx):
                    codec = self.codecs[t]
                    out = np.zeros(exists.shape[0], dtype=codec.decode_map.dtype)
                    if hit.size:
                        out[hit] = codec.decode(codes[hit, wi])
                    value_parts[t].append(out)
                stats.rows_decoded += int(hit.size)
                match_parts.append(match)
            stats.decode_s += time.perf_counter() - t5
            exists_parts.append(exists)

        exists = (
            exists_parts[0]
            if len(exists_parts) == 1
            else np.concatenate(exists_parts)
        )
        match = None
        if preds:
            match = (
                match_parts[0]
                if len(match_parts) == 1
                else np.concatenate(match_parts)
            )
        values = {
            t: (parts[0] if len(parts) == 1 else np.concatenate(parts))
            for t, parts in value_parts.items()
        }
        return values, exists, match, stats

    @staticmethod
    def _kernel_filtering(pending: _PendingLookup) -> bool:
        """True when the first dispatched chunk asked K1 for match bits;
        ``_iter_corrected_chunks`` clears ``kernel_filtered`` for any
        chunk that came back without them."""
        if not (pending.preds and pending.tickets):
            return False
        ticket = pending.tickets[0][1]
        return ticket.path == "fused" and ticket.match_dev is not None

    def _iter_corrected_chunks(self, pending: _PendingLookup, stats: ExplainStats):
        """Yield ``(codes, exists, match)`` per chunk of a pending
        lookup — the shared front half of Algorithm 1 (device collect,
        existence fallback, aux override, predicate code-table filter)
        WITHOUT the decode tail.  ``codes`` are the aux-corrected argmax
        codes ``(rows, len(wanted))``; ``match`` is ``None`` without
        predicates.  The aggregate path consumes these directly: for
        existing rows the corrected codes are exact (the aux table
        overrides every model miss), so any reduction over them equals
        the same reduction over decoded values."""
        keys, preds = pending.keys, pending.preds
        task_idx = [self.spec.tasks.index(t) for t in pending.wanted]
        while pending.tickets:
            _, ticket = pending.tickets.pop(0)
            t0 = time.perf_counter()
            while (
                len(pending.tickets) < DISPATCH_WINDOW - 1
                and pending.next_start < keys.shape[0]
            ):
                self._dispatch_next_chunk(pending)
            t1 = time.perf_counter()
            codes, exists = self.engine.collect(ticket)
            t2 = time.perf_counter()
            if exists is None:
                exists = self.vexist.test(ticket.keys)
            t3 = time.perf_counter()
            exist_idx = np.flatnonzero(exists)
            found, aux_codes = self.aux.get(ticket.keys[exist_idx])
            codes[exist_idx[found]] = aux_codes[found][:, task_idx]
            t4 = time.perf_counter()
            stats.infer_s += (t1 - t0) + (t2 - t1)
            stats.exist_s += t3 - t2
            stats.aux_s += t4 - t3
            match = None
            # Predicate filter on aux-corrected argmax codes: one boolean
            # gather per predicate, BEFORE any decode.
            if preds:
                if ticket.match is not None:
                    # In-kernel filter: the fused kernel already ANDed
                    # the predicate code tables over the model codes and
                    # exist bits; only the (few) aux-overridden rows can
                    # have changed codes, so re-evaluate just those on
                    # their corrected codes via the full host tables.
                    match = ticket.match
                    aux_rows = exist_idx[found]
                    if aux_rows.size:
                        patched = np.ones(aux_rows.shape[0], dtype=bool)
                        for wi, table, _ in preds:
                            patched &= table[codes[aux_rows, wi]]
                        match[aux_rows] = patched
                else:
                    stats.kernel_filtered = False
                    match = exists.copy()
                    for wi, table, _ in preds:
                        codes_w = np.where(exists, codes[:, wi], 0)
                        match &= table[codes_w]
                stats.filter_s += time.perf_counter() - t4
                stats.rows_matched += int(match.sum())
            yield codes, exists, match

    def _collect_aggregate(self, pending: _PendingLookup, group_by, aggregates):
        """Code-space ``group_by(...).agg(...)``: consume aux-corrected
        argmax codes, never rows.

        Rows group by their raw code vectors (mixed-radix packed over
        the codec cardinalities); ``count`` is a ``bincount`` over the
        packed codes, ``sum``/``min``/``max`` gather per-row values
        through the cached code→value tables
        (:meth:`~repro_torch.api.cache.PlanCache.agg_table` — the decode map
        cast once per vocabulary, version-fenced like the predicate
        tables).  Only the *distinct group labels* are decoded, so
        ``rows_decoded`` stays 0 no matter how many rows aggregate —
        the below-decode claim the TPC-H harness asserts.  State keys
        are decoded group values, mergeable across shards/members with
        independent codecs."""
        keys, wanted, preds = pending.keys, pending.wanted, pending.preds
        all_tasks = self.spec.tasks
        gidx = [wanted.index(c) for c in group_by]
        gdims = [self.codecs[c].cardinality for c in group_by]
        specs = []
        for spec in aggregates:
            if spec.column is None:
                specs.append((None, None))
            else:
                table = self.plan_cache().agg_table(
                    spec.column,
                    self.codecs[spec.column].decode_map,
                    self.mutation_version(),
                )
                specs.append((wanted.index(spec.column), table))
        n_chunks = max(
            1, -(-keys.shape[0] // self.config.inference_batch)
        ) if pending.tickets else 0
        kfilter = self._kernel_filtering(pending)
        stats = ExplainStats(
            heads_evaluated=wanted,
            heads_skipped=pending.skipped,
            columns_skipped=tuple(t for t in all_tasks if t not in wanted),
            predicates=tuple(d for _, _, d in preds),
            plan=(
                f"infer[{len(wanted)}/{len(all_tasks)} heads,"
                f"{pending.tickets[0][1].path if pending.tickets else 'none'}]",
                "exist",
                "aux_merge",
            )
            + (
                (
                    f"filter[{'kernel,' if kfilter else ''}"
                    f"{','.join(d for _, _, d in preds)}]",
                )
                if preds
                else ()
            )
            + (
                f"aggregate[code,{len(group_by)} keys,{len(aggregates)} aggs]",
                f"pipeline[{max(1, n_chunks)} chunks]",
            ),
        )
        stats.kernel_filtered = kfilter
        stats.infer_s = pending.dispatch_s
        state: Dict[tuple, list] = {}

        def fold(codes: Optional[np.ndarray], sel: np.ndarray) -> None:
            """Fold one chunk's selected rows (code-space) into state."""
            t5 = time.perf_counter()
            if sel.size:
                if gidx:
                    if len(gidx) > 1:
                        packed = np.ravel_multi_index(
                            [codes[sel, wi] for wi in gidx], gdims
                        )
                    else:
                        packed = codes[sel, gidx[0]]
                    ug, ginv = np.unique(packed, return_inverse=True)
                    coords = np.unravel_index(ug, gdims)
                    # decode per DISTINCT group, not per row: this is
                    # label materialization, not row decode
                    labels = [
                        self.codecs[c].decode(np.asarray(coord)).tolist()
                        for c, coord in zip(group_by, coords)
                    ]
                    group_tuples = list(zip(*labels))
                else:
                    ug = np.zeros(1, dtype=np.int64)
                    ginv = np.zeros(sel.size, dtype=np.int64)
                    group_tuples = [()]
                value_arrays = [
                    None if table is None else table[codes[sel, wi]]
                    for wi, table in specs
                ]
                partials = agg_partials(aggregates, ginv, len(ug), value_arrays)
                fold_agg_partials(state, group_tuples, aggregates, partials)
            stats.agg_s += time.perf_counter() - t5

        if not pending.tickets:
            # Zero keys, or a count-only global aggregate with no
            # predicate heads: host existence test answers everything.
            t1 = time.perf_counter()
            exists = self.vexist.test(keys)
            stats.exist_s = time.perf_counter() - t1
            fold(None, np.flatnonzero(exists))
            return state, stats

        for codes, exists, match in self._iter_corrected_chunks(pending, stats):
            sel = np.flatnonzero(exists if match is None else match)
            fold(codes, sel)
        return state, stats

    def _lookup_with_stats(
        self,
        keys: np.ndarray,
        columns: Optional[Tuple[str, ...]] = None,
        fanout: Optional[bool] = None,
    ) -> Tuple[Dict[str, np.ndarray], np.ndarray, ExplainStats]:
        """Algorithm 1 with projection pushdown and per-call stats —
        the dispatch/collect pair run back-to-back (all chunks' device
        work enqueued up front, host half trailing chunk by chunk)."""
        values, exists, _, stats = self._collect_lookup(
            self._dispatch_lookup(keys, columns, fanout)
        )
        return values, exists, stats

    def lookup(
        self, keys: np.ndarray, columns: Optional[Tuple[str, ...]] = None
    ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
        """Algorithm 1 — batched exact-match lookup.

        Returns ``(values, exists)``: per-column decoded arrays (rows
        where ``exists`` is False are NULL — filled with the column's
        code-0 value, callers must respect the mask) plus the existence
        mask.  For per-call stats use ``store.query(...).execute().explain``
        (the ``last_stats`` side-channel was removed — the metrics
        registry and ``ExplainStats`` supersede it).
        """
        values, exists, _stats = self._lookup_with_stats(keys, columns)
        return values, exists

    # ------------------------------------------------ modifications (Alg 3-5)
    def _encode_rows(self, columns: Dict[str, np.ndarray]) -> np.ndarray:
        """Encode raw values to codes, extending codecs for unseen values.
        Codes beyond a head's out_card can never be predicted by ``M``,
        so such rows are routed to T_aux."""
        cols = []
        for t in self.spec.tasks:
            codec = self.codecs[t]
            codec.extend(columns[t])
            codes, known = codec.encode(columns[t])
            if not known.all():
                raise RuntimeError("extend() must make every value encodable")
            cols.append(codes)
        return np.stack(cols, axis=1)

    def insert(self, keys: np.ndarray, columns: Dict[str, np.ndarray]) -> None:
        """Algorithm 3. Pairs the model already generalizes to are NOT
        stored; the rest land in T_aux."""
        keys = np.asarray(keys, dtype=np.int64)
        if keys.size == 0:
            return
        if np.unique(keys).size != keys.size:
            raise ValueError("duplicate keys in insert batch")
        if self.vexist.test(keys).any():
            raise ValueError("insert of existing key; use update()")
        codes = self._encode_rows(columns)
        self.vexist.set(keys, True)                      # line 4
        pred = self._infer_codes(keys)                   # line 5 (inference check)
        wrong = (pred != codes).any(axis=1) | (keys >= self.encoder.capacity)
        if wrong.any():
            self.aux.add(keys[wrong], codes[wrong])      # line 9
        self.num_rows += keys.shape[0]
        self.raw_bytes += int(keys.shape[0] * self._bytes_per_row)
        self.modified_bytes += int(keys.shape[0] * self._bytes_per_row)
        self._note_mutation()

    def delete(self, keys: np.ndarray) -> None:
        """Algorithm 4. Existence bit off; purge from T_aux if present."""
        # unique: a key repeated in one batch deletes one row, not two
        keys = np.unique(np.asarray(keys, dtype=np.int64))
        present = self.vexist.test(keys)
        keys = keys[present]
        if keys.size == 0:
            return
        self.vexist.set(keys, False)                     # line 4
        in_aux = self.aux.contains(keys)                 # line 5
        if in_aux.any():
            self.aux.remove(keys[in_aux])
        self.num_rows -= keys.shape[0]
        self.raw_bytes -= int(keys.shape[0] * self._bytes_per_row)
        self.modified_bytes += int(keys.shape[0] * self._bytes_per_row)
        self._note_mutation()

    def update(self, keys: np.ndarray, columns: Dict[str, np.ndarray]) -> None:
        """Algorithm 5. Correctly-predicted updates drop any aux entry;
        the rest are upserted into T_aux."""
        keys = np.asarray(keys, dtype=np.int64)
        if keys.size == 0:
            return
        if not self.vexist.test(keys).all():
            raise ValueError("update of non-existing key; use insert()")
        codes = self._encode_rows(columns)
        pred = self._infer_codes(keys)
        right = (pred == codes).all(axis=1) & (keys < self.encoder.capacity)
        if right.any():
            in_aux = self.aux.contains(keys[right])      # line 4
            if in_aux.any():
                self.aux.remove(keys[right][in_aux])
        wrong = ~right
        if wrong.any():
            self.aux.update(keys[wrong], codes[wrong])   # lines 7-11
        self.modified_bytes += int(keys.shape[0] * self._bytes_per_row)
        self._note_mutation()

    def _range_keys(self, lo: int, hi: Optional[int]) -> np.ndarray:
        """Existence-index range filter (§IV-E) — key source for the
        protocol's ``range_lookup``/``scan`` and the plan executor."""
        return self.vexist.keys_in_range(lo, hi)

    def should_retrain(self) -> bool:
        thr = self.config.retrain_after_modified_bytes
        return thr is not None and self.modified_bytes >= thr

    def materialize(self) -> Table:
        """Reconstruct the full logical table (used by retrain)."""
        keys, values = self.scan()
        return Table(keys=keys, columns=values)

    def retrain(self, verbose: bool = False) -> "DeepMappingStore":
        """Rebuild model + auxiliary structures on current logical data,
        on this store's device (paper: lazily, offline/background/non-peak)."""
        return DeepMappingStore.build(
            self.materialize(), self.config, pool=self.aux.pool, verbose=verbose,
            device=self.device,
        )

    # ---------------------------------------------------------- persistence
    def save(self, path: str) -> None:
        """Protocol persistence — the reference's v2 directory layout
        (``core.serialize``; atomic tmp+rename)."""
        from repro_torch.core import serialize  # local: serialize imports us

        serialize.save_store(self, path)

    @classmethod
    def load(
        cls, path: str, pool: Optional[MemoryPool] = None, device: DeviceLike = None
    ) -> "DeepMappingStore":
        """Open a store saved by either package onto ``device`` (CUDA by
        default); see :func:`~repro_torch.core.serialize.load_store`."""
        from repro_torch.core import serialize

        return serialize.load_store(path, pool=pool, device=device)

    # ------------------------------------------------------------- accounting
    def size_breakdown(self) -> Dict[str, int]:
        """Bytes per component — the paper's Fig. 6 storage breakdown."""
        return {
            "model": model_lib.model_size_bytes(self.params),
            "aux_table": self.aux.size_bytes(),
            "exist_bitvector": self.vexist.size_bytes(),
            "decode_map": sum(c.size_bytes() for c in self.codecs.values())
            + self.encoder.size_bytes(),
        }

    def size_bytes(self) -> int:
        return sum(self.size_breakdown().values())

    def compression_ratio(self) -> float:
        """Paper Eq. 1 — lower is better; 1.0 means no compression."""
        return self.size_bytes() / max(1, self.raw_bytes)

    def memorized_fraction(self) -> float:
        """Fraction of rows answered by ``M`` alone (paper reports 66-81%)."""
        return 1.0 - self.aux.num_rows / max(1, self.num_rows)
