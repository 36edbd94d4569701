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
``params``); save/load and the query layer come with later slices, and
the store is a plain class (the reference's ``MappingStore`` protocol
comes with the query layer).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.api.plan import ExplainStats
from repro_torch.core import model as model_lib
from repro_torch.core import trainer as trainer_lib
from repro_torch.core.aux_table import AuxTable
from repro_torch.core.bitvector import BitVector
from repro_torch.core.encoding import KeyEncoder, ValueCodec, build_codecs
from repro_torch.core.inference import InferenceEngine
from repro_torch.core.model import MLPSpec
from repro_torch.core.table import Table
from repro_torch.device import DeviceLike, resolve_device
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


#: Device chunks in flight ahead of the host half.
DISPATCH_WINDOW = 2


@dataclasses.dataclass
class _PendingLookup:
    """Handle returned by ``_dispatch_lookup``: device inference for the
    first ``DISPATCH_WINDOW`` chunks is enqueued; the host half
    (existence fallback, aux merge, decode) runs at ``_collect_lookup``
    time, which tops the window up as it drains."""

    keys: np.ndarray
    wanted: Tuple[str, ...]            # heads to evaluate
    skipped: Tuple[str, ...]
    tickets: list                      # [(start, InferTicket), ...] in flight
    next_start: int                    # first key offset not yet dispatched
    dispatch_s: float


class DeepMappingStore:
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
        self._mutations = 0
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

    def mutation_version(self) -> int:
        """Counter bumped by every insert/delete/update."""
        return self._mutations

    def _note_mutation(self) -> None:
        self._mutations += 1

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
        self, keys: np.ndarray, columns: Optional[Tuple[str, ...]] = None
    ) -> _PendingLookup:
        """Stage 1 of Algorithm 1: enqueue device inference (+ fused
        existence test) for the first chunks of the batch and return.  At
        most ``DISPATCH_WINDOW`` chunks are in flight; collect tops the
        window up."""
        keys = np.asarray(keys, dtype=np.int64)
        t0 = time.perf_counter()
        all_tasks = self.spec.tasks
        wanted = tuple(t for t in all_tasks if columns is None or t in columns)
        skipped = tuple(t for t in all_tasks if t not in wanted)
        pending = _PendingLookup(
            keys=keys, wanted=wanted, skipped=skipped, tickets=[],
            next_start=0, dispatch_s=0.0,
        )
        if keys.shape[0] and wanted:
            while (
                len(pending.tickets) < DISPATCH_WINDOW
                and pending.next_start < keys.shape[0]
            ):
                self._dispatch_next_chunk(pending)
        pending.dispatch_s = time.perf_counter() - t0
        return pending

    def _dispatch_next_chunk(self, pending: _PendingLookup) -> None:
        bs = self.config.inference_batch
        start = pending.next_start
        pending.tickets.append((
            start,
            self.engine.dispatch(
                pending.keys[start : start + bs], pending.wanted, want_exists=True,
            ),
        ))
        pending.next_start = min(start + bs, pending.keys.shape[0])

    def _collect_lookup(
        self, pending: _PendingLookup
    ) -> Tuple[Dict[str, np.ndarray], np.ndarray, ExplainStats]:
        """Stage 2 of Algorithm 1: per chunk, copy the device result back,
        apply the aux-table override and decode — while later chunks keep
        executing on the device.  Returns ``(values, exists, stats)``."""
        keys, wanted = pending.keys, pending.wanted
        all_tasks = self.spec.tasks
        n_chunks = max(
            1, -(-keys.shape[0] // self.config.inference_batch)
        ) if pending.tickets else 0
        fused = bool(pending.tickets) and pending.tickets[0][1].path == "fused"
        stats = ExplainStats(
            heads_evaluated=wanted,
            heads_skipped=pending.skipped,
            columns_decoded=wanted,
            columns_skipped=pending.skipped,
            plan=(
                f"infer[{len(wanted)}/{len(all_tasks)} heads,"
                f"{pending.tickets[0][1].path if pending.tickets else 'none'}]",
                "exist[fused]" if fused else "exist",
                "aux_merge",
                f"decode[{','.join(wanted)}]",
                f"pipeline[{max(1, n_chunks)} chunks]",
            ),
        )
        stats.infer_s = pending.dispatch_s

        if not pending.tickets:
            # Zero keys or empty projection: typed empty/zero columns,
            # host existence only — never reaches the device.
            t1 = time.perf_counter()
            exists = self.vexist.test(keys)
            t2 = time.perf_counter()
            values = {
                t: self.codecs[t].decode(np.zeros(keys.shape[0], dtype=np.int32))
                for t in wanted
            }
            stats.exist_s = t2 - t1
            stats.decode_s = time.perf_counter() - t2
            return values, exists, stats

        task_idx = [all_tasks.index(t) for t in wanted]
        exists_parts = []
        value_parts = {t: [] for t in wanted}
        while pending.tickets:
            _, ticket = pending.tickets.pop(0)
            # keep the device window full before blocking on this chunk
            t0 = time.perf_counter()
            while (
                len(pending.tickets) < DISPATCH_WINDOW - 1
                and pending.next_start < keys.shape[0]
            ):
                self._dispatch_next_chunk(pending)
            t1 = time.perf_counter()
            stats.infer_s += t1 - t0
            pred, exists = self.engine.collect(ticket)      # line 3 (inference)
            t2 = time.perf_counter()
            if exists is None:                               # line 5 (existence)
                exists = self.vexist.test(ticket.keys)
            t3 = time.perf_counter()
            # line 6-8: aux override for existing keys only.  T_aux rows
            # carry codes for ALL tasks; project to the evaluated ones.
            exist_idx = np.flatnonzero(exists)
            found, aux_codes = self.aux.get(ticket.keys[exist_idx])
            pred[exist_idx[found]] = aux_codes[found][:, task_idx]
            t4 = time.perf_counter()
            stats.infer_s += t2 - t1
            stats.exist_s += t3 - t2
            stats.aux_s += t4 - t3
            # line 13: decode
            for wi, t in enumerate(wanted):
                safe = np.where(exists, pred[:, wi], 0)
                value_parts[t].append(self.codecs[t].decode(safe))
            stats.rows_decoded += int(exists.shape[0])
            stats.decode_s += time.perf_counter() - t4
            exists_parts.append(exists)

        exists = exists_parts[0] if len(exists_parts) == 1 else np.concatenate(exists_parts)
        values = {
            t: (parts[0] if len(parts) == 1 else np.concatenate(parts))
            for t, parts in value_parts.items()
        }
        return values, exists, stats

    def _lookup_with_stats(
        self, keys: np.ndarray, columns: Optional[Tuple[str, ...]] = None
    ) -> Tuple[Dict[str, np.ndarray], np.ndarray, ExplainStats]:
        """Algorithm 1 with projection pushdown and per-call stats."""
        return self._collect_lookup(self._dispatch_lookup(keys, columns))

    def lookup(
        self, keys: np.ndarray, columns: Optional[Tuple[str, ...]] = None
    ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
        """Algorithm 1 — batched exact-match lookup.

        Returns ``(values, exists)``: per-column decoded arrays (rows
        where ``exists`` is False are NULL — filled with the column's
        code-0 value, callers must respect the mask) plus the existence
        mask.
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
