"""Shared machinery for the AB/HB baseline stores: partitioned
immutable base + modification overlay + protocol persistence.

A copy of ``repro.baselines.partitioned``.  The file is packed by the
port's own msgpack codec (:mod:`repro_torch.storage.msgpack_codec`,
byte-equal to ``msgpack.packb``), and read through the port's
serializer helpers, so a baseline file saved by either package opens in
the other.  Baselines are host code in both packages: numpy and pickle,
no device, no ``device`` argument.  That is the reference's design, not
a fallback: the JAX package gives them no device either.

The paper's baselines are build-once partitioned blobs.  To conform to
the :class:`~repro_torch.api.protocol.MappingStore` contract (insert /
delete / update like the DeepMapping stores), both baselines layer a
small in-memory **overlay** over the immutable partitions — the same
discipline as an LSM memtable over sealed runs:

* ``_overlay``  maps key -> row for inserted and updated rows;
* ``_deleted``  masks keys whose base row was removed.

Lookup answers from the partitions first, then patches overlay rows in
and masks deleted keys out; range/scan key sources merge the overlay
into the base partition scan.  ``save``/``load`` persist everything in
one msgpack file (atomic ``os.replace``), self-describing via a
``kind`` header that ``repro_torch.open`` sniffs.

**Partition pruning** (predicate pushdown into the partition probe):
when a pushed-down predicate's column is dictionary-encoded, the store
keeps a lazy per-partition *zone map* of present codes
(``_partition_code_presence``) and skips — never decompresses — any
partition whose dictionary holds no matching code.  Pruning only
activates under the executor's ``keys_exist`` hint (range/scan plans,
whose keys come from the existence index), so skipped rows' existence
is known without a probe; overlay-touched keys are never pruned.
``ExplainStats.partitions_pruned`` records the evidence.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.api.plan import (
    ExplainStats,
    columns_with_predicates,
    evaluate_predicates,
)
from repro_torch.api.protocol import MappingStore
from repro_torch.core.serialize import crc32, read_artifact, unpack_meta
from repro_torch.storage import MemoryPool
from repro_torch.storage.msgpack_codec import packb

#: v2 wraps the state in a ``{"version", "kind", "crc32", "payload"}``
#: envelope — the payload crc is verified on load; v1 flat files (state
#: dict at top level, no checksum) still load, without verification.
BASELINE_FORMAT_VERSION = 2



def _array_to_state(arr: np.ndarray) -> Dict:
    """msgpack-friendly array state (raw bytes for numerics, item list
    for strings/objects — no pickle)."""
    arr = np.asarray(arr)
    if arr.dtype == object or arr.dtype.kind in "US":
        return {"enc": "items", "dtype": arr.dtype.str, "items": list(arr.tolist())}
    return {"enc": "raw", "dtype": arr.dtype.str, "raw": arr.tobytes()}


def _array_from_state(state: Dict) -> np.ndarray:
    if state["enc"] == "items":
        dt = np.dtype(state["dtype"])
        return np.asarray(state["items"], dtype=object if dt == object else dt)
    return np.frombuffer(state["raw"], dtype=np.dtype(state["dtype"])).copy()


class PartitionedBaselineStore(MappingStore):
    """Base class of :class:`ArrayStore` and :class:`HashStore`.

    Subclasses provide the immutable-partition probe surface:

    * ``kind``                        — format tag for save/open sniffing;
    * ``_base_lookup(keys, wanted)``  — partition binary-search/hash probe;
    * ``_base_keys_in_range(lo, hi)`` — ascending base keys in ``[lo, hi)``;
    * ``_extra_state()`` / ``_construct(state, pool)`` — subclass fields.
    """

    kind: str = "abstract"

    # Set by subclass __init__:
    names: List[str]
    codec_name: str
    partition_bytes: int
    pool: MemoryPool
    _partitions: List[bytes]
    _boundaries: np.ndarray
    num_rows: int

    def _init_overlay(self) -> None:
        self._overlay: Dict[int, Dict[str, object]] = {}
        self._deleted: set = set()
        # Lazily-built int64 array of overlay+deleted keys — the
        # vectorized lookup prefilter; mutations invalidate it.
        self._touched_cache: Optional[np.ndarray] = None

    def _touched_keys(self) -> np.ndarray:
        if self._touched_cache is None:
            n = len(self._overlay) + len(self._deleted)
            self._touched_cache = np.fromiter(
                (k for src in (self._overlay, self._deleted) for k in src),
                dtype=np.int64,
                count=n,
            )
        return self._touched_cache

    # --------------------------------------------------------- probe hooks
    def _base_lookup(
        self, keys: np.ndarray, wanted: List[str]
    ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
        raise NotImplementedError

    def _base_keys_in_range(self, lo: int, hi: Optional[int]) -> np.ndarray:
        raise NotImplementedError

    # ----------------------------------------------------- pruning hooks
    def _column_decoder(self, column: str):
        """The column's :class:`~repro_torch.core.encoding.ValueCodec` when
        the base partitions store dictionary codes for it, else
        ``None`` (no zone-map pruning possible).  Subclass hook."""
        return None

    def _partition_code_presence(self, column: str) -> Optional[np.ndarray]:
        """Zone map: bool ``(num_partitions, cardinality)`` — which
        codes appear in each partition's base rows — or ``None`` when
        the column is not dictionary-encoded.  Base partitions are
        immutable, so the map never invalidates.  Subclass hook."""
        return None

    def _partition_span(self, lo: int, hi: Optional[int]) -> Tuple[int, int]:
        """Partition-id range [first, last] overlapping ``[lo, hi)``
        (binary search on boundary keys); (0, -1) when empty."""
        if not self._partitions or (hi is not None and hi <= lo):
            return 0, -1
        first = max(0, int(np.searchsorted(self._boundaries, lo, side="right")) - 1)
        if hi is None:
            return first, len(self._partitions) - 1
        last = int(np.searchsorted(self._boundaries, hi - 1, side="right")) - 1
        return first, last

    # ------------------------------------------------------------ protocol
    @property
    def columns(self) -> Tuple[str, ...]:
        return tuple(self.names)

    def lookup(
        self, keys: np.ndarray, columns: Optional[Tuple[str, ...]] = None
    ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
        """Partition probe + overlay patch -> ``(values, exists)``."""
        keys = np.asarray(keys, dtype=np.int64)
        wanted = [c for c in self.names if columns is None or c in columns]
        values, exists = self._base_lookup(keys, wanted)
        self._apply_overlay(keys, wanted, values, exists)
        return values, exists

    def _apply_overlay(
        self,
        keys: np.ndarray,
        wanted: List[str],
        values: Dict[str, np.ndarray],
        exists: np.ndarray,
    ) -> None:
        """Patch overlay rows in / deleted keys out, in place — the
        baselines' analogue of the hybrid store's aux-merge stage (the
        streaming executor times it as the AuxMerge operator)."""
        if not (self._overlay or self._deleted):
            return
        # Vectorized prefilter: restrict the Python fix-up loop to
        # keys that actually hit the (typically tiny) overlay state.
        candidates = np.flatnonzero(np.isin(keys, self._touched_keys()))
        fix_idx: List[int] = []
        fix_rows: List[Dict[str, object]] = []
        for i in candidates.tolist():
            k = int(keys[i])
            if k in self._deleted:
                exists[i] = False
            else:
                row = self._overlay.get(k)
                if row is not None:
                    exists[i] = True
                    fix_idx.append(i)
                    fix_rows.append(row)
        if fix_idx:
            for name in wanted:
                values[name] = _patch_column(
                    values[name], fix_idx, [r[name] for r in fix_rows]
                )

    def _lookup_with_stats(
        self,
        keys: np.ndarray,
        columns: Optional[Tuple[str, ...]] = None,
        fanout: Optional[bool] = None,
    ) -> Tuple[Dict[str, np.ndarray], np.ndarray, ExplainStats]:
        """Partition probe + overlay patch with a real stage split
        (probe time lands in ``decode_s``, overlay patching in
        ``aux_s``), so baseline explain output carries per-operator
        rows instead of one coarse ``lookup`` bucket.  ``fanout`` is
        accepted for protocol parity (nothing to fan out here)."""
        keys = np.asarray(keys, dtype=np.int64)
        wanted = [c for c in self.names if columns is None or c in columns]
        t0 = time.perf_counter()
        values, exists = self._base_lookup(keys, wanted)
        t1 = time.perf_counter()
        self._apply_overlay(keys, wanted, values, exists)
        t2 = time.perf_counter()
        stats = ExplainStats(
            plan=(
                f"probe[{len(self._partitions)} parts]",
                f"overlay[{len(self._overlay)}+{len(self._deleted)}]",
                f"decode[{','.join(wanted)}]",
            ),
            heads_skipped=tuple(self.columns),  # no model heads exist
            columns_decoded=tuple(wanted),
            columns_skipped=tuple(c for c in self.columns if c not in wanted),
            decode_s=t1 - t0,
            aux_s=t2 - t1,
        )
        return values, exists, stats

    # --------------------------------------------------- partition pruning
    def _prunable_partitions(
        self, predicates: tuple
    ) -> Optional[np.ndarray]:
        """Bool array over partitions — True where NO base row can
        match the conjunction (some predicate's zone map shows no
        matching code) — or ``None`` when no predicate column has zone
        info.  Code tables come from the store's plan cache."""
        prunable = None
        version = self.mutation_version()
        for p in predicates:
            presence = self._partition_code_presence(p.column)
            if presence is None:
                continue
            decoder = self._column_decoder(p.column)
            table = self.plan_cache().pred_table(
                p, decoder.decode_map, version
            )
            cant_match = ~(presence & table[None, :]).any(axis=1)
            prunable = (
                cant_match if prunable is None else (prunable | cant_match)
            )
        return prunable

    def _collect_lookup(self, handle):
        """Predicated collects prune partitions via the dictionary zone
        maps (see the module docstring); everything else defers to the
        protocol default."""
        keys, columns, fanout, predicates, keys_exist = handle
        keys = np.asarray(keys, dtype=np.int64)
        n = int(keys.shape[0])
        prunable = (
            self._prunable_partitions(predicates)
            if predicates and keys_exist and n and self._partitions
            else None
        )
        if prunable is None or not prunable.any():
            return super()._collect_lookup(handle)
        pid = np.searchsorted(self._boundaries, keys, side="right") - 1
        prune_mask = (pid >= 0) & prunable[pid]
        touched = np.zeros(n, dtype=bool)
        if self._overlay or self._deleted:
            # Overlay rows carry values the base dictionary never saw —
            # they must be evaluated, never pruned.
            touched = np.isin(keys, self._touched_keys())
            prune_mask &= ~touched
        if not prune_mask.any():
            return super()._collect_lookup(handle)
        if not (~prune_mask & ~touched & (pid >= 0)).any():
            # The probed subset must contain at least one guaranteed
            # base-partition HIT so every output column materializes
            # with its true dtype (an overlay-only probe set would fall
            # back to the empty-gather int64 fill and break morsel
            # concatenation / byte-equality with the unpruned
            # reference).  A pruned row qualifies: under keys_exist it
            # exists and is not overlay-touched, hence lives in a base
            # partition.
            prune_mask[int(np.flatnonzero(prune_mask)[0])] = False
        selected = (
            tuple(columns) if columns is not None else tuple(self.columns)
        )
        need = columns_with_predicates(selected, predicates)
        wanted = [c for c in self.names if c in need]
        t0 = time.perf_counter()
        probe_idx = np.flatnonzero(~prune_mask)
        # Only partitions with NO probed row are truly skipped (never
        # decompressed); one shared with an overlay-touched or anchor
        # row is loaded anyway and must not inflate the evidence.
        skipped_parts = int(
            np.setdiff1d(pid[prune_mask], pid[probe_idx]).size
        )
        sub_values, sub_exists = self._base_lookup(keys[probe_idx], wanted)
        t1 = time.perf_counter()
        self._apply_overlay(keys[probe_idx], wanted, sub_values, sub_exists)
        t2 = time.perf_counter()
        stats = ExplainStats(
            plan=(
                f"probe[{len(self._partitions)} parts,"
                f"{skipped_parts} pruned]",
                f"overlay[{len(self._overlay)}+{len(self._deleted)}]",
                f"filter[{','.join(p.describe() for p in predicates)}]",
                f"decode[{','.join(wanted)}]",
            ),
            heads_skipped=tuple(self.columns),  # no model heads exist
            columns_decoded=tuple(wanted),
            columns_skipped=tuple(c for c in self.columns if c not in wanted),
            partitions_pruned=skipped_parts,
            decode_s=t1 - t0,
            aux_s=t2 - t1,
        )
        sub_match = evaluate_predicates(
            predicates, sub_values, sub_exists, stats
        )
        # keys_exist: every key came from the existence index, so the
        # pruned (unprobed) rows are known present; the probed subset
        # keeps its real probe answer.
        exists = np.ones(n, dtype=bool)
        exists[probe_idx] = sub_exists
        match = np.zeros(n, dtype=bool)
        match[probe_idx] = sub_match
        values: Dict[str, np.ndarray] = {}
        for c in selected:
            sub = sub_values[c]
            full = np.zeros(n, dtype=sub.dtype)
            full[probe_idx] = sub
            values[c] = full
        stats.rows_decoded += int(probe_idx.size)
        return values, exists, match, stats

    def insert(self, keys: np.ndarray, columns: Dict[str, np.ndarray]) -> None:
        keys = np.asarray(keys, dtype=np.int64)
        if keys.size == 0:
            return
        if keys.min() < 0:
            raise ValueError("keys must be non-negative")  # Table parity
        if np.unique(keys).size != keys.size:
            raise ValueError("duplicate keys in insert batch")
        _, exists = self.lookup(keys, columns=())  # exists-only: skip decode
        if exists.any():
            raise ValueError("insert of existing key; use update()")
        # Build every row before touching overlay state: a malformed
        # columns dict must not leave the batch half-applied.
        rows = [{n: columns[n][i] for n in self.names} for i in range(keys.size)]
        for k, row in zip(keys.tolist(), rows):
            self._deleted.discard(k)
            self._overlay[k] = row
        self.num_rows += int(keys.size)
        self._touched_cache = None
        self._note_mutation()

    def delete(self, keys: np.ndarray) -> None:
        # unique: a key repeated in one batch deletes one row, not two
        keys = np.unique(np.asarray(keys, dtype=np.int64))
        if keys.size == 0:
            return
        _, exists = self.lookup(keys, columns=())  # exists-only: skip decode
        for k in keys[exists].tolist():
            # Mask the base row even when an overlay row shadowed it —
            # removing only the overlay would resurrect the base value.
            self._overlay.pop(k, None)
            self._deleted.add(k)
        self.num_rows -= int(exists.sum())
        self._touched_cache = None
        self._note_mutation()

    def update(self, keys: np.ndarray, columns: Dict[str, np.ndarray]) -> None:
        keys = np.asarray(keys, dtype=np.int64)
        if keys.size == 0:
            return
        _, exists = self.lookup(keys, columns=())  # exists-only: skip decode
        if not exists.all():
            raise ValueError("update of non-existing key; use insert()")
        rows = [{n: columns[n][i] for n in self.names} for i in range(keys.size)]
        for k, row in zip(keys.tolist(), rows):
            self._overlay[k] = row
        self._touched_cache = None
        self._note_mutation()

    def _range_keys(self, lo: int, hi: Optional[int]) -> np.ndarray:
        base = self._base_keys_in_range(int(lo), None if hi is None else int(hi))
        if self._deleted:
            dead = np.fromiter(self._deleted, dtype=np.int64, count=len(self._deleted))
            base = base[np.isin(base, dead, invert=True)]
        ovl = [
            k for k in self._overlay if k >= lo and (hi is None or k < hi)
        ]
        if not ovl:
            return base
        # unique: an updated key appears in both base and overlay.
        return np.unique(np.concatenate([base, np.asarray(ovl, dtype=np.int64)]))

    def overlay_rows(self) -> int:
        """Rows currently answered by the overlay (not the partitions)."""
        return len(self._overlay)

    # ---------------------------------------------------------- accounting
    def _overlay_bytes(self) -> int:
        total = 8 * len(self._deleted)
        for row in self._overlay.values():
            total += 8
            for v in row.values():
                if isinstance(v, (str, bytes)):
                    total += len(v)
                else:
                    total += int(np.asarray(v).nbytes)
        return total

    def size_breakdown(self) -> Dict[str, int]:
        out = {
            "partitions": sum(len(p) for p in self._partitions),
            "boundaries": int(self._boundaries.nbytes),
            "overlay": self._overlay_bytes(),
        }
        out.update(self._extra_breakdown())
        return out

    def _extra_breakdown(self) -> Dict[str, int]:
        return {}

    # ---------------------------------------------------------- persistence
    def _extra_state(self) -> Dict:
        return {}

    @classmethod
    def _construct(
        cls, state: Dict, pool: Optional[MemoryPool]
    ) -> "PartitionedBaselineStore":
        raise NotImplementedError

    def save(self, path: str) -> None:
        """One self-describing msgpack file (atomic ``os.replace``,
        fsync before the swap).  v2 wraps the state in a
        ``{"version", "kind", "crc32", "payload"}`` envelope — ``kind``
        stays at top level so ``repro_torch.open`` sniffs without unpacking
        the payload, and the payload crc rejects bit flips at load."""
        ovl_keys = sorted(self._overlay)
        ovl_cols = {
            n: _array_to_state(np.asarray([self._overlay[k][n] for k in ovl_keys]))
            for n in self.names
        } if ovl_keys else {}
        state = {
            "version": BASELINE_FORMAT_VERSION,
            "kind": self.kind,
            "names": list(self.names),
            "codec": self.codec_name,
            "partition_bytes": int(self.partition_bytes),
            "num_rows": int(self.num_rows),
            "boundaries": self._boundaries.tobytes(),
            "partitions": list(self._partitions),
            "overlay_keys": ovl_keys,
            "overlay_cols": ovl_cols,
            "deleted": sorted(self._deleted),
            "extra": self._extra_state(),
        }
        payload = packb(state)
        envelope = packb(
            {
                "version": BASELINE_FORMAT_VERSION,
                "kind": self.kind,
                "crc32": crc32(payload),
                "payload": payload,
            }
        )
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(envelope)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    @classmethod
    def load(
        cls, path: str, pool: Optional[MemoryPool] = None
    ) -> "PartitionedBaselineStore":
        return cls.from_saved_state(_read_baseline_state(path), pool=pool)

    @classmethod
    def from_saved_state(
        cls, state: Dict, pool: Optional[MemoryPool] = None
    ) -> "PartitionedBaselineStore":
        """Restore from an already-unpacked state dict (lets
        ``repro_torch.open`` parse the file exactly once)."""
        if state["version"] > BASELINE_FORMAT_VERSION:
            raise ValueError(f"baseline format {state['version']} newer than reader")
        if state["kind"] != cls.kind:
            raise ValueError(
                f"saved store holds a {state['kind']!r} store, not {cls.kind!r}"
            )
        store = cls._construct(state, pool)
        store._partitions = list(state["partitions"])
        store._boundaries = np.frombuffer(state["boundaries"], dtype=np.int64).copy()
        store.num_rows = int(state["num_rows"])
        store._init_overlay()
        ovl_keys = state["overlay_keys"]
        if ovl_keys:
            cols = {n: _array_from_state(s) for n, s in state["overlay_cols"].items()}
            for i, k in enumerate(ovl_keys):
                store._overlay[int(k)] = {n: cols[n][i] for n in store.names}
        store._deleted = set(int(k) for k in state["deleted"])
        return store


def _read_baseline_state(path: str) -> Dict:
    """Read + verify one baseline file: v2 crc32 envelope (payload crc
    checked, :class:`IntegrityError` on mismatch) or v1 flat state.
    Reads ride the ``artifact_read`` injection site like every other
    persistence format."""
    data = read_artifact(
        os.path.dirname(path) or ".", os.path.basename(path), None
    )
    state = unpack_meta(data, path)
    if not isinstance(state, dict):
        raise ValueError(f"{path!r} is not a recognized baseline store file")
    return state


def load_baseline_store(
    path: str, pool: Optional[MemoryPool] = None
) -> PartitionedBaselineStore:
    """Load a saved AB/HB store, parsing the file exactly once and
    dispatching on its ``kind`` header (used by ``repro_torch.open``)."""
    from repro_torch.baselines.array_store import ArrayStore
    from repro_torch.baselines.hash_store import HashStore

    kinds = {ArrayStore.kind: ArrayStore, HashStore.kind: HashStore}
    state = _read_baseline_state(path)
    if state.get("kind") not in kinds:
        raise ValueError(f"{path!r} is not a recognized baseline store file")
    return kinds[state["kind"]].from_saved_state(state, pool=pool)


def _patch_column(col: np.ndarray, idx: List[int], vals: List[object]) -> np.ndarray:
    """Overwrite ``col[idx] = vals`` with dtype promotion so overlay
    values never truncate (e.g. a longer string than the base column's
    fixed itemsize)."""
    va = np.asarray(vals)
    if col.dtype == object or va.dtype == object:
        col = col.astype(object)
    else:
        if col.dtype.kind == "S" and va.dtype.kind == "U":
            va = np.char.encode(va, "utf-8")
        dt = np.promote_types(col.dtype, va.dtype)
        if dt != col.dtype:
            col = col.astype(dt)
    col = col.copy() if not col.flags.writeable else col
    col[np.asarray(idx, dtype=np.int64)] = va
    return col
