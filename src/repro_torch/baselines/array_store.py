"""Array-based baseline (paper's AB / ABC-*).

The table is sorted by key and split into fixed-row partitions.  Each
partition serializes ``keys`` + per-column value arrays into one buffer
(numpy raw bytes with a tiny header — the paper's "serialized numpy
array"), optionally dictionary-encodes values first (ABC-D) and/or
compresses the buffer (ABC-G/Z/L).  Lookup binary-searches boundary
keys for the partition, loads/decompresses it through the shared memory
pool, then binary-searches inside (the paper's stated lookup cost).

Modifications (insert/delete/update) and persistence come from
:class:`~repro_torch.baselines.partitioned.PartitionedBaselineStore`: the
partitions stay immutable, an overlay patches lookups.

A copy of ``repro.baselines.array_store``: host code (numpy), with no
device, as in the reference.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.baselines.partitioned import (
    PartitionedBaselineStore,
    _array_from_state,
    _array_to_state,
)
from repro_torch.core.encoding import ValueCodec
from repro_torch.core.table import Table
from repro_torch.storage import MemoryPool, get_codec


def _pack_arrays(keys: np.ndarray, cols: Dict[str, np.ndarray]) -> bytes:
    """Self-describing buffer: [n, ncols] + keys + per-col (dtype tag, data)."""
    parts = [np.array([keys.shape[0], len(cols)], dtype=np.int64).tobytes()]
    parts.append(keys.tobytes())
    for name in sorted(cols):
        arr = cols[name]
        dt = arr.dtype.str.encode()
        parts.append(np.array([len(dt), arr.nbytes], dtype=np.int64).tobytes())
        parts.append(dt)
        parts.append(arr.tobytes())
    return b"".join(parts)


def _unpack_arrays(blob: bytes, names) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    n, ncols = np.frombuffer(blob[:16], dtype=np.int64)
    n, ncols = int(n), int(ncols)
    off = 16
    keys = np.frombuffer(blob[off : off + 8 * n], dtype=np.int64)
    off += 8 * n
    cols: Dict[str, np.ndarray] = {}
    for name in sorted(names):
        dtlen, nbytes = np.frombuffer(blob[off : off + 16], dtype=np.int64)
        off += 16
        dt = blob[off : off + int(dtlen)].decode()
        off += int(dtlen)
        cols[name] = np.frombuffer(blob[off : off + int(nbytes)], dtype=np.dtype(dt))
        off += int(nbytes)
    return keys, cols


class ArrayStore(PartitionedBaselineStore):
    """AB (codec='none'), ABC-D (dictionary=True), ABC-G/Z/L."""

    kind = "array_store"

    def __init__(
        self,
        names,
        codec: str,
        dictionary: bool,
        partition_bytes: int,
        pool: Optional[MemoryPool],
    ):
        self.names = list(names)
        self.codec_name = codec
        self._codec = get_codec(codec)
        self.dictionary = dictionary
        self.partition_bytes = partition_bytes
        self.pool = pool if pool is not None else MemoryPool(1 << 30)
        self._partitions: list[bytes] = []
        self._boundaries = np.zeros(0, dtype=np.int64)
        self._decoders: Dict[str, ValueCodec] = {}
        # Lazy per-column zone maps over the immutable partitions
        # (dictionary mode only) — the partition-pruning evidence.
        self._zone_maps: Dict[str, np.ndarray] = {}
        self.num_rows = 0
        self._init_overlay()

    @classmethod
    def build(
        cls,
        table: Table,
        codec: str = "none",
        dictionary: bool = False,
        partition_bytes: int = 4 * 1024 * 1024,
        pool: Optional[MemoryPool] = None,
    ) -> "ArrayStore":
        store = cls(table.value_names, codec, dictionary, partition_bytes, pool)
        t = table.sorted_by_key()
        cols: Dict[str, np.ndarray] = {}
        for name in t.value_names:
            col = t.columns[name]
            if dictionary or col.dtype == object:
                vc = ValueCodec(name, col)
                store._decoders[name] = vc
                # smallest int dtype that fits the cardinality
                dt = np.uint8 if vc.cardinality <= 256 else (
                    np.uint16 if vc.cardinality <= 65536 else np.int32
                )
                cols[name] = vc.codes.astype(dt) if dictionary else col
                if not dictionary:
                    # object columns must still be encodable to raw bytes:
                    cols[name] = np.char.encode(col.astype(str), "utf-8").astype("S")
            else:
                cols[name] = col
        row_bytes = 8 + sum(
            (c.dtype.itemsize if c.dtype != object else 16) for c in cols.values()
        )
        rows_per_part = max(1, partition_bytes // row_bytes)
        bounds = []
        for start in range(0, t.num_rows, rows_per_part):
            k = t.keys[start : start + rows_per_part]
            pc = {n: c[start : start + rows_per_part] for n, c in cols.items()}
            store._partitions.append(store._codec.compress(_pack_arrays(k, pc)))
            bounds.append(int(k[0]))
        store._boundaries = np.asarray(bounds, dtype=np.int64)
        store.num_rows = t.num_rows
        return store

    def _load(self, idx: int):
        def loader():
            blob = self._codec.decompress(self._partitions[idx])
            part = _unpack_arrays(blob, self.names)
            nbytes = part[0].nbytes + sum(c.nbytes for c in part[1].values())
            return part, nbytes

        return self.pool.get(("ab", id(self), idx), loader)

    def _base_lookup(self, keys: np.ndarray, wanted: List[str]):
        n = keys.shape[0]
        exists = np.zeros(n, dtype=bool)
        out: Dict[str, np.ndarray] = {}
        gathered = {name: [] for name in wanted}
        # Hit bookkeeping only pays off when values must be gathered;
        # exists-only probes (mutation validation, predicate-only
        # requests) skip it.
        gathered_idx = [] if wanted else None
        if self._partitions:
            pid = np.searchsorted(self._boundaries, keys, side="right") - 1
            order = np.argsort(pid, kind="stable")
            start = 0
            while start < n:
                end = start
                p = pid[order[start]]
                while end < n and pid[order[end]] == p:
                    end += 1
                if p >= 0:
                    pkeys, pcols = self._load(int(p))
                    qidx = order[start:end]
                    qk = keys[qidx]
                    pos = np.searchsorted(pkeys, qk)
                    hit = (pos < pkeys.shape[0]) & (
                        pkeys[np.minimum(pos, pkeys.shape[0] - 1)] == qk
                    )
                    sel = qidx[hit]
                    exists[sel] = True
                    if gathered_idx is not None:
                        gathered_idx.append(sel)
                        for name in wanted:
                            gathered[name].append(pcols[name][pos[hit]])
                start = end
        idx = (
            np.concatenate(gathered_idx)
            if gathered_idx
            else np.zeros(0, dtype=np.int64)
        )
        for name in wanted:
            vals = (
                np.concatenate(gathered[name])
                if gathered[name]
                else np.zeros(0, dtype=np.int64)
            )
            if self.dictionary and name in self._decoders:
                decoded_hits = self._decoders[name].decode(vals)
            else:
                decoded_hits = vals
            col = np.zeros(n, dtype=decoded_hits.dtype if decoded_hits.size else np.int64)
            if idx.size:
                col[idx] = decoded_hits
            out[name] = col
        return out, exists

    # ----------------------------------------------------- pruning hooks
    def _column_decoder(self, column: str) -> Optional[ValueCodec]:
        """Dictionary-mode columns expose their codec for zone-map
        pruning; raw-value columns return ``None``."""
        if not self.dictionary:
            return None
        return self._decoders.get(column)

    # Memo of immutable derived data (see docstring) — a zone-map build
    # is not a logical store mutation and must NOT bump the PlanCache.
    # deeplint: ignore[mutation-version]
    def _partition_code_presence(self, column: str) -> Optional[np.ndarray]:
        """Lazy zone map: bool ``(num_partitions, cardinality)`` of the
        codes present in each partition (dictionary mode only).  Built
        once per column by one pass over the partitions — the same
        pool-cached loads a first scan pays anyway — and valid forever
        (base partitions are immutable; overlay rows are handled by the
        pruning path's touched-key exclusion)."""
        if self._column_decoder(column) is None:
            return None
        zone = self._zone_maps.get(column)
        if zone is None:
            cardinality = self._decoders[column].cardinality
            zone = np.zeros((len(self._partitions), cardinality), dtype=bool)
            for pidx in range(len(self._partitions)):
                _, pcols = self._load(pidx)
                codes = np.unique(np.asarray(pcols[column], dtype=np.int64))
                zone[pidx, codes] = True
            self._zone_maps[column] = zone
        return zone

    def _base_keys_in_range(self, lo: int, hi: Optional[int]) -> np.ndarray:
        first, last = self._partition_span(lo, hi)
        parts = []
        for p in range(first, last + 1):
            pkeys, _ = self._load(p)
            a = int(np.searchsorted(pkeys, lo, side="left"))
            b = pkeys.shape[0] if hi is None else int(np.searchsorted(pkeys, hi, side="left"))
            if b > a:
                parts.append(np.asarray(pkeys[a:b], dtype=np.int64))
        return np.concatenate(parts) if parts else np.zeros(0, dtype=np.int64)

    # ---------------------------------------------------------- accounting
    def _extra_breakdown(self) -> Dict[str, int]:
        return {"decode_map": sum(vc.size_bytes() for vc in self._decoders.values())}

    # ---------------------------------------------------------- persistence
    def _extra_state(self) -> Dict:
        state = {
            "dictionary": self.dictionary,
            "decoders": {
                name: _array_to_state(vc.decode_map)
                for name, vc in self._decoders.items()
            },
        }
        if self._zone_maps:
            # Persist whichever zone maps are already built (bit-packed:
            # a map is bool (partitions, cardinality)) so a loaded store
            # prunes from the first predicated scan without re-reading
            # every partition.  They ride the v2 envelope, so the crc
            # covers them like every other field.
            state["zone_maps"] = {
                name: {
                    "partitions": int(zone.shape[0]),
                    "cardinality": int(zone.shape[1]),
                    "bits": np.packbits(zone, axis=None).tobytes(),
                }
                for name, zone in self._zone_maps.items()
            }
        return state

    @classmethod
    def _construct(cls, state: Dict, pool: Optional[MemoryPool]) -> "ArrayStore":
        store = cls(
            state["names"],
            state["codec"],
            state["extra"]["dictionary"],
            state["partition_bytes"],
            pool,
        )
        for name, dm_state in state["extra"]["decoders"].items():
            store._decoders[name] = ValueCodec.from_decode_map(
                name, _array_from_state(dm_state)
            )
        n_parts = len(state["partitions"])
        for name, zm in state["extra"].get("zone_maps", {}).items():
            # A stale or malformed map (unknown column, partition count
            # or cardinality drift, truncated bits) is silently dropped:
            # the lazy build in ``_partition_code_presence`` regenerates
            # it, so pruning degrades to a first-scan rebuild instead of
            # a load failure.
            vc = store._decoders.get(name)
            rows, card = int(zm["partitions"]), int(zm["cardinality"])
            if vc is None or rows != n_parts or card != vc.cardinality:
                continue
            bits = np.frombuffer(zm["bits"], dtype=np.uint8)
            if bits.size * 8 < rows * card:
                continue
            store._zone_maps[name] = (
                np.unpackbits(bits, count=rows * card)
                .reshape(rows, card)
                .astype(bool)
            )
        return store
