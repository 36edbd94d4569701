"""Auxiliary accuracy-assurance table ``T_aux`` (paper §IV-B1).

Misclassified key-value pairs are sorted by key, range-partitioned, and
each partition is compressed (Z-Standard or LZMA).  Lookup locates the
partition by binary search over partition-boundary keys, decompresses it
through the shared LRU :class:`~repro_torch.storage.pool.MemoryPool`, and
binary-searches inside.  We NEVER re-key (paper's emphasis) — original
key order is preserved.

Modifications (Algorithms 3–5) land in a sorted in-memory delta overlay
(inserts/updates) and a tombstone set (deletes of rows that live in
compacted partitions); ``compact()`` folds both back into partitions.
The delta is charged to Eq. 1 at its *compressed serialized* size, i.e.
exactly what a flush would cost on disk.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.storage import MemoryPool, get_codec

_EMPTY_I64 = np.zeros(0, dtype=np.int64)


def _pack_partition(keys: np.ndarray, codes: np.ndarray) -> bytes:
    n, m = codes.shape
    header = np.array([n, m], dtype=np.int64).tobytes()
    return header + keys.astype(np.int64).tobytes() + codes.astype(np.int32).tobytes()


def _unpack_partition(blob: bytes) -> Tuple[np.ndarray, np.ndarray]:
    n, m = np.frombuffer(blob[:16], dtype=np.int64)
    n, m = int(n), int(m)
    keys = np.frombuffer(blob[16 : 16 + 8 * n], dtype=np.int64)
    codes = np.frombuffer(blob[16 + 8 * n :], dtype=np.int32).reshape(n, m)
    return keys, codes


class AuxTable:
    """Sorted / partitioned / compressed misclassified-row store."""

    def __init__(
        self,
        num_values: int,
        codec: str = "zstd",
        partition_bytes: int = 128 * 1024,
        pool: Optional[MemoryPool] = None,
    ):
        self.num_values = int(num_values)
        self.codec_name = codec
        self._codec = get_codec(codec)
        self.partition_bytes = int(partition_bytes)
        self.pool = pool if pool is not None else MemoryPool(1 << 30)
        # Immutable compacted state.
        self._partitions: list[bytes] = []
        self._boundaries = _EMPTY_I64  # first key of each partition
        self._part_rows: list[int] = []
        self._compacted_rows = 0
        # Mutable overlay.
        self._delta: Dict[int, np.ndarray] = {}
        self._tombstones: set[int] = set()
        self._delta_size_cache: Optional[int] = None
        self._generation = 0  # pool-key namespace; bumped by compact()

    # -- construction --------------------------------------------------------
    @classmethod
    def build(
        cls,
        keys: np.ndarray,
        codes: np.ndarray,
        codec: str = "zstd",
        partition_bytes: int = 128 * 1024,
        pool: Optional[MemoryPool] = None,
    ) -> "AuxTable":
        keys = np.asarray(keys, dtype=np.int64)
        codes = np.asarray(codes, dtype=np.int32)
        if codes.ndim != 2 or codes.shape[0] != keys.shape[0]:
            raise ValueError("codes must be (n, m) aligned with keys")
        t = cls(codes.shape[1], codec, partition_bytes, pool)
        t._rebuild(keys, codes)
        return t

    def _rebuild(self, keys: np.ndarray, codes: np.ndarray) -> None:
        order = np.argsort(keys, kind="stable")
        keys, codes = keys[order], codes[order]
        row_bytes = 8 + 4 * self.num_values
        rows_per_part = max(1, self.partition_bytes // row_bytes)
        self._partitions, self._part_rows, bounds = [], [], []
        for start in range(0, keys.shape[0], rows_per_part):
            k = keys[start : start + rows_per_part]
            c = codes[start : start + rows_per_part]
            self._partitions.append(self._codec.compress(_pack_partition(k, c)))
            self._part_rows.append(int(k.shape[0]))
            bounds.append(int(k[0]))
        self._boundaries = np.asarray(bounds, dtype=np.int64)
        self._compacted_rows = int(keys.shape[0])
        self._generation += 1

    # -- partition access ------------------------------------------------------
    def _load_partition(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        def loader():
            blob = self._codec.decompress(self._partitions[idx])
            part = _unpack_partition(blob)
            return part, part[0].nbytes + part[1].nbytes

        return self.pool.get(("aux", id(self), self._generation, idx), loader)

    # -- batched lookup ----------------------------------------------------------
    def get(self, keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Batched aux lookup.

        Returns ``(found_mask (n,) bool, codes (n, m) int32)``; rows not
        present in T_aux have arbitrary codes and found=False.  Queries
        are grouped per partition so each partition is decompressed at
        most once per batch (paper §IV-B2).
        """
        keys = np.asarray(keys, dtype=np.int64)
        n = keys.shape[0]
        found = np.zeros(n, dtype=bool)
        out = np.zeros((n, self.num_values), dtype=np.int32)
        if n == 0:
            return found, out

        # Overlay first: delta wins over partitions; tombstones kill rows.
        if self._delta:
            for i, k in enumerate(keys.tolist()):
                row = self._delta.get(k)
                if row is not None:
                    found[i] = True
                    out[i] = row
        tomb = self._tombstones

        remaining = np.flatnonzero(~found)
        if remaining.size and self._partitions:
            rkeys = keys[remaining]
            pid = np.searchsorted(self._boundaries, rkeys, side="right") - 1
            valid = pid >= 0
            order = np.argsort(pid[valid], kind="stable")
            ridx = remaining[valid][order]
            rpid = pid[valid][order]
            start = 0
            while start < ridx.size:
                end = start
                p = rpid[start]
                while end < ridx.size and rpid[end] == p:
                    end += 1
                pkeys, pcodes = self._load_partition(int(p))
                qk = keys[ridx[start:end]]
                pos = np.searchsorted(pkeys, qk)
                hit = (pos < pkeys.shape[0]) & (pkeys[np.minimum(pos, pkeys.shape[0] - 1)] == qk)
                if tomb:
                    hit &= ~np.isin(qk, np.fromiter(tomb, dtype=np.int64, count=len(tomb)))
                sel = ridx[start:end][hit]
                found[sel] = True
                out[sel] = pcodes[pos[hit]]
                start = end
        return found, out

    def contains(self, keys: np.ndarray) -> np.ndarray:
        return self.get(keys)[0]

    # -- modification overlay (Algorithms 3-5) ------------------------------------
    def add(self, keys: np.ndarray, codes: np.ndarray) -> None:
        keys = np.asarray(keys, dtype=np.int64)
        codes = np.asarray(codes, dtype=np.int32)
        for k, row in zip(keys.tolist(), codes):
            self._delta[k] = row.copy()
            self._tombstones.discard(k)
        self._delta_size_cache = None

    def remove(self, keys: np.ndarray) -> None:
        keys = np.asarray(keys, dtype=np.int64)
        for k in keys.tolist():
            self._delta.pop(k, None)
            self._tombstones.add(k)
        self._delta_size_cache = None

    def update(self, keys: np.ndarray, codes: np.ndarray) -> None:
        # Same mechanics as add: delta overrides compacted partitions.
        self.add(keys, codes)

    def compact(self) -> None:
        """Fold delta + tombstones into fresh sorted compressed partitions."""
        all_keys, all_codes = [], []
        for idx in range(len(self._partitions)):
            k, c = self._load_partition(idx)
            all_keys.append(k)
            all_codes.append(c)
        keys = np.concatenate(all_keys) if all_keys else _EMPTY_I64
        codes = (
            np.concatenate(all_codes)
            if all_codes
            else np.zeros((0, self.num_values), dtype=np.int32)
        )
        if self._tombstones or self._delta:
            drop = np.fromiter(
                set(self._tombstones) | set(self._delta), dtype=np.int64
            )
            keep = ~np.isin(keys, drop)
            keys, codes = keys[keep], codes[keep]
        if self._delta:
            dkeys = np.fromiter(self._delta.keys(), dtype=np.int64, count=len(self._delta))
            dcodes = np.stack([self._delta[int(k)] for k in dkeys]).astype(np.int32)
            keys = np.concatenate([keys, dkeys])
            codes = np.concatenate([codes, dcodes])
        self._delta.clear()
        self._tombstones.clear()
        self._delta_size_cache = None
        self._rebuild(keys, codes)

    # -- accounting ---------------------------------------------------------------
    @property
    def num_rows(self) -> int:
        # Callers (Algorithm 4) only tombstone keys actually present, so this
        # is exact under the documented contract; used for retrain triggering.
        return max(0, self._compacted_rows + len(self._delta) - len(self._tombstones))

    def _delta_bytes(self) -> int:
        if self._delta_size_cache is None:
            if not self._delta and not self._tombstones:
                self._delta_size_cache = 0
            else:
                dkeys = np.fromiter(
                    self._delta.keys(), dtype=np.int64, count=len(self._delta)
                )
                dcodes = (
                    np.stack([self._delta[int(k)] for k in dkeys]).astype(np.int32)
                    if self._delta
                    else np.zeros((0, self.num_values), dtype=np.int32)
                )
                blob = _pack_partition(dkeys, dcodes)
                blob += np.fromiter(
                    self._tombstones, dtype=np.int64, count=len(self._tombstones)
                ).tobytes()
                self._delta_size_cache = len(self._codec.compress(blob))
        return self._delta_size_cache

    def size_bytes(self) -> int:
        """Compressed at-rest size — the Eq. 1 contribution."""
        return (
            sum(len(p) for p in self._partitions)
            + self._boundaries.nbytes
            + self._delta_bytes()
        )

    # -- serialization --------------------------------------------------------------
    def to_state(self) -> dict:
        self.compact()
        return {
            "codec": self.codec_name,
            "partition_bytes": self.partition_bytes,
            "num_values": self.num_values,
            "partitions": list(self._partitions),
            "boundaries": self._boundaries.copy(),
            "part_rows": list(self._part_rows),
            "rows": self._compacted_rows,
        }

    @classmethod
    def from_state(cls, state: dict, pool: Optional[MemoryPool] = None) -> "AuxTable":
        t = cls(
            state["num_values"],
            state["codec"],
            state["partition_bytes"],
            pool,
        )
        t._partitions = list(state["partitions"])
        t._boundaries = np.asarray(state["boundaries"], dtype=np.int64)
        t._part_rows = list(state["part_rows"])
        t._compacted_rows = int(state["rows"])
        return t
