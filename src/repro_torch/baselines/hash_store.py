"""Hash-based baseline (paper's HB / HBC-*).

Each range partition is a Python dict ``{key: (v1, .., vm)}`` serialized
with pickle — exactly the paper's implementation ("each partition is a
serialized hash table", "state-of-the-art Pickle library"), which is
what makes HB's deserialization cost dominate under memory pressure
(paper §V-C).  Pickle here is confined to benchmark baselines on data we
generate ourselves.

Modifications (insert/delete/update) and persistence come from
:class:`~repro_torch.baselines.partitioned.PartitionedBaselineStore`: the
partitions stay immutable, an overlay patches lookups.

A copy of ``repro.baselines.hash_store``: host code (pickle), with no
device, as in the reference.
"""

from __future__ import annotations

import pickle
from typing import Dict, List, Optional

import numpy as np

from repro_torch.baselines.partitioned import PartitionedBaselineStore
from repro_torch.core.table import Table
from repro_torch.storage import MemoryPool, get_codec


class HashStore(PartitionedBaselineStore):
    """HB (codec='none'), HBC-Z, HBC-L."""

    kind = "hash_store"

    def __init__(self, names, codec: str, partition_bytes: int, pool: Optional[MemoryPool]):
        self.names = list(names)
        self.codec_name = codec
        self._codec = get_codec(codec)
        self.partition_bytes = partition_bytes
        self.pool = pool if pool is not None else MemoryPool(1 << 30)
        self._partitions: list[bytes] = []
        self._boundaries = np.zeros(0, dtype=np.int64)
        self.num_rows = 0
        self._init_overlay()

    @classmethod
    def build(
        cls,
        table: Table,
        codec: str = "none",
        partition_bytes: int = 128 * 1024,
        pool: Optional[MemoryPool] = None,
    ) -> "HashStore":
        store = cls(table.value_names, codec, partition_bytes, pool)
        t = table.sorted_by_key()
        # Hash tables have higher per-row overhead than arrays (paper: HB is
        # ~1.5-3x larger than AB); rows-per-partition follows the raw row size.
        row_bytes = 8 + sum(
            (c.dtype.itemsize if c.dtype != object else 24) for c in t.columns.values()
        )
        rows_per_part = max(1, partition_bytes // row_bytes)
        names = sorted(t.value_names)
        bounds = []
        for start in range(0, t.num_rows, rows_per_part):
            k = t.keys[start : start + rows_per_part]
            d = {}
            colarrs = [t.columns[n][start : start + rows_per_part] for n in names]
            for i, key in enumerate(k.tolist()):
                d[key] = tuple(c[i] for c in colarrs)
            blob = pickle.dumps(d, protocol=pickle.HIGHEST_PROTOCOL)
            store._partitions.append(store._codec.compress(blob))
            bounds.append(int(k[0]))
        store._boundaries = np.asarray(bounds, dtype=np.int64)
        store.num_rows = t.num_rows
        return store

    def _load(self, idx: int) -> dict:
        def loader():
            blob = self._codec.decompress(self._partitions[idx])
            d = pickle.loads(blob)
            # dict memory estimate: key + tuple + per-elem boxes
            nbytes = len(blob) * 3 + 64 * len(d)
            return d, nbytes

        return self.pool.get(("hb", id(self), idx), loader)

    def _base_lookup(self, keys: np.ndarray, wanted: List[str]):
        names = sorted(self.names)
        # Exists-only probes (mutation validation, predicate-only
        # columns=() requests) skip row materialization entirely.
        col_idx = [names.index(name) for name in wanted]
        n = keys.shape[0]
        exists = np.zeros(n, dtype=bool)
        rows: list = [None] * n if wanted else []
        if len(self._partitions):
            pid = np.searchsorted(self._boundaries, keys, side="right") - 1
            order = np.argsort(pid, kind="stable")
            start = 0
            while start < n:
                end = start
                p = pid[order[start]]
                while end < n and pid[order[end]] == p:
                    end += 1
                if p >= 0:
                    d = self._load(int(p))
                    if wanted:
                        for qi in order[start:end]:
                            row = d.get(int(keys[qi]))
                            if row is not None:
                                exists[qi] = True
                                rows[qi] = row
                    else:
                        for qi in order[start:end]:
                            if int(keys[qi]) in d:
                                exists[qi] = True
                start = end
        out: Dict[str, np.ndarray] = {}
        for name, ci in zip(wanted, col_idx):
            vals = [r[ci] if r is not None else 0 for r in rows]
            out[name] = np.asarray(vals)
        return out, exists

    @classmethod
    def _construct(cls, state: Dict, pool: Optional[MemoryPool]) -> "HashStore":
        return cls(state["names"], state["codec"], state["partition_bytes"], pool)

    def _base_keys_in_range(self, lo: int, hi: Optional[int]) -> np.ndarray:
        first, last = self._partition_span(lo, hi)
        parts = []
        for p in range(first, last + 1):
            d = self._load(p)
            ks = np.fromiter(d.keys(), dtype=np.int64, count=len(d))
            mask = ks >= lo
            if hi is not None:
                mask &= ks < hi
            sel = ks[mask]
            if sel.size:
                parts.append(np.sort(sel))
        return np.concatenate(parts) if parts else np.zeros(0, dtype=np.int64)
