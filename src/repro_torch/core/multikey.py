"""Paper §III problem variants beyond single-key:

* **Single-Relation, Multiple-Key** — the workload looks up the same
  relation through different key columns; each key choice gets its own
  hybrid structure over the remaining columns (mappings need not be
  unique per key value — the paper's key "does not need to be a unique
  identifier", so non-key-unique groups are disambiguated by packing the
  row's disambiguator in, or rejected with a clear error).
* **Multiple-Relation, Multiple-Key** — star-schema cross-table lookups:
  a fact row's foreign-key attribute references a dimension relation;
  ``RelationGraph.lookup_through`` chains two hybrid lookups (fact ->
  fk value -> dimension row), each batched through Algorithm 1.

The port of ``repro.core.multikey``: the same packing, checks and
answers, over the port's :class:`DeepMappingStore`.  Every store is
built on the caller's ``device`` (CUDA by default).  A key choice whose
packed domain fits int32 serves through the fused lookup kernel (K1);
a wider one takes the engine's host-digits tier, the fused MLP kernel
(K2), with the existence test on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.encoding import ValueCodec
from repro_torch.core.hybrid import DeepMappingConfig, DeepMappingStore
from repro_torch.core.table import Table
from repro_torch.device import DeviceLike


def _pack_with_radices(parts: Sequence[np.ndarray], radices: Sequence[int]) -> np.ndarray:
    """Mixed-radix packing with radices FIXED at build time (the query
    batch's maxima must not change the packing)."""
    total_bits = float(np.sum(np.log2(np.maximum(radices, 2))))
    if total_bits > 62:
        raise ValueError(f"composite key domain needs {total_bits:.1f} bits > 62")
    packed = np.zeros_like(np.asarray(parts[0], dtype=np.int64))
    for p, r in zip(parts, radices):
        packed = packed * r + np.asarray(p, dtype=np.int64)
    return packed


class MultiKeyMapping:
    """Several DeepMapping structures over ONE relation, keyed by
    different column subsets (paper: Single-Relation, Multiple-Key)."""

    def __init__(self, stores: Dict[Tuple[str, ...], DeepMappingStore],
                 key_codecs: Dict[Tuple[str, ...], list],
                 key_radices: Dict[Tuple[str, ...], list]):
        self._stores = stores
        self._key_codecs = key_codecs
        self._key_radices = key_radices  # packing radices FIXED at build

    @classmethod
    def build(
        cls,
        table: Table,
        key_choices: Sequence[Sequence[str]],
        config: DeepMappingConfig = DeepMappingConfig(),
        verbose: bool = False,
        device: DeviceLike = None,
    ) -> "MultiKeyMapping":
        base_cols = dict(table.columns)
        base_cols["__key__"] = table.keys  # the original key is lookupable too
        stores, key_codecs, key_radices = {}, {}, {}
        for choice in key_choices:
            choice = tuple(choice)
            for c in choice:
                if c not in base_cols:
                    raise KeyError(f"unknown key column {c!r}")
            parts, codecs = [], []
            for c in choice:
                col = np.asarray(base_cols[c])
                if col.dtype.kind in "iu" and (col.size == 0 or col.min() >= 0):
                    parts.append(col.astype(np.int64))
                    codecs.append(None)
                else:
                    vc = ValueCodec(c, col)
                    parts.append(vc.codes.astype(np.int64))
                    codecs.append(vc)
            radices = [int(p.max()) + 1 for p in parts]
            packed = _pack_with_radices(parts, radices)
            if len(np.unique(packed)) != len(packed):
                raise ValueError(
                    f"key choice {choice} does not uniquely identify rows"
                )
            values = {
                name: col for name, col in base_cols.items()
                if name not in choice and name != "__key__"
            }
            sub = Table(keys=packed, columns=values)
            stores[choice] = DeepMappingStore.build(
                sub, config, verbose=verbose, device=device
            )
            key_codecs[choice] = codecs
            key_radices[choice] = radices
        return cls(stores, key_codecs, key_radices)

    @property
    def key_choices(self) -> List[Tuple[str, ...]]:
        return list(self._stores)

    def lookup(
        self,
        key_columns: Sequence[str],
        key_values: Sequence[np.ndarray],
        columns: Optional[Tuple[str, ...]] = None,
    ):
        choice = tuple(key_columns)
        store = self._stores[choice]
        codecs = self._key_codecs[choice]
        radices = self._key_radices[choice]
        parts = []
        valid = None
        for col, vc, r in zip(key_values, codecs, radices):
            col = np.asarray(col)
            if vc is None:
                part = col.astype(np.int64)
                ok = (part >= 0) & (part < r)
            else:
                part, ok = vc.encode(col)
                ok &= (part >= 0) & (part < r)
            parts.append(np.clip(part, 0, r - 1))
            valid = ok if valid is None else (valid & ok)
        packed = _pack_with_radices(parts, radices)
        vals, exists = store.lookup(packed, columns)
        return vals, exists & valid

    def size_bytes(self) -> int:
        return sum(s.size_bytes() for s in self._stores.values())


@dataclasses.dataclass
class _Relation:
    store: DeepMappingStore
    table: Table


class RelationGraph:
    """Star-schema mappings: fact tables referencing dimension tables
    (paper: Multiple-Relation, Multiple-Key)."""

    def __init__(self):
        self._relations: Dict[str, _Relation] = {}
        self._fks: Dict[Tuple[str, str], str] = {}  # (relation, column) -> target

    def add_relation(
        self, name: str, table: Table,
        config: DeepMappingConfig = DeepMappingConfig(),
        store: Optional[DeepMappingStore] = None,
        device: DeviceLike = None,
    ) -> None:
        self._relations[name] = _Relation(
            store=store or DeepMappingStore.build(table, config, device=device),
            table=table,
        )

    def add_foreign_key(self, relation: str, column: str, references: str) -> None:
        for r in (relation, references):
            if r not in self._relations:
                raise KeyError(f"unknown relation {r!r}")
        self._fks[(relation, column)] = references

    def lookup(self, relation: str, keys: np.ndarray, columns=None):
        return self._relations[relation].store.lookup(keys, columns)

    def lookup_through(
        self,
        relation: str,
        keys: np.ndarray,
        fk_column: str,
        columns: Optional[Tuple[str, ...]] = None,
    ):
        """Cross-table: fact keys -> fk values -> dimension columns.
        Both hops are batched Algorithm-1 lookups."""
        target = self._fks[(relation, fk_column)]
        fk_vals, fact_exists = self._relations[relation].store.lookup(
            keys, columns=(fk_column,)
        )
        fk_keys = np.asarray(fk_vals[fk_column], dtype=np.int64)
        dim_vals, dim_exists = self._relations[target].store.lookup(
            np.where(fact_exists, fk_keys, 0), columns
        )
        return dim_vals, fact_exists & dim_exists

    def size_bytes(self) -> int:
        return sum(r.store.size_bytes() for r in self._relations.values())
