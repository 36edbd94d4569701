"""Tabular container used throughout the DeepMapping stack.

A :class:`Table` is a single-relation, single-key mapping
``R(K, V_1..V_m)`` (paper §III): one integer key column plus ``m``
discrete value columns.  Composite keys are packed into one int64 by the
caller (``pack_composite_key``) — the paper's key "can consist of any
attribute" and does not need to be a unique identifier *per attribute*,
but the packed key must uniquely identify a row.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np


@dataclasses.dataclass
class Table:
    """Column-major tabular data: one int64 key column + value columns.

    ``columns`` values may be any 1-D numpy array of discrete data
    (integers, bytes, numpy strings).  Rows are aligned positionally
    with ``keys``; ``keys`` need not be sorted or dense.
    """

    keys: np.ndarray
    columns: Dict[str, np.ndarray]

    def __post_init__(self) -> None:
        self.keys = np.asarray(self.keys, dtype=np.int64)
        if self.keys.ndim != 1:
            raise ValueError(f"keys must be 1-D, got shape {self.keys.shape}")
        if np.any(self.keys < 0):
            raise ValueError("keys must be non-negative")
        for name, col in self.columns.items():
            col = np.asarray(col)
            if col.shape != self.keys.shape:
                raise ValueError(
                    f"column {name!r} shape {col.shape} != keys {self.keys.shape}"
                )
            self.columns[name] = col
        if len(np.unique(self.keys)) != len(self.keys):
            raise ValueError("keys must uniquely identify rows")

    # -- basic accessors ---------------------------------------------------
    @property
    def num_rows(self) -> int:
        return int(self.keys.shape[0])

    @property
    def value_names(self) -> Sequence[str]:
        return list(self.columns.keys())

    @property
    def max_key(self) -> int:
        return int(self.keys.max()) if self.num_rows else 0

    def sorted_by_key(self) -> "Table":
        order = np.argsort(self.keys, kind="stable")
        return Table(
            keys=self.keys[order],
            columns={k: v[order] for k, v in self.columns.items()},
        )

    def row(self, i: int) -> Dict[str, object]:
        return {k: v[i] for k, v in self.columns.items()}

    def raw_size_bytes(self) -> int:
        """Uncompressed size — the denominator of the paper's Eq. 1."""
        total = self.keys.nbytes
        for col in self.columns.values():
            if col.dtype == object:
                total += int(sum(len(x) for x in col))
            else:
                total += col.nbytes
        return total

    def take(self, idx: np.ndarray) -> "Table":
        return Table(
            keys=self.keys[idx],
            columns={k: v[idx] for k, v in self.columns.items()},
        )

    def concat(self, other: "Table") -> "Table":
        if set(other.columns) != set(self.columns):
            raise ValueError("column mismatch in concat")
        return Table(
            keys=np.concatenate([self.keys, other.keys]),
            columns={
                k: np.concatenate([self.columns[k], other.columns[k]])
                for k in self.columns
            },
        )


def pack_composite_key(parts: Sequence[np.ndarray]) -> np.ndarray:
    """Pack several non-negative integer key attributes into one int64.

    Uses mixed-radix packing with per-attribute radix ``max+1``.  Raises
    if the packed domain would overflow int64 — at that point the caller
    should hash or re-map the key domain instead.
    """
    parts = [np.asarray(p, dtype=np.int64) for p in parts]
    if not parts:
        raise ValueError("need at least one key attribute")
    radices = [int(p.max()) + 1 for p in parts]
    total_bits = float(np.sum(np.log2(np.maximum(radices, 2))))
    if total_bits > 62:
        raise ValueError(
            f"composite key domain needs {total_bits:.1f} bits > 62; "
            "re-map key attributes first"
        )
    packed = np.zeros_like(parts[0])
    for p, r in zip(parts, radices):
        if np.any(p < 0):
            raise ValueError("key attributes must be non-negative")
        packed = packed * r + p
    return packed
