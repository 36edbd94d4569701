"""Synthetic datasets with controlled key-value correlation (paper §V-A1).

A copy of ``repro.data.datasets`` (numpy only).

* ``synthetic_*_column(correlation="low")``  — values independent of the
  key (Pearson ~1e-4), like the paper's <OrderKey, OrderStatus> sample
  from TPC-H Orders.
* ``synthetic_*_column(correlation="high")`` — values are periodic
  functions of the key with a small noise fraction, like TPC-DS
  Customer_Demographics (Pearson ~0.12, "periodical patterns along the
  key-dimension").
* ``cropland_like`` — spatially-autocorrelated grid of crop categories
  (CroplandCROS §V-A1): patches generated from a coarse random field.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.table import Table, pack_composite_key


def synthetic_single_column(
    n: int = 100_000,
    correlation: str = "low",
    cardinality: int = 3,
    noise: float = 0.01,
    seed: int = 0,
) -> Table:
    rng = np.random.default_rng(seed)
    keys = np.arange(n, dtype=np.int64)
    if correlation == "low":
        col = rng.integers(0, cardinality, size=n).astype(np.int32)
    elif correlation == "high":
        period = max(2, n // (cardinality * 64))
        col = ((keys // period) % cardinality).astype(np.int32)
        flip = rng.random(n) < noise
        col[flip] = rng.integers(0, cardinality, size=int(flip.sum()))
    else:
        raise ValueError(correlation)
    return Table(keys=keys, columns={"value": col})


def synthetic_multi_column(
    n: int = 100_000,
    correlation: str = "low",
    cardinalities=(3, 2, 7, 5),
    noise: float = 0.01,
    seed: int = 0,
) -> Table:
    rng = np.random.default_rng(seed)
    keys = np.arange(n, dtype=np.int64)
    cols = {}
    for i, c in enumerate(cardinalities):
        if correlation == "low":
            cols[f"v{i}"] = rng.integers(0, c, size=n).astype(np.int32)
        elif correlation == "high":
            period = max(2, (n // (c * 32)) * (i + 1))
            col = ((keys // period + i) % c).astype(np.int32)
            flip = rng.random(n) < noise
            col[flip] = rng.integers(0, c, size=int(flip.sum()))
            cols[f"v{i}"] = col
        else:
            raise ValueError(correlation)
    return Table(keys=keys, columns=cols)


def cropland_like(
    rows: int = 256,
    cols: int = 256,
    num_crops: int = 12,
    patch: int = 16,
    noise: float = 0.02,
    seed: int = 0,
) -> Table:
    """Image-like crop map: coarse random field upsampled into patches —
    strong spatial correlation, pixel key = packed (lat, lon)."""
    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, num_crops, size=(rows // patch + 1, cols // patch + 1))
    rr, cc = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    crop = coarse[rr // patch, cc // patch].astype(np.int32)
    flip = rng.random(crop.shape) < noise
    crop[flip] = rng.integers(0, num_crops, size=int(flip.sum()))
    keys = pack_composite_key([rr.ravel(), cc.ravel()])
    return Table(keys=keys, columns={"crop_type": crop.ravel()})


def pearson_keyvalue(table: Table) -> float:
    """Mean |Pearson| between key and each (coded) value column — the
    paper's correlation characterization of its synthetic data."""
    corrs = []
    k = table.keys.astype(np.float64)
    for col in table.columns.values():
        if col.dtype == object or col.dtype.kind in "SU":
            _, codes = np.unique(col, return_inverse=True)
            v = codes.astype(np.float64)
        else:
            v = col.astype(np.float64)
        if v.std() == 0 or k.std() == 0:
            corrs.append(1.0)
            continue
        corrs.append(abs(float(np.corrcoef(k, v)[0, 1])))
    return float(np.mean(corrs))
