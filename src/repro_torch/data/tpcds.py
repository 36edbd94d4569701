"""TPC-DS-like table generators (a copy of ``repro.data.tpcds``).

``customer_demographics`` is generated exactly as TPC-DS does: the
table is the full cross product of its attribute domains, so every
column is a deterministic periodic function of ``cd_demo_sk`` — this is
the paper's flagship high-correlation case (compressed to 0.6% of raw,
§V-B1).  ``catalog_sales``/``catalog_returns`` are mostly-random fact
tables (low correlation, larger cardinalities)."""

from __future__ import annotations

import numpy as np

from repro_torch.core.table import Table

_GENDER = np.array(["F", "M"])
_MARITAL = np.array(["D", "M", "S", "U", "W"])
_EDUCATION = np.array(
    ["2 yr Degree", "4 yr Degree", "Advanced Degree", "College",
     "Primary", "Secondary", "Unknown"]
)
_CREDIT = np.array(["Good", "High Risk", "Low Risk", "Unknown"])


def customer_demographics_like(n: int | None = None, seed: int = 0) -> Table:
    """Cross product of demographic domains (full table = 1,920,800 rows).

    ``n`` truncates the cross product (keys stay dense 1..n)."""
    dims = [
        ("cd_gender", _GENDER),
        ("cd_marital_status", _MARITAL),
        ("cd_education_status", _EDUCATION),
        ("cd_purchase_estimate", np.arange(500, 10500, 500, dtype=np.int32)),  # 20
        ("cd_credit_rating", _CREDIT),
        ("cd_dep_count", np.arange(0, 7, dtype=np.int32)),
        ("cd_dep_employed_count", np.arange(0, 7, dtype=np.int32)),
        ("cd_dep_college_count", np.arange(0, 7, dtype=np.int32)),
    ]
    full = int(np.prod([len(d) for _, d in dims]))
    n = full if n is None else min(n, full)
    keys = np.arange(1, n + 1, dtype=np.int64)
    idx = keys - 1
    cols = {}
    stride = full
    for name, domain in dims:
        stride //= len(domain)
        cols[name] = domain[(idx // stride) % len(domain)]
    return Table(keys=keys, columns=cols)


def catalog_sales_like(n: int = 400_000, seed: int = 0) -> Table:
    rng = np.random.default_rng(seed)
    keys = np.arange(1, n + 1, dtype=np.int64)
    return Table(
        keys=keys,
        columns={
            "cs_ship_mode_sk": rng.integers(1, 21, n).astype(np.int32),
            "cs_warehouse_sk": rng.integers(1, 16, n).astype(np.int32),
            "cs_promo_sk": rng.integers(1, 301, n).astype(np.int32),
            "cs_call_center_sk": rng.integers(1, 7, n).astype(np.int32),
            "cs_quantity": rng.integers(1, 101, n).astype(np.int32),
        },
    )


def catalog_returns_like(n: int = 140_000, seed: int = 0) -> Table:
    rng = np.random.default_rng(seed)
    keys = np.arange(1, n + 1, dtype=np.int64)
    return Table(
        keys=keys,
        columns={
            "cr_reason_sk": rng.integers(1, 36, n).astype(np.int32),
            "cr_return_quantity": rng.integers(1, 101, n).astype(np.int32),
            "cr_return_ship_mode": rng.integers(1, 21, n).astype(np.int32),
        },
    )
