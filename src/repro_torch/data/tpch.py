"""TPC-H-like table generators (categorical/integer attributes only —
the paper removes float attributes, §V-A1).  Column domains follow the
TPC-H specification; value distributions are uniform over the domain,
which is what makes TPC-H the paper's *low*-correlation regime."""

from __future__ import annotations

import numpy as np

from repro_torch.core.table import Table, pack_composite_key

_ORDERSTATUS = np.array(["F", "O", "P"])
_ORDERPRIORITY = np.array(
    ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
)
_RETURNFLAG = np.array(["A", "N", "R"])
_LINESTATUS = np.array(["F", "O"])
_SHIPINSTRUCT = np.array(
    ["COLLECT COD", "DELIVER IN PERSON", "NONE", "TAKE BACK RETURN"]
)
_SHIPMODE = np.array(["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK"])
_MFGR = np.array([f"Manufacturer#{i}" for i in range(1, 6)])
_BRAND = np.array([f"Brand#{i}{j}" for i in range(1, 6) for j in range(1, 6)])
_CONTAINER = np.array(
    [f"{s} {t}" for s in ("SM", "MED", "LG", "JUMBO", "WRAP")
     for t in ("BAG", "BOX", "CAN", "CASE", "DRUM", "JAR", "PACK", "PKG")]
)


def orders_like(n: int = 150_000, seed: int = 0) -> Table:
    rng = np.random.default_rng(seed)
    # TPC-H orderkeys are sparse: only 4 of every 32 consecutive ints used.
    blocks = np.arange(n, dtype=np.int64)
    keys = (blocks // 4) * 32 + (blocks % 4) + 1
    return Table(
        keys=keys,
        columns={
            "o_orderstatus": _ORDERSTATUS[rng.integers(0, 3, n)],
            "o_orderpriority": _ORDERPRIORITY[rng.integers(0, 5, n)],
            "o_clerk": rng.integers(1, 1001, n).astype(np.int32),
            "o_shippriority": np.zeros(n, dtype=np.int32),
        },
    )


def lineitem_like(n: int = 600_000, seed: int = 0) -> Table:
    rng = np.random.default_rng(seed)
    # Composite (orderkey, linenumber 1..7) packed into one key.
    orders = np.repeat(np.arange(1, n // 4 + 2, dtype=np.int64), 7)[:n]
    lineno = np.concatenate(
        [np.arange(1, 8, dtype=np.int64)] * (n // 7 + 1)
    )[:n]
    keys = pack_composite_key([orders, lineno])
    return Table(
        keys=keys,
        columns={
            "l_returnflag": _RETURNFLAG[rng.integers(0, 3, n)],
            "l_linestatus": _LINESTATUS[rng.integers(0, 2, n)],
            "l_shipinstruct": _SHIPINSTRUCT[rng.integers(0, 4, n)],
            "l_shipmode": _SHIPMODE[rng.integers(0, 7, n)],
            "l_quantity": rng.integers(1, 51, n).astype(np.int32),
            "l_linenumber_mod": (lineno % 7).astype(np.int32),
        },
    )


def part_like(n: int = 200_000, seed: int = 0) -> Table:
    rng = np.random.default_rng(seed)
    keys = np.arange(1, n + 1, dtype=np.int64)
    return Table(
        keys=keys,
        columns={
            "p_mfgr": _MFGR[rng.integers(0, 5, n)],
            "p_brand": _BRAND[rng.integers(0, 25, n)],
            "p_size": rng.integers(1, 51, n).astype(np.int32),
            "p_container": _CONTAINER[rng.integers(0, 40, n)],
        },
    )
