"""Serving launcher: build (or load) a DeepMapping store and run the
batched LookupServer over synthetic request traffic.

    PYTHONPATH=src python -m repro_torch.launch.serve --dataset tpcds_customer_demographics \
        --requests 100 --store-dir /tmp/dm_store [--variant DM-R] [--device cpu]

The port of ``repro.launch.serve``.  The reference takes its tables and
store configs from ``benchmarks.common``, which imports ``repro``; this
module carries its own copies of that registry (``DATASETS``, the same
scaled sizes) and of ``DM_CONFIGS`` (DM-Z, DM-L, DM-R), and builds,
saves and loads through the port.  The benchmarks' on-disk build cache
is not carried over: ``--store-dir`` keeps a store between runs.  The
store is built and served on the card unless ``--device`` names another
device.
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Dict, List, Optional

from repro_torch.core import DeepMappingConfig, Table
from repro_torch.core.trainer import TrainConfig
from repro_torch.data import (
    catalog_returns_like,
    catalog_sales_like,
    cropland_like,
    customer_demographics_like,
    lineitem_like,
    orders_like,
    part_like,
    synthetic_multi_column,
    synthetic_single_column,
)

# Scaled-down stand-ins for the paper's workloads (§V-A1), as in the
# reference's benchmarks/common.py.
DATASETS: Dict[str, Callable[[], Table]] = {
    "tpch_orders": lambda: orders_like(n=60_000),
    "tpch_lineitem": lambda: lineitem_like(n=120_000),
    "tpch_part": lambda: part_like(n=40_000),
    "tpcds_customer_demographics": lambda: customer_demographics_like(n=120_000),
    "tpcds_catalog_sales": lambda: catalog_sales_like(n=80_000),
    "tpcds_catalog_returns": lambda: catalog_returns_like(n=40_000),
    "synth_single_low": lambda: synthetic_single_column(n=120_000, correlation="low"),
    "synth_single_high": lambda: synthetic_single_column(n=120_000, correlation="high"),
    "synth_multi_low": lambda: synthetic_multi_column(n=100_000, correlation="low"),
    "synth_multi_high": lambda: synthetic_multi_column(n=100_000, correlation="high"),
    "crop": lambda: cropland_like(rows=320, cols=320),
}

DM_CONFIGS: Dict[str, DeepMappingConfig] = {
    "DM-Z": DeepMappingConfig(
        shared=(256, 128), private=(32,), codec="zstd",
        partition_bytes=64 * 1024,
        train=TrainConfig(epochs=60, batch_size=8192),
    ),
    "DM-L": DeepMappingConfig(
        shared=(256, 128), private=(32,), codec="lzma",
        partition_bytes=32 * 1024,
        train=TrainConfig(epochs=60, batch_size=8192),
    ),
    # Beyond-paper: auto-detected residue features.  Smaller trunk — the
    # residue features carry the periodic structure, so the model only
    # has to wire them up, not compute divisions.
    "DM-R": DeepMappingConfig(
        shared=(128, 64), private=(16,), codec="zstd",
        partition_bytes=64 * 1024, auto_residues=True,
        train=TrainConfig(epochs=60, batch_size=8192),
    ),
}


def main(argv: Optional[List[str]] = None):
    """Run the launcher on ``argv`` (the command line when None); prints
    the reference's summary lines and returns the ``LookupServer``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="tpcds_customer_demographics")
    ap.add_argument("--requests", type=int, default=100)
    ap.add_argument("--request-size", type=int, default=1000)
    ap.add_argument("--store-dir", default=None)
    ap.add_argument("--variant", default="DM-Z", choices=["DM-Z", "DM-L", "DM-R"])
    ap.add_argument("--device", default=None,
                    help="torch device of the store (default: the CUDA device)")
    args = ap.parse_args(argv)

    import numpy as np

    from repro_torch.core import DeepMappingStore
    from repro_torch.core.serialize import load_store, save_store
    from repro_torch.serve import LookupServer

    table = DATASETS[args.dataset]()
    if args.store_dir and os.path.isdir(args.store_dir):
        store = load_store(args.store_dir, device=args.device)
        print(f"loaded store from {args.store_dir}")
    else:
        store = DeepMappingStore.build(table, DM_CONFIGS[args.variant], device=args.device)
        if args.store_dir:
            save_store(store, args.store_dir)
    print(
        f"store: ratio={store.compression_ratio():.4f} "
        f"memorized={store.memorized_fraction():.1%} "
        f"bytes={store.size_bytes():,}"
    )

    server = LookupServer(store)
    rng = np.random.default_rng(0)
    reqs = [rng.choice(table.keys, size=args.request_size) for _ in range(args.requests)]
    results = server.lookup_many(reqs)
    ok = sum(int(e.all()) for _, e in results)
    s = server.stats
    print(
        f"served {s.requests} requests ({s.keys:,} keys) in {s.total_s:.2f}s "
        f"-> {s.qps():,.0f} keys/s; all-found={ok}/{len(reqs)}; "
        f"infer={s.infer_s:.2f}s exist={s.exist_s:.2f}s "
        f"aux={s.aux_s:.2f}s decode={s.decode_s:.2f}s"
    )
    return server


if __name__ == "__main__":
    main()
