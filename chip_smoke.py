#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed N]
    python3 chip_smoke.py --models-only [--plans] [--src CHECKOUT]

Drives the port's main paths at full width and holds every CUDA kernel
on them against its plain PyTorch version on the card:

1. env        — card name and power limit, torch/CUDA versions, TF32
                off, the kernel builds from ``src/repro_torch/csrc`` (one
                ``nvcc`` per source, started together);
2. kernels    — K1 (fused lookup) and K2 (fused MLP) against their plain
                versions at buckets 256, 257, 65,536 and 65,537 plus key
                edges; K1 codes equal K2 codes byte for byte; every tile
                plan of the store's model forced at those buckets, and of
                coverage models (no trunk, private depth 2, a card above
                1,024, NaN/+-0/+-inf ties, hidden 1,024 and 2,048) that
                take each tile shape: K2 codes and logits byte-identical
                across plans, K1 codes equal to K2's, the default plan
                against the plain version;
3. bitvector  — K3 (the existence test) through ``bitvector_test`` over
                the SF1 store's existence vector, at 1,023 to 65,537 keys
                with edge keys and on all 1.5 M present keys plus 100,000
                absent ones, equal to its plain version and to
                ``BitVector.test`` on every key;
4. main       — a DeepMapping store over TPC-H ``orders`` at SF1 row
                count (1.5 M rows) with the paper's store config, built
                from random weights; every key looked up losslessly
                through the ``fused`` tier, absent and out-of-capacity
                keys absent; 10,000 inserts/updates/deletes re-checked;
5. streamed   — the same lookups through the ``fused_streamed`` tier
                under a forced budget, byte-identical to phase 4;
6. train      — the same table built with no weights: the store trains
                at the paper's width and ``TrainConfig`` (batch 16,384,
                up to 200 epochs), evaluates T_aux through K2 and answers
                every key losslessly through K1;
7. persist    — the trained store saved by the port in the reference's
                v2 layout and reopened through ``repro_torch.open``:
                every SF1 key plus 100,000 absent and 2,000
                out-of-capacity keys answer byte for byte as before the
                save and losslessly; a bit flipped in ``vexist.bin``
                raises ``IntegrityError``; save, load and first-lookup
                seconds and each artifact's bytes;
8. query      — nine plans through ``store.query()`` on the reopened
                store (a projected ``where_keys`` on 65,536 keys, a
                ``scan`` with a ``where`` conjunction on two heads, a
                ``where_range``, a count-only ``group_by``, a self-join
                probe, a point ``where``, a filtered aggregate, a
                filtered range, and a point lookup under nine ``where``
                clauses on three heads, more than K1's eight predicate
                slots, which ship as one table per head), each against
                a numpy oracle and byte for byte against
                ``pushdown(False)``, then all nine at once through
                ``execute_plans``; the five ``where`` plans again on the
                main store after its mutations.  K1 must run with
                predicate tables and every ``where`` plan must report
                ``kernel_filtered``;
9. cluster    — the reference's default cluster (``ClusterConfig()``:
                4 range shards) over the same SF1 table, every shard
                trained on the card with the train phase's config through
                ``repro_torch.build(..., cluster=...)`` in a thread pool:
                every key, absent and out-of-capacity keys through
                ``lookup`` (serial) and a ``where_keys`` plan (fan-out),
                byte-identical to each other and on present rows to the
                single store; the query phase's nine plans against their
                oracles and ``pushdown(False)``; 10,000 mutations in the
                last shard's range and a retrain of the shard they
                dirtied; save and reopen through ``repro_torch.open``; a
                replicate (round robin) and a partition federation with
                an AB baseline, member 0 killed in the replicate one; one
                shard fault retried, one dead shard surfacing as
                ``OwnerFailure``; a bit flipped in one shard's
                ``aux.msgpack`` refused, then quarantined with the healthy
                shards serving.  Every plan without an injected fault
                retries nothing;
10. serve     — the batched ``LookupServer`` over the train phase's
                store and the cluster (after its mutations): 2,048
                requests of 1 to 4,096 keys (log-uniform), Zipf-skewed
                (s = 1.1) over the present keys with 5% absent and 1%
                out-of-capacity keys, in ``lookup_many`` calls of 32 with
                ``max_batch`` 65,536, and one call of 163,840 unique keys
                (three morsels); lossless, byte for byte each store's own
                ``lookup`` and, on present unmutated keys, the cluster's
                answers the single store's; one batch per morsel and K1
                at least once per batch; on the cluster under
                ``on_error="partial"`` no retried or degraded morsel and
                every present key found, then with shard 1 failing every
                collect its keys absent, the healthy shards' byte for
                byte and the fault counters moved by what was injected;
                keys/s, the ``ServeStats`` split, request latency p50 and
                p99 and plan-cache outcomes per store.  Then the launcher
                (``repro_torch.launch.serve.main``) twice in-process: it
                builds its DM-R ``customer_demographics`` store (120,000
                rows) on the card, saves it and serves 100 requests, then
                reopens the save and serves again; every request found,
                the store lossless.  The path's launches are read before
                the checks that look keys up outside the servers;
11. correlated — TPC-DS ``customer_demographics`` at its full 1,920,800
                rows under the reference benchmark's DM-R config,
                trained on the card through ``repro_torch.build``: every
                key lossless, absent and out-of-capacity keys absent; the
                residue periods found, epochs, memorized share, T_aux,
                Eq. 1, per-column accuracy against the majority share,
                the lookup's split; six scan and ``where`` plans against
                their oracles and ``pushdown(False)``; saved and reopened
                through ``repro_torch.open`` with the same answers; K1
                (with and without predicate tables) and K2 on the store's
                model and residue features against their plain versions;
12. multikey  — ``MultiKeyMapping`` over a 240,000-row prefix of it,
                under DM-R (20 epochs, cut for time), with two key
                choices: (key, credit rating),
                whose packed domain fits int32 (K1), and (key, purchase
                estimate), past int32 (the host-digits tier, K2); each
                lossless on every row, unknown combinations absent; each
                choice's kernel on its store's model against its plain
                version;
13. baselines — every AB/HB factory of the paper (§V-A3) on
                ``customer_demographics`` (HBC-L on its first 960,400
                rows, cut for time) and on SF1 ``orders``: exact on
                100,000 present and 50,000 absent keys, saved, reopened
                through ``repro_torch.open`` with the same answers, and a
                flipped payload bit refused; size, Eq. 1 ratio, build
                seconds and lookup keys/s beside the two DeepMapping
                stores probed the same way.  Baselines are host code:
                they build in a pool of spawned workers (never forked
                from the process that holds the CUDA context), one per
                core but two, started before phase 11 and running beside
                phases 11 and 12; a hash store's reopened lookup is timed
                in its worker, an array store's in the main process once
                at most one worker is left (and again alone if one was);
14. times     — kernel and plain-version times with CUDA events, the
                kernels' bounds, K1/K2 under each plan of the store's
                model, one fp32 ``torch.matmul`` of the trunk's 256x256
                layer as a yardstick, registers and spills per
                instantiation, and whole-table lookup throughput.

Each kernel's launches are counted on every path that drives the port
(phases 3 to 13), with the counts set to 0 just before each path and read
just after; K1's launches that carried predicate tables are counted
apart.  The launches made to compare a kernel with its plain version
(phase 2, and in phases 11 and 12 after their counts are read) and those
of phase 14 do not count.
Each phase prints one JSON line with its seconds (``phase_s``); any
failed check raises (non-zero exit).  The last lines are the kernel summary and
``{"ok": true, "device": {...}}``.  Without CUDA, or without the
repository's ``src/`` beside it, the script exits non-zero and prints
no result.  A full record goes to ``chiprun_out/chip_smoke.json``.

``--models-only`` runs none of that: it builds the kernels of the
checkout under ``--src`` (this one by default) and prints one JSON line
of K1/K2 times on the MODELS (the store's heads under wider trunks)
through the public calls, so that two checkouts can be timed in one
call; ``--plans`` also times every plan that fits, with the codes
checked across plans, through private helpers of this checkout's
package (``fused_mlp._candidate_plans``, ``plan=``).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import json
import multiprocessing
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: H100 SXM data-sheet peaks: fp32 on CUDA cores, and device memory
#: bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
#: Tolerances: logits as the frameworks' summation orders differ; codes
#: may differ only where the plain side's top-two margin is below this.
LOGIT_TOL = 1e-5
MARGIN_TOL = 1e-5
#: Device spin queued before each timed call: about 2 ms at the H100's
#: clock, longer than the host needs to enqueue any timed call.
SPIN_CYCLES = 4_000_000
#: TPC-H ``orders`` rows at scale factor 1.
ROWS = 1_500_000
#: The paper's epoch cap (``PAPER_STORE``'s TrainConfig); training may
#: stop earlier on |Δloss| < 1e-4.
TRAIN_EPOCHS = 200
#: The reference benchmark's DM-R store (``benchmarks/common.py``): a
#: smaller trunk, and residue features for the periods found at build;
#: its TrainConfig is 60 epochs at batch 8,192 (early stop as default).
DMR = {"shared": (128, 64), "private": (16,), "codec": "zstd",
       "partition_bytes": 64 * 1024, "auto_residues": True}
DMR_EPOCHS, DMR_BATCH = 60, 8192
#: customer_demographics rows of the multikey phase: a prefix, cut for
#: time (215,001 x 10,001 already passes int32, so the cut keeps the
#: purchase-estimate choice past it).
MK_ROWS = 240_000
#: Epochs of the multikey phase's two stores: DM-R's 60 capped at 20, cut
#: for the smoke's time budget.
MK_EPOCHS = 20
#: Probe of the baselines phase, the same for every store of a table:
#: present keys sampled without replacement, and absent keys (halved from
#: 200,000 and 100,000 for the smoke's time budget).
PROBE_PRESENT, PROBE_ABSENT = 100_000, 50_000
#: customer_demographics rows under HBC-L, the baseline pool's long pole
#: (its LZMA partitions took 128.85 s over all 1,920,800 rows): a prefix,
#: cut for the smoke's time budget.
HBCL_CD_ROWS = 960_400
#: Serve phase traffic: requests, their largest size (sizes log-uniform
#: from 1), requests per ``lookup_many`` call, the server's
#: ``max_batch``, the Zipf exponent of the present keys, and the shares of
#: keys absent inside the key range and at or past the store's capacity.
SERVE_REQUESTS, SERVE_MAX_KEYS, SERVE_CALL = 2048, 4096, 32
SERVE_MAX_BATCH = 65_536
SERVE_ZIPF, SERVE_ABSENT, SERVE_OUT_CAP = 1.1, 0.05, 0.01
#: Requests of SERVE_MAX_KEYS distinct keys in the one call that streams
#: three morsels (163,840 unique keys), and the calls served again with
#: a cluster shard dead.
SERVE_BIG_CALL, SERVE_FAULT_CALLS = 40, 4
#: Requests of the launcher's runs (of 1,000 keys each, its default).
LAUNCH_REQUESTS = 100

RECORD: dict = {}
#: perf_counter at the end of the previous phase (the script's start for
#: the first).
_PHASE_T0 = [time.perf_counter()]


def emit(phase: str, **fields) -> None:
    now = time.perf_counter()
    line = {"phase": phase, "phase_s": now - _PHASE_T0[0], **fields}
    _PHASE_T0[0] = now
    RECORD[phase] = line
    print(json.dumps(line), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def time_ms(fn, reps=20, warmup=3):
    """Median device time of one call, each call between its own pair
    of CUDA events.  A device-side spin queued ahead of the first
    event keeps the card busy while the host runs the wrapper
    (checks, ctypes), so the host's time is not read as the kernel's."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)

def host_ms(fn, reps=50):
    """Median host time of one call (checks, plan, ctypes, launch),
    each made while a device spin keeps the card busy, so the launch
    queue never waits on the device."""
    import torch

    ts = []
    for _ in range(reps):
        torch.cuda._sleep(SPIN_CYCLES)
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    return statistics.median(ts)


#: The store's heads (width 8, four heads, cards 1000/5/3/1) under the
#: store's layers and wider ones of the paper's architecture search
#: (PAPER_MHAS layer sizes 100-2,000, up to two layers): (shared, private).
#: Each takes another tile or slab depth; the previous design took the
#: first three at 32 rows a block and the others at 8.
MODELS = (
    ((256, 256), (64,)),
    ((512, 512), (64,)),
    ((576,), (576, 576)),
    ((1024, 1024), (64,)),
    ((2000, 2000), (64,)),
)
MODEL_CARDS = (1000, 5, 3, 1)


def flops_per_key(spec) -> int:
    """Unpadded work per key: gather layer width*out adds, dense 2*in*out."""
    flops = 0
    d = None
    for h in spec.shared:
        flops += spec.width * h if d is None else 2 * d * h
        d = h
    for t in spec.tasks:
        hd = d
        for h in spec.private_map[t]:
            flops += 2 * hd * h
            hd = h
        flops += 2 * hd * spec.card_map[t]
    return flops


def model_times(dev, seed: int, plans: bool) -> list:
    """K1 and K2 ms per 65,536-key launch on the MODELS, and K1's host
    time per launch, through the public calls of the ``repro_torch``
    package on ``sys.path``; with ``plans``, also under every plan that
    fits, forced through the private helpers (medians of 5 calls, where
    the default plan's are of 20: the slowest plans of the widest trunk
    take about 0.1 s a call), with the codes checked equal across plans
    and between K1 and K2."""
    import numpy as np
    import torch
    from repro_torch.core import MLPSpec, init_params
    from repro_torch.kernels import fused_mlp as fm
    from repro_torch.kernels import ops

    rng = np.random.default_rng(seed)
    n, width = 65536, 8
    cap = 10 ** width
    pos = torch.tensor([[10 ** (width - p), 10 ** (width - 1 - p)] for p in range(width)],
                       dtype=torch.int32, device=dev)
    keys = torch.from_numpy(rng.integers(0, cap, n).astype(np.int32)).to(dev)
    digits = torch.stack([(keys.long() // 10 ** (width - 1 - p)) % 10 for p in range(width)],
                         dim=1).to(torch.int32).contiguous()
    words = ops.words_tensor(rng.integers(0, 2**63, cap // 64, dtype=np.uint64), dev)
    base_pad = ops._round_up(10, ops.LANE)
    tasks = [f"t{i}" for i in range(len(MODEL_CARDS))]
    out = []
    for shared, private in MODELS:
        spec = MLPSpec(base=10, width=width, shared=shared, private={t: private for t in tasks},
                       out_cards=dict(zip(tasks, MODEL_CARDS)))
        flat, _ = ops.pad_flat_weights(init_params(spec, seed=seed, device=dev), spec)
        pads = ops.card_pads(spec)
        row = {
            "shared": list(shared), "private": list(private),
            "flops_per_key": flops_per_key(spec),
            "bound_ms": n * flops_per_key(spec) / PEAK_FP32_FLOPS * 1e3,
            "fused_lookup_ms": time_ms(
                lambda: fm.fused_lookup_call(keys, pos, words, flat, spec, 256, base_pad, cap)),
            "fused_mlp_ms": time_ms(
                lambda: fm.fused_mlp_call(digits, flat, spec, 256, base_pad, pads, True)),
            "fused_lookup_host_ms": host_ms(
                lambda: fm.fused_lookup_call(keys, pos, words, flat, spec, 256, base_pad, cap)),
        }
        if plans:
            row["default"] = fm.tile_plan(spec).describe()
            row["by_plan"] = {}
            first = None
            for p in fm._candidate_plans(spec):
                if p.smem_bytes > fm.SMEM_LIMIT:
                    continue
                c1 = fm._fused_lookup(keys, pos, words, flat, spec, 256, base_pad, cap,
                                      plan=p)[0]
                c2 = fm._fused_mlp(digits, flat, spec, 256, base_pad, pads, True, plan=p)
                check(torch.equal(c1, c2), f"K1 and K2 codes differ ({p.describe()})")
                first = c2 if first is None else first
                check(torch.equal(c2, first), f"K2 codes differ across plans ({p.describe()})")
                row["by_plan"][f"{p.tile.name}/{p.schedule}/slab {p.slab}"] = {
                    "fused_lookup_ms": time_ms(
                        lambda: fm._fused_lookup(keys, pos, words, flat, spec, 256, base_pad,
                                                 cap, plan=p), reps=5, warmup=1),
                    "fused_mlp_ms": time_ms(
                        lambda: fm._fused_mlp(digits, flat, spec, 256, base_pad, pads, True,
                                              plan=p), reps=5, warmup=1),
                }
        out.append(row)
    return out


def models_only(src: Path, seed: int, plans: bool) -> int:
    """``--models-only``: build the kernels of the package under
    ``src/src`` and print the MODELS' times as one JSON line, so that two
    checkouts can be compared in one call."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src / "src"))
    from repro_torch.kernels import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    ptxas = [ln.strip() for ln in build.BUILD_INFO["fused_mlp.cu"]["log"].splitlines()
             if "Compiling entry function" in ln or "registers" in ln or "spill" in ln]
    print(json.dumps({"phase": "models", "src": str(src), "nvidia_smi": smi, "ptxas": ptxas,
                      "models": model_times(torch.device("cuda"), seed, plans)}),
          flush=True)
    return 0


def baseline_table(name: str, seed: int):
    """The baselines phase's tables: TPC-DS ``customer_demographics`` in
    full and its first HBCL_CD_ROWS rows, and TPC-H ``orders`` at SF1
    (the ``train`` phase's table)."""
    from repro_torch.data import customer_demographics_like, orders_like

    if name == "customer_demographics":
        return customer_demographics_like()
    if name == "customer_demographics_prefix":
        return customer_demographics_like(n=HBCL_CD_ROWS)
    return orders_like(ROWS, seed=seed)


def baseline_probe(table, seed: int):
    """``(keys, present)``: PROBE_PRESENT keys of the table and
    PROBE_ABSENT keys it lacks (between its keys, or past its largest),
    shuffled; the same for every store built over ``table``."""
    import numpy as np

    rng = np.random.default_rng(seed + 19)
    present = rng.choice(table.keys, PROBE_PRESENT, replace=False)
    cand = rng.integers(0, 2 * table.max_key + 2, 4 * PROBE_ABSENT)
    absent = cand[~np.isin(cand, table.keys)][:PROBE_ABSENT]
    check(absent.size == PROBE_ABSENT, "not enough absent keys for the probe")
    keys = np.concatenate([present, absent])
    order = rng.permutation(keys.size)
    return keys[order], (order < PROBE_PRESENT)


def check_probe(label: str, table, keys, present, values, exists) -> None:
    """Exact on the probe: present keys decode to their rows, absent
    keys read as absent."""
    import numpy as np

    check(np.array_equal(exists, present), f"{label}: existence differs on the probe")
    rows = np.searchsorted(table.keys, keys[present])
    check(np.array_equal(table.keys[rows], keys[present]), f"{label}: probe rows not found")
    for c, col in table.columns.items():
        check(np.array_equal(values[c][present], col[rows]), f"{label}: column {c} differs")


def answers_digest(values, exists) -> str:
    """sha256 over a lookup's answers: existence, then each column's
    name, dtype and bytes."""
    h = hashlib.sha256(exists.tobytes())
    for c in sorted(values):
        h.update(f"{c}:{values[c].dtype.str}".encode())
        h.update(values[c].tobytes())
    return h.hexdigest()


def baseline_job(table_name: str, factory: str, seed: int, out_dir: str) -> dict:
    """One AB/HB store, in a worker process (host code: no CUDA): build
    it with the reference's factory (timed), save it, refuse a copy with
    one payload bit flipped, look the probe up on the store as built and
    check it exact, then reopen the saved file, time its lookup of the
    probe (beside the other workers) and hold its answers byte for byte
    against the store's as built.  The file (written atomically) stays
    for the main process, which reopens and times the array stores again
    on their own; the digest of the answers lets it hold those against
    this store too."""
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch
    from repro_torch.baselines import BASELINE_FACTORIES
    from repro_torch.fault import IntegrityError

    label = f"{factory} on {table_name}"
    table = baseline_table(table_name, seed)
    t0 = time.perf_counter()
    store = BASELINE_FACTORIES[factory](table)
    build_s = time.perf_counter() - t0
    path = baseline_file(out_dir, table_name, factory)
    t0 = time.perf_counter()
    store.save(path)
    save_s = time.perf_counter() - t0
    blob = bytearray(Path(path).read_bytes())
    blob[len(blob) // 2] ^= 0x01
    Path(path + ".flipped").write_bytes(bytes(blob))
    integrity_error = None
    try:
        repro_torch.open(path + ".flipped")
    except IntegrityError as err:
        integrity_error = str(err)
    check(integrity_error is not None, f"{label}: a file with a flipped bit opened")
    os.remove(path + ".flipped")
    keys, present = baseline_probe(table, seed)
    values, exists = store.lookup(keys)
    check_probe(label, table, keys, present, values, exists)
    digest = answers_digest(values, exists)
    t0 = time.perf_counter()
    reopened = repro_torch.open(path)
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    values, exists = reopened.lookup(keys)
    lookup_s = time.perf_counter() - t0
    check(type(reopened) is type(store) and answers_digest(values, exists) == digest,
          f"{label}: the reopened store answers otherwise than before its save")
    return {"table": table_name, "store": factory, "kind": store.kind, "codec": store.codec_name,
            "type": type(store).__name__, "rows": table.num_rows,
            "partitions": len(store._partitions), "size_bytes": store.size_bytes(),
            "size_breakdown": store.size_breakdown(),
            "ratio": store.size_bytes() / table.raw_size_bytes(), "file_bytes": os.path.getsize(path),
            "build_s": build_s, "save_s": save_s, "integrity_error": integrity_error,
            "digest": digest, "load_s": load_s, "lookup_s": lookup_s,
            "lookup_keys_per_s": keys.size / lookup_s, "timed_in": "worker"}


def baseline_file(out_dir: str, table_name: str, factory: str) -> str:
    return os.path.join(out_dir, f"{table_name}_{factory}.bin")


#: The baseline stores, most expensive first (the pool takes them in
#: this order): every factory on both tables, HBC-L on
#: customer_demographics' prefix.
BASELINE_JOBS = tuple(
    ("customer_demographics_prefix" if (t, f) == ("customer_demographics", "HBC-L") else t, f)
    for f in ("HBC-L", "HB", "HBC-Z", "ABC-L", "ABC-G", "ABC-D", "ABC-Z", "AB")
    for t in ("customer_demographics", "orders"))


# ------------------------------------------------------------ serve phase
def serve_traffic(rng, present, max_key: int, cap: int):
    """The serve phase's request stream: SERVE_REQUESTS requests, sizes
    log-uniform over 1 to SERVE_MAX_KEYS keys; each key Zipf-skewed
    (exponent SERVE_ZIPF, ranks over a random order of ``present``), or
    with the shares SERVE_ABSENT and SERVE_OUT_CAP a key absent inside
    ``[0, max_key]`` or one at or past ``cap``.  Returns the requests in
    ``lookup_many`` calls of SERVE_CALL requests each."""
    import numpy as np

    sizes = np.exp(rng.uniform(0.0, np.log(SERVE_MAX_KEYS + 1), SERVE_REQUESTS))
    sizes = np.clip(sizes.astype(np.int64), 1, SERVE_MAX_KEYS)
    total = int(sizes.sum())
    p = np.arange(1, present.size + 1, dtype=np.float64) ** -SERVE_ZIPF
    keys = rng.permutation(present)[rng.choice(present.size, total, p=p / p.sum())]
    u = rng.random(total)
    slots = np.flatnonzero(u < SERVE_ABSENT)
    cand = rng.integers(0, max_key + 1, 4 * slots.size + 64)
    cand = cand[~np.isin(cand, present)]
    check(cand.size >= slots.size, "serve: not enough absent keys")
    keys[slots] = cand[: slots.size]
    slots = np.flatnonzero(u > 1.0 - SERVE_OUT_CAP)
    keys[slots] = rng.integers(cap, 2**40, slots.size)
    reqs = np.split(keys, np.cumsum(sizes)[:-1])
    return [reqs[i:i + SERVE_CALL] for i in range(0, len(reqs), SERVE_CALL)]


def serve_calls(server, calls, read_launches):
    """Every call through ``server.lookup_many``; returns the answers per
    call, each call's wall seconds, and K1's launches in the calls."""
    import torch

    before = read_launches()["fused_lookup"]
    answers, walls = [], []
    for call in calls:
        t0 = time.perf_counter()
        answers.append(server.lookup_many(call))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return answers, walls, read_launches()["fused_lookup"] - before


def joined(answers):
    """One call's answers end to end: ``(values, exists)``."""
    import numpy as np

    return ({c: np.concatenate([v[c] for v, _ in answers]) for c in answers[0][0]},
            np.concatenate([e for _, e in answers]))


def same_answers(label: str, got, want, rows=slice(None)) -> None:
    """Two ``(values, exists)`` answers equal in dtype and bytes on
    ``rows``, with the same columns."""
    import numpy as np

    check(np.array_equal(got[1][rows], want[1][rows]), f"{label}: existence differs")
    check(set(got[0]) == set(want[0]), f"{label}: the columns differ")
    for c in want[0]:
        g, w = got[0][c][rows], want[0][c][rows]
        check(g.dtype == w.dtype and g.tobytes() == w.tobytes(), f"{label}: column {c} differs")


def same_rows_widened(label: str, got, want, rows) -> list:
    """``same_answers`` on ``rows``, except that an integer column may come
    back wider in ``got``: a cluster shard whose codec took an unseen
    value decodes it as int64 (``ColumnCodec.extend`` concatenates Python
    ints, in the reference as in the port); such a column must be equal
    in value.  Returns the widened columns."""
    import numpy as np

    widened = [c for c in want[0] if got[0][c].dtype != want[0][c].dtype]
    for c in widened:
        g, w = got[0][c], want[0][c]
        check(g.dtype.kind == w.dtype.kind == "i" and g.dtype.itemsize > w.dtype.itemsize
              and np.array_equal(g[rows], w[rows]), f"{label}: column {c} differs")
    same_answers(label, ({c: v for c, v in got[0].items() if c not in widened}, got[1]),
                 ({c: v for c, v in want[0].items() if c not in widened}, want[1]), rows)
    return widened


def serve_summary(server, walls, launches, reg, calls) -> dict:
    """Keys/s, wall s, the ServeStats split, request latency p50 and p99
    (exact: each request waits its call's wall, as the server observes
    it; and as ``deepmap_serve_request_seconds`` estimates them from its
    log buckets), plan-cache outcomes."""
    import numpy as np

    s = server.stats
    lat = reg.histogram("deepmap_serve_request_seconds")
    waits = np.repeat(walls, [len(c) for c in calls])
    wall = float(sum(walls))
    return {"calls": len(calls), "requests": s.requests, "keys": s.keys,
            "wall_s": wall, "keys_per_s": s.keys / wall,
            "batches": s.batches, "fused_lookup_launches": launches,
            **{f: getattr(s, f) for f in ("total_s", "route_s", "infer_s", "exist_s", "aux_s",
                                          "filter_s", "decode_s", "gather_s")},
            "request_p50_s": float(np.quantile(waits, 0.5)),
            "request_p99_s": float(np.quantile(waits, 0.99)),
            "histogram_p50_s": lat.quantile(0.5), "histogram_p99_s": lat.quantile(0.99),
            "cache": {"hits": s.cache_hits, "misses": s.cache_misses,
                      "bypass": s.cache_bypass}}


def counter_total(reg, name: str) -> float:
    """A counter family's sum over its labels (0 before its first use)."""
    metric = reg.get(name)
    return 0.0 if metric is None else sum(v for _, v in metric.items())


@contextlib.contextmanager
def own_registry():
    """A fresh metrics registry as the process default, for one block."""
    from repro_torch import obs

    reg = obs.MetricsRegistry()
    prev = obs.set_registry(reg)
    try:
        yield reg
    finally:
        obs.set_registry(prev)


def serve_phase(seed: int, store, table, cluster, cluster_expect, mutated, read_launches,
                work_dir: Path) -> dict:
    """The serve phase (see the module docstring): the train phase's
    single store and the cluster phase's cluster (after its mutations:
    ``cluster_expect`` is ``(sorted live keys, their columns)``,
    ``mutated`` the keys updated or deleted there) behind
    ``LookupServer``, then the launcher twice.  Each server records into
    a metrics registry of its own.  Returns the phase's record and the
    checks that look keys up outside the servers (against each store's
    own lookup, the launcher's stores on every key), to be run once the
    path's launch counts are read."""
    import io

    import numpy as np
    import torch

    from repro_torch.core import Table
    from repro_torch.fault import DEFAULT_POLICY, FaultPlan, FaultSpec
    from repro_torch.launch import serve as launcher
    from repro_torch.serve import LookupServer

    dev = store.device
    rng = np.random.default_rng(seed + 22)
    calls = serve_traffic(rng, table.keys, int(table.max_key), int(store.encoder.capacity))
    # One more call whose unique keys exceed twice the server's batch,
    # so that the executor's window streams three morsels.
    big = rng.choice(table.keys, SERVE_BIG_CALL * SERVE_MAX_KEYS, replace=False)
    calls.append(np.split(big, SERVE_BIG_CALL))
    uniq = [np.unique(np.concatenate(call)).size for call in calls]
    morsels = sum(max(1, -(-u // SERVE_MAX_BATCH)) for u in uniq)
    check(uniq[-1] > 2 * SERVE_MAX_BATCH, "serve: the merged call does not stream 3 morsels")
    flat_keys = np.concatenate([k for call in calls for k in call])
    rec: dict = {"requests": int(sum(len(c) for c in calls)), "keys": int(flat_keys.size),
                 "unique_keys_per_call": {"min": min(uniq), "max": max(uniq),
                                          "mean": float(np.mean(uniq))},
                 "morsels_expected": morsels}

    # The single store: lossless, byte for byte its own lookup, one
    # batch per morsel, K1 at least once per batch.
    with own_registry() as reg:
        server = LookupServer(store, max_batch=SERVE_MAX_BATCH)
        single, walls, k1 = serve_calls(server, calls, read_launches)
        rec["single"] = serve_summary(server, walls, k1, reg, calls)
    check(server.stats.batches == morsels,
          f"serve: {server.stats.batches} batches, expected {morsels} morsels")
    check(k1 >= server.stats.batches, f"serve: K1 launched {k1} times for "
          f"{server.stats.batches} batches")
    single_flat = joined([a for answers in single for a in answers])
    check_probe("serve: single store", table, flat_keys, np.isin(flat_keys, table.keys),
                *single_flat)

    # The cluster, fault-free under on_error="partial": nothing retried
    # or degraded, and every present key exists, so a failure cannot
    # pass as an absent key.
    live_keys, live_cols = cluster_expect
    check(bool(np.all(np.diff(live_keys) > 0)), "serve: the cluster's live keys are not sorted")
    with own_registry() as reg:
        server = LookupServer(cluster, max_batch=SERVE_MAX_BATCH, on_error="partial")
        clustered, walls, k1 = serve_calls(server, calls, read_launches)
        rec["cluster"] = serve_summary(server, walls, k1, reg, calls)
        hidden = {n: counter_total(reg, n) for n in ("deepmap_fault_retries_total",
                                                      "deepmap_fault_degraded_morsels_total")}
    check(not any(hidden.values()), f"serve: the fault-free cluster calls retried or "
          f"degraded: {hidden}")
    check(server.stats.batches == morsels and k1 >= server.stats.batches,
          "serve: the cluster's batches or K1 launches are short")
    cl_flat = joined([a for answers in clustered for a in answers])
    check_probe("serve: cluster", Table(keys=live_keys, columns=live_cols), flat_keys,
                np.isin(flat_keys, live_keys), *cl_flat)
    kept = np.isin(flat_keys, table.keys) & ~np.isin(flat_keys, mutated)
    widened = same_rows_widened("serve: cluster against the single store", cl_flat,
                                single_flat, kept)
    rec["cluster"]["rows_held_against_single"] = int(kept.sum())
    rec["cluster"]["columns_widened"] = widened

    # One shard dead (every collect of shard 1 raises) under "partial":
    # the healthy shards' keys byte for byte, shard 1's absent, and the
    # counters moved by what was injected.
    dead_calls = calls[:SERVE_FAULT_CALLS]
    plan = FaultPlan([FaultSpec(site="shard_collect", owner="shard:1", kind="raise")])
    with own_registry() as reg, plan.activate():
        server = LookupServer(cluster, max_batch=SERVE_MAX_BATCH, on_error="partial")
        dead, _, _ = serve_calls(server, dead_calls, read_launches)
        moved = {n: counter_total(reg, n) for n in (
            "deepmap_fault_injected_total", "deepmap_fault_retries_total",
            "deepmap_fault_degraded_morsels_total")}
    dead_keys = np.concatenate([k for call in dead_calls for k in call])
    dead_flat = joined([a for answers in dead for a in answers])
    healthy = cluster.partitioner.shard_of(dead_keys) != 1
    same_answers("serve: shard 1 dead, healthy shards", dead_flat,
                 ({c: v[: dead_keys.size] for c, v in cl_flat[0].items()},
                  cl_flat[1][: dead_keys.size]), healthy)
    check(not dead_flat[1][~healthy].any(), "serve: a key of the dead shard reads present")
    attempts = DEFAULT_POLICY.max_attempts
    check(plan.fired > 0 and plan.fired % attempts == 0
          and moved["deepmap_fault_injected_total"] == plan.fired
          and moved["deepmap_fault_retries_total"] == plan.fired // attempts * (attempts - 1)
          and moved["deepmap_fault_degraded_morsels_total"] == 0,
          f"serve: the fault counters moved otherwise than injected: fired {plan.fired}, "
          f"{moved}")
    rec["shard_dead"] = {"calls": len(dead_calls), "keys": int(dead_keys.size),
                         "dead_shard_keys": int((~healthy).sum()), "fired": plan.fired,
                         **moved}

    # The launcher, twice in-process: it builds the DM-R store of its
    # registry's customer_demographics (120,000 rows) on the card, saves
    # it and serves; then it reopens the save and serves again.
    argv = ["--dataset", "tpcds_customer_demographics", "--variant", "DM-R",
            "--requests", str(LAUNCH_REQUESTS), "--store-dir", str(work_dir / "launcher")]
    launch_table = launcher.DATASETS["tpcds_customer_demographics"]()
    runs, launch_stores = [], []
    for run in ("build", "reopen"):
        before = read_launches()
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            srv = launcher.main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        after = read_launches()
        text = out.getvalue()
        print(text, end="", flush=True)
        found = re.search(r"all-found=(\d+)/(\d+);", text)
        check(found is not None and found.group(1) == found.group(2) == str(LAUNCH_REQUESTS),
              f"serve: the launcher's {run} run did not find every request")
        check(("loaded store from" in text) == (run == "reopen"),
              f"serve: the launcher's {run} run took the other path")
        check(srv.store.device.type == dev.type and srv.store.encoder.residues,
              f"serve: the launcher's {run} store is off the card or has no residues")
        launches = {k: after[k] - before[k] for k in after}
        check(launches["fused_lookup"] > 0 and (run == "reopen" or launches["fused_mlp"] > 0),
              f"serve: the launcher's {run} run did not launch K1 (and K2 to build)")
        launch_stores.append(srv.store)
        s = srv.stats
        runs.append({"run": run, "seconds": secs, "rows": launch_table.num_rows,
                     "residues": list(srv.store.encoder.residues),
                     "memorized_fraction": srv.store.memorized_fraction(),
                     "compression_ratio": srv.store.compression_ratio(),
                     "aux_rows": srv.store.aux.num_rows, "requests": s.requests,
                     "keys": s.keys, "wall_s": s.total_s, "keys_per_s": s.qps(),
                     **{f: getattr(s, f) for f in ("infer_s", "exist_s", "aux_s",
                                                   "decode_s")},
                     "launches": launches, "summary": text.strip().splitlines()[-2:]})
    rec["launcher"] = runs

    def lookups_outside_the_servers():
        """Each server's answers, all calls end to end, byte for byte its
        store's own lookup of the same keys; the launcher's stores
        lossless on every key and equal to each other."""
        same_answers("serve: single store against store.lookup", single_flat,
                     store.lookup(flat_keys))
        same_answers("serve: cluster against cluster.lookup", cl_flat,
                     cluster.lookup(flat_keys))
        answers = []
        for run, st in zip(("build", "reopen"), launch_stores):
            answers.append(st.lookup(launch_table.keys))
            check(bool(answers[-1][1].all()), f"serve: the launcher's {run} store lost a key")
            for c, col in launch_table.columns.items():
                check(np.array_equal(answers[-1][0][c], col),
                      f"serve: the launcher's {run} store: column {c} is not lossless")
        same_answers("serve: the launcher's reopened store against its built one",
                     answers[1], answers[0])

    return rec, lookups_outside_the_servers


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--models-only", action="store_true",
                    help="only time K1 and K2 on the wider models, through the public calls")
    ap.add_argument("--src", type=Path, default=ROOT,
                    help="with --models-only: the checkout whose src/ package to time")
    ap.add_argument("--plans", action="store_true",
                    help="with --models-only: also time every tile plan (private helpers)")
    args = ap.parse_args()
    if args.models_only:
        return models_only(args.src.resolve(), args.seed, args.plans)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401 — fails here when src/ is not beside the script

    with contextlib.ExitStack() as cleanup:
        return smoke(args, cleanup)


def smoke(args, cleanup: contextlib.ExitStack) -> int:
    """Every phase but the models-only mode (see the module docstring);
    ``cleanup`` stops the baseline pool however the phases end."""
    import numpy as np
    import torch

    import repro_torch
    from repro_torch import obs, storage
    from repro_torch.api import FederatedStore, execute_plans
    from repro_torch.baselines import BASELINE_FACTORIES
    from repro_torch.cluster import ClusterConfig, plan_range_partitions
    from repro_torch.core import (
        BitVector, DeepMappingConfig, DeepMappingStore, InferenceEngine, KeyEncoder,
        MLPSpec, Table, init_params,
    )
    from repro_torch.core import trainer as trainer_lib
    from repro_torch.core.encoding import build_codecs
    from repro_torch.core.multikey import MultiKeyMapping
    from repro_torch.data import customer_demographics_like
    from repro_torch.data.tpch import orders_like
    from repro_torch.fault import DEFAULT_POLICY, FaultPlan, FaultSpec, IntegrityError, OwnerFailure
    from repro_torch.kernels import bitvector as bvk
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_mlp as fm
    from repro_torch.kernels import ops, ref
    from repro_torch.train.optimizer import adam_init

    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)

    def reset_launches():
        """Every kernel's launch count to 0 (just before a path)."""
        fm.fused_lookup_call.launches = fm.fused_lookup_call.pred_launches = 0
        fm.fused_mlp_call.launches = bvk.bitvector_call.launches = 0

    def read_launches():
        """Every kernel's launches since ``reset_launches`` (just after a
        path); ``fused_lookup_with_preds`` counts K1's launches that
        carried predicate tables."""
        torch.cuda.synchronize()
        return {"fused_lookup": fm.fused_lookup_call.launches,
                "fused_lookup_with_preds": fm.fused_lookup_call.pred_launches,
                "fused_mlp": fm.fused_mlp_call.launches,
                "bitvector": bvk.bitvector_call.launches}

    paths: dict = {}

    # ------------------------------------------------------------ 1. env
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    tf32_was = (torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision(),
                torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    t0 = time.perf_counter()
    build.build_all()
    fm.library()
    bvk.library()
    build_s = time.perf_counter() - t0
    ptxas = {src: [ln.strip() for ln in info["log"].splitlines()
                   if "Compiling entry function" in ln or "registers" in ln or "spill" in ln]
             for src, info in build.BUILD_INFO.items()}
    emit(
        "env", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        tf32_before={"matmul": tf32_was[0], "precision": tf32_was[1], "cudnn": tf32_was[2]},
        tf32_now={"matmul": False, "precision": "highest", "cudnn": False},
        kernel_build_s=build_s,
        nvcc_seconds={src: info["seconds"] for src, info in build.BUILD_INFO.items()},
        ptxas=ptxas,
        codec="zstd" if storage.HAVE_ZSTD else "zstd (zlib fallback: no zstandard)",
    )

    # The slice's full width: TPC-H orders at SF1, the paper's store.
    table = orders_like(ROWS, seed=args.seed)
    config = DeepMappingConfig(
        base=10, codec="zstd", partition_bytes=4 * 1024 * 1024,
        shared=(256, 256), private=(64,),
    )
    encoder = KeyEncoder(table.max_key, base=config.base)
    codecs = build_codecs(table.columns)
    spec = MLPSpec(
        base=config.base, width=encoder.width, shared=config.shared,
        private={c: config.private for c in table.columns},
        out_cards={c: codecs[c].cardinality for c in table.columns},
    )
    params = init_params(spec, seed=args.seed, device=dev)
    flat, wbytes = ops.pad_flat_weights(params, spec)
    bv = BitVector.from_keys(table.keys)
    words = ops.words_tensor(bv.words, dev)
    pos_ops = torch.tensor(encoder.position_ops(), dtype=torch.int32, device=dev)
    cap = encoder.capacity
    base_pad = ops._round_up(spec.base, ops.LANE)
    m = len(spec.tasks)

    # ------------------------------------------------------- 2. kernels
    def key_digits(keys_t, mpos, base, mcap):
        """The features K1 computes from keys: ``((k % mod) // div) % base``
        per position, zero rows outside ``[0, mcap)``."""
        k = keys_t.long()
        in_cap = (k >= 0) & (k < mcap)
        safe = torch.where(in_cap, k, torch.zeros_like(k))
        d = torch.stack([((safe % int(md)) // int(dv)) % base for md, dv in mpos], dim=1)
        return d.to(torch.int32).contiguous(), in_cap

    def digits_of(keys_t):
        return key_digits(keys_t, encoder.position_ops(), spec.base, cap)

    def margins(digits, mflat=flat, mspec=spec):
        """Plain-side top-two margin per row and task (inf for card 1)."""
        lg = ref._forward_flat(mflat, mspec, digits, emit_codes=False)
        out = []
        for ti, t in enumerate(mspec.tasks):
            card = mspec.card_map[t]
            if card < 2:
                out.append(torch.full((digits.shape[0],), float("inf"), device=dev))
                continue
            top = torch.topk(lg[ti][:, :card], 2, dim=1).values
            out.append(top[:, 0] - top[:, 1])
        return torch.stack(out, dim=1)

    def cmp_codes(got, want, marg):
        diff = got != want
        check(bool((marg[diff] < MARGIN_TOL).all()),
              "kernel codes differ from the plain version on a row with a clear margin")
        n_diff = int(diff.any(dim=1).sum())
        check(n_diff <= max(2, got.shape[0] // 1000), f"{n_diff} margin rows is not small")
        return n_diff, diff.any(dim=1)

    words_dom = words.shape[0] * 32
    edges = np.array([-1, -7, 0, 1, table.max_key, table.max_key + 1, cap - 1, cap,
                      words_dom - 1, words_dom, 2**31 - 1], dtype=np.int64)
    kern_err = {"fused_lookup": 0.0, "fused_mlp": 0.0}
    margin_rows = 0
    cases = []
    for n in (256, 257, 65536, 65537):
        bucket = 256
        while bucket < n:
            bucket <<= 1
        keys = np.concatenate([edges, rng.integers(0, table.max_key + 64, n - edges.size)])
        kp = np.full(bucket, -1, dtype=np.int32)
        kp[:n] = keys.astype(np.int32)
        kt = torch.from_numpy(kp).to(dev)
        digits, in_cap = digits_of(kt)
        marg = margins(digits)
        tabs = tuple(
            torch.from_numpy((rng.random(ops._round_up(spec.card_map[t], ops.LANE)) < 0.5)
                             .astype(np.int32)).to(dev)
            for t in spec.tasks[:2]
        )
        for with_exists, ptabs in ((True, ()), (True, tabs), (False, ())):
            ptasks = tuple(range(len(ptabs)))
            got = fm.fused_lookup_call(kt, pos_ops, words if with_exists else None, flat,
                                       spec, 256, base_pad, cap, ptabs, ptasks, with_exists)
            want = ref.fused_lookup(kt, pos_ops, words if with_exists else None, flat,
                                    spec, cap, ptabs, ptasks, with_exists)
            torch.cuda.synchronize()
            nd, rows = cmp_codes(got[0], want[0], marg)
            margin_rows += nd
            ok = ~rows
            if with_exists:
                check(torch.equal(got[1], want[1]), "K1 exists differs from the plain version")
            if ptabs:
                check(torch.equal(got[2][ok], want[2][ok]), "K1 match differs")
            err = max(
                (got[0][ok] - want[0][ok]).abs().max().item() if ok.any() else 0,
                (got[1] - want[1]).abs().max().item() if with_exists else 0,
            )
            kern_err["fused_lookup"] = max(kern_err["fused_lookup"], float(err))
            cases.append({"kernel": "fused_lookup", "n": n, "bucket": bucket,
                          "with_exists": with_exists, "preds": len(ptabs), "margin_rows": nd})
        # K2 on the same rows' digits: codes and logits.
        k2 = fm.fused_mlp_call(digits, flat, spec, 256, base_pad, ops.card_pads(spec), True)
        w2 = ref.fused_mlp(digits, flat, spec, True)
        nd, _ = cmp_codes(k2, w2, marg)
        margin_rows += nd
        lg = fm.fused_mlp_call(digits, flat, spec, 256, base_pad, ops.card_pads(spec), False)
        wl = ref.fused_mlp(digits, flat, spec, False)
        for a, b in zip(lg, wl):
            torch.testing.assert_close(a, b, rtol=LOGIT_TOL, atol=LOGIT_TOL)
            kern_err["fused_mlp"] = max(kern_err["fused_mlp"], (a - b).abs().max().item())
        # K1 codes == K2 codes byte for byte (in-capacity rows; K1 zeroes the rest).
        k1 = fm.fused_lookup_call(kt, pos_ops, words, flat, spec, 256, base_pad, cap)[0]
        check(torch.equal(k1[in_cap], k2[in_cap]), "K1 and K2 codes differ")
        check(bool((k1[~in_cap] == 0).all()), "K1 codes outside capacity are not 0")
        cases.append({"kernel": "fused_mlp", "n": n, "bucket": bucket, "margin_rows": nd})

    def same_bits(a, b):
        return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))

    def plan_sweep(mspec, mflat, kt, digits, in_cap, mpos, mcap):
        """Every plan that fits ``mspec``, forced through the private
        helpers: K2 codes and logits byte-identical across plans, and K1
        codes equal to K2's on in-capacity rows.  Returns the default
        plan's (codes, logits) and the plans run."""
        plans = [p for p in fm._candidate_plans(mspec) if p.smem_bytes <= fm.SMEM_LIMIT]
        check(plans[0].describe() == fm.tile_plan(mspec).describe(),
              "the default plan is not the first that fits")
        pads = ops.card_pads(mspec)
        first = None
        for p in plans:
            c2 = fm._fused_mlp(digits, mflat, mspec, 256, base_pad, pads, True, plan=p)
            l2 = fm._fused_mlp(digits, mflat, mspec, 256, base_pad, pads, False, plan=p)
            c1 = fm._fused_lookup(kt, mpos, words, mflat, mspec, 256, base_pad, mcap,
                                  plan=p)[0]
            torch.cuda.synchronize()
            check(torch.equal(c1[in_cap], c2[in_cap]), f"K1 and K2 codes differ ({p.describe()})")
            if first is None:
                first = (c2, l2)
                continue
            check(torch.equal(c2, first[0]), f"K2 codes differ across plans ({p.describe()})")
            check(all(same_bits(a, b) for a, b in zip(l2, first[1])),
                  f"K2 logits differ across plans ({p.describe()})")
        return first, [f"{p.tile.name}/{p.schedule}/slab {p.slab}" for p in plans]

    # The store's model under every plan, at the same buckets.
    sweep = []
    for n in (256, 257, 65536, 65537):
        bucket = 256
        while bucket < n:
            bucket <<= 1
        kp = np.full(bucket, -1, dtype=np.int32)
        kp[:n] = np.concatenate([edges, rng.integers(0, table.max_key + 64, n - edges.size)])
        kt = torch.from_numpy(kp).to(dev)
        digits, in_cap = digits_of(kt)
        _, names = plan_sweep(spec, flat, kt, digits, in_cap, pos_ops, cap)
        sweep.append({"n": n, "bucket": bucket, "plans": names})

    # Coverage models, at least one per tile shape, each under every plan
    # and held against the plain version at its default plan.
    def coverage_model(name, width, shared, private, cards, special=None):
        tasks = [f"t{i}" for i in range(len(cards))]
        mspec = MLPSpec(base=10, width=width, shared=shared,
                        private={t: tuple(private[i]) for i, t in enumerate(tasks)},
                        out_cards=dict(zip(tasks, cards)))
        mflat, _ = ops.pad_flat_weights(init_params(mspec, seed=args.seed, device=dev), mspec)
        if special:
            mflat = special(list(mflat))
        mcap = 10 ** width
        mpos = torch.tensor([[10 ** (width - p), 10 ** (width - 1 - p)] for p in range(width)],
                            dtype=torch.int32, device=dev)
        out = []
        for n in (257, 65537):
            bucket = ops._round_up(n, 256)
            kp = np.full(bucket, -1, dtype=np.int32)
            kp[:n] = rng.integers(-3, mcap + 3, n)
            kt = torch.from_numpy(kp).to(dev)
            k = kt.long()
            m_in = (k >= 0) & (k < mcap)
            safe = torch.where(m_in, k, torch.zeros_like(k))
            digits = torch.stack([((safe // 10 ** (width - 1 - p)) % 10) for p in range(width)],
                                 dim=1).to(torch.int32).contiguous()
            (c2, l2), names = plan_sweep(mspec, mflat, kt, digits, m_in, mpos, mcap)
            want_l = ref.fused_mlp(digits, mflat, mspec, False)
            want_c = ref.fused_mlp(digits, mflat, mspec, True)
            for a, b in zip(l2, want_l):
                torch.testing.assert_close(a, b, rtol=LOGIT_TOL, atol=LOGIT_TOL, equal_nan=True)
                fin = torch.isfinite(b)
                kern_err["fused_mlp"] = max(kern_err["fused_mlp"],
                                            (a[fin] - b[fin]).abs().max().item())
            tops = [torch.topk(b[:, :mspec.card_map[t]], min(2, mspec.card_map[t]), dim=1).values
                    for t, b in zip(mspec.tasks, want_l)]
            marg = torch.stack([v[:, 0] - v[:, 1] if v.shape[1] > 1
                                else torch.full_like(v[:, 0], float("inf")) for v in tops], dim=1)
            nd, _ = cmp_codes(c2, want_c, marg)
            out.append({"model": name, "n": n, "bucket": bucket, "plans": names,
                        "default": fm.tile_plan(mspec).describe(), "margin_rows": nd,
                        "nan_logits": int(sum(torch.isnan(b).sum() for b in want_l)),
                        "inf_logits": int(sum(torch.isinf(b).sum() for b in want_l))})
        return out

    def ties(mflat):
        # Head t0's out layer (flat[4], flat[5]): equal columns (finite
        # ties), +inf weights at k = 5 (+inf logits where x_5 > 0, NaN
        # where x_5 == 0), a -inf column, zero columns with biases -0 and
        # +0, and a NaN column; head t1's columns all equal.
        w, b = mflat[4].clone(), mflat[5].clone()
        w[:, 9], b[9] = w[:, 2], b[2]
        w[:, 11], b[11] = w[:, 2], b[2]
        w[:, 3] = 0
        w[5, 3] = float("inf")
        w[:, 5] = 0
        w[5, 5] = float("inf")
        w[:, 7] = 0
        w[6, 7] = -float("inf")
        w[:, 13], b[13] = 0, -0.0
        w[:, 14], b[14] = 0, 0.0
        w[:, 20] = float("nan")
        w1 = mflat[2].clone()
        w1[:, 5] *= 50
        w2, b2 = mflat[8].clone(), mflat[9].clone()
        w2[:, :6] = w2[:, :1]
        b2[:6] = b2[0]
        mflat[2], mflat[4], mflat[5], mflat[8], mflat[9] = w1, w, b, w2, b2
        return tuple(t.contiguous() for t in mflat)

    coverage = []
    coverage += coverage_model("private depth 2", 8, (256, 256), [(64, 64)] * 4,
                               (1000, 5, 3, 1))
    coverage += coverage_model("no trunk", 6, (), [(64,), (), (32, 16)], (7, 3, 130))
    coverage += coverage_model("card 1100", 8, (256,), [(64,)] * 2, (1100, 2))
    coverage += coverage_model("NaN, +-0, +-inf ties", 8, (128,), [(32,)] * 2, (40, 6), ties)
    coverage += coverage_model("hidden 1024", 8, (1024,), [(64,)] * 2, (300, 5))
    coverage += coverage_model("hidden 2048", 8, (2048,), [(2048,)] * 2, (300, 5))
    tiles_seen = {c["default"].split()[0] for c in coverage}
    check(tiles_seen == {t.name for t in fm.TILES}, f"coverage models took only {tiles_seen}")
    emit("kernels_vs_plain", cases=cases, max_abs_err=kern_err, margin_rows=margin_rows,
         logit_tol=LOGIT_TOL, margin_tol=MARGIN_TOL, plan_sweep=sweep, coverage=coverage)

    def store_kernels_vs_plain(s, keys):
        """K1 (where the store's key domain fits int32) and K2 on a trained
        store's own weights, spec and key features (residue positions
        included), on its first 256 and 65,536 ``keys``, against their
        plain versions by the rule above: K1 with no predicate tables and
        with one per head (up to ``ref.MAX_PREDS``), K2 codes and logits,
        K1 codes equal to K2's.  Comparison launches: the correlated and
        multikey phases call this after reading their paths' counts."""
        eng = s.engine
        mspec = s.spec
        mflat, _ = eng._entry(mspec.tasks).flat()
        mcap = s.encoder.capacity
        mbase_pad = ops._round_up(mspec.base, ops.LANE)
        pads = ops.card_pads(mspec)
        keys_in = mcap <= 2**31 - 1  # K1's domain; K2 on host digits otherwise
        out = []
        for n in (256, 65536):
            kh = np.asarray(keys[:n], dtype=np.int64)
            if keys_in:
                kt = eng._keys_dev(kh, n)
                digits, in_cap = key_digits(kt, eng._pos_ops, mspec.base, mcap)
            else:
                inside = (kh >= 0) & (kh < mcap)
                dp = np.zeros((n, s.encoder.width), dtype=np.int32)
                dp[inside] = s.encoder.digits(kh[inside])
                digits = torch.from_numpy(dp).to(dev)
            marg = margins(digits, mflat, mspec)
            c2 = fm.fused_mlp_call(digits, mflat, mspec, 256, mbase_pad, pads, True)
            nd, _ = cmp_codes(c2, ref.fused_mlp(digits, mflat, mspec, True), marg)
            row = {"n": n, "bucket": n, "kernel": "fused_lookup and fused_mlp" if keys_in
                   else "fused_mlp", "fused_mlp_margin_rows": nd, "fused_mlp_max_abs_err": 0.0}
            for a, b in zip(fm.fused_mlp_call(digits, mflat, mspec, 256, mbase_pad, pads, False),
                            ref.fused_mlp(digits, mflat, mspec, False)):
                torch.testing.assert_close(a, b, rtol=LOGIT_TOL, atol=LOGIT_TOL)
                row["fused_mlp_max_abs_err"] = max(row["fused_mlp_max_abs_err"],
                                                   (a - b).abs().max().item())
            kern_err["fused_mlp"] = max(kern_err["fused_mlp"], row["fused_mlp_max_abs_err"])
            if keys_in:
                mpos, mwords = eng._device_pos_ops(), eng._device_words()
                tabs = tuple(
                    torch.from_numpy((rng.random(ops._round_up(mspec.card_map[t], ops.LANE))
                                      < 0.5).astype(np.int32)).to(dev)
                    for t in mspec.tasks[:ref.MAX_PREDS])
                for ptabs in ((), tabs):
                    ptasks = tuple(range(len(ptabs)))
                    got = fm.fused_lookup_call(kt, mpos, mwords, mflat, mspec, 256, mbase_pad,
                                               mcap, ptabs, ptasks, True)
                    want = ref.fused_lookup(kt, mpos, mwords, mflat, mspec, mcap, ptabs, ptasks,
                                            True)
                    nd, rows = cmp_codes(got[0], want[0], marg)
                    ok = ~rows
                    check(torch.equal(got[1], want[1]), "K1 exists differs from the plain version")
                    if ptabs:
                        check(torch.equal(got[2][ok], want[2][ok]), "K1 match differs")
                    err = float((got[0][ok] - want[0][ok]).abs().max().item() if ok.any() else 0)
                    kern_err["fused_lookup"] = max(kern_err["fused_lookup"], err)
                    row[f"fused_lookup_preds_{len(ptabs)}_margin_rows"] = nd
                    row[f"fused_lookup_preds_{len(ptabs)}_max_abs_err"] = err
                    row["present"] = int(got[1].sum())
                    check(torch.equal(got[0][in_cap], c2[in_cap]), "K1 and K2 codes differ")
            out.append(row)
        return out

    # ---------------------------------------------------- 3. bitvector
    # K3's path is its public entry point, bitvector_test, over the SF1
    # store's existence vector; its results are then held against the
    # plain version (on the card) and the host BitVector.test.
    dom = 32 * words.shape[0]
    bv_edges = np.array([0, bv.capacity - 1, bv.capacity, dom - 1, dom, -1, 2**31 - 1,
                         2**32 + 5], dtype=np.int64)
    absent_k3 = rng.integers(0, table.max_key, 400_000)
    absent_k3 = absent_k3[~bv.test(absent_k3)][:100_000]
    k3_inputs = []
    for n in (1023, 1024, 1025, 65536, 65537):
        k3_inputs.append(np.concatenate([
            bv_edges, rng.choice(table.keys, (n - bv_edges.size) // 2),
            rng.integers(-64, dom + 64, n - bv_edges.size - (n - bv_edges.size) // 2),
        ]))
    k3_inputs.append(np.concatenate([table.keys, absent_k3, bv_edges]))
    k3_dev = [torch.from_numpy(k).to(dev) for k in k3_inputs]
    torch.cuda.synchronize()
    reset_launches()
    k3_out = [ops.bitvector_test(bv.words, k) for k in k3_dev]
    paths["bitvector"] = read_launches()
    k3_launches = paths["bitvector"]["bitvector"]
    k3_cases = []
    k3_err = 0
    for keys, kd, got in zip(k3_inputs, k3_dev, k3_out):
        plain = ref.ref_bitvector_test(words, kd).bool()
        host = bv.test(keys)
        check(torch.equal(got, plain), f"K3 differs from its plain version at n={keys.size}")
        check(np.array_equal(got.cpu().numpy(), host),
              f"K3 differs from BitVector.test at n={keys.size}")
        k3_err = max(k3_err, int((got.int() - plain.int()).abs().max()))
        k3_cases.append({"n": int(keys.size), "present": int(host.sum())})
    check(k3_launches == len(k3_inputs), "a bitvector_test call did not launch K3 once")
    sf1_bits = k3_out[-1]
    check(bool(sf1_bits[: table.num_rows].all())
          and not sf1_bits[table.num_rows : table.num_rows + absent_k3.size].any(),
          "K3 misreads the SF1 present or absent keys")
    emit("bitvector_vs_plain", cases=k3_cases, edges=bv_edges.tolist(), capacity=bv.capacity,
         word_domain=dom, n_words=int(words.shape[0]), launches=k3_launches,
         max_abs_err=k3_err)

    # ---------------------------------------------------------- 4. main
    reset_launches()
    t0 = time.perf_counter()
    store = DeepMappingStore.build(table, config, spec=spec, params=params, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    memorized = store.memorized_fraction()
    build_launches = {"fused_lookup": fm.fused_lookup_call.launches,
                      "fused_mlp": fm.fused_mlp_call.launches}
    st = store.engine.stats
    t0 = time.perf_counter()
    vals, exists, lstats = store._lookup_with_stats(table.keys)
    lookup_s = time.perf_counter() - t0
    check(bool(exists.all()), "a present key reads as absent")
    for c, col in table.columns.items():
        check(np.array_equal(vals[c], col), f"column {c} is not lossless")
    absent = absent_k3
    out_cap = np.concatenate([rng.integers(cap, 2**40, 1000), -rng.integers(1, 2**31, 1000)])
    _, ex_abs = store.lookup(absent)
    _, ex_out = store.lookup(out_cap)
    check(absent.size == 100_000 and not ex_abs.any(), "an absent key reads as present")
    check(not ex_out.any(), "an out-of-capacity key reads as present")
    lookup_launches = {"fused_lookup": fm.fused_lookup_call.launches - build_launches["fused_lookup"],
                       "fused_mlp": fm.fused_mlp_call.launches - build_launches["fused_mlp"]}

    # 10,000 mutations: 4,000 inserts (some with unseen values), 3,000
    # updates, 3,000 deletes; then re-check touched keys and a sample.
    expect = {c: col.copy() for c, col in table.columns.items()}
    keys_all = table.keys.copy()
    free = np.setdiff1d(rng.integers(0, table.max_key + 5000, 20_000), keys_all)[:4000]
    check(free.size == 4000, "not enough free keys for inserts")

    def rand_rows(k):
        cols = {c: table.columns[c][rng.integers(0, table.num_rows, k)] for c in table.columns}
        cols["o_clerk"] = cols["o_clerk"].copy()
        cols["o_clerk"][: k // 10] = 1001 + np.arange(k // 10, dtype=np.int32) % 7  # unseen
        return cols

    ins_cols = rand_rows(4000)
    store.insert(free, ins_cols)
    pick = rng.permutation(keys_all.size)
    upd_idx, del_idx = pick[:3000], pick[3000:6000]
    upd_cols = rand_rows(3000)
    store.update(keys_all[upd_idx], upd_cols)
    store.delete(keys_all[del_idx])
    for c in expect:
        expect[c][upd_idx] = upd_cols[c]
    v_ins, e_ins = store.lookup(free)
    check(bool(e_ins.all()), "an inserted key reads as absent")
    for c in ins_cols:
        check(np.array_equal(v_ins[c], ins_cols[c]), f"inserted {c} differs")
    _, e_del = store.lookup(keys_all[del_idx])
    check(not e_del.any(), "a deleted key reads as present")
    alive = np.setdiff1d(np.arange(keys_all.size), del_idx)
    sample = np.concatenate([upd_idx, rng.choice(alive, min(100_000, alive.size), replace=False)])
    v_s, e_s = store.lookup(keys_all[sample])
    check(bool(e_s.all()), "a kept key reads as absent after mutations")
    for c in expect:
        check(np.array_equal(v_s[c], expect[c][sample]), f"{c} differs after mutations")
    main_launches = paths["main"] = read_launches()
    check(st.fused_calls > 0 and st.pallas_calls > 0, "the kernel tiers were not taken")
    check(st.jit_calls == 0, "a plain jit tier was taken")
    check(main_launches["fused_lookup"] > 0 and main_launches["fused_mlp"] > 0,
          "a kernel was not launched")
    emit(
        "main", rows=table.num_rows, max_key=table.max_key, width=encoder.width,
        capacity=cap, cards=spec.card_map, padded_weight_bytes=wbytes,
        words_bytes=int(bv.words.nbytes), memorized_fraction=memorized,
        compression_ratio=store.compression_ratio(), size_breakdown=store.size_breakdown(),
        build_s=build_s, lookup_all_s=lookup_s, absent_checked=int(absent.size),
        out_of_capacity_checked=int(out_cap.size), mutations=10_000,
        stats={k: getattr(st, k) for k in ("dispatches", "fused_calls", "pallas_calls",
                                           "fused_streamed_calls", "jit_calls")},
        launches=main_launches, build_launches=build_launches,
        lookup_launches=lookup_launches,
    )

    # ------------------------------------------------------ 5. streamed
    trunk_b, head_b = ops.padded_weight_parts(spec)
    budget = trunk_b + ops.activation_bytes(spec, 256) + max(head_b.values())
    os.environ["REPRO_VMEM_BUDGET"] = str(budget)
    resident = store.engine
    streamed = InferenceEngine.for_store(store)
    entry = streamed._entry(spec.tasks)
    plan = streamed._streamed_plan(entry, True)
    check(plan is not None and len(plan[0]) > 1, "no multi-page streamed plan")
    store.attach_engine(streamed)
    reset_launches()
    v2, e2 = store.lookup(keys_all[alive])
    v3, e3 = store.lookup(free)
    paths["streamed"] = read_launches()
    check(streamed.stats.fused_streamed_calls > 0, "the streamed tier was not taken")
    check(streamed.stats.fused_calls == 0 and streamed.stats.jit_calls == 0,
          "another tier was taken under the forced budget")
    check(bool(e2.all()) and bool(e3.all()), "streamed existence differs")
    for c in expect:
        check(np.array_equal(v2[c], expect[c][alive]), f"streamed {c} differs")
        check(np.array_equal(v3[c], ins_cols[c]), f"streamed inserted {c} differs")
    del os.environ["REPRO_VMEM_BUDGET"]
    store.attach_engine(resident)
    emit("streamed", budget=budget, pages=[list(p) for p in plan[0]],
         pages_with_exists=plan[1], fused_streamed_calls=streamed.stats.fused_streamed_calls,
         fused_lookup_launches=paths["streamed"]["fused_lookup"])

    # --------------------------------------------------------- 6. train
    # build() with no weights trains (the paper's TrainConfig), then
    # evaluates T_aux through K2 and serves through K1.  The trainer is
    # wrapped only to read its loss history and time it.
    train_table = orders_like(ROWS, seed=args.seed)
    train_cfg = dataclasses.replace(config, train=trainer_lib.TrainConfig(
        batch_size=16384, epochs=TRAIN_EPOCHS, lr=1e-3, lr_decay=0.999, early_stop_tol=1e-4))
    trained: dict = {}
    real_train = trainer_lib.train

    def timed_train(*a, **kw):
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        out = real_train(*a, **kw)
        torch.cuda.synchronize()
        trained.update(seconds=time.perf_counter() - t_start, history=out[2],
                       steps=int(out[1].step))
        return out

    reset_launches()
    trainer_lib.train = timed_train
    try:
        t0 = time.perf_counter()
        tstore = DeepMappingStore.build(train_table, train_cfg, device=dev)
        torch.cuda.synchronize()
        tbuild_s = time.perf_counter() - t0
    finally:
        trainer_lib.train = real_train
    tbuild_launches = {"fused_lookup": fm.fused_lookup_call.launches,
                       "fused_mlp": fm.fused_mlp_call.launches}
    hist = trained["history"]
    check(len(hist) > 0 and all(np.isfinite(hist)), "training gave no finite loss")
    check(tbuild_launches["fused_mlp"] > 0, "the trained build did not evaluate T_aux through K2")
    tst = tstore.engine.stats
    t0 = time.perf_counter()
    tvals, texists, tls = tstore._lookup_with_stats(train_table.keys)
    tlookup_s = time.perf_counter() - t0
    check(bool(texists.all()), "a present key of the trained store reads as absent")
    for c, col in train_table.columns.items():
        check(np.array_equal(tvals[c], col), f"trained store: column {c} is not lossless")
    _, tex_abs = tstore.lookup(absent)
    _, tex_out = tstore.lookup(out_cap)
    check(not tex_abs.any(), "trained store: an absent key reads as present")
    check(not tex_out.any(), "trained store: an out-of-capacity key reads as present")
    check(tst.fused_calls > 0 and tst.jit_calls == 0, "the trained store left the fused tier")
    train_launches = paths["train"] = read_launches()
    check(train_launches["fused_lookup"] > 0 and train_launches["fused_mlp"] > 0,
          "a kernel was not launched")
    # Where a training step's time goes: a torch.profiler trace of a few
    # steps at the trainer's batch, device kernel time by name against
    # the host clock.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    tspec = tstore.spec
    tcodes = np.stack([tstore.codecs[t].codes for t in tspec.tasks], axis=1)
    pd = torch.from_numpy(tstore.encoder.digits(train_table.keys[:16384])).to(dev)
    pc = torch.from_numpy(tcodes[:16384]).to(dev)
    popt = adam_init(tstore.params)
    pparams = tstore.params
    for _ in range(3):
        pparams, popt, _ = trainer_lib._train_step(pparams, popt, pd, pc, tspec, 1e-3, 0.999)
    torch.cuda.synchronize()
    prof_steps = 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(prof_steps):
            pparams, popt, _ = trainer_lib._train_step(pparams, popt, pd, pc, tspec, 1e-3, 0.999)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    by_kernel: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_kernel[e.name] = by_kernel.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    step_profile = {
        "steps": prof_steps, "wall_ms_per_step": prof_wall * 1e3 / prof_steps,
        "device_ms_per_step": busy / prof_steps if by_kernel else None,
        "device_idle_share": 1 - busy / (prof_wall * 1e3) if by_kernel else None,
        "top_kernels_ms_per_step": [(k[:90], v / prof_steps) for k, v in top],
    }
    emit(
        "train", rows=train_table.num_rows, epochs_max=TRAIN_EPOCHS, epochs_run=len(hist),
        steps=trained["steps"], train_s=trained["seconds"],
        s_per_epoch=trained["seconds"] / len(hist),
        steps_per_s=trained["steps"] / trained["seconds"],
        first_loss=hist[0], last_loss=hist[-1], history=hist,
        early_stopped=len(hist) < TRAIN_EPOCHS,
        memorized_fraction=tstore.memorized_fraction(), aux_rows=tstore.aux.num_rows,
        compression_ratio=tstore.compression_ratio(), size_breakdown=tstore.size_breakdown(),
        build_s=tbuild_s, build_launches=tbuild_launches, launches=train_launches,
        absent_checked=int(absent.size), out_of_capacity_checked=int(out_cap.size),
        lookup={"keys": train_table.num_rows, "wall_s": tlookup_s,
                "keys_per_s": train_table.num_rows / tlookup_s, "infer_s": tls.infer_s,
                "exist_s": tls.exist_s, "aux_s": tls.aux_s, "decode_s": tls.decode_s},
        step_profile=step_profile,
    )

    # ------------------------------------------------------- 7. persist
    # The trained store saved by the port in the reference's v2 layout
    # and reopened through repro_torch.open, onto the card: every SF1
    # key plus the absent and out-of-capacity keys answer byte for byte
    # as before the save, and a bit flipped in vexist.bin raises
    # IntegrityError.  The store lives under the ignored build/.
    probe = np.concatenate([train_table.keys, absent, out_cap])
    want_v, want_e = tstore.lookup(probe)
    store_dir = ROOT / "build" / f"chip_smoke_store_{os.getpid()}"
    shutil.rmtree(store_dir, ignore_errors=True)
    store_dir.mkdir(parents=True)
    try:
        reset_launches()
        t0 = time.perf_counter()
        tstore.save(str(store_dir / "sf1"))
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = repro_torch.open(str(store_dir / "sf1"))
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got_v, got_e = loaded.lookup(probe)
        first_lookup_s = time.perf_counter() - t0
        persist_launches = paths["persist"] = read_launches()
        check(loaded.device.type == "cuda" and loaded.config.use_kernels,
              "the reopened store is not on the card with kernels on")
        check(np.array_equal(got_e, want_e), "existence differs after the reload")
        for c in want_v:
            check(got_v[c].dtype == want_v[c].dtype and got_v[c].tobytes() == want_v[c].tobytes(),
                  f"column {c} differs after the reload")
            check(np.array_equal(got_v[c][: train_table.num_rows], train_table.columns[c]),
                  f"reloaded store: column {c} is not lossless")
        check(bool(got_e[: train_table.num_rows].all())
              and not got_e[train_table.num_rows:].any(), "reloaded existence is wrong")
        check(loaded.engine.stats.fused_calls > 0 and loaded.engine.stats.jit_calls == 0,
              "the reloaded store left the fused tier")
        check(persist_launches["fused_lookup"] > 0, "the reloaded store did not launch K1")
        artifact_bytes = {f.name: f.stat().st_size for f in sorted((store_dir / "sf1").iterdir())}
        flipped = store_dir / "flipped"
        shutil.copytree(store_dir / "sf1", flipped)
        blob = bytearray((flipped / "vexist.bin").read_bytes())
        blob[len(blob) // 2] ^= 0x01
        (flipped / "vexist.bin").write_bytes(bytes(blob))
        integrity_error = None
        try:
            repro_torch.open(str(flipped))
        except IntegrityError as err:
            integrity_error = str(err)
        check(integrity_error is not None and "vexist.bin" in integrity_error,
              "a store with a flipped vexist.bin bit loaded")
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)
    emit("persist", rows=train_table.num_rows, keys_checked=int(probe.size),
         absent_checked=int(absent.size), out_of_capacity_checked=int(out_cap.size),
         save_s=save_s, load_s=load_s, first_lookup_s=first_lookup_s,
         first_lookup_keys_per_s=probe.size / first_lookup_s, artifact_bytes=artifact_bytes,
         store_bytes=sum(artifact_bytes.values()), aux_rows=loaded.aux.num_rows,
         aux_codec=loaded.config.codec + ("" if storage.HAVE_ZSTD else " (zlib fallback)"),
         integrity_error=integrity_error, launches=persist_launches)

    # --------------------------------------------------------- 8. query
    # Plans through store.query() on the reopened SF1 store, each held
    # against a numpy oracle over the source table and byte for byte
    # against pushdown(False); the where plans again on the main store
    # after its mutations.  A where conjunction ships its predicate code
    # tables into K1, which returns the match bits the store filters on.
    def oracle_of(keys, columns):
        order = np.argsort(keys, kind="stable")
        keys, columns = keys[order], {c: v[order] for c, v in columns.items()}
        pos = np.full(int(keys.max()) + 2, -1, dtype=np.int32)
        pos[keys] = np.arange(keys.size, dtype=np.int32)

        def rows(k):
            k = np.asarray(k, np.int64)
            inside = (k >= 0) & (k < pos.size)
            r = np.full(k.size, -1, dtype=np.int32)
            r[inside] = pos[k[inside]]
            return r
        return keys, columns, rows

    def check_rows(name, res, keys, values):
        check(np.array_equal(res.keys, keys), f"{name}: keys differ from the oracle")
        check(bool(res.exists.all()), f"{name}: a returned row is absent")
        for c, v in values.items():
            check(np.array_equal(res.values[c], v), f"{name}: {c} differs from the oracle")
        check(set(res.values) == set(values), f"{name}: columns differ from the oracle")

    def check_groups(name, res, group_by, groups, counts):
        check(res.num_groups == len(groups), f"{name}: group count differs")
        for i, c in enumerate(group_by):
            check(np.array_equal(np.asarray(res.groups[c]).astype(str),
                                 np.asarray([g[i] for g in groups]).astype(str)),
                  f"{name}: group {c} differs")
        for agg, want in counts.items():
            check(np.array_equal(np.asarray(res.aggregates[agg]), want),
                  f"{name}: {agg} differs from the oracle")

    #: The oracles' comparisons (numpy, independent of the port's Predicate).
    ops_ = {"==": lambda a, v: a == v, "!=": lambda a, v: a != v, "<": lambda a, v: a < v,
            "<=": lambda a, v: a <= v, ">": lambda a, v: a > v, ">=": lambda a, v: a >= v,
            "in": lambda a, v: np.isin(a, list(v))}

    def described(name, d, okeys, ocols, lo_, hi_, qk_):
        """(name, build(store) -> Query, oracle check) of a plan given as
        a description: key source, where clauses, projection, group_by and
        aggregates; the oracle evaluates the same description in numpy."""
        def build_q(s):
            q = s.query()
            if d.get("select"):
                q = q.select(*d["select"])
            for c, op, v in d.get("where", ()):
                q = q.where(c, op, v)
            if d.get("aggs"):
                q = q.group_by(*d.get("group", ())).agg(*d["aggs"])
            if d["src"] == "scan":
                return q.scan()
            return q.where_range(lo_, hi_) if d["src"] == "range" else q.where_keys(qk_)

        def oracle(res):
            if d["src"] == "point":
                r = np.searchsorted(okeys, qk_).clip(0, okeys.size - 1)
                hit = okeys[r] == qk_
                rows, keys = r[hit], qk_[hit]
            else:
                m = np.ones(okeys.size, bool) if d["src"] == "scan" \
                    else (okeys >= lo_) & (okeys < hi_)
                rows = np.flatnonzero(m)
                keys = okeys[rows]
            keep = np.ones(rows.size, bool)
            for c, op, v in d.get("where", ()):
                keep &= ops_[op](ocols[c][rows], v)
            rows, keys = rows[keep], keys[keep]
            if not d.get("aggs"):
                check_rows(name, res, keys, {c: ocols[c][rows]
                                             for c in (d.get("select") or ocols)})
                return
            group = d["group"]
            labels = ocols[group[0]][rows].astype(str)
            for g in group[1:]:
                labels = np.char.add(np.char.add(labels, "|"), ocols[g][rows].astype(str))
            u, inv = np.unique(labels, return_inverse=True)
            want = {}
            for a in d["aggs"]:
                if a == "count":
                    want["count"] = np.bincount(inv, minlength=u.size)
                    continue
                fn, col = a
                v = ocols[col][rows].astype(np.int64)
                want[f"{fn}({col})"] = np.array([getattr(np, fn)(v[inv == i])
                                                 for i in range(u.size)])
            check_groups(name, res, group, [tuple(x.split("|")) for x in u], want)
            if d["aggs"] == ("count",):
                check(res.explain.rows_decoded == 0, f"{name}: count-only decoded rows")
        return name, build_q, oracle

    def plans_for(okeys, ocols, rows, prio, lo, hi, qk):
        """(name, build(store) -> Query, oracle check) for the 9 plans: the
        projected point plan (absent keys answered too) and the self-join
        with oracles of their own, the others as descriptions."""
        def point(res):
            r = rows(qk)
            ex = r >= 0
            check(np.array_equal(res.exists, ex), "point: existence differs from the oracle")
            for c in ("o_clerk", "o_orderstatus"):
                check(np.array_equal(res.values[c][ex], ocols[c][r[ex]]),
                      f"point: {c} differs from the oracle")

        jlo, jhi = lo, lo + (hi - lo) // 2

        def self_join(res):
            left = np.flatnonzero((okeys >= jlo) & (okeys < jhi))
            r = rows(okeys[left] + 1)
            keep = r >= 0
            check_rows("self_join", res, okeys[left][keep],
                       {"o_clerk": ocols["o_clerk"][left][keep],
                        "o_orderpriority": ocols["o_orderpriority"][r[keep]]})

        nine = (("o_clerk", ">=", 10), ("o_clerk", "<", 900), ("o_clerk", "!=", 50),
                ("o_clerk", ">", 20), ("o_clerk", "<=", 800),
                ("o_orderstatus", "!=", "P"), ("o_orderstatus", "in", ("F", "O")),
                ("o_orderpriority", "!=", prio),
                ("o_orderpriority", "in",
                 tuple(np.unique(ocols["o_orderpriority"])[:4].tolist())))

        def desc(name, d):
            return described(name, d, okeys, ocols, lo, hi, qk)

        return [
            ("point", lambda s: s.query().select("o_clerk", "o_orderstatus").where_keys(qk),
             point),
            desc("scan_where", {"src": "scan", "select": ("o_clerk",),
                                "where": (("o_orderpriority", "==", prio),
                                          ("o_orderstatus", "in", ("F", "P")))}),
            desc("range", {"src": "range"}),
            desc("count", {"src": "scan", "group": ("o_orderpriority", "o_orderstatus"),
                           "aggs": ("count",)}),
            ("self_join", lambda s: s.query().select("o_clerk").where_range(jlo, jhi)
             .join(s, key=lambda k: k + 1, columns=("o_orderpriority",)), self_join),
            desc("point_where", {"src": "point", "where": (("o_clerk", "<", 100),)}),
            desc("agg_where", {"src": "scan", "where": (("o_orderpriority", "!=", prio),),
                               "group": ("o_orderstatus",),
                               "aggs": ("count", ("sum", "o_clerk"), ("min", "o_clerk"),
                                        ("max", "o_clerk"))}),
            desc("range_where", {"src": "range", "select": ("o_orderpriority",),
                                 "where": (("o_orderstatus", "==", "O"),)}),
            desc("point_where9", {"src": "point", "where": nine}),
        ]

    def same_result(a, b):
        if hasattr(a, "aggregates"):
            return (a.num_groups == b.num_groups
                    and all(np.array_equal(a.groups[c], b.groups[c]) for c in a.groups)
                    and all(np.array_equal(a.aggregates[k], b.aggregates[k])
                            for k in a.aggregates))
        return (a.keys.tobytes() == b.keys.tobytes() and np.array_equal(a.exists, b.exists)
                and set(a.values) == set(b.values)
                and all(a.values[c].dtype == b.values[c].dtype
                        and a.values[c].tobytes() == b.values[c].tobytes() for c in a.values))

    def run_plans(s, plans):
        """Each plan alone (timed, against its oracle and pushdown(False)),
        then all of them at once through execute_plans."""
        out = []
        serial = []
        for name, build_q, oracle in plans:
            t0 = time.perf_counter()
            res = build_q(s).execute()
            wall = time.perf_counter() - t0
            oracle(res)
            check(same_result(res, build_q(s).pushdown(False).execute()),
                  f"{name}: pushdown differs from pushdown(False)")
            ex = res.explain
            where = bool(build_q(s).plan().predicates)
            if where:
                check(ex.kernel_filtered, f"{name}: the predicates were not filtered in K1")
            out.append({
                "plan": name, "wall_s": wall, "keys": ex.num_keys,
                "rows_per_s": ex.num_keys / wall, "rows_out": ex.num_rows,
                "morsels": ex.morsels, "kernel_filtered": ex.kernel_filtered,
                "rows_decoded": ex.rows_decoded, "rows_matched": ex.rows_matched,
                "plan_cache": ex.plan_cache, "stages": list(ex.plan),
                "retries": ex.retries, "owners_failed": list(ex.owners_failed),
                "split_s": {k: getattr(ex, k) for k in ("route_s", "infer_s", "exist_s",
                                                         "aux_s", "filter_s", "decode_s",
                                                         "agg_s", "gather_s", "total_s")},
            })
            serial.append(res)
        t0 = time.perf_counter()
        together = execute_plans([(s, build_q(s).plan()) for _, build_q, _ in plans])
        together_s = time.perf_counter() - t0
        for (name, _, _), a, b in zip(plans, together, serial):
            check(same_result(a, b), f"{name}: execute_plans differs from execute_plan")
        return out, together_s

    okeys, ocols, orows = oracle_of(train_table.keys, train_table.columns)
    prio = str(ocols["o_orderpriority"][0])
    lo, hi = int(okeys[okeys.size // 4]), int(okeys[okeys.size // 2])
    half = min(32_768, okeys.size // 4)
    qk = rng.permutation(np.concatenate([rng.choice(okeys, half, replace=False),
                                         rng.integers(0, int(okeys.max()) + 64, 65_536 - half)]))
    sf1_plans = plans_for(okeys, ocols, orows, prio, lo, hi, qk)
    mkeys, mcols, mrows = oracle_of(
        np.concatenate([keys_all[alive], free]),
        {c: np.concatenate([expect[c][alive], ins_cols[c]]) for c in expect})
    mlo, mhi = int(mkeys[mkeys.size // 3]), int(mkeys[2 * mkeys.size // 3])
    mqk = rng.permutation(np.concatenate([rng.choice(mkeys, half, replace=False), free,
                                          keys_all[del_idx][:1000],
                                          rng.integers(0, int(mkeys.max()) + 64,
                                                       60_536 - half)]))
    main_plans = [p for p in plans_for(mkeys, mcols, mrows, prio, mlo, mhi, mqk)
                  if p[0] in ("scan_where", "point_where", "agg_where", "range_where",
                              "point_where9")]
    reset_launches()
    sf1_runs, sf1_together_s = run_plans(loaded, sf1_plans)
    main_runs, main_together_s = run_plans(store, main_plans)
    query_launches = paths["query"] = read_launches()
    check(query_launches["fused_lookup_with_preds"] > 0,
          "K1 ran with no predicate tables on the query path")
    check(loaded.engine.stats.jit_calls == 0 and store.engine.stats.jit_calls == 0,
          "a query left the kernel tiers")
    emit("query", plans_sf1=sf1_runs, execute_plans_sf1_s=sf1_together_s,
         plans_main_after_mutations=main_runs, execute_plans_main_s=main_together_s,
         point_keys=int(qk.size), range=[lo, hi], launches=query_launches)
    del loaded

    # ------------------------------------------------------- 9. cluster
    # The reference's default cluster (ClusterConfig(): 4 range shards,
    # the 4 that benchmarks/bench_shards.py runs) over the SF1 orders
    # table, every shard trained on the card with the train phase's
    # PAPER_STORE config through repro_torch.build(..., cluster=...).
    # The shards train in a thread pool, so K2 launches from several
    # host threads at once; lookups and plans visit the shards on the
    # fan-out pool.  Checked: every key, absent and out-of-capacity key
    # through lookup (serial) and a where_keys plan (fan-out), the two
    # byte-identical and, on present rows, equal to the train phase's
    # single store; the query phase's plans; 10,000 mutations at the
    # tail of the key space (new and recent orders, the last shard's
    # range) and a retrain of the shards they dirtied; save and reopen;
    # a replicate and a partition federation with an AB baseline; a
    # quarantined shard; injected shard and member faults.  Every plan
    # without an injected fault retries nothing.
    def retries_total():
        return counter_total(obs.registry(), "deepmap_fault_retries_total")

    def no_retries(name, ex):
        check(ex.retries == 0 and ex.owners_failed == (),
              f"cluster: {name} retried ({ex.retries}) or lost owners {ex.owners_failed}")

    def split(ex, keys, wall):
        return {"keys": int(keys), "wall_s": wall, "keys_per_s": keys / wall,
                **{k: getattr(ex, k) for k in ("route_s", "infer_s", "exist_s", "aux_s",
                                               "decode_s", "gather_s", "total_s")},
                "shards_visited": ex.shards_visited, "morsels": ex.morsels,
                "stages": list(ex.plan)}

    cl_config = ClusterConfig()
    check(cl_config.num_shards == 4 and cl_config.policy == "range",
          "ClusterConfig's defaults are not the reference's 4 range shards")
    # PAPER_STORE as trained in the train phase; any modified byte marks
    # a shard dirty, so retrain() rebuilds exactly the shards mutated.
    cl_cfg = dataclasses.replace(train_cfg, retrain_after_modified_bytes=1)
    cl_shard_of = plan_range_partitions(train_table.keys, cl_config.num_shards).shard_of
    # Per-shard training and T_aux evaluation, recorded from the build's
    # threads: a thread's train record is completed by the evaluation
    # that follows it in the same thread, which names the shard.
    rec_lock = threading.Lock()
    open_rec: dict = {}
    shard_recs: dict = {}
    real_eval = trainer_lib.evaluate_misclassified_engine

    def shard_train(*a, **kw):
        t_start = time.perf_counter()
        out = real_train(*a, **kw)
        with rec_lock:
            open_rec[threading.get_ident()] = {
                "train_s": time.perf_counter() - t_start, "epochs": len(out[2]),
                "steps": int(out[1].step), "last_loss": out[2][-1]}
        return out

    def shard_eval(engine, keys, *a, **kw):
        t_start = time.perf_counter()
        out = real_eval(engine, keys, *a, **kw)
        with rec_lock:
            rec = open_rec.pop(threading.get_ident())
            rec.update(eval_s=time.perf_counter() - t_start, rows=int(keys.size))
            shard_recs[int(cl_shard_of(keys[:1])[0])] = rec
        return out

    def hooked(fn):
        trainer_lib.train, trainer_lib.evaluate_misclassified_engine = shard_train, shard_eval
        try:
            t_start = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            return out, time.perf_counter() - t_start
        finally:
            trainer_lib.train, trainer_lib.evaluate_misclassified_engine = real_train, real_eval

    # The train phase's single store answers the cluster's probe before
    # the counts are zeroed, so its launches count on no path.
    n_tr = train_table.num_rows
    cl_probe = np.concatenate([train_table.keys, absent, out_cap])
    single = tstore.lookup(cl_probe)
    retries_0 = retries_total()
    reset_launches()
    cluster, cl_build_s = hooked(
        lambda: repro_torch.build(train_table, cl_cfg, cluster=cl_config, device=dev))
    cl_build_launches = read_launches()
    build_recs = dict(sorted(shard_recs.items()))
    shard_recs.clear()
    check(cluster.num_shards == 4 and sorted(build_recs) == [0, 1, 2, 3],
          "cluster: not every shard trained once")
    check(all(s.device.type == "cuda" and s.config.use_kernels for s in cluster.shards),
          "cluster: a shard is not on the card with kernels on")
    check(cl_build_launches["fused_mlp"] > 0,
          "cluster: the build did not evaluate T_aux through K2")
    cl_shards = [{"shard": i, "rows": s.num_rows, "aux_rows": s.aux.num_rows,
                  "memorized_fraction": s.memorized_fraction(),
                  "compression_ratio": s.compression_ratio(), "capacity": int(s.encoder.capacity),
                  **build_recs[i]} for i, s in enumerate(cluster.shards)]

    # Every key, the absent and the out-of-capacity keys: serial lookup,
    # then a where_keys plan (fan-out on the shard pool).
    before = read_launches()
    t0 = time.perf_counter()
    ser_v, ser_e, ser_st = cluster._lookup_with_stats(cl_probe, fanout=False)
    ser_s = time.perf_counter() - t0
    mid = read_launches()
    t0 = time.perf_counter()
    fan = cluster.query().where_keys(cl_probe).execute()
    fan_s = time.perf_counter() - t0
    after = read_launches()
    check(fan.keys.tobytes() == cl_probe.tobytes(), "cluster: the plan's keys differ")
    same_answers("cluster: fan-out against serial", (fan.values, fan.exists), (ser_v, ser_e))
    check(bool(ser_e[:n_tr].all()) and not ser_e[n_tr:].any(),
          "cluster: a present key reads absent, or an absent one present")
    for c, col in train_table.columns.items():
        check(np.array_equal(ser_v[c][:n_tr], col), f"cluster: column {c} is not lossless")
    same_answers("cluster: against the single store", (ser_v, ser_e), single, slice(0, n_tr))
    check(np.array_equal(ser_e, single[1]), "cluster: existence differs from the single store")
    check(ser_st.shards_visited == 4 and fan.explain.shards_visited == 4,
          "cluster: a lookup did not visit all 4 shards")
    check("serial" in ser_st.plan and not ser_st.async_fanout and fan.explain.async_fanout,
          "cluster: the lookups did not take the serial and fan-out paths")
    no_retries("serial lookup", ser_st)
    no_retries("fan-out lookup", fan.explain)
    cl_lookups = {
        "serial": {**split(ser_st, cl_probe.size, ser_s),
                   "launches": {k: mid[k] - before[k] for k in mid}},
        "fanout": {**split(fan.explain, cl_probe.size, fan_s),
                   "launches": {k: after[k] - mid[k] for k in after}},
    }
    check(cl_lookups["serial"]["launches"]["fused_lookup"] > 0
          and cl_lookups["fanout"]["launches"]["fused_lookup"] > 0,
          "cluster: a lookup path did not launch K1")
    del single, ser_v, fan

    # The query phase's plans on the cluster, against the same oracles
    # and pushdown(False).
    before = read_launches()
    cl_runs, cl_together_s = run_plans(cluster, sf1_plans)
    after = read_launches()
    for r in cl_runs:
        check(r["retries"] == 0 and not r["owners_failed"], f"cluster: {r['plan']} retried")
        check(any(s.startswith("scatter[") for s in r["stages"]),
              f"cluster: {r['plan']} did not scatter")
    cl_plan_launches = {k: after[k] - before[k] for k in after}
    check(cl_plan_launches["fused_lookup_with_preds"] > 0,
          "cluster: K1 ran with no predicate tables on the plans")

    # 10,000 mutations at the tail of the key space: 4,000 new orders
    # past the largest key, 3,000 updates and 3,000 deletes of the last
    # shard's orders; re-checked, then the dirty shards retrained.
    last = cluster.num_shards - 1
    tail_rows = np.flatnonzero(cl_shard_of(train_table.keys) == last)
    pick = rng.permutation(tail_rows)
    cl_upd, cl_del = pick[:3000], pick[3000:6000]
    cl_new = int(train_table.keys.max()) + 1 + np.sort(rng.choice(16_000, 4000, replace=False))
    cl_ins = rand_rows(4000)
    cl_upd_cols = rand_rows(3000)
    cluster.insert(cl_new, cl_ins)
    cluster.update(train_table.keys[cl_upd], cl_upd_cols)
    cluster.delete(train_table.keys[cl_del])
    live = np.ones(n_tr, dtype=bool)
    live[cl_del] = False
    cl_expect = {c: col.copy() for c, col in train_table.columns.items()}
    for c in cl_expect:
        cl_expect[c][cl_upd] = cl_upd_cols[c]
    live_keys = np.concatenate([train_table.keys[live], cl_new])
    live_cols = {c: np.concatenate([cl_expect[c][live], cl_ins[c]]) for c in cl_expect}

    def check_live(name, s):
        v, e = s.lookup(live_keys)
        check(bool(e.all()), f"cluster: {name}: a live key reads as absent")
        for c, col in live_cols.items():
            check(np.array_equal(v[c], col), f"cluster: {name}: column {c} differs")
        gone = np.concatenate([train_table.keys[cl_del], absent, out_cap])
        check(not s.lookup(gone)[1].any(), f"cluster: {name}: a deleted or absent key reads present")

    check_live("after the mutations", cluster)
    dirty = cluster.dirty_shards()
    check(dirty == [last], f"cluster: dirty shards {dirty}, expected [{last}]")
    before = read_launches()
    retrained, cl_retrain_s = hooked(cluster.retrain)
    after = read_launches()
    retrain_recs = dict(sorted(shard_recs.items()))
    shard_recs.clear()
    check(retrained == dirty and sorted(retrain_recs) == dirty and not cluster.dirty_shards(),
          f"cluster: retrained {retrained}, expected {dirty}")
    check(after["fused_mlp"] > before["fused_mlp"], "cluster: the retrain did not launch K2")
    check(cluster.shards[last].device.type == "cuda", "cluster: the retrained shard left the card")
    check_live("after the retrain", cluster)

    # Persistence: save, reopen through repro_torch.open, the same answers.
    live_probe = np.concatenate([live_keys, train_table.keys[cl_del], absent, out_cap])
    live_want = cluster.lookup(live_probe)
    cl_dir = ROOT / "build" / f"chip_smoke_cluster_{os.getpid()}"
    shutil.rmtree(cl_dir, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        cluster.save(str(cl_dir / "c"))
        cl_save_s = time.perf_counter() - t0
        cl_bytes = {str(f.relative_to(cl_dir / "c")): f.stat().st_size
                    for f in sorted((cl_dir / "c").rglob("*")) if f.is_file()}
        t0 = time.perf_counter()
        reopened = repro_torch.open(str(cl_dir / "c"))
        cl_load_s = time.perf_counter() - t0
        check(type(reopened) is type(cluster) and reopened.num_shards == 4
              and all(s.device.type == "cuda" for s in reopened.shards),
              "cluster: reopened as another kind, or off the card")
        same_answers("cluster: after the reopen", reopened.lookup(live_probe), live_want)
        del reopened
        check(retries_total() == retries_0, "cluster: a fault-free path retried")

        # Federations with the AB baseline over the cluster's content.
        t0 = time.perf_counter()
        ab = BASELINE_FACTORIES["AB"](Table(keys=live_keys, columns=live_cols))
        ab_build_s = time.perf_counter() - t0
        fprobe = np.concatenate([live_keys, absent])
        n_live = live_keys.size

        def check_fed(name, res):
            check(bool(res.exists[:n_live].all()) and not res.exists[n_live:].any(),
                  f"cluster: {name}: existence differs")
            for c, col in live_cols.items():
                check(np.array_equal(np.asarray(res.values[c])[:n_live], col),
                      f"cluster: {name}: column {c} differs")

        rep = FederatedStore([cluster, ab], mode="replicate", policy="round_robin")
        before = read_launches()
        t0 = time.perf_counter()
        rres = rep.query().where_keys(fprobe).morsel(1 << 16).execute()
        rep_s = time.perf_counter() - t0
        after = read_launches()
        check_fed("replicate federation", rres)
        no_retries("replicate federation", rres.explain)
        check(rep._rr > 2 and after["fused_lookup"] > before["fused_lookup"],
              "cluster: round robin did not reach both replicas")
        median = int(np.median(live_keys))
        part = FederatedStore([cluster, ab], mode="partition", boundaries=[median])
        t0 = time.perf_counter()
        pres = part.query().where_keys(fprobe).execute()
        part_s = time.perf_counter() - t0
        check_fed("partition federation", pres)
        no_retries("partition federation", pres.explain)
        for build_q in (lambda s: s.select("o_clerk").where("o_orderstatus", "==", "O").scan(),
                        lambda s: s.group_by("o_orderstatus").agg("count", ("sum", "o_clerk"))
                        .scan()):
            got, want = build_q(part.query()).execute(), build_q(cluster.query()).execute()
            no_retries("partition federation plan", got.explain)
            # Values equal, not bytes: an AB member and a retrained shard
            # may decode a column to another integer width.
            check(same_result(got, want) if hasattr(want, "aggregates") else
                  got.keys.tobytes() == want.keys.tobytes()
                  and all(np.array_equal(got.values[c], want.values[c]) for c in want.values),
                  "cluster: the partition federation's plan differs")
        check(retries_total() == retries_0, "cluster: a fault-free path retried")

        # Replicate failover: member 0 (the cluster) killed at collect.
        kill = FaultPlan([FaultSpec(site="member_collect", owner="member:0", kind="raise")])
        with kill.activate():
            fres = rep.query().where_keys(fprobe).morsel(1 << 16).execute()
        check_fed("replicate federation, member 0 down", fres)
        check(kill.fired > 0 and len(fres.explain.owners_failed) > 0,
              "cluster: the replicate federation did not fail over")

        # A shard fault recovered by one retry; a dead shard in raise mode.
        once = FaultPlan([FaultSpec(site="shard_collect", owner="shard:2", kind="raise",
                                    times=1)])
        with once.activate():
            ores = cluster.query().where_keys(live_probe).execute()
        same_answers("cluster: after one retried shard fault", (ores.values, ores.exists), live_want)
        check(once.fired == 1 and ores.explain.retries == 1 and ores.explain.owners_failed == (),
              "cluster: a shard fault was not recovered by exactly one retry")
        dead = FaultPlan([FaultSpec(site="shard_collect", owner="shard:0", kind="raise")])
        dead_error = None
        with dead.activate():
            try:
                cluster.query().where_keys(live_probe).execute()
            except OwnerFailure as err:
                dead_error = err
        check(dead_error is not None and [o.owner for o in dead_error.owners] == ["shard:0"]
              and dead_error.owners[0].attempts == DEFAULT_POLICY.max_attempts,
              "cluster: a dead shard did not surface as OwnerFailure")

        # Quarantine: one bit flipped in shard 1's aux.msgpack.
        flipped = cl_dir / "flipped"
        shutil.copytree(cl_dir / "c", flipped)
        aux_file = flipped / "shard_00001" / "aux.msgpack"
        blob = bytearray(aux_file.read_bytes())
        blob[len(blob) // 2] ^= 0x01
        aux_file.write_bytes(bytes(blob))
        refused = None
        try:
            repro_torch.open(str(flipped))
        except IntegrityError as err:
            refused = str(err)
        check(refused is not None and "aux.msgpack" in refused,
              "cluster: a flipped aux.msgpack bit was not refused")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            q = repro_torch.open(str(flipped), on_corrupt="quarantine")
        check(q.quarantined_shards() == [1]
              and any("quarantining shard 1" in str(w.message) for w in caught),
              "cluster: shard 1 was not quarantined")
        qres = q.query().where_keys(live_probe).on_error("partial").execute()
        healthy = q.partitioner.shard_of(live_probe) != 1
        same_answers("cluster: quarantined, healthy shards", (qres.values, qres.exists), live_want,
                     healthy)
        check(not qres.exists[~healthy].any()
              and qres.explain.keys_unresolved == int((~healthy).sum())
              and len(qres.explain.owners_failed) == 1,
              "cluster: the quarantined shard's keys were not reported unresolved")
        b = q.partitioner.boundaries
        scan_refused = None
        try:
            q.query().where_range(int(b[0]), int(b[1])).execute()
        except IntegrityError as err:
            scan_refused = str(err)
        check(scan_refused is not None and "quarantined" in scan_refused,
              "cluster: a scan over the quarantined range did not raise")
        del q
    finally:
        shutil.rmtree(cl_dir, ignore_errors=True)
    cl_launches = paths["cluster"] = read_launches()
    check(cl_launches["fused_lookup"] > 0 and cl_launches["fused_lookup_with_preds"] > 0
          and cl_launches["fused_mlp"] > 0, "cluster: K1 (with predicate tables) or K2 missing")
    cl_st = cluster.engines.stats
    check(cl_st.fused_calls > 0 and cl_st.jit_calls == 0, "cluster: a shard left the fused tier")
    emit("cluster", rows=n_tr, config={"num_shards": cl_config.num_shards,
                                       "policy": cl_config.policy,
                                       "max_workers": cl_config.max_workers,
                                       "retrain_after_modified_bytes": 1},
         boundaries=cluster.partitioner.boundaries.tolist(), build_s=cl_build_s,
         shards=cl_shards, memorized_fraction=cluster.memorized_fraction(),
         aux_rows=sum(s.aux.num_rows for s in cluster.shards),
         compression_ratio=cluster.compression_ratio(), size_bytes=cluster.size_bytes(),
         size_breakdown=cluster.size_breakdown(), build_launches=cl_build_launches,
         absent_checked=int(absent.size), out_of_capacity_checked=int(out_cap.size),
         lookups=cl_lookups, plans=cl_runs, execute_plans_s=cl_together_s,
         plan_launches=cl_plan_launches, mutations=10_000, dirty_shards=dirty,
         retrained=retrained, retrain_s=cl_retrain_s, retrain_shards=retrain_recs,
         save_s=cl_save_s, load_s=cl_load_s, manifest_bytes=cl_bytes["manifest.msgpack"],
         cluster_bytes=sum(cl_bytes.values()), ab_build_s=ab_build_s,
         federation={"replicate_s": rep_s, "replicate_morsels": rres.explain.morsels,
                     "replicate_dispatches": rep._rr, "partition_s": part_s,
                     "partition_boundary": median, "failover_fired": kill.fired,
                     "failover_owners_failed": list(fres.explain.owners_failed),
                     "health": rep.health.snapshot()},
         faults={"retried_fired": once.fired, "retried_retries": ores.explain.retries,
                 "dead_fired": dead.fired, "dead_owner": dead_error.owners[0].describe()},
         quarantine={"refused": refused, "keys_unresolved": qres.explain.keys_unresolved,
                     "scan_refused": scan_refused},
         stats={k: getattr(cl_st, k) for k in ("dispatches", "fused_calls", "pallas_calls",
                                               "fused_streamed_calls", "jit_calls")},
         launches=cl_launches)
    del rep, part, ab, rres, pres, fres, ores, qres, live_want

    # --------------------------------------------------------- 10. serve
    # The batched LookupServer over the train phase's single store and
    # the cluster (as the cluster phase left it), then the launcher; host
    # times here are taken before the baseline pool starts.
    reset_launches()
    serve_dir = ROOT / "build" / f"chip_smoke_serve_{os.getpid()}"
    shutil.rmtree(serve_dir, ignore_errors=True)
    serve_dir.mkdir(parents=True)
    try:
        serve_rec, serve_checks = serve_phase(
            args.seed, tstore, train_table, cluster, (live_keys, live_cols),
            np.concatenate([train_table.keys[cl_upd], train_table.keys[cl_del]]),
            read_launches, serve_dir)
        serve_launches = paths["serve"] = read_launches()
        serve_checks()
    finally:
        shutil.rmtree(serve_dir, ignore_errors=True)
    check(serve_launches["fused_lookup"] > 0 and serve_launches["fused_mlp"] > 0,
          "serve: K1 or K2 was not launched")
    emit("serve", **serve_rec, launches=serve_launches)
    cluster.close()
    del cluster

    # The baseline pool (phase 13's stores) starts here, beside the
    # correlated and multikey phases, on all cores but two: a training
    # step there is launch-bound on one core.  Spawned workers, never
    # forked from this process, which holds a CUDA context.
    bl_dir = ROOT / "build" / f"chip_smoke_baselines_{os.getpid()}"
    bl_dir.mkdir(parents=True, exist_ok=True)
    cleanup.callback(shutil.rmtree, bl_dir, ignore_errors=True)
    bl_workers = max(1, min(len(BASELINE_JOBS), (os.cpu_count() or 1) - 2))
    bl_t0 = time.perf_counter()
    bl_pool = multiprocessing.get_context("spawn").Pool(bl_workers)
    cleanup.callback(bl_pool.join)
    cleanup.callback(bl_pool.terminate)
    bl_jobs = [bl_pool.apply_async(baseline_job, (t, f, args.seed, str(bl_dir)))
               for t, f in BASELINE_JOBS]

    # --------------------------------------------------- 11. correlated
    # TPC-DS customer_demographics at its full 1,920,800 rows (every
    # column a periodic function of the key) under the reference
    # benchmark's DM-R config, built with repro_torch.build on the card:
    # lossless on every key, absent and out-of-capacity keys absent; the
    # residue periods found, training, memorization, T_aux, Eq. 1,
    # per-column accuracy against the majority share, the lookup's split;
    # the query phase's scan and where plans against their oracles and
    # pushdown(False); a save and reopen through repro_torch.open.
    cd_table = customer_demographics_like()
    cd_cfg = DeepMappingConfig(**DMR, train=trainer_lib.TrainConfig(
        epochs=DMR_EPOCHS, batch_size=DMR_BATCH))
    reset_launches()
    trained.clear()
    trainer_lib.train = timed_train
    try:
        t0 = time.perf_counter()
        cd_store = repro_torch.build(cd_table, cd_cfg, device=dev)
        torch.cuda.synchronize()
        cd_build_s = time.perf_counter() - t0
    finally:
        trainer_lib.train = real_train
    cd_build_launches = read_launches()
    cd_hist = trained["history"]
    check(len(cd_hist) > 0 and all(np.isfinite(cd_hist)), "DM-R training gave no finite loss")
    n_cd = cd_table.num_rows
    cd_cap = cd_store.encoder.capacity
    cd_absent = np.concatenate([[0], rng.integers(n_cd + 1, cd_cap, 100_000 - 1)])
    cd_out = np.concatenate([rng.integers(cd_cap, 2**40, 1000), -rng.integers(1, 2**31, 1000)])
    t0 = time.perf_counter()
    cd_vals, cd_ex, cd_ls = cd_store._lookup_with_stats(cd_table.keys)
    cd_lookup_s = time.perf_counter() - t0
    check(bool(cd_ex.all()), "correlated: a present key reads as absent")
    for c, col in cd_table.columns.items():
        check(np.array_equal(cd_vals[c], col), f"correlated: column {c} is not lossless")
    check(not cd_store.lookup(cd_absent)[1].any(), "correlated: an absent key reads as present")
    check(not cd_store.lookup(cd_out)[1].any(),
          "correlated: an out-of-capacity key reads as present")
    cd_st = cd_store.engine.stats
    check(cd_st.fused_calls > 0 and cd_st.jit_calls == 0, "correlated: left the fused tier")
    # The model's own codes (before T_aux) per column, and the share of
    # the most frequent value: the accuracy of always answering it.
    cd_pred = cd_store.engine.infer(cd_table.keys)
    per_column = {}
    for i, t in enumerate(cd_store.spec.tasks):
        truth = cd_store.codecs[t].codes
        per_column[t] = {"accuracy": float((cd_pred[:, i] == truth).mean()),
                         "majority_share": float(np.bincount(truth).max() / n_cd),
                         "cardinality": cd_store.codecs[t].cardinality}
    del cd_pred

    pe = "cd_purchase_estimate"
    cd_nine = ((pe, ">=", 1000), (pe, "<", 9000), (pe, "!=", 5000), (pe, ">", 1500),
               (pe, "<=", 8500), ("cd_credit_rating", "!=", "Unknown"),
               ("cd_credit_rating", "in", ("Good", "High Risk", "Low Risk")),
               ("cd_education_status", "!=", "Primary"),
               ("cd_education_status", "in", ("College", "Unknown", "2 yr Degree",
                                               "4 yr Degree")))
    cd_lo, cd_hi = n_cd // 4, n_cd // 2
    cd_qk = rng.permutation(np.concatenate([rng.choice(cd_table.keys, 32_768, replace=False),
                                            rng.integers(0, 2 * n_cd, 32_768)]))
    cd_plans = [described(name, d, cd_table.keys, cd_table.columns, cd_lo, cd_hi, cd_qk)
                for name, d in (
        ("scan_where", {"src": "scan", "select": (pe,),
                        "where": (("cd_education_status", "==", "College"),
                                  ("cd_credit_rating", "in", ("Good", "Low Risk")))}),
        ("count", {"src": "scan", "group": ("cd_gender", "cd_marital_status"),
                   "aggs": ("count",)}),
        ("point_where", {"src": "point", "where": (("cd_dep_count", "<", 2),)}),
        ("agg_where", {"src": "scan", "where": (("cd_marital_status", "!=", "M"),),
                       "group": ("cd_credit_rating",),
                       "aggs": ("count", ("sum", pe), ("min", pe), ("max", pe))}),
        ("range_where", {"src": "range", "select": ("cd_education_status",),
                         "where": (("cd_credit_rating", "==", "High Risk"),)}),
        ("point_where9", {"src": "point", "where": cd_nine}),
    )]
    cd_runs, cd_together_s = run_plans(cd_store, cd_plans)
    for r in cd_runs:
        r["infer_share"] = r["split_s"]["infer_s"] / r["wall_s"]
    # Saved and reopened through repro_torch.open: the same answers.
    cd_probe = np.concatenate([cd_table.keys, cd_absent, cd_out])
    want_v, want_e = cd_store.lookup(cd_probe)
    cd_dir = ROOT / "build" / f"chip_smoke_cd_{os.getpid()}"
    shutil.rmtree(cd_dir, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        cd_store.save(str(cd_dir))
        cd_save_s = time.perf_counter() - t0
        cd_artifacts = {f.name: f.stat().st_size for f in sorted(cd_dir.iterdir())}
        t0 = time.perf_counter()
        cd_loaded = repro_torch.open(str(cd_dir))
        cd_load_s = time.perf_counter() - t0
        got_v, got_e = cd_loaded.lookup(cd_probe)
    finally:
        shutil.rmtree(cd_dir, ignore_errors=True)
    check(cd_loaded.device.type == "cuda" and np.array_equal(got_e, want_e),
          "correlated: existence differs after the reopen")
    for c in want_v:
        check(got_v[c].dtype == want_v[c].dtype and got_v[c].tobytes() == want_v[c].tobytes(),
              f"correlated: column {c} differs after the reopen")
    del cd_loaded, got_v, want_v
    cd_launches = paths["correlated"] = read_launches()
    check(cd_launches["fused_lookup"] > 0 and cd_launches["fused_lookup_with_preds"] > 0,
          "correlated: K1 was not launched, or never with predicate tables")
    # K1 and K2 on this store's model and residue features against their
    # plain versions: present keys, absent keys and the capacity's edges.
    cd_edges = np.array([-1, 0, cd_cap - 1, cd_cap, 2**31 - 1], dtype=np.int64)
    cd_kernels = store_kernels_vs_plain(cd_store, np.concatenate([
        cd_edges, rng.permutation(np.concatenate([
            rng.choice(cd_table.keys, 61_440, replace=False),
            cd_absent[: 65_536 - 61_440 - cd_edges.size]]))]))
    emit("correlated", rows=n_cd, config={**DMR, "epochs": DMR_EPOCHS, "batch": DMR_BATCH},
         residues=list(cd_store.encoder.residues), width=cd_store.encoder.width,
         feature_width=cd_store.spec.width, capacity=cd_cap,
         cards={t: v["cardinality"] for t, v in per_column.items()},
         epochs_run=len(cd_hist), early_stopped=len(cd_hist) < DMR_EPOCHS,
         steps=trained["steps"], train_s=trained["seconds"],
         s_per_epoch=trained["seconds"] / len(cd_hist),
         steps_per_s=trained["steps"] / trained["seconds"], first_loss=cd_hist[0],
         last_loss=cd_hist[-1], build_s=cd_build_s,
         memorized_fraction=cd_store.memorized_fraction(), aux_rows=cd_store.aux.num_rows,
         compression_ratio=cd_store.compression_ratio(), size_bytes=cd_store.size_bytes(),
         size_breakdown=cd_store.size_breakdown(), raw_bytes=cd_store.raw_bytes,
         per_column=per_column, absent_checked=int(cd_absent.size),
         out_of_capacity_checked=int(cd_out.size),
         lookup={"keys": n_cd, "wall_s": cd_lookup_s, "keys_per_s": n_cd / cd_lookup_s,
                 "infer_s": cd_ls.infer_s, "exist_s": cd_ls.exist_s, "aux_s": cd_ls.aux_s,
                 "decode_s": cd_ls.decode_s},
         plans=cd_runs, execute_plans_s=cd_together_s, range=[cd_lo, cd_hi],
         point_keys=int(cd_qk.size), save_s=cd_save_s, load_s=cd_load_s,
         artifact_bytes=cd_artifacts, reopen_keys_checked=int(cd_probe.size),
         stats={k: getattr(cd_st, k) for k in ("dispatches", "fused_calls", "pallas_calls",
                                               "fused_streamed_calls", "jit_calls")},
         build_launches=cd_build_launches, launches=cd_launches,
         kernels_vs_plain=cd_kernels)

    # ------------------------------------------------------ 12. multikey
    # MultiKeyMapping over a customer_demographics prefix under DM-R, two
    # key choices: (key, credit rating) packs into int32 and serves
    # through K1; (key, purchase estimate) packs past int32 (raw integers
    # up to 10,000, radix 10,001), so the engine takes the host-digits
    # tier, K2, with the existence test on the host.  Each is lossless
    # on every row; unknown combinations read as absent.
    mk_table = customer_demographics_like(n=MK_ROWS)
    mk_choices = (("__key__", "cd_credit_rating"), ("__key__", "cd_purchase_estimate"))
    reset_launches()
    t0 = time.perf_counter()
    mk_cfg = dataclasses.replace(cd_cfg, train=dataclasses.replace(cd_cfg.train,
                                                                   epochs=MK_EPOCHS))
    mk = MultiKeyMapping.build(mk_table, mk_choices, mk_cfg, device=dev)
    torch.cuda.synchronize()
    mk_build_s = time.perf_counter() - t0
    mk_build_launches = read_launches()
    by_choice = {}
    for choice in mk_choices:
        col = choice[1]
        s = mk._stores[choice]
        st = s.engine.stats
        before = read_launches()
        calls = (st.fused_calls, st.pallas_calls)
        t0 = time.perf_counter()
        vals, ex = mk.lookup(choice, [mk_table.keys, mk_table.columns[col]])
        wall = time.perf_counter() - t0
        check(bool(ex.all()), f"multikey {choice}: a row reads as absent")
        check(set(vals) == set(mk_table.columns) - {col}, f"multikey {choice}: columns differ")
        for c, v in vals.items():
            check(np.array_equal(v, mk_table.columns[c]), f"multikey {choice}: {c} differs")
        rows = rng.integers(0, MK_ROWS, 20_000)
        domain = np.unique(mk_table.columns[col])
        shifted = domain[(np.searchsorted(domain, mk_table.columns[col][rows]) + 1) % domain.size]
        unseen = np.array(["Excellent"] if col == "cd_credit_rating" else [-5])
        for keys, values, what in (
                (mk_table.keys[rows], shifted, "another attribute value"),
                (mk_table.keys[rows] + MK_ROWS, mk_table.columns[col][rows], "a key past the prefix"),
                (mk_table.keys[:1], unseen, "a value outside the domain")):
            check(not mk.lookup(choice, [keys, values])[1].any(),
                  f"multikey {choice}: {what} reads as present")
        after = read_launches()
        took = {"fused": st.fused_calls - calls[0], "pallas_digits": st.pallas_calls - calls[1]}
        by_choice[" + ".join(choice)] = {
            "capacity": s.encoder.capacity, "int32": s.encoder.capacity <= 2**31 - 1,
            "tier": [t for t, k in took.items() if k], "lookup_s": wall,
            "keys_per_s": MK_ROWS / wall, "memorized_fraction": s.memorized_fraction(),
            "aux_rows": s.aux.num_rows, "residues": list(s.encoder.residues),
            "compression_ratio": s.compression_ratio(), "jit_calls": st.jit_calls,
            "lookup_launches": {k: after[k] - before[k] for k in after}}
    narrow, wide = by_choice.values()
    check(narrow["int32"] and narrow["tier"] == ["fused"]
          and narrow["lookup_launches"]["fused_lookup"] > 0,
          "multikey: the int32 choice did not serve through K1")
    check(not wide["int32"] and wide["tier"] == ["pallas_digits"]
          and wide["lookup_launches"]["fused_mlp"] > 0
          and wide["lookup_launches"]["fused_lookup"] == 0,
          "multikey: the choice past int32 did not serve through K2")
    check(narrow["jit_calls"] == 0 and wide["jit_calls"] == 0, "multikey: a plain tier was taken")
    mk_launches = paths["multikey"] = read_launches()
    # Each choice's kernel (K1 for the int32 one, K2 on host digits for
    # the other) on its store's model against the plain version: packed
    # keys of the prefix, packed keys past it, and the domain's edges.
    for choice in mk_choices:
        s = mk._stores[choice]
        radix = mk._key_radices[choice][1]
        codec = mk._key_codecs[choice][1]
        part = mk_table.columns[choice[1]] if codec is None else codec.codes
        packed = mk_table.keys.astype(np.int64) * radix + part
        mcap = s.encoder.capacity
        edges_mk = np.array([-1, 0, mcap - 1, mcap], dtype=np.int64)
        by_choice[" + ".join(choice)]["kernels_vs_plain"] = store_kernels_vs_plain(
            s, np.concatenate([edges_mk, rng.permutation(np.concatenate([
                rng.choice(packed, 61_440, replace=False),
                rng.integers(0, mcap, 65_536 - 61_440 - edges_mk.size)]))]))
    emit("multikey", rows=MK_ROWS, epochs=MK_EPOCHS, choices=by_choice, build_s=mk_build_s,
         build_launches=mk_build_launches, size_bytes=mk.size_bytes(), launches=mk_launches)
    del mk

    # ----------------------------------------------------- 13. baselines
    # Every AB/HB factory on customer_demographics and on SF1 orders,
    # built, checked, saved, bit-flipped and reopened by the pool started
    # before phase 11; the hash stores' reopened lookups are timed in
    # their workers (about 15,000-40,000 keys/s, a core's work either
    # way).  Each array store's saved file is reopened here through
    # repro_torch.open and its lookup timed as the DeepMapping stores'
    # are, with at most one worker still running beside it
    # (``workers_beside``), and again alone if one was.  The two
    # DeepMapping stores (train's SF1 store, correlated's DM-R store) are
    # probed the same way once the pool is done.
    tables = {"orders": train_table, "customer_demographics": cd_table,
              "customer_demographics_prefix": customer_demographics_like(n=HBCL_CD_ROWS)}

    def reopen_and_time(table_name, path):
        """Reopen a saved file here, time its lookup of the probe, and
        check it exact; its kind and the digest of its answers are held
        against the worker's store once the worker returns."""
        t = tables[table_name]
        keys, present = baseline_probe(t, args.seed)
        t0 = time.perf_counter()
        reopened = repro_torch.open(path)
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        values, exists = reopened.lookup(keys)
        lookup_s = time.perf_counter() - t0
        check_probe(f"{path} reopened", t, keys, present, values, exists)
        return {"load_s": load_s, "lookup_s": lookup_s, "lookup_keys_per_s": keys.size / lookup_s,
                "type": type(reopened).__name__, "digest": answers_digest(values, exists)}

    files = [baseline_file(str(bl_dir), t, f) for t, f in BASELINE_JOBS]
    timed_here = [f.startswith("AB") for _, f in BASELINE_JOBS]
    waited_t0 = time.perf_counter()
    # An array store's saved file is reopened and timed once at most one
    # job is left: that lone worker holds one core.
    lone = [None] * len(bl_jobs)
    while True:
        running = sum(not j.ready() for j in bl_jobs)
        todo = [i for i, f in enumerate(files)
                if timed_here[i] and lone[i] is None and os.path.exists(f)]
        if not todo and not running:
            break
        if running > 1 or not todo:
            time.sleep(0.05)
            continue
        for i in todo:
            lone[i] = reopen_and_time(BASELINE_JOBS[i][0], files[i])
            lone[i]["workers_beside"] = running
    stores = [j.get() for j in bl_jobs]  # a failed check in a worker raises here
    pool_s = time.perf_counter() - bl_t0
    waited_s = time.perf_counter() - waited_t0
    bl_pool.terminate()
    bl_pool.join()
    # The array stores (the baselines whose lookups rival DeepMapping's)
    # timed beside that worker are timed again with nothing beside them.
    for i, row in enumerate(stores):
        digest = row.pop("digest")
        if timed_here[i]:
            if lone[i]["workers_beside"]:
                beside = lone[i]
                lone[i] = {**reopen_and_time(row["table"], files[i]), "workers_beside": 0,
                           "beside": {k: beside[k] for k in ("load_s", "lookup_s",
                                                              "lookup_keys_per_s")}}
            label = f"{row['store']} on {row['table']}"
            check(lone[i].pop("type") == row["type"], f"{label}: reopened as another kind")
            check(lone[i].pop("digest") == digest,
                  f"{label}: the reopened store answers otherwise than before its save")
            row["worker"] = {k: row[k] for k in ("load_s", "lookup_s", "lookup_keys_per_s")}
            row.update(lone[i], timed_in="main")
        os.remove(files[i])
    reset_launches()
    dm_rows = []
    for name, s, tname, bs in (("DM (PAPER_STORE, train)", tstore, "orders", tbuild_s),
                               ("DM-R (correlated)", cd_store, "customer_demographics",
                                cd_build_s)):
        t = tables[tname]
        keys, present = baseline_probe(t, args.seed)
        t0 = time.perf_counter()
        values, exists = s.lookup(keys)
        wall = time.perf_counter() - t0
        check_probe(name, t, keys, present, values, exists)
        dm_rows.append({"table": tname, "store": name, "rows": t.num_rows,
                        "size_bytes": s.size_bytes(), "ratio": s.compression_ratio(),
                        "build_s": bs, "lookup_s": wall, "lookup_keys_per_s": keys.size / wall})
    paths["baselines"] = read_launches()
    emit("baselines", workers=bl_workers, pool_s=pool_s, waited_s=waited_s,
         pool_beside=["correlated", "multikey"],
         probe={"present": PROBE_PRESENT, "absent": PROBE_ABSENT}, stores=stores,
         deepmapping=dm_rows, launches=paths["baselines"])
    del cd_store

    # -------------------------------------------------------- 14. times
    n = 65536
    kp = rng.choice(table.keys, n).astype(np.int32)
    kt = torch.from_numpy(kp).to(dev)
    digits, _ = digits_of(kt)
    flops_key = flops_per_key(spec)
    io_k1 = n * (4 + 4 * m + 4) + wbytes + int(words.numel()) * 4 + int(pos_ops.numel()) * 4
    io_k2 = n * (4 * spec.width + 4 * m) + wbytes
    kernels = []
    for name, fn, plain, io, src_line in (
        ("fused_lookup",
         lambda: fm.fused_lookup_call(kt, pos_ops, words, flat, spec, 256, base_pad, cap),
         lambda: ref.fused_lookup(kt, pos_ops, words, flat, spec, cap),
         io_k1, "src/repro/kernels/fused_mlp.py:322"),
        ("fused_mlp",
         lambda: fm.fused_mlp_call(digits, flat, spec, 256, base_pad, ops.card_pads(spec), True),
         lambda: ref.fused_mlp(digits, flat, spec, True),
         io_k2, "src/repro/kernels/fused_mlp.py:162"),
    ):
        plain_a = time_ms(plain)
        ms = time_ms(fn)
        ms_b = time_ms(fn)
        plain_b = time_ms(plain)
        t_ops = n * flops_key / PEAK_FP32_FLOPS * 1e3
        t_io = io / PEAK_BYTES_PER_S * 1e3
        kernels.append({
            "name": name, "route": "cuda", "source": "src/repro_torch/csrc/fused_mlp.cu",
            "replaces": src_line, "launches": sum(c[name] for c in paths.values()),
            "launches_by_path": {path: c[name] for path, c in paths.items()},
            **({"launches_with_preds_by_path": {path: c["fused_lookup_with_preds"]
                                                for path, c in paths.items()}}
               if name == "fused_lookup" else {}),
            "max_abs_err": kern_err[name], "ms": min(ms, ms_b),
            "plain_ms": min(plain_a, plain_b), "bound_ms": max(t_ops, t_io),
            "bound_by": "operations" if t_ops >= t_io else "bytes", "library_ms": None,
            "ms_runs": [ms, ms_b], "plain_ms_runs": [plain_a, plain_b],
            "flops": n * flops_key, "bytes": io,
        })
    # K3 at one 65,536-key chunk and at its path's largest call (every
    # present key plus the absent ones).  Bound: keys in and bits out
    # once, and each word these keys touch read once.
    k3_times = {}
    for n3 in (n, k3_inputs[-1].size):
        kh = k3_inputs[-1][:n3]
        k3 = torch.from_numpy(np.where((kh >= 0) & (kh <= 2**31 - 1), kh, -1)).to(dev)
        kp3 = torch.nn.functional.pad(k3.to(torch.int32), (0, -n3 % 1024))
        plain_a = time_ms(lambda: ref.ref_bitvector_test(words, kp3))
        ms = time_ms(lambda: bvk.bitvector_call(kp3, words, 1024))
        ms_b = time_ms(lambda: bvk.bitvector_call(kp3, words, 1024))
        plain_b = time_ms(lambda: ref.ref_bitvector_test(words, kp3))
        touched = np.unique(kh[(kh >= 0) & (kh < dom)] >> 5).size
        io = int(kp3.numel()) * 8 + touched * 4
        k3_times[n3] = {"ms": min(ms, ms_b), "plain_ms": min(plain_a, plain_b),
                        "bound_ms": io / PEAK_BYTES_PER_S * 1e3, "ms_runs": [ms, ms_b],
                        "plain_ms_runs": [plain_a, plain_b], "keys": int(kp3.numel()),
                        "words_touched": touched, "bytes": io}
    sf1 = k3_times[k3_inputs[-1].size]
    kernels.append({
        "name": "bitvector", "route": "cuda", "source": "src/repro_torch/csrc/bitvector.cu",
        "replaces": "src/repro/kernels/bitvector.py:47",
        "launches": sum(c["bitvector"] for c in paths.values()),
        "max_abs_err": k3_err, **k3_times[n], "bound_by": "bytes", "library_ms": None,
        "launches_by_path": {path: c["bitvector"] for path, c in paths.items()},
        "ms_sf1": sf1["ms"], "plain_ms_sf1": sf1["plain_ms"], "bound_ms_sf1": sf1["bound_ms"],
        "keys_sf1": sf1["keys"], "sf1_runs": {k: sf1[k] for k in ("ms_runs", "plain_ms_runs",
                                                                  "words_touched", "bytes")},
    })
    # K1 and K2 under every plan of the store's model that fits, same keys.
    by_plan = {}
    pads = ops.card_pads(spec)
    for p in fm._candidate_plans(spec):
        if p.smem_bytes > fm.SMEM_LIMIT:
            continue
        by_plan[f"{p.tile.name}/{p.schedule}/slab {p.slab}"] = {
            "fused_lookup_ms": time_ms(
                lambda: fm._fused_lookup(kt, pos_ops, words, flat, spec, 256, base_pad, cap,
                                         plan=p)),
            "fused_mlp_ms": time_ms(
                lambda: fm._fused_mlp(digits, flat, spec, 256, base_pad, pads, True, plan=p)),
        }
    # The wrappers' host time per launch (their plan is cached per spec),
    # and what computing the plan costs where it is not: one first fit,
    # and every candidate (16 at the store's shape).
    host = {
        "fused_lookup_ms": host_ms(
            lambda: fm.fused_lookup_call(kt, pos_ops, words, flat, spec, 256, base_pad, cap)),
        "fused_mlp_ms": host_ms(
            lambda: fm.fused_mlp_call(digits, flat, spec, 256, base_pad, pads, True)),
        "plan_uncached_ms": host_ms(lambda: fm.tile_plan.__wrapped__(spec)),
        "all_candidates_ms": host_ms(lambda: list(fm._candidate_plans(spec))),
    }
    # A yardstick of fp32 GEMM on this card, not a library time for K1 or
    # K2: one torch.matmul of the trunk's dense layer at this batch, TF32 off.
    xd = torch.rand((n, 256), device=dev)
    wd = torch.rand((256, 256), device=dev)
    dense_ms = time_ms(lambda: torch.matmul(xd, wd))
    # Registers and spills per instantiation, from nvcc's -Xptxas -v.
    regs, entry = {}, None
    for ln in build.BUILD_INFO["fused_mlp.cu"]["log"].splitlines():
        hit = re.search(r"(fused_(?:mlp|lookup)_kernel)ILi(\d+)ELi(\d+)ELi(\d+)E", ln)
        if "Compiling entry function" in ln and hit:
            entry = f"{hit.group(1)}<{','.join(hit.groups()[1:])}>"
            regs[entry] = {}
        elif entry and "spill" in ln:
            nums = re.findall(r"(\d+) bytes (stack frame|spill stores|spill loads)", ln)
            regs[entry].update({k.replace(" ", "_"): int(v) for v, k in nums})
        elif entry and "Used" in ln:
            regs[entry]["registers"] = int(re.search(r"Used (\d+) registers", ln).group(1))
    t0 = time.perf_counter()
    _, _, tstats = store._lookup_with_stats(keys_all[alive])
    wall = time.perf_counter() - t0
    emit("times", nvidia_smi=smi, keys_per_launch=n, flops_per_key=flops_key,
         peak_fp32_flops=PEAK_FP32_FLOPS, peak_bytes_per_s=PEAK_BYTES_PER_S,
         kernels=kernels, ms_by_plan=by_plan, wrapper_host=host,
         dense_layer_cublas_ms=dense_ms,
         dense_layer_cublas_tflops=2 * n * 256 * 256 / (dense_ms * 1e-3) / 1e12,
         ptxas_by_instantiation=regs,
         lookup={"keys": int(alive.size), "wall_s": wall, "keys_per_s": alive.size / wall,
                 "infer_s": tstats.infer_s, "exist_s": tstats.exist_s,
                 "aux_s": tstats.aux_s, "decode_s": tstats.decode_s})

    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(RECORD, indent=1))
    summary = [{k: v for k, v in kern.items() if not k.endswith("_runs")
                and k not in ("flops", "bytes", "words_touched")} for kern in kernels]
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
