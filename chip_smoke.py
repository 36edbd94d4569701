#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed N]
    python3 chip_smoke.py --models-only [--src CHECKOUT]

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
9. times      — kernel and plain-version times with CUDA events, the
                kernels' bounds, K1/K2 under each plan of the store's
                model and on the store's heads under wider trunks (every
                plan), one fp32 ``torch.matmul`` of the trunk's 256x256
                layer as a yardstick, registers and spills per
                instantiation, and whole-table lookup throughput.

Each kernel's launches are counted on every path that drives the port
(phases 3 to 8), with the counts set to 0 just before each path and read
just after; K1's launches that carried predicate tables are counted
apart.  The launches made to compare a kernel with its plain version
(phase 2) and those of phase 9 do not count.
Each phase prints one JSON line with its seconds (``phase_s``); any
failed check raises (non-zero exit).  The last lines are the kernel summary and
``{"ok": true, "device": {...}}``.  Without CUDA, or without the
repository's ``src/`` beside it, the script exits non-zero and prints
no result.  A full record goes to ``chiprun_out/chip_smoke.json``.

``--models-only`` runs none of that: it builds the kernels of the
checkout under ``--src`` (this one by default) and prints one JSON line
of K1/K2 times on the MODELS through the public calls, so that two
checkouts can be timed in one call.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
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
    fits, forced through the private helpers, and with the codes checked
    equal across plans and between K1 and K2."""
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
                                                 cap, plan=p)),
                    "fused_mlp_ms": time_ms(
                        lambda: fm._fused_mlp(digits, flat, spec, 256, base_pad, pads, True,
                                              plan=p)),
                }
        out.append(row)
    return out


def models_only(src: Path, seed: int) -> int:
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
                      "models": model_times(torch.device("cuda"), seed, plans=False)}),
          flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--models-only", action="store_true",
                    help="only time K1 and K2 on the wider models, through the public calls")
    ap.add_argument("--src", type=Path, default=ROOT,
                    help="with --models-only: the checkout whose src/ package to time")
    args = ap.parse_args()
    if args.models_only:
        return models_only(args.src.resolve(), args.seed)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch
    from repro_torch import storage
    from repro_torch.api import execute_plans
    from repro_torch.core import (
        BitVector, DeepMappingConfig, DeepMappingStore, InferenceEngine, KeyEncoder,
        MLPSpec, init_params,
    )
    from repro_torch.core import trainer as trainer_lib
    from repro_torch.core.encoding import build_codecs
    from repro_torch.data.tpch import orders_like
    from repro_torch.fault import IntegrityError
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
    def digits_of(keys_t):
        k = keys_t.long()
        in_cap = (k >= 0) & (k < cap)
        safe = torch.where(in_cap, k, torch.zeros_like(k))
        d = torch.stack([((safe % int(md)) // int(dv)) % spec.base
                         for md, dv in encoder.position_ops()], dim=1)
        return d.to(torch.int32).contiguous(), in_cap

    def margins(digits):
        """Plain-side top-two margin per row and task (inf for card 1)."""
        lg = ref._forward_flat(flat, spec, digits, emit_codes=False)
        out = []
        for ti, t in enumerate(spec.tasks):
            card = spec.card_map[t]
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

    def plans_for(okeys, ocols, rows, prio, lo, hi, qk):
        """(name, build(store) -> Query, oracle check) for the 9 plans."""
        def point(res):
            r = rows(qk)
            ex = r >= 0
            check(np.array_equal(res.exists, ex), "point: existence differs from the oracle")
            for c in ("o_clerk", "o_orderstatus"):
                check(np.array_equal(res.values[c][ex], ocols[c][r[ex]]),
                      f"point: {c} differs from the oracle")

        def scan_where(res):
            m = (ocols["o_orderpriority"] == prio) & np.isin(ocols["o_orderstatus"], ["F", "P"])
            check_rows("scan_where", res, okeys[m], {"o_clerk": ocols["o_clerk"][m]})

        def range_all(res):
            m = (okeys >= lo) & (okeys < hi)
            check_rows("range", res, okeys[m], {c: v[m] for c, v in ocols.items()})

        def count_groups(res):
            pairs = np.char.add(np.char.add(ocols["o_orderpriority"].astype(str), "|"),
                                ocols["o_orderstatus"].astype(str))
            u, n = np.unique(pairs, return_counts=True)
            check_groups("count", res, ("o_orderpriority", "o_orderstatus"),
                         [tuple(x.split("|")) for x in u], {"count": n})
            check(res.explain.rows_decoded == 0, "count-only group_by decoded rows")

        jlo, jhi = lo, lo + (hi - lo) // 2

        def self_join(res):
            left = np.flatnonzero((okeys >= jlo) & (okeys < jhi))
            r = rows(okeys[left] + 1)
            keep = r >= 0
            check_rows("self_join", res, okeys[left][keep],
                       {"o_clerk": ocols["o_clerk"][left][keep],
                        "o_orderpriority": ocols["o_orderpriority"][r[keep]]})

        def point_where(res):
            r = rows(qk)
            hit = r >= 0
            hit[hit] = ocols["o_clerk"][r[hit]] < 100
            check_rows("point_where", res, qk[hit],
                       {c: ocols[c][r[hit]] for c in ocols})

        def agg_where(res):
            m = ocols["o_orderpriority"] != prio
            st_ = ocols["o_orderstatus"][m]
            ck = ocols["o_clerk"][m].astype(np.int64)
            u = np.unique(st_)
            check_groups("agg_where", res, ("o_orderstatus",), [(x,) for x in u], {
                "count": np.array([(st_ == x).sum() for x in u]),
                "sum(o_clerk)": np.array([ck[st_ == x].sum() for x in u]),
                "min(o_clerk)": np.array([ck[st_ == x].min() for x in u]),
                "max(o_clerk)": np.array([ck[st_ == x].max() for x in u])})

        def range_where(res):
            m = (okeys >= lo) & (okeys < hi) & (ocols["o_orderstatus"] == "O")
            check_rows("range_where", res, okeys[m],
                       {"o_orderpriority": ocols["o_orderpriority"][m]})

        nine = (("o_clerk", ">=", 10), ("o_clerk", "<", 900), ("o_clerk", "!=", 50),
                ("o_clerk", ">", 20), ("o_clerk", "<=", 800),
                ("o_orderstatus", "!=", "P"), ("o_orderstatus", "in", ("F", "O")),
                ("o_orderpriority", "!=", prio),
                ("o_orderpriority", "in",
                 tuple(np.unique(ocols["o_orderpriority"])[:4].tolist())))
        cmp = {">=": lambda a, v: a >= v, "<": lambda a, v: a < v,
               "!=": lambda a, v: a != v, ">": lambda a, v: a > v,
               "<=": lambda a, v: a <= v, "in": lambda a, v: np.isin(a, v)}

        def point_where9(res):
            r = rows(qk)
            hit = r >= 0
            for c, op, v in nine:
                hit[hit] = cmp[op](ocols[c][r[hit]], v)
            check_rows("point_where9", res, qk[hit],
                       {c: ocols[c][r[hit]] for c in ocols})

        def where9(s):
            q = s.query()
            for c, op, v in nine:
                q = q.where(c, op, v)
            return q.where_keys(qk)

        return [
            ("point", lambda s: s.query().select("o_clerk", "o_orderstatus").where_keys(qk),
             point),
            ("scan_where", lambda s: s.query().select("o_clerk")
             .where("o_orderpriority", "==", prio).where("o_orderstatus", "in", ("F", "P"))
             .scan(), scan_where),
            ("range", lambda s: s.query().where_range(lo, hi), range_all),
            ("count", lambda s: s.query().group_by("o_orderpriority", "o_orderstatus")
             .agg("count").scan(), count_groups),
            ("self_join", lambda s: s.query().select("o_clerk").where_range(jlo, jhi)
             .join(s, key=lambda k: k + 1, columns=("o_orderpriority",)), self_join),
            ("point_where", lambda s: s.query().where("o_clerk", "<", 100).where_keys(qk),
             point_where),
            ("agg_where", lambda s: s.query().where("o_orderpriority", "!=", prio)
             .group_by("o_orderstatus").agg("count", ("sum", "o_clerk"), ("min", "o_clerk"),
                                            ("max", "o_clerk")).scan(), agg_where),
            ("range_where", lambda s: s.query().select("o_orderpriority")
             .where("o_orderstatus", "==", "O").where_range(lo, hi), range_where),
            ("point_where9", where9, point_where9),
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

    # --------------------------------------------------------- 9. times
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
    # The store's heads under wider trunks, under their own plans and
    # every other that fits.
    models = model_times(dev, args.seed, plans=True)
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
         kernels=kernels, ms_by_plan=by_plan, models=models, wrapper_host=host,
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
