#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed N]

Drives the port's main path at full width and holds every CUDA kernel
on that path against its plain PyTorch version on the card:

1. env      — card name and power limit, torch/CUDA versions, TF32 off,
              the kernel build from ``src/repro_torch/csrc``;
2. kernels  — K1 (fused lookup) and K2 (fused MLP) against their plain
              versions at buckets 256, 257, 65,536 and 65,537 plus key
              edges; K1 codes equal K2 codes byte for byte;
3. main     — a DeepMapping store over TPC-H ``orders`` at SF1 row count
              (1.5 M rows) with the paper's store config, built from
              random weights; every key looked up losslessly through the
              ``fused`` tier, absent and out-of-capacity keys absent;
              10,000 inserts/updates/deletes re-checked;
4. streamed — the same lookups through the ``fused_streamed`` tier under
              a forced budget, byte-identical to phase 3;
5. times    — kernel and plain-version times with CUDA events, the
              kernels' bounds, and whole-table lookup throughput.

Each phase prints one JSON line; any failed check raises (non-zero
exit).  The last lines are the kernel summary and
``{"ok": true, "device": {...}}``.  Without CUDA, or without the
repository's ``src/`` beside it, the script exits non-zero and prints
no result.  A full record goes to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import json
import os
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
#: TPC-H ``orders`` rows at scale factor 1.
ROWS = 1_500_000

RECORD: dict = {}


def emit(phase: str, **fields) -> None:
    line = {"phase": phase, **fields}
    RECORD[phase] = line
    print(json.dumps(line), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import storage
    from repro_torch.core import (
        BitVector, DeepMappingConfig, DeepMappingStore, InferenceEngine, KeyEncoder,
        MLPSpec, init_params,
    )
    from repro_torch.core.encoding import build_codecs
    from repro_torch.data.tpch import orders_like
    from repro_torch.kernels import fused_mlp as fm
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)

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
    fm.library()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in fm.BUILD_INFO["log"].splitlines()
             if "Compiling entry function" in ln or "registers" in ln or "spill" in ln]
    emit(
        "env", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        tf32_before={"matmul": tf32_was[0], "precision": tf32_was[1], "cudnn": tf32_was[2]},
        tf32_now={"matmul": False, "precision": "highest", "cudnn": False},
        kernel_build_s=build_s, nvcc_seconds=fm.BUILD_INFO["seconds"], ptxas=ptxas,
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
    emit("kernels_vs_plain", cases=cases, max_abs_err=kern_err, margin_rows=margin_rows,
         logit_tol=LOGIT_TOL, margin_tol=MARGIN_TOL)

    # ---------------------------------------------------------- 3. main
    fm.fused_lookup_call.launches = 0
    fm.fused_mlp_call.launches = 0
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
    absent = rng.integers(0, table.max_key, 400_000)
    absent = absent[~bv.test(absent)][:100_000]
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
    torch.cuda.synchronize()
    main_launches = {"fused_lookup": fm.fused_lookup_call.launches,
                     "fused_mlp": fm.fused_mlp_call.launches}
    check(st.fused_calls > 0 and st.pallas_calls > 0, "the kernel tiers were not taken")
    check(st.jit_calls == 0, "a plain jit tier was taken")
    check(all(v > 0 for v in main_launches.values()), "a kernel was not launched")
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

    # ------------------------------------------------------ 4. streamed
    trunk_b, head_b = ops.padded_weight_parts(spec)
    budget = trunk_b + ops.activation_bytes(spec, 256) + max(head_b.values())
    os.environ["REPRO_VMEM_BUDGET"] = str(budget)
    resident = store.engine
    streamed = InferenceEngine.for_store(store)
    entry = streamed._entry(spec.tasks)
    plan = streamed._streamed_plan(entry, True)
    check(plan is not None and len(plan[0]) > 1, "no multi-page streamed plan")
    store.attach_engine(streamed)
    before = fm.fused_lookup_call.launches
    v2, e2 = store.lookup(keys_all[alive])
    v3, e3 = store.lookup(free)
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
         fused_lookup_launches=fm.fused_lookup_call.launches - before)

    # --------------------------------------------------------- 5. times
    def time_ms(fn, reps=20, warmup=3):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b))
        return statistics.median(ts)

    n = 65536
    kp = rng.choice(table.keys, n).astype(np.int32)
    kt = torch.from_numpy(kp).to(dev)
    digits, _ = digits_of(kt)
    # Unpadded work per key: gather layer width*out adds, dense 2*in*out.
    flops_key = 0
    d = None
    for h in spec.shared:
        flops_key += spec.width * h if d is None else 2 * d * h
        d = h
    for t in spec.tasks:
        hd = d
        for h in spec.private_map[t]:
            flops_key += 2 * hd * h
            hd = h
        flops_key += 2 * hd * spec.card_map[t]
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
            "replaces": src_line, "launches": main_launches[name],
            "max_abs_err": kern_err[name], "ms": min(ms, ms_b),
            "plain_ms": min(plain_a, plain_b), "bound_ms": max(t_ops, t_io),
            "bound_by": "operations" if t_ops >= t_io else "bytes", "library_ms": None,
            "ms_runs": [ms, ms_b], "plain_ms_runs": [plain_a, plain_b],
            "flops": n * flops_key, "bytes": io,
        })
    t0 = time.perf_counter()
    _, _, tstats = store._lookup_with_stats(keys_all[alive])
    wall = time.perf_counter() - t0
    emit("times", nvidia_smi=smi, keys_per_launch=n, flops_per_key=flops_key,
         peak_fp32_flops=PEAK_FP32_FLOPS, peak_bytes_per_s=PEAK_BYTES_PER_S,
         kernels=kernels,
         lookup={"keys": int(alive.size), "wall_s": wall, "keys_per_s": alive.size / wall,
                 "infer_s": tstats.infer_s, "exist_s": tstats.exist_s,
                 "aux_s": tstats.aux_s, "decode_s": tstats.decode_s})

    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(RECORD, indent=1))
    summary = [{k: v for k, v in kern.items() if not k.endswith("_runs")
                and k not in ("flops", "bytes")} for kern in kernels]
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
