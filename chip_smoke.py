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
                against the plain version.  Then ``mhas_space``: the MHAS
                search space over the store's table at the paper's layer
                sizes (100 to 2,000, depth 2; a 14-matrix weight bank)
                with its LSTM controller, both made on the card from
                ``--seed``; eight children (four fixed: depth 2 at width
                2,000 everywhere, depth 0 everywhere, the trunk at depth 0
                under 2 x 2,000 heads, the trunk at 2 x 2,000 under heads
                of depth 0; four drawn by ``sample_arch``, each draw's logp
                equal to ``logprob_of``'s) cut from the bank and run through
                K2 on 16,384 SF1 keys: the logits against the masked
                forward within 1e-4, the codes equal to its argmax but on
                near ties, and both against K2's plain version; each
                child's widths, tile plan, largest difference, margin rows
                and seconds.  Then each child through an
                ``InferenceEngine`` of its own, on the tier the engine's
                budget rule picks (K2 through ``pallas_digits``, K1
                through ``fused_streamed``, or the plain path): its codes
                equal to the masked forward's but on near ties, its
                launches those of its tier;
3. bitvector  — K3 (the existence test) through ``bitvector_test`` on
                keys as a caller holds them, one launch a call: int64 and
                int32, contiguous, at offsets of 1 and 3 keys, strided,
                lengths 1 to 9 and 1,023 to 65,537 with edge keys, and all
                1.5 M present SF1 keys plus 100,000 absent ones, over the
                SF1 store's existence vector and over a 10^8-slot vector
                (12.5 MB of words, about 1.5 M keys set); equal to its
                plain version and to ``BitVector.test`` on every key; the
                reference's contract (``bitvector_call``, int32 -> int32)
                against the plain version on the two largest calls' keys;
4. main       — a DeepMapping store over TPC-H ``orders`` at SF1 row
                count (1.5 M rows) with the paper's store config, built
                from random weights; every key looked up losslessly
                through the ``fused`` tier, absent and out-of-capacity
                keys absent; 10,000 inserts/updates/deletes re-checked;
5. streamed   — the same lookups through the ``fused_streamed`` tier
                under a forced budget, byte-identical to phase 4;
6. lm_serve   — the LM substrate's dense decoders through the serve
                steps (``make_prefill_step``, ``make_decode_step``,
                ``make_cache_factory``), no DeepMapping kernel on the
                path: tinyllama-1.1b at full width and depth (22 layers,
                d_model 2,048, 32 heads over 4 kv heads, d_ff 5,632,
                vocab 32,000), weights from ``DecoderLM.init`` on the card
                in fp32, their count against ``param_count_estimate``;
                64 tokens of 2 sequences decoded step by step from an
                empty cache against their prefill within 2e-3; the same
                weights in bf16: a 4 x 2,048-token prefill (tokens/s,
                every logit finite, argmaxes equal to the fp32 prefill's
                on 99% of the rows with an fp32 top-two margin of 0.1 or
                more), a greedy decode of 64 steps at batch 4 in a
                2,112-slot cache (ms a step), peak device memory; then
                gemma3-1b at full width (window 512, tied), its depth cut
                to 8 layers (one 6-layer group and a 2-layer remainder):
                a 1,024-token fp32 prefill, banded on its windowed layers,
                against the windowed decode of the same tokens within
                2e-3;
7. lm_recurrent — the RWKV6 and RG-LRU blocks (ROADMAP M12c-1) through the
                same serve steps, no DeepMapping kernel on the path:
                rwkv6-7b (32 RWKV6 layers, d_model 4,096, 64 heads of 64,
                d_ff 14,336, vocab 65,536) and recurrentgemma-2b (26
                layers, 18 RG-LRU and 8 local attention with window
                2,048; d_model 2,560, 10 heads over 1 kv head of 256,
                d_ff 7,680, vocab 256,000, tied) at full width and depth,
                weights from ``DecoderLM.init`` on the card in fp32, their
                count against the reference tree's (8,054,640,640 and
                2,894,481,920; the estimate beside it); 64 tokens of 2
                sequences decoded from an empty state against their
                prefill within 2e-3; the weights cast to the dtypes the
                bf16 config's own init gives (RG-LRU's ``a_param`` stays
                fp32): the prefill of 4 x 512 and 4 x 1,024 tokens
                (tokens/s, argmaxes against fp32's on 75% and 95% of the
                clear rows), a greedy decode of 64 steps at batch 4 (ms a
                step), the state's bytes a sequence, peak device memory;
8. lm_train   — the LM substrate's training path (ROADMAP M12b): the
                launcher ``repro_torch.launch.train.main`` on tinyllama-1.1b
                at full width and depth in bf16 (its batch of 8 x 65
                tokens, AdamW with warmup-cosine and clip 1.0, remat) with
                ``--compressed-data``: the DeepMapping token store built
                over its 200,000-token corpus (a 19,057-way head; T_aux
                found through K2) and every batch looked up through it
                (K1 on the fused tier); 4 steps and a 6.6 GB
                checkpoint, then the launcher again without the store to
                10 steps: resumed from ``LATEST``, the restored state
                equal bit for bit to that checkpoint's ``arrays.npz``,
                every loss finite, no restart, and the restored state's
                loss on the batch of its last step below the loss that
                step recorded; ``make_train_step`` at 4 x 2,049 tokens
                (ms a step, tokens/s, peak device memory, the model FLOPs'
                share of the bf16 peak, the bf16 loss against fp32 on the
                same weights, at the first step and after the steps);
                then the store lossless on every position, the
                launcher's batches through it equal to the raw ones, and
                K1 and K2 on its model against their plain versions on
                every position (codes equal but on near ties, counted);
9. mhas_search — MHAS (Algorithm 2, ``run_mhas``) over the same table
                under the port's ``PAPER_MHAS`` at the paper's layer
                sizes (100 to 2,000, depth 2), batches (16,384 and 2,048),
                8 samples a controller update and learning rates, its
                iterations (20), controller updates (4) and fine-tune
                epochs (5) cut for time: the history's length, each
                entry's parameter count and finite ratio, the best ratio
                the history's least, the spec and params the best arch's;
                the split of its seconds (bank steps, scoring, controller
                updates, fine-tune).  Then the searched store built
                through ``DeepMappingStore.build`` under ``PAPER_STORE``
                from the chosen child: every key lossless, absent and
                out-of-capacity keys absent, the tiers its engine took at
                build and at lookup, and the path's launches equal to
                those tiers'; then K1 and K2 on its model against their
                plain versions, and the bank freed;
10. train      — the same table built with no weights: the store trains
                at the paper's width and ``TrainConfig`` (batch 16,384,
                up to 200 epochs), evaluates T_aux through K2 and answers
                every key losslessly through K1; a few training steps
                and ``bitvector_test`` calls under one ``torch.profiler``
                session: one CUDA kernel a call on contiguous keys, and
                the call's split (word upload, kernels, wall; its own
                JSON line, ``bitvector_profile``);
11. persist   — the trained store saved by the port in the reference's
                v2 layout and reopened through ``repro_torch.open``:
                every SF1 key plus 100,000 absent and 2,000
                out-of-capacity keys answer byte for byte as before the
                save and losslessly; a bit flipped in ``vexist.bin``
                raises ``IntegrityError``; save, load and first-lookup
                seconds and each artifact's bytes;
12. query      — nine plans through ``store.query()`` on the reopened
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
13. cluster   — the reference's default cluster (``ClusterConfig()``:
                4 range shards) over the same SF1 table, every shard
                trained on the card with the train phase's config through
                ``repro_torch.build(..., cluster=...)``, one shard at a
                time and for at most 80 epochs (``CL_EPOCHS``; both cut
                for time),
                then served under the default config; the default
                build (shards on four threads at once) over a
                187,500-row prefix, every key looked up, and
                each of its shards' T_aux rows found again through K2 on
                one thread and on four at once, equal to the build's
                (after the path's counts); every key, absent and
                out-of-capacity keys through ``lookup`` (serial) and a ``where_keys`` plan (fan-out),
                byte-identical to each other and on present rows to the
                single store; the query phase's nine plans against their
                oracles and ``pushdown(False)``; 10,000 mutations in the
                last shard's range and a retrain of the shard they
                dirtied (at most 40 epochs, ``CL_RETRAIN_EPOCHS``, cut for
                time); save and reopen through ``repro_torch.open``; a
                replicate (round robin) and a partition federation with
                an AB baseline, member 0 killed in the replicate one; one
                shard fault retried, one dead shard surfacing as
                ``OwnerFailure``; a bit flipped in one shard's
                ``aux.msgpack`` refused, then quarantined with the healthy
                shards serving.  Every plan without an injected fault
                retries nothing;
14. serve     — the batched ``LookupServer`` over the train phase's
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
15. correlated — TPC-DS ``customer_demographics`` at its full 1,920,800
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
16. multikey  — ``MultiKeyMapping`` over a 240,000-row prefix of it,
                under DM-R (20 epochs, cut for time), with two key
                choices: (key, credit rating),
                whose packed domain fits int32 (K1), and (key, purchase
                estimate), past int32 (the host-digits tier, K2); each
                lossless on every row, unknown combinations absent; each
                choice's kernel on its store's model against its plain
                version;
17. baselines — every AB/HB factory of the paper (§V-A3) on
                ``customer_demographics`` (HBC-L on its first 960,400
                rows, cut for time) and on SF1 ``orders``: exact on
                100,000 present and 50,000 absent keys, saved, reopened
                through ``repro_torch.open`` with the same answers, and a
                flipped payload bit refused; size, Eq. 1 ratio, build
                seconds and lookup keys/s beside the two DeepMapping
                stores probed the same way.  Baselines are host code:
                they build in a pool of spawned workers (never forked
                from the process that holds the CUDA context), one per
                core but two, started before phase 15 and running beside
                phases 15 and 16; a hash store's reopened lookup is timed
                in its worker, an array store's in the main process once
                at most one worker is left (and again alone if one was);
18. times     — kernel and plain-version times with CUDA events, the
                kernels' bounds, K3's two instantiations at 65,536 keys
                and at its largest call (one launch, a run of 100, L2
                flushed) beside the launch floor, K1/K2 under each plan
                of the store's model, one fp32 ``torch.matmul`` of the trunk's 256x256
                layer as a yardstick, registers and spills per
                instantiation, and whole-table lookup throughput.

Each kernel's launches are counted on every path that drives the port
(the MHAS children of phase 2 through K2 as path ``mhas`` and through
their engines as ``mhas_engine``, and phases 3 to 17, the search
and its store as ``mhas_search``), with
the counts set to 0 just before each path and read just after; K1's
launches that carried predicate tables are counted apart.  The launches
made to compare a kernel with its plain version (the rest of phase 2,
and in phases 8, 9, 15 and 16 after their counts are read) and those of
phase 18 do not count.  The LM serving paths of phases 6 and 7 launch
none of the three kernels (the reference's LM path reaches no Pallas
kernel); their counts, all 0, are read as paths ``lm_serve`` and
``lm_recurrent``.  The LM training path of phase 8 launches K1 through
the token store and K2 in its build (path ``lm_train``).
Each phase prints one JSON line with its seconds (``phase_s``); any
failed check raises (non-zero exit).  The last lines are the kernel summary and
``{"ok": true, "device": {...}}``.  Without CUDA, or without the
repository's ``src/`` beside it, the script exits non-zero and prints
no result.  A full record goes to ``chiprun_out/chip_smoke.json``.

``--models-only`` runs none of that: it builds the kernels of the
checkout under ``--src`` (this one by default) and prints one JSON line
of K1/K2 times on the MODELS (the store's heads under wider trunks)
through the public calls, and of K3's times and ``bitvector_test``'s
split on the SF1 vector, so that two checkouts can be timed in one
call; ``--plans`` also times every plan that fits, with the codes
checked across plans, through private helpers of this checkout's
package (``fused_mlp._candidate_plans``, ``plan=``).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import inspect
import json
import multiprocessing
import os
import re
import shutil
import statistics
import struct
import subprocess
import sys
import threading
import time
import warnings
import zipfile
from concurrent.futures import ThreadPoolExecutor
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
#: K3's run of launches timed between one event pair, and the spin queued
#: ahead of it (about 10 ms, longer than the host needs to enqueue them).
RUN_LAUNCHES = 100
RUN_SPIN_CYCLES = 20_000_000
#: Bytes read between launches to flush the 50 MB L2.
L2_FLUSH_BYTES = 256 * 2**20
#: The bitvector phase's second vector: the 10^8-slot domain of the
#: reference's docstring (12.5 MB of words), with about 1.5 M keys set.
K3_BIG_SLOTS, K3_BIG_SET = 10**8, 1_500_000
#: TPC-H ``orders`` rows at scale factor 1.
ROWS = 1_500_000
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
#: The cluster phase's build under the default ``ClusterConfig()`` (the
#: shards trained at once on the build pool's threads): a prefix of the
#: SF1 ``orders`` table and an epoch cap, cut for the smoke's time (the
#: SF1 cluster itself trains one shard at a time).
CL_THREADED_ROWS, CL_THREADED_EPOCHS = 187_500, 20
#: Epochs at most of the SF1 cluster's shard trainings (its one-thread
#: build; its retrain is capped again at CL_RETRAIN_EPOCHS): PAPER_STORE's
#: 200 capped, cut for the smoke's time to pay for the lm_serve phase
#: (120) and then for the lm_recurrent phase (80; each epoch of the four
#: shards, about 92 steps, took 0.9-1.4 s on an H100, and each epoch cut
#: from the cap saved 0.56-0.86 s of their training).  Uncapped, the
#: shards stop early after 118-144 epochs.  Every shard stays lossless
#: whatever its epochs, since T_aux corrects the deployed model.
CL_EPOCHS = 80
#: The kernels phase's MHAS check: SF1 keys run through every child, the
#: children the controller samples (beside the four fixed ones), and the
#: tolerance of the masked forward against K2 on the extracted child: a
#: 2,000-long fp32 contraction over zero padding in cuBLAS's order
#: against K2's own order, so looser than LOGIT_TOL (K2 against its plain
#: version).  Codes may differ only where the masked top-two margin is
#: below twice it.
MHAS_KEYS, MHAS_SAMPLED = 16_384, 4
MHAS_TOL = 1e-4
#: The mhas_search phase runs the port's ``PAPER_MHAS`` at the paper's
#: layer sizes, depth, batches, samples and learning rates, with three
#: cuts of its budget for the smoke's time: the iterations
#: (``total_iters`` = ``model_iters``, 2,000 in ``PAPER_MHAS``), the
#: controller updates (40 there; four, one every fifth iteration, so that
#: REINFORCE moves the controller at least twice, against an EMA
#: baseline, unless the early stop ends the loop before the tenth), and
#: the fine-tune's epochs (``MHASConfig``'s 30; its early stop kept).
MHAS_SEARCH_ITERS, MHAS_CTRL_ITERS, MHAS_FINETUNE_EPOCHS = 20, 4, 5
#: The lm_serve phase (the LM substrate's dense decoders, ROADMAP M12a):
#: tinyllama-1.1b at full width and depth, its fp32 decode from an empty
#: cache held against its fp32 prefill on (sequences, tokens); the bf16
#: prefill of (sequences, tokens) and the greedy bf16 decode of (steps,
#: sequences) in a cache of LM_CACHE slots.  Then gemma3-1b at full width,
#: its depth cut to LM_WINDOW_LAYERS (one 6-layer group and a 2-layer
#: remainder, the plan of its SMOKE config), prefilled and decoded over
#: LM_WINDOW_TOKENS in fp32: the banded prefill (LM_WINDOW_TOKENS % 512
#: == 0) against the windowed decode.
LM_ARCH, LM_WINDOW_ARCH = "tinyllama-1.1b", "gemma3-1b"
LM_CHECK = (2, 64)
LM_PREFILL = (4, 2048)
LM_DECODE = (64, 4)
LM_CACHE = 2112
LM_WINDOW_LAYERS, LM_WINDOW_TOKENS = 8, 1024
#: Decode against prefill in fp32: the reference's own tolerance
#: (tests/test_models.py, rtol and atol).  bf16 prefill argmaxes must
#: equal the fp32 run's on at least LM_AGREE of the rows whose fp32
#: top-two margin is at least LM_MARGIN.
LM_TOL, LM_MARGIN, LM_AGREE = 2e-3, 0.1, 0.99
#: The lm_recurrent phase (the RWKV6 and RG-LRU blocks, ROADMAP M12c-1):
#: both archs at full width and depth.  The reference tree's parameter
#: count of each (``jax.eval_shape`` of the reference's init; its
#: ``param_count_estimate`` undercounts both), and the bf16 prefill's
#: (sequences, tokens).  The fp32 check runs LM_CHECK, the greedy decode
#: LM_DECODE in a cache of LM_DECODE[0] slots (inside recurrentgemma's
#: 2,048-token window), under LM_TOL, and LM_AGREE at LM_REC_MARGIN.
LM_REC_ARCHS = ("rwkv6-7b", "recurrentgemma-2b")
LM_REC_PARAMS = {"rwkv6-7b": 8_054_640_640, "recurrentgemma-2b": 2_894_481_920}
LM_REC_PREFILL = {"rwkv6-7b": (4, 512), "recurrentgemma-2b": (4, 1024)}
#: The fp32 top-two margin from which a row is clear in the bf16 argmax
#: check of both recurrent archs (LM_AGREE of those rows must agree):
#: wider than tinyllama's LM_MARGIN, because bf16 moves more of their
#: near-tied argmaxes at random weights.  On an H100 (seed 0) rwkv6-7b's
#: bf16 prefill agrees with its fp32 one on 91.4% of the rows with margin
#: >= 0.1 and 99.3% of those >= 0.25, recurrentgemma-2b's on 97.7% and
#: 100%.  At d_model 512 on the CPU (``tools/lm_bf16_sensitivity.py``,
#: seed 0) the reference's own bf16 forward of rwkv agrees with its fp32
#: one on 82.7% of the rows with margin >= 0.1 (the port's on 82.1%).
#: The share at LM_MARGIN and the one from rounding only the weights to
#: bf16 are recorded beside it.
LM_REC_MARGIN = 0.25
#: The lm_train phase (LM training and the token store, ROADMAP M12b):
#: the training launcher on tinyllama-1.1b at full width and depth under
#: its own defaults (bf16, 8 sequences of 64 + 1 tokens, AdamW with
#: warmup_cosine(3e-3, 10, steps) and clip 1.0), first over the token
#: store for LM_TRAIN_STEPS[0] steps, then resumed from its checkpoint
#: over the raw corpus to LM_TRAIN_STEPS[1] steps (both cut for time:
#: each save writes 6.6 GB); then make_train_step's throughput at
#: LM_TRAIN_SHAPE (sequences, tokens + 1) over the token store, one
#: warm-up step and LM_TRAIN_TIMED timed ones; the bf16 loss within
#: LM_LOSS_TOL of the fp32 loss on the same weights and batch, at the
#: first step and on the trained weights. On an H100 the gap was at most
#: 5.5e-4 in size over 18 such pairs, at the initial weights and after
#: the steps, seeds 0-2 (``tools/lm_train_curves.py --loss-gap``). K1
#: and K2 on the store's model against their plain versions on every
#: position, in chunks of LM_K1_CHUNK keys. The corpus is the launcher's
#: (200,000 tokens).
LM_TRAIN_STEPS = (4, 10)
LM_TRAIN_SHAPE, LM_TRAIN_TIMED = (4, 2048), 2
LM_LOSS_TOL = 1e-3
#: The least drop of the trained batch's loss (the restored state against
#: the loss its step recorded): numerics move a same-batch loss by about
#: 1e-5; on an H100 one AdamW update at lr 3e-4 took a repeated batch's
#: loss from 10.87 to 3.67 (``tools/lm_train_curves.py``, ``repeated_10``).
LM_TRAINED_DROP = 0.1
LM_K1_CHUNK = 32_768
LM_CORPUS = 200_000
#: bf16 tensor-core peak of one H100 SXM (data sheet, dense).
PEAK_BF16_FLOPS = 989e12
#: Epochs at most of the SF1 cluster's one retrain (of the shard the
#: mutations dirtied): CL_EPOCHS capped again, cut for the smoke's time
#: to pay for the lm_train phase (the retrain took 45.7 s at 120 epochs
#: on an H100).  The shard stays lossless, since its T_aux corrects the
#: model it deploys.
CL_RETRAIN_EPOCHS = 40

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


def run_ms(fn, reps=RUN_LAUNCHES):
    """Device time per call over ``reps`` calls queued back to back
    between one pair of CUDA events, behind a spin that outlasts their
    enqueue: the gaps between launches count, the host's time does not.
    Returns ``(ms, queued_ahead)``; ``queued_ahead`` is False when the
    device reached the first event before the host had queued every call
    (then the number holds host time)."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(RUN_SPIN_CYCLES)
    a.record()
    for _ in range(reps):
        fn()
    queued_ahead = not a.query()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps, queued_ahead


def flushed_ms(fn, flush, reps=20):
    """Median device time of one call with L2 flushed before it:
    ``flush`` reads a buffer larger than L2, then a spin as in
    :func:`time_ms` keeps the host's time out."""
    import torch

    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        flush()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def wall_ms(fn, reps=20):
    """Median host time of one call up to the end of its device work."""
    import torch

    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def profile_windows(parts) -> dict:
    """One ``torch.profiler`` session over ``parts``, ``(label, fn)``
    pairs run in turn, each inside ``record_function(label)`` and
    synchronized before its window closes.  Per label: the names of the
    CUDA kernels launched in its window, the device ms of those kernels
    and of its copies (``Memcpy``/``Memset`` events), the device ms of
    each CUDA event name (``by_name``), and its wall ms.  Under
    ``"unplaced"``: the device events that no window launched; under
    ``"clock_offset_us"``: the least and most of a device event's start
    less its runtime call's, as the trace gives them.

    A device event is placed by the host clock, at the start of the
    runtime call that launched it (the CPU event of the same correlation
    id), or else of the op it is linked to.  Its own start is on the
    card's clock, which the trace maps onto the host's with an offset
    that drifts, in one run on the card far enough to put a call's
    kernels into the window before.  One
    session for all parts: the first session in a process starts CUPTI,
    and training run after profiler sessions slowed about twofold on the
    card, and a session after the cluster's threads saw no device events
    (PERF.md §6)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    out = {}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for label, fn in parts:
            t0 = time.perf_counter()
            with record_function(label):
                fn()
                torch.cuda.synchronize()
            out[label] = {"kernels": [], "copies": [], "kernel_ms": 0.0, "copy_ms": 0.0,
                          "by_name": {}, "wall_ms": (time.perf_counter() - t0) * 1e3}
    events = prof.events()
    host = [e for e in events if e.device_type == DeviceType.CPU]
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in host if e.name in out]
    runtime = {e.id: e.time_range.start for e in host if e.name.startswith("cu")}
    ops = {e.id: e.time_range.start for e in host
           if not e.name.startswith("cu") and not getattr(e, "linked_correlation_id", 0)}
    device = sorted((e for e in events if e.device_type == DeviceType.CUDA and e.name not in out),
                    key=lambda e: e.time_range.start)
    unplaced, offsets = [], []
    for e in device:
        at = runtime.get(e.id, ops.get(getattr(e, "linked_correlation_id", 0) or -1))
        if e.id in runtime:
            offsets.append(e.time_range.start - at)
        label = next((lb for lb, start, end in spans if at is not None and start <= at <= end),
                     None)
        if label is None:
            unplaced.append(e.name[:80])
            continue
        w, ms = out[label], e.time_range.elapsed_us() / 1e3
        kind = "copy" if e.name.startswith(("Memcpy", "Memset")) else "kernel"
        w["copies" if kind == "copy" else "kernels"].append(e.name[:80])
        w[f"{kind}_ms"] += ms
        w["by_name"][e.name] = w["by_name"].get(e.name, 0.0) + ms
    out["unplaced"] = unplaced
    out["clock_offset_us"] = [min(offsets), max(offsets)] if offsets else None
    return out


def k3_edges(bv):
    """Edge keys of a vector: its capacity's and word domain's ends, -1,
    the int32 maximum, and a key that wraps round to 5 in int32."""
    import numpy as np

    dom = 32 * np.asarray(bv.words).view(np.uint32).size
    return np.array([0, bv.capacity - 1, bv.capacity, dom - 1, dom, -1, 2**31 - 1, 2**32 + 5],
                    dtype=np.int64)


def k3_keys(table, bv, rng):
    """K3's largest call on the SF1 store's vector: every present key,
    then 100,000 absent keys inside the key range, then the edge keys
    (``k3_edges``).  Returns ``(keys, absent, edges)``, int64."""
    import numpy as np

    absent = rng.integers(0, table.max_key, 400_000)
    absent = absent[~bv.test(absent)][:100_000]
    edges = k3_edges(bv)
    return np.concatenate([table.keys, absent, edges]), absent, edges


def k3_times(bvk, ref, words, keys, dev) -> dict:
    """K3 at one 65,536-key chunk (the first of ``keys``) and at all of
    ``keys`` padded to 1,024 (its path's largest call), through each
    entry the package has: the reference's contract (``bitvector_call``,
    int32 keys with those outside int32 mapped to -1, int32 bits) and,
    where present, the caller's keys as they are
    (``bitvector_test_call``, int64 keys, bools).  Per shape and entry,
    in the order plain, kernel, kernel, plain: the median single launch
    (``time_ms``), the time per launch over a run of RUN_LAUNCHES
    (``run_ms``), at the large shape the median with L2 flushed
    (``flushed_ms``), each result held against the plain version.  The
    bound counts each key and result byte once and each word the keys
    touch once.  And the launch floor: an empty kernel
    (``torch.cuda._sleep(0)``) timed the same two ways."""
    import numpy as np
    import torch

    dom = 32 * int(words.shape[0])
    flush_buf = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    floor_run, floor_ahead = run_ms(lambda: torch.cuda._sleep(0))
    out = {"launch_floor": {"single_ms": time_ms(lambda: torch.cuda._sleep(0)),
                            "run_ms": floor_run, "run_queued_ahead": floor_ahead},
           "shapes": []}
    entries = [("int32_to_int32", torch.int32, 4,
                lambda kt: (lambda: bvk.bitvector_call(kt, words, 1024)))]
    if hasattr(bvk, "bitvector_test_call"):
        entries.append(("int64_to_bool", torch.int64, 1,
                        lambda kt: (lambda: bvk.bitvector_test_call(kt, words))))
    for n in (65536, keys.size):
        kh = keys[:n]
        n_pad = -(-n // 1024) * 1024
        touched = np.unique(kh[(kh >= 0) & (kh < dom)] >> 5).size
        for label, dtype, out_bytes, make in entries:
            kn = np.where((kh >= 0) & (kh <= 2**31 - 1), kh, -1) if dtype == torch.int32 else kh
            kt = torch.from_numpy(np.pad(kn, (0, n_pad - n))).to(dev, dtype)
            fn = make(kt)

            def plain():
                return ref.ref_bitvector_test(words, kt)

            check(torch.equal(fn().int(), plain()), f"K3 {label} differs from plain at n={n}")
            big = n_pad > 65536
            runs = {"plain": [time_ms(plain)], "single": [], "run": [], "queued_ahead": [],
                    "flushed": []}
            for _ in range(2):
                runs["single"].append(time_ms(fn))
                ms, ahead = run_ms(fn)
                runs["run"].append(ms)
                runs["queued_ahead"].append(ahead)
                if big:
                    runs["flushed"].append(flushed_ms(fn, flush_buf.sum))
            runs["plain"].append(time_ms(plain))
            io = n_pad * (kt.element_size() + out_bytes) + touched * 4
            out["shapes"].append({
                "entry": label, "keys": n_pad, "words_touched": int(touched), "bytes": io,
                "bound_ms": io / PEAK_BYTES_PER_S * 1e3, "single_ms": min(runs["single"]),
                "run_ms": min(runs["run"]),
                "flushed_ms": min(runs["flushed"]) if big else None,
                "plain_ms": min(runs["plain"]), "runs": runs,
            })
    return out


def k3_call_split(ops, bv, keys, dev, before=()):
    """``ops.bitvector_test`` on ``keys`` as a caller holds them: contiguous
    int64, the same as int32 (clipped to int32), a strided int64 view,
    and the first 65,536 as int64.  Per call: the CUDA kernels it runs
    and their device ms, its copies' device ms (the word upload), its
    device span (``time_ms``) and its wall time; and the word upload
    (``ops.words_tensor``) alone.  The calls are profiled in one
    ``profile_windows`` session, after the ``before`` parts.  Returns the
    split and the session's windows."""
    import numpy as np
    import torch

    t64 = torch.from_numpy(keys).to(dev)
    t32 = torch.from_numpy(np.clip(keys, -2**31, 2**31 - 1).astype(np.int32)).to(dev)
    strided = torch.from_numpy(np.repeat(keys, 2)).to(dev)[::2]
    out = {"upload": {"bytes": int(np.asarray(bv.words).nbytes),
                      "device_ms": time_ms(lambda: ops.words_tensor(bv.words, dev)),
                      "wall_ms": wall_ms(lambda: ops.words_tensor(bv.words, dev))}}
    calls = {}
    for label, t in (("int64", t64), ("int32", t32), ("int64_strided", strided),
                     ("int64_65536", t64[:65536])):
        calls[label] = (t, lambda t=t: ops.bitvector_test(bv.words, t))
        calls[label][1]()
    windows = profile_windows([*before, *((f"bitvector_test {label}", call)
                                          for label, (_, call) in calls.items())])
    for label, (t, call) in calls.items():
        prof = windows[f"bitvector_test {label}"]
        out[label] = {"keys": int(t.numel()), "kernels_per_call": len(prof["kernels"]),
                      "kernels": prof["kernels"], "copies": prof["copies"],
                      "kernel_ms": prof["kernel_ms"], "copy_ms": prof["copy_ms"],
                      "device_ms": time_ms(call), "wall_ms": wall_ms(call)}
    return out, windows


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
        for h in (*spec.private_map[t], spec.card_map[t]):
            flops += spec.width * h if hd is None else 2 * hd * h
            hd = h
    return flops


def mlp_bound(spec, n: int, in_per_key: int, out_per_key: int, extra: int = 0) -> dict:
    """K1's or K2's least time on ``n`` keys of ``spec``: the larger of its
    fp32 operations over PEAK_FP32_FLOPS and its bytes over
    PEAK_BYTES_PER_S.  The bytes are ``in_per_key`` and ``out_per_key``
    a key (read and written once), the unpadded weights read once, and
    ``extra`` (the existence words, the position table)."""
    flops = n * flops_per_key(spec)
    nbytes = n * (in_per_key + out_per_key) + 4 * spec.num_params() + extra
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_io = nbytes / PEAK_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_io), "bound_by": "operations" if t_ops >= t_io else "bytes",
            "flops": flops, "bytes": nbytes}


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
    ``src/src`` and print the MODELS' times, K3's (``k3_times``) and
    ``ops.bitvector_test``'s split (``k3_call_split``) on the SF1 orders
    table's existence vector as one JSON line, so that two checkouts can
    be compared in one call."""
    import numpy as np
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
    ptxas = {name: [ln.strip() for ln in info["log"].splitlines()
                    if "Compiling entry function" in ln or "registers" in ln or "spill" in ln]
             for name, info in build.BUILD_INFO.items()}
    from repro_torch.core import BitVector
    from repro_torch.data.tpch import orders_like
    from repro_torch.kernels import bitvector as bvk
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    models = model_times(dev, seed, plans)
    table = orders_like(ROWS, seed=seed)
    bv = BitVector.from_keys(table.keys)
    keys, _, _ = k3_keys(table, bv, np.random.default_rng(seed))
    k3 = k3_times(bvk, ref, ops.words_tensor(bv.words, dev), keys, dev)
    print(json.dumps({"phase": "models", "src": str(src), "nvidia_smi": smi, "ptxas": ptxas,
                      "models": models, "k3": k3,
                      "k3_call": k3_call_split(ops, bv, keys, dev)[0]}),
          flush=True)
    return 0


def mhas_space_check(spec, encoder, keys, dev, seed: int, margins, cmp_codes) -> dict:
    """The MHAS search space over the store's table (``spec``'s base,
    width, tasks and cards) at the paper's layer sizes (100 to 2,000) and
    depth: the weight bank and the LSTM controller made on ``dev`` from
    ``seed``; four fixed children (everything at depth 2 and width 2,000;
    everything at depth 0, the out layers gathers; the trunk at depth 0
    under heads of 2 x 2,000; the trunk at 2 x 2,000 under heads of depth
    0) and MHAS_SAMPLED drawn by ``sample_arch``, each draw's logp equal
    to ``logprob_of``'s.  Each child is cut from the bank and run through
    K2 (logits, then codes) on ``keys``' digits: the logits against the
    masked forward on the padded one-hot within MHAS_TOL, the codes equal
    to its argmax but where its top-two margin is below 2 * MHAS_TOL; and
    both against K2's plain version by the phase's rule (``margins``,
    ``cmp_codes``, LOGIT_TOL).  Returns the record of its JSON line."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core.encoding import onehot_digits
    from repro_torch.core.mhas import SearchSpace, controller
    from repro_torch.kernels import fused_mlp as fm
    from repro_torch.kernels import ops, ref

    space = SearchSpace(base=spec.base, width=spec.width, tasks=spec.tasks,
                        out_cards=tuple(spec.card_map[t] for t in spec.tasks))
    bank = space.init_bank(seed=seed, device=dev)
    cspec = controller.ControllerSpec.for_space(space)
    cparams = controller.init_controller(cspec, seed=seed, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    widest = space.num_size_choices - 1
    deep = [space.max_layers] + [widest] * space.max_layers
    shallow = [0] * (1 + space.max_layers)
    n_tasks = len(space.tasks)
    children = [("depth 2, width 2,000 everywhere", deep * (1 + n_tasks)),
                ("depth 0 everywhere", shallow * (1 + n_tasks)),
                ("trunk depth 0, heads 2 x 2,000", shallow + deep * n_tasks),
                ("trunk 2 x 2,000, heads depth 0", deep + shallow * n_tasks)]
    draws = []
    for i in range(MHAS_SAMPLED):
        tokens, logp, entropy = controller.sample_arch(cparams, cspec, gen)
        logp_r, entropy_r = controller.logprob_of(cparams, cspec, tokens)
        check(bool(torch.isclose(logp, logp_r, rtol=1e-5, atol=0)),
              f"sampled child {i}: sample_arch's logp {float(logp)} is not logprob_of's "
              f"{float(logp_r)}")
        draws.append({"logp": float(logp), "logprob_of": float(logp_r),
                      "entropy": float(entropy), "entropy_of": float(entropy_r)})
        children.append((f"sampled {i}", tokens))
    digits = encoder.digits_torch(torch.from_numpy(keys).to(dev)).contiguous()
    onehot = F.pad(onehot_digits(digits, space.base), (0, space.max_width - space.feature_dim))
    base_pad = ops._round_up(space.base, ops.LANE)
    rows, served = [], []
    for name, tokens in children:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        arch = space.tokens_to_arch(tokens)
        cs = space.child_spec(arch)
        check(space.child_num_params(arch) == cs.num_params(),
              f"{name}: child_num_params is not the child spec's num_params")
        aa = space.arch_arrays(arch, device=dev)
        child = space.extract_child_params(bank, arch)
        flat, _ = ops.pad_flat_weights(child, cs)
        pads = ops.card_pads(cs)
        # K2's least time for the logits launch: the digits in, the
        # unpadded logits out.
        bound = mlp_bound(cs, digits.shape[0], 4 * cs.width, 4 * sum(cs.card_map.values()))
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        masked = space.forward(bank, onehot, aa)
        ev[1].record()
        logits = fm.fused_mlp_call(digits, flat, cs, ops.DEFAULT_TILE_N, base_pad, pads, False)
        ev[2].record()
        codes = fm.fused_mlp_call(digits, flat, cs, ops.DEFAULT_TILE_N, base_pad, pads, True)
        ev[3].record()
        # K2 against the masked forward on the bank.
        masked_err, masked_codes, masked_marg = 0.0, [], []
        for lg, t in zip(logits, cs.tasks):
            want = masked[t]
            got = lg[:, : want.shape[1]]
            torch.testing.assert_close(got, want, rtol=MHAS_TOL, atol=MHAS_TOL)
            masked_err = max(masked_err, (got - want).abs().max().item())
            masked_codes.append(torch.argmax(want, dim=1))
            top = torch.topk(want, min(2, want.shape[1]), dim=1).values
            masked_marg.append(top[:, 0] - top[:, 1] if top.shape[1] > 1
                               else torch.full_like(top[:, 0], float("inf")))
        masked_codes = torch.stack(masked_codes, dim=1).to(torch.int32)
        masked_marg = torch.stack(masked_marg, dim=1)
        diff = codes != masked_codes
        check(bool((masked_marg[diff] < 2 * MHAS_TOL).all()),
              f"{name}: K2's codes differ from the masked forward's on a row with a clear margin")
        # K2 against its plain version on the same child.
        plain_margin_rows, _ = cmp_codes(codes, ref.fused_mlp(digits, flat, cs, True),
                                         margins(digits, flat, cs))
        plain_err = 0.0
        for a, b in zip(logits, ref.fused_mlp(digits, flat, cs, False)):
            torch.testing.assert_close(a, b, rtol=LOGIT_TOL, atol=LOGIT_TOL)
            plain_err = max(plain_err, (a - b).abs().max().item())
        torch.cuda.synchronize()
        rows.append({
            "child": name, "tokens": [int(t) for t in tokens],
            "shared": list(cs.shared), "private": {t: list(p) for t, p in cs.private},
            "num_params": cs.num_params(), "plan": fm.tile_plan(cs).describe(),
            "masked_max_abs_diff": masked_err,
            "masked_margin_rows": int(diff.any(dim=1).sum()),
            "plain_max_abs_err": plain_err, "plain_margin_rows": plain_margin_rows,
            "masked_forward_ms": ev[0].elapsed_time(ev[1]),
            "k2_logits_ms": ev[1].elapsed_time(ev[2]), "k2_codes_ms": ev[2].elapsed_time(ev[3]),
            "k2_bound_ms": bound["bound_ms"], "k2_bound_by": bound["bound_by"],
            "seconds": time.perf_counter() - t0,
        })
        served.append((name, cs, child, masked_codes, masked_marg))
    layers = [*bank["trunk"], *(layer for head in bank["heads"].values()
                                for layer in (*head["hidden"], head["out"]))]
    return {"keys": int(keys.size), "max_width": space.max_width,
            "layer_sizes": list(space.layer_sizes), "max_layers": space.max_layers,
            "bank_matrices": len(layers),
            "bank_bytes": sum(int(t.numel()) * t.element_size()
                              for layer in layers for t in layer.values()),
            "masked_tol": MHAS_TOL, "logit_tol": LOGIT_TOL, "sampled": draws,
            "children": rows}, served


def mhas_engine_check(served, encoder, keys, dev) -> list:
    """Each child of ``mhas_space_check`` (``served``: name, spec, params
    cut from the bank, the masked forward's codes and top-two margins)
    looked up as a store would look it up: an ``InferenceEngine`` over
    the child, one ``dispatch``/``collect`` of ``keys``.  The engine
    picks the tier by its own budget rule (K2 through ``pallas_digits``,
    K1 through ``fused_streamed``, or the plain path); its codes must
    equal the masked forward's but where the margin is below
    2 * MHAS_TOL.  Returns each child's tier, pages, margin rows and
    milliseconds."""
    import torch

    from repro_torch.core.inference import InferenceEngine

    rows = []
    for name, cs, child, masked_codes, masked_marg in served:
        engine = InferenceEngine(encoder, cs, child, device=dev)
        t0 = time.perf_counter()
        ticket = engine.dispatch(keys)
        codes, _ = engine.collect(ticket)
        ms = (time.perf_counter() - t0) * 1e3
        diff = torch.from_numpy(codes).to(dev) != masked_codes
        check(bool((masked_marg[diff] < 2 * MHAS_TOL).all()),
              f"{name}: the engine's codes ({ticket.path}) differ from the masked forward's "
              f"on a row with a clear margin")
        rows.append({"child": name, "tier": ticket.path,
                     "pages": len(ticket.codes_dev) if ticket.path == "fused_streamed" else 1,
                     "margin_rows": int(diff.any(dim=1).sum()), "ms": ms})
    return rows


class CallTimer:
    """Wraps functions looked up through their modules or classes at call
    time (``(module, name)`` pairs, with an optional function of the
    result to keep): each call is timed between two device syncs and
    counted; ``with`` restores them."""

    def __init__(self, targets, sync):
        self.targets, self.sync = targets, sync
        self.seconds = {t[1]: 0.0 for t in targets}
        self.calls = {t[1]: 0 for t in targets}
        self.results: dict = {t[1]: [] for t in targets}

    def _wrap(self, name, fn, keep):
        def timed(*a, **kw):
            self.sync()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            self.sync()
            self.seconds[name] += time.perf_counter() - t0
            self.calls[name] += 1
            if keep:
                self.results[name].append(keep(out))
            return out
        return timed

    def __enter__(self):
        self.saved = []
        for mod, name, *keep in self.targets:
            fn = getattr(mod, name)
            # the attribute as stored (a classmethod stays one on exit)
            self.saved.append((mod, name, inspect.getattr_static(mod, name)))
            setattr(mod, name, self._wrap(name, fn, keep[0] if keep else None))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def mhas_search_phase(table, absent, out_cap, dev, seed: int, read_launches) -> tuple:
    """``run_mhas`` over ``table`` under the port's ``PAPER_MHAS`` with
    the cuts above, then the searched store built from its spec and
    params through ``DeepMappingStore.build`` under ``PAPER_STORE`` (T_aux
    corrects the model through the tier its engine picks) and every key
    of ``table``, the ``absent`` and the ``out_cap`` keys looked up.

    Checks the search's contracts: the history holds one entry per model
    iteration run and ``controller_samples`` per controller update; each
    entry's ``child_params`` is the sampled arch's and its ratio finite;
    ``best_ratio`` is the history's least; the spec is the best arch's
    and the params have its shapes.  The store: lossless, the absent and
    out-of-capacity keys absent, the kernels' launches those of the
    tiers its engine took (``read_launches``: counts since the caller
    zeroed them, just before this call).  Returns the record of the
    phase's JSON line, the launches and the store."""
    import numpy as np
    import torch

    from repro_torch.configs.deepmapping_paper import PAPER_MHAS, PAPER_STORE
    from repro_torch.core import DeepMappingStore
    from repro_torch.core import trainer as trainer_lib
    from repro_torch.core.mhas import controller, search
    from repro_torch.core.model import _leaves, init_params

    cfg = dataclasses.replace(
        PAPER_MHAS, total_iters=MHAS_SEARCH_ITERS, model_iters=MHAS_SEARCH_ITERS,
        controller_iters=MHAS_CTRL_ITERS, finetune_epochs=MHAS_FINETUNE_EPOCHS, seed=seed)
    reduced = {"total_iters": [MHAS_SEARCH_ITERS, PAPER_MHAS.total_iters],
               "model_iters": [MHAS_SEARCH_ITERS, PAPER_MHAS.model_iters],
               "controller_iters": [MHAS_CTRL_ITERS, PAPER_MHAS.controller_iters],
               "finetune_epochs": [MHAS_FINETUNE_EPOCHS, PAPER_MHAS.finetune_epochs]}
    timer = CallTimer([(search, "_bank_step"), (search, "_child_errors"),
                       (controller, "sample_arch", lambda out: out[0].cpu().numpy()),
                       (search, "_controller_update"),
                       (trainer_lib, "train", lambda out: (out[2], int(out[1].step)))],
                      torch.cuda.synchronize)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem_before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    with timer:
        res = search.run_mhas(table, cfg, device=dev)
    torch.cuda.synchronize()
    search_s = time.perf_counter() - t0
    peak_bytes = torch.cuda.max_memory_allocated() - mem_before
    space = res.space

    # The search's contracts.
    model_iters_run = timer.calls["_bank_step"] // cfg.model_epochs_per_iter
    ctrl_updates = timer.calls["_controller_update"]
    hist = res.history
    check(timer.calls["_bank_step"] == model_iters_run * cfg.model_epochs_per_iter,
          "mhas_search: a model iteration ran a partial epoch count")
    # Every iteration trains the bank (total_iters == model_iters) and
    # every ctrl_every-th then updates the controller, unless the early
    # stop broke the loop at that iteration, the last one run.
    ctrl_every = max(1, cfg.total_iters // max(1, cfg.controller_iters))
    check((model_iters_run - 1) // ctrl_every <= ctrl_updates <= model_iters_run // ctrl_every,
          f"mhas_search: {ctrl_updates} controller updates after {model_iters_run} model "
          f"iterations, one due every {ctrl_every}")
    check(len(hist) == model_iters_run + ctrl_updates * cfg.controller_samples,
          f"mhas_search: {len(hist)} history entries for {model_iters_run} model iterations "
          f"and {ctrl_updates} controller updates")
    sampled = [space.tokens_to_arch(t) for t in timer.results["sample_arch"]]
    check(len(sampled) >= len(hist), "mhas_search: fewer samples than history entries")
    for i, h in enumerate(hist):
        check(h["child_params"] == space.child_num_params(sampled[i]),
              f"mhas_search: history entry {i}'s child_params is not its arch's")
        check(bool(np.isfinite(h["ratio"])) and 0.0 <= h["err"] <= 1.0,
              f"mhas_search: history entry {i}: ratio {h['ratio']}, err {h['err']}")
    ratios = [h["ratio"] for h in hist]
    check(not hist or res.best_ratio == min(ratios),
          "mhas_search: best_ratio is not the least ratio of the history")
    check(res.spec == space.child_spec(res.best_arch), "mhas_search: the spec is not the best arch's")
    want_shapes = [tuple(t.shape) for t in _leaves(init_params(res.spec, device=dev))]
    got = list(_leaves(res.params))
    check([tuple(t.shape) for t in got] == want_shapes
          and all(t.device.type == dev.type and t.dtype == torch.float32 for t in got),
          "mhas_search: the params are not the spec's fp32 shapes on the card")
    ft_hist, ft_steps = timer.results["train"][0]
    check(len(ft_hist) > 0 and all(np.isfinite(ft_hist)), "mhas_search: the fine-tune's losses")
    q = max(1, len(ratios) // 4)
    arch = res.best_arch
    chosen = {"trunk": [int(x) for x in arch["trunk_sizes"][: arch["trunk_depth"]]],
              "heads": {t: [int(x) for x in h["sizes"][: h["depth"]]]
                        for t, h in arch["heads"].items()},
              "child_num_params": space.child_num_params(arch)}

    # The searched store, built and looked up through its engine's tiers.
    tiers = ("fused_calls", "fused_streamed_calls", "pallas_calls", "jit_calls")
    t0 = time.perf_counter()
    store = DeepMappingStore.build(table, PAPER_STORE, spec=res.spec, params=res.params,
                                   device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    st = store.engine.stats
    at_build = {k: getattr(st, k) for k in tiers}
    t0 = time.perf_counter()
    vals, exists, ls = store._lookup_with_stats(table.keys)
    lookup_s = time.perf_counter() - t0
    check(bool(exists.all()), "mhas_search: a present key of the searched store reads as absent")
    for c, col in table.columns.items():
        check(np.array_equal(vals[c], col), f"mhas_search: column {c} is not lossless")
    check(not store.lookup(absent)[1].any(), "mhas_search: an absent key reads as present")
    check(not store.lookup(out_cap)[1].any(), "mhas_search: an out-of-capacity key reads present")
    at_lookup = {k: getattr(st, k) - at_build[k] for k in tiers}
    launches = read_launches()
    entry = store.engine._entry(res.spec.tasks)
    plan = store.engine._streamed_plan(entry, True)
    pages = len(plan[0]) if plan is not None and at_build["fused_streamed_calls"] + \
        at_lookup["fused_streamed_calls"] else 0
    total = {k: at_build[k] + at_lookup[k] for k in tiers}
    want = {"fused_mlp": total["pallas_calls"],
            "fused_lookup": total["fused_calls"] + pages * total["fused_streamed_calls"],
            "bitvector": 0}
    check(all(launches[k] == v for k, v in want.items()),
          f"mhas_search: launches {launches} are not the tiers' {want}")

    def tier(counts):
        names = {"fused_calls": "fused", "fused_streamed_calls": "fused_streamed",
                 "pallas_calls": "pallas_digits", "jit_calls": "jit"}
        return [names[k] for k in tiers if counts[k]]

    mw = space.max_width
    bank_bytes = 4 * ((1 + len(space.tasks)) * space.max_layers * (mw * mw + mw)
                      + sum(mw * c + c for c in space.out_cards))
    rec = {
        "config": {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)},
        "max_width": mw, "bank_bytes": bank_bytes,
        "reduced": reduced, "rows": table.num_rows,
        "search_s": search_s, "peak_device_bytes": peak_bytes,
        "split_s": {"bank_steps": timer.seconds["_bank_step"],
                    "scoring": timer.seconds["sample_arch"] + timer.seconds["_child_errors"],
                    "controller_updates": timer.seconds["_controller_update"],
                    "finetune": timer.seconds["train"],
                    "other": search_s - sum(timer.seconds.values())},
        "bank_steps": timer.calls["_bank_step"],
        "bank_steps_per_s": timer.calls["_bank_step"] / timer.seconds["_bank_step"],
        "scored_samples": timer.calls["_child_errors"], "model_iters_run": model_iters_run,
        "early_stop_at_iter": model_iters_run if model_iters_run < cfg.total_iters else None,
        "controller_updates": ctrl_updates, "controller_every": ctrl_every,
        "history_len": len(hist),
        "finetune": {"epochs": len(ft_hist), "steps": ft_steps, "losses": ft_hist,
                     "early_stopped": len(ft_hist) < cfg.finetune_epochs},
        "chosen": chosen, "spec": {"shared": list(res.spec.shared),
                                   "private": {t: list(p) for t, p in res.spec.private}},
        "best_ratio": res.best_ratio,
        "first_quartile_ratio": sum(ratios[:q]) / q, "last_quartile_ratio": sum(ratios[-q:]) / q,
        "history": hist,
        "store": {"build_s": build_s, "memorized_fraction": store.memorized_fraction(),
                  "aux_rows": store.aux.num_rows, "compression_ratio": store.compression_ratio(),
                  "size_breakdown": store.size_breakdown(),
                  "tier_at_build": tier(at_build), "tier_at_lookup": tier(at_lookup),
                  "stats_at_build": at_build, "stats_at_lookup": at_lookup,
                  "streamed_pages": pages,
                  "lookup": {"keys": table.num_rows, "wall_s": lookup_s,
                             "keys_per_s": table.num_rows / lookup_s, "infer_s": ls.infer_s,
                             "aux_s": ls.aux_s, "decode_s": ls.decode_s},
                  "absent_checked": int(absent.size),
                  "out_of_capacity_checked": int(out_cap.size)},
    }
    return rec, launches, store


def lm_sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def lm_timed(dev, fn):
    """``(fn(), seconds)``: the host clock between two synchronizes."""
    lm_sync(dev)
    t0 = time.perf_counter()
    out = fn()
    lm_sync(dev)
    return out, time.perf_counter() - t0


def lm_decode_against(dev, params, cfg, toks, full):
    """Decode ``toks`` one at a time from an empty cache through
    ``make_cache_factory`` and ``make_decode_step``; per step the largest
    excess over the tolerance, max(|got - want| - (LM_TOL + LM_TOL |want|))
    (<= 0 where close), and difference against ``full`` (on the device,
    read once at the end)."""
    import torch

    from repro_torch.serve.serve_step import make_cache_factory, make_decode_step

    B, S = toks.shape
    step = make_decode_step(cfg, device=dev)
    cache = make_cache_factory(cfg, device=dev)(B, S)
    exc, diff = [], []
    for t in range(S):
        lg, cache = step(params, cache, toks[:, t:t + 1])
        got, want = lg[:, 0].float(), full[:, t]
        exc.append(((got - want).abs() - LM_TOL * (1 + want.abs())).amax())
        diff.append((got - want).abs().amax())
    check(int(cache["len"]) == S, f"{cfg.name}: the cache's len is not {S}")
    return torch.stack(exc).cpu(), torch.stack(diff).cpu()


def lm_fp32_argmax(dev, prefill32, params, prompts):
    """The fp32 prefill of ``prompts``: its argmaxes and top-two margins
    (the logits themselves are freed) and its seconds."""
    import torch

    lg32, s = lm_timed(dev, lambda: prefill32(params, {"tokens": prompts}))
    top2 = torch.topk(lg32, 2, dim=-1).values
    margin32 = top2[..., 0] - top2[..., 1]
    arg32 = lg32.argmax(dim=-1)
    return arg32, margin32, s


def argmax_agreement(arg, arg32, margin32) -> dict:
    """{margin: [equal share, rows]} of ``arg`` against the fp32 argmaxes,
    over the rows whose fp32 top-two margin is at least LM_MARGIN,
    LM_REC_MARGIN, 0.5 and 1.0."""
    out = {}
    for m in (LM_MARGIN, LM_REC_MARGIN, 0.5, 1.0):
        clear = margin32 >= m
        n = int(clear.sum())
        out[m] = [float((arg == arg32)[clear].float().mean()) if n else None, n]
    return out


def lm_bf16_serve(dev, cfg16, params16, prompts, arg32, margin32, cache_slots: int,
                  margin: float = LM_MARGIN):
    """The bf16 half of ``lm_serve`` and ``lm_recurrent``, on weights
    already in the config's dtypes: the prefill of ``prompts`` timed four
    times (the first warms cuBLAS up and is not counted; tokens/s from
    the median of the other three), every logit finite and the argmaxes
    equal to the fp32 prefill's on LM_AGREE of the rows with an fp32
    top-two margin of ``margin`` or more; a greedy decode of LM_DECODE
    steps and sequences in a ``cache_slots``-slot cache timed after a
    4-step warm-up (ms a step); the peak device memory from the call on.
    Returns the record and the decode's last cache."""
    import torch

    from repro_torch.core.model import _leaves
    from repro_torch.serve.serve_step import (
        make_cache_factory, make_decode_step, make_prefill_step,
    )

    name = cfg16.name
    lm_sync(dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mem_before = torch.cuda.memory_allocated()
    Bp, Sp = prompts.shape
    prefill16 = make_prefill_step(cfg16, device=dev)
    pre16_runs = []
    for _ in range(4):
        lg16, s16 = lm_timed(dev, lambda: prefill16(params16, {"tokens": prompts}))
        pre16_runs.append(s16)
    check(lg16.dtype == torch.bfloat16 and tuple(lg16.shape) == (Bp, Sp, cfg16.vocab_size),
          f"{name}: bf16 prefill gave {lg16.dtype} {tuple(lg16.shape)}")
    check(bool(torch.isfinite(lg16).all()), f"{name}: a bf16 prefill logit is not finite")
    by_margin = argmax_agreement(lg16.argmax(dim=-1), arg32, margin32)
    agree, n_clear = by_margin[margin]
    del lg16
    check(n_clear > 0 and agree >= LM_AGREE,
          f"{name}: bf16 argmax equals fp32 on {agree} of {n_clear} rows with margin >= "
          f"{margin}, not {LM_AGREE}")
    Sd, Bd = LM_DECODE
    step16 = make_decode_step(cfg16, device=dev)
    caches = make_cache_factory(cfg16, device=dev)

    def greedy(steps):
        cache = caches(Bd, cache_slots)
        tok = prompts[:Bd, :1]
        out, finite = [], []
        for _ in range(steps):
            lg, cache = step16(params16, cache, tok)
            finite.append(torch.isfinite(lg).all())
            tok = lg[:, -1].argmax(dim=-1, keepdim=True)
            out.append(tok)
        return torch.cat(out, dim=1), torch.stack(finite), cache

    lm_timed(dev, lambda: greedy(4))  # warm-up
    (gen_toks, finite, cache16), dec16_s = lm_timed(dev, lambda: greedy(Sd))
    check(bool(finite.all()), f"{name}: a bf16 decode logit is not finite")
    check(int(cache16["len"]) == Sd and int(gen_toks.max()) < cfg16.vocab_size,
          f"{name}: the greedy decode's cache or tokens are wrong")
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    pre16_s = statistics.median(pre16_runs[1:])
    return {
        "weight_bytes": sum(t.numel() * t.element_size() for t in _leaves(params16)),
        "prefill": {"sequences": Bp, "tokens": Sp, "s": pre16_s, "s_runs": pre16_runs,
                    "tokens_per_s": Bp * Sp / pre16_s},
        "argmax_vs_fp32": {"margin": margin, "rows": n_clear,
                           "of_rows": Bp * Sp, "equal_share": agree, "need": LM_AGREE,
                           "by_margin": by_margin},
        "decode": {"steps": Sd, "sequences": Bd, "cache_slots": cache_slots, "s": dec16_s,
                   "ms_per_step": dec16_s / Sd * 1e3, "tokens_per_s": Bd * Sd / dec16_s},
        "peak_device_bytes": peak,
        "peak_device_bytes_over_start": peak - mem_before if dev.type == "cuda" else 0,
    }, cache16


def lm_serve_phase(dev, seed: int) -> dict:
    """The LM substrate's serving path (``make_prefill_step``,
    ``make_decode_step``, ``make_cache_factory``) on the dense decoders:

    (a) tinyllama-1.1b at full width and depth, weights from
        ``DecoderLM.init`` on the card in fp32 (their count against
        ``param_count_estimate``, which leaves out the norms' scales);
        LM_CHECK tokens decoded one step at a time from an empty cache,
        held against the prefill of the same tokens within LM_TOL;
    (b) the same weights cast to the config's bfloat16: the prefill of
        LM_PREFILL tokens timed (tokens/s), every logit finite and the
        argmaxes equal to the fp32 prefill's on LM_AGREE of the rows with
        an fp32 top-two margin of LM_MARGIN or more; a greedy decode of
        LM_DECODE steps and sequences in a LM_CACHE-slot cache timed (ms a
        step, tokens/s); the peak device memory of the bf16 part;
    (c) gemma3-1b at full width, depth cut to LM_WINDOW_LAYERS: the fp32
        prefill of LM_WINDOW_TOKENS (banded on its windowed layers)
        against the windowed decode of the same tokens, within LM_TOL, at
        positions past the window too.

    bf16 products accumulate in fp32 and TF32 stays off, as ``smoke()``
    sets both for the whole run.  Prompts are drawn from a generator seeded with
    ``seed``.  Returns the record of the phase's JSON line."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core.model import _leaves, _map_tree
    from repro_torch.models import DecoderLM
    from repro_torch.serve.serve_step import make_prefill_step

    check(not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
          "lm_serve: bf16 products would be reduced in bf16 (smoke() turns that off)")
    gen = torch.Generator(device=dev).manual_seed(seed)

    rec: dict = {"bf16_reduced_precision_reduction": False}

    # (a) tinyllama-1.1b, fp32, at full width and depth.
    arch = get_arch(LM_ARCH)
    cfg32 = dataclasses.replace(arch.config, dtype="float32")
    model = DecoderLM(cfg32)
    params, init_s = lm_timed(dev, lambda: model.init(seed, device=dev))
    n_params = sum(t.numel() for t in _leaves(params))
    est = cfg32.param_count_estimate()
    norms = (2 * cfg32.num_layers + 1) * cfg32.d_model
    check(n_params == est + norms,
          f"{LM_ARCH}: {n_params} parameters, not the estimate {est} plus {norms} norm scales")
    check(all(t.device.type == dev.type for t in _leaves(params)),
          f"{LM_ARCH}: a weight is not on {dev}")
    B, S = LM_CHECK
    toks = torch.randint(0, cfg32.vocab_size, (B, S), generator=gen, device=dev)
    prefill32 = make_prefill_step(cfg32, device=dev)
    full, _ = lm_timed(dev, lambda: prefill32(params, {"tokens": toks}).float())
    (exc, diff), dec32_s = lm_timed(
        dev, lambda: lm_decode_against(dev, params, cfg32, toks, full))
    check(bool((exc <= 0).all()), f"{LM_ARCH}: fp32 decode differs from prefill past "
          f"{LM_TOL} at step {int(exc.argmax())} (max abs {float(diff.max())})")
    rec["tinyllama"] = {
        "config": {k: getattr(cfg32, k) for k in (
            "name", "num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim", "d_ff",
            "vocab_size")},
        "params": n_params, "param_count_estimate": est, "norm_scales": norms,
        "init_s": init_s,
        "fp32_decode_vs_prefill": {"sequences": B, "tokens": S, "max_abs_diff": float(diff.max()),
                                   "tol": LM_TOL, "decode_s": dec32_s,
                                   "decode_ms_per_step": dec32_s / S * 1e3},
    }
    del full

    # (b) the same weights in bf16: prefill and greedy decode, timed.
    Bp, Sp = LM_PREFILL
    prompts = torch.randint(0, cfg32.vocab_size, (Bp, Sp), generator=gen, device=dev)
    arg32, margin32, pre32_s = lm_fp32_argmax(dev, prefill32, params, prompts)
    cfg16 = arch.config
    check(cfg16.dtype == "bfloat16", f"{LM_ARCH}'s config is not bf16")
    params16 = _map_tree(params, lambda t: t.to(torch.bfloat16))
    del params
    bf16, cache16 = lm_bf16_serve(dev, cfg16, params16, prompts, arg32, margin32, LM_CACHE)
    bf16["prefill"]["fp32_s"] = pre32_s
    rec["tinyllama"]["bf16"] = bf16
    del params16, cache16, prompts, margin32, arg32

    # (c) gemma3-1b at full width, depth cut: banded prefill vs windowed decode.
    garch = get_arch(LM_WINDOW_ARCH)
    gcfg = dataclasses.replace(garch.config, num_layers=LM_WINDOW_LAYERS, dtype="float32")
    gmodel = DecoderLM(gcfg)
    seg = gmodel.segments[0]
    window = max(seg.windows)
    check(len(gmodel.segments) == 1 and seg.groups == 1 and len(seg.remainder) == 2
          and LM_WINDOW_TOKENS % window == 0 and LM_WINDOW_TOKENS > window,
          f"{LM_WINDOW_ARCH}: the cut is not one group and a 2-layer remainder over a "
          f"banded prefill")
    gparams, ginit_s = lm_timed(dev, lambda: gmodel.init(seed, device=dev))
    gtoks = torch.randint(0, gcfg.vocab_size, (1, LM_WINDOW_TOKENS), generator=gen, device=dev)
    gfull, gpre_s = lm_timed(dev, lambda: make_prefill_step(gcfg, device=dev)(
        gparams, {"tokens": gtoks}).float())
    (gexc, gdiff), gdec_s = lm_timed(
        dev, lambda: lm_decode_against(dev, gparams, gcfg, gtoks, gfull))
    check(bool((gexc <= 0).all()), f"{LM_WINDOW_ARCH}: windowed decode differs from the "
          f"banded prefill past {LM_TOL} at step {int(gexc.argmax())}")
    rec["gemma3"] = {
        "config": {k: getattr(gcfg, k) for k in (
            "name", "d_model", "num_heads", "num_kv_heads", "head_dim", "d_ff", "vocab_size",
            "window_pattern", "tie_embeddings")},
        "reduced": {"num_layers": [LM_WINDOW_LAYERS, garch.config.num_layers]},
        "plan": {"groups": seg.groups, "pattern_windows": list(seg.windows),
                 "remainder_windows": list(seg.rem_windows)},
        "params": sum(t.numel() for t in _leaves(gparams)), "init_s": ginit_s,
        "tokens": LM_WINDOW_TOKENS, "prefill_s": gpre_s, "decode_s": gdec_s,
        "decode_ms_per_step": gdec_s / LM_WINDOW_TOKENS * 1e3,
        "max_abs_diff": float(gdiff.max()),
        "max_abs_diff_past_window": float(gdiff[window:].max()), "tol": LM_TOL,
    }
    del gparams, gfull
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return rec


def own_dtypes(cfg) -> list:
    """The dtype of every leaf ``cfg``'s own ``DecoderLM.init`` makes, in
    ``_leaves`` order: read off the init of a twin of ``cfg`` on the CPU,
    with its depth, block plan and dtype and tiny widths (a leaf's dtype
    does not depend on widths)."""
    import torch

    from repro_torch.core.model import _leaves
    from repro_torch.models import DecoderLM

    twin = dataclasses.replace(
        cfg, d_model=16, num_heads=2, num_kv_heads=2 if cfg.num_kv_heads == cfg.num_heads else 1,
        head_dim=8, d_ff=16, vocab_size=16, rglru_dim=16 if cfg.rglru_dim else 0)
    return [t.dtype for t in _leaves(DecoderLM(twin).init(0, device=torch.device("cpu")))]


def leaf_paths(tree, path=()):
    """``(path, leaf)`` of every leaf, in ``_leaves`` order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaf_paths(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaf_paths(v, path + (i,))
    elif tree is not None:
        yield path, tree


def state_bytes(cfg, cache) -> dict:
    """A cache's bytes per sequence: the recurrent states (RWKV's wkv and
    token shifts, RG-LRU's h and conv rows), and the attention layers'
    k and v per cached token; each beside the same count from the
    config's shapes."""
    B = None
    rec_bytes = kv_bytes = 0
    for path, t in leaf_paths(cache["layers"]):
        stacked = path[1] == "groups"
        batch = t.shape[1] if stacked else t.shape[0]
        B = batch if B is None else B
        check(batch == B, f"{cfg.name}: a cache leaf's batch is {batch}, not {B}")
        if path[-1] in ("k", "v"):
            T = t.shape[2] if stacked else t.shape[1]
            kv_bytes += t.numel() * t.element_size() // (B * T)
        else:
            rec_bytes += t.numel() * t.element_size() // B
    size = 2 if cfg.dtype == "bfloat16" else 4
    kinds = cfg.layer_blocks
    d, H = cfg.d_model, cfg.num_heads
    rd, cw = cfg.rglru_dim or d, cfg.conv_width
    want_rec = size * (kinds.count("rwkv") * (H * (d // H) ** 2 + 2 * d)
                       + kinds.count("rglru") * (rd + (cw - 1) * rd))
    want_kv = size * kinds.count("attn") * 2 * cfg.num_kv_heads * cfg.head_dim
    check(rec_bytes == want_rec and kv_bytes == want_kv,
          f"{cfg.name}: state {rec_bytes} B and kv {kv_bytes} B a token against the shapes' "
          f"{want_rec} and {want_kv}")
    return {"recurrent_state_bytes_per_sequence": rec_bytes,
            "kv_bytes_per_sequence_token": kv_bytes}


def lm_recurrent_phase(dev, seed: int) -> dict:
    """The RWKV6 and RG-LRU blocks (ROADMAP M12c-1) through the serving
    path (``make_prefill_step``, ``make_decode_step``,
    ``make_cache_factory``): each of LM_REC_ARCHS at full width and depth,

    (a) weights from ``DecoderLM.init`` on the card in fp32, their count
        against the reference tree's (LM_REC_PARAMS; the reference's
        ``param_count_estimate`` undercounts both archs and is reported
        beside it); LM_CHECK tokens decoded one step at a time from an
        empty state, held against the prefill of the same tokens within
        LM_TOL; the fp32 prefill of LM_REC_PREFILL tokens, of which only
        the argmaxes and top-two margins are kept;
    (b) the same weights cast, leaf by leaf, to the dtypes the bf16
        config's own init gives (RG-LRU's ``a_param`` stays fp32), the
        fp32 tree freed; the fp32 prefill of the same prompts on those
        rounded weights, whose argmaxes against the first ones show how
        far rounding the weights alone moves them (recorded, not
        checked); the bf16 prefill timed, its argmaxes equal to the fp32
        ones on LM_AGREE of the rows with an fp32 margin of LM_REC_MARGIN
        or more, a greedy decode of LM_DECODE steps and sequences timed
        (recurrentgemma's inside its 2,048-token window), the cache's
        bytes per sequence and the peak device memory (``lm_bf16_serve``).

    bf16 products accumulate in fp32 and TF32 stays off, as ``smoke()``
    sets both.  Prompts are drawn from a generator seeded with ``seed``.
    Returns the record of the phase's JSON line."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core.model import _leaves, _map_tree, _with_leaves
    from repro_torch.models import DecoderLM
    from repro_torch.serve.serve_step import make_prefill_step

    check(not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
          "lm_recurrent: bf16 products would be reduced in bf16 (smoke() turns that off)")
    gen = torch.Generator(device=dev).manual_seed(seed)
    rec: dict = {"bf16_reduced_precision_reduction": False}
    for arch_id in LM_REC_ARCHS:
        cfg16 = get_arch(arch_id).config
        check(cfg16.dtype == "bfloat16", f"{arch_id}'s config is not bf16")
        cfg32 = dataclasses.replace(cfg16, dtype="float32")
        model = DecoderLM(cfg32)

        # (a) fp32: the parameter count, decode against prefill.
        params, init_s = lm_timed(dev, lambda: model.init(seed, device=dev))
        n_params = sum(t.numel() for t in _leaves(params))
        check(n_params == LM_REC_PARAMS[arch_id],
              f"{arch_id}: {n_params} parameters, not the reference tree's "
              f"{LM_REC_PARAMS[arch_id]}")
        check(all(t.device.type == dev.type for t in _leaves(params)),
              f"{arch_id}: a weight is not on {dev}")
        B, S = LM_CHECK
        toks = torch.randint(0, cfg32.vocab_size, (B, S), generator=gen, device=dev)
        prefill32 = make_prefill_step(cfg32, device=dev)
        full, _ = lm_timed(dev, lambda: prefill32(params, {"tokens": toks}).float())
        (exc, diff), dec32_s = lm_timed(
            dev, lambda: lm_decode_against(dev, params, cfg32, toks, full))
        check(bool((exc <= 0).all()), f"{arch_id}: fp32 decode differs from prefill past "
              f"{LM_TOL} at step {int(exc.argmax())} (max abs {float(diff.max())})")
        del full
        Bp, Sp = LM_REC_PREFILL[arch_id]
        prompts = torch.randint(0, cfg32.vocab_size, (Bp, Sp), generator=gen, device=dev)
        arg32, margin32, pre32_s = lm_fp32_argmax(dev, prefill32, params, prompts)

        # (b) bf16 in the reference's dtypes: prefill and greedy decode, timed.
        dtypes = own_dtypes(cfg16)
        params16, cast_s = lm_timed(dev, lambda: _with_leaves(params, [
            t.to(d) for t, d in zip(_leaves(params), dtypes, strict=True)]))
        params = None
        # The model's own sensitivity: fp32 on the bf16-rounded weights.
        rounded = _map_tree(params16, lambda t: t.float())
        lg, control_s = lm_timed(dev, lambda: prefill32(rounded, {"tokens": prompts}))
        control = argmax_agreement(lg.argmax(dim=-1), arg32, margin32)
        del rounded, lg
        fp32_leaves = ["/".join(map(str, path)) for path, t in leaf_paths(params16)
                       if t.dtype == torch.float32]
        n_rglru = sum((seg.pattern + seg.remainder).count("rglru") for seg in model.segments)
        check([t.dtype for t in _leaves(params16)] == dtypes
              and len(fp32_leaves) == n_rglru
              and all(p.endswith("/attn/a_param") for p in fp32_leaves),
              f"{arch_id}: the bf16 tree's fp32 leaves are {fp32_leaves}")
        Sd, Bd = LM_DECODE
        bf16, cache16 = lm_bf16_serve(dev, cfg16, params16, prompts, arg32, margin32, Sd,
                                      margin=LM_REC_MARGIN)
        bf16["prefill"]["fp32_s"] = pre32_s
        rec[arch_id] = {
            "config": {k: getattr(cfg16, k) for k in (
                "name", "num_layers", "block_pattern", "window_pattern", "d_model",
                "num_heads", "num_kv_heads", "head_dim", "d_ff", "vocab_size", "rglru_dim",
                "conv_width", "tie_embeddings")},
            "params": n_params, "param_count_estimate": cfg32.param_count_estimate(),
            "init_s": init_s, "cast_s": cast_s, "fp32_leaves_in_bf16_tree": fp32_leaves,
            "fp32_on_bf16_weights_vs_fp32": {"by_margin": control, "s": control_s},
            "fp32_decode_vs_prefill": {"sequences": B, "tokens": S,
                                       "max_abs_diff": float(diff.max()), "tol": LM_TOL,
                                       "decode_s": dec32_s,
                                       "decode_ms_per_step": dec32_s / S * 1e3},
            "bf16": bf16, **state_bytes(cfg16, cache16),
        }
        del params16, cache16, prompts, margin32, arg32
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return rec


def npz_arrays(path) -> dict:
    """``{key: array}`` of an uncompressed ``.npz`` as memory maps of its
    members' data (what ``np.savez`` stores, read with no copy and no
    crc32 pass, which took most of a 6.6 GB comparison); copy-on-write,
    so ``torch.from_numpy`` takes them as they are and the file is never
    written."""
    import numpy as np

    out = {}
    with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
        for info in zf.infolist():
            check(info.compress_type == zipfile.ZIP_STORED, f"{path}: a compressed member")
            f.seek(info.header_offset + 26)  # the local header's name and extra lengths
            n_name, n_extra = struct.unpack("<HH", f.read(4))
            f.seek(info.header_offset + 30 + n_name + n_extra)
            version = np.lib.format.read_magic(f)
            read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                    else np.lib.format.read_array_header_2_0)
            shape, fortran, dtype = read(f)
            check(not fortran, f"{path}: {info.filename} is in Fortran order")
            out[info.filename[:-len(".npy")]] = np.memmap(
                path, dtype=dtype, mode="c", offset=f.tell(), shape=shape)
    return out


def lm_train_phase(dev, seed: int, read_launches) -> tuple:
    """The LM substrate's training path (ROADMAP M12b) at full width:

    (a) ``repro_torch.launch.train.main`` on tinyllama-1.1b (22 layers,
        d_model 2,048, bf16, the launcher's batch and optimizer) with
        ``--compressed-data`` for LM_TRAIN_STEPS[0] steps: the token store
        is built over the launcher's 200,000-token corpus (its deployed
        engine finds the T_aux rows, through K2 as every build does) and
        every batch is looked up through it (K1 on the fused tier); the
        run saves its state at its end.
        Then again without ``--compressed-data`` to LM_TRAIN_STEPS[1]
        steps: it must resume from ``LATEST``, the restored state equal
        bit for bit to that checkpoint's ``arrays.npz``; every loss
        finite, no restart, and the restored state's loss on the batch of
        step LM_TRAIN_STEPS[0] - 1 at least LM_TRAINED_DROP below the loss
        that step recorded before its update;
    (c) ``make_train_step`` on the same arch from a fresh ``init_state``
        at LM_TRAIN_SHAPE, batches from the token store: one warm-up and
        LM_TRAIN_TIMED timed steps (ms, tokens/s, peak device memory, the
        model FLOPs' share of the bf16 peak); the bf16 loss against the
        fp32 loss of the same weights and batch, at the warm-up step and
        on the trained weights and the last step's batch (where the
        logits are no longer near uniform), both within LM_LOSS_TOL;

    then the path's launches are read, and

    (b) the token store: every position looked up equals the corpus; the
        launcher's loader through the store equals it through the raw
        tokens on every step (a) ran; K1 on the store's own model (a
        19,057-way head), and K2 on the digits K1 makes, each against its
        plain version on every position, codes equal but on near ties
        (plain top-two margin below MARGIN_TOL), with the near-tie rows
        counted; K1's time on one chunk beside its plain version and
        bound.

    Returns ``(record, launches)``.  The checkpoints go under the ignored
    ``build/`` and are removed however the phase ends."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core import trainer as trainer_lib
    from repro_torch.core.model import _map_tree
    from repro_torch.data import tokens as tokens_lib
    from repro_torch.data.loader import LoaderConfig, TokenBatchLoader
    from repro_torch.kernels import fused_mlp as fm
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import train as launcher
    from repro_torch.models.layers import _dtype
    from repro_torch.train import checkpoint as ckpt_lib
    from repro_torch.train.optimizer import adamw, warmup_cosine
    from repro_torch.train.train_step import init_state, make_loss_fn, make_train_step

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    S1, S2 = LM_TRAIN_STEPS
    arch = get_arch(LM_ARCH)
    cfg = arch.config
    check(cfg.dtype == "bfloat16" and cfg.remat != "none",
          f"{LM_ARCH}: the launcher's config is not bf16 with remat")
    corpus = tokens_lib.make_structured_tokens(LM_CORPUS, vocab=cfg.vocab_size, run_len=8,
                                               seed=0)
    rec: dict = {"arch": LM_ARCH, "config": {k: getattr(cfg, k) for k in (
        "num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim", "d_ff", "vocab_size",
        "dtype", "remat")}, "steps": [S1, S2], "corpus_tokens": LM_CORPUS,
        "distinct_tokens": int(np.unique(corpus).size)}
    ckpt_dir = ROOT / "build" / f"chip_smoke_lm_{os.getpid()}"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    argv = ["--arch", LM_ARCH, "--ckpt-dir", str(ckpt_dir), "--ckpt-every", str(S2 + 1),
            "--device", str(dev)]
    try:
        # (a) the launcher twice: over the token store, then resumed.
        timer = CallTimer([
            (tokens_lib.DeepMappingTokenStore, "build"),
            (trainer_lib, "train", lambda out: (len(out[2]), int(out[1].step), out[2][-1])),
            (ckpt_lib.AsyncCheckpointer, "save"),
            (ckpt_lib, "save_checkpoint"),
            (ckpt_lib, "restore_latest", lambda out: out),
        ], sync)
        with timer:
            t0 = time.perf_counter()
            rep1, store = launcher.main(argv + ["--compressed-data", "--steps", str(S1)])
            sync()
            run1_s = time.perf_counter() - t0
            ck_dir = ckpt_dir / f"step_{S1:08d}"
            ck_bytes = {f.name: f.stat().st_size for f in sorted(ck_dir.iterdir())}
            t0 = time.perf_counter()
            rep2, no_store = launcher.main(argv + ["--steps", str(S2)])
            sync()
            run2_s = time.perf_counter() - t0
        check(store is not None and no_store is None, "lm_train: the launcher returned no store, "
              "or one without --compressed-data")
        check(rep1.final_step == S1 and rep1.steps_run == S1 and rep1.restarts == 0,
              f"lm_train: run 1 ended at {rep1.final_step} after {rep1.steps_run} steps")
        check(rep2.final_step == S2 and rep2.steps_run == S2 - S1 and rep2.restarts == 0,
              f"lm_train: the resumed run ended at {rep2.final_step} after {rep2.steps_run} "
              f"steps, {rep2.restarts} restarts")
        losses = rep1.losses + rep2.losses
        check(all(np.isfinite(losses)), f"lm_train: a loss is not finite: {losses}")
        restores = timer.results["restore_latest"]
        check(len(restores) == 2 and restores[0] == (None, None) and restores[1][0] == S1,
              f"lm_train: the restores found {[r[0] for r in restores]}, not [None, {S1}]")
        restored = restores[1][1]
        timer.results["restore_latest"].clear()
        # The restored state against the checkpoint's arrays, bit for bit.
        t0 = time.perf_counter()
        arrays = npz_arrays(ck_dir / "arrays.npz")
        n_leaves = [0]

        def same(key, t):
            n_leaves[0] += 1
            arr = arrays[key]
            bf16 = arr.dtype == np.dtype("V2")
            want = torch.from_numpy(arr.view(np.int16) if bf16 else arr).to(t.device)
            got = t.detach().view(torch.int16) if t.dtype == torch.bfloat16 else t.detach()
            check(bf16 == (t.dtype == torch.bfloat16) and got.dtype == want.dtype
                  and torch.equal(got, want),
                  f"lm_train: restored leaf {key} differs from arrays.npz")

        ckpt_lib._rebuild(restored, same)
        check(n_leaves[0] == len(arrays), f"lm_train: {n_leaves[0]} restored leaves against "
              f"{len(arrays)} arrays")
        del arrays
        compare_s = time.perf_counter() - t0
        # The steps trained: the restored state's loss on the batch of step
        # S1 - 1 against the loss that step recorded before its update.  (A
        # fresh batch's loss cannot show it in a few steps: each holds about
        # 65 of the corpus' 19,057 tokens, and what the model learns first is
        # per token.)
        lcfg = LoaderConfig(global_batch=8, seq_len=64, seed=0)  # the launcher's loader
        seen = {"tokens": torch.from_numpy(TokenBatchLoader(lcfg, tokens=corpus).batch_for_step(
            S1 - 1)["tokens"]).to(dev)}
        with torch.no_grad():
            seen_loss = float(make_loss_fn(cfg)[0](restored.params, seen))
        check(seen_loss < rep1.losses[-1] - LM_TRAINED_DROP,
              f"lm_train: the restored state's loss on step {S1 - 1}'s batch is {seen_loss}, "
              f"not below the {rep1.losses[-1]} that step recorded by {LM_TRAINED_DROP}")
        del restored, restores
        manifest = json.loads((ck_dir / "manifest.json").read_text())
        epochs, store_steps, last_loss = timer.results["train"][0]
        rec["launcher"] = {
            "run1": {"steps": S1, "wall_s": run1_s, "losses": rep1.losses,
                     "stragglers": len(rep1.straggler_events)},
            "run2": {"steps": S2, "resumed_from": S1, "wall_s": run2_s, "losses": rep2.losses,
                     "stragglers": len(rep2.straggler_events)},
            "loss_first_last": [losses[0], losses[-1]], "restarts": 0,
            "trained_batch": {"step": S1 - 1, "loss_at_step": rep1.losses[-1],
                              "loss_after": seen_loss, "need_drop": LM_TRAINED_DROP},
            "checkpoint": {"bytes": ck_bytes, "arrays": len(manifest["arrays"]),
                           "bf16_arrays": sum(v["dtype"] == "bfloat16"
                                              for v in manifest["arrays"].values()),
                           "snapshot_s": timer.seconds["save"],
                           "write_s": timer.seconds["save_checkpoint"],
                           "saves": timer.calls["save_checkpoint"],
                           "restore_s": timer.seconds["restore_latest"],
                           "restored_equal_bits": True, "compare_s": compare_s},
        }
        eng = store.store.engine
        build_stats = {k: getattr(eng.stats, k) for k in (
            "dispatches", "fused_calls", "pallas_calls", "fused_streamed_calls", "jit_calls")}

        # (c) the train step at a realistic shape, batches from the store.
        Bt, St = LM_TRAIN_SHAPE
        loader = TokenBatchLoader(LoaderConfig(global_batch=Bt, seq_len=St, seed=seed),
                                  store=store)
        batches = [{"tokens": torch.from_numpy(loader.batch_for_step(k)["tokens"]).to(dev)}
                   for k in range(1 + LM_TRAIN_TIMED)]
        opt = adamw(lr=warmup_cosine(3e-3, 10, 1 + LM_TRAIN_TIMED), max_grad_norm=1.0)
        state = init_state(cfg, opt, seed=seed, device=dev)
        loss16_fn = make_loss_fn(cfg)[0]
        loss32_fn = make_loss_fn(dataclasses.replace(cfg, dtype="float32"))[0]

        def fp32_loss(params, batch):
            with torch.no_grad():
                return float(loss32_fn(_map_tree(params, lambda t: t.float()), batch))

        loss32 = fp32_loss(state.params, batches[0])
        sync()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        step = make_train_step(cfg, opt)
        step_s, step_losses = [], []
        for b in batches:
            sync()
            t0 = time.perf_counter()
            state, metrics = step(state, b)
            step_losses.append(float(metrics["loss"]))
            sync()
            step_s.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
        check(all(np.isfinite(step_losses)), f"lm_train: a train-step loss is not finite")
        check(abs(step_losses[0] - loss32) <= LM_LOSS_TOL,
              f"lm_train: bf16 loss {step_losses[0]} against fp32 {loss32}")
        # The same on the trained weights and the batch the last step
        # trained on, where the model's output is no longer uniform (at
        # random weights the loss sits near ln V whatever the precision).
        with torch.no_grad():
            trained16 = float(loss16_fn(state.params, batches[-1]))
        trained32 = fp32_loss(state.params, batches[-1])
        check(abs(trained16 - trained32) <= LM_LOSS_TOL,
              f"lm_train: trained bf16 loss {trained16} against fp32 {trained32}")
        # Model FLOPs: 6 per matmul weight and token (forward and
        # backward; remat's recompute not counted), and causal attention's
        # two products, 6 B S^2 H hd a layer.
        n_tok = Bt * (St + 1)
        d, hd = cfg.d_model, cfg.head_dim
        n_mm = cfg.num_layers * (2 * d * cfg.num_heads * hd + 2 * d * cfg.num_kv_heads * hd
                                 + 3 * d * cfg.d_ff) + d * cfg.vocab_size
        flops = 6 * n_mm * n_tok + 6 * Bt * (St + 1) ** 2 * cfg.num_heads * hd * cfg.num_layers
        timed_s = statistics.median(step_s[1:])
        rec["train_step"] = {
            "sequences": Bt, "tokens_per_sequence": St + 1, "steps_timed": LM_TRAIN_TIMED,
            "step_s": step_s, "ms_per_step": timed_s * 1e3, "tokens_per_s": n_tok / timed_s,
            "peak_device_bytes": peak, "model_flops": flops,
            "bf16_peak_share": flops / timed_s / PEAK_BF16_FLOPS, "losses": step_losses,
            "loss_fp32": loss32, "loss_bf16_minus_fp32": step_losses[0] - loss32,
            "trained_loss": {"batch": LM_TRAIN_TIMED, "bf16": trained16, "fp32": trained32,
                             "bf16_minus_fp32": trained16 - trained32},
            "loss_tol": LM_LOSS_TOL, "dtype": str(_dtype(cfg.dtype)),
        }
        del state, batches, metrics
        sync()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        launches = read_launches()
        lookups = store.lookups
        check(launches["fused_lookup"] > 0, f"lm_train: K1 was not launched: {launches}")
        check(launches["fused_lookup"] >= lookups,
              f"lm_train: {lookups} token-store lookups but {launches['fused_lookup']} K1 "
              f"launches")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    # (b) the token store: lossless, the loader's batches, K1 on its head.
    t0 = time.perf_counter()
    got = store.get(np.arange(LM_CORPUS))
    get_s = time.perf_counter() - t0
    check(np.array_equal(got, corpus), "lm_train: the token store is not lossless")
    via_store = TokenBatchLoader(lcfg, store=store)
    via_raw = TokenBatchLoader(lcfg, tokens=corpus)
    for k in range(S2):
        check(np.array_equal(via_store.batch_for_step(k)["tokens"],
                             via_raw.batch_for_step(k)["tokens"]),
              f"lm_train: the store's batch differs from the raw one at step {k}")
    eng = store.store.engine
    spec = store.store.spec
    flat, _ = eng._entry(spec.tasks).flat()
    pos, words = eng._device_pos_ops(), eng._device_words()
    cap = store.store.encoder.capacity
    base_pad = ops._round_up(spec.base, ops.LANE)
    card = spec.card_map["token"]
    near, differ, differ2, k1_k2 = 0, 0, 0, 0
    for lo in range(0, LM_CORPUS, LM_K1_CHUNK):
        keys = np.arange(lo, min(lo + LM_K1_CHUNK, LM_CORPUS), dtype=np.int64)
        n = keys.size
        kt = eng._keys_dev(keys, ops._round_up(n, 256))
        k1 = fm.fused_lookup_call(kt, pos, words, flat, spec, 256, base_pad, cap)
        want = ref.fused_lookup(kt, pos, words, flat, spec, cap)
        # The digits K1 makes, on every padded row (K2 takes whole tiles),
        # and the plain side's top-two margin per row.
        k = kt.long()
        digits = torch.stack([((k % int(md)) // int(dv)) % spec.base
                              for md, dv in pos.tolist()], dim=1).to(torch.int32).contiguous()
        top = torch.topk(ref._forward_flat(flat, spec, digits[:n], emit_codes=False)[0][:, :card],
                         2, dim=1).values
        tie = (top[:, 0] - top[:, 1]) < MARGIN_TOL
        diff = k1[0][:n, 0] != want[0][:n, 0]
        check(not bool((diff & ~tie).any()),
              "lm_train: K1's token codes differ from the plain version on a clear row")
        check(torch.equal(k1[1][:n], want[1][:n]), "lm_train: K1's existence bits differ")
        # K2 on the same digits: the build finds T_aux through it.
        k2 = fm.fused_mlp_call(digits, flat, spec, 256, base_pad, ops.card_pads(spec), True)
        diff2 = k2[:n, 0] != ref.fused_mlp(digits, flat, spec, True)[:n, 0]
        check(not bool((diff2 & ~tie).any()),
              "lm_train: K2's token codes differ from the plain version on a clear row")
        near += int(tie.sum())
        differ += int(diff.sum())
        differ2 += int(diff2.sum())
        k1_k2 += int((k1[0][:n, 0] != k2[:n, 0]).sum())
    # K1 on one chunk of this model, against its plain version and bound.
    kt = eng._keys_dev(np.arange(LM_K1_CHUNK, dtype=np.int64), LM_K1_CHUNK)
    bound = mlp_bound(spec, LM_K1_CHUNK, 4, 4 * len(spec.tasks) + 4,
                      int(words.numel()) * 4 + int(pos.numel()) * 4)
    k1_ms = time_ms(lambda: fm.fused_lookup_call(kt, pos, words, flat, spec, 256, base_pad, cap))
    plain_ms = time_ms(lambda: ref.fused_lookup(kt, pos, words, flat, spec, cap), reps=5)
    rec["token_store"] = {
        "epochs": epochs, "train_steps": store_steps, "last_train_loss": last_loss,
        "build_s": timer.seconds["build"], "train_s": timer.seconds["train"],
        "tier_stats_at_path_end": build_stats, "plan": fm.tile_plan(spec).describe(),
        "spec": {"width": spec.width, "shared": list(spec.shared),
                 "private": list(spec.private_map["token"]), "card": card},
        "memorized_fraction": store.memorized_fraction(), "aux_rows": store.store.aux.num_rows,
        "compression_ratio": store.compression_ratio(), "size_bytes": store.size_bytes(),
        "lookups_on_path": lookups, "get_all_s": get_s, "loader_steps_checked": S2,
        "k1_vs_plain": {"keys": LM_CORPUS, "differing_rows": differ, "near_tie_rows": near,
                        "margin_tol": MARGIN_TOL},
        "k2_vs_plain": {"keys": LM_CORPUS, "differing_rows": differ2, "near_tie_rows": near,
                        "margin_tol": MARGIN_TOL, "k1_k2_differing_rows": k1_k2},
        "k1_chunk": {"keys": LM_K1_CHUNK, "ms": k1_ms, "plain_ms": plain_ms, **bound},
    }
    del store
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return rec, launches


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
                    help="only time K1 and K2 on the wider models and K3 on the SF1 vector, "
                         "through the public calls")
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
    from repro_torch.cluster import (
        ClusterConfig, ShardedDeepMappingStore, plan_range_partitions,
    )
    from repro_torch.configs.deepmapping_paper import PAPER_STORE
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
    # bf16 products (lm_serve) accumulate in fp32.
    bf16_red_was = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
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
        bf16_reduced_precision_reduction={"before": bf16_red_was, "now": False},
        kernel_build_s=build_s,
        nvcc_seconds={src: info["seconds"] for src, info in build.BUILD_INFO.items()},
        ptxas=ptxas,
        codec="zstd" if storage.HAVE_ZSTD else "zstd (zlib fallback: no zstandard)",
    )

    # The slice's full width: TPC-H orders at SF1, the paper's store.
    table = orders_like(ROWS, seed=args.seed)
    config = PAPER_STORE
    train_epochs = config.train.epochs
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

    # The MHAS search space over this table: children at the paper's
    # widths cut from the weight bank and served through K2, whose
    # launches count on a path of their own.  The keys come from a
    # generator of their own, so later phases draw as they did before.
    mhas_rng = np.random.default_rng(args.seed)
    mhas_keys = np.concatenate([[0, table.max_key],
                                mhas_rng.choice(table.keys, MHAS_KEYS - 2, replace=False)])
    reset_launches()
    mhas, served = mhas_space_check(spec, encoder, mhas_keys, dev, args.seed, margins,
                                    cmp_codes)
    paths["mhas"] = read_launches()
    check(paths["mhas"]["fused_mlp"] >= 2 * len(mhas["children"]),
          "a child of the search space was not served through K2")
    check(paths["mhas"]["fused_lookup"] == 0 and paths["mhas"]["bitvector"] == 0,
          "the MHAS check launched K1 or K3")
    # The same children through the engine's own tier choice, on a path
    # of their own: one K2 launch a pallas_digits child, one K1 launch a
    # page of a fused_streamed one, none on the plain path.
    reset_launches()
    engine_rows = mhas_engine_check(served, encoder, mhas_keys, dev)
    paths["mhas_engine"] = read_launches()
    del served
    want = {"fused_mlp": sum(r["tier"] == "pallas_digits" for r in engine_rows),
            "fused_lookup": sum(r["pages"] for r in engine_rows
                                if r["tier"] == "fused_streamed"), "bitvector": 0}
    check(all(paths["mhas_engine"][k] == v for k, v in want.items()),
          f"the engine's launches {paths['mhas_engine']} are not its tiers' {want}")
    emit("mhas_space", launches=paths["mhas"], engine=engine_rows,
         engine_launches=paths["mhas_engine"], **mhas)

    def store_kernels_vs_plain(s, keys, draw=None):
        """K1 (where the store's key domain fits int32) and K2 on a trained
        store's own weights, spec and key features (residue positions
        included), on its first 256 and 65,536 ``keys``, against their
        plain versions by the rule above: K1 with no predicate tables and
        with one per head (up to ``ref.MAX_PREDS``), K2 codes and logits,
        K1 codes equal to K2's.  Comparison launches: the correlated and
        multikey phases call this after reading their paths' counts.  The
        predicate tables are drawn from ``draw`` (the phases' ``rng`` by
        default)."""
        draw = rng if draw is None else draw
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
                    torch.from_numpy((draw.random(ops._round_up(mspec.card_map[t], ops.LANE))
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
    # K3's path is its public entry point, bitvector_test, on keys as a
    # caller holds them: int64 and int32, contiguous, misaligned views,
    # a strided view, lengths 1 to 9, 1,023 to 65,537 and all 1.6 M SF1
    # keys with absent ones, over the SF1 store's existence vector and a
    # 10^8-slot vector; one K3 launch a call.  Its results are then held
    # against the plain version (on the card) and the host
    # BitVector.test, and the reference's contract (bitvector_call, int32
    # -> int32) against the plain version on the largest calls' keys.
    dom = 32 * words.shape[0]
    k3_sf1, absent_k3, bv_edges = k3_keys(table, bv, rng)
    k3_inputs = []
    for n in (1023, 1024, 1025, 65536, 65537):
        k3_inputs.append(np.concatenate([
            bv_edges, rng.choice(table.keys, (n - bv_edges.size) // 2),
            rng.integers(-64, dom + 64, n - bv_edges.size - (n - bv_edges.size) // 2),
        ]))
    rng3 = np.random.default_rng([args.seed, 3])
    big_set = np.unique(rng3.integers(0, K3_BIG_SLOTS, K3_BIG_SET))
    big_bv = BitVector.from_keys(big_set, capacity=K3_BIG_SLOTS)
    big_words = ops.words_tensor(big_bv.words, dev)
    big_absent = rng3.integers(0, K3_BIG_SLOTS, 400_000)
    big_keys = np.concatenate([big_set, big_absent[~big_bv.test(big_absent)][:100_000],
                               k3_edges(big_bv)])
    # A base of 65,540 keys, so that its view [3:] holds 65,537.
    mix = np.concatenate([bv_edges, rng3.choice(table.keys, 32_770),
                          rng3.integers(-64, dom + 64, 65_540 - 32_770 - bv_edges.size)])
    rng3.shuffle(mix)
    k3_cases = []  # (label, vector, its words on the card, keys on the card)
    for kn in (*k3_inputs, k3_sf1):
        t64 = torch.from_numpy(kn).to(dev)
        k3_cases.append((f"int64 n={kn.size}", bv, words, t64))
        k3_cases.append((f"int32 n={kn.size}", bv, words,
                         t64.clamp(-2**31, 2**31 - 1).to(torch.int32)))
    for dtype in (torch.int64, torch.int32):
        base = torch.from_numpy(mix).to(dev).clamp(-2**31, 2**31 - 1).to(dtype) \
            if dtype == torch.int32 else torch.from_numpy(mix).to(dev)
        views = [("[1:]", base[1:]), ("[3:]", base[3:]), ("[::2]", base[::2])]
        views += [(f"[:{n}]", base[:n]) for n in range(1, 10)]
        views += [(f"[3:{3 + n}]", base[3:3 + n]) for n in range(1, 10)]
        k3_cases += [(f"{str(dtype)[6:]} {label}", bv, words, v) for label, v in views]
    big_t = torch.from_numpy(big_keys).to(dev)
    k3_cases.append((f"10^8 slots int64 n={big_keys.size}", big_bv, big_words, big_t))
    k3_cases.append((f"10^8 slots int32 n={big_keys.size}", big_bv, big_words,
                     big_t.clamp(-2**31, 2**31 - 1).to(torch.int32)))
    torch.cuda.synchronize()
    reset_launches()
    k3_out = [ops.bitvector_test(vec.words, t) for _, vec, _, t in k3_cases]
    paths["bitvector"] = read_launches()
    k3_launches = paths["bitvector"]["bitvector"]
    check(k3_launches == len(k3_cases),
          f"{len(k3_cases)} bitvector_test calls launched K3 {k3_launches} times")
    k3_rows = []
    k3_err = 0
    for (label, vec, w32, t), got in zip(k3_cases, k3_out):
        plain = ref.ref_bitvector_test(w32, t).bool()
        host = vec.test(t.cpu().numpy().astype(np.int64))
        check(got.dtype == torch.bool and got.shape == t.shape, f"K3 result of {label}: "
              f"{got.dtype} {tuple(got.shape)}")
        check(torch.equal(got, plain), f"K3 differs from its plain version on {label}")
        check(np.array_equal(got.cpu().numpy(), host), f"K3 differs from BitVector.test on {label}")
        k3_err = max(k3_err, int((got.int() - plain.int()).abs().max()))
        k3_rows.append({"case": label, "n": int(t.numel()), "present": int(host.sum())})
    sf1_bits = k3_out[2 * len(k3_inputs)]
    check(bool(sf1_bits[: table.num_rows].all())
          and not sf1_bits[table.num_rows : table.num_rows + absent_k3.size].any(),
          "K3 misreads the SF1 present or absent keys")
    # The reference's contract on the two largest calls' keys, aligned
    # and at a 4-byte offset (comparison launches: not on the path).
    k3_contract = []
    for label, w32, kn in (("SF1", words, k3_sf1), ("10^8 slots", big_words, big_keys)):
        n_pad = -(-kn.size // 1024) * 1024
        k = np.where((kn >= 0) & (kn <= 2**31 - 1), kn, -1)
        kp = torch.from_numpy(np.pad(k, (0, n_pad + 1024 - k.size))).to(dev, torch.int32)
        for at, v in (("aligned", kp[:n_pad]), ("[1:]", kp[1:1 + n_pad])):
            got = bvk.bitvector_call(v, w32, 1024)
            check(got.dtype == torch.int32 and torch.equal(got, ref.ref_bitvector_test(w32, v)),
                  f"K3 int32 -> int32 differs from its plain version on {label} {at}")
            k3_contract.append({"case": f"{label} {at}", "n": n_pad})
    emit("bitvector_vs_plain", cases=k3_rows, edges=bv_edges.tolist(), capacity=bv.capacity,
         word_domain=dom, n_words=int(words.shape[0]),
         big_vector={"capacity": big_bv.capacity, "n_words": int(big_words.shape[0]),
                     "keys_set": int(big_set.size)},
         calls=len(k3_cases), launches=k3_launches, max_abs_err=k3_err, contract=k3_contract)

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

    # ------------------------------------------------------- 6. lm_serve
    # The LM substrate's dense decoders through the serve steps
    # (lm_serve_phase); no DeepMapping kernel lies on this path, so its
    # counts are read as a path of their own and must all be 0.  The
    # phase draws from a generator of its own, so later phases draw as
    # they did.
    reset_launches()
    lm_rec = lm_serve_phase(dev, args.seed)
    paths["lm_serve"] = read_launches()
    check(not any(paths["lm_serve"].values()),
          f"lm_serve launched a DeepMapping kernel: {paths['lm_serve']}")
    emit("lm_serve", nvidia_smi=smi, **lm_rec, launches=paths["lm_serve"])

    # --------------------------------------------------- 7. lm_recurrent
    # The RWKV6 and RG-LRU blocks through the serve steps
    # (lm_recurrent_phase): rwkv6-7b and recurrentgemma-2b at full width
    # and depth; no DeepMapping kernel lies on this path either, so its
    # counts must all be 0.  Its generator is its own.
    reset_launches()
    rec_rec = lm_recurrent_phase(dev, args.seed)
    paths["lm_recurrent"] = read_launches()
    check(not any(paths["lm_recurrent"].values()),
          f"lm_recurrent launched a DeepMapping kernel: {paths['lm_recurrent']}")
    emit("lm_recurrent", nvidia_smi=smi, **rec_rec, launches=paths["lm_recurrent"])

    # ------------------------------------------------------- 8. lm_train
    # The LM substrate's training path (lm_train_phase): the launcher over
    # the token store, its batches looked up through K1, then resumed
    # from its checkpoint; the train step at a realistic shape.  The
    # path's counts are read inside the phase, before K1 is held against
    # its plain version on the store's model.
    reset_launches()
    lm_train_rec, paths["lm_train"] = lm_train_phase(dev, args.seed, read_launches)
    emit("lm_train", nvidia_smi=smi, **lm_train_rec, launches=paths["lm_train"])

    # ---------------------------------------------------- 9. mhas_search
    # MHAS (Algorithm 2) over this table at the paper's layer widths
    # (PAPER_MHAS, its iterations cut), then the searched store built
    # from the chosen child and looked up: its launches count on a path
    # of their own, equal to the tiers its engine took.  Then K1 and K2
    # on the searched store's model against their plain versions
    # (comparison launches, after the count is read).  The phase draws
    # from generators of its own, so later phases draw as they did.
    torch.cuda.synchronize()
    mem_before = torch.cuda.memory_allocated()
    reset_launches()
    search_rec, paths["mhas_search"], sstore = mhas_search_phase(
        table, absent, out_cap, dev, args.seed, read_launches)
    srng = np.random.default_rng([args.seed, 6])
    s_edges = np.array([-1, 0, table.max_key, cap - 1, cap, 2**31 - 1], dtype=np.int64)
    search_kernels = store_kernels_vs_plain(sstore, np.concatenate([
        s_edges, srng.permutation(np.concatenate([
            srng.choice(table.keys, 61_440, replace=False),
            absent[: 65_536 - 61_440 - s_edges.size]]))]), draw=srng)
    del sstore
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - mem_before
    check(held < search_rec["bank_bytes"], f"mhas_search: {held} bytes still held on the "
          f"card after the phase, as much as the weight bank")
    emit("mhas_search", **search_rec, launches=paths["mhas_search"],
         kernels_vs_plain=search_kernels, device_bytes_held_after=held)

    # --------------------------------------------------------- 10. train
    # build() with no weights trains (the paper's TrainConfig), then
    # evaluates T_aux through K2 and serves through K1.  The trainer is
    # wrapped only to read its loss history and time it.
    train_table = orders_like(ROWS, seed=args.seed)
    train_cfg = config
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
    # steps at the trainer's batch, device time by name against the host
    # clock.  In the same session (the process's only one, started after
    # SF1 has trained): one bitvector_test call on contiguous keys runs
    # one CUDA kernel beside the word upload, a strided view one copy
    # kernel more.
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

    def profiled_steps():
        nonlocal pparams, popt
        for _ in range(prof_steps):
            pparams, popt, _ = trainer_lib._train_step(pparams, popt, pd, pc, tspec, 1e-3, 0.999)

    t0 = time.perf_counter()
    k3_split, windows = k3_call_split(ops, bv, k3_sf1, dev,
                                      before=[("train steps", profiled_steps)])
    session_s = time.perf_counter() - t0  # the session's start and the K3 split's timings too
    prof = windows["train steps"]
    by_kernel = prof["by_name"]
    busy = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    step_profile = {
        "steps": prof_steps, "wall_ms_per_step": prof["wall_ms"] / prof_steps,
        "session_s": session_s,
        "device_ms_per_step": busy / prof_steps if by_kernel else None,
        "device_idle_share": 1 - busy / prof["wall_ms"] if by_kernel else None,
        "top_kernels_ms_per_step": [(k[:90], v / prof_steps) for k, v in top],
    }
    emit(
        "train", rows=train_table.num_rows, epochs_max=train_epochs, epochs_run=len(hist),
        steps=trained["steps"], train_s=trained["seconds"],
        s_per_epoch=trained["seconds"] / len(hist),
        steps_per_s=trained["steps"] / trained["seconds"],
        first_loss=hist[0], last_loss=hist[-1], history=hist,
        early_stopped=len(hist) < train_epochs,
        memorized_fraction=tstore.memorized_fraction(), aux_rows=tstore.aux.num_rows,
        compression_ratio=tstore.compression_ratio(), size_breakdown=tstore.size_breakdown(),
        build_s=tbuild_s, build_launches=tbuild_launches, launches=train_launches,
        absent_checked=int(absent.size), out_of_capacity_checked=int(out_cap.size),
        lookup={"keys": train_table.num_rows, "wall_s": tlookup_s,
                "keys_per_s": train_table.num_rows / tlookup_s, "infer_s": tls.infer_s,
                "exist_s": tls.exist_s, "aux_s": tls.aux_s, "decode_s": tls.decode_s},
        step_profile=step_profile,
    )
    emit("bitvector_profile", call_split=k3_split, unplaced=windows["unplaced"],
         clock_offset_us=windows["clock_offset_us"])
    for label, want in (("int64", 1), ("int32", 1), ("int64_65536", 1), ("int64_strided", 2)):
        got_k = k3_split[label]["kernels"]
        check(len(got_k) == want and "bitvector_kernel" in got_k[-1],
              f"bitvector_test on {label} keys ran {got_k}, not {want} kernel(s) ending in K3")

    # ------------------------------------------------------- 11. persist
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

    # --------------------------------------------------------- 12. query
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

    # ------------------------------------------------------- 13. cluster
    # The reference's default cluster (ClusterConfig(): 4 range shards,
    # the 4 that benchmarks/bench_shards.py runs) over the SF1 orders
    # table, every shard trained on the card with the train phase's
    # PAPER_STORE config through repro_torch.build(..., cluster=...).
    # The shards train one at a time (a build pool of one thread, cut for
    # the smoke's time: four threads on one card train more slowly
    # together than one alone), and the cluster then serves under the
    # default config, so lookups and plans visit the shards on the
    # fan-out pool.  The default build, its shards trained on four
    # threads at once, runs over a prefix of the table (every key looked
    # up); after the path's counts are read, each of its shards' T_aux
    # rows is found again through K2 on one thread and on four threads
    # at once, equal to each other and to the build's.
    # Checked: every key, absent and out-of-capacity key
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
    # PAPER_STORE as trained in the train phase, its epochs capped at
    # CL_EPOCHS; any modified byte marks a shard dirty, so retrain()
    # rebuilds exactly the shards mutated.
    cl_cfg = dataclasses.replace(
        train_cfg, retrain_after_modified_bytes=1,
        train=dataclasses.replace(train_cfg.train, epochs=CL_EPOCHS))
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
    built, cl_build_s = hooked(lambda: repro_torch.build(
        train_table, cl_cfg, cluster=dataclasses.replace(cl_config, max_workers=1), device=dev))
    cl_build_launches = read_launches()
    cluster = ShardedDeepMappingStore(built.partitioner, built.shards, cl_config, built.pool)
    del built
    # The default build (ClusterConfig(): the shards train, and evaluate
    # their T_aux through K2, on the build pool's threads at once) over a
    # prefix of the table, every key looked up.
    thr_table = Table(keys=train_table.keys[:CL_THREADED_ROWS],
                      columns={c: col[:CL_THREADED_ROWS] for c, col in train_table.columns.items()})
    thr_cfg = dataclasses.replace(
        cl_cfg, train=dataclasses.replace(cl_cfg.train, epochs=CL_THREADED_EPOCHS))
    before = read_launches()
    t0 = time.perf_counter()
    threaded = repro_torch.build(thr_table, thr_cfg, cluster=cl_config, device=dev)
    torch.cuda.synchronize()
    thr_build_s = time.perf_counter() - t0
    thr_launches = {k: v - before[k] for k, v in read_launches().items()}
    check(threaded.num_shards == 4 and cl_config.max_workers != 1
          and thr_launches["fused_mlp"] >= threaded.num_shards,
          "cluster: the default build did not evaluate each shard's T_aux through K2")
    thr_probe = np.concatenate([thr_table.keys, absent])
    thr_v, thr_e = threaded.lookup(thr_probe)
    check(bool(thr_e[:CL_THREADED_ROWS].all()) and not thr_e[CL_THREADED_ROWS:].any(),
          "cluster: the default build: a present key reads absent, or an absent one present")
    for c, col in thr_table.columns.items():
        check(np.array_equal(thr_v[c][:CL_THREADED_ROWS], col),
              f"cluster: the default build: column {c} is not lossless")
    del thr_v, thr_e
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
    # The retrain's epochs capped again, at CL_RETRAIN_EPOCHS (cut for time).
    cluster.shards[last].config = dataclasses.replace(
        cl_cfg, train=dataclasses.replace(cl_cfg.train, epochs=CL_RETRAIN_EPOCHS))
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

    # After the counts: each shard of the default build has its T_aux
    # rows found again through its engine (K2 on host digits), on one
    # thread and then on four at once; both equal the build's.
    thr_owner = threaded.partitioner.shard_of(thr_table.keys)

    def shard_mask(i):
        s = threaded.shards[i]
        codes = np.stack([s.codecs[t].codes for t in s.spec.tasks], axis=1)
        return real_eval(s.engine, thr_table.keys[thr_owner == i], codes)

    t0 = time.perf_counter()
    serial_masks = [shard_mask(i) for i in range(threaded.num_shards)]
    serial_mask_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=threaded.num_shards) as ex:
        threaded_masks = list(ex.map(shard_mask, range(threaded.num_shards)))
    threaded_mask_s = time.perf_counter() - t0
    for i, (a, b) in enumerate(zip(serial_masks, threaded_masks)):
        check(a.tobytes() == b.tobytes(), f"cluster: shard {i}'s T_aux rows differ when K2 "
              f"runs on four threads at once")
        check(int(a.sum()) == threaded.shards[i].aux.num_rows,
              f"cluster: shard {i}'s T_aux rows found again are not its build's")
    thr_rec = {"rows": CL_THREADED_ROWS, "epochs_cap": CL_THREADED_EPOCHS,
               "max_workers": cl_config.max_workers, "build_s": thr_build_s,
               "launches": thr_launches,
               "shards": [{"rows": s.num_rows, "aux_rows": s.aux.num_rows,
                           "memorized_fraction": s.memorized_fraction()}
                          for s in threaded.shards],
               "t_aux_found_again_s": {"one_thread": serial_mask_s,
                                       "four_threads": threaded_mask_s}}
    threaded.close()
    del serial_masks, threaded_masks, threaded
    emit("cluster", rows=n_tr, config={"num_shards": cl_config.num_shards,
                                       "policy": cl_config.policy,
                                       "max_workers": cl_config.max_workers,
                                       "build_workers": 1,
                                       "retrain_after_modified_bytes": 1,
                                       "epochs_cap": CL_EPOCHS,
                                       "retrain_epochs_cap": CL_RETRAIN_EPOCHS,
                                       "epochs_uncapped": train_cfg.train.epochs},
         boundaries=cluster.partitioner.boundaries.tolist(), build_s=cl_build_s,
         default_build=thr_rec,
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

    # --------------------------------------------------------- 14. serve
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

    # The baseline pool (phase 17's stores) starts here, beside the
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

    # ---------------------------------------------------- 15. correlated
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

    # ------------------------------------------------------ 16. multikey
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

    # ----------------------------------------------------- 17. baselines
    # Every AB/HB factory on customer_demographics and on SF1 orders,
    # built, checked, saved, bit-flipped and reopened by the pool started
    # before phase 15; the hash stores' reopened lookups are timed in
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

    # --------------------------------------------------------- 18. times
    n = 65536
    kp = rng.choice(table.keys, n).astype(np.int32)
    kt = torch.from_numpy(kp).to(dev)
    digits, _ = digits_of(kt)
    # K1: a key in, the codes and the existence bit out, and the words
    # and position table; K2 (codes): the digits in, the codes out.
    bound_k1 = mlp_bound(spec, n, 4, 4 * m + 4,
                         int(words.numel()) * 4 + int(pos_ops.numel()) * 4)
    bound_k2 = mlp_bound(spec, n, 4 * spec.width, 4 * m)
    kernels = []
    for name, fn, plain, bound, src_line in (
        ("fused_lookup",
         lambda: fm.fused_lookup_call(kt, pos_ops, words, flat, spec, 256, base_pad, cap),
         lambda: ref.fused_lookup(kt, pos_ops, words, flat, spec, cap),
         bound_k1, "src/repro/kernels/fused_mlp.py:322"),
        ("fused_mlp",
         lambda: fm.fused_mlp_call(digits, flat, spec, 256, base_pad, ops.card_pads(spec), True),
         lambda: ref.fused_mlp(digits, flat, spec, True),
         bound_k2, "src/repro/kernels/fused_mlp.py:162"),
    ):
        plain_a = time_ms(plain)
        ms = time_ms(fn)
        ms_b = time_ms(fn)
        plain_b = time_ms(plain)
        kernels.append({
            "name": name, "route": "cuda", "source": "src/repro_torch/csrc/fused_mlp.cu",
            "replaces": src_line, "launches": sum(c[name] for c in paths.values()),
            "launches_by_path": {path: c[name] for path, c in paths.items()},
            **({"launches_with_preds_by_path": {path: c["fused_lookup_with_preds"]
                                                for path, c in paths.items()}}
               if name == "fused_lookup" else {}),
            "max_abs_err": kern_err[name], "ms": min(ms, ms_b),
            "plain_ms": min(plain_a, plain_b), "bound_ms": bound["bound_ms"],
            "bound_by": bound["bound_by"], "library_ms": None,
            "ms_runs": [ms, ms_b], "plain_ms_runs": [plain_a, plain_b],
            "flops": bound["flops"], "bytes": bound["bytes"],
        })
    # K3 (k3_times): both entries at one 65,536-key chunk and at its
    # path's largest call, and the launch floor.  The summary's ms,
    # plain_ms and bound_ms are the reference's contract (int32 -> int32)
    # at the chunk, its *_sf1 fields at the largest call; *_bool_sf1 are
    # the public call's instantiation (int64 -> bool) there.
    k3t = k3_times(bvk, ref, words, k3_sf1, dev)
    k3_row = {(r["entry"], r["keys"]): r for r in k3t["shapes"]}
    chunk = k3_row[("int32_to_int32", n)]
    sf1 = k3_row[("int32_to_int32", -(-k3_sf1.size // 1024) * 1024)]
    sf1_bool = k3_row[("int64_to_bool", sf1["keys"])]
    kernels.append({
        "name": "bitvector", "route": "cuda", "source": "src/repro_torch/csrc/bitvector.cu",
        "replaces": "src/repro/kernels/bitvector.py:47",
        "launches": sum(c["bitvector"] for c in paths.values()),
        "max_abs_err": k3_err, "ms": chunk["single_ms"], "plain_ms": chunk["plain_ms"],
        "bound_ms": chunk["bound_ms"], "bound_by": "bytes", "library_ms": None,
        "launches_by_path": {path: c["bitvector"] for path, c in paths.items()},
        "ms_sf1": sf1["single_ms"], "plain_ms_sf1": sf1["plain_ms"],
        "bound_ms_sf1": sf1["bound_ms"], "keys_sf1": sf1["keys"], "run_ms_sf1": sf1["run_ms"],
        "flushed_ms_sf1": sf1["flushed_ms"], "ms_bool_sf1": sf1_bool["single_ms"],
        "bound_ms_bool_sf1": sf1_bool["bound_ms"],
        "launch_floor_ms": k3t["launch_floor"]["single_ms"], "timings": k3t,
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
    emit("times", nvidia_smi=smi, keys_per_launch=n, flops_per_key=flops_per_key(spec),
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
                and k not in ("flops", "bytes", "timings")} for kern in kernels]
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
