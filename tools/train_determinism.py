#!/usr/bin/env python3
"""Whether training the SF1 store on the card repeats itself from run to run.

    python3 tools/train_determinism.py [--runs 2] [--deterministic]

Trains the model that ``chip_smoke.py``'s ``train`` phase trains (TPC-H
``orders`` at ``chip_smoke.ROWS`` rows, the layers and the ``TrainConfig``
of the port's ``PAPER_STORE``, seed 0) ``--runs`` times in one process
through ``repro_torch.core.trainer.train``, each from the same initial
weights and the same batch order.  Prints one JSON line per run (epochs,
last loss, the epoch losses' digest, seconds) and a summary: whether the
runs' epoch losses are equal bit for bit, and the first epoch where they
part.  Before them, ``step_check`` computes one step's gradients
STEP_REPS times on the same batch and lists the leaves whose gradients
differ (``--runs 0`` runs that alone).

``--deterministic`` sets ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` before
torch loads and calls ``torch.use_deterministic_algorithms(True)``; an
op that has no deterministic CUDA version then raises, and the summary
names it.  Runs on the card only (TF32 off, as in the smoke); it
changes nothing in the package.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SEED = 0
STEP_REPS = 5


def leaf_names(tree, prefix=""):
    """The names of ``model._leaves(tree)``, in its order (dict keys
    sorted): ``shared[0].w``, ``heads.<task>.out.b`` and so on."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaf_names(tree[k], f"{prefix}.{k}" if prefix else k)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaf_names(v, f"{prefix}[{i}]")
    else:
        yield prefix


def step_check(spec, digits, codes, cfg, reps: int) -> dict:
    """One training step's loss and gradients, computed ``reps`` times on
    the same weights and the first batch of ``train``'s first epoch:
    which leaves' gradients differ from the first repetition, and by how
    much.  The leaves name the op: the first layer's weight is the
    ``F.embedding`` gather's backward, a dense layer's weight the
    matmul's, a bias a sum over the batch."""
    import numpy as np
    import torch

    from repro_torch.core import model as model_lib
    from repro_torch.core import trainer as trainer_lib

    params = model_lib.init_params(spec, seed=cfg.seed, device="cuda")
    idx = np.random.default_rng(cfg.seed).permutation(digits.shape[0])[: cfg.batch_size]
    d = torch.from_numpy(np.ascontiguousarray(digits[idx], dtype=np.int32)).cuda()
    c = torch.from_numpy(np.ascontiguousarray(codes[idx], dtype=np.int32)).cuda()
    names = list(leaf_names(params))
    runs = []
    for _ in range(reps):
        leaves = [t.detach().requires_grad_(True) for t in model_lib._leaves(params)]
        loss = trainer_lib.multitask_loss(model_lib._with_leaves(params, leaves), d, c, spec)
        runs.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    torch.cuda.synchronize()
    differ = {}
    for loss, grads in runs[1:]:
        for name, g, g0 in zip(names, grads, runs[0][1]):
            if not torch.equal(g, g0):
                differ[name] = max(differ.get(name, 0.0), (g - g0).abs().max().item())
    return {"reps": reps, "batch": int(idx.size),
            "losses_equal": all(torch.equal(r[0], runs[0][0]) for r in runs),
            "leaves": len(names), "leaves_differ": differ}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--deterministic", action="store_true")
    args = ap.parse_args()
    if args.deterministic:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("train_determinism: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as smoke
    from repro_torch.configs.deepmapping_paper import PAPER_STORE
    from repro_torch.core import KeyEncoder, MLPSpec
    from repro_torch.core import trainer as trainer_lib
    from repro_torch.core.encoding import build_codecs
    from repro_torch.data.tpch import orders_like

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if args.deterministic:
        torch.use_deterministic_algorithms(True)
    table = orders_like(smoke.ROWS, seed=SEED)
    encoder = KeyEncoder(table.max_key, base=10)
    codecs = build_codecs(table.columns)
    spec = MLPSpec(base=10, width=encoder.width, shared=PAPER_STORE.shared,
                   private={c: PAPER_STORE.private for c in table.columns},
                   out_cards={c: codecs[c].cardinality for c in table.columns})
    digits = encoder.digits(table.keys)
    codes = np.stack([codecs[t].codes for t in spec.tasks], axis=1)
    cfg = dataclasses.replace(PAPER_STORE.train, seed=SEED)
    histories, error = [], None
    try:
        step = step_check(spec, digits, codes, cfg, STEP_REPS)
    except RuntimeError as exc:  # an op without a deterministic CUDA version
        step, error = None, str(exc)
    print(json.dumps({"step_check": step}), flush=True)
    for run in range(args.runs if error is None else 0):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            _, _, hist = trainer_lib.train(spec, digits, codes, cfg, device="cuda")
        except RuntimeError as exc:  # an op without a deterministic CUDA version
            error = str(exc)
            break
        torch.cuda.synchronize()
        histories.append(hist)
        print(json.dumps({
            "run": run, "deterministic": args.deterministic, "epochs": len(hist),
            "last_loss": hist[-1], "first_loss": hist[0],
            "losses_sha256": hashlib.sha256(np.asarray(hist, np.float64).tobytes()).hexdigest(),
            "seconds": time.perf_counter() - t0,
        }), flush=True)
    parted = None
    if len(histories) > 1:
        a, b = histories[0], histories[1]
        parted = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                      None if len(a) == len(b) else min(len(a), len(b)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    print(json.dumps({
        "summary": True, "deterministic": args.deterministic,
        "cublas_workspace_config": os.environ.get("CUBLAS_WORKSPACE_CONFIG"),
        "torch": torch.__version__, "cuda": torch.version.cuda, "nvidia_smi": smi.strip(),
        "runs": len(histories), "equal": parted is None and len(histories) > 1,
        "first_epoch_apart": parted, "error": error,
    }), flush=True)
    return 1 if error else 0


if __name__ == "__main__":
    sys.exit(main())
