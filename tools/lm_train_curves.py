#!/usr/bin/env python3
"""Loss curves of the training launcher's optimizer on tinyllama-1.1b at full width.

    python3 tools/lm_train_curves.py [--arch tinyllama-1.1b] [--loss-gap]

Trains the model ``repro_torch.launch.train`` trains (the arch's full
config, bf16, seed 0; AdamW with clip 1.0; the launcher's corpus
``make_structured_tokens(200_000, vocab, run_len=8, seed=0)`` and loader,
8 sequences of 64 + 1 tokens a step) through ``make_train_step``, from
the same initial weights each time, in four runs:

* ``launcher_10`` and ``launcher_40``: the launcher's schedule,
  ``warmup_cosine(3e-3, 10, steps)``, on a fresh batch every step (what
  the launcher does), for 10 and 40 steps;
* ``repeated_10``: the same schedule for 10 steps on step 0's batch only;
* ``peak_3e-4_40``: ``warmup_cosine(3e-4, 10, 40)`` on fresh batches.

Each run's loss per step (before the step's update, as the launcher
records it), its step times (host clock to a synchronize) and, after the
last step, the loss on step 0's batch.  Prints one JSON line per run and
writes them all to ``chiprun_out/lm_train_curves.json``.

With ``--loss-gap``, instead: the bf16 loss against the fp32 loss of the
same weights and batch, as ``chip_smoke.py``'s ``lm_train`` phase takes
it at its train-step shape (4 sequences of 2,048 + 1 tokens, seed s for
the weights and the loader, ``warmup_cosine(3e-3, 10, 3)``, three steps),
on each of the three batches, at the initial weights and after the
steps, for seeds 0 to 2; written to ``chiprun_out/lm_loss_gap.json``.

Runs on the card only (TF32 and bf16 reduced-precision reductions off,
as in the smoke); it changes nothing in the package.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
#: (name, peak lr, steps, every step on step 0's batch)
RUNS = (("launcher_10", 3e-3, 10, False), ("launcher_40", 3e-3, 40, False),
        ("repeated_10", 3e-3, 10, True), ("peak_3e-4_40", 3e-4, 40, False))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--loss-gap", action="store_true",
                    help="measure the bf16 - fp32 loss gap at the smoke's train-step shape")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("lm_train_curves: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_arch
    from repro_torch.data.loader import LoaderConfig, TokenBatchLoader
    from repro_torch.data.tokens import make_structured_tokens
    from repro_torch.train.optimizer import adamw, warmup_cosine
    from repro_torch.train.train_step import init_state, make_loss_fn, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda")
    cfg = get_arch(args.arch).config
    if args.loss_gap:
        return loss_gap(args.arch, cfg, dev)
    corpus = make_structured_tokens(200_000, vocab=cfg.vocab_size, run_len=8, seed=0)
    loader = TokenBatchLoader(LoaderConfig(global_batch=8, seq_len=64, seed=0), tokens=corpus)

    def batch(step):
        return {"tokens": torch.from_numpy(loader.batch_for_step(step)["tokens"]).to(dev)}

    out = {"arch": args.arch, "device": torch.cuda.get_device_name(0), "runs": {}}
    for name, peak, steps, repeated in RUNS:
        opt = adamw(lr=warmup_cosine(peak, 10, steps), max_grad_norm=1.0)
        state = init_state(cfg, opt, seed=0, device=dev)
        step_fn = make_train_step(cfg, opt)
        losses, step_s = [], []
        for s in range(steps):
            b = batch(0 if repeated else s)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step_fn(state, b)
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        with torch.no_grad():
            after = float(make_loss_fn(cfg)[0](state.params, batch(0)))
        rec = {"peak_lr": peak, "steps": steps, "repeated_batch": repeated, "losses": losses,
               "step_s": step_s, "step0_batch_loss_after": after}
        out["runs"][name] = rec
        print(json.dumps({"run": name, **rec}), flush=True)
        del state
        torch.cuda.empty_cache()
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "lm_train_curves.json").write_text(json.dumps(out, indent=1))
    return 0


def loss_gap(arch: str, cfg, dev) -> int:
    """The ``--loss-gap`` mode (see the module docstring)."""
    import dataclasses

    import torch

    from repro_torch.core.model import _map_tree
    from repro_torch.data.loader import LoaderConfig, TokenBatchLoader
    from repro_torch.data.tokens import make_structured_tokens
    from repro_torch.train.optimizer import adamw, warmup_cosine
    from repro_torch.train.train_step import init_state, make_loss_fn, make_train_step

    corpus = make_structured_tokens(200_000, vocab=cfg.vocab_size, run_len=8, seed=0)
    loss16_fn = make_loss_fn(cfg)[0]
    loss32_fn = make_loss_fn(dataclasses.replace(cfg, dtype="float32"))[0]

    def losses(params, batches):
        with torch.no_grad():
            p32 = _map_tree(params, lambda t: t.float())
            out = [(float(loss16_fn(params, b)), float(loss32_fn(p32, b))) for b in batches]
        del p32
        return [{"bf16": a, "fp32": b, "bf16_minus_fp32": a - b} for a, b in out]

    out = {"arch": arch, "device": torch.cuda.get_device_name(0), "seeds": {}}
    for seed in range(3):
        loader = TokenBatchLoader(LoaderConfig(global_batch=4, seq_len=2048, seed=seed),
                                  tokens=corpus)
        batches = [{"tokens": torch.from_numpy(loader.batch_for_step(k)["tokens"]).to(dev)}
                   for k in range(3)]
        opt = adamw(lr=warmup_cosine(3e-3, 10, 3), max_grad_norm=1.0)
        state = init_state(cfg, opt, seed=seed, device=dev)
        rec = {"initial": losses(state.params, batches)}
        step_fn = make_train_step(cfg, opt)
        rec["step_losses"] = []
        for b in batches:
            state, metrics = step_fn(state, b)
            rec["step_losses"].append(float(metrics["loss"]))
        rec["trained"] = losses(state.params, batches)
        out["seeds"][seed] = rec
        print(json.dumps({"seed": seed, **rec}), flush=True)
        del state, metrics
        torch.cuda.empty_cache()
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "lm_loss_gap.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
