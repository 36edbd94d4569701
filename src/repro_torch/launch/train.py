"""Training launcher: the port of ``repro.launch.train``.

Wires together the arch registry, the train step, the deterministic
loader (optionally through the DeepMapping-compressed token store), and
the fault-tolerant runner with atomic async checkpoints and the
straggler watchdog, on one device: the card unless ``--device`` names
another.  The reference's jitted, sharded step becomes the plain step;
``--data-mesh``/``--model-mesh`` other than 1 wait for ROADMAP item M12d.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
        --steps 50 --ckpt-dir build/ckpt [--compressed-data] [--smoke --device cpu]

A run resumes from the ``LATEST`` checkpoint under ``--ckpt-dir`` when
there is one, so running again with a larger ``--steps`` continues it.
The default directory is ``build/ckpt/<arch>`` (``<arch>-smoke`` with
``--smoke``) in this checkout, so no two checkouts share one.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import List, Optional, Tuple

import torch

from repro_torch.configs import get_arch
from repro_torch.data.loader import LoaderConfig, TokenBatchLoader
from repro_torch.data.tokens import DeepMappingTokenStore, make_structured_tokens
from repro_torch.device import resolve_device
from repro_torch.train.fault_tolerance import RunReport, StepWatchdog, run_training
from repro_torch.train.optimizer import adamw, warmup_cosine
from repro_torch.train.train_step import init_state, make_train_step

#: The checkout's ignored ``build/`` (as ``kernels/build.py`` finds it).
_BUILD = Path(__file__).resolve().parents[3] / "build"


def main(argv: Optional[List[str]] = None
         ) -> Tuple[RunReport, Optional[DeepMappingTokenStore]]:
    """Run the launcher on ``argv`` (the command line when None); prints
    the reference's two summary lines and returns the ``RunReport`` and
    the token store (None without ``--compressed-data``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: build/ckpt/<arch> in this checkout)")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--compressed-data", action="store_true")
    ap.add_argument("--data-mesh", type=int, default=1)
    ap.add_argument("--model-mesh", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: the CUDA device)")
    args = ap.parse_args(argv)

    if args.data_mesh != 1 or args.model_mesh != 1:
        raise NotImplementedError(
            "--data-mesh/--model-mesh other than 1: sharded training is not ported yet "
            "(ROADMAP item M12d); the port trains on one device")
    spec = get_arch(args.arch)
    cfg = spec.smoke if args.smoke else spec.config
    if cfg.is_encoder_decoder or cfg.modality != "text":
        raise SystemExit("this launcher drives text decoder archs")
    dev = resolve_device(args.device)
    ckpt_dir = args.ckpt_dir or str(
        _BUILD / "ckpt" / (args.arch + ("-smoke" if args.smoke else "")))

    toks = make_structured_tokens(200_000, vocab=cfg.vocab_size, run_len=8, seed=0)
    loader_cfg = LoaderConfig(global_batch=args.batch, seq_len=args.seq, seed=0)
    store = None
    if args.compressed_data:
        store = DeepMappingTokenStore.build(toks, verbose=True, device=dev)
        loader = TokenBatchLoader(loader_cfg, store=store)
    else:
        loader = TokenBatchLoader(loader_cfg, tokens=toks)

    opt = adamw(lr=warmup_cosine(3e-3, 10, args.steps), max_grad_norm=1.0)
    step_fn = make_train_step(cfg, opt)

    def batch_fn(s):
        return {k: torch.from_numpy(v).to(dev) for k, v in loader.batch_for_step(s).items()}

    wd = StepWatchdog()
    t0 = time.time()
    # The initial state is passed with no name of its own here, so the
    # loop frees it once it steps or restores.
    report = run_training(
        step_fn, init_state(cfg, opt, seed=0, device=dev), batch_fn, num_steps=args.steps,
        ckpt_dir=ckpt_dir, ckpt_every=args.ckpt_every, watchdog=wd,
    )
    print(
        f"arch={args.arch} steps={report.final_step} restarts={report.restarts} "
        f"stragglers={len(report.straggler_events)} wall={time.time()-t0:.1f}s"
    )
    print(f"loss {report.losses[0]:.4f} -> {report.losses[-1]:.4f}")
    return report, store


if __name__ == "__main__":
    main()
