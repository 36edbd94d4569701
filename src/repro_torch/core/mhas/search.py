"""MHAS Algorithm 2: alternating shared-weight training and controller
REINFORCE updates, minimizing the paper's Eq. 1 over the hybrid — the
port of ``repro.core.mhas.search``.

The reward for a sampled child is the (estimated) hybrid compression
ratio: sliced-model bytes + estimated T_aux bytes (from the child's
row-level error rate on a held-out sample, scaled by a calibrated
compression factor) + V_exist + f_decode, over raw data bytes.
``run_mhas`` returns the best child re-sliced from the bank and
fine-tuned — the paper's "model search process is followed by training
to finetune the accuracy".

The control flow is the reference's, step for step: one numpy
``default_rng(cfg.seed)`` draws every batch and reward sample in the
reference's call order, so equal draws give equal batch indices; the
architectures come from a ``torch.Generator`` seeded ``cfg.seed + 1``
(the reference's ``PRNGKey(cfg.seed + 1)``).  The reference trains the
bank in plain JAX; the port trains it in plain PyTorch (autograd through
the masked forward, then :func:`~repro_torch.train.optimizer.adam_update`),
with the keys' digits and codes uploaded once and each batch's padded
one-hot built on the device.  The host waits on the device once per
model iteration (its last loss) and once per scored sample (its error
rate), as the reference does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import trainer as trainer_lib
from repro_torch.core.aux_table import AuxTable
from repro_torch.core.bitvector import BitVector
from repro_torch.core.encoding import KeyEncoder, build_codecs, onehot_digits
from repro_torch.core.mhas import controller as ctrl_lib
from repro_torch.core.mhas.search_space import SearchSpace
from repro_torch.core.model import MLPSpec, _leaves, _with_leaves
from repro_torch.core.table import Table
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.train.optimizer import OptState, adam_init, adam_update


@dataclasses.dataclass(frozen=True)
class MHASConfig:
    """Paper §V-A6 hyper-parameters (defaults scaled for CPU runs; the
    paper-scale values are in comments)."""

    layer_sizes: Tuple[int, ...] = (100, 200, 400, 800, 1200, 1600, 2000)
    max_layers: int = 2
    total_iters: int = 200            # N_t (paper: 2000)
    model_iters: int = 200            # N_m (paper: 2000)
    controller_iters: int = 4         # N_c (paper: 40 — 1 epoch / 50 iters)
    model_epochs_per_iter: int = 5    # paper: 5
    model_batch: int = 16384          # paper: 16384
    controller_batch: int = 2048      # paper: 2048 (reward eval batch)
    controller_samples: int = 8       # archs per controller update
    lr_model: float = 1e-3            # paper: 1e-3 (decay handled by Adam)
    lr_controller: float = 3.5e-4     # paper: 0.00035
    entropy_coef: float = 1e-3
    baseline_decay: float = 0.95
    early_stop_tol: float = 1e-4      # paper: |Δloss| < 0.0001
    finetune_epochs: int = 30
    seed: int = 0
    base: int = 10
    verbose: bool = False


@dataclasses.dataclass
class MHASResult:
    spec: MLPSpec
    params: Dict                     # tensors on the search's device
    best_arch: Dict
    best_ratio: float
    history: List[Dict]              # per-sample: iter, ratio, err, child_params
    space: SearchSpace


# --------------------------------------------------------------------------
# child train / eval on the shared bank
# --------------------------------------------------------------------------


def _child_loss(bank, onehot_pad, codes, aa, space: SearchSpace):
    """Sum over tasks of the mean softmax cross-entropy of the masked
    child forward."""
    logits = space.forward(bank, onehot_pad, aa)
    loss = 0.0
    for i, t in enumerate(space.tasks):
        lg = logits[t]
        lse = torch.logsumexp(lg, dim=-1)
        picked = torch.gather(lg, 1, codes[:, i : i + 1].long())[:, 0]
        loss = loss + torch.mean(lse - picked)
    return loss


def _bank_step(bank, opt: OptState, onehot_pad, codes, aa, space: SearchSpace, lr: float):
    """One Adam step of the bank on the child's loss.  Returns the new
    bank and moments and the loss (a 0-d tensor; nothing waits for the
    device).  The caller rebinds its bank and moments, so the step keeps
    no reference to the old ones."""
    leaves = [t.detach().requires_grad_(True) for t in _leaves(bank)]
    loss = _child_loss(_with_leaves(bank, leaves), onehot_pad, codes, aa, space)
    grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        bank, opt = adam_update(_with_leaves(bank, grads), opt, bank, lr=lr)
    return bank, opt, loss.detach()


@torch.no_grad()
def _child_errors(bank, onehot_pad, codes, aa, space: SearchSpace) -> torch.Tensor:
    """The share of rows the masked child gets wrong in any task (a 0-d
    fp32 tensor); argmax ties go to the lowest index."""
    logits = space.forward(bank, onehot_pad, aa)
    wrong = torch.zeros(onehot_pad.shape[0], dtype=torch.bool, device=onehot_pad.device)
    for i, t in enumerate(space.tasks):
        pred = torch.argmax(logits[t], dim=-1).to(torch.int32)
        wrong = wrong | (pred != codes[:, i])
    return wrong.to(torch.float32).mean()


def _controller_update(cparams: Dict, copt: OptState, cspec: ctrl_lib.ControllerSpec,
                       tokens_batch: torch.Tensor, advantages: torch.Tensor,
                       lr: float, entropy_coef: float):
    """REINFORCE: the mean over the batch of ``-adv * logp - entropy_coef
    * entropy``, then one Adam step at ``lr`` (the reference's jitted
    ``ctrl_update`` closure).  Returns the new params and moments and the
    loss."""
    leaves = [t.detach().requires_grad_(True) for t in _leaves(cparams)]
    cp = _with_leaves(cparams, leaves)
    total = 0.0
    for tokens, adv in zip(tokens_batch, advantages):
        logp, ent = ctrl_lib.logprob_of(cp, cspec, tokens)
        total = total - adv * logp - entropy_coef * ent
    loss = total / len(tokens_batch)
    grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        cparams, copt = adam_update(_with_leaves(cparams, grads), copt, cparams, lr=lr)
    return cparams, copt, loss.detach()


# --------------------------------------------------------------------------
# the search driver
# --------------------------------------------------------------------------


def _to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """``a`` on ``dev`` without making the host wait for the device: on a
    GPU through a pinned staging copy, which the caching host allocator
    keeps until the copy has run."""
    t = torch.from_numpy(a)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


class _RewardModel:
    """Eq. 1 estimate for a sampled child architecture."""

    def __init__(self, space: SearchSpace, table: Table, codes: np.ndarray, cfg: MHASConfig):
        self.space = space
        self.raw_bytes = table.raw_size_bytes()
        self.n = table.num_rows
        self.row_bytes = 8 + 4 * len(space.tasks)
        # Constant terms: V_exist (compressed) + f_decode.
        self.const_bytes = BitVector.from_keys(table.keys).size_bytes()
        codecs = build_codecs(table.columns)
        self.const_bytes += sum(c.size_bytes() for c in codecs.values())
        # Calibrate the aux compression factor on a random row sample.
        rng = np.random.default_rng(cfg.seed)
        m = min(4096, self.n)
        idx = rng.choice(self.n, size=m, replace=False)
        aux = AuxTable.build(table.keys[idx], codes[idx], codec="zstd")
        self.aux_factor = aux.size_bytes() / max(1, m * self.row_bytes)

    def ratio(self, arch: Dict, err_rate: float) -> float:
        model_bytes = self.space.child_num_params(arch) * 4
        aux_bytes = err_rate * self.n * self.row_bytes * self.aux_factor
        return (model_bytes + aux_bytes + self.const_bytes) / max(1, self.raw_bytes)


def run_mhas(
    table: Table,
    cfg: MHASConfig = MHASConfig(),
    pool=None,
    device: DeviceLike = None,
) -> MHASResult:
    """Search a hybrid architecture for ``table`` (Algorithm 2) on
    ``device`` (CUDA by default).  ``pool`` is accepted for the
    reference's signature and unused, as there."""
    dev = resolve_device(device)
    encoder = KeyEncoder(table.max_key, base=cfg.base)
    codecs = build_codecs(table.columns)
    tasks = tuple(sorted(table.columns))
    space = SearchSpace(
        base=cfg.base,
        width=encoder.width,
        tasks=tasks,
        out_cards=tuple(codecs[t].cardinality for t in tasks),
        layer_sizes=cfg.layer_sizes,
        max_layers=cfg.max_layers,
    )
    digits = encoder.digits(table.keys)
    codes = np.stack([codecs[t].codes for t in tasks], axis=1)
    n = table.num_rows
    digits_d = torch.from_numpy(np.ascontiguousarray(digits, dtype=np.int32)).to(dev)
    codes_d = torch.from_numpy(np.ascontiguousarray(codes, dtype=np.int32)).to(dev)
    pad = space.max_width - space.feature_dim

    def batch(idx: np.ndarray):
        """The rows ``idx``: padded one-hot (n, max_width) and codes, made
        on the device from the resident digits and codes."""
        idx_d = _to_device(idx, dev)
        oh = onehot_digits(digits_d[idx_d], space.base)
        return F.pad(oh, (0, pad)), codes_d[idx_d]

    bank = space.init_bank(seed=cfg.seed, device=dev)
    bank_opt = adam_init(bank)
    cspec = ctrl_lib.ControllerSpec.for_space(space)
    cparams = ctrl_lib.init_controller(cspec, seed=cfg.seed, device=dev)
    copt = adam_init(cparams)
    reward_model = _RewardModel(space, table, codes, cfg)

    rng = np.random.default_rng(cfg.seed)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed + 1)
    baseline = None
    best = {"ratio": float("inf"), "arch": None}
    history: List[Dict] = []
    bs = min(cfg.model_batch, n)
    rbs = min(cfg.controller_batch, n)

    model_every = max(1, cfg.total_iters // max(1, cfg.model_iters))
    ctrl_every = max(1, cfg.total_iters // max(1, cfg.controller_iters))
    prev_loss = None

    def sample_and_score():
        tokens, _, _ = ctrl_lib.sample_arch(cparams, cspec, gen)
        arch = space.tokens_to_arch(tokens)
        aa = space.arch_arrays(arch, device=dev)
        idx = rng.choice(n, size=rbs, replace=False)
        err = float(_child_errors(bank, *batch(idx), aa, space))
        ratio = reward_model.ratio(arch, err)
        return tokens, arch, aa, err, ratio

    for it in range(1, cfg.total_iters + 1):
        # ---- model training iteration (controller fixed) — Alg. 2 l.5-13
        if it % model_every == 0:
            tokens, arch, aa, err, ratio = sample_and_score()
            for _ in range(cfg.model_epochs_per_iter):
                idx = rng.choice(n, size=bs, replace=False)
                bank, bank_opt, loss = _bank_step(
                    bank, bank_opt, *batch(idx), aa, space, cfg.lr_model,
                )
            history.append(
                {"iter": it, "ratio": ratio, "err": err,
                 "child_params": space.child_num_params(arch)}
            )
            if ratio < best["ratio"]:
                best = {"ratio": ratio, "arch": arch}
            lf = float(loss)
            if cfg.verbose and it % 10 == 0:
                print(f"[mhas] it={it} loss={lf:.4f} err={err:.3f} ratio={ratio:.4f}")
            if prev_loss is not None and abs(prev_loss - lf) < cfg.early_stop_tol:
                if cfg.verbose:
                    print(f"[mhas] early stop at iter {it}")
                break
            prev_loss = lf

        # ---- controller training iteration (weights fixed) — Alg. 2 l.14-20
        if it % ctrl_every == 0:
            tokens_batch, advantages = [], []
            for _ in range(cfg.controller_samples):
                tokens, arch, aa, err, ratio = sample_and_score()
                reward = -ratio
                baseline = (
                    reward
                    if baseline is None
                    else cfg.baseline_decay * baseline + (1 - cfg.baseline_decay) * reward
                )
                tokens_batch.append(tokens)
                advantages.append(reward - baseline)
                history.append(
                    {"iter": it, "ratio": ratio, "err": err,
                     "child_params": space.child_num_params(arch)}
                )
                if ratio < best["ratio"]:
                    best = {"ratio": ratio, "arch": arch}
            cparams, copt, _ = _controller_update(
                cparams, copt, cspec, torch.stack(tokens_batch),
                torch.tensor(advantages, dtype=torch.float32, device=dev),
                cfg.lr_controller, cfg.entropy_coef,
            )

    if best["arch"] is None:  # degenerate budget: sample one unconditionally
        tokens, arch, aa, err, ratio = sample_and_score()
        best = {"ratio": ratio, "arch": arch}

    # ---- finalize: slice the bank, fine-tune the child (paper §V-A6)
    spec = space.child_spec(best["arch"])
    params = space.extract_child_params(bank, best["arch"])
    del bank, bank_opt
    params, _, _ = trainer_lib.train(
        spec,
        digits,
        codes,
        trainer_lib.TrainConfig(
            batch_size=cfg.model_batch,
            epochs=cfg.finetune_epochs,
            early_stop_tol=cfg.early_stop_tol,
            seed=cfg.seed,
        ),
        params=params,
        device=dev,
    )
    return MHASResult(
        spec=spec,
        params=params,
        best_arch=best["arch"],
        best_ratio=best["ratio"],
        history=history,
        space=space,
    )
