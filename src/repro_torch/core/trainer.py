"""Trainer for the memorization MLP (paper §IV-C2, §V-A6) — the port of
``repro.core.trainer``.

Standard cross-entropy over every task head, Adam at lr 1e-3 decayed by
0.999 per iteration, early stop when |Δloss| < 1e-4.  Gradients come from
``torch.autograd`` through :func:`~repro_torch.core.model.forward_digits`
(the gather path), as the reference takes ``jax.value_and_grad`` of the
same forward: the reference's trainer runs no Pallas kernel, so the port
runs plain PyTorch ops here.  Matmuls run in full fp32: TF32 stays off,
as it is by default in PyTorch.

:func:`evaluate_misclassified_engine` is the build-time pass that finds
the rows T_aux must hold, through the engine that serves lookups.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import model as model_lib
from repro_torch.core.model import MLPSpec, _leaves, _map_tree, _with_leaves
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.train.optimizer import OptState, adam_init, adam_update, exponential_decay


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 16384          # paper §V-A6
    epochs: int = 50
    lr: float = 1e-3                 # paper §V-A6
    lr_decay: float = 0.999          # per iteration
    early_stop_tol: float = 1e-4     # |Δloss| threshold (paper §V-A6)
    seed: int = 0
    log_every: int = 0               # 0 = silent


def multitask_loss(
    params: Dict, digits: torch.Tensor, codes: torch.Tensor, spec: MLPSpec
) -> torch.Tensor:
    """Sum of per-task softmax cross-entropies (paper: 'standard cross
    entropy'); codes columns follow ``spec.tasks`` order."""
    logits = model_lib.forward_digits(params, digits, spec)
    loss = 0.0
    for i, t in enumerate(spec.tasks):
        lg = logits[t]
        lse = torch.logsumexp(lg, dim=-1)
        picked = torch.gather(lg, 1, codes[:, i : i + 1].long())[:, 0]
        loss = loss + torch.mean(lse - picked)
    return loss


def _train_step(
    params: Dict,
    opt: OptState,
    digits: torch.Tensor,
    codes: torch.Tensor,
    spec: MLPSpec,
    lr_base: float,
    lr_decay: float,
) -> Tuple[Dict, OptState, torch.Tensor]:
    leaves = [t.detach().requires_grad_(True) for t in _leaves(params)]
    loss = multitask_loss(_with_leaves(params, leaves), digits, codes, spec)
    grads = torch.autograd.grad(loss, leaves)
    lr = exponential_decay(lr_base, lr_decay)(opt.step)
    with torch.no_grad():
        params, opt = adam_update(_with_leaves(params, grads), opt, params, lr=lr)
    return params, opt, loss.detach()


def train(
    spec: MLPSpec,
    digits: np.ndarray,
    codes: np.ndarray,
    cfg: TrainConfig = TrainConfig(),
    params: Optional[Dict] = None,
    opt: Optional[OptState] = None,
    device: DeviceLike = None,
) -> Tuple[Dict, OptState, list]:
    """Train (or continue training) a mapping model on ``device``.

    Returns ``(params, opt_state, loss_history)``, params as tensors on
    the device.  ``digits`` is (n, width) int32 from
    :class:`~repro_torch.core.encoding.KeyEncoder`; ``codes`` is (n, m)
    int32 with columns ordered by ``spec.tasks``.  ``params`` may be a
    tree of tensors or numpy arrays; fresh ones come from
    :func:`~repro_torch.core.model.init_params` with ``cfg.seed``.

    Batches follow the reference: one ``np.random.default_rng(cfg.seed)``
    permutation per epoch, the last batch padded by wrapping round to the
    permutation's start, the epoch loss the mean of its step losses.
    """
    dev = resolve_device(device)
    n = digits.shape[0]
    if params is None:
        params = model_lib.init_params(spec, seed=cfg.seed, device=dev)
    else:
        params = _map_tree(params, lambda a: torch.as_tensor(a).to(dev))
    if opt is None:
        opt = adam_init(params)
    digits_d = torch.from_numpy(np.ascontiguousarray(digits, dtype=np.int32)).to(dev)
    codes_d = torch.from_numpy(np.ascontiguousarray(codes, dtype=np.int32)).to(dev)
    rng = np.random.default_rng(cfg.seed)
    bs = min(cfg.batch_size, n)
    history: list = []
    prev_epoch_loss = None
    for epoch in range(cfg.epochs):
        order = rng.permutation(n)
        order_d = torch.from_numpy(order).to(dev)
        losses = []
        for start in range(0, n, bs):
            idx = order_d[start : start + bs]
            if idx.shape[0] < bs:  # wrap round, as the reference pads its last batch
                idx = torch.cat([idx, order_d[: bs - idx.shape[0]]])
            params, opt, loss = _train_step(
                params, opt, digits_d[idx], codes_d[idx], spec, cfg.lr, cfg.lr_decay,
            )
            losses.append(loss)
        # One copy back per epoch; summed as Python floats in step
        # order, as the reference sums ``float(loss)``.
        epoch_loss = sum(torch.stack(losses).tolist()) / max(1, len(losses))
        history.append(epoch_loss)
        if cfg.log_every and (epoch % cfg.log_every == 0):
            print(f"[trainer] epoch {epoch} loss {epoch_loss:.6f}")
        if prev_epoch_loss is not None and abs(prev_epoch_loss - epoch_loss) < cfg.early_stop_tol:
            break
        prev_epoch_loss = epoch_loss
    return params, opt, history


def evaluate_misclassified_engine(
    engine,
    keys: np.ndarray,
    codes: np.ndarray,
    batch: int = 1 << 16,
) -> np.ndarray:
    """Row mask of tuples the model gets wrong in ANY column (§IV-B1);
    these rows become T_aux.  Drives the deployed
    :class:`~repro_torch.core.inference.InferenceEngine` from raw keys
    as a two-stage pipeline: the device infers chunk *i+1* while the host
    compares chunk *i*.  Because the engine is the SAME object the store
    serves lookups with, T_aux corrects exactly the deployed inference
    path — including its weight padding and argmax tie-breaking."""
    keys = np.asarray(keys, dtype=np.int64)
    n = keys.shape[0]
    wrong = np.zeros(n, dtype=bool)
    pending: list = []
    for start in range(0, n, batch):
        pending.append((start, engine.dispatch(keys[start : start + batch])))
        if len(pending) >= 2:  # two-stage pipeline: host trails by one
            s, t = pending.pop(0)
            pred, _ = engine.collect(t)
            wrong[s : s + t.n] = (pred != codes[s : s + t.n]).any(axis=1)
    for s, t in pending:
        pred, _ = engine.collect(t)
        wrong[s : s + t.n] = (pred != codes[s : s + t.n]).any(axis=1)
    return wrong
