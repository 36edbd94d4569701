"""Optimizers and LR schedules over params trees of tensors: the port of
``repro.train.optimizer`` (Adam, AdamW with global-norm clipping, and
the exponential, cosine and warmup-cosine schedules) for the
mapping-model trainer (paper §V-A6: Adam, lr 1e-3 decayed by 0.999 per
iteration) and the LM substrate (AdamW + warmup-cosine).

The arithmetic keeps the reference's order, step for step:
``step + 1``; the bias corrections ``1 - b**step`` in fp32; the moments
``b1 * m + (1 - b1) * g`` and ``b2 * v + (1 - b2) * (g * g)``;
``m / bc1`` and ``v / bc2``; ``mhat / (sqrt(vhat) + eps)``;
``p - lr * delta`` cast back to the leaf's dtype.  ``torch.optim.Adam``
computes the same formula in another rounding order
(``sqrt(v) / sqrt(bc2) + eps``), so it is not used.  Updates are
functional, as in JAX: new tensors, nothing changed in place.  The
leaves of a tree are updated together with ``torch._foreach_*`` ops,
which are the per-tensor elementwise ops batched into fewer launches.

Low-precision leaves follow JAX's promotion.  A Python constant is
weakly typed there, so on a bf16 leaf it is rounded to bf16 and every
moment op rounds to bf16 in turn; torch would keep a Python scalar in
fp32 (its op math), so such leaves get their constants as 0-d tensors
of their own dtype.  ``bc1``/``bc2`` are fp32 arrays, not weak, so
``m / bc1`` and everything after it is fp32, cast back to the leaf's
dtype at the end.  On fp32 leaves the constants stay Python scalars.

Schedules take the 0-d int step tensor and return a 0-d fp32 tensor on
its device, so a step makes no host sync.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.model import _leaves, _map_tree, _with_leaves


class OptState(NamedTuple):
    step: torch.Tensor  # 0-d int32, on the params' device
    mu: Dict  # first-moment tree
    nu: Dict  # second-moment tree


def adam_init(params: Dict) -> OptState:
    leaf = next(_leaves(params))
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=leaf.device),
        mu=_map_tree(params, torch.zeros_like),
        nu=_map_tree(params, torch.zeros_like),
    )


def _const(x: float, like: torch.Tensor):
    """The reference's weakly typed Python constant on a leaf like
    ``like``: a Python scalar on fp32 and fp64 leaves, a 0-d tensor of
    the leaf's dtype (so rounded to it) on lower-precision ones."""
    if like.dtype in (torch.float32, torch.float64):
        return x
    return torch.full((), x, dtype=like.dtype, device=like.device)


def _dtype_groups(leaves: List[torch.Tensor]) -> List[List[int]]:
    """Leaf indices grouped by dtype, in first-seen order."""
    groups: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(leaves):
        groups.setdefault(t.dtype, []).append(i)
    return list(groups.values())


def adam_update(
    grads: Dict,
    state: OptState,
    params: Dict,
    lr: torch.Tensor | float,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> Tuple[Dict, OptState]:
    """One AdamW step. Returns ``(new_params, new_state)``.

    ``weight_decay`` is decoupled (AdamW); 0 recovers plain Adam, which
    is what the paper's §V-A6 training uses."""
    step = state.step + 1
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, stepf)
    bc2 = 1.0 - torch.pow(b2, stepf)
    g_all = list(_leaves(grads))
    m_all = list(_leaves(state.mu))
    v_all = list(_leaves(state.nu))
    p_all = list(_leaves(params))
    new_p, new_m, new_v = [None] * len(p_all), [None] * len(p_all), [None] * len(p_all)
    for idx in _dtype_groups(p_all):
        g = [g_all[i] for i in idx]
        p = [p_all[i] for i in idx]
        c = lambda x: _const(x, p[0])  # noqa: E731
        mu = torch._foreach_add(
            torch._foreach_mul([m_all[i] for i in idx], c(b1)),
            torch._foreach_mul(g, c(1.0 - b1)),
        )
        nu = torch._foreach_add(
            torch._foreach_mul([v_all[i] for i in idx], c(b2)),
            torch._foreach_mul(torch._foreach_mul(g, g), c(1.0 - b2)),
        )
        # From here on fp32 (bc1 and bc2 are fp32 arrays in the reference).
        mhat = torch._foreach_div([m.float() for m in mu], bc1)
        vhat = torch._foreach_div([v.float() for v in nu], bc2)
        delta = torch._foreach_div(mhat, torch._foreach_add(torch._foreach_sqrt(vhat), eps))
        if weight_decay:
            decay = torch._foreach_mul(p, c(weight_decay))
            delta = torch._foreach_add(delta, [d.float() for d in decay])
        upd = torch._foreach_sub([t.float() for t in p], torch._foreach_mul(delta, lr))
        for j, i in enumerate(idx):
            new_p[i] = upd[j].to(p_all[i].dtype)
            new_m[i], new_v[i] = mu[j], nu[j]
    return _with_leaves(params, new_p), OptState(
        step=step, mu=_with_leaves(params, new_m), nu=_with_leaves(params, new_v)
    )


def global_norm(tree) -> torch.Tensor:
    """``sqrt(sum of sum(g**2))`` in fp32 over the leaves, summed in the
    reference's order (leaf by leaf, from 0); a 0-d device tensor."""
    total = 0
    for g in _leaves(tree):
        total = total + torch.sum(torch.square(g.float()))
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float):
    """Scale every leaf by ``min(1, max_norm / (norm + 1e-12))`` (in
    fp32, cast back to the leaf's dtype). Returns ``(clipped, norm)``."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return _map_tree(grads, lambda g: (g.float() * scale).to(g.dtype)), norm


@dataclasses.dataclass(frozen=True)
class adamw:  # noqa: N801 — factory with function-like name, as in the reference
    """Bound AdamW rule: ``opt = adamw(lr=...); opt.init / opt.update``."""

    lr: float | Callable[[torch.Tensor], torch.Tensor] = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    max_grad_norm: Optional[float] = None

    def init(self, params) -> OptState:
        return adam_init(params)

    def update(self, grads, state: OptState, params):
        if self.max_grad_norm is not None:
            grads, _ = clip_by_global_norm(grads, self.max_grad_norm)
        lr = self.lr(state.step) if callable(self.lr) else self.lr
        return adam_update(
            grads,
            state,
            params,
            lr=lr,
            b1=self.b1,
            b2=self.b2,
            eps=self.eps,
            weight_decay=self.weight_decay,
        )


# -- schedules ---------------------------------------------------------------


def exponential_decay(base_lr: float, decay: float) -> Callable:
    """Paper §V-A6: model lr 0.001 decayed by 0.999 per iteration."""

    def sched(step: torch.Tensor) -> torch.Tensor:
        return base_lr * torch.pow(decay, step.to(torch.float32))

    return sched


def cosine_schedule(base_lr: float, total_steps: int, final_frac: float = 0.1) -> Callable:
    def sched(step: torch.Tensor) -> torch.Tensor:
        frac = torch.clamp(step.to(torch.float32) / max(1, total_steps), 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
        return base_lr * (final_frac + (1.0 - final_frac) * cos)

    return sched


def warmup_cosine(
    base_lr: float, warmup_steps: int, total_steps: int, final_frac: float = 0.1
) -> Callable:
    cos = cosine_schedule(base_lr, max(1, total_steps - warmup_steps), final_frac)

    def sched(step: torch.Tensor) -> torch.Tensor:
        stepf = step.to(torch.float32)
        warm = base_lr * stepf / max(1, warmup_steps)
        return torch.where(step < warmup_steps, warm, cos(step - warmup_steps))

    return sched
