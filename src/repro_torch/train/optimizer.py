"""Adam and the exponential learning-rate decay, over params trees of
tensors — the port of the part of ``repro.train.optimizer`` that the
mapping-model trainer uses (paper §V-A6: Adam, lr 1e-3 decayed by 0.999
per iteration).

The arithmetic keeps the reference's order, step for step, in fp32:
``step + 1``; the bias corrections ``1 - b**step``; ``m / bc1`` and
``v / bc2``; ``mhat / (sqrt(vhat) + eps)``; ``p - lr * delta``.
``torch.optim.Adam`` computes the same formula in another rounding
order (``sqrt(v) / sqrt(bc2) + eps``), so it is not used.  Updates are
functional, as in JAX: new tensors, nothing changed in place.  The
leaves of a tree are updated together with ``torch._foreach_*`` ops,
which are the per-tensor elementwise ops batched into fewer launches.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple

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


def adam_update(
    grads: Dict,
    state: OptState,
    params: Dict,
    lr: torch.Tensor | float,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
):
    """One Adam step (no weight decay). Returns ``(new_params, new_state)``."""
    step = state.step + 1
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, stepf)
    bc2 = 1.0 - torch.pow(b2, stepf)
    g = list(_leaves(grads))
    mu = torch._foreach_add(
        torch._foreach_mul(list(_leaves(state.mu)), b1), torch._foreach_mul(g, 1.0 - b1)
    )
    nu = torch._foreach_add(
        torch._foreach_mul(list(_leaves(state.nu)), b2),
        torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - b2),
    )
    mhat = torch._foreach_div(mu, bc1)
    vhat = torch._foreach_div(nu, bc2)
    delta = torch._foreach_div(mhat, torch._foreach_add(torch._foreach_sqrt(vhat), eps))
    new_p = torch._foreach_sub(list(_leaves(params)), torch._foreach_mul(delta, lr))
    return _with_leaves(params, new_p), OptState(
        step=step, mu=_with_leaves(params, mu), nu=_with_leaves(params, nu)
    )


def exponential_decay(base_lr: float, decay: float) -> Callable:
    """Paper §V-A6: model lr 0.001 decayed by 0.999 per iteration.
    ``sched(step)`` takes the 0-d int step and returns a 0-d fp32 lr."""

    def sched(step: torch.Tensor) -> torch.Tensor:
        return base_lr * torch.pow(decay, step.to(torch.float32))

    return sched
