"""Shared neural building blocks (PyTorch, params as trees of tensors).

The port of ``repro.models.layers``.  Init functions take a
``torch.Generator`` and draw on its device; their numbers differ from
the reference's ``jax.random`` draws, while shapes, scales, dtypes and
tree layout are the reference's, so ``repro_torch.core.convert`` carries
a tree between the two packages.  ``stacked_init`` stacks per-layer
trees along a leading dimension, the layout the reference's ``vmap``
gives for ``lax.scan``; the port's decoder walks it in a Python loop.
"""

from __future__ import annotations

from typing import Callable, Dict, Union

import torch
import torch.nn.functional as F

DTypeLike = Union[str, torch.dtype]


def _dtype(name: DTypeLike) -> torch.dtype:
    """``"bfloat16"``/``"float32"`` (a config's dtype) or a torch dtype."""
    return name if isinstance(name, torch.dtype) else getattr(torch, name)


def stack_trees(trees):
    """Trees of one layout -> one tree, each leaf stacked on a new dim 0
    (``None`` leaves stay ``None``)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_trees([t[k] for t in trees]) for k in first}
    if isinstance(first, list):
        return [stack_trees([t[i] for t in trees]) for i in range(len(first))]
    if first is None:
        return None
    return torch.stack(trees)


# -- initializers -------------------------------------------------------------


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype: DTypeLike,
               bias: bool = False) -> Dict:
    dt = _dtype(dtype)
    w = torch.randn((in_dim, out_dim), generator=gen, dtype=torch.float32, device=gen.device)
    p = {"w": (w * (1.0 / in_dim) ** 0.5).to(dt)}
    if bias:
        p["b"] = torch.zeros((out_dim,), dtype=dt, device=gen.device)
    return p


def dense(p: Dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def embedding_init(gen: torch.Generator, vocab: int, dim: int, dtype: DTypeLike) -> Dict:
    t = torch.randn((vocab, dim), generator=gen, dtype=torch.float32, device=gen.device)
    return {"table": (t * 0.02).to(_dtype(dtype))}


def embed(p: Dict, ids: torch.Tensor) -> torch.Tensor:
    return F.embedding(ids.long(), p["table"])


def rmsnorm_init(dim: int, dtype: DTypeLike, device=None) -> Dict:
    return {"scale": torch.ones((dim,), dtype=_dtype(dtype), device=device)}


def rmsnorm(p: Dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def stacked_init(init_fn: Callable, gen: torch.Generator, num: int, *args, **kwargs):
    """``num`` inits from ``gen`` stacked on a leading layer dimension."""
    return stack_trees([init_fn(gen, *args, **kwargs) for _ in range(num)])


# -- rotary embeddings ----------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    angles = positions[..., :, None, None].float() * freqs  # (...,S,1,hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- gated MLP -------------------------------------------------------------------


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, dtype: DTypeLike) -> Dict:
    return {
        "gate": dense_init(gen, d_model, d_ff, dtype),
        "up": dense_init(gen, d_model, d_ff, dtype),
        "down": dense_init(gen, d_ff, d_model, dtype),
    }


def mlp(p: Dict, x: torch.Tensor) -> torch.Tensor:
    return dense(p["down"], F.silu(dense(p["gate"], x)) * dense(p["up"], x))


# -- misc -------------------------------------------------------------------------


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0:
        return x
    return cap * torch.tanh(x / cap)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor, mask=None) -> torch.Tensor:
    """Mean token CE in fp32; logits (..., V), labels (...) integer."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.take_along_dim(logits, labels[..., None].long(), dim=-1)[..., 0]
    nll = lse - picked
    if mask is not None:
        mask = mask.to(nll.dtype)
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
