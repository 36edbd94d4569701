"""int8 error-feedback gradient compression: the single-device half of
``repro.train.compression``.

int8 quantization cuts a gradient's wire bytes 4x against fp32 (2x
against bf16), and ERROR FEEDBACK (the residual carried into the next
step) keeps SGD convergence (the 1-bit-Adam/EF-SGD lineage).  The
reference's collectives over mesh axes (``hierarchical_psum``,
``compressed_cross_pod_mean``) run inside ``shard_map`` across devices;
they wait for ROADMAP item M12d.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.core.model import _leaves, _map_tree, _with_leaves


class EFState(NamedTuple):
    """Per-leaf error-feedback residuals (same structure as grads)."""

    residual: Dict


def ef_init(grads_like) -> EFState:
    return EFState(residual=_map_tree(grads_like, torch.zeros_like))


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization. Returns (q, scale)."""
    xf = x.float()
    scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_grads(grads, ef: EFState) -> Tuple[Dict, EFState]:
    """Quantize (grad + residual) to int8; residual keeps what was lost.

    Returns (compressed tree of (q, scale), new EF state).  The caller
    transmits ``q``/``scale`` over the slow link and dequantizes on the
    far side; convergence-critical information is never dropped, only
    delayed — the EF guarantee."""
    def one(g, r):
        target = g.float() + r.float()
        q, scale = quantize_int8(target)
        return (q, scale), (target - dequantize_int8(q, scale)).to(r.dtype)

    out = [one(g, r) for g, r in zip(_leaves(grads), _leaves(ef.residual), strict=True)]
    return (_with_leaves(grads, [o[0] for o in out]),
            EFState(residual=_with_leaves(grads, [o[1] for o in out])))


def decompress_grads(compressed) -> Dict:
    """The tree of ``(q, scale)`` pairs back to fp32 gradients."""
    return _map_tree(compressed, lambda qs: dequantize_int8(*qs))
