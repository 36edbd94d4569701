"""Public wrappers around the fused kernels, and their host half.

Responsibilities, as in ``repro.kernels.ops``: padding every dense
dimension to a multiple of 128 (zero-padding is exact for dense+ReLU
chains: padded inputs are zero, padded weight rows/cols are zero,
ReLU(0)=0 propagates), batch padding, the word packing, and the
residency budget that picks the engine's tier.

**The budget is the reference's tier-selection rule, not a statement
about Hopper memory.**  ``vmem_budget_bytes`` reads like the reference
(``REPRO_VMEM_BUDGET`` wins, else 12 MiB; there is no TPU backend here)
so that both packages pick the same tier for the same spec.  What limits
one launch on Hopper is whether the activation tile fits a block's
shared memory, not the weights' bytes: the kernel streams the weights
from global memory (L2) in slabs, and
``repro_torch.kernels.fused_mlp.tile_plan`` picks the widest tile whose
activations fit, or raises.

The wrappers run the CUDA kernel for tensors on the card and the plain
version (``repro_torch.kernels.ref``) for tensors on the CPU.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.model import MLPSpec
from repro_torch.kernels import bitvector as bv_kernel
from repro_torch.kernels import fused_mlp as fm_kernel
from repro_torch.kernels.bitvector import pack_words32  # noqa: F401  (re-export)

LANE = 128  # padding multiple, kept from the reference's weight layout
DEFAULT_TILE_N = 256
#: The reference's default residency cap — the tier-selection rule.
VMEM_BUDGET_BYTES = 12 * 1024 * 1024


def vmem_budget_bytes() -> int:
    """Resolved tier budget in bytes: ``REPRO_VMEM_BUDGET`` (env, always
    wins — also the hook the boundary tests use), else
    :data:`VMEM_BUDGET_BYTES`.  Re-read on every call."""
    env = os.environ.get("REPRO_VMEM_BUDGET", "").strip()
    if env:
        return max(int(env), 1)
    return VMEM_BUDGET_BYTES


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _pad2(w: torch.Tensor) -> torch.Tensor:
    return F.pad(
        w,
        (0, _round_up(w.shape[1], LANE) - w.shape[1],
         0, _round_up(w.shape[0], LANE) - w.shape[0]),
    )


def _pad_flat_weights(params: Dict, spec: MLPSpec) -> Tuple[Tuple[torch.Tensor, ...], int]:
    """Flatten + pad weights in kernel plan order, on the params' device.
    Returns (flat, bytes)."""
    flat = []

    def add(layer):
        w, b = layer["w"], layer["b"]
        if w.dim() == 3:
            base_pad = _round_up(w.shape[1], LANE)
            h_pad = _round_up(w.shape[2], LANE)
            wp = F.pad(w, (0, h_pad - w.shape[2], 0, base_pad - w.shape[1]))
        else:
            wp = _pad2(w)
            h_pad = wp.shape[1]
        bp = F.pad(b, (0, h_pad - b.shape[0]))
        flat.append(wp.to(torch.float32).contiguous())
        flat.append(bp.to(torch.float32).contiguous())

    with torch.no_grad():
        for layer in params["shared"]:
            add(layer)
        for t in spec.tasks:
            for layer in params["heads"][t]["hidden"]:
                add(layer)
            add(params["heads"][t]["out"])
    nbytes = sum(int(x.numel()) * 4 for x in flat)
    return tuple(flat), nbytes


#: Public alias — the inference engine caches this call's result per
#: task subset so the hot path never re-pads.
pad_flat_weights = _pad_flat_weights


def padded_weight_parts(spec: MLPSpec) -> Tuple[int, Dict[str, int]]:
    """Shape-only padded byte counts, split ``(trunk_bytes, {task:
    head_bytes})`` — the streaming page planner budgets the shared trunk
    once per page and packs heads greedily against the remainder."""

    def dense(in_dim: int, out_dim: int, embed: bool) -> int:
        o = _round_up(out_dim, LANE)
        if embed:  # rank-3 (width, base_pad, h_pad) + bias
            return spec.width * _round_up(spec.base, LANE) * o + o
        return _round_up(in_dim, LANE) * o + o

    trunk_total = 0
    d = None
    for h in spec.shared:
        trunk_total += dense(d or 0, h, embed=d is None)
        d = h
    trunk = d
    priv, cards = spec.private_map, spec.card_map
    heads: Dict[str, int] = {}
    for t in spec.tasks:
        d = trunk
        total = 0
        for h in priv[t]:
            total += dense(d or 0, h, embed=d is None)
            d = h
        total += dense(d or 0, cards[t], embed=d is None)
        heads[t] = total * 4  # fp32
    return trunk_total * 4, heads


def padded_weight_bytes(spec: MLPSpec) -> int:
    """Byte count :func:`pad_flat_weights` would produce, from shapes
    alone — eligibility decisions must not materialize (and cache) a
    padded device copy that the chosen path never uses."""
    trunk, heads = padded_weight_parts(spec)
    return trunk + sum(heads.values())


def plan_head_pages(
    spec: MLPSpec,
    tile_n: int,
    words_bytes: int = 0,
    budget: Optional[int] = None,
) -> Optional[Tuple[Tuple[str, ...], ...]]:
    """Partition ``spec.tasks`` into consecutive head groups ("pages")
    that each fit the budget — the ``fused_streamed`` tier runs one
    :func:`fused_lookup` per page.  Every page pays the shared trunk +
    activation overhead; page 0 additionally reserves ``words_bytes``
    for the existence words, which ride with the first page.  Returns a
    tuple of task tuples covering ``spec.tasks`` in canonical order, or
    None when even a single head cannot fit on a fresh page."""
    budget = vmem_budget_bytes() if budget is None else int(budget)
    trunk_b, head_b = padded_weight_parts(spec)
    act = activation_bytes(spec, tile_n)
    pages: list = []
    cur: list = []
    used = trunk_b + act + int(words_bytes)
    for t in spec.tasks:
        hb = head_b[t]
        if cur and used + hb > budget:
            pages.append(tuple(cur))
            cur = []
            used = trunk_b + act
        if used + hb > budget:
            return None
        cur.append(t)
        used += hb
    pages.append(tuple(cur))
    return tuple(pages)


def activation_bytes(spec: MLPSpec, tile_n: int) -> int:
    """Per-tile activation footprint of the reference's rule (with ~double
    buffering)."""
    widths = [spec.feature_dim, *spec.shared]
    for t, sizes in spec.private:
        widths.extend(sizes)
    return tile_n * _round_up(max(widths), LANE) * 4 * 3


def check_vmem_budget(
    params: Dict, spec: MLPSpec, tile_n: int, extra_bytes: int = 0
) -> None:
    """Raise if weights + activations (+ ``extra_bytes``) exceed the
    budget — the reference's guard on its digits-in wrappers."""
    budget = vmem_budget_bytes()
    wbytes = padded_weight_bytes(spec)
    total = wbytes + activation_bytes(spec, tile_n) + extra_bytes
    if total > budget:
        raise ValueError(
            f"model too large for the VMEM-resident fused kernel rule "
            f"({total / 2**20:.1f} MiB > "
            f"{budget / 2**20:.1f} MiB); use the streamed or plain path"
        )


def words_tensor(words, device) -> torch.Tensor:
    """The packed words on ``device`` as an int32 view of
    :func:`pack_words32` (torch's uint32 support is thin; the kernel
    shifts them as unsigned)."""
    return torch.from_numpy(pack_words32(words).view(np.int32).copy()).to(device)


def card_pads(spec: MLPSpec) -> Tuple[Tuple[str, int], ...]:
    cards = spec.card_map
    return tuple((t, _round_up(cards[t], LANE)) for t in spec.tasks)


def _prep(digits: torch.Tensor, tile_n: int) -> Tuple[torch.Tensor, int]:
    n = digits.shape[0]
    n_pad = _round_up(max(n, tile_n), tile_n)
    dp = F.pad(digits.to(torch.int32), (0, 0, 0, n_pad - n))
    return dp.contiguous(), n


def fused_mlp_logits(
    params: Dict,
    spec: MLPSpec,
    digits: torch.Tensor,
    tile_n: int = DEFAULT_TILE_N,
) -> Dict[str, torch.Tensor]:
    """Per-task logits via the fused kernel. digits (n, width) int, on
    the params' device."""
    check_vmem_budget(params, spec, tile_n)
    flat, _ = _pad_flat_weights(params, spec)
    dp, n = _prep(digits, tile_n)
    cards = spec.card_map
    outs = fm_kernel.fused_mlp_call(
        dp, flat, spec, tile_n, _round_up(spec.base, LANE), card_pads(spec),
        emit_codes=False,
    )
    return {t: o[:n, : cards[t]] for t, o in zip(spec.tasks, outs)}


def fused_mlp_codes(
    params: Dict,
    spec: MLPSpec,
    digits: torch.Tensor,
    tile_n: int = DEFAULT_TILE_N,
) -> torch.Tensor:
    """(n, num_tasks) int32 argmax codes — Algorithm 1's inference
    output, with the argmax in-kernel."""
    check_vmem_budget(params, spec, tile_n)
    flat, _ = _pad_flat_weights(params, spec)
    dp, n = _prep(digits, tile_n)
    codes = fm_kernel.fused_mlp_call(
        dp, flat, spec, tile_n, _round_up(spec.base, LANE), card_pads(spec),
        emit_codes=True,
    )
    return codes[:n]


def fused_lookup(
    flat_weights: Sequence[torch.Tensor],
    spec: MLPSpec,
    keys_i32: torch.Tensor,
    pos_ops: torch.Tensor,
    words32: Optional[torch.Tensor],
    capacity: int,
    tile_n: int = DEFAULT_TILE_N,
    with_exists: bool = True,
    pred_tables: Sequence[torch.Tensor] = (),
    pred_tasks: Sequence[int] = (),
) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """One-launch lookup: padded int32 keys in, ``(codes (N_pad, m)
    int32, exists (N_pad,) int32 | None, match (N_pad,) int32 | None)``
    out.  Takes already-padded device weights (the engine's per-subset
    cache), device ``pos_ops``/``words32`` and a bucket-padded key batch;
    the caller slices padding off.

    ``with_exists=False`` drops the words input and existence output
    (streamed pages past the first).  ``pred_tables`` are padded int32
    0/1 code tables; ``pred_tasks[j]`` names the head whose code indexes
    table ``j``; match bits are the existence bit ANDed with every
    table lookup, so predicate filtering requires ``with_exists``."""
    return fm_kernel.fused_lookup_call(
        keys_i32, pos_ops, words32, tuple(flat_weights), spec, tile_n,
        _round_up(spec.base, LANE),
        int(capacity), pred_tables=tuple(pred_tables),
        pred_tasks=tuple(pred_tasks), with_exists=with_exists,
    )


def bitvector_test(words64, keys: torch.Tensor, tile_n: int = 1024) -> torch.Tensor:
    """Existence bits for integer keys against a packed uint64 word array
    (the ``BitVector`` runtime form), on the keys' device.  Returns
    (n,) bool.

    The kernel works on uint32 words, split from the uint64 words on the
    host and uploaded on every call, as the reference does.  Contiguous
    int32 or int64 keys go to the kernel as they are, in one launch; any
    other dtype or stride is first made contiguous int64.  A key reads
    as present only if ``0 <= k <= 2**31 - 1`` and ``k >> 5 < n_words``,
    so a key above int32 never wraps round to another key's bit.
    ``tile_n`` is the reference's padding granularity; the kernel needs
    no padding and does not read it."""
    if not isinstance(keys, torch.Tensor):
        raise TypeError(f"keys must be a tensor (its device picks the path), got {type(keys)}")
    words32 = words_tensor(np.asarray(words64, dtype=np.uint64), keys.device)
    if keys.dtype not in (torch.int32, torch.int64) or not keys.is_contiguous():
        keys = keys.to(torch.int64).contiguous()
    return bv_kernel.bitvector_test_call(keys, words32)
