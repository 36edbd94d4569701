"""Plain PyTorch versions of the CUDA kernels.

Two kinds live here:

* the oracles of ``repro.kernels.ref`` — the plain model forward and the
  host staged lookup (host digits, forward, host ``BitVector.test``);
* ``ref_bitvector_test``, ``fused_mlp`` and ``fused_lookup``, each with
  its kernel's exact contract (padded flat weights, padded batch, raw
  int32 keys, packed words as an int32 view).  On a CPU tensor the kernel wrappers run
  these; on the card ``chip_smoke.py`` holds each CUDA kernel against
  them on the same inputs.

Dense layers are ``x @ w + b``; the gather layer sums the selected rows
in position order, then adds the bias — the kernels' order.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.model import MLPSpec, forward_digits

#: Predicate tables one fused lookup takes, on the card and here alike
#: (the C interface's by-value descriptor holds this many).
MAX_PREDS = 8


def ref_fused_mlp_logits(
    params: Dict, digits: torch.Tensor, spec: MLPSpec
) -> Dict[str, torch.Tensor]:
    """Oracle for the fused kernel's logits: the plain model forward."""
    return forward_digits(params, digits, spec)


def ref_fused_mlp_codes(params: Dict, digits: torch.Tensor, spec: MLPSpec) -> torch.Tensor:
    logits = forward_digits(params, digits, spec)
    return torch.stack(
        [torch.argmax(logits[t], dim=-1).to(torch.int32) for t in spec.tasks], dim=1
    )


def ref_fused_lookup(params: Dict, keys, encoder, vexist, spec: MLPSpec):
    """Oracle for the fused key->codes+exists kernel: host digit
    featurization + plain model forward + host BitVector test.  Returns
    ``(codes (n, m) int32 numpy, exists (n,) bool numpy)``;
    out-of-capacity rows carry code 0 (the ``_infer_codes`` zero-fill
    contract).  Runs on the device the params live on."""
    keys = np.asarray(keys, dtype=np.int64)
    codes = np.zeros((keys.shape[0], len(spec.tasks)), dtype=np.int32)
    in_cap = (keys >= 0) & (keys < encoder.capacity)
    idx = np.flatnonzero(in_cap)
    if idx.size:
        dev = params["heads"][spec.tasks[0]]["out"]["w"].device
        digits = torch.from_numpy(encoder.digits(keys[idx])).to(dev)
        codes[idx] = ref_fused_mlp_codes(params, digits, spec).cpu().numpy()
    return codes, vexist.test(keys)


def ref_bitvector_test(words32: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """Plain version of the existence test: words32 (n_words,) int32 view
    of the packed uint32 words (LSB first), keys (n,) integers.  Returns
    (n,) int32 ``(words[k >> 5] >> (k & 31)) & 1``, and 0 for a key
    outside ``[0, min(32 * n_words, 2**31))`` — ``BitVector.test``'s
    answer past the words, where the reference's oracle would index out
    of range; a key above int32 reads as absent, as in the kernel."""
    k = keys.to(torch.int64)
    in_dom = (k >= 0) & (k <= 2**31 - 1) & ((k >> 5) < words32.shape[0])
    if not words32.numel():
        return torch.zeros_like(k, dtype=torch.int32)
    sk = torch.where(in_dom, k, torch.zeros_like(k))
    w = words32[sk >> 5].to(torch.int64) & 0xFFFFFFFF
    return (((w >> (sk & 31)) & 1) * in_dom).to(torch.int32)


def _plan(spec: MLPSpec) -> Tuple[List[str], Dict[str, List[str]]]:
    """Layer kinds for trunk and heads: 'embed' (rank-3 from input) or
    'dense', and 'embed_out'/'dense_out' for each head's last layer —
    the flat weight order of ``ops.pad_flat_weights``."""
    trunk = ["embed" if i == 0 else "dense" for i in range(len(spec.shared))]
    heads = {}
    priv = spec.private_map
    for t in spec.tasks:
        kinds = []
        first = len(trunk) == 0
        for _ in priv[t]:
            kinds.append("embed" if first else "dense")
            first = False
        kinds.append("embed_out" if first else "dense_out")
        heads[t] = kinds
    return trunk, heads


def _gather(w: torch.Tensor, b: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    idx = digits.long()
    acc = w[0][idx[:, 0]]
    for p in range(1, w.shape[0]):
        acc = acc + w[p][idx[:, p]]
    return acc + b


def _forward_flat(
    flat: Sequence[torch.Tensor], spec: MLPSpec, digits: torch.Tensor, emit_codes: bool
) -> List[torch.Tensor]:
    """Whole-model forward on padded flat weights: per-task codes (n,)
    int32 when ``emit_codes`` (argmax over columns below the card, ties
    to the lowest index) else padded logits (n, card_pad)."""
    trunk_kinds, head_kinds = _plan(spec)
    cards = spec.card_map
    it = iter(flat)
    x = None
    for kind in trunk_kinds:
        w, b = next(it), next(it)
        x = _gather(w, b, digits) if kind == "embed" else x @ w + b
        x = torch.relu(x)
    outs: List[torch.Tensor] = []
    for t in spec.tasks:
        h = x
        for kind in head_kinds[t]:
            w, b = next(it), next(it)
            if kind == "embed":
                h = torch.relu(_gather(w, b, digits))
            elif kind == "dense":
                h = torch.relu(h @ w + b)
            elif kind == "embed_out":
                h = _gather(w, b, digits)
            else:  # dense_out
                h = h @ w + b
        if emit_codes:
            col = torch.arange(h.shape[1], device=h.device)
            masked = torch.where(col < cards[t], h, torch.full_like(h, -torch.inf))
            outs.append(torch.argmax(masked, dim=-1).to(torch.int32))
        else:
            outs.append(h)
    return outs


def fused_mlp(
    digits: torch.Tensor,
    flat_weights: Sequence[torch.Tensor],
    spec: MLPSpec,
    emit_codes: bool,
):
    """Plain version of the digits-in kernel: ``(N_pad, m)`` int32 codes
    when ``emit_codes``, else a tuple of ``(N_pad, card_pad)`` fp32
    logits, one per task."""
    outs = _forward_flat(flat_weights, spec, digits, emit_codes)
    if emit_codes:
        return torch.stack(outs, dim=1)
    return tuple(outs)


def fused_lookup(
    keys: torch.Tensor,
    pos_ops: torch.Tensor,
    words32: Optional[torch.Tensor],
    flat_weights: Sequence[torch.Tensor],
    spec: MLPSpec,
    capacity: int,
    pred_tables: Sequence[torch.Tensor] = (),
    pred_tasks: Sequence[int] = (),
    with_exists: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Plain version of the keys-in kernel, same contract: keys (N_pad,)
    int32 (padding -1), pos_ops (width, 2) int32, words32 an int32 view
    of the packed uint32 words.  Returns ``(codes (N_pad, m) int32,
    exists (N_pad,) int32 | None, match (N_pad,) int32 | None)``.
    Takes at most ``MAX_PREDS`` predicate tables, as the kernel does."""
    if len(pred_tables) > MAX_PREDS:
        raise ValueError(f"at most {MAX_PREDS} predicate tables per launch")
    k = keys.to(torch.int64)
    in_cap = (k >= 0) & (k < int(capacity))
    safe = torch.where(in_cap, k, torch.zeros_like(k))
    ops = pos_ops.to(torch.int64)
    digits = torch.stack(
        [((safe % ops[p, 0]) // ops[p, 1]) % spec.base for p in range(ops.shape[0])],
        dim=1,
    )
    outs = _forward_flat(flat_weights, spec, digits, emit_codes=True)
    codes = torch.stack(outs, dim=1)
    codes = torch.where(in_cap[:, None], codes, torch.zeros_like(codes))
    if not with_exists:
        return codes, None, None
    exists = ref_bitvector_test(words32, k)
    match = None
    if pred_tables:
        match = exists
        for table, task in zip(pred_tables, pred_tasks):
            match = match * table[codes[:, task].long()]
        match = match.to(torch.int32)
    return codes, exists, match
