"""Attention: GQA (full/causal, sliding-window, decode).

The port of the GQA half of ``repro.models.attention``, in plain torch
ops as the reference is in plain ``jnp`` (no Pallas kernel lies on this
path).  MLA (``mla_init``, ``mla_apply``, ``mla_init_cache``) waits for
ROADMAP item M12c.

* full causal attention runs FLASH-style — a loop over KV chunks with
  running max/sum, so live memory is O(S · chunk) not O(S²);
* sliding-window attention runs BANDED — queries are chunked to the
  window size and attend only to (own chunk, previous chunk), which is
  exact for window ≤ chunk and skips far blocks entirely;
* decode attends one query against the cache with a length mask.

Every score and weighted sum is computed in fp32 and cast back to the
activation dtype at the reference's points.  Masked scores take the
finite ``NEG_INF``: a chunk whose entries are all masked for a row gives
``exp(s - m) = 1`` there, and the running correction
``exp(NEG_INF - m_new) = 0`` scales that away once a real score arrives;
``-inf`` would make the same row NaN.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L

NEG_INF = -2.0e38
#: kv position of padding slots: after every query, so never attended.
PAD_POS = 2**30


def _constrain_batch_sharded(t: torch.Tensor, cfg) -> torch.Tensor:
    """The identity: the reference's sharding constraint is a no-op
    without a mesh, and the port runs on one device."""
    return t


# --------------------------------------------------------------------------
# parameter init
# --------------------------------------------------------------------------


def gqa_init(gen: torch.Generator, cfg) -> Dict:
    d, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = cfg.dtype
    return {
        "wq": L.dense_init(gen, d, H * hd, dt, bias=cfg.qkv_bias),
        "wk": L.dense_init(gen, d, K * hd, dt, bias=cfg.qkv_bias),
        "wv": L.dense_init(gen, d, K * hd, dt, bias=cfg.qkv_bias),
        "wo": L.dense_init(gen, H * hd, d, dt),
    }


# --------------------------------------------------------------------------
# core attention math
# --------------------------------------------------------------------------


def _flash_attend(q, k, v, q_positions, kv_positions, window: int, kv_chunk: int,
                  causal: bool = True, chunk_remat: bool = False):
    """Chunked causal softmax attention with running normalization.

    q (B,S,K,G,hd); k (B,T,K,hd); v (B,T,K,vd).  positions (B,S)/(B,T).
    window > 0 restricts to [pos-window+1, pos].  Returns (B,S,K,G,vd).
    """
    B, S, K, G, hd = q.shape
    vd = v.shape[-1]
    T = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    nchunks = (T + kv_chunk - 1) // kv_chunk
    pad = nchunks * kv_chunk - T
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kv_positions = torch.nn.functional.pad(kv_positions, (0, pad), value=PAD_POS)
    qf = q.float()
    qpos = q_positions[:, :, None]

    def step(m, l, acc, kc, vc, pc):
        s = torch.einsum("bskgh,bckh->bskgc", qf, kc.float()) * scale
        if causal:
            valid = pc[:, None, :] <= qpos  # (B,S,C)
            if window > 0:
                valid = valid & (pc[:, None, :] > (qpos - window))
        else:
            valid = (pc < 2**29)[:, None, :].expand(pc.shape[0], S, pc.shape[1])
        s = torch.where(valid[:, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bskgc,bckh->bskgh", p, vc.float())
        return m_new, l, acc

    m = torch.full((B, S, K, G), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, S, K, G), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, S, K, G, vd), dtype=torch.float32, device=q.device)
    remat = chunk_remat and torch.is_grad_enabled()
    for c in range(nchunks):
        sl = slice(c * kv_chunk, (c + 1) * kv_chunk)
        args = (m, l, acc, k[:, sl], v[:, sl], kv_positions[:, sl])
        if remat:
            # backward recomputes the chunk's softmax instead of saving
            # O(S x chunk x heads) fp32 residuals per layer
            m, l, acc = torch.utils.checkpoint.checkpoint(step, *args, use_reentrant=False)
        else:
            m, l, acc = step(*args)
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.to(q.dtype)


def _banded_attend(q, k, v, positions, window: int):
    """Exact sliding-window attention via (chunk, prev-chunk) banding.

    Requires S % window == 0.  q (B,S,K,G,hd), k/v (B,S,K,hd).
    """
    B, S, K, G, hd = q.shape
    w = window
    nc = S // w
    scale = 1.0 / math.sqrt(hd)
    qc = q.reshape(B, nc, w, K, G, hd)
    kc = k.reshape(B, nc, w, K, hd)
    vc = v.reshape(B, nc, w, K, hd)
    pos_c = positions.reshape(B, nc, w)
    # previous chunk (zeros before chunk 0)
    kp = torch.cat([torch.zeros_like(kc[:, :1]), kc[:, :-1]], dim=1)
    vp = torch.cat([torch.zeros_like(vc[:, :1]), vc[:, :-1]], dim=1)
    pp = torch.cat([torch.full_like(pos_c[:, :1], PAD_POS), pos_c[:, :-1]], dim=1)
    kk = torch.cat([kp, kc], dim=2)      # (B,nc,2w,K,hd)
    vv = torch.cat([vp, vc], dim=2)
    pk = torch.cat([pp, pos_c], dim=2)   # (B,nc,2w)
    s = torch.einsum("bnwkgh,bnckh->bnwkgc", qc.float(), kk.float()) * scale
    valid = (pk[:, :, None, :] <= pos_c[:, :, :, None]) & (
        pk[:, :, None, :] > pos_c[:, :, :, None] - w
    )
    s = torch.where(valid[:, :, :, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bnwkgc,bnckh->bnwkgh", p, vv.float())
    return out.reshape(B, S, K, G, hd).to(q.dtype)


def _masked_decode(q, k_cache, v_cache, mask):
    """q (B,1,K,G,hd) vs cache (B,T,K,hd); slots where ``mask`` (B,T)."""
    hd = q.shape[-1]
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bskgh,btkh->bskgt", q.float(), k_cache.float()) * scale
    s = torch.where(mask[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bskgt,btkh->bskgh", p, v_cache.float())
    return out.to(q.dtype)


def _slot_index(k_cache):
    """(1,T) cache slot indices."""
    return torch.arange(k_cache.shape[1], device=k_cache.device)[None, :]


def _decode_attend(q, k_cache, v_cache, length):
    """q (B,1,K,G,hd) vs cache (B,T,K,hd); positions < length attend."""
    return _masked_decode(q, k_cache, v_cache, _slot_index(k_cache) < length[:, None])


def _decode_attend_window(q, k_cache, v_cache, length, mask_lo):
    mask = (_slot_index(k_cache) < length[:, None]) & mask_lo
    return _masked_decode(q, k_cache, v_cache, mask)


def _write_cache(cache_t: torch.Tensor, new: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``dynamic_update_slice(cache_t, new, (0, idx, 0, 0))``: a new tensor
    with ``new`` (B,S,...) copied in at slots ``idx .. idx+S-1``; the
    start is clamped so the slice fits, as XLA clamps it.  ``idx`` stays
    on the device (no host sync)."""
    T, S = cache_t.shape[1], new.shape[1]
    start = torch.clamp(idx.long(), 0, T - S)
    return cache_t.index_copy(1, start + torch.arange(S, device=cache_t.device),
                              new.to(cache_t.dtype))


# --------------------------------------------------------------------------
# GQA block
# --------------------------------------------------------------------------


def gqa_apply(
    p: Dict,
    cfg,
    x: torch.Tensor,
    positions: torch.Tensor,
    window: int = 0,
    cache: Optional[Dict] = None,
    kv_chunk: int = 1024,
    causal: bool = True,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x (B,S,d).  cache = {'k': (B,T,K,hd), 'v': ..., 'len': 0-d int
    tensor} for decode.  ``causal=False`` gives bidirectional attention
    (encoder use).  Returns (out (B,S,d), updated cache)."""
    B, S, d = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G = H // K
    q = _constrain_batch_sharded(L.dense(p["wq"], x), cfg).reshape(B, S, H, hd)
    k = _constrain_batch_sharded(L.dense(p["wk"], x), cfg).reshape(B, S, K, hd)
    v = _constrain_batch_sharded(L.dense(p["wv"], x), cfg).reshape(B, S, K, hd)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    qg = q.reshape(B, S, K, G, hd)

    if cache is not None:
        idx = cache["len"]  # 0-d int tensor: same step across batch
        k_cache = _write_cache(cache["k"], k, idx)
        v_cache = _write_cache(cache["v"], v, idx)
        length = (idx + S).to(torch.int32).expand(B)
        if isinstance(window, int) and window > 0:
            # windowed decode: only last `window` positions attend
            lo = torch.clamp(length - window, min=0)
            mask_lo = _slot_index(k_cache) >= lo[:, None]
            out = _decode_attend_window(qg, k_cache, v_cache, length, mask_lo)
        else:
            out = _decode_attend(qg, k_cache, v_cache, length)
        new_cache = {"k": k_cache, "v": v_cache, "len": idx + S}
    else:
        if causal and isinstance(window, int) and window > 0 and S % window == 0 and S > window:
            out = _banded_attend(qg, k, v, positions, window)
        else:
            w = window if isinstance(window, int) else 0
            out = _flash_attend(qg, k, v, positions, positions, w, kv_chunk,
                                causal=causal, chunk_remat=cfg.flash_remat)
        new_cache = None

    out = _constrain_batch_sharded(out.reshape(B, S, H * hd), cfg)
    return L.dense(p["wo"], out), new_cache


def gqa_init_cache(cfg, batch: int, max_len: int, dtype=None,
                   device: DeviceLike = None) -> Dict:
    dev = resolve_device(device)
    dt = L._dtype(dtype or cfg.dtype)
    K, hd = cfg.num_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, max_len, K, hd), dtype=dt, device=dev),
        "v": torch.zeros((batch, max_len, K, hd), dtype=dt, device=dev),
        "len": torch.zeros((), dtype=torch.int32, device=dev),
    }
