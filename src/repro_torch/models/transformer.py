"""Decoder-only LM assembly: dense GQA decoders, RWKV6 and RG-LRU hybrids.

The port of ``repro.models.transformer`` for blocks of kind ``"attn"``
with a dense FFN, ``"rwkv"`` (time-mix and channel-mix,
:mod:`repro_torch.models.ssm`) and ``"rglru"`` (the recurrence and a
gated MLP).  A MoE FFN and MLA raise ``NotImplementedError``: they wait
for ROADMAP item M12c.

Depth is organized into SEGMENTS of repeated block-pattern GROUPS, as in
the reference: gemma3's group is six layers (5 windowed + 1 global), so
each position's window is static; recurrentgemma's is
``("rglru", "rglru", "attn")``.  A segment's group params are stacked on
a leading group dimension (the reference's ``lax.scan`` layout); the
port walks the groups in a Python loop, then the remainder layers.
Caches are stacked per group the same way: KV caches for ``"attn"``,
``{"wkv", "x_prev", "x_prev_ffn"}`` for ``"rwkv"`` and ``{"h", "conv"}``
for ``"rglru"``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.core.model import _map_tree
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.config import ModelConfig


# --------------------------------------------------------------------------
# depth plan
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Segment:
    pattern: Tuple[str, ...]       # block kinds within one group
    windows: Tuple[int, ...]       # per-position window (attn blocks)
    moe: Tuple[bool, ...]          # per-position: MoE FFN?
    groups: int                    # number of stacked groups
    remainder: Tuple[str, ...]     # trailing unrolled block kinds
    rem_windows: Tuple[int, ...]
    rem_moe: Tuple[bool, ...]


def plan_segments(cfg: ModelConfig) -> List[Segment]:
    L_ = cfg.num_layers
    blocks = cfg.layer_blocks
    windows = cfg.layer_window
    moe_flags = tuple(
        cfg.is_moe and i >= cfg.first_dense_layers and blocks[i] == "attn"
        for i in range(L_)
    )
    segs: List[Segment] = []
    if cfg.is_moe and cfg.first_dense_layers:
        fd = cfg.first_dense_layers
        segs.append(
            Segment(
                pattern=blocks[:1] * 1, windows=windows[:1], moe=(False,),
                groups=0, remainder=blocks[:fd], rem_windows=windows[:fd],
                rem_moe=(False,) * fd,
            )
        )
        blocks, windows, moe_flags = blocks[fd:], windows[fd:], moe_flags[fd:]
    # pattern period = lcm of block and window patterns
    P = math.lcm(len(cfg.block_pattern), len(cfg.window_pattern))
    n = len(blocks)
    groups = n // P
    segs.append(
        Segment(
            pattern=blocks[:P],
            windows=windows[:P],
            moe=moe_flags[:P],
            groups=groups,
            remainder=blocks[groups * P :],
            rem_windows=windows[groups * P :],
            rem_moe=moe_flags[groups * P :],
        )
    )
    return segs


# --------------------------------------------------------------------------
# per-block init / apply / cache
# --------------------------------------------------------------------------


def _require_ported(cfg: ModelConfig, kind: str, moe: bool) -> None:
    """Raise for the block kinds this port does not run yet."""
    if kind not in ("attn", "rwkv", "rglru"):
        raise ValueError(kind)
    if kind == "attn" and (moe or cfg.use_mla):
        what = "a MoE FFN" if moe else "MLA attention"
        raise NotImplementedError(
            f"{cfg.name}: {what} is not ported yet (ROADMAP item M12c); "
            "repro_torch runs dense GQA, RWKV6 and RG-LRU decoders")


def _block_init(gen: torch.Generator, cfg: ModelConfig, kind: str, moe: bool) -> Dict:
    _require_ported(cfg, kind, moe)
    dev = gen.device
    p: Dict = {"ln1": L.rmsnorm_init(cfg.d_model, cfg.dtype, dev),
               "ln2": L.rmsnorm_init(cfg.d_model, cfg.dtype, dev)}
    if kind == "attn":
        p["attn"] = A.gqa_init(gen, cfg)
        p["ffn"] = L.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.dtype)
    elif kind == "rwkv":
        p["attn"] = S.rwkv_init(gen, cfg)
        p["ffn"] = S.rwkv_channel_init(gen, cfg)
    else:
        p["attn"] = S.rglru_init(gen, cfg)
        p["ffn"] = L.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.dtype)
    return p


def _block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                 device: torch.device) -> Dict:
    _require_ported(cfg, kind, False)
    if kind == "rwkv":
        return S.rwkv_init_state(cfg, batch, device=device)
    if kind == "rglru":
        return S.rglru_init_state(cfg, batch, device=device)
    c = A.gqa_init_cache(cfg, batch, max_len, device=device)
    c.pop("len")
    return c


def _block_apply(
    p: Dict,
    cfg: ModelConfig,
    kind: str,
    moe: bool,
    window: int,
    x: torch.Tensor,
    positions: torch.Tensor,
    cache: Optional[Dict],
    cache_len,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    _require_ported(cfg, kind, moe)
    h_in = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    new_cache = None
    if kind == "attn":
        c = dict(cache, len=cache_len) if cache is not None else None
        h, new_cache = A.gqa_apply(p["attn"], cfg, h_in, positions, window=window, cache=c)
        if new_cache is not None:
            new_cache.pop("len")
        x = x + h
        f = L.mlp(p["ffn"], L.rmsnorm(p["ln2"], x, cfg.norm_eps))
    elif kind == "rwkv":
        st = {"wkv": cache["wkv"], "x_prev": cache["x_prev"]} if cache is not None else None
        h, st2 = S.rwkv_apply(p["attn"], cfg, h_in, state=st)
        x = x + h
        f_in = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
        xp = cache["x_prev_ffn"] if cache is not None else None
        f, xp2 = S.rwkv_channel_apply(p["ffn"], cfg, f_in, x_prev=xp)
        if cache is not None:
            new_cache = {"wkv": st2["wkv"], "x_prev": st2["x_prev"], "x_prev_ffn": xp2}
    else:
        h, new_cache = S.rglru_apply(p["attn"], cfg, h_in, state=cache)
        x = x + h
        f = L.mlp(p["ffn"], L.rmsnorm(p["ln2"], x, cfg.norm_eps))
    return x + f, new_cache


def _unstack(tree, groups: int) -> List:
    """The ``groups`` groups of a stacked tree, as views (no copies): one
    ``unbind`` a leaf, whose backward stacks the groups' gradients in one
    op, where indexing each group would add a zero-filled gradient of the
    whole stack per group."""
    per_leaf = _map_tree(tree, lambda t: t.unbind(0))
    return [_map_tree(per_leaf, lambda ts, g=g: ts[g]) for g in range(groups)]


# --------------------------------------------------------------------------
# the decoder
# --------------------------------------------------------------------------


class DecoderLM:
    """Functional decoder: ``init`` -> params, ``apply`` -> logits,
    ``init_cache``/``decode_step`` for serving.  The params and the cache
    are the reference's trees leaf for leaf (``"groups"`` is ``None`` in
    a segment without groups); ``apply`` and ``decode_step`` run on the
    device the params and tokens are on."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.segments = plan_segments(cfg)
        for seg in self.segments:
            for kind, moe in zip(seg.pattern + seg.remainder, seg.moe + seg.rem_moe):
                _require_ported(cfg, kind, moe)

    @property
    def padded_vocab(self) -> int:
        m = self.cfg.vocab_pad_multiple
        v = self.cfg.vocab_size
        return v if m <= 0 else ((v + m - 1) // m) * m

    # ------------------------------------------------------------- params
    def init(self, seed: int = 0, device: DeviceLike = None) -> Dict:
        """Weights drawn from a ``torch.Generator`` on ``device`` (CUDA by
        default), in the reference's dtypes and tree layout."""
        cfg = self.cfg
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        vp = self.padded_vocab
        params: Dict = {
            "embed": L.embedding_init(gen, vp, cfg.d_model, cfg.dtype),
            "final_norm": L.rmsnorm_init(cfg.d_model, cfg.dtype, dev),
            "segments": [],
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = L.dense_init(gen, cfg.d_model, vp, cfg.dtype)
        for seg in self.segments:
            seg_params: Dict = {"groups": None, "remainder": []}
            if seg.groups > 0:
                seg_params["groups"] = L.stack_trees([
                    [_block_init(gen, cfg, kind, moe) for kind, moe in zip(seg.pattern, seg.moe)]
                    for _ in range(seg.groups)
                ])
            for kind, moe in zip(seg.remainder, seg.rem_moe):
                seg_params["remainder"].append(_block_init(gen, cfg, kind, moe))
            params["segments"].append(seg_params)
        return params

    # ------------------------------------------------------------- forward
    def apply(
        self,
        params: Dict,
        tokens: torch.Tensor,
        prefix_embeds: Optional[torch.Tensor] = None,
        remat: Optional[bool] = None,
    ) -> torch.Tensor:
        """tokens (B,S) -> logits (B,S,V).  ``prefix_embeds`` (B,P,d)
        replaces the first P token embeddings (modality-frontend stub:
        vision patches / audio frames).  ``remat`` checkpoints each group
        (``torch.utils.checkpoint``) when autograd records."""
        cfg = self.cfg
        x = L.embed(params["embed"], tokens)
        if prefix_embeds is not None:
            P = prefix_embeds.shape[1]
            x = torch.cat([prefix_embeds.to(x.dtype), x[:, P:, :]], dim=1)
        B, S_len, _ = x.shape
        positions = torch.arange(S_len, dtype=torch.int32, device=x.device)[None].expand(B, S_len)
        use_remat = cfg.remat != "none" if remat is None else remat

        x = self._run_blocks(params, x, positions, caches=None, cache_len=None,
                             use_remat=use_remat)[0]
        x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return self._logits(params, x)

    def _logits(self, params: Dict, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if cfg.tie_embeddings:
            logits = x @ params["embed"]["table"].T
        else:
            logits = L.dense(params["lm_head"], x)
        logits = L.softcap(logits, cfg.logit_softcap)
        if self.padded_vocab != cfg.vocab_size:
            # mask padded classes (keeps the vocab dim shardable)
            col = torch.arange(logits.shape[-1], device=logits.device)
            logits = torch.where(col < cfg.vocab_size, logits, -1e9)
        return logits

    def _run_blocks(self, params, x, positions, caches, cache_len, use_remat):
        """Shared depth walk for full-sequence and decode paths."""
        cfg = self.cfg
        remat = use_remat and torch.is_grad_enabled()
        new_caches: List = []
        for si, seg in enumerate(self.segments):
            seg_params = params["segments"][si]
            seg_cache = caches[si] if caches is not None else None
            new_seg_cache: Dict = {"groups": None, "remainder": []}

            def group_body(x, gp, gc):
                outs = []
                for bi, kind in enumerate(seg.pattern):
                    c = gc[bi] if gc is not None else None
                    x, nc = _block_apply(gp[bi], cfg, kind, seg.moe[bi], seg.windows[bi],
                                         x, positions, c, cache_len)
                    outs.append(nc)
                return x, outs

            if seg.groups > 0:
                group_caches = []
                gps = _unstack(seg_params["groups"], seg.groups)
                gcs = (_unstack(seg_cache["groups"], seg.groups) if seg_cache is not None
                       else [None] * seg.groups)
                for gp, gc in zip(gps, gcs):
                    if remat:
                        x, outs = torch.utils.checkpoint.checkpoint(
                            group_body, x, gp, gc, use_reentrant=False)
                    else:
                        x, outs = group_body(x, gp, gc)
                    group_caches.append(outs)
                if seg_cache is not None:
                    new_seg_cache["groups"] = L.stack_trees(group_caches)

            for ri, kind in enumerate(seg.remainder):
                c = seg_cache["remainder"][ri] if seg_cache is not None else None
                x, nc = _block_apply(
                    seg_params["remainder"][ri], cfg, kind, seg.rem_moe[ri],
                    seg.rem_windows[ri], x, positions, c, cache_len,
                )
                new_seg_cache["remainder"].append(nc)
            new_caches.append(new_seg_cache)
        return x, new_caches

    # ------------------------------------------------------------- serving
    def init_cache(self, batch: int, max_len: int, device: DeviceLike = None) -> Dict:
        """Zeroed KV caches and recurrent states on ``device`` (CUDA by
        default), in the config's dtype: ``{"layers": [...], "len": 0-d
        int32}``."""
        cfg = self.cfg
        dev = resolve_device(device)
        caches = []
        for seg in self.segments:
            seg_cache: Dict = {"groups": None, "remainder": []}
            if seg.groups > 0:
                seg_cache["groups"] = [
                    {name: torch.zeros((seg.groups,) + t.shape, dtype=t.dtype, device=dev)
                     for name, t in _block_cache(cfg, kind, batch, max_len, dev).items()}
                    for kind in seg.pattern
                ]
            for kind in seg.remainder:
                seg_cache["remainder"].append(_block_cache(cfg, kind, batch, max_len, dev))
            caches.append(seg_cache)
        return {"layers": caches, "len": torch.zeros((), dtype=torch.int32, device=dev)}

    def decode_step(
        self, params: Dict, cache: Dict, tokens: torch.Tensor
    ) -> Tuple[torch.Tensor, Dict]:
        """tokens (B,1) one new token per sequence -> (logits (B,1,V), cache).
        The cache's ``len`` stays on the device, so a step makes no host
        sync."""
        cfg = self.cfg
        x = L.embed(params["embed"], tokens)
        B = x.shape[0]
        idx = cache["len"]
        positions = idx.to(torch.int32).expand(B, 1)
        x, new_caches = self._run_blocks(
            params, x, positions, caches=cache["layers"], cache_len=idx,
            use_remat=False,
        )
        x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return self._logits(params, x), {"layers": new_caches, "len": idx + 1}


def decoder_for(cfg: ModelConfig) -> DecoderLM:
    """The decoder of ``cfg``; the encoder-decoder LM waits for M12c."""
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder LM is not ported yet (ROADMAP item M12c)")
    return DecoderLM(cfg)
