"""Inference steps for the LM architectures.

The port of ``repro.serve.serve_step`` for the decoder-only archs.
``make_prefill_step`` runs the full forward over the prompt (logits for
every position — cache materialization is the decode path's first
iteration in this framework).  ``make_decode_step`` runs one-token
decode against a cache of a given length (KV caches for attention
blocks, carried states for RWKV6 and RG-LRU blocks);
``make_cache_factory`` makes that cache.  Each factory takes
``device=`` (CUDA by default, raising without a GPU); its step moves
the batch's tokens there and runs without autograd.  The encoder-decoder branch waits for ROADMAP
item M12c.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import decoder_for


def make_prefill_step(cfg: ModelConfig, device: DeviceLike = None) -> Callable:
    """(params, {"tokens": (B,S), "patch_embeds"?: (B,P,d)}) -> logits (B,S,V)."""
    model = decoder_for(cfg)
    dev = resolve_device(device)

    @torch.no_grad()
    def prefill(params: Dict, batch: Dict):
        pe = batch.get("patch_embeds")
        return model.apply(
            params, torch.as_tensor(batch["tokens"], device=dev),
            prefix_embeds=None if pe is None else torch.as_tensor(pe, device=dev),
            remat=False,
        )

    return prefill


def make_decode_step(cfg: ModelConfig, device: DeviceLike = None) -> Callable:
    """(params, cache, tokens (B,1)) -> (logits (B,1,V), new cache)."""
    model = decoder_for(cfg)
    dev = resolve_device(device)

    @torch.no_grad()
    def decode(params: Dict, cache: Dict, tokens):
        return model.decode_step(params, cache, torch.as_tensor(tokens, device=dev))

    return decode


def make_cache_factory(cfg: ModelConfig, device: DeviceLike = None) -> Callable:
    """(batch, max_len) -> a zeroed cache on ``device``."""
    return functools.partial(decoder_for(cfg).init_cache, device=resolve_device(device))
