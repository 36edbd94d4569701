"""Train step factory for the LM architectures.

The port of ``repro.train.train_step`` for the decoder-only archs
(dense GQA, RWKV6 and RG-LRU blocks).
``make_train_step(cfg, optimizer, microbatches)`` returns a
``(state, batch) -> (state, metrics)`` function that runs eagerly on the
device the state is on: next-token cross-entropy through
``DecoderLM.apply`` (with its ``remat`` groups), gradients by autograd
in place of ``jax.value_and_grad``, then the optimizer.  Gradient
accumulation over microbatches walks the microbatches in a Python loop,
in the reference's ``lax.scan`` order, so activation memory is bounded
by one microbatch.  The MoE auxiliary loss and the encoder-decoder loss
wait for ROADMAP item M12c: their configs raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.core.model import _leaves, _map_tree, _with_leaves
from repro_torch.device import DeviceLike
from repro_torch.models import DecoderLM
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import decoder_for
from repro_torch.train.optimizer import OptState, adamw, global_norm


class TrainState(NamedTuple):
    params: Dict
    opt: OptState


def init_state(cfg: ModelConfig, optimizer: adamw, seed: int = 0,
               device: DeviceLike = None) -> TrainState:
    """Weights from ``DecoderLM.init`` on ``device`` (CUDA by default)
    and the optimizer's state for them."""
    params = decoder_for(cfg).init(seed, device=device)
    return TrainState(params=params, opt=optimizer.init(params))


def _lm_loss(model: DecoderLM, params: Dict, batch: Dict) -> torch.Tensor:
    tokens = batch["tokens"]
    prefix = batch.get("patch_embeds")
    logits = model.apply(params, tokens, prefix_embeds=prefix)
    labels = tokens[:, 1:]
    lg = logits[:, :-1]
    mask = None
    if prefix is not None:
        # prefix positions carry embeddings, not predictable tokens
        P = prefix.shape[1]
        pos = torch.arange(labels.shape[1], device=labels.device)[None, :]
        mask = (pos >= P).float() * torch.ones_like(labels, dtype=torch.float32)
    return L.cross_entropy_loss(lg, labels, mask)


def make_loss_fn(cfg: ModelConfig) -> Tuple[Callable, DecoderLM]:
    """``(loss_fn(params, batch) -> 0-d fp32 loss, model)``.  MoE and
    encoder-decoder configs raise ``NotImplementedError`` (M12c)."""
    model = decoder_for(cfg)

    def loss_fn(params: Dict, batch: Dict) -> torch.Tensor:
        return _lm_loss(model, params, batch)

    return loss_fn, model


def value_and_grad(loss_fn: Callable, params: Dict, batch: Dict) -> Tuple[torch.Tensor, Dict]:
    """``jax.value_and_grad(loss_fn)(params, batch)`` by autograd: the
    loss (detached) and a gradient tree of ``params``' layout (zeros
    for a leaf the loss does not reach, as JAX gives)."""
    leaves = [t.detach().requires_grad_(True) for t in _leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(_with_leaves(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]
    return loss.detach(), _with_leaves(params, grads)


def make_train_step(
    cfg: ModelConfig,
    optimizer: adamw,
    microbatches: int = 1,
) -> Callable[[TrainState, Dict], Tuple[TrainState, Dict]]:
    """``train_step(state, batch) -> (state, {"loss", "grad_norm"})``;
    ``grad_norm`` is the global norm of the (unclipped) gradients in
    fp32.  Both metrics stay 0-d device tensors."""
    loss_fn, _ = make_loss_fn(cfg)

    def train_step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        if microbatches <= 1:
            loss, grads = value_and_grad(loss_fn, state.params, batch)
        else:
            def reshape(x):
                b = x.shape[0]
                return x.reshape(microbatches, b // microbatches, *x.shape[1:])

            micro = {k: reshape(v) for k, v in batch.items()}
            first = next(_leaves(state.params))
            loss = torch.zeros((), dtype=torch.float32, device=first.device)
            grads = _map_tree(state.params, torch.zeros_like)
            for i in range(microbatches):
                mloss, mgrads = value_and_grad(
                    loss_fn, state.params, {k: v[i] for k, v in micro.items()})
                loss = loss + mloss / microbatches
                grads = _with_leaves(grads, [
                    a + g / microbatches for a, g in zip(_leaves(grads), _leaves(mgrads))])
        new_params, new_opt = optimizer.update(grads, state.opt, state.params)
        return TrainState(new_params, new_opt), {"loss": loss, "grad_norm": global_norm(grads)}

    return train_step
