"""Recurrent sequence mixers: RWKV6 ("Finch", data-dependent decay
linear attention) and RG-LRU (RecurrentGemma's gated linear recurrence
with temporal conv).  Both carry O(1)-per-token state.

The port of ``repro.models.ssm``, in plain torch ops as the reference is
in plain ``jnp`` (no Pallas kernel lies on this path).  Each recurrence
is a step-by-step loop over the sequence in the reference's order of
operations, with the batch as a leading dimension where the reference
``vmap``s: the WKV update ``out = r · (s + u ⊙ k vᵀ)``,
``s = w ⊙ s + k vᵀ`` and the RG-LRU update ``h = a_t ⊙ h + bx_t``, both
in fp32.  Decode is the same loop over one token against a carried
state, which is rounded to the activation dtype between steps, as in the
reference.  Inits draw from a ``torch.Generator`` on its device, in the
reference's shapes and dtypes leaf for leaf (``u`` and ``conv_w`` drawn
in fp32 and cast; RG-LRU's ``a_param`` stays fp32 in a bf16 tree).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L


def _full(shape, value: float, dtype, device) -> torch.Tensor:
    return torch.full(shape, value, dtype=L._dtype(dtype), device=device)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, i.e.
    ``max(x, 0) + log1p(exp(-|x|))`` (``F.softplus`` turns into the
    identity above its threshold)."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


# --------------------------------------------------------------------------
# RWKV6 (arXiv:2404.05892) — time-mix with data-dependent decay + channel-mix
# --------------------------------------------------------------------------


def rwkv_init(gen: torch.Generator, cfg) -> Dict:
    d = cfg.d_model
    H = cfg.num_heads
    dh = d // H
    dt, dev = cfg.dtype, gen.device
    p = {name: _full((d,), 0.5, dt, dev) for name in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g")}
    for name in ("wr", "wk", "wv", "wg", "ww"):  # ww: data-dependent decay
        p[name] = L.dense_init(gen, d, d, dt)
    p["w_bias"] = _full((d,), -6.0, dt, dev)  # decay bias (slow default)
    u = torch.randn((H, dh), generator=gen, dtype=torch.float32, device=dev)
    p["u"] = (0.1 * u).to(L._dtype(dt))  # bonus
    p["wo"] = L.dense_init(gen, d, d, dt)
    p["ln_x"] = L.rmsnorm_init(d, dt, dev)
    return p


def _rwkv_chunk_step(state: torch.Tensor, inputs, H: int, dh: int):
    """The WKV6 recurrence over a sequence, one token at a time
    (faithful to data-dependent decay).  ``state`` (B,H,dh,dh) fp32;
    ``inputs`` = (r, k, v, w, u), the first four (S,B,H,dh) and ``u``
    (H,dh).  Returns (final state, out (S,B,H,dh))."""
    r, k, v, w, u = inputs
    s = state
    outs = []
    for t in range(r.shape[0]):
        # out = r · (s + u ⊙ k v^T); s' = diag(w) s + k v^T
        kv = k[t][..., :, None] * v[t][..., None, :]  # (B,H,dh,dh)
        outs.append(torch.einsum("bhi,bhij->bhj", r[t], s + u[:, :, None] * kv))
        s = w[t][..., :, None] * s + kv
    return s, torch.stack(outs)


def rwkv_apply(
    p: Dict, cfg, x: torch.Tensor, state: Optional[Dict] = None
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Time-mix block.  x (B,S,d).  state carries (wkv (B,H,dh,dh),
    x_prev (B,d)) for decode; None for train (zero init)."""
    B, S, d = x.shape
    H = cfg.num_heads
    dh = d // H

    x_prev = state["x_prev"][:, None, :] if state is not None else x.new_zeros((B, 1, d))
    xs = torch.cat([x_prev, x[:, :-1, :]], dim=1)  # token shift

    def mix(mu):
        return x + (xs - x) * mu

    r = L.dense(p["wr"], mix(p["mu_r"])).reshape(B, S, H, dh)
    k = L.dense(p["wk"], mix(p["mu_k"])).reshape(B, S, H, dh)
    v = L.dense(p["wv"], mix(p["mu_v"])).reshape(B, S, H, dh)
    g = F.silu(L.dense(p["wg"], mix(p["mu_g"])))
    # data-dependent decay in (0,1): exp(-exp(...)) parameterization
    w = torch.exp(-torch.exp((L.dense(p["ww"], mix(p["mu_w"])) + p["w_bias"]).float()))
    w = w.reshape(B, S, H, dh)

    s0 = (state["wkv"].float() if state is not None
          else torch.zeros((B, H, dh, dh), dtype=torch.float32, device=x.device))
    seq_first = lambda t: t.float().transpose(0, 1)  # (S,B,H,dh)
    sT, out = _rwkv_chunk_step(
        s0, (seq_first(r), seq_first(k), seq_first(v), seq_first(w), p["u"].float()), H, dh)
    out = out.transpose(0, 1).reshape(B, S, d).to(x.dtype)  # (S,B,H,dh)->(B,S,d)
    out = L.rmsnorm(p["ln_x"], out, cfg.norm_eps) * g
    out = L.dense(p["wo"], out)
    new_state = {"wkv": sT.to(x.dtype), "x_prev": x[:, -1, :]} if state is not None else None
    return out, new_state


def rwkv_channel_init(gen: torch.Generator, cfg) -> Dict:
    d, dff = cfg.d_model, cfg.d_ff
    dt, dev = cfg.dtype, gen.device
    return {
        "mu_k": _full((d,), 0.5, dt, dev),
        "mu_r": _full((d,), 0.5, dt, dev),
        "wk": L.dense_init(gen, d, dff, dt),
        "wv": L.dense_init(gen, dff, d, dt),
        "wr": L.dense_init(gen, d, d, dt),
    }


def rwkv_channel_apply(
    p: Dict, cfg, x: torch.Tensor, x_prev: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    B, S, d = x.shape
    xp = x_prev[:, None, :] if x_prev is not None else x.new_zeros((B, 1, d))
    xs = torch.cat([xp, x[:, :-1, :]], dim=1)
    k = L.dense(p["wk"], x + (xs - x) * p["mu_k"])
    kv = L.dense(p["wv"], torch.square(F.relu(k)))
    rgate = torch.sigmoid(L.dense(p["wr"], x + (xs - x) * p["mu_r"]))
    out = rgate * kv
    return out, (x[:, -1, :] if x_prev is not None else None)


def rwkv_init_state(cfg, batch: int, dtype=None, device: DeviceLike = None) -> Dict:
    """Zeroed RWKV state on ``device`` (CUDA by default)."""
    dev = resolve_device(device)
    dt = L._dtype(dtype or cfg.dtype)
    H = cfg.num_heads
    dh = cfg.d_model // H
    return {
        "wkv": torch.zeros((batch, H, dh, dh), dtype=dt, device=dev),
        "x_prev": torch.zeros((batch, cfg.d_model), dtype=dt, device=dev),
        "x_prev_ffn": torch.zeros((batch, cfg.d_model), dtype=dt, device=dev),
    }


# --------------------------------------------------------------------------
# RG-LRU (RecurrentGemma, arXiv:2402.19427) — gated linear recurrence
# --------------------------------------------------------------------------

_C_RGLRU = 8.0  # paper's fixed scaling constant


def rglru_init(gen: torch.Generator, cfg) -> Dict:
    d = cfg.d_model
    rd = cfg.rglru_dim or d
    dt, dev = cfg.dtype, gen.device
    w_in_x = L.dense_init(gen, d, rd, dt)  # recurrence branch
    w_in_g = L.dense_init(gen, d, rd, dt)  # gate branch (GeLU)
    conv_w = torch.randn((cfg.conv_width, rd), generator=gen, dtype=torch.float32, device=dev)
    return {
        "w_in_x": w_in_x,
        "w_in_g": w_in_g,
        "conv_w": (0.1 * conv_w).to(L._dtype(dt)),
        "conv_b": _full((rd,), 0.0, dt, dev),
        "wa_gate": L.dense_init(gen, rd, rd, dt),  # recurrence gate r_t
        "wx_gate": L.dense_init(gen, rd, rd, dt),  # input gate i_t
        "a_param": _full((rd,), -4.0, torch.float32, dev),  # Λ logit (slow decay)
        "w_out": L.dense_init(gen, rd, d, dt),
    }


def rglru_apply(
    p: Dict, cfg, x: torch.Tensor, state: Optional[Dict] = None
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Recurrent block: in-proj -> temporal conv -> RG-LRU -> gated out.

    state = {'h': (B,rd), 'conv': (B,conv_width-1,rd)} for decode."""
    B, S, d = x.shape
    rd = cfg.rglru_dim or d
    cw = cfg.conv_width

    xb = L.dense(p["w_in_x"], x)  # (B,S,rd)
    # jax.nn.gelu's default is the tanh approximation
    gate_branch = F.gelu(L.dense(p["w_in_g"], x), approximate="tanh")

    # temporal conv (causal, width cw)
    if state is not None:
        ctx = torch.cat([state["conv"], xb], dim=1)
    else:
        ctx = torch.cat([xb.new_zeros((B, cw - 1, rd)), xb], dim=1)
    conv = sum(ctx[:, i: i + S, :] * p["conv_w"][i] for i in range(cw)) + p["conv_b"]

    # RG-LRU gates
    r_t = torch.sigmoid(L.dense(p["wa_gate"], conv))
    i_t = torch.sigmoid(L.dense(p["wx_gate"], conv))
    log_a = -_C_RGLRU * _softplus(p["a_param"]) * r_t.float()
    a = torch.exp(log_a)
    gated_x = (conv * i_t).float()
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-6))

    h = (state["h"].float() if state is not None
         else torch.zeros((B, rd), dtype=torch.float32, device=x.device))
    bx = beta * gated_x
    hs = []
    for t in range(S):
        h = a[:, t] * h + bx[:, t]
        hs.append(h)
    hs = torch.stack(hs, dim=1).to(x.dtype)  # (B,S,rd)

    out = L.dense(p["w_out"], hs * gate_branch)
    new_state = (
        {"h": h.to(x.dtype),
         "conv": ctx[:, S: S + cw - 1, :] if S >= cw - 1 else ctx[:, -(cw - 1):, :]}
        if state is not None
        else None
    )
    return out, new_state


def rglru_init_state(cfg, batch: int, dtype=None, device: DeviceLike = None) -> Dict:
    """Zeroed RG-LRU state on ``device`` (CUDA by default)."""
    dev = resolve_device(device)
    dt = L._dtype(dtype or cfg.dtype)
    rd = cfg.rglru_dim or cfg.d_model
    return {
        "h": torch.zeros((batch, rd), dtype=dt, device=dev),
        "conv": torch.zeros((batch, cfg.conv_width - 1, rd), dtype=dt, device=dev),
    }
