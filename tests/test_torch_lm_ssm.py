"""The port's recurrent sequence mixers (``repro_torch.models.ssm``: RWKV6
time-mix and channel-mix, RG-LRU) held against the reference's
(``repro.models.ssm``) on the CPU.

Inputs and carried states are made with numpy from a seed; weights are
the reference's inits carried over with ``params_from_numpy``.  fp32
outputs and states agree within ``TOL`` (1e-5, absolute and relative):
each recurrence runs in the reference's order of operations, so only
the matmuls' summation orders differ.  One RG-LRU case drives its GeLU
gate where the erf form and the reference's tanh form differ by more
than ``TOL``.  bf16 states are rounded to the activation dtype between
steps as in the reference, within ``BF16_TOL``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models import ModelConfig as JModelConfig
from repro.models import ssm as JS
from repro_torch.core.convert import params_from_numpy
from repro_torch.models import ModelConfig
from repro_torch.models import ssm as S

#: fp32 outputs and states: absolute and relative.
TOL = 1e-5
#: bf16 outputs and states (a few bf16 steps at magnitudes up to 4).
BF16_TOL = 6.25e-2

#: A small RWKV6 config (3 heads of 8) and an RG-LRU one whose
#: recurrence is wider than the model (rd 20 over d 16, conv width 4).
RWKV = JModelConfig(name="rwkv-t", family="ssm", num_layers=1, d_model=24, num_heads=3,
                    num_kv_heads=3, d_ff=40, vocab_size=10, block_pattern=("rwkv",),
                    dtype="float32", remat="none")
RGLRU = JModelConfig(name="rglru-t", family="hybrid", num_layers=1, d_model=16, num_heads=2,
                     num_kv_heads=1, d_ff=32, vocab_size=10, block_pattern=("rglru",),
                     rglru_dim=20, conv_width=4, dtype="float32", remat="none")


def cpu(tree):
    return params_from_numpy(jax.device_get(tree), device="cpu")


def tcfg_of(jcfg):
    return ModelConfig(**dataclasses.asdict(jcfg))


def close(got, want, tol=TOL):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32),
                               np.asarray(want, dtype=np.float32), rtol=tol, atol=tol)


def normal(rng, *shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


def close_trees(got, want, tol=TOL):
    assert (got is None) == (want is None)
    if want is None:
        return
    assert got.keys() == want.keys()
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        close(got[k], want[k], tol)


# -------------------------------------------------------------------- RWKV6


def rwkv_case(seed, jcfg=RWKV):
    """The reference's time-mix and channel-mix weights, with the
    constant leaves (mixes, decay bias) given values so every term
    counts."""
    rng = np.random.default_rng(seed)
    p = JS.rwkv_init(jax.random.PRNGKey(seed), jcfg)
    d = jcfg.d_model
    for name in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g"):
        p[name] = jnp.asarray(rng.uniform(0, 1, d).astype(np.float32))
    p["w_bias"] = jnp.asarray(normal(rng, d, scale=0.5) - 1.0)  # decays 0.1-0.9
    p["ln_x"] = {"scale": jnp.asarray(1 + normal(rng, d, scale=0.1))}
    pc = JS.rwkv_channel_init(jax.random.PRNGKey(seed + 1), jcfg)
    pc["mu_k"] = jnp.asarray(rng.uniform(0, 1, d).astype(np.float32))
    pc["mu_r"] = jnp.asarray(rng.uniform(0, 1, d).astype(np.float32))
    return p, pc, rng


def rwkv_state(rng, jcfg, B):
    H = jcfg.num_heads
    dh = jcfg.d_model // H
    return {"wkv": normal(rng, B, H, dh, dh), "x_prev": normal(rng, B, jcfg.d_model)}


class TestRWKV:
    def test_apply_without_state(self):
        p, _, rng = rwkv_case(0)
        x = normal(rng, 2, 9, RWKV.d_model)
        got, gs = S.rwkv_apply(cpu(p), tcfg_of(RWKV), torch.from_numpy(x))
        want, ws = JS.rwkv_apply(p, RWKV, jnp.asarray(x))
        assert gs is None and ws is None
        close(got, want)

    @pytest.mark.parametrize("S_len", [1, 6])
    def test_apply_with_a_carried_state(self, S_len):
        p, _, rng = rwkv_case(1)
        st = rwkv_state(rng, RWKV, 2)
        x = normal(rng, 2, S_len, RWKV.d_model)
        got, gs = S.rwkv_apply(cpu(p), tcfg_of(RWKV), torch.from_numpy(x),
                               state={k: torch.from_numpy(v) for k, v in st.items()})
        want, ws = JS.rwkv_apply(p, RWKV, jnp.asarray(x),
                                 state={k: jnp.asarray(v) for k, v in st.items()})
        close(got, want)
        close_trees(gs, ws)
        # x_prev is the last input row, exactly
        np.testing.assert_array_equal(gs["x_prev"].numpy(), x[:, -1])

    def test_chunk_step_per_batch_element(self):
        """The batched recurrence equals the reference's per-sequence
        scan on each batch element."""
        rng = np.random.default_rng(2)
        B, Sq, H, dh = 3, 7, 2, 4
        r, k, v = (normal(rng, Sq, B, H, dh) for _ in range(3))
        w = rng.uniform(0.1, 0.99, (Sq, B, H, dh)).astype(np.float32)
        u = normal(rng, H, dh)
        s0 = normal(rng, B, H, dh, dh)
        sT, out = S._rwkv_chunk_step(torch.from_numpy(s0), tuple(
            map(torch.from_numpy, (r, k, v, w, u))), H, dh)
        assert sT.shape == (B, H, dh, dh) and out.shape == (Sq, B, H, dh)
        for b in range(B):
            ub = np.broadcast_to(u, (Sq, H, dh))
            wsT, wout = JS._rwkv_chunk_step(jnp.asarray(s0[b]), tuple(
                jnp.asarray(a) for a in (r[:, b], k[:, b], v[:, b], w[:, b], ub)), H, dh)
            close(sT[b], wsT)
            close(out[:, b], wout)

    @pytest.mark.parametrize("with_prev", [False, True])
    def test_channel_apply(self, with_prev):
        _, pc, rng = rwkv_case(3)
        x = normal(rng, 2, 5, RWKV.d_model)
        xp = normal(rng, 2, RWKV.d_model) if with_prev else None
        got, gp = S.rwkv_channel_apply(cpu(pc), tcfg_of(RWKV), torch.from_numpy(x),
                                       x_prev=None if xp is None else torch.from_numpy(xp))
        want, wp = JS.rwkv_channel_apply(pc, RWKV, jnp.asarray(x),
                                         x_prev=None if xp is None else jnp.asarray(xp))
        close(got, want)
        # x_prev comes back only when one was given
        assert (gp is None) == (wp is None) == (not with_prev)
        if with_prev:
            np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))

    def test_sequence_split_into_decode_steps(self):
        """The state carried through single-token steps gives the
        full-sequence outputs (fp32: no rounding between steps)."""
        p, _, rng = rwkv_case(4)
        cfg = tcfg_of(RWKV)
        x = torch.from_numpy(normal(rng, 2, 6, RWKV.d_model))
        full, _ = S.rwkv_apply(cpu(p), cfg, x)
        st = S.rwkv_init_state(cfg, 2, device="cpu")
        st.pop("x_prev_ffn")
        outs = []
        for t in range(6):
            o, st = S.rwkv_apply(cpu(p), cfg, x[:, t:t + 1], state=st)
            outs.append(o)
        close(torch.cat(outs, 1), full.numpy())

    def test_bf16_state_is_rounded_as_the_reference(self):
        jcfg = dataclasses.replace(RWKV, dtype="bfloat16")
        p = JS.rwkv_init(jax.random.PRNGKey(5), jcfg)
        tp = cpu(p)
        assert tp["u"].dtype == torch.bfloat16 and tp["wr"]["w"].dtype == torch.bfloat16
        rng = np.random.default_rng(5)
        st = rwkv_state(rng, jcfg, 2)
        x = normal(rng, 2, 3, jcfg.d_model)
        got, gs = S.rwkv_apply(tp, tcfg_of(jcfg), torch.from_numpy(x).bfloat16(),
                               state={k: torch.from_numpy(v).bfloat16() for k, v in st.items()})
        want, ws = JS.rwkv_apply(p, jcfg, jnp.asarray(x, jnp.bfloat16),
                                 state={k: jnp.asarray(v, jnp.bfloat16) for k, v in st.items()})
        assert got.dtype == gs["wkv"].dtype == torch.bfloat16
        close(got, np.asarray(want.astype(jnp.float32)), BF16_TOL)
        close(gs["wkv"], np.asarray(ws["wkv"].astype(jnp.float32)), BF16_TOL)


# ------------------------------------------------------------------- RG-LRU


def rglru_case(seed, jcfg=RGLRU, gate_scale=1.0):
    rng = np.random.default_rng(seed)
    p = JS.rglru_init(jax.random.PRNGKey(seed), jcfg)
    rd = jcfg.rglru_dim
    p["conv_b"] = jnp.asarray(normal(rng, rd, scale=0.1))
    p["a_param"] = jnp.asarray(normal(rng, rd, scale=2.0))  # decays across (0, 1)
    p["w_in_g"] = {"w": p["w_in_g"]["w"] * gate_scale}
    return p, rng


class TestRGLRU:
    def test_apply_without_state(self):
        p, rng = rglru_case(10)
        x = normal(rng, 2, 9, RGLRU.d_model)
        got, gs = S.rglru_apply(cpu(p), tcfg_of(RGLRU), torch.from_numpy(x))
        want, ws = JS.rglru_apply(p, RGLRU, jnp.asarray(x))
        assert gs is None and ws is None
        close(got, want)

    @pytest.mark.parametrize("S_len", [1, 2, 3, 7])
    def test_apply_with_a_carried_state(self, S_len):
        """S = 1 and S < cw - 1 keep the last cw - 1 rows of the context
        (old conv rows included); S >= cw - 1 the last cw - 1 inputs."""
        p, rng = rglru_case(11)
        cw, rd = RGLRU.conv_width, RGLRU.rglru_dim
        st = {"h": normal(rng, 2, rd), "conv": normal(rng, 2, cw - 1, rd)}
        x = normal(rng, 2, S_len, RGLRU.d_model)
        got, gs = S.rglru_apply(cpu(p), tcfg_of(RGLRU), torch.from_numpy(x),
                                state={k: torch.from_numpy(v) for k, v in st.items()})
        want, ws = JS.rglru_apply(p, RGLRU, jnp.asarray(x),
                                  state={k: jnp.asarray(v) for k, v in st.items()})
        close(got, want)
        close_trees(gs, ws)
        if S_len < cw - 1:
            np.testing.assert_array_equal(gs["conv"][:, :cw - 1 - S_len].numpy(),
                                          st["conv"][:, S_len:])

    def test_gelu_gate_is_the_tanh_form(self):
        """Gate pre-activations of magnitude 2-4, where erf and tanh GeLU
        differ by more than TOL: the port follows jax.nn.gelu's tanh
        default."""
        p, rng = rglru_case(12, gate_scale=4.0)
        x = normal(rng, 2, 5, RGLRU.d_model)
        pre = torch.from_numpy(x) @ cpu(p)["w_in_g"]["w"]
        gap = (F.gelu(pre) - F.gelu(pre, approximate="tanh")).abs().max()
        assert float(gap) > 10 * TOL
        got, _ = S.rglru_apply(cpu(p), tcfg_of(RGLRU), torch.from_numpy(x))
        want, _ = JS.rglru_apply(p, RGLRU, jnp.asarray(x))
        close(got, want)

    def test_softplus_is_the_references(self):
        x = np.concatenate([np.linspace(-40, 40, 801), [-1e4, 1e4, 0.0, 19.99, 20.01]])
        x = x.astype(np.float32)
        close(S._softplus(torch.from_numpy(x)), jax.nn.softplus(jnp.asarray(x)), tol=1e-7)

    def test_sequence_split_into_decode_steps(self):
        p, rng = rglru_case(13)
        cfg = tcfg_of(RGLRU)
        x = torch.from_numpy(normal(rng, 2, 6, RGLRU.d_model))
        full, _ = S.rglru_apply(cpu(p), cfg, x)
        st = S.rglru_init_state(cfg, 2, device="cpu")
        outs = []
        for t in range(6):
            o, st = S.rglru_apply(cpu(p), cfg, x[:, t:t + 1], state=st)
            outs.append(o)
        close(torch.cat(outs, 1), full.numpy())

    def test_bf16_keeps_a_param_fp32_and_rounds_the_state(self):
        jcfg = dataclasses.replace(RGLRU, dtype="bfloat16")
        p = JS.rglru_init(jax.random.PRNGKey(14), jcfg)
        tp = cpu(p)
        assert tp["a_param"].dtype == torch.float32 and tp["conv_w"].dtype == torch.bfloat16
        rng = np.random.default_rng(14)
        st = {"h": normal(rng, 2, jcfg.rglru_dim),
              "conv": normal(rng, 2, jcfg.conv_width - 1, jcfg.rglru_dim)}
        x = normal(rng, 2, 1, jcfg.d_model)
        got, gs = S.rglru_apply(tp, tcfg_of(jcfg), torch.from_numpy(x).bfloat16(),
                                state={k: torch.from_numpy(v).bfloat16() for k, v in st.items()})
        want, ws = JS.rglru_apply(p, jcfg, jnp.asarray(x, jnp.bfloat16),
                                  state={k: jnp.asarray(v, jnp.bfloat16) for k, v in st.items()})
        assert got.dtype == gs["h"].dtype == gs["conv"].dtype == torch.bfloat16
        close(got, np.asarray(want.astype(jnp.float32)), BF16_TOL)
        close(gs["h"], np.asarray(ws["h"].astype(jnp.float32)), BF16_TOL)


# ------------------------------------------------------- inits and states


def layout(tree):
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in _flat(tree)}


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + "/")
        else:
            yield prefix + k, v


class TestInitsAndStates:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("which", ["rwkv", "rwkv_channel", "rglru"])
    def test_init_is_the_reference_layout(self, which, dtype):
        jcfg = dataclasses.replace(RGLRU if which == "rglru" else RWKV, dtype=dtype)
        want = jax.device_get(getattr(JS, which + "_init")(jax.random.PRNGKey(0), jcfg))
        gen = torch.Generator().manual_seed(0)
        got = getattr(S, which + "_init")(gen, tcfg_of(jcfg))
        assert layout(got) == layout(want)
        again = getattr(S, which + "_init")(torch.Generator().manual_seed(0), tcfg_of(jcfg))
        assert all(torch.equal(a, b) for (_, a), (_, b) in zip(_flat(got), _flat(again)))
        # the constant leaves are the reference's values
        for name, v in _flat(want):
            if name.startswith(("mu_", "w_bias", "conv_b", "a_param", "ln_x")):
                np.testing.assert_array_equal(dict(_flat(got))[name].float().numpy(),
                                              np.asarray(v, np.float32))

    @pytest.mark.parametrize("dtype", [None, "bfloat16"])
    @pytest.mark.parametrize("which", ["rwkv", "rglru"])
    def test_init_state(self, which, dtype):
        jcfg = RGLRU if which == "rglru" else RWKV
        want = jax.device_get(getattr(JS, which + "_init_state")(jcfg, 3, dtype))
        got = getattr(S, which + "_init_state")(tcfg_of(jcfg), 3, dtype, device="cpu")
        assert layout(got) == layout(want)
        assert all(bool((t == 0).all()) and t.device.type == "cpu" for t in got.values())

    def test_init_state_defaults_to_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        for make in (S.rwkv_init_state, S.rglru_init_state):
            with pytest.raises(RuntimeError, match="CUDA"):
                make(tcfg_of(RGLRU), 1)
