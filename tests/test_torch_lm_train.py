"""The port's LM training step (``repro_torch.train.train_step``) held
against the reference's (``repro.train.train_step``) on the CPU.

Weights are the reference's ``init_state`` carried over with
``params_from_numpy``; token batches are drawn with numpy from a seed.
The loss and its gradients are held against ``jax.value_and_grad`` of
the reference's loss; a whole ``make_train_step`` step (AdamW with a
schedule, clipping and weight decay) against the reference's jitted
step.  Tolerances:

* fp32: the loss within ``LOSS_TOL`` relative, every gradient within
  ``GRAD_ATOL`` + ``GRAD_RTOL`` (summation orders differ: 3.7e-6 at
  most on gradients up to 2 in the smoke configs);
* bf16: the loss within ``BF16_LOSS_TOL`` absolute, each leaf's
  gradient within ``BF16_GRAD_TOL`` of that leaf's largest reference
  gradient (bf16 keeps 8 significant bits, 2**-8 = 0.4%, and the two
  frameworks round activations at other points: 2% at most seen);
* a step's params sign-aware: AdamW's first step moves a parameter by
  about ``lr * sign(g)``, so where the reference's gradient clears the
  gradient tolerance the params agree within a rounding of the leaf's
  dtype, and elsewhere within ``2 * lr`` (a gradient that close to 0
  may take the other sign in the other package).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.train import train_step as JT
from repro.train.optimizer import adamw as j_adamw
from repro.train.optimizer import cosine_schedule as j_cosine
from repro_torch.core.convert import params_from_numpy
from repro_torch.core.model import _leaves
from repro_torch.models import ModelConfig
from repro_torch.train import train_step as TT
from repro_torch.train.optimizer import adamw, cosine_schedule

LOSS_TOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
BF16_LOSS_TOL = 5e-3
BF16_GRAD_TOL = 5e-2

#: (arch, dtype, remat, with patch_embeds) of the loss-and-gradient cases.
GRAD_CASES = [
    ("tinyllama-1.1b", "float32", "none", False),
    ("tinyllama-1.1b", "float32", "full", False),
    ("phi-3-vision-4.2b", "float32", "none", True),
    ("tinyllama-1.1b", "bfloat16", "none", False),
    ("rwkv6-7b", "float32", "none", False),
    ("recurrentgemma-2b", "float32", "full", False),
]
#: The same, with the microbatch count, for the whole-step cases.
STEP_CASES = [
    ("tinyllama-1.1b", "float32", "none", False, 1),
    ("tinyllama-1.1b", "float32", "full", False, 2),
    ("phi-3-vision-4.2b", "float32", "none", True, 2),
    ("tinyllama-1.1b", "bfloat16", "none", False, 1),
]
#: The registered archs whose blocks wait for ROADMAP item M12c.
UNPORTED_ARCHS = ("deepseek-v3-671b", "llama4-scout-17b-a16e", "seamless-m4t-medium")
BATCH, SEQ, PATCHES = 4, 16, 4
LR = 1e-2


def _ids(case):
    arch, dtype, remat, prefix, *mb = case
    return "-".join([arch, dtype, f"remat_{remat}"] + (["prefix"] if prefix else [])
                    + [f"mb{m}" for m in mb])


def jcfg_of(arch, dtype, remat):
    return dataclasses.replace(jconfigs.get_arch(arch).smoke, dtype=dtype, remat=remat)


def tcfg_of(jcfg):
    return ModelConfig(**dataclasses.asdict(jcfg))


def make_batch(jcfg, prefix, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (BATCH, SEQ)).astype(np.int32)}
    if prefix:
        batch["patch_embeds"] = rng.normal(size=(BATCH, PATCHES, jcfg.d_model)).astype(np.float32)
    return batch


def f32(a):
    """A leaf (jax array, torch tensor of any dtype) as fp32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, dtype=np.float32)


def carried(jtree):
    return params_from_numpy(jax.device_get(jtree), device="cpu")


def assert_grads_close(jgrads, tgrads, dtype):
    pairs = list(zip(jax.tree_util.tree_flatten_with_path(jgrads)[0], _leaves(tgrads),
                     strict=True))
    for (path, jg), tg in pairs:
        a, b = f32(jg), f32(tg)
        key = jax.tree_util.keystr(path)
        if dtype == "float32":
            np.testing.assert_allclose(b, a, rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=key)
        else:
            assert np.abs(b - a).max() <= BF16_GRAD_TOL * np.abs(a).max(), key


def grad_tol(a, dtype):
    """Per-element gradient tolerance of a reference gradient leaf."""
    if dtype == "float32":
        return GRAD_ATOL + GRAD_RTOL * np.abs(a)
    return np.full_like(a, BF16_GRAD_TOL * np.abs(a).max())


@pytest.fixture(scope="module")
def ref_run():
    """Per (arch, dtype, remat, prefix): the reference's state, the batch
    and ``jax.value_and_grad`` of its loss there (jit compiles are the
    slow part, so each case compiles once)."""
    cache = {}

    def get(arch, dtype, remat, prefix):
        key = (arch, dtype, remat, prefix)
        if key not in cache:
            jcfg = jcfg_of(arch, dtype, remat)
            opt = j_adamw(lr=j_cosine(LR, 10), max_grad_norm=1.0, weight_decay=0.01)
            state = JT.init_state(jcfg, opt, seed=0)
            batch = make_batch(jcfg, prefix)
            loss, grads = jax.jit(jax.value_and_grad(JT.make_loss_fn(jcfg)[0]))(
                state.params, {k: jnp.asarray(v) for k, v in batch.items()})
            cache[key] = (state, batch, loss, grads)
        return cache[key]

    return get


@pytest.mark.parametrize("case", GRAD_CASES, ids=[_ids(c) for c in GRAD_CASES])
def test_loss_and_grads_match_value_and_grad(case, ref_run):
    arch, dtype, remat, prefix = case
    jcfg = jcfg_of(arch, dtype, remat)
    jstate, batch, jl, jg = ref_run(*case)
    loss_fn, _ = TT.make_loss_fn(tcfg_of(jcfg))
    tl, tg = TT.value_and_grad(loss_fn, carried(jstate.params),
                               {k: torch.from_numpy(v) for k, v in batch.items()})
    assert tl.dtype == torch.float32 and tl.dim() == 0
    if dtype == "float32":
        assert float(tl) == pytest.approx(float(jl), rel=LOSS_TOL)
    else:
        assert abs(float(tl) - float(jl)) <= BF16_LOSS_TOL
    assert all(g.dtype == p.dtype for g, p in zip(_leaves(tg), _leaves(carried(jstate.params))))
    assert_grads_close(jg, tg, dtype)


@pytest.mark.parametrize("case", STEP_CASES, ids=[_ids(c) for c in STEP_CASES])
def test_train_step_matches_reference(case, ref_run):
    arch, dtype, remat, prefix, mb = case
    jcfg = jcfg_of(arch, dtype, remat)
    jstate, batch, jl, jg = ref_run(arch, dtype, remat, prefix)
    jopt = j_adamw(lr=j_cosine(LR, 10), max_grad_norm=1.0, weight_decay=0.01)
    jnew, jm = jax.jit(JT.make_train_step(jcfg, jopt, microbatches=mb))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})

    topt = adamw(lr=cosine_schedule(LR, 10), max_grad_norm=1.0, weight_decay=0.01)
    tparams = carried(jstate.params)
    tstate = TT.TrainState(tparams, topt.init(tparams))
    tnew, tm = TT.make_train_step(tcfg_of(jcfg), topt, microbatches=mb)(
        tstate, {k: torch.from_numpy(v) for k, v in batch.items()})

    tol = LOSS_TOL if dtype == "float32" else BF16_LOSS_TOL / float(jm["loss"])
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=tol)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=tol if dtype == "float32" else 0.02)
    if mb == 1:
        assert float(jm["loss"]) == float(jl)
    assert int(tnew.opt.step) == int(jnew.opt.step) == 1
    scale = min(1.0, 1.0 / (float(jm["grad_norm"]) + 1e-12))
    flat_j = jax.tree_util.tree_flatten_with_path(jnew.params)[0]
    for (path, jp), tp, p0, g, jmu, tmu in zip(
            flat_j, _leaves(tnew.params), _leaves(tparams), jax.tree.leaves(jg),
            jax.tree.leaves(jnew.opt.mu), _leaves(tnew.opt.mu), strict=True):
        key = jax.tree_util.keystr(path)
        assert tp.dtype == p0.dtype, key
        g = f32(g) * scale
        gt = grad_tol(g, dtype)
        # A rounding of the leaf's dtype at the parameter's magnitude,
        # before or after the step; in bf16 the moments' own roundings
        # also move mhat / sqrt(vhat) off 1 by a few 2**-8.
        bf16 = dtype == "bfloat16"
        ulp = np.maximum(np.abs(f32(p0)), np.abs(f32(jp))) * 2.0 ** (-7 if bf16 else -22)
        slack = LR * (2.0 ** -5 if bf16 else 1e-3)
        clear = np.abs(g) > 2 * gt
        diff = np.abs(f32(tp) - f32(jp))
        assert (diff[clear] <= 2 * ulp[clear] + slack).all(), key
        assert (diff <= 2 * LR + 2 * ulp + slack).all(), key
        # The first moment is 0.1 * the clipped gradient.
        np.testing.assert_allclose(f32(tmu), f32(jmu), rtol=0,
                                   atol=float((0.1 * gt).max()) + float(np.abs(f32(jmu)).max())
                                   * (2.0 ** -7 if dtype == "bfloat16" else 1e-6), err_msg=key)


@pytest.mark.parametrize("arch", UNPORTED_ARCHS)
def test_unported_blocks_raise_naming_m12c(arch):
    cfg = tcfg_of(jconfigs.get_arch(arch).smoke)
    opt = adamw(lr=1e-3)
    with pytest.raises(NotImplementedError, match="M12c"):
        TT.make_loss_fn(cfg)
    with pytest.raises(NotImplementedError, match="M12c"):
        TT.make_train_step(cfg, opt)
    with pytest.raises(NotImplementedError, match="M12c"):
        TT.init_state(cfg, opt, device="cpu")


def test_remat_full_gives_the_same_gradients_as_none():
    jcfg = jcfg_of("tinyllama-1.1b", "float32", "none")
    params = carried(JT.init_state(jcfg, j_adamw(), seed=3).params)
    batch = {"tokens": torch.from_numpy(make_batch(jcfg, False, seed=2)["tokens"])}
    out = {}
    for remat in ("none", "full"):
        loss_fn, _ = TT.make_loss_fn(tcfg_of(dataclasses.replace(jcfg, remat=remat)))
        out[remat] = TT.value_and_grad(loss_fn, params, batch)
    assert torch.equal(out["none"][0], out["full"][0])
    for a, b in zip(_leaves(out["none"][1]), _leaves(out["full"][1]), strict=True):
        assert torch.equal(a, b)


def test_train_step_makes_no_host_sync_in_its_metrics():
    jcfg = jcfg_of("tinyllama-1.1b", "float32", "none")
    opt = adamw(lr=cosine_schedule(LR, 10), max_grad_norm=1.0)
    state = TT.init_state(tcfg_of(jcfg), opt, seed=0, device="cpu")
    batch = {"tokens": torch.from_numpy(make_batch(jcfg, False)["tokens"])}
    new, metrics = TT.make_train_step(tcfg_of(jcfg), opt)(state, batch)
    assert all(isinstance(v, torch.Tensor) and v.dim() == 0 for v in metrics.values())
    assert isinstance(new, TT.TrainState) and int(new.opt.step) == 1
    assert all(not t.requires_grad for t in _leaves(new.params))
