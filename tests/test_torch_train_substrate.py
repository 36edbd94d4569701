"""The port's training substrate (``repro_torch.train``, ``data.tokens``,
``data.loader``, ``launch.train``) held against the reference's on the
CPU: every case of ``tests/test_train_substrate.py`` run on both
packages, plus checkpoints read across packages.

Tolerances: fp32 optimizer updates and schedules within 1e-6 relative
(the frameworks' ``pow``, ``cos`` and reductions may differ in the last
bit; a moment near 0 after cancellation, within 1e-6 of its leaf's
largest value); a bf16 AdamW update bit for bit (both round every moment op to
bf16 with bf16 constants, and the rest in fp32 the same way); int8
quantization exactly; the toy training runs' losses within 1e-6
relative; loaders, token stores and checkpoint arrays exactly.
"""

import functools
import gc
import json
import os
import weakref
import zipfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.hybrid import DeepMappingConfig as JDeepMappingConfig  # noqa: F401 — before kernels
from repro.data import loader as jloader
from repro.data import tokens as jtokens
from repro.train import checkpoint as jckpt
from repro.train import compression as jcomp
from repro.train import fault_tolerance as jft
from repro.train import optimizer as jopt
from repro.train import train_step as JT
from repro_torch.core import DeepMappingConfig
from repro_torch.core.convert import params_from_numpy
from repro_torch.core.model import _leaves
from repro_torch.core.trainer import TrainConfig
from repro_torch.data import loader as tloader
from repro_torch.data import tokens as ttokens
from repro_torch.launch import train as tlaunch
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import compression as tcomp
from repro_torch.train import fault_tolerance as tft
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as TT

RTOL = 1e-6


def t(x, dtype=torch.float32):
    return torch.tensor(x, dtype=dtype)


def np_of(x):
    """A jax array or torch tensor as a numpy array (bf16 as fp32)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.dtype == torch.bfloat16 else x.detach().numpy()
    return np.asarray(x, dtype=np.float32) if x.dtype == jnp.bfloat16 else np.asarray(x)


def bits(x):
    """A bf16 leaf's 16-bit patterns, from either package."""
    if isinstance(x, torch.Tensor):
        return x.detach().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def tree_arrays(seed, dtype):
    """A small tree (dicts and a list) of numpy leaves."""
    rng = np.random.default_rng(seed)
    tree = {"w": rng.normal(size=(5, 7)), "b": [rng.normal(size=(7,)), rng.normal(size=(3, 2))]}
    return jax.tree.map(lambda a: a.astype(np.float32), tree) if dtype == "float32" else tree


def as_jax(tree, dtype):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype=jnp.dtype(dtype)), tree)


def as_torch(tree, dtype):
    return params_from_numpy(jax.device_get(as_jax(tree, dtype)), device="cpu")


# ------------------------------------------------------------------ optimizer


class TestOptimizer:
    def test_adam_converges_quadratic(self):
        jp = {"x": jnp.asarray(5.0), "y": jnp.asarray(-3.0)}
        tp = {"x": t(5.0), "y": t(-3.0)}
        jo, to = jopt.adam_init(jp), topt.adam_init(tp)
        j_step = jax.jit(lambda p, o: jopt.adam_update(
            jax.grad(lambda q: q["x"] ** 2 + (q["y"] - 1) ** 2)(p), o, p, lr=0.05))
        for _ in range(300):
            jp, jo = j_step(jp, jo)
            tg = {"x": 2 * tp["x"], "y": 2 * (tp["y"] - 1)}
            tp, to = topt.adam_update(tg, to, tp, lr=0.05)
        assert abs(float(tp["x"])) < 0.05 and abs(float(tp["y"]) - 1) < 0.05
        for k in jp:
            assert float(tp[k]) == pytest.approx(float(jp[k]), rel=1e-5, abs=1e-6)
        assert int(to.step) == int(jo.step) == 300

    def test_weight_decay_shrinks(self):
        jp1, _ = jopt.adam_update({"w": jnp.zeros((4,))}, jopt.adam_init({"w": jnp.ones((4,))}),
                                  {"w": jnp.ones((4,))}, lr=0.1, weight_decay=0.1)
        tp1, _ = topt.adam_update({"w": torch.zeros(4)}, topt.adam_init({"w": torch.ones(4)}),
                                  {"w": torch.ones(4)}, lr=0.1, weight_decay=0.1)
        assert float(tp1["w"][0]) < 1.0
        np.testing.assert_allclose(tp1["w"].numpy(), np.asarray(jp1["w"]), rtol=RTOL)

    def test_clip_global_norm(self):
        jc, jn = jopt.clip_by_global_norm({"a": jnp.full((3,), 100.0)}, 1.0)
        tc, tn = topt.clip_by_global_norm({"a": torch.full((3,), 100.0)}, 1.0)
        cn = torch.sqrt(sum(torch.sum(x ** 2) for x in _leaves(tc)))
        assert float(cn) == pytest.approx(1.0, rel=1e-5)
        assert float(tn) > 100 and float(tn) == pytest.approx(float(jn), rel=RTOL)
        np.testing.assert_allclose(tc["a"].numpy(), np.asarray(jc["a"]), rtol=RTOL)

    @pytest.mark.parametrize("name,args", [
        ("exponential_decay", (1e-3, 0.999)),
        ("cosine_schedule", (1.0, 50)),
        ("cosine_schedule", (3e-3, 40, 0.2)),
        ("warmup_cosine", (1.0, 10, 50)),
        ("warmup_cosine", (3e-3, 10, 8)),
    ])
    def test_schedules_at_every_step(self, name, args):
        js, ts = getattr(jopt, name)(*args), getattr(topt, name)(*args)
        for step in range(61):
            got = ts(torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32 and got.dim() == 0
            want = float(js(jnp.asarray(step, jnp.int32)))
            assert float(got) == pytest.approx(want, rel=RTOL, abs=1e-12), step
        assert float(topt.warmup_cosine(1.0, 10, 100)(t(5, torch.int32))) == pytest.approx(0.5)

    def test_adamw_factory_with_clip(self):
        jnew, _ = jopt.adamw(lr=0.1, max_grad_norm=1.0).update(
            {"w": jnp.full((2,), 50.0)}, jopt.adam_init({"w": jnp.ones((2,))}),
            {"w": jnp.ones((2,))})
        o = topt.adamw(lr=0.1, max_grad_norm=1.0)
        params = {"w": torch.ones(2)}
        new, _ = o.update({"w": torch.full((2,), 50.0)}, o.init(params), params)
        assert float((params["w"] - new["w"]).abs().max()) <= 0.11
        np.testing.assert_allclose(new["w"].numpy(), np.asarray(jnew["w"]), rtol=RTOL)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("rule", ["adam", "adamw_decay", "adamw_clip_schedule"])
    def test_update_on_identical_trees(self, dtype, rule):
        """Three steps on carried params, each fed the same gradient tree:
        params and both moments within 1e-6 in fp32 (of the value, or of
        the leaf's largest value near 0), bit for bit in bf16."""
        if rule == "adam":
            j_rule = lambda g, s, p: jopt.adam_update(g, s, p, lr=1e-2)  # noqa: E731
            t_rule = lambda g, s, p: topt.adam_update(g, s, p, lr=1e-2)  # noqa: E731
        elif rule == "adamw_decay":
            j_rule = jopt.adamw(lr=1e-2, weight_decay=0.1).update
            t_rule = topt.adamw(lr=1e-2, weight_decay=0.1).update
        else:
            j_rule = jopt.adamw(lr=jopt.warmup_cosine(3e-2, 1, 5), max_grad_norm=1.0,
                                weight_decay=0.01).update
            t_rule = topt.adamw(lr=topt.warmup_cosine(3e-2, 1, 5), max_grad_norm=1.0,
                                weight_decay=0.01).update
        p0 = tree_arrays(0, dtype)
        jp, tp = as_jax(p0, dtype), as_torch(p0, dtype)
        js, ts = jopt.adam_init(jp), topt.adam_init(tp)
        for k in range(3):
            g = tree_arrays(10 + k, dtype)
            jp, js = j_rule(as_jax(g, dtype), js, jp)
            tp, ts = t_rule(as_torch(g, dtype), ts, tp)
            for jtree, ttree in ((jp, tp), (js.mu, ts.mu), (js.nu, ts.nu)):
                for a, b in zip(jax.tree.leaves(jtree), _leaves(ttree), strict=True):
                    assert b.dtype == getattr(torch, dtype)
                    if dtype == "bfloat16":
                        np.testing.assert_array_equal(bits(b), bits(a))
                    else:
                        a = np.asarray(a)
                        np.testing.assert_allclose(b.numpy(), a, rtol=RTOL,
                                                   atol=RTOL * np.abs(a).max())
            assert int(ts.step) == int(js.step) == k + 1

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_clip_on_identical_trees(self, dtype):
        g = jax.tree.map(lambda a: a * 3, tree_arrays(3, dtype))
        jc, jn = jopt.clip_by_global_norm(as_jax(g, dtype), 1.0)
        tc, tn = topt.clip_by_global_norm(as_torch(g, dtype), 1.0)
        assert tn.dtype == torch.float32
        assert float(tn) == pytest.approx(float(jn), rel=RTOL)
        for a, b in zip(jax.tree.leaves(jc), _leaves(tc), strict=True):
            if dtype == "bfloat16":
                np.testing.assert_array_equal(bits(b), bits(a))
            else:
                np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL)


# ------------------------------------------------------------------ checkpoints


def make_state():
    return {
        "params": {"w": np.arange(6, dtype=np.float32).reshape(2, 3)},
        "opt": {"mu": np.zeros((2, 3), np.float32), "step": np.asarray(7)},
    }


def make_torch_state():
    return {
        "params": {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)},
        "opt": {"mu": torch.zeros((2, 3)), "step": torch.tensor(7)},
    }


def npz_members(path):
    """{member name: raw bytes} of an ``arrays.npz``, in member order."""
    with zipfile.ZipFile(path) as zf:
        return {n: zf.read(n) for n in zf.namelist()}


@functools.lru_cache(maxsize=None)
def ref_train_state(dtype, seed=0):
    """The reference's TrainState of tinyllama's smoke config, its
    moments and step filled so that every leaf carries data."""
    cfg = jconfigs.get_arch("tinyllama-1.1b").smoke
    if dtype != cfg.dtype:
        import dataclasses

        cfg = dataclasses.replace(cfg, dtype=dtype)
    st = JT.init_state(cfg, jopt.adamw(), seed=seed)
    return st._replace(opt=st.opt._replace(
        step=jnp.asarray(7, jnp.int32),
        mu=jax.tree.map(lambda p: p * 0.5, st.params),
        nu=jax.tree.map(lambda p: p * p, st.params)))


def state_leaves(st):
    """A port TrainState's leaves in ``jax.tree.leaves`` order."""
    return [*_leaves(st.params), st.opt.step, *_leaves(st.opt.mu), *_leaves(st.opt.nu)]


def carried_state(jstate):
    host = jax.device_get(jstate)
    return TT.TrainState(
        params=params_from_numpy(host.params, device="cpu"),
        opt=topt.OptState(step=torch.tensor(int(host.opt.step), dtype=torch.int32),
                          mu=params_from_numpy(host.opt.mu, device="cpu"),
                          nu=params_from_numpy(host.opt.nu, device="cpu")))


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        state = make_torch_state()
        tckpt.save_checkpoint(str(tmp_path), 10, state)
        step, restored = tckpt.restore_latest(str(tmp_path), state)
        assert step == 10
        assert torch.equal(restored["params"]["w"], state["params"]["w"])
        assert restored["opt"]["step"].dtype == torch.int64

    def test_numpy_like_restores_tensors(self, tmp_path):
        state = make_state()
        tckpt.save_checkpoint(str(tmp_path), 10, state)
        step, restored = tckpt.restore_latest(str(tmp_path), state)
        assert step == 10
        np.testing.assert_array_equal(restored["params"]["w"].numpy(), state["params"]["w"])
        assert int(restored["opt"]["step"]) == 7

    def test_keep_k_prunes(self, tmp_path):
        for s in range(1, 6):
            tckpt.save_checkpoint(str(tmp_path), s, make_torch_state(), keep=2)
        assert tckpt.list_steps(str(tmp_path)) == [4, 5]

    def test_atomic_no_tmp_left(self, tmp_path):
        tckpt.save_checkpoint(str(tmp_path), 1, make_torch_state())
        assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))

    def test_restore_specific_step(self, tmp_path):
        state = make_torch_state()
        tckpt.save_checkpoint(str(tmp_path), 1, state, keep=5)
        state2 = make_torch_state()
        state2["params"]["w"] = state2["params"]["w"] + 100
        tckpt.save_checkpoint(str(tmp_path), 2, state2, keep=5)
        r1 = tckpt.restore_checkpoint(str(tmp_path), 1, state)
        assert float(r1["params"]["w"][0, 0]) == 0.0

    def test_restore_onto_device(self, tmp_path):
        """The reference's ``shardings=`` restore becomes ``device=``;
        ``elastic_restore`` goes through it."""
        state = make_torch_state()
        tckpt.save_checkpoint(str(tmp_path), 3, state)
        step, restored = tckpt.restore_latest(str(tmp_path), state, device="cpu")
        assert step == 3 and restored["params"]["w"].device.type == "cpu"
        assert torch.equal(restored["params"]["w"], state["params"]["w"])
        step, again = tft.elastic_restore(str(tmp_path), state, device="cpu")
        assert step == 3 and torch.equal(again["opt"]["mu"], state["opt"]["mu"])

    def test_async_checkpointer(self, tmp_path):
        saver = tckpt.AsyncCheckpointer(str(tmp_path), keep=2)
        for s in (10, 20, 30):
            saver.save(s, make_torch_state())
        saver.wait()
        assert tckpt.list_steps(str(tmp_path)) == [20, 30]

    def test_skeleton_restores_with_no_storage(self, tmp_path):
        """``skeleton`` gives a restore's ``like`` (meta tensors of each
        leaf's shape and dtype) and the state's one device."""
        state = make_torch_state()
        tckpt.save_checkpoint(str(tmp_path), 5, state)
        like, device = tckpt.skeleton(state)
        assert device == torch.device("cpu")
        metas = []
        tckpt._rebuild(like, lambda _k, leaf: metas.append(leaf))
        assert [m.is_meta for m in metas] == [True] * 3
        step, restored = tckpt.restore_latest(str(tmp_path), like, device)
        assert step == 5
        for key in ("w", "mu", "step"):
            got = restored["params" if key == "w" else "opt"][key]
            want = state["params" if key == "w" else "opt"][key]
            assert got.device == want.device and got.dtype == want.dtype
            assert torch.equal(got, want)
        with pytest.raises(ValueError, match="M12d"):
            tckpt.skeleton({"a": torch.zeros(2), "b": torch.zeros(2, device="meta")})

    def test_shape_mismatch_raises(self, tmp_path):
        tckpt.save_checkpoint(str(tmp_path), 1, make_torch_state())
        bad = make_torch_state()
        bad["params"]["w"] = torch.zeros((3, 3))
        with pytest.raises(ValueError, match="shape mismatch"):
            tckpt.restore_checkpoint(str(tmp_path), 1, bad)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_files_equal_the_references(self, tmp_path, dtype):
        """The same TrainState saved by each package: the manifest's
        arrays and step equal, the ``arrays.npz`` members (names, order,
        npy headers and data) byte for byte."""
        jstate = ref_train_state(dtype)
        jckpt.save_checkpoint(str(tmp_path / "j"), 5, jstate)
        tckpt.save_checkpoint(str(tmp_path / "t"), 5, carried_state(jstate))
        jdir, tdir = tmp_path / "j" / "step_00000005", tmp_path / "t" / "step_00000005"
        jm = json.loads((jdir / "manifest.json").read_text())
        tm = json.loads((tdir / "manifest.json").read_text())
        assert tm["arrays"] == jm["arrays"] and tm["step"] == jm["step"] == 5
        assert any(k.startswith(".params/") for k in tm["arrays"])
        assert {".opt/.step"} | {k for k in tm["arrays"] if k.startswith((".opt/.mu/",
                                                                           ".opt/.nu/"))} \
            == {k for k in tm["arrays"] if k.startswith(".opt/")}
        assert tm["arrays"][".params/embed/table"]["dtype"] == dtype
        jz, tz = npz_members(jdir / "arrays.npz"), npz_members(tdir / "arrays.npz")
        assert list(tz) == list(jz)
        for name in jz:
            assert tz[name] == jz[name], name
        assert (tmp_path / "t" / "LATEST").read_text() == "step_00000005"

    def test_each_package_restores_the_others_fp32_state(self, tmp_path):
        jstate = ref_train_state("float32")
        jckpt.save_checkpoint(str(tmp_path / "j"), 4, jstate)
        tlike = carried_state(ref_train_state("float32", seed=1))
        step, tgot = tckpt.restore_latest(str(tmp_path / "j"), tlike)
        assert step == 4 and isinstance(tgot, TT.TrainState)
        for a, b in zip(jax.tree.leaves(jstate), state_leaves(tgot), strict=True):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        tckpt.save_checkpoint(str(tmp_path / "t"), 9, tgot)
        jlike = jax.tree.map(np.asarray, ref_train_state("float32", seed=1))
        step, jgot = jckpt.restore_latest(str(tmp_path / "t"), jlike)
        assert step == 9
        for a, b in zip(jax.tree.leaves(jgot), jax.tree.leaves(jstate), strict=True):
            np.testing.assert_array_equal(a, np.asarray(b))

    def test_bf16_state_reference_raises_port_restores_bit_for_bit(self, tmp_path):
        """The reference writes a bf16 leaf as a raw ``V2`` record and
        cannot cast it back (``restore_checkpoint``'s ``astype``); the port
        restores the same file bit for bit from the manifest's dtype."""
        jstate = ref_train_state("bfloat16")
        jckpt.save_checkpoint(str(tmp_path), 3, jstate)
        with pytest.raises(ValueError):
            jckpt.restore_latest(str(tmp_path), jax.tree.map(np.asarray, jstate))
        step, tgot = tckpt.restore_latest(str(tmp_path), carried_state(ref_train_state(
            "bfloat16", seed=1)))
        assert step == 3
        n_bf16 = 0
        for a, b in zip(jax.tree.leaves(jstate), state_leaves(tgot), strict=True):
            if b.dtype == torch.bfloat16:
                n_bf16 += 1
                np.testing.assert_array_equal(bits(b), bits(a))
            else:
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        assert n_bf16 > 0

    def test_bf16_leaf_into_fp32_like(self, tmp_path):
        """A bf16 record restored into an fp32 leaf widens exactly."""
        x = torch.randn(4, 3).to(torch.bfloat16)
        tckpt.save_checkpoint(str(tmp_path), 1, {"x": x})
        with np.load(tmp_path / "step_00000001" / "arrays.npz") as z:
            assert z["x"].dtype == np.dtype("V2")
        _, got = tckpt.restore_latest(str(tmp_path), {"x": torch.zeros(4, 3)})
        assert got["x"].dtype == torch.float32 and torch.equal(got["x"], x.float())


# ------------------------------------------------------------------ fault tolerance


def j_toy_step(state, batch):
    w = state["w"] - 0.1 * (state["w"] - batch["target"])
    return {"w": w}, {"loss": float(jnp.mean((w - batch["target"]) ** 2))}


def t_toy_step(state, batch):
    w = state["w"] - 0.1 * (state["w"] - batch["target"])
    return {"w": w}, {"loss": float(torch.mean((w - batch["target"]) ** 2))}


def crash_once_at(step_at):
    crashed = {"done": False}

    def fail_at(step):
        if step == step_at and not crashed["done"]:
            crashed["done"] = True
            return True
        return False

    return fail_at


class TestFaultTolerance:
    @pytest.mark.parametrize("crash", [None, 13])
    @pytest.mark.parametrize("async_ckpt", [False, True])
    def test_run_report_equals_references(self, tmp_path, crash, async_ckpt):
        kw = dict(num_steps=20 if crash else 25, ckpt_every=5, async_ckpt=async_ckpt)
        jrep = jft.run_training(
            j_toy_step, {"w": jnp.asarray(10.0)}, lambda s: {"target": jnp.asarray(float(s % 3))},
            ckpt_dir=str(tmp_path / "j"), fail_at=crash and crash_once_at(crash), **kw)
        trep = tft.run_training(
            t_toy_step, {"w": t(10.0)}, lambda s: {"target": t(float(s % 3))},
            ckpt_dir=str(tmp_path / "t"), fail_at=crash and crash_once_at(crash), **kw)
        assert (trep.steps_run, trep.restarts, trep.final_step) == (
            jrep.steps_run, jrep.restarts, jrep.final_step)
        np.testing.assert_allclose(trep.losses, jrep.losses, rtol=RTOL)
        assert tckpt.list_steps(str(tmp_path / "t")) == jckpt.list_steps(str(tmp_path / "j"))
        if crash:
            # replayed steps 10-12 after restoring step-10 checkpoint
            assert trep.restarts == 1 and trep.final_step == 20 and trep.steps_run == 23
        else:
            assert trep.final_step == 25 and trep.restarts == 0

    @pytest.mark.parametrize("crash", [None, 3])
    def test_loop_keeps_no_copy_of_the_initial_state(self, tmp_path, crash):
        """Once the loop has stepped (or restored), nothing it keeps holds
        the state it was given: its restores read a skeleton."""
        initial = []

        def first_state():
            w = t(10.0)
            initial.append(weakref.ref(w))
            return {"w": w}

        alive = []

        def step(state, batch):
            gc.collect()
            alive.append(initial[0]() is not None)
            return t_toy_step(state, batch)

        rep = tft.run_training(step, first_state(), lambda s: {"target": t(float(s % 3))},
                               num_steps=6, ckpt_dir=str(tmp_path), ckpt_every=2,
                               fail_at=crash and crash_once_at(crash))
        assert rep.final_step == 6 and rep.restarts == (1 if crash else 0)
        assert alive == [True] + [False] * (len(alive) - 1)

    def test_too_many_failures_raises(self, tmp_path):
        with pytest.raises(RuntimeError):
            tft.run_training(
                t_toy_step, {"w": t(0.0)}, lambda s: {"target": t(float(s % 3))},
                num_steps=5, ckpt_dir=str(tmp_path), fail_at=lambda s: True, max_restarts=2,
                async_ckpt=False)

    def test_watchdog_flags_straggler(self):
        times = [0.1] * 8 + [0.5, 0.1, 0.31]
        jwd, twd = jft.StepWatchdog(factor=2.0, window=10), tft.StepWatchdog(factor=2.0, window=10)
        for i, dt in enumerate(times):
            jev, tev = jwd.observe(i, dt), twd.observe(i, dt)
            assert (tev is None) == (jev is None)
        assert [(e.step, e.step_time, e.median) for e in twd.events] == [
            (e.step, e.step_time, e.median) for e in jwd.events]
        assert twd.events[0].step == 8


# ------------------------------------------------------------------ compression


class TestCompression:
    @pytest.mark.parametrize("scale", [1.0, 1e-3, 0.0])
    def test_quantize_equals_reference(self, scale):
        x = (np.random.default_rng(0).normal(size=(128,)) * scale).astype(np.float32)
        jq, js = jcomp.quantize_int8(jnp.asarray(x))
        tq, ts = tcomp.quantize_int8(torch.from_numpy(x))
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert float(ts) == float(js)
        err = (tcomp.dequantize_int8(tq, ts) - torch.from_numpy(x)).abs().max()
        assert float(err) <= float(ts) * 0.5 + 1e-6

    def test_compress_grads_equals_reference_and_keeps_the_sum(self):
        """Five rounds of error feedback: q and scale equal exactly, the
        residuals equal, and transmitted + residual == accumulated intent."""
        rng = np.random.default_rng(1)
        shapes = {"w": (64,), "b": [(3, 5)]}
        first = jax.tree.map(lambda s: rng.normal(size=s).astype(np.float32), shapes,
                             is_leaf=lambda s: isinstance(s, tuple))
        jef, tef = jcomp.ef_init(as_jax(first, "float32")), tcomp.ef_init(as_torch(first, "float32"))
        sent = torch.zeros(64)
        true = torch.zeros(64)
        for _ in range(5):
            g = jax.tree.map(lambda s: rng.normal(size=s).astype(np.float32), shapes,
                             is_leaf=lambda s: isinstance(s, tuple))
            jc, jef = jcomp.compress_grads(as_jax(g, "float32"), jef)
            tc, tef = tcomp.compress_grads(as_torch(g, "float32"), tef)
            for (jq, js), (tq, ts) in zip(
                    jax.tree.leaves(jc, is_leaf=lambda x: isinstance(x, tuple)),
                    [tc["b"][0], tc["w"]], strict=True):
                np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
                assert float(ts) == float(js)
            for a, b in zip(jax.tree.leaves(jef.residual), _leaves(tef.residual), strict=True):
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))
            true = true + torch.from_numpy(g["w"])
            sent = sent + tcomp.decompress_grads(tc)["w"]
        np.testing.assert_allclose((sent + tef.residual["w"]).numpy(), true.numpy(),
                                   rtol=1e-4, atol=1e-4)

    def test_compression_ratio_is_4x(self):
        g = {"w": torch.zeros(1024)}
        compressed, _ = tcomp.compress_grads(g, tcomp.ef_init(g))
        q, s = compressed["w"]
        assert q.dtype == torch.int8 and q.numel() * q.element_size() == 1024


# ------------------------------------------------------------------ loader, token store


def loader_pair(cfg_kw, tokens):
    return (jloader.TokenBatchLoader(jloader.LoaderConfig(**cfg_kw), tokens=tokens),
            tloader.TokenBatchLoader(tloader.LoaderConfig(**cfg_kw), tokens=tokens))


class TestLoader:
    @pytest.mark.parametrize("cfg_kw", [
        dict(global_batch=8, seq_len=32, seed=3),
        dict(global_batch=8, seq_len=16, seed=0, process_index=1, process_count=2),
        dict(global_batch=9, seq_len=5, seed=7, process_index=2, process_count=3),
    ])
    def test_batch_for_step_equals_reference(self, cfg_kw):
        toks = np.arange(10_000, dtype=np.int32) % 777
        jl, tl = loader_pair(cfg_kw, toks)
        for step in (0, 1, 7, 1000):
            got, want = tl.batch_for_step(step), jl.batch_for_step(step)
            assert got.keys() == want.keys() == {"tokens"}
            assert got["tokens"].dtype == want["tokens"].dtype == np.int32
            np.testing.assert_array_equal(got["tokens"], want["tokens"])
            np.testing.assert_array_equal(tl.batch_for_step(step)["tokens"], got["tokens"])

    def test_process_sharding_partitions_batch(self):
        toks = np.arange(10_000, dtype=np.int32)
        full = tloader.TokenBatchLoader(tloader.LoaderConfig(8, 16, seed=0),
                                        tokens=toks).batch_for_step(0)["tokens"]
        parts = [tloader.TokenBatchLoader(tloader.LoaderConfig(8, 16, 0, i, 2),
                                          tokens=toks).batch_for_step(0)["tokens"]
                 for i in range(2)]
        recombined = np.empty_like(full)
        recombined[0::2], recombined[1::2] = parts
        np.testing.assert_array_equal(recombined, full)

    def test_refuses_bad_sources(self):
        with pytest.raises(ValueError, match="exactly one"):
            tloader.TokenBatchLoader(tloader.LoaderConfig(2, 4))
        with pytest.raises(ValueError, match="shorter"):
            tloader.TokenBatchLoader(tloader.LoaderConfig(2, 10), tokens=np.arange(8))


class TestTokenStore:
    def test_structured_tokens_equal_reference(self):
        for args in ((4000, 64, 16, 0), (2000, 32, 8, 1), (200_000, 32_000, 8, 0)):
            np.testing.assert_array_equal(ttokens.make_structured_tokens(*args),
                                          jtokens.make_structured_tokens(*args))
        # A length that is not a multiple of run_len fails alike in both.
        for make in (ttokens.make_structured_tokens, jtokens.make_structured_tokens):
            with pytest.raises(IndexError):
                make(2001, 32, 8, 1)

    def test_lossless_roundtrip(self):
        toks = ttokens.make_structured_tokens(4000, vocab=64, run_len=16, seed=0)
        store = ttokens.DeepMappingTokenStore.build(
            toks, DeepMappingConfig(shared=(64,), private=(16,),
                                    train=TrainConfig(epochs=20, batch_size=1024)),
            device="cpu")
        assert store.num_tokens == 4000 and store.store.device.type == "cpu"
        got = store.get(np.arange(4000))
        np.testing.assert_array_equal(got.astype(np.int32), toks)
        batch = store.get_batch(np.array([0, 100]), seq_len=32)
        assert batch.dtype == np.int32
        np.testing.assert_array_equal(batch[0], toks[:32])
        np.testing.assert_array_equal(batch[1], toks[100:132])
        assert store.lookups == 2
        assert 0 < store.compression_ratio() and store.size_bytes() > 0
        assert 0 <= store.memorized_fraction() <= 1
        with pytest.raises(KeyError):
            store.get(np.array([4000]))

    def test_feeds_loader(self):
        toks = ttokens.make_structured_tokens(2000, vocab=32, run_len=8, seed=1)
        store = ttokens.DeepMappingTokenStore.build(
            toks, DeepMappingConfig(shared=(32,), private=(),
                                    train=TrainConfig(epochs=10, batch_size=512)),
            device="cpu")
        cfg = dict(global_batch=4, seq_len=64, seed=0)
        via_store = tloader.TokenBatchLoader(tloader.LoaderConfig(**cfg), store=store)
        jl, tl = loader_pair(cfg, toks)
        for step in range(3):
            want = jl.batch_for_step(step)["tokens"]
            np.testing.assert_array_equal(via_store.batch_for_step(step)["tokens"], want)
            np.testing.assert_array_equal(tl.batch_for_step(step)["tokens"], want)


# ------------------------------------------------------------------ launcher


class TestLauncher:
    def test_trains_and_resumes_from_latest(self, tmp_path, capsys):
        argv = ["--smoke", "--device", "cpu", "--ckpt-dir", str(tmp_path), "--ckpt-every", "3"]
        report, store = tlaunch.main(argv + ["--steps", "4"])
        out = capsys.readouterr().out.splitlines()
        assert store is None
        assert (report.final_step, report.steps_run, report.restarts) == (4, 4, 0)
        assert all(np.isfinite(report.losses))
        assert out[-2].startswith("arch=tinyllama-1.1b steps=4 restarts=0 stragglers=")
        assert out[-1] == f"loss {report.losses[0]:.4f} -> {report.losses[-1]:.4f}"
        assert tckpt.list_steps(str(tmp_path)) == [3, 4]
        report2, _ = tlaunch.main(argv + ["--steps", "7"])
        assert (report2.final_step, report2.steps_run, report2.restarts) == (7, 3, 0)
        assert tckpt.list_steps(str(tmp_path)) == [4, 6, 7]

    def test_default_ckpt_dir_is_the_checkouts_build(self, tmp_path, monkeypatch):
        assert tlaunch._BUILD == Path(__file__).resolve().parents[1] / "build"
        monkeypatch.setattr(tlaunch, "_BUILD", tmp_path / "build")
        report, _ = tlaunch.main(["--smoke", "--device", "cpu", "--steps", "2"])
        assert report.final_step == 2
        assert tckpt.list_steps(str(tmp_path / "build" / "ckpt" / "tinyllama-1.1b-smoke")) == [2]

    def test_mesh_flags_raise_naming_m12d(self, tmp_path):
        for flag in ("--data-mesh", "--model-mesh"):
            with pytest.raises(NotImplementedError, match="M12d"):
                tlaunch.main(["--smoke", "--device", "cpu", flag, "2", "--ckpt-dir",
                              str(tmp_path)])

    def test_refuses_non_text_archs(self, tmp_path):
        with pytest.raises(SystemExit):
            tlaunch.main(["--arch", "phi-3-vision-4.2b", "--smoke", "--device", "cpu",
                          "--ckpt-dir", str(tmp_path)])

    def test_defaults_to_cuda(self, tmp_path, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            tlaunch.main(["--smoke", "--steps", "1", "--ckpt-dir", str(tmp_path)])
