"""The port's MHAS search (``repro_torch.core.mhas.search``) and the
paper's configs (``repro_torch.configs.deepmapping_paper``) on the CPU,
held against the reference (``repro.core.mhas.search``,
``repro.configs.deepmapping_paper``).

``jax.random`` and ``torch.Generator`` draw different numbers from one
seed, so each cross-package case starts from weights carried over with
``params_from_numpy`` (a numpy bank, or the reference's own initial bank
and controller) and from numpy-made tables, codes, token sequences and
advantages; ``run_mhas`` is compared under a scripted ``sample_arch``
(the same token sequences in both packages, one per call), which leaves
its numpy batch draws equal.  Tolerances:

* ``_RewardModel`` exactly: it is host arithmetic on the same bytes;
* losses ``rtol=1e-5`` (``SCORE_RTOL``), gradients ``rtol=1e-4,
  atol=1e-6``: the frameworks sum in different orders;
* error rates equal but for the rows whose top-two logit margin (the
  reference's) is under ``MARGIN_TOL``;
* after one Adam step, the first moments within the gradients'
  tolerance times ``1 - b1``, the second moments within what that
  tolerance allows for a square; the weights within ``lr * 1e-3`` where
  the reference's gradient is clear of zero (above ``10 * GRAD_ATOL``,
  so both gradients have its sign), and within ``2 * lr`` elsewhere:
  Adam's first step moves a weight by ``lr * g / (|g| + eps)``, about
  ``lr`` whatever the gradient's size, so a near-zero gradient whose sign
  differs moves the two weights ``2 * lr`` apart;
* the fine-tune's epoch losses ``rtol=1e-4``, as the trainer's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (before repro.kernels: the reference's import order)
from repro.configs import deepmapping_paper as jpaper
from repro.core import DeepMappingConfig as JConfig
from repro.core.encoding import KeyEncoder as JEncoder
from repro.core.encoding import build_codecs as j_build_codecs
from repro.core.mhas import MHASConfig as JMHASConfig
from repro.core.mhas import SearchSpace as JSpace
from repro.core.mhas import controller as jctrl
from repro.core.mhas import search as jsearch
from repro.core.trainer import TrainConfig as JTrainConfig
from repro.data import orders_like as j_orders_like
from repro.data import synthetic_multi_column as j_synthetic
from repro.train.optimizer import adam_init as j_adam_init
from repro.train.optimizer import adam_update as j_adam_update
from repro_torch.configs import deepmapping_paper as paper
from repro_torch.core import DeepMappingConfig, DeepMappingStore, TrainConfig
from repro_torch.core import trainer as trainer_lib
from repro_torch.core.convert import params_from_numpy, params_to_numpy
from repro_torch.core.encoding import KeyEncoder, build_codecs
from repro_torch.core.mhas import MHASConfig, MHASResult, SearchSpace, run_mhas
from repro_torch.core.mhas import controller as ctrl
from repro_torch.core.mhas import search
from repro_torch.data import orders_like, synthetic_multi_column
from repro_torch.train.optimizer import adam_init
from test_torch_mhas import (
    ARCHS,
    GRAD_ATOL,
    GRAD_RTOL,
    SCORE_RTOL,
    SMALL,
    assert_arch_equal,
    features,
    no_host_copies,
    np_bank,
    np_leaves,
    token_sequences,
    torch_leaves,
    with_grad,
)
from torch_port_util import MARGIN_TOL

#: The epoch losses of the fine-tune, as the trainer's hold.
LOSS_RTOL = 1e-4
#: Where a reference gradient counts as clear of zero.
CLEAR_GRAD = 10 * GRAD_ATOL


def table_pair(kind):
    """The same numpy-made table in both packages."""
    if kind == "orders":
        return j_orders_like(n=2000, seed=3), orders_like(n=2000, seed=3)
    kw = dict(n=2000, correlation="high", cardinalities=(3, 4), seed=0)
    return j_synthetic(**kw), synthetic_multi_column(**kw)


def spaces_of(jtable, table, cfg):
    """Both packages' search spaces and code matrices for ``table``, as
    ``run_mhas`` makes them."""
    out = []
    for enc_cls, codecs_fn, space_cls, t in ((JEncoder, j_build_codecs, JSpace, jtable),
                                             (KeyEncoder, build_codecs, SearchSpace, table)):
        enc = enc_cls(t.max_key, base=cfg.base)
        codecs = codecs_fn(t.columns)
        tasks = tuple(sorted(t.columns))
        space = space_cls(base=cfg.base, width=enc.width, tasks=tasks,
                          out_cards=tuple(codecs[c].cardinality for c in tasks),
                          layer_sizes=cfg.layer_sizes, max_layers=cfg.max_layers)
        out += [space, np.stack([codecs[c].codes for c in tasks], axis=1)]
    return out


def step_pair(jleaves, leaves, grads_j, lr):
    """Hold one Adam step's weights: ``lr * 1e-3`` where the reference's
    gradient is clear of zero, ``2 * lr`` elsewhere (see the module
    docstring)."""
    for (path, jw), w, g in zip(jleaves, leaves, grads_j):
        diff = np.abs(w.numpy() - np.asarray(jw))
        clear = np.abs(g) > CLEAR_GRAD
        assert (diff[clear] <= lr * 1e-3).all(), (path, diff[clear].max())
        assert (diff <= 2 * lr * (1 + 1e-5)).all(), (path, diff.max())


def moments_pair(opt, jopt, grads_j, b1=0.9, b2=0.999):
    """The moments of a first Adam step within the gradients' tolerance."""
    assert int(opt.step) == int(jopt.step) == 1
    for m, (path, jm) in zip(torch_leaves(opt.mu), np_leaves(jax.device_get(jopt.mu))):
        np.testing.assert_allclose(m.numpy(), jm, rtol=GRAD_RTOL,
                                   atol=(1 - b1) * GRAD_ATOL, err_msg=str(path))
    for v, (path, jv), g in zip(torch_leaves(opt.nu), np_leaves(jax.device_get(jopt.nu)),
                                grads_j):
        # |g1^2 - g2^2| <= |g1 - g2| (|g1| + |g2|), with |g1 - g2| within
        # the gradients' tolerance.
        d = GRAD_ATOL + GRAD_RTOL * np.abs(g)
        np.testing.assert_array_less(np.abs(v.numpy() - jv),
                                     (1 - b2) * d * (2 * np.abs(g) + d) * (1 + 1e-5) + 1e-30,
                                     err_msg=str(path))


# ---------------------------------------------------------------- reward
class TestRewardModel:
    @pytest.mark.parametrize("kind", ["synthetic", "orders"])
    def test_reward_model_equals_reference(self, kind):
        jtable, table = table_pair(kind)
        cfg, jcfg = MHASConfig(layer_sizes=(8, 16, 32)), JMHASConfig(layer_sizes=(8, 16, 32))
        jspace, jcodes, space, codes = spaces_of(jtable, table, cfg)
        np.testing.assert_array_equal(codes, jcodes)
        rm, jrm = search._RewardModel(space, table, codes, cfg), \
            jsearch._RewardModel(jspace, jtable, jcodes, jcfg)
        for f in ("raw_bytes", "n", "row_bytes", "const_bytes", "aux_factor"):
            assert getattr(rm, f) == getattr(jrm, f), f
        rng = np.random.default_rng(1)
        d = space.num_decisions
        seqs = [np.full(d, 2), np.zeros(d, dtype=int)] + [rng.integers(0, 3, size=d)
                                                          for _ in range(6)]
        for seq in seqs:
            arch, jarch = space.tokens_to_arch(seq), jspace.tokens_to_arch(seq)
            for err in (0.0, 1 / 2048, 0.013, 0.5, 1.0):
                assert rm.ratio(arch, err) == jrm.ratio(jarch, err)


# ------------------------------------------------- child loss, errors, steps
@pytest.fixture(scope="module")
def child_inputs():
    """A numpy bank of the small space carried into both packages, 257
    rows' digits, both packages' padded one-hots, and codes."""
    space, jspace = SearchSpace(**SMALL), JSpace(**SMALL)
    bank = np_bank(space, seed=11)
    digits, t_oh, j_oh = features(space, 257, seed=11)
    rng = np.random.default_rng(11)
    codes = np.stack([rng.integers(0, c, size=digits.shape[0]) for c in space.out_cards],
                     axis=1).astype(np.int32)
    return space, jspace, bank, t_oh, j_oh, codes


class TestChildFunctions:
    @pytest.mark.parametrize("name", list(ARCHS))
    def test_child_loss_and_errors(self, child_inputs, name):
        space, jspace, bank, t_oh, j_oh, codes = child_inputs
        arch, jarch = space.tokens_to_arch(ARCHS[name]), jspace.tokens_to_arch(ARCHS[name])
        aa, jaa = space.arch_arrays(arch, device="cpu"), jspace.arch_arrays(jarch)
        tbank, jbank = params_from_numpy(bank, "cpu"), jax.tree.map(jnp.asarray, bank)
        loss = search._child_loss(tbank, t_oh, torch.from_numpy(codes), aa, space)
        jloss = jsearch._child_loss(jbank, j_oh, jnp.asarray(codes), jaa, jspace)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=SCORE_RTOL)
        err = search._child_errors(tbank, t_oh, torch.from_numpy(codes), aa, space)
        jerr = jsearch._child_errors(jbank, j_oh, jnp.asarray(codes), jaa, jspace)
        assert err.dtype == torch.float32 and err.shape == ()
        # Rows where a task's top-two margin is under MARGIN_TOL may go
        # either way; every other row counts alike.
        logits = jspace.forward(jbank, j_oh, jaa)
        near = np.zeros(codes.shape[0], dtype=bool)
        for t in space.tasks:
            top = np.sort(np.asarray(logits[t]), axis=1)[:, -2:]
            near |= (top[:, 1] - top[:, 0]) < MARGIN_TOL
        n = codes.shape[0]
        assert abs(round(float(err) * n) - round(float(jerr) * n)) <= near.sum()
        if not near.any():
            assert float(err) == float(jerr)

    @pytest.mark.parametrize("name", ["full", "mixed a", "mixed b", "trunk 0, heads 2 x 32"])
    def test_one_bank_step(self, child_inputs, name):
        space, jspace, bank, t_oh, j_oh, codes = child_inputs
        arch, jarch = space.tokens_to_arch(ARCHS[name]), jspace.tokens_to_arch(ARCHS[name])
        aa, jaa = space.arch_arrays(arch, device="cpu"), jspace.arch_arrays(jarch)
        lr = 1e-3
        # The gradients, each package through its own _child_loss.
        tbank, leaves = with_grad(params_from_numpy(bank, "cpu"))
        grads = torch.autograd.grad(
            search._child_loss(tbank, t_oh, torch.from_numpy(codes), aa, space), leaves)
        jgrads = jax.grad(jsearch._child_loss)(jax.tree.map(jnp.asarray, bank), j_oh,
                                               jnp.asarray(codes), jaa, jspace)
        jg = [np.asarray(g) for _, g in np_leaves(jax.device_get(jgrads))]
        for g, (path, want) in zip(grads, np_leaves(jax.device_get(jgrads))):
            np.testing.assert_allclose(g.numpy(), want, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                       err_msg=str(path))
        # One step each; the reference's donates its inputs, so it gets
        # fresh copies.
        tbank = params_from_numpy(bank, "cpu")
        new, opt, loss = search._bank_step(tbank, adam_init(tbank), t_oh,
                                           torch.from_numpy(codes), aa, space, lr)
        jb = jax.tree.map(jnp.array, bank)
        jnew, jopt, jloss = jsearch._bank_step(jb, j_adam_init(jb), j_oh, jnp.asarray(codes),
                                               jaa, jspace, lr)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=SCORE_RTOL)
        assert not loss.requires_grad
        moments_pair(opt, jopt, jg)
        step_pair(np_leaves(jax.device_get(jnew)), torch_leaves(new), jg, lr)
        # The step leaves the bank it was given as it was.
        for a, (_, b) in zip(torch_leaves(tbank), np_leaves(bank)):
            assert a.numpy().tobytes() == b.tobytes()

    def test_bank_step_and_errors_need_no_host_sync(self, child_inputs):
        space, _, bank, t_oh, _, codes = child_inputs
        tbank = params_from_numpy(bank, "cpu")
        aa = space.arch_arrays(space.tokens_to_arch(ARCHS["mixed c"]), device="cpu")
        c = torch.from_numpy(codes)
        with no_host_copies():
            new, opt, loss = search._bank_step(tbank, adam_init(tbank), t_oh, c, aa, space,
                                               1e-3)
            err = search._child_errors(new, t_oh, c, aa, space)
        assert loss.shape == err.shape == ()


class TestControllerUpdate:
    @pytest.mark.parametrize("layer_sizes", [(8, 16, 32), (100, 200, 400, 800, 1200, 1600,
                                                           2000)], ids=["small", "paper"])
    def test_one_update_equals_reference_lines(self, layer_sizes):
        kw = dict(SMALL, layer_sizes=layer_sizes)
        space, jspace = SearchSpace(**kw), JSpace(**kw)
        cspec, jcspec = ctrl.ControllerSpec.for_space(space), jctrl.ControllerSpec.for_space(jspace)
        p = jax.device_get(jctrl.init_controller(jcspec, seed=4))
        seqs = token_sequences(cspec, n=8, seed=4)
        adv = np.random.default_rng(4).normal(0, 0.05, size=seqs.shape[0]).astype(np.float32)
        lr, coef = 3.5e-4, 1e-3

        # The reference's ctrl_update (search.py:178-189), composed here.
        def j_loss(cp, tokens_batch, advantages):
            total = 0.0
            for tokens, a in zip(tokens_batch, advantages):
                logp, ent = jctrl.logprob_of(cp, jcspec, tokens)
                total = total - a * logp - coef * ent
            return total / len(tokens_batch)

        jp = jax.tree.map(jnp.asarray, p)
        jloss, jgrads = jax.value_and_grad(j_loss)(jp, jnp.asarray(seqs), jnp.asarray(adv))
        jnew, jopt = j_adam_update(jgrads, j_adam_init(jp), jp, lr=lr)

        cp = params_from_numpy(p, "cpu")
        new, opt, loss = search._controller_update(cp, adam_init(cp), cspec,
                                                   torch.from_numpy(seqs), torch.from_numpy(adv),
                                                   lr, coef)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=SCORE_RTOL)
        jg = [np.asarray(g) for _, g in np_leaves(jax.device_get(jgrads))]
        moments_pair(opt, jopt, jg)
        step_pair(np_leaves(jax.device_get(jnew)), torch_leaves(new), jg, lr)


# ------------------------------------------------------- run_mhas scripted
#: Token sequences of a two-task space with layer sizes (8, 16): child
#: sizes far apart, so that Eq. 1's model term orders them.
SCRIPT = [
    [2, 1, 1, 2, 1, 1, 2, 1, 1],   # everything at depth 2, width 16
    [1, 0, 0, 1, 0, 0, 0, 0, 0],   # trunk 8, head a 8, head b depth 0
    [0, 0, 0, 0, 0, 0, 0, 0, 0],   # every layer a gather: the smallest
    [2, 0, 1, 0, 0, 0, 2, 1, 1],
]


@pytest.fixture
def scripted(monkeypatch):
    """``sample_arch`` in both controller modules replaced by SCRIPT, one
    sequence a call in turn; each package's fine-tune losses recorded;
    the port's initial bank and controller taken from the reference's
    (carried as numpy), which the reference's run records."""
    calls = {"j": 0, "t": 0}
    seen: dict = {"j_finetune": [], "t_finetune": []}

    def j_sample(params, spec, rng):
        seq = SCRIPT[calls["j"] % len(SCRIPT)]
        calls["j"] += 1
        return jnp.asarray(seq, jnp.int32), jnp.float32(0), jnp.float32(0)

    def t_sample(params, spec, generator):
        seq = SCRIPT[calls["t"] % len(SCRIPT)]
        calls["t"] += 1
        return torch.tensor(seq, dtype=torch.int32), torch.tensor(0.0), torch.tensor(0.0)

    j_init_bank, j_init_ctrl = JSpace.init_bank, jctrl.init_controller

    def j_bank(self, seed=0, dtype=jnp.float32):
        seen["bank"] = jax.device_get(j_init_bank(self, seed=seed, dtype=dtype))
        return jax.tree.map(jnp.asarray, seen["bank"])

    def j_controller(spec, seed=0):
        seen["controller"] = jax.device_get(j_init_ctrl(spec, seed=seed))
        return jax.tree.map(jnp.asarray, seen["controller"])

    def t_bank(self, seed=0, dtype=torch.float32, device=None):
        return params_from_numpy(seen["bank"], device)

    def t_controller(spec, seed=0, device=None):
        return params_from_numpy(seen["controller"], device)

    j_train, t_train = jsearch.trainer_lib.train, trainer_lib.train

    def j_finetune(*a, **kw):
        out = j_train(*a, **kw)
        seen["j_finetune"].append(out[2])
        return out

    def t_finetune(*a, **kw):
        out = t_train(*a, **kw)
        seen["t_finetune"].append(out[2])
        return out

    monkeypatch.setattr(jctrl, "sample_arch", j_sample)
    monkeypatch.setattr(ctrl, "sample_arch", t_sample)
    monkeypatch.setattr(JSpace, "init_bank", j_bank)
    monkeypatch.setattr(jctrl, "init_controller", j_controller)
    monkeypatch.setattr(SearchSpace, "init_bank", t_bank)
    monkeypatch.setattr(ctrl, "init_controller", t_controller)
    monkeypatch.setattr(jsearch.trainer_lib, "train", j_finetune)
    monkeypatch.setattr(trainer_lib, "train", t_finetune)
    return calls, seen


def run_both(cfg_kw, kind="synthetic"):
    """The reference's run_mhas, then the port's, on one table."""
    jtable, table = table_pair(kind)
    jres = jsearch.run_mhas(jtable, JMHASConfig(**cfg_kw))
    res = run_mhas(table, MHASConfig(**cfg_kw), device="cpu")
    return jres, res


def assert_same_search(res, jres):
    assert isinstance(res, MHASResult)
    assert len(res.history) == len(jres.history)
    for h, jh in zip(res.history, jres.history):
        assert h["iter"] == jh["iter"] and h["child_params"] == jh["child_params"]
    assert_arch_equal(res.best_arch, jres.best_arch)
    for f in ("base", "width", "shared", "private", "out_cards", "dtype"):
        assert getattr(res.spec, f) == getattr(jres.spec, f), f
    assert res.spec == res.space.child_spec(res.best_arch)


class TestRunMHASScripted:
    CFG = dict(layer_sizes=(8, 16), total_iters=6, model_iters=6, controller_iters=2,
               model_epochs_per_iter=2, model_batch=512, controller_batch=512,
               controller_samples=3, finetune_epochs=4)

    def test_search_equals_reference(self, scripted, monkeypatch):
        calls, seen = scripted
        # Each scored sample's near-tie rows, from the reference's logits.
        near_rows = []
        j_errors = jsearch._child_errors

        def j_errors_noting_ties(bank, onehot_pad, codes, aa, space):
            logits = space.forward(bank, onehot_pad, aa)
            near = np.zeros(onehot_pad.shape[0], dtype=bool)
            for t in space.tasks:
                top = np.sort(np.asarray(logits[t]), axis=1)[:, -2:]
                near |= (top[:, 1] - top[:, 0]) < MARGIN_TOL
            near_rows.append(int(near.sum()))
            return j_errors(bank, onehot_pad, codes, aa, space=space)

        monkeypatch.setattr(jsearch, "_child_errors", j_errors_noting_ties)
        jres, res = run_both(self.CFG)
        # 6 model iterations, 2 controller updates of 3 samples.
        assert len(jres.history) == 6 + 2 * 3
        assert calls["j"] == calls["t"] == len(jres.history)
        assert_same_search(res, jres)
        rbs = self.CFG["controller_batch"]
        for h, jh, near in zip(res.history, jres.history, near_rows):
            assert abs(round(h["err"] * rbs) - round(jh["err"] * rbs)) <= near
            if h["err"] == jh["err"]:
                assert h["ratio"] == jh["ratio"]
        assert res.best_ratio == min(h["ratio"] for h in res.history)
        assert jres.best_ratio == min(h["ratio"] for h in jres.history)
        ft, jft = seen["t_finetune"][0], seen["j_finetune"][0]
        assert len(ft) == len(jft) > 0
        np.testing.assert_allclose(ft, jft, rtol=LOSS_RTOL)
        # The result: tensors on the search's device, the spec's layout.
        assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu"
                   for t in torch_leaves(res.params))
        want = jax.device_get(jres.params)
        got = params_to_numpy(res.params)
        for (path, a), (_, b) in zip(np_leaves(got), np_leaves(want)):
            assert a.shape == b.shape and a.dtype == b.dtype, path

    def test_no_iterations_samples_once(self, scripted):
        """``total_iters=0``: no iteration runs, the history is empty and
        one unconditional sample is the best arch (the degenerate
        budget)."""
        calls, _ = scripted
        jres, res = run_both(dict(self.CFG, total_iters=0, finetune_epochs=1))
        assert res.history == jres.history == []
        assert calls["j"] == calls["t"] == 1
        assert_same_search(res, jres)
        assert np.isfinite(res.best_ratio) and np.isfinite(jres.best_ratio)

    def test_early_stop_breaks_the_whole_loop(self, scripted):
        """An ``early_stop_tol`` that every loss change passes: the loop
        breaks at the second model iteration, before the first controller
        update (``ctrl_every`` is 10)."""
        calls, _ = scripted
        jres, res = run_both(dict(self.CFG, total_iters=10, model_iters=10, controller_iters=1,
                                  early_stop_tol=1e9, finetune_epochs=1))
        assert len(res.history) == len(jres.history) == 2
        assert [h["iter"] for h in res.history] == [1, 2]
        assert calls["j"] == calls["t"] == 2
        assert_same_search(res, jres)


# ------------------------------------------------ test_mhas.py's TestRunMHAS
class TestRunMHAS:
    def test_end_to_end_small(self):
        table = synthetic_multi_column(n=1500, correlation="high", cardinalities=(3, 4), seed=0)
        cfg = MHASConfig(layer_sizes=(8, 16), total_iters=8, model_iters=8, controller_iters=2,
                         model_epochs_per_iter=1, model_batch=512, controller_batch=512,
                         controller_samples=2, finetune_epochs=3)
        res = run_mhas(table, cfg, device="cpu")
        assert res.best_ratio < float("inf")
        assert len(res.history) > 0
        assert res.spec.tasks == ("v0", "v1")
        store = DeepMappingStore.build(table, DeepMappingConfig(), spec=res.spec,
                                       params=res.params, device="cpu")
        vals, exists = store.lookup(table.keys)
        assert exists.all()
        for c in table.columns:
            np.testing.assert_array_equal(vals[c], table.columns[c])

    def test_history_records_ratio_progress(self):
        table = synthetic_multi_column(n=1000, correlation="high", seed=1)
        cfg = MHASConfig(layer_sizes=(8,), total_iters=4, model_iters=4, controller_iters=1,
                         model_epochs_per_iter=1, model_batch=256, controller_batch=256,
                         controller_samples=2, finetune_epochs=2)
        res = run_mhas(table, cfg, device="cpu")
        assert all("ratio" in h and "iter" in h for h in res.history)
        # 4 model iterations and one controller update of 2 samples.
        assert len(res.history) == 4 + 2
        assert res.best_ratio == min(h["ratio"] for h in res.history)
        store = DeepMappingStore.build(table, DeepMappingConfig(), spec=res.spec,
                                       params=res.params, device="cpu")
        vals, exists = store.lookup(table.keys)
        assert exists.all()
        for c in table.columns:
            np.testing.assert_array_equal(vals[c], table.columns[c])


# ---------------------------------------------------------------- configs
def fields_of(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


class TestConfigs:
    @pytest.mark.parametrize("name", ["PAPER_MHAS", "BENCH_MHAS"])
    def test_mhas_configs_equal_reference(self, name):
        got, want = getattr(paper, name), getattr(jpaper, name)
        assert isinstance(got, MHASConfig) and isinstance(want, JMHASConfig)
        assert fields_of(got) == fields_of(want)
        assert fields_of(MHASConfig()) == fields_of(JMHASConfig())

    @pytest.mark.parametrize("name", ["PAPER_STORE", "BENCH_STORE"])
    def test_store_configs_equal_reference(self, name):
        got, want = fields_of(getattr(paper, name)), fields_of(getattr(jpaper, name))
        assert isinstance(getattr(paper, name), DeepMappingConfig)
        assert isinstance(getattr(jpaper, name), JConfig)
        # The one documented difference: the port's kernels switch.
        assert got.pop("use_kernels") is True and want.pop("use_pallas") is False
        train, jtrain = got.pop("train"), want.pop("train")
        assert got == want
        assert isinstance(train, TrainConfig) and isinstance(jtrain, JTrainConfig)
        assert fields_of(train) == fields_of(jtrain)
