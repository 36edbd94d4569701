"""The port's trainer (``repro_torch.core.trainer``, ``repro_torch.train.
optimizer``) against the reference's, on the CPU, from the same inputs
made with numpy.

Tolerances, and why:

* Adam and the decay schedule: ``rtol=1e-6``.  The port keeps the
  reference's fp32 arithmetic order; what remains is the last-ulp
  rounding of ``pow`` and of any fused multiply-add XLA forms.
* The loss ``rtol=1e-5``; gradients ``rtol=1e-4, atol=1e-6``.  The two
  frameworks reduce the batch mean, ``logsumexp`` and the gather's
  scatter-add backward in different orders.
* Training: the per-epoch losses of the first 3 epochs to ``1e-4``
  relative, and the memorized fractions after training to 0.05.  Both
  packages draw the same batches (one ``default_rng(seed)`` permutation
  per epoch, wrap-around padding), so the runs differ only by the
  rounding above, which Adam's normalised steps carry forward without
  growing much over a few epochs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (before repro.kernels: circular import)
from conftest import make_periodic_table, make_random_table
from repro.core import trainer as jtrainer
from repro.core.encoding import KeyEncoder, build_codecs
from repro.core.model import MLPSpec as JSpec
from repro.core.model import predict_codes as j_predict_codes
from repro.train import optimizer as joptim
from repro_torch.core import DeepMappingConfig, DeepMappingStore
from repro_torch.core import trainer as ttrainer
from repro_torch.core.convert import params_from_numpy, params_to_numpy
from repro_torch.core.model import MLPSpec, _leaves, _with_leaves, predict_codes
from repro_torch.train import optimizer as toptim
from torch_port_util import np_params, spec_pair

SHARED, PRIVATE = (32, 32), (16,)


def _paired(jtree, ttree):
    """(reference leaf, port leaf) pairs, matched by tree path."""
    out = []

    def walk(j, t):
        if isinstance(j, dict):
            for k in j:
                walk(j[k], t[k])
        elif isinstance(j, (list, tuple)):
            for a, b in zip(j, t, strict=True):
                walk(a, b)
        else:
            out.append((np.asarray(j), t.detach().cpu().numpy()))

    walk(jtree, ttree)
    return out


def _table_setup(table):
    enc = KeyEncoder(table.max_key, base=10)
    codecs = build_codecs(table.columns)
    kw = dict(base=10, width=enc.width, shared=SHARED,
              private={c: PRIVATE for c in table.columns},
              out_cards={c: codecs[c].cardinality for c in table.columns})
    jspec, spec = JSpec(**kw), MLPSpec(**kw)
    codes = np.stack([codecs[t].codes for t in spec.tasks], axis=1)
    return jspec, spec, enc.digits(table.keys), codes


TABLES = {
    "periodic": lambda: make_periodic_table(),
    "random": lambda: make_random_table(n=1000, cards=(7, 3)),
}


class TestOptimizer:
    def test_adam_and_decay_match_reference_over_5_steps(self):
        jspec, spec = spec_pair((16,), (8,), (5, 3))
        p0 = np_params(jspec, seed=2)
        rng = np.random.default_rng(7)
        grads = [
            jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), p0)
            for _ in range(5)
        ]
        sched_j = joptim.exponential_decay(1e-3, 0.999)
        sched_t = toptim.exponential_decay(1e-3, 0.999)
        jp, jopt = jax.tree.map(jnp.asarray, p0), joptim.adam_init(p0)
        tp = params_from_numpy(p0, "cpu")
        topt = toptim.adam_init(tp)
        for g in grads:
            lr_j, lr_t = sched_j(jopt.step), sched_t(topt.step)
            assert lr_t.dtype == torch.float32
            np.testing.assert_allclose(lr_t.item(), float(lr_j), rtol=1e-6)
            jp, jopt = joptim.adam_update(g, jopt, jp, lr=lr_j)
            tp, topt = toptim.adam_update(params_from_numpy(g, "cpu"), topt, tp, lr=lr_t)
        assert int(topt.step) == int(jopt.step) == 5 and topt.step.dtype == torch.int32
        for jt, tt in ((jp, tp), (jopt.mu, topt.mu), (jopt.nu, topt.nu)):
            for a, b in _paired(jt, tt):
                assert b.dtype == np.float32
                np.testing.assert_allclose(b, a, rtol=1e-6, atol=0)

    def test_update_is_functional(self):
        _, spec = spec_pair((8,), (), (3,))
        p = params_from_numpy(np_params(spec, seed=0), "cpu")
        before = [t.clone() for t in _leaves(p)]
        opt = toptim.adam_init(p)
        g = params_from_numpy(np_params(spec, seed=1), "cpu")
        p2, opt2 = toptim.adam_update(g, opt, p, lr=1e-3)
        for a, b in zip(before, _leaves(p), strict=True):
            assert torch.equal(a, b)
        assert int(opt.step) == 0 and int(opt2.step) == 1
        assert all(not torch.equal(a, b) for a, b in zip(_leaves(p), _leaves(p2)))


class TestLossAndGradients:
    @pytest.mark.parametrize("shared,private,cards,n", [
        ((32, 16), (8,), (7, 3), 200),
        ((), (12,), (9,), 64),          # head-first gather layer
        ((16,), (), (300, 2, 5), 150),  # out layers straight off the trunk
    ])
    def test_value_and_grad_match_reference(self, shared, private, cards, n):
        jspec, spec = spec_pair(shared, private, cards)
        p0 = np_params(jspec, seed=n)
        rng = np.random.default_rng(n)
        digits = rng.integers(0, 10, (n, spec.width)).astype(np.int32)
        codes = np.stack([rng.integers(0, c, n) for c in cards], axis=1).astype(np.int32)
        jloss, jgrads = jax.value_and_grad(jtrainer.multitask_loss)(
            p0, jnp.asarray(digits), jnp.asarray(codes), jspec
        )
        leaves = [t.requires_grad_(True) for t in _leaves(params_from_numpy(p0, "cpu"))]
        tree = _with_leaves(params_from_numpy(p0, "cpu"), leaves)
        loss = ttrainer.multitask_loss(tree, torch.from_numpy(digits),
                                       torch.from_numpy(codes), spec)
        grads = torch.autograd.grad(loss, list(_leaves(tree)))
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
        gtree = _with_leaves(tree, grads)
        pairs = _paired(jgrads, gtree)
        assert len(pairs) == len(leaves)
        for a, b in pairs:
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-6)


def _run_both(table_name, **cfg):
    jspec, spec, digits, codes = _table_setup(TABLES[table_name]())
    p0 = np_params(jspec, seed=1)
    jp, jopt, jh = jtrainer.train(jspec, digits, codes, jtrainer.TrainConfig(**cfg), params=p0)
    tp, topt, th = ttrainer.train(spec, digits, codes, ttrainer.TrainConfig(**cfg),
                                  params=params_from_numpy(p0, "cpu"), device="cpu")
    return (jspec, spec, digits, codes), (jp, jopt, jh), (tp, topt, th)


class TestTrain:
    @pytest.mark.parametrize("table_name", sorted(TABLES))
    def test_losses_and_memorization_match_reference(self, table_name):
        """1,500 or 1,000 rows at batch 512: three or two steps an epoch,
        the last one padded by wrap-around."""
        (jspec, spec, digits, codes), (jp, _, jh), (tp, topt, th) = _run_both(
            table_name, epochs=12, batch_size=512, early_stop_tol=0.0,
        )
        assert len(th) == len(jh) == 12
        np.testing.assert_allclose(th[:3], jh[:3], rtol=1e-4)
        assert int(topt.step) == 12 * -(-digits.shape[0] // 512)
        assert all(t.device.type == "cpu" for t in _leaves(tp))
        jmem = (np.asarray(j_predict_codes(jp, digits, jspec)) == codes).all(axis=1).mean()
        tmem = (predict_codes(tp, torch.from_numpy(digits), spec).numpy() == codes).all(
            axis=1).mean()
        assert abs(float(tmem) - float(jmem)) <= 0.05

    def test_early_stop_matches_reference(self):
        """lr 0 and one batch of every row leave the loss flat, so both stop
        after the second epoch."""
        _, (_, _, jh), (_, _, th) = _run_both("periodic", epochs=10, batch_size=4096, lr=0.0)
        assert len(th) == len(jh) == 2
        np.testing.assert_allclose(th, jh, rtol=1e-5)

    def test_continue_training_matches_reference(self):
        """A second call with the returned params and optimizer state goes
        on from the step count the first left."""
        (jspec, spec, digits, codes), (jp, jopt, _), (tp, topt, _) = _run_both(
            "random", epochs=2, batch_size=256, early_stop_tol=0.0,
        )
        cfg = dict(epochs=2, batch_size=256, early_stop_tol=0.0, seed=3)
        _, jopt2, jh = jtrainer.train(jspec, digits, codes, jtrainer.TrainConfig(**cfg),
                                      params=jp, opt=jopt)
        tp2, topt2, th = ttrainer.train(spec, digits, codes, ttrainer.TrainConfig(**cfg),
                                        params=tp, opt=topt, device="cpu")
        assert int(topt2.step) == int(jopt2.step) == 16
        np.testing.assert_allclose(th, jh, rtol=1e-4)
        assert isinstance(params_to_numpy(tp2)["shared"][0]["w"], np.ndarray)

    def test_fresh_params_use_the_ports_init(self):
        _, spec, digits, codes = _table_setup(TABLES["random"]())
        cfg = ttrainer.TrainConfig(epochs=1, batch_size=512, seed=5)
        p, _, h = ttrainer.train(spec, digits, codes, cfg, device="cpu")
        p2, _, h2 = ttrainer.train(spec, digits, codes, cfg, device="cpu")
        assert h == h2 and len(h) == 1 and np.isfinite(h[0])
        for a, b in zip(_leaves(p), _leaves(p2), strict=True):
            assert torch.equal(a, b)


class TestTrainedBuild:
    """``DeepMappingStore.build`` with no params trains, then evaluates
    T_aux through the engine that serves."""

    @pytest.fixture(scope="class")
    def built(self):
        table = make_periodic_table()
        cfg = DeepMappingConfig(
            shared=SHARED, private=PRIVATE,
            train=ttrainer.TrainConfig(epochs=30, batch_size=512),
        )
        return table, DeepMappingStore.build(table, cfg, device="cpu")

    def test_trains_and_is_lossless(self, built):
        table, store = built
        assert store.spec.shared == SHARED and store.spec.width == store.encoder.width
        assert 0.0 < store.memorized_fraction() <= 1.0
        v, e = store.lookup(table.keys)
        assert e.all()
        for c, col in table.columns.items():
            np.testing.assert_array_equal(v[c], col)

    def test_absent_and_out_of_capacity_keys_read_absent(self, built):
        table, store = built
        absent = np.setdiff1d(np.arange(table.max_key + 1), table.keys)
        out = np.array([-1, -2**40, store.encoder.capacity, store.encoder.capacity + 7,
                        2**31 - 1, 2**31, 2**40], dtype=np.int64)
        _, e = store.lookup(np.concatenate([absent, out]))
        assert not e.any()

    def test_aux_holds_exactly_the_engines_misses(self, built):
        table, store = built
        codes = np.stack([store.codecs[t].codes for t in store.spec.tasks], axis=1)
        wrong = (store.engine.infer(table.keys) != codes).any(axis=1)
        found, _ = store.aux.get(table.keys)
        np.testing.assert_array_equal(found, wrong)
        assert store.aux.num_rows == int(wrong.sum())

    def test_given_spec_without_params_trains_that_spec(self):
        table = make_random_table(n=600, cards=(4, 6))
        _, spec, _, _ = _table_setup(table)
        spec = MLPSpec(base=spec.base, width=spec.width, shared=(24,), private=spec.private,
                       out_cards=spec.out_cards)
        store = DeepMappingStore.build(
            table, DeepMappingConfig(train=ttrainer.TrainConfig(epochs=2, batch_size=256)),
            spec=spec, device="cpu",
        )
        assert store.spec is spec and store.params["shared"][0]["w"].shape == (
            spec.width, spec.base, 24)
        v, e = store.lookup(table.keys)
        assert e.all()
        for c, col in table.columns.items():
            np.testing.assert_array_equal(v[c], col)
