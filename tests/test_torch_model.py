"""The port's model (``repro_torch.core.model``) against the reference
(``repro.core.model``) on the CPU, over ``tests/test_model.py``'s shapes.

Weights are drawn with numpy (``torch_port_util.np_params``) and
carried into the port with ``params_from_numpy``: ``jax.random`` and
``torch.Generator`` give different numbers from one seed.  Tolerances:

* logits ``rtol=atol=1e-5`` — the two frameworks sum in different orders;
* codes equal, except rows whose top-two logit margin on the reference
  side is below ``1e-5`` (counted, and the count must be small).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import model as jmodel
from repro.core.encoding import KeyEncoder
from repro_torch.core import model as tmodel
from repro_torch.core.convert import params_from_numpy, params_to_numpy
from torch_port_util import np_params

TOL = 1e-5
MARGIN = 1e-5


def make_specs(shared=(32, 16), private=(8,), cards=(5, 3), base=10, width=4):
    kw = dict(
        base=base, width=width, shared=shared,
        private={f"c{i}": private for i in range(len(cards))},
        out_cards={f"c{i}": c for i, c in enumerate(cards)},
    )
    return jmodel.MLPSpec(**kw), tmodel.MLPSpec(**kw)


def carried(jspec, seed=0):
    jparams = np_params(jspec, seed=seed)
    return jparams, params_from_numpy(jparams, "cpu")


def assert_codes_match(got, want_logits, want_codes, spec):
    """Codes equal except on reference rows with a near-tie."""
    got = np.asarray(got)
    want_codes = np.asarray(want_codes)
    excused = 0
    for i, t in enumerate(spec.tasks):
        lg = np.asarray(want_logits[t])
        diff = got[:, i] != want_codes[:, i]
        if diff.any():
            top = np.sort(lg[diff], axis=1)[:, -2:]
            assert (top[:, 1] - top[:, 0] < MARGIN).all(), t
            excused += int(diff.sum())
    assert excused <= max(1, got.shape[0] // 100)
    return excused


SHAPES = [
    # (shared, private, cards, base, width, n) — test_model.py's depths
    ((32, 16), (8,), (5, 3), 10, 4, 7),
    ((), (), (5, 3), 10, 4, 7),
    ((16,), (), (5, 3), 10, 4, 64),
    ((), (8,), (5, 3), 10, 4, 64),
    ((32, 16), (8, 4), (5, 3), 10, 4, 129),
    ((64,), (), (5, 3), 10, 4, 1024),
    ((96, 96), (32,), (300, 2), 16, 5, 500),
]


class TestSpecAndInit:
    def test_spec_matches_reference(self):
        jspec, spec = make_specs()
        assert spec.tasks == jspec.tasks
        assert spec.num_params() == jspec.num_params()
        assert spec.size_bytes() == jspec.size_bytes()
        assert hash(spec) == hash(make_specs()[1]) and spec == make_specs()[1]

    @pytest.mark.parametrize("shared,private", [((), ()), ((16,), ()), ((), (8,)), ((32, 16), (8, 4))])
    def test_init_tree_layout_matches_reference(self, shared, private):
        jspec, spec = make_specs(shared=shared, private=private)
        p = tmodel.init_params(spec, seed=3, device="cpu")
        shapes = jax.tree.map(
            lambda a: tuple(a.shape), jax.eval_shape(lambda: jmodel.init_params(jspec, seed=3))
        )
        assert jax.tree.map(lambda t: tuple(t.shape), params_to_numpy(p)) == shapes
        assert tmodel.count_params(p) == spec.num_params()
        assert tmodel.model_size_bytes(p) == spec.size_bytes()
        assert all(not t.requires_grad for t in tmodel._leaves(p))

    def test_he_normal_and_seeded(self):
        _, spec = make_specs(shared=(256,), width=8)
        a = tmodel.init_params(spec, seed=1, device="cpu")
        b = tmodel.init_params(spec, seed=1, device="cpu")
        w = a["shared"][0]["w"]
        assert w.shape == (8, 10, 256)
        torch.testing.assert_close(w, b["shared"][0]["w"], rtol=0, atol=0)
        assert abs(float(w.std()) - (2.0 / 80) ** 0.5) < 0.02
        assert float(a["shared"][0]["b"].abs().sum()) == 0.0

    def test_convert_roundtrip(self):
        jspec, _ = make_specs()
        jp, p = carried(jspec, seed=2)
        back = params_to_numpy(p)
        for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
            np.testing.assert_array_equal(x, y)


class TestForwardAgainstReference:
    @pytest.mark.parametrize("shared,private,cards,base,width,n", SHAPES)
    def test_logits_and_codes(self, shared, private, cards, base, width, n):
        jspec, spec = make_specs(shared, private, cards, base, width)
        jp, p = carried(jspec, seed=n)
        digits = np.random.default_rng(n).integers(0, base, (n, width)).astype(np.int32)
        want = jax.jit(jmodel.forward_digits, static_argnums=2)(jp, jnp.asarray(digits), jspec)
        got = tmodel.forward_digits(p, torch.from_numpy(digits), spec)
        for t in spec.tasks:
            assert tuple(got[t].shape) == tuple(want[t].shape)
            np.testing.assert_allclose(got[t].numpy(), np.asarray(want[t]), rtol=TOL, atol=TOL)
        codes = tmodel.predict_codes(p, torch.from_numpy(digits), spec)
        assert codes.dtype == torch.int32
        jcodes = np.stack([np.argmax(np.asarray(want[t]), axis=1) for t in spec.tasks], 1)
        assert_codes_match(codes.numpy(), want, jcodes, spec)

    def test_onehot_path_matches_reference_and_gather(self):
        enc = KeyEncoder(max_key=9999, base=10)
        jspec, spec = make_specs(width=enc.width)
        jp, p = carried(jspec, seed=1)
        keys = np.array([0, 42, 9999, 1234], dtype=np.int64)
        onehot = enc.onehot(keys)
        want = jmodel.forward_onehot(jp, jnp.asarray(onehot), jspec)
        got = tmodel.forward_onehot(p, torch.from_numpy(onehot), spec)
        gathered = tmodel.forward_digits(p, torch.from_numpy(enc.digits(keys)), spec)
        for t in spec.tasks:
            np.testing.assert_allclose(got[t].numpy(), np.asarray(want[t]), rtol=TOL, atol=TOL)
            np.testing.assert_allclose(got[t].numpy(), gathered[t].numpy(), rtol=TOL, atol=TOL)

    def test_predict_codes_shape_order(self):
        _, spec = make_specs(cards=(5, 3))
        p = tmodel.init_params(spec, device="cpu")
        codes = tmodel.predict_codes(p, torch.zeros((11, 4), dtype=torch.int32), spec)
        assert codes.shape == (11, 2)
        assert (codes[:, 0] < 5).all() and (codes[:, 1] < 3).all()


class TestModule:
    def test_module_forward_and_grad(self):
        jspec, spec = make_specs()
        _, p = carried(jspec, seed=4)
        mod = tmodel.MappingMLP(spec, device="cpu", params=p)
        assert sum(x.numel() for x in mod.parameters()) == spec.num_params()
        digits = torch.from_numpy(np.random.default_rng(0).integers(0, 10, (9, 4)).astype(np.int32))
        out = mod(digits)
        ref = tmodel.forward_digits(p, digits, spec)
        for t in spec.tasks:
            torch.testing.assert_close(out[t], ref[t], rtol=0, atol=0)
        loss = sum((v**2).sum() for v in out.values())
        loss.backward()
        assert all(torch.isfinite(x.grad).all() for x in mod.parameters())
        tree = mod.tree()
        assert tree["heads"]["c1"]["out"]["w"] is mod.out[1].w

    def test_no_nans_large_batch(self):
        _, spec = make_specs(shared=(64,), private=())
        p = tmodel.init_params(spec, device="cpu")
        digits = torch.from_numpy(np.random.default_rng(0).integers(0, 10, (4096, 4)).astype(np.int32))
        out = tmodel.forward_digits(p, digits, spec)
        assert all(torch.isfinite(v).all() for v in out.values())
