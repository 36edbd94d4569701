"""The port's MHAS search space and controller (``repro_torch.core.mhas``)
on the CPU: ``tests/test_mhas.py``'s ``TestSearchSpace`` and
``TestController`` ported onto the port, and the port held against the
reference (``repro.core.mhas``) on carried weights.

``jax.random`` and ``torch.Generator`` draw different numbers from one
seed, so every cross-package case starts from a bank or controller drawn
with numpy and carried into both packages (``params_from_numpy``), and
from numpy-made keys, codes and token sequences.  Samples cannot be
shared, so the port's samples are held by their distribution and by the
reference's score of them.  Tolerances:

* masked forward ``rtol=atol=2e-5`` (the reference's own masked-vs-sliced
  tolerance): the frameworks sum in different orders;
* ``extract_child_params`` byte for byte: slicing does no arithmetic;
* bank and controller gradients ``rtol=1e-4, atol=1e-6``: a backward
  pass sums over the batch and the decisions in another order again;
* ``logprob_of`` and its entropy ``rtol=1e-5``;
* sample frequencies within 4 standard errors of the reference's
  step-0 softmax.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (before repro.kernels: the reference's import order)
from repro.core.encoding import onehot_digits as j_onehot
from repro.core.mhas import SearchSpace as JSpace
from repro.core.mhas import controller as jctrl
from repro.core.mhas.search import _child_loss as j_child_loss
from repro_torch.core.convert import params_from_numpy, params_to_numpy
from repro_torch.core.encoding import KeyEncoder, onehot_digits
from repro_torch.core.mhas import SearchSpace
from repro_torch.core.mhas import controller as ctrl
from repro_torch.core.model import _map_tree, forward_onehot

SMALL = dict(base=10, width=4, tasks=("a", "b"), out_cards=(5, 3),
             layer_sizes=(8, 16, 32), max_layers=2)
#: The paper's layer sizes (100 to 2,000) and depth, two tasks.
PAPER = dict(base=10, width=4, tasks=("a", "b"), out_cards=(5, 3))
#: The paper's choices with one task: a short sequence whose depth head
#: is padded (3 choices to 7).
PAPER_ONE_TASK = dict(base=10, width=4, tasks=("a",), out_cards=(5,))
FWD_TOL = 2e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
SCORE_RTOL = 1e-5

#: Token sequences of the small space ([depth, size, size] for the trunk,
#: then per task): the four edge archs, mixed ones, and size tokens past
#: ``len(layer_sizes)`` (taken modulo it).
ARCHS = {
    "full": [2, 2, 2] * 3,
    "all depth 0": [0, 0, 0] * 3,
    "trunk 0, heads 2 x 32": [0, 0, 0] + [2, 2, 2] * 2,
    "trunk 2 x 32, heads 0": [2, 2, 2] + [0, 0, 0] * 2,
    "mixed a": [1, 1, 0, 2, 0, 1, 0, 2, 2],
    "mixed b": [2, 0, 2, 1, 1, 1, 2, 1, 0],
    "mixed c": [1, 2, 2, 0, 1, 0, 1, 0, 2],
    "mixed d": [0, 1, 1, 1, 2, 0, 2, 0, 1],
    "sizes modulo": [2, 4, 5, 1, 3, 7, 2, 6, 4],
}
EDGE = ["full", "all depth 0", "trunk 0, heads 2 x 32", "trunk 2 x 32, heads 0"]


@pytest.fixture(scope="module")
def space():
    return SearchSpace(**SMALL)


@pytest.fixture(scope="module")
def jspace():
    return JSpace(**SMALL)


@pytest.fixture(scope="module")
def ref_bank(jspace):
    """The reference's own bank, numpy leaves."""
    return jax.device_get(jspace.init_bank(seed=1))


#: The reference's child loss and its gradient, compiled once for every
#: arch (the arch arrays are arguments).
j_loss_and_grad = jax.jit(jax.value_and_grad(j_child_loss), static_argnums=(4,))


def np_bank(space, seed=0):
    """A bank in the reference's layout with numpy leaves: He-normal
    weights and small random biases (the reference's are zero)."""
    rng = np.random.default_rng(seed)
    mw = space.max_width

    def mat(out_dim):
        w = (rng.standard_normal((mw, out_dim)) * np.sqrt(2.0 / mw)).astype(np.float32)
        return {"w": w, "b": (0.1 * rng.standard_normal(out_dim)).astype(np.float32)}

    return {
        "trunk": [mat(mw) for _ in range(space.max_layers)],
        "heads": {t: {"hidden": [mat(mw) for _ in range(space.max_layers)], "out": mat(c)}
                  for t, c in zip(space.tasks, space.out_cards)},
    }


def np_controller(cspec, seed=0, scale=0.5):
    """Controller params with numpy leaves, wider than the paper's 0.05 so
    that the step distributions are far from uniform, and a random bias."""
    rng = np.random.default_rng(seed)

    def init(*shape):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    return {"embed": init(cspec.vocab, ctrl.EMBED), "wx": init(ctrl.EMBED, 4 * ctrl.HIDDEN),
            "wh": init(ctrl.HIDDEN, 4 * ctrl.HIDDEN), "b": init(4 * ctrl.HIDDEN) / 5,
            "depth_head": init(ctrl.HIDDEN, cspec.depth_choices),
            "size_head": init(ctrl.HIDDEN, cspec.size_choices)}


def features(space, n, seed):
    """numpy digits of ``n`` random keys, and both packages' padded one-hots."""
    rng = np.random.default_rng(seed)
    enc = KeyEncoder(max_key=space.base ** space.width - 1, base=space.base)
    digits = enc.digits(rng.integers(0, space.base ** space.width, size=n))
    pad = space.max_width - space.feature_dim
    t_oh = torch.nn.functional.pad(onehot_digits(torch.from_numpy(digits), space.base), (0, pad))
    j_oh = jnp.pad(j_onehot(jnp.asarray(digits), space.base), ((0, 0), (0, pad)))
    return digits, t_oh, j_oh


def np_leaves(tree):
    """(path, numpy leaf) pairs in a fixed order."""
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def torch_leaves(tree):
    out = []
    if isinstance(tree, dict):
        for k in sorted(tree):
            out += torch_leaves(tree[k])
    elif isinstance(tree, list):
        for v in tree:
            out += torch_leaves(v)
    else:
        out.append(tree)
    return out


def with_grad(tree):
    """A copy of a tensor tree whose leaves require grad, and those leaves
    in ``torch_leaves`` order (jax's flattening order: sorted keys)."""
    tree = _map_tree(tree, lambda t: t.detach().clone().requires_grad_(True))
    return tree, torch_leaves(tree)


def port_child_loss(space, bank, onehot_pad, codes, aa):
    """The reference's ``search._child_loss`` in the port: the sum over
    tasks of the mean softmax cross-entropy of the masked forward."""
    logits = space.forward(bank, onehot_pad, aa)
    loss = 0.0
    for i, t in enumerate(space.tasks):
        lg = logits[t]
        picked = torch.gather(lg, 1, codes[:, i : i + 1].long())[:, 0]
        loss = loss + torch.mean(torch.logsumexp(lg, dim=-1) - picked)
    return loss


def assert_arch_equal(got, want):
    assert got["trunk_depth"] == want["trunk_depth"]
    np.testing.assert_array_equal(got["trunk_sizes"], want["trunk_sizes"])
    assert got["trunk_sizes"].dtype == want["trunk_sizes"].dtype
    assert list(got["heads"]) == list(want["heads"])
    for t in want["heads"]:
        assert got["heads"][t]["depth"] == want["heads"][t]["depth"]
        np.testing.assert_array_equal(got["heads"][t]["sizes"], want["heads"][t]["sizes"])


def assert_bytes_equal(got_tree, want_tree):
    got, want = np_leaves(got_tree), np_leaves(want_tree)
    assert jax.tree.structure(got_tree) == jax.tree.structure(want_tree)
    for (path, a), (_, b) in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, path
        assert a.tobytes() == b.tobytes(), path


# ------------------------------------------------------- test_mhas.py, ported
class TestSearchSpace:
    def test_bank_shapes(self, space):
        bank = space.init_bank(seed=0, device="cpu")
        assert bank["trunk"][0]["w"].shape == (space.max_width, space.max_width)
        assert bank["heads"]["a"]["out"]["w"].shape == (space.max_width, 5)

    def test_tokens_to_arch_bounds(self, space):
        tokens = np.array([2, 0, 1, 1, 2, 2, 0, 0, 0])
        arch = space.tokens_to_arch(tokens)
        assert arch["trunk_depth"] == 2
        assert list(arch["trunk_sizes"]) == [8, 16]
        assert arch["heads"]["a"]["depth"] == 1

    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_masked_equals_sliced_child(self, space, seed):
        """THE core MHAS invariant: the weight-shared masked forward must
        equal the standalone sliced child model."""
        rng = np.random.default_rng(seed)
        bank = space.init_bank(seed=seed, device="cpu")
        tokens = rng.integers(0, 3, size=space.num_decisions)
        arch = space.tokens_to_arch(tokens)
        aa = space.arch_arrays(arch, device="cpu")

        enc = KeyEncoder(max_key=9999, base=10)
        keys = rng.integers(0, 10000, size=17).astype(np.int64)
        oh = onehot_digits(torch.from_numpy(enc.digits(keys)), 10)
        oh_pad = torch.nn.functional.pad(oh, (0, space.max_width - oh.shape[-1]))

        masked = space.forward(bank, oh_pad, aa)
        child_params = space.extract_child_params(bank, arch)
        spec = space.child_spec(arch)
        sliced = forward_onehot(child_params, oh, spec)
        for t in space.tasks:
            torch.testing.assert_close(masked[t], sliced[t], rtol=FWD_TOL, atol=FWD_TOL)

    def test_child_num_params_matches_spec(self, space):
        tokens = np.array([1, 2, 0, 2, 1, 1, 0, 0, 0])
        arch = space.tokens_to_arch(tokens)
        assert space.child_num_params(arch) == space.child_spec(arch).num_params()

    def test_search_space_size_formula(self, space):
        assert space.num_decisions == (1 + 2) * (1 + 2)


class TestController:
    def test_sample_shapes_and_ranges(self, space):
        cspec = ctrl.ControllerSpec.for_space(space)
        params = ctrl.init_controller(cspec, seed=0, device="cpu")
        tokens, logp, ent = ctrl.sample_arch(params, cspec, torch.Generator().manual_seed(0))
        assert tokens.shape == (space.num_decisions,) and tokens.dtype == torch.int32
        kinds = space.decision_kinds()
        for k, t in zip(kinds, tokens.numpy()):
            limit = cspec.depth_choices if k == 0 else cspec.size_choices
            assert 0 <= t < limit
        assert torch.isfinite(logp) and ent > 0

    def test_logprob_matches_sample(self, space):
        cspec = ctrl.ControllerSpec.for_space(space)
        params = ctrl.init_controller(cspec, seed=0, device="cpu")
        tokens, logp_s, _ = ctrl.sample_arch(params, cspec, torch.Generator().manual_seed(1))
        logp_r, _ = ctrl.logprob_of(params, cspec, tokens)
        np.testing.assert_allclose(float(logp_s), float(logp_r), rtol=SCORE_RTOL)

    def test_logprob_differentiable(self, space):
        cspec = ctrl.ControllerSpec.for_space(space)
        params, leaves = with_grad(ctrl.init_controller(cspec, seed=0, device="cpu"))
        tokens = torch.zeros((space.num_decisions,), dtype=torch.int32)
        grads = torch.autograd.grad(ctrl.logprob_of(params, cspec, tokens)[0], leaves)
        assert all(bool(torch.isfinite(g).all()) for g in grads)

    def test_different_rng_different_samples(self, space):
        cspec = ctrl.ControllerSpec.for_space(space)
        params = ctrl.init_controller(cspec, seed=0, device="cpu")
        outs = [ctrl.sample_arch(params, cspec, torch.Generator().manual_seed(i))[0].numpy()
                for i in range(8)]
        assert any(not np.array_equal(outs[0], o) for o in outs[1:])


# ------------------------------------------------------ against the reference
class TestSpaceAgainstReference:
    @pytest.mark.parametrize("name", list(ARCHS))
    def test_arch_metadata_equal(self, space, jspace, name):
        tokens = np.asarray(ARCHS[name])
        arch, jarch = space.tokens_to_arch(tokens), jspace.tokens_to_arch(tokens)
        assert_arch_equal(arch, jarch)
        assert_arch_equal(space.tokens_to_arch(torch.from_numpy(tokens).to(torch.int32)), jarch)
        aa, jaa = space.arch_arrays(arch, device="cpu"), jspace.arch_arrays(jarch)
        assert list(aa) == list(jaa)
        for k in jaa:
            assert aa[k].dtype == torch.int32
            np.testing.assert_array_equal(aa[k].numpy(), np.asarray(jaa[k]))
        assert space.child_num_params(arch) == jspace.child_num_params(jarch)
        spec, jspec = space.child_spec(arch), jspace.child_spec(jarch)
        for f in ("base", "width", "shared", "private", "out_cards", "dtype"):
            assert getattr(spec, f) == getattr(jspec, f), f
        assert spec.num_params() == jspec.num_params() == space.child_num_params(arch)

    def test_space_properties_equal(self, space, jspace):
        for kw in (SMALL, PAPER, PAPER_ONE_TASK):
            s, js = SearchSpace(**kw), JSpace(**kw)
            for f in ("feature_dim", "max_width", "num_size_choices", "num_decisions"):
                assert getattr(s, f) == getattr(js, f), f
            np.testing.assert_array_equal(s.decision_kinds(), js.decision_kinds())
            assert s.decision_kinds().dtype == js.decision_kinds().dtype == np.int32

    def test_init_bank_layout_equals_reference(self, space, ref_bank):
        bank = params_to_numpy(space.init_bank(seed=3, device="cpu"))
        jbank = ref_bank
        assert jax.tree.structure(bank) == jax.tree.structure(jbank)
        for (path, a), (_, b) in zip(np_leaves(bank), np_leaves(jbank)):
            assert a.shape == b.shape and a.dtype == b.dtype, path
        biases = [a for p, a in np_leaves(bank) if p[-1].key == "b"]
        assert all(not b.any() for b in biases)
        ws = np.concatenate([a.ravel() for p, a in np_leaves(bank) if p[-1].key == "w"])
        np.testing.assert_allclose(ws.std(), np.sqrt(2.0 / space.max_width), rtol=0.05)
        again = params_to_numpy(space.init_bank(seed=3, device="cpu"))
        assert_bytes_equal(again, bank)

    def test_trees_carry_both_ways(self, jspace, ref_bank):
        """The reference's bank and controller (``jax.device_get``) into
        the port and back, byte for byte."""
        jbank = ref_bank
        bank = params_from_numpy(jbank, "cpu")
        assert bank["trunk"][0]["w"].dtype == torch.float32
        assert_bytes_equal(params_to_numpy(bank), jbank)
        jcs = jctrl.ControllerSpec.for_space(jspace)
        jparams = jax.device_get(jctrl.init_controller(jcs, seed=1))
        params = params_from_numpy(jparams, "cpu")
        assert sorted(params) == sorted(jparams)
        assert_bytes_equal(params_to_numpy(params), jparams)

    @pytest.mark.parametrize("name", list(ARCHS))
    def test_masked_forward_matches_reference(self, space, jspace, name):
        bank = np_bank(space, seed=5)
        _, t_oh, j_oh = features(space, 33, seed=5)
        arch = space.tokens_to_arch(ARCHS[name])
        got = space.forward(params_from_numpy(bank, "cpu"), t_oh,
                            space.arch_arrays(arch, device="cpu"))
        want = jspace.forward(jax.tree.map(jnp.asarray, bank), j_oh,
                              jspace.arch_arrays(jspace.tokens_to_arch(ARCHS[name])))
        for t in space.tasks:
            np.testing.assert_allclose(got[t].numpy(), np.asarray(want[t]),
                                       rtol=FWD_TOL, atol=FWD_TOL)

    @pytest.mark.parametrize("name", list(ARCHS))
    def test_extract_child_params_byte_equal(self, space, jspace, name):
        bank = np_bank(space, seed=6)
        tbank = params_from_numpy(bank, "cpu")
        arch = space.tokens_to_arch(ARCHS[name])
        child = space.extract_child_params(tbank, arch)
        want = jax.device_get(jspace.extract_child_params(bank, jspace.tokens_to_arch(ARCHS[name])))
        assert_bytes_equal(params_to_numpy(child), want)
        # A standalone copy: writing to the child leaves the bank as it was.
        for leaf in torch_leaves(child):
            assert leaf.is_contiguous() and not leaf.requires_grad
            leaf.add_(1.0)
        assert_bytes_equal(params_to_numpy(tbank), bank)

    @pytest.mark.parametrize("name", list(ARCHS))
    def test_bank_gradients_match_reference(self, space, jspace, name):
        bank = np_bank(space, seed=7)
        digits, t_oh, j_oh = features(space, 29, seed=7)
        rng = np.random.default_rng(7)
        codes = np.stack([rng.integers(0, c, size=digits.shape[0]) for c in space.out_cards],
                         axis=1).astype(np.int32)
        arch = space.tokens_to_arch(ARCHS[name])
        tbank, leaves = with_grad(params_from_numpy(bank, "cpu"))
        loss = port_child_loss(space, tbank, t_oh, torch.from_numpy(codes),
                               space.arch_arrays(arch, device="cpu"))
        grads = torch.autograd.grad(loss, leaves)
        jaa = jspace.arch_arrays(jspace.tokens_to_arch(ARCHS[name]))
        jbank = jax.tree.map(jnp.asarray, bank)
        jloss, jgrads = j_loss_and_grad(jbank, j_oh, jnp.asarray(codes), jaa, jspace)
        np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=SCORE_RTOL)
        jleaves = np_leaves(jax.device_get(jgrads))
        assert len(jleaves) == len(grads)
        for g, (path, jg) in zip(grads, jleaves):
            np.testing.assert_allclose(g.numpy(), jg, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                       err_msg=str(path))


def controller_pair(kw, seed=0, reference_init=False):
    """Both packages' controller specs and one set of carried params:
    :func:`np_controller`'s, or the reference's ``init_controller``'s."""
    space, jspace = SearchSpace(**kw), JSpace(**kw)
    cspec, jcspec = ctrl.ControllerSpec.for_space(space), jctrl.ControllerSpec.for_space(jspace)
    p = (jax.device_get(jctrl.init_controller(jcspec, seed=seed)) if reference_init
         else np_controller(cspec, seed))
    return cspec, jcspec, params_from_numpy(p, "cpu"), jax.tree.map(jnp.asarray, p)


def token_sequences(cspec, n=16, seed=0):
    """``n`` sequences: the first ``max_choices`` take every choice at
    every step (``i % limit``), the rest are drawn."""
    limits = [cspec.depth_choices if k == 0 else cspec.size_choices for k in cspec.kinds]
    rng = np.random.default_rng(seed)
    seqs = [[i % lim for lim in limits] for i in range(cspec.max_choices)]
    seqs += [[int(rng.integers(0, lim)) for lim in limits] for _ in range(n - len(seqs))]
    return np.asarray(seqs, dtype=np.int32)


class TestControllerAgainstReference:
    def test_spec_equals_reference(self):
        for kw in (SMALL, PAPER, PAPER_ONE_TASK):
            cspec, jcspec, _, _ = controller_pair(kw)
            for f in ("num_decisions", "depth_choices", "size_choices", "kinds", "vocab",
                      "max_choices"):
                assert getattr(cspec, f) == getattr(jcspec, f), f
            for kind in (0, 1):
                for choice in range(cspec.max_choices):
                    want = int(jcspec.token_id(jnp.int32(kind), jnp.int32(choice)))
                    assert cspec.token_id(kind, choice) == want
                    assert int(cspec.token_id(kind, torch.tensor(choice))) == want

    def test_init_controller_layout(self):
        space = SearchSpace(**PAPER)
        cspec = ctrl.ControllerSpec.for_space(space)
        params = params_to_numpy(ctrl.init_controller(cspec, seed=2, device="cpu"))
        jparams = jax.device_get(jctrl.init_controller(jctrl.ControllerSpec.for_space(
            JSpace(**PAPER)), seed=2))
        assert sorted(params) == sorted(jparams)
        for k in jparams:
            assert params[k].shape == jparams[k].shape and params[k].dtype == jparams[k].dtype
        assert not params["b"].any()
        ws = np.concatenate([params[k].ravel() for k in params if k != "b"])
        np.testing.assert_allclose(ws.std(), 0.05, rtol=0.05)

    @pytest.mark.parametrize("kw", [SMALL, PAPER], ids=["small", "paper"])
    def test_logprob_and_entropy_match_reference(self, kw):
        cspec, jcspec, params, jparams = controller_pair(kw, seed=1)
        seqs = token_sequences(cspec, seed=1)
        for seq in seqs:
            logp, ent = ctrl.logprob_of(params, cspec, seq)
            jlogp, jent = jctrl.logprob_of(jparams, jcspec, jnp.asarray(seq))
            np.testing.assert_allclose(float(logp), float(jlogp), rtol=SCORE_RTOL)
            np.testing.assert_allclose(float(ent), float(jent), rtol=SCORE_RTOL)

    @pytest.mark.parametrize("kw", [SMALL, PAPER], ids=["small", "paper"])
    @pytest.mark.parametrize("which", [0, 1], ids=["logp", "entropy"])
    def test_gradients_match_reference(self, kw, which):
        cspec, jcspec, params, jparams = controller_pair(kw, seed=2, reference_init=True)
        jgrad = jax.jit(jax.grad(lambda p, s: jctrl.logprob_of(p, jcspec, s)[which]))
        for seq in token_sequences(cspec, seed=2):
            tparams, leaves = with_grad(params)
            grads = torch.autograd.grad(ctrl.logprob_of(tparams, cspec, seq)[which], leaves)
            jleaves = np_leaves(jax.device_get(jgrad(jparams, jnp.asarray(seq))))
            assert len(jleaves) == len(grads)
            for g, (path, jg) in zip(grads, jleaves):
                np.testing.assert_allclose(g.numpy(), jg, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                           err_msg=f"{seq} {path}")

    @pytest.mark.parametrize("kw", [SMALL, PAPER], ids=["small", "paper"])
    def test_port_samples_score_the_same_in_reference(self, kw):
        cspec, jcspec, params, jparams = controller_pair(kw, seed=3)
        gen = torch.Generator().manual_seed(3)
        limits = [cspec.depth_choices if k == 0 else cspec.size_choices for k in cspec.kinds]
        for _ in range(8):
            tokens, logp, ent = ctrl.sample_arch(params, cspec, gen)
            assert all(0 <= t < lim for t, lim in zip(tokens.tolist(), limits))
            jlogp, jent = jctrl.logprob_of(jparams, jcspec, jnp.asarray(tokens.numpy()))
            np.testing.assert_allclose(float(logp), float(jlogp), rtol=SCORE_RTOL)
            np.testing.assert_allclose(float(ent), float(jent), rtol=SCORE_RTOL)

    def test_first_decision_frequencies_follow_reference_softmax(self):
        """4,096 samples: each first choice's share within 4 standard
        errors of the reference's step-0 softmax (padded choices never)."""
        cspec, jcspec, params, jparams = controller_pair(PAPER_ONE_TASK, seed=4)
        h = jnp.zeros((ctrl.HIDDEN,), jnp.float32)
        h, _ = jctrl._lstm_step(jparams, h, h, jparams["embed"][0])
        p = np.asarray(jax.nn.softmax(jctrl._step_logits(jparams, jcspec, h, 0)), np.float64)
        assert p.shape == (cspec.max_choices,) and p[cspec.depth_choices:].max() < 1e-30
        n = 4096
        gen = torch.Generator().manual_seed(4)
        first = np.array([int(ctrl.sample_arch(params, cspec, gen)[0][0]) for _ in range(n)])
        freq = np.bincount(first, minlength=cspec.max_choices) / n
        assert freq[cspec.depth_choices:].sum() == 0
        se = np.sqrt(p * (1 - p) / n)
        assert (np.abs(freq - p) <= 4 * se).all(), (freq, p)
        assert p[:cspec.depth_choices].min() > 0.05  # a distribution the test can tell apart


@contextlib.contextmanager
def no_host_copies():
    """``item``, ``tolist`` and the conversions to Python scalars raise."""
    def refuse(*a, **k):
        raise AssertionError("copied a tensor to the host")

    with pytest.MonkeyPatch.context() as mp:
        for name in ("item", "tolist", "__bool__", "__int__", "__float__"):
            mp.setattr(torch.Tensor, name, refuse)
        yield


class TestNoHostSync:
    def test_forward_needs_no_host_sync(self, space):
        bank = params_from_numpy(np_bank(space, seed=8), "cpu")
        _, t_oh, _ = features(space, 9, seed=8)
        aas = [space.arch_arrays(space.tokens_to_arch(ARCHS[n]), device="cpu") for n in EDGE]
        want = [space.forward(bank, t_oh, aa) for aa in aas]
        with no_host_copies():
            got = [space.forward(bank, t_oh, aa) for aa in aas]
            with pytest.raises(AssertionError, match="host"):
                bool(aas[0]["trunk_depth"] > 0)
        for g, w in zip(got, want):
            for t in space.tasks:
                assert torch.equal(g[t], w[t])

    def test_controller_needs_no_host_sync(self, space):
        cspec = ctrl.ControllerSpec.for_space(space)
        params = params_from_numpy(np_controller(cspec, seed=9), "cpu")
        with no_host_copies():
            tokens, logp, _ = ctrl.sample_arch(params, cspec, torch.Generator().manual_seed(9))
            logp_r, _ = ctrl.logprob_of(params, cspec, tokens)
        assert tokens.shape == (cspec.num_decisions,) and logp.shape == logp_r.shape == ()


class TestDeviceDefaults:
    @pytest.fixture
    def no_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def test_entry_points_default_to_cuda(self, space, no_cuda):
        cspec = ctrl.ControllerSpec.for_space(space)
        arch = space.tokens_to_arch(ARCHS["full"])
        for call in (space.init_bank, lambda: space.arch_arrays(arch),
                     lambda: ctrl.init_controller(cspec),
                     lambda: space.init_bank(device="cuda")):
            with pytest.raises(RuntimeError, match="CUDA"):
                call()

    def test_search_defaults_to_cuda(self, no_cuda):
        """``run_mhas`` resolves its device before any work: no bank, no
        controller and no fine-tune on the CPU unless asked for."""
        from repro_torch.core.mhas import MHASConfig, run_mhas
        from repro_torch.data import synthetic_multi_column

        table = synthetic_multi_column(n=200, correlation="high", cardinalities=(3, 4), seed=0)
        cfg = MHASConfig(layer_sizes=(8,), total_iters=1, model_iters=1, finetune_epochs=1)
        for call in (lambda: run_mhas(table, cfg), lambda: run_mhas(table, cfg, device="cuda")):
            with pytest.raises(RuntimeError, match="CUDA"):
                call()


# ------------------------------------------------------ the paper's widths
PAPER_ARCHS = {
    "full 2,000": [2, 6, 6] * 3,
    "mixed": [1, 4, 0, 2, 5, 6, 0, 3, 3],
}


@pytest.fixture(scope="module")
def paper_bank():
    space = SearchSpace(**PAPER)
    return space, space.init_bank(seed=0, device="cpu")


@pytest.mark.parametrize("name", list(PAPER_ARCHS))
def test_paper_width_child(paper_bank, name):
    """Layer sizes up to 2,000 on 64 keys: the port's masked forward
    against its sliced child and against the reference's masked forward
    on the same bank; the child cut byte for byte as the reference's."""
    space, bank = paper_bank
    jspace = JSpace(**PAPER)
    assert space.max_width == 2000
    _, t_oh, j_oh = features(space, 64, seed=10)
    arch = space.tokens_to_arch(PAPER_ARCHS[name])
    jarch = jspace.tokens_to_arch(PAPER_ARCHS[name])
    masked = space.forward(bank, t_oh, space.arch_arrays(arch, device="cpu"))
    child = space.extract_child_params(bank, arch)
    sliced = forward_onehot(child, t_oh[:, : space.feature_dim], space.child_spec(arch))
    jbank = params_to_numpy(bank)
    want = jspace.forward(jax.tree.map(jnp.asarray, jbank), j_oh, jspace.arch_arrays(jarch))
    for t in space.tasks:
        torch.testing.assert_close(masked[t], sliced[t], rtol=FWD_TOL, atol=FWD_TOL)
        np.testing.assert_allclose(masked[t].numpy(), np.asarray(want[t]),
                                   rtol=FWD_TOL, atol=FWD_TOL)
    assert_bytes_equal(params_to_numpy(child),
                       jax.device_get(jspace.extract_child_params(jbank, jarch)))
