"""The port's existence test K3 (``repro_torch.kernels.bitvector_test``)
on CPU tensors — where it runs its plain version — against the
reference's ``bitvector_test`` (Pallas in interpret mode, as the
reference's own tests run it) and the host ``BitVector.test``.

Mirrors ``tests/test_kernels.py::TestBitvectorKernel`` and its
hypothesis property.  Results are bits: equality, no tolerance.

Domain rule: inside ``[0, 32 * n_words)`` the port equals the reference
kernel bit for bit.  Outside it (keys at or past ``32 * n_words``,
negative keys, keys above int32) the port equals ``BitVector.test``,
which says absent.  The reference kernel does not: its ``jnp.take``
fills an out-of-range word with 0xFFFFFFFF, and its wrapper casts int64
keys to int32, so such keys can read as present.  The CUDA kernel is
held against the same plain version on the card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (before repro.kernels: circular import)
from repro.core.bitvector import BitVector as JBitVector
from repro.kernels import bitvector_test as j_bitvector_test
from repro.kernels.bitvector import pack_words32 as j_pack_words32
from repro.kernels.ref import ref_bitvector_test as j_ref_bitvector_test
from repro_torch import kernels
from repro_torch.core import BitVector
from repro_torch.kernels import bitvector as bv_kernel
from repro_torch.kernels import ops, ref

try:  # property test only
    from hypothesis import given, settings
    from hypothesis import strategies as st

    HAS_HYPOTHESIS = True
except ImportError:  # pragma: no cover
    HAS_HYPOTHESIS = False


def _vector(capacity, seed):
    rng = np.random.default_rng(seed)
    keys = rng.choice(capacity, size=max(1, capacity // 3), replace=False)
    return BitVector.from_keys(keys, capacity=capacity), JBitVector.from_keys(
        keys, capacity=capacity
    )


def _domain(bv):
    return 32 * ops.pack_words32(bv.words).shape[0]


class TestBitvectorKernel:
    @pytest.mark.parametrize("batch", [1, 1023, 1024, 1025])
    @pytest.mark.parametrize("capacity", [64, 100, 1000, 65536])
    def test_in_domain_matches_reference_kernel(self, capacity, batch):
        bv, jbv = _vector(capacity, capacity + batch)
        q = np.random.default_rng(batch).integers(0, _domain(bv), size=batch)
        q[0] = _domain(bv) - 1
        got = kernels.bitvector_test(bv.words, torch.from_numpy(q))
        assert got.dtype == torch.bool and got.shape == (batch,)
        want = np.asarray(j_bitvector_test(jbv.words, jnp.asarray(q)))
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), bv.test(q))

    @pytest.mark.parametrize("capacity", [64, 100, 1000, 65536])
    def test_out_of_domain_matches_host_bitvector(self, capacity):
        bv, _ = _vector(capacity, capacity)
        dom = _domain(bv)
        q = np.array([dom, dom + 1, dom + 31, 2 * dom, -1, -32, -2**31, 2**31 - 1, 2**31,
                      2**31 + 5, 2**32, 2**32 + 5, 2**40, -2**40, capacity, capacity - 1],
                     dtype=np.int64)
        got = kernels.bitvector_test(bv.words, torch.from_numpy(q))
        np.testing.assert_array_equal(got.numpy(), bv.test(q))
        assert not got[:-1].any()

    def test_int32_keys_and_empty_batch(self):
        bv, jbv = _vector(1000, 0)
        q = np.arange(-5, 1100, dtype=np.int32)
        got = kernels.bitvector_test(bv.words, torch.from_numpy(q))
        np.testing.assert_array_equal(got.numpy(), bv.test(q.astype(np.int64)))
        empty = kernels.bitvector_test(bv.words, torch.zeros(0, dtype=torch.int64))
        assert empty.shape == (0,) and empty.dtype == torch.bool

    def test_reference_out_of_domain_fault_is_not_copied(self):
        """The first keys on which the reference kernel and the host
        bitvector disagree (ROADMAP queue 3): the port sides with the
        host."""
        keys = np.array([0, 5, 63])
        bv, jbv = BitVector.from_keys(keys, capacity=64), JBitVector.from_keys(keys, capacity=64)
        q = np.array([0, 5, 63, 64, 100, -1, 2**31 - 1], dtype=np.int64)
        port = kernels.bitvector_test(bv.words, torch.from_numpy(q)).numpy()
        host = bv.test(q)
        np.testing.assert_array_equal(port, host)
        np.testing.assert_array_equal(port, [1, 1, 1, 0, 0, 0, 0])
        jax_kernel = np.asarray(j_bitvector_test(jbv.words, jnp.asarray(q.astype(np.int32))))
        np.testing.assert_array_equal(jax_kernel[:3], port[:3])
        assert jax_kernel[3:].all()

    def test_words_from_a_grown_and_cleared_vector(self):
        bv = BitVector(100)
        jbv = JBitVector(100)
        for b in (bv, jbv):
            b.set(np.arange(0, 300, 7), True)
            b.set(np.arange(0, 300, 21), False)
        q = np.arange(0, _domain(bv))
        got = kernels.bitvector_test(bv.words, torch.from_numpy(q)).numpy()
        np.testing.assert_array_equal(got, bv.test(q))
        np.testing.assert_array_equal(got, np.asarray(j_bitvector_test(jbv.words, jnp.asarray(q))))


def _edge_keys(bv, capacity):
    """The edge keys of ``test_out_of_domain_matches_host_bitvector``."""
    dom = _domain(bv)
    return np.array([dom, dom + 1, dom + 31, 2 * dom, -1, -32, -2**31, 2**31 - 1, 2**31,
                     2**31 + 5, 2**32, 2**32 + 5, 2**40, -2**40, capacity, capacity - 1],
                    dtype=np.int64)


def _as_keys(q, dtype):
    """``q`` as a tensor of ``dtype``; int32 keeps only the keys that fit."""
    if dtype == torch.int32:
        q = q[(q >= -2**31) & (q <= 2**31 - 1)]
    return torch.from_numpy(q).to(dtype)


def _view(base, view, n):
    """n keys of ``base`` (at least 2n + 3 long): the whole of its first
    n, or a view at an offset of 1 or 3 keys, or a stride of 2."""
    return {"whole": base[:n], "[1:]": base[1:1 + n], "[3:]": base[3:3 + n],
            "[::2]": base[::2][:n]}[view]


def _holds(bv, jbv, keys):
    """kernels.bitvector_test on ``keys`` (a tensor as the caller holds
    it) equals BitVector.test on every key and the reference kernel
    (Pallas, interpret mode) inside the word domain."""
    got = kernels.bitvector_test(bv.words, keys)
    assert got.dtype == torch.bool and got.shape == keys.shape
    q = keys.numpy().astype(np.int64)
    np.testing.assert_array_equal(got.numpy(), bv.test(q))
    inside = (q >= 0) & (q < _domain(bv))
    if inside.any():
        want = np.asarray(j_bitvector_test(jbv.words, jnp.asarray(q[inside])))
        np.testing.assert_array_equal(got.numpy()[inside], want)
    return got


VIEWS = ("whole", "[1:]", "[3:]", "[::2]")


class TestCallersKeys:
    """``bitvector_test`` on keys as a caller holds them: int32 or int64,
    contiguous, at a misaligned offset or strided, of any length (the
    card launches the kernel on them as they are; a strided view is made
    contiguous first)."""

    @pytest.mark.parametrize("n", [*range(1, 10), 65537])
    @pytest.mark.parametrize("view", VIEWS)
    @pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
    def test_views_and_lengths(self, dtype, view, n):
        bv, jbv = _vector(100_000, n)
        rng = np.random.default_rng([n, VIEWS.index(view)])
        dom = _domain(bv)
        base = np.concatenate([_edge_keys(bv, 100_000),
                               rng.integers(-64, dom + 64, 2 * n + 3)])
        rng.shuffle(base)
        keys = _view(_as_keys(base, dtype), view, n)
        assert keys.shape == (n,) and keys.is_contiguous() == (view != "[::2]" or n == 1)
        _holds(bv, jbv, keys)

    @pytest.mark.parametrize("capacity", [100, 65536])
    @pytest.mark.parametrize("view", VIEWS)
    @pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
    def test_edge_keys(self, dtype, view, capacity):
        bv, jbv = _vector(capacity, capacity)
        edges = _as_keys(_edge_keys(bv, capacity), dtype)
        base = torch.cat([edges, edges, edges[:3]])
        keys = _view(base, view, edges.shape[0])
        got = _holds(bv, jbv, keys)
        assert got.sum() <= 1  # only capacity - 1 can be present

    def test_other_dtypes_widen(self):
        bv, jbv = _vector(1000, 5)
        for dtype in (torch.int16, torch.uint8, torch.float64):
            keys = torch.arange(0, 120).to(dtype)
            _holds(bv, jbv, keys)
            _holds(bv, jbv, keys[1::3])


class TestPlainVersionAndCall:
    def test_plain_version_matches_reference_oracle(self):
        rng = np.random.default_rng(3)
        keys = rng.choice(4096, size=1000, replace=False)
        bv = BitVector.from_keys(keys, capacity=4096)
        words32 = ops.words_tensor(bv.words, "cpu")
        q = rng.integers(0, 4096, size=256).astype(np.int32)
        got = ref.ref_bitvector_test(words32, torch.from_numpy(q))
        want = j_ref_bitvector_test(jnp.asarray(bv.words.view(np.uint32)), jnp.asarray(q))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_call_contract_on_cpu(self):
        bv, _ = _vector(1000, 1)
        words32 = ops.words_tensor(bv.words, "cpu")
        before = bv_kernel.bitvector_call.launches
        keys = torch.arange(-3, 1021, dtype=torch.int32)
        out = bv_kernel.bitvector_call(keys, words32, 256)
        assert out.dtype == torch.int32 and out.shape == (1024,)
        np.testing.assert_array_equal(out.numpy().astype(bool), bv.test(keys.numpy()))
        assert bv_kernel.bitvector_call.launches == before  # CPU: no kernel launched
        with pytest.raises(ValueError, match="multiple"):
            bv_kernel.bitvector_call(keys[:1000], words32, 256)
        with pytest.raises(ValueError, match="int32"):
            bv_kernel.bitvector_call(keys.long(), words32, 256)
        with pytest.raises(TypeError, match="tensor"):
            kernels.bitvector_test(bv.words, np.arange(5))

    def test_test_call_contract_on_cpu(self):
        """The caller's-keys entry: int32 or int64, contiguous, any length
        and offset, bools out; its plain path launches nothing."""
        bv, _ = _vector(1000, 4)
        words32 = ops.words_tensor(bv.words, "cpu")
        before = bv_kernel.bitvector_call.launches
        for dtype in (torch.int32, torch.int64):
            keys = torch.arange(-3, 1100, dtype=dtype)
            for k in (keys, keys[1:], keys[3:8], keys[:1]):
                out = bv_kernel.bitvector_test_call(k, words32)
                assert out.dtype == torch.bool and out.shape == k.shape
                np.testing.assert_array_equal(out.numpy(), bv.test(k.numpy().astype(np.int64)))
            empty = bv_kernel.bitvector_test_call(keys[:0], words32)
            assert empty.dtype == torch.bool and empty.shape == (0,)
        assert bv_kernel.bitvector_call.launches == before  # CPU: no kernel launched
        keys = torch.arange(0, 64, dtype=torch.int64)
        with pytest.raises(ValueError, match="int32 or int64"):
            bv_kernel.bitvector_test_call(keys.to(torch.int16), words32)
        with pytest.raises(ValueError, match="contiguous"):
            bv_kernel.bitvector_test_call(keys[::2], words32)
        with pytest.raises(ValueError, match="1-d"):
            bv_kernel.bitvector_test_call(keys.view(8, 8), words32)
        with pytest.raises(ValueError, match="words32"):
            bv_kernel.bitvector_test_call(keys, words32.long())
        with pytest.raises(ValueError, match="one device"):
            bv_kernel.bitvector_test_call(keys, words32.to("meta"))

    def test_plain_version_domain_stops_at_int32(self):
        """A key above int32 reads as absent even where its word exists
        (more than 2**26 words), as in the kernel; below it, it reads its
        bit."""
        words32 = torch.ones(1, dtype=torch.int32).expand(2**26 + 4)
        keys = torch.tensor([2**31 - 32, 2**31, 2**31 + 32, 2**32], dtype=torch.int64)
        got = ref.ref_bitvector_test(words32, keys)
        assert got.tolist() == [1, 0, 0, 0]

    def test_pack_words32_lives_with_the_kernel(self):
        bv, _ = _vector(1000, 2)
        assert ops.pack_words32 is bv_kernel.pack_words32
        np.testing.assert_array_equal(bv_kernel.pack_words32(bv.words),
                                      j_pack_words32(bv.words))


if HAS_HYPOTHESIS:

    class TestBitvectorProperties:
        @settings(max_examples=25, deadline=None)
        @given(
            keys=st.lists(st.integers(0, 99999), min_size=1, max_size=64, unique=True),
            probe=st.lists(st.one_of(st.integers(0, 99999), st.integers(-2**33, 2**33)),
                           min_size=1, max_size=64),
        )
        def test_membership_property(self, keys, probe):
            bv = BitVector.from_keys(np.array(keys), capacity=100000)
            probe = np.array(probe, dtype=np.int64)
            got = kernels.bitvector_test(bv.words, torch.from_numpy(probe)).numpy()
            np.testing.assert_array_equal(got, np.isin(probe, np.array(keys)))
