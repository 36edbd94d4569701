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
