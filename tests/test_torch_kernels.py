"""The port's kernel wrappers (``repro_torch.kernels.ops``) on CPU tensors
— where they run the kernels' plain versions — against the reference's
(``repro.kernels.ops``), whose Pallas kernels run in interpret mode on
the CPU as the reference's own tests run them.

Cases: tile edges ±1, capacity and int32 key edges, negative keys,
residue encoders, ``with_exists=False``, predicate tables.  Tolerances
(``torch_port_util``): logits ``rtol=atol=1e-5``; codes equal except on
reference rows with a top-two margin below ``1e-5``; exists and match
bits equal.  The CUDA kernels themselves are held against the same
plain versions on the card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.bitvector import BitVector
from repro.core.encoding import KeyEncoder
from repro.core.model import forward_digits as j_forward_digits
from repro.kernels import ops as jops
from repro_torch.kernels import fused_mlp as fm
from repro_torch.kernels import ops, ref
from torch_port_util import (
    LOGIT_TOL, assert_codes_close, both_params, margins, spec_pair,
)

MLP_SWEEP = [
    # (shared, private, cards, base, n)
    ((64, 32), (16,), (7,), 10, 300),
    ((), (24,), (9,), 10, 257),        # no shared trunk: head-first gather
    ((), (), (4,), 10, 128),           # degenerate: input -> logits
    ((32, 32), (16, 8), (300,), 10, 100),  # card > 256
    ((16,), (8,), (3, 5, 7), 2, 500),  # binary digit base
]


class TestFusedMLPWrappers:
    @pytest.mark.parametrize("shared,private,cards,base,n", MLP_SWEEP)
    def test_logits_and_codes_match_reference(self, shared, private, cards, base, n):
        jspec, spec = spec_pair(shared, private, cards, base=base)
        jp, p = both_params(jspec, seed=n)
        digits = np.random.default_rng(n).integers(0, base, (n, spec.width)).astype(np.int32)
        want = jops.fused_mlp_logits(jp, jspec, jnp.asarray(digits))
        got = ops.fused_mlp_logits(p, spec, torch.from_numpy(digits))
        for t in spec.tasks:
            assert tuple(got[t].shape) == tuple(want[t].shape)
            np.testing.assert_allclose(got[t].numpy(), np.asarray(want[t]),
                                       rtol=LOGIT_TOL, atol=LOGIT_TOL)
        want_codes = jops.fused_mlp_codes(jp, jspec, jnp.asarray(digits))
        codes = ops.fused_mlp_codes(p, spec, torch.from_numpy(digits))
        assert codes.dtype == torch.int32 and codes.shape == (n, len(cards))
        assert_codes_close(codes.numpy(), want_codes, margins(want, spec.tasks))

    def test_tile_size_invariance_and_ragged_batch(self):
        jspec, spec = spec_pair((32,), (16,), (6,))
        _, p = both_params(jspec, seed=0)
        digits = torch.from_numpy(
            np.random.default_rng(0).integers(0, 10, (77, 5)).astype(np.int32)
        )
        outs = [ops.fused_mlp_codes(p, spec, digits, tile_n=t) for t in (8, 64, 256)]
        assert outs[0].shape == (77, 1)
        for o in outs[1:]:
            torch.testing.assert_close(o, outs[0], rtol=0, atol=0)
        want = ref.ref_fused_mlp_codes(p, digits, spec)
        torch.testing.assert_close(outs[0], want, rtol=0, atol=0)

    def test_unpadded_batch_raises(self):
        jspec, spec = spec_pair((16,), (), (3,))
        _, p = both_params(jspec)
        flat, _ = ops.pad_flat_weights(p, spec)
        with pytest.raises(ValueError, match="multiple"):
            fm.fused_mlp_call(torch.zeros((100, 5), dtype=torch.int32), flat, spec, 64,
                              128, ops.card_pads(spec), True)


TILE = 64


def lookup_setup(residues=(), tasks=2, seed=3, max_key=9999):
    """Encoder, spec pair, params pair and a bitvector holding a third
    of the keys below 10,000 (whatever the encoder's domain)."""
    enc = KeyEncoder(max_key, base=10, residues=residues)
    jspec, spec = spec_pair((32,), (16,), tuple(3 + 2 * i for i in range(tasks)),
                            width=enc.width)
    jp, p = both_params(jspec, seed=seed)
    rng = np.random.default_rng(seed)
    bv = BitVector.from_keys(rng.choice(10_000, size=10_000 // 3, replace=False))
    return enc, jspec, spec, jp, p, bv


def run_both(setup, keys, with_exists=True, n_preds=0, seed=0):
    """Pad keys to the tile with -1, run both wrappers, compare."""
    enc, jspec, spec, jp, p, bv = setup
    n = keys.shape[0]
    n_pad = -(-max(n, 1) // TILE) * TILE
    kp = np.full(n_pad, -1, dtype=np.int32)
    kp[:n] = np.where((keys >= 0) & (keys < 2**31), keys, -1)
    pos = np.asarray(enc.position_ops(), dtype=np.int32)
    rng = np.random.default_rng(seed)
    tables = [
        (rng.random(ops._round_up(spec.card_map[t], ops.LANE)) < 0.5).astype(np.int32)
        for t in spec.tasks[:n_preds]
    ]
    tasks = tuple(range(n_preds))[::-1]  # table j indexes head n_preds-1-j
    jflat, _ = jops.pad_flat_weights(jp, jspec)
    jc, je, jm = jops.fused_lookup(
        jflat, jspec, jnp.asarray(kp), jnp.asarray(pos),
        jnp.asarray(bv.words.view(np.uint32)) if with_exists else None, enc.capacity,
        tile_n=TILE, with_exists=with_exists,
        pred_tables=tuple(jnp.asarray(t) for t in tables), pred_tasks=tasks,
    )
    flat, _ = ops.pad_flat_weights(p, spec)
    c, e, m = ops.fused_lookup(
        flat, spec, torch.from_numpy(kp), torch.from_numpy(pos),
        ops.words_tensor(bv.words, "cpu") if with_exists else None, enc.capacity,
        tile_n=TILE, with_exists=with_exists,
        pred_tables=tuple(torch.from_numpy(t) for t in tables), pred_tasks=tasks,
    )
    in_cap = (kp >= 0) & (kp < enc.capacity)
    digits = enc.digits(np.where(in_cap, kp, 0))
    marg = margins(j_forward_digits(jp, jnp.asarray(digits), jspec), spec.tasks)
    bad = assert_codes_close(c.numpy(), np.asarray(jc), marg)
    assert (c.numpy()[~in_cap] == 0).all()
    if with_exists:
        np.testing.assert_array_equal(e.numpy(), np.asarray(je))
        np.testing.assert_array_equal(e.numpy()[:n].astype(bool), bv.test(keys))
    else:
        assert e is None and je is None
    if n_preds:
        ok = (c.numpy() == np.asarray(jc)).all(axis=1)
        np.testing.assert_array_equal(m.numpy()[ok], np.asarray(jm)[ok])
    else:
        assert m is None
    return bad


class TestFusedLookupWrapper:
    @pytest.fixture(scope="class")
    def setup(self):
        return lookup_setup()

    @pytest.mark.parametrize("n", [63, 64, 65, 129])
    def test_tile_edges(self, setup, n):
        keys = np.random.default_rng(n).integers(0, 10000, n).astype(np.int64)
        run_both(setup, keys)

    def test_capacity_int32_and_negative_keys(self, setup):
        keys = np.array(
            [0, 1, 9999, 10000, 10001, 123456, 2**31 - 1, 2**31, 2**40, -1, -7, -(2**31)],
            dtype=np.int64,
        )
        run_both(setup, keys)

    def test_without_exists(self, setup):
        keys = np.random.default_rng(5).integers(-3, 10100, 100).astype(np.int64)
        run_both(setup, keys, with_exists=False)

    @pytest.mark.parametrize("n_preds", [1, 2])
    def test_predicate_tables(self, setup, n_preds):
        keys = np.random.default_rng(6).integers(-3, 10100, 120).astype(np.int64)
        run_both(setup, keys, n_preds=n_preds, seed=n_preds)

    @pytest.mark.parametrize("residues", [(7,), (5, 12)])
    def test_residue_encoders(self, residues):
        keys = np.random.default_rng(1).integers(0, 10000, 100).astype(np.int64)
        run_both(lookup_setup(residues=residues), keys)

    def test_plain_contract_matches_staged_oracle(self, setup):
        """The plain fused version equals the host staged path exactly."""
        enc, jspec, spec, jp, p, bv = setup
        keys = np.random.default_rng(9).integers(-5, 10050, 192).astype(np.int64)
        flat, _ = ops.pad_flat_weights(p, spec)
        kp = torch.from_numpy(keys.astype(np.int32))
        pos = torch.tensor(enc.position_ops(), dtype=torch.int32)
        c, e, _ = ref.fused_lookup(kp, pos, ops.words_tensor(bv.words, "cpu"), flat, spec,
                                   enc.capacity)
        want_c, want_e = ref.ref_fused_lookup(p, keys, enc, bv, spec)
        np.testing.assert_array_equal(c.numpy(), want_c)
        np.testing.assert_array_equal(e.numpy().astype(bool), want_e)

    def test_predicates_need_exists(self, setup):
        enc, jspec, spec, jp, p, bv = setup
        flat, _ = ops.pad_flat_weights(p, spec)
        with pytest.raises(ValueError, match="with_exists"):
            ops.fused_lookup(flat, spec, torch.full((64,), -1, dtype=torch.int32),
                             torch.zeros((spec.width, 2), dtype=torch.int32), None, 10,
                             tile_n=64, with_exists=False,
                             pred_tables=(torch.zeros(128, dtype=torch.int32),),
                             pred_tasks=(0,))
