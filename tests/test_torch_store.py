"""The slice whole: a DeepMapping store built by the port and by the
reference from the same table and the same weights, on the CPU.

The weights come from a short run of the reference trainer (so the model
memorizes part of the table and T_aux holds the rest), carried to the
port as numpy.  The reference builds with ``use_pallas=True`` (Pallas in
interpret mode), the port with ``use_kernels=True`` (the kernels' plain
versions on CPU tensors).  Held equal: T_aux's key set (up to reference
near-tie rows, of which there must be few), lookups of present, absent
and out-of-capacity keys against the reference and the source table,
and all of it again after interleaved inserts, deletes and updates.
"""

import jax
import numpy as np
import pytest

from conftest import make_periodic_table
from repro.core import DeepMappingConfig as JConfig
from repro.core import DeepMappingStore as JStore
from repro.core.model import MLPSpec as JSpec
from repro.core.model import forward_digits as j_forward_digits
from repro.core.trainer import TrainConfig, train
from repro_torch.core import DeepMappingConfig, DeepMappingStore, MLPSpec, Table
from repro_torch.core.convert import params_from_numpy
from torch_port_util import MARGIN_TOL, margins

SHARED, PRIVATE = (32, 32), (16,)


def trained(table):
    enc_width = len(str(table.max_key))
    cards = {c: len(np.unique(v)) for c, v in table.columns.items()}
    kw = dict(base=10, width=enc_width, shared=SHARED,
              private={c: PRIVATE for c in table.columns}, out_cards=cards)
    jspec = JSpec(**kw)
    from repro.core.encoding import KeyEncoder, build_codecs

    enc = KeyEncoder(table.max_key, base=10)
    assert enc.width == enc_width
    codecs = build_codecs(table.columns)
    codes = np.stack([codecs[t].codes for t in jspec.tasks], axis=1)
    params, _, _ = train(jspec, enc.digits(table.keys), codes,
                         TrainConfig(epochs=6, batch_size=512))
    return jspec, MLPSpec(**kw), jax.device_get(params), enc


def near_tie_keys(jstore, jparams, jspec, keys):
    """Keys whose reference top-two margin is below the tolerance in any
    head: the only rows where the two packages may disagree."""
    enc = jstore.encoder
    in_cap = (keys >= 0) & (keys < enc.capacity)
    lg = j_forward_digits(jparams, enc.digits(np.where(in_cap, keys, 0)), jspec)
    m = margins(lg, jspec.tasks).min(axis=1)
    return set(keys[(m < MARGIN_TOL) & in_cap].tolist())


def aux_keys(store, keys):
    return set(keys[store.aux.get(keys)[0]].tolist())


def assert_lookup_equal(jstore, store, keys, ties, source=None):
    jv, je = jstore.lookup(keys)
    v, e = store.lookup(keys)
    np.testing.assert_array_equal(e, je)
    ok = ~np.isin(keys, list(ties)) if ties else np.ones(keys.size, bool)
    for c in jv:
        np.testing.assert_array_equal(v[c][e & ok], jv[c][e & ok])
        if source is not None:
            np.testing.assert_array_equal(v[c][e], source[c][e])
    return v, e


@pytest.fixture(scope="module")
def built():
    ref_table = make_periodic_table(n=1500, period=16, cards=(5, 3))
    jspec, spec, jparams, enc = trained(ref_table)
    table = Table(keys=ref_table.keys.copy(),
                  columns={c: v.copy() for c, v in ref_table.columns.items()})
    jstore = JStore.build(ref_table, JConfig(shared=SHARED, private=PRIVATE, use_pallas=True),
                          spec=jspec, params=jparams)
    store = DeepMappingStore.build(table, DeepMappingConfig(shared=SHARED, private=PRIVATE),
                                   spec=spec, params=params_from_numpy(jparams, "cpu"),
                                   device="cpu")
    ties = near_tie_keys(jstore, jparams, jspec, table.keys)
    assert len(ties) <= 15
    return ref_table, jspec, jparams, jstore, store, ties


class TestBuildAndLookup:
    def test_aux_key_set_matches_reference(self, built):
        table, _, _, jstore, store, ties = built
        a, b = aux_keys(store, table.keys), aux_keys(jstore, table.keys)
        assert a ^ b <= ties
        assert 0 < len(a) < table.num_rows  # a partly memorizing model
        assert store.engine.stats.pallas_calls >= 1  # build took the digits kernel tier
        assert store.engine.stats.jit_calls == 0

    def test_present_absent_out_of_capacity(self, built):
        table, _, _, jstore, store, ties = built
        assert_lookup_equal(jstore, store, table.keys, ties, source=table.columns)
        v, e = store.lookup(table.keys)
        assert e.all()
        for c in table.columns:
            np.testing.assert_array_equal(v[c], table.columns[c])
        absent = np.setdiff1d(np.arange(table.max_key + 50), table.keys)
        odd = np.array([-1, -9, 10**4, 10**4 + 1, 2**31 - 1, 2**31, 2**40], dtype=np.int64)
        for keys in (absent, odd):
            _, e = assert_lookup_equal(jstore, store, keys, ties)
            assert not e.any()
        assert store.engine.stats.fused_calls >= 1

    def test_projection_and_accounting(self, built):
        table, _, _, jstore, store, _ = built
        v, e = store.lookup(table.keys[:100], columns=("col1",))
        assert list(v) == ["col1"] and e.all()
        np.testing.assert_array_equal(v["col1"], table.columns["col1"][:100])
        a, b = store.size_breakdown(), jstore.size_breakdown()
        assert a["model"] == b["model"] and a["exist_bitvector"] == b["exist_bitvector"]
        assert a["decode_map"] == b["decode_map"]
        if aux_keys(store, table.keys) == aux_keys(jstore, table.keys):
            assert a == b
            assert store.compression_ratio() == jstore.compression_ratio()
            assert store.memorized_fraction() == jstore.memorized_fraction()


class TestModifications:
    def test_interleaved_mutations_match(self, built):
        table, jspec, jparams, jstore, store, ties = built
        rng = np.random.default_rng(0)
        expect = {k: dict(zip(table.keys.tolist(), v.tolist())) for k, v in table.columns.items()}
        alive = set(table.keys.tolist())
        for step in range(3):
            free = np.setdiff1d(np.arange(table.max_key + 400), np.fromiter(alive, np.int64))
            ins = rng.choice(free, 40, replace=False)
            cols = {"col0": rng.integers(0, 7, 40).astype(np.int32),   # 5, 6 unseen
                    "col1": rng.integers(0, 3, 40).astype(np.int32)}
            live = np.fromiter(alive, np.int64)
            upd = rng.choice(live, 30, replace=False)
            ucols = {"col0": rng.integers(0, 5, 30).astype(np.int32),
                     "col1": rng.integers(0, 3, 30).astype(np.int32)}
            dele = rng.choice(np.setdiff1d(live, upd), 25, replace=False)
            for s in (jstore, store):
                s.insert(ins, cols)
                s.update(upd, ucols)
                s.delete(dele)
            for c in expect:
                expect[c].update(zip(ins.tolist(), cols[c].tolist()))
                expect[c].update(zip(upd.tolist(), ucols[c].tolist()))
            alive |= set(ins.tolist())
            alive -= set(dele.tolist())
            ties |= near_tie_keys(jstore, jparams, jspec, np.concatenate([ins, upd]))
            keys = np.arange(-2, table.max_key + 420, dtype=np.int64)
            v, e = assert_lookup_equal(jstore, store, keys, ties)
            np.testing.assert_array_equal(e, np.isin(keys, np.fromiter(alive, np.int64)))
            for c in expect:
                want = np.array([expect[c][k] for k in keys[e].tolist()])
                np.testing.assert_array_equal(v[c][e], want)
            assert aux_keys(store, keys) ^ aux_keys(jstore, keys) <= ties
        assert store.num_rows == jstore.num_rows and store.mutation_version() == 9

    def test_plain_tiers_store(self, built):
        """``use_kernels=False`` takes the jit tiers, as the reference's
        ``use_pallas=False`` does, and stays lossless."""
        table, jspec, jparams, _, _, _ = built
        t2 = Table(keys=table.keys.copy(), columns={c: v.copy() for c, v in table.columns.items()})
        store = DeepMappingStore.build(
            t2, DeepMappingConfig(shared=SHARED, private=PRIVATE, use_kernels=False),
            spec=MLPSpec(base=jspec.base, width=jspec.width, shared=jspec.shared,
                         private=jspec.private, out_cards=jspec.out_cards),
            params=params_from_numpy(jparams, "cpu"), device="cpu",
        )
        v, e = store.lookup(t2.keys)
        assert e.all()
        for c in t2.columns:
            np.testing.assert_array_equal(v[c], t2.columns[c])
        st = store.engine.stats
        assert st.jit_calls >= 2 and st.fused_calls == 0 and st.pallas_calls == 0

    def test_build_requires_weights(self, built):
        table = built[0]
        with pytest.raises(ValueError, match="M2"):
            DeepMappingStore.build(table, DeepMappingConfig(), device="cpu")
        bad = MLPSpec(base=10, width=3, shared=(4,), private={"col0": (), "col1": ()},
                      out_cards={"col0": 5, "col1": 3})
        with pytest.raises(ValueError, match="width"):
            DeepMappingStore.build(table, DeepMappingConfig(), spec=bad,
                                   params=params_from_numpy(built[2], "cpu"), device="cpu")
