"""The port's multi-key and star-schema mappings
(``repro_torch.core.multikey``), on the CPU, held against the reference
``repro.core.multikey``.

Each package trains its own stores from the same numpy table (their
initial weights differ by design), and both are lossless, so every
lookup must answer byte for byte alike in the two packages and equal
the source table.  These are the cases of ``test_multikey.py``, plus a
key choice whose packed domain is past int32: the port's engine then
takes the host-digits tier (K2's plain version on the CPU) instead of
the fused tier (K1), and its existence test runs on the host.
"""

import numpy as np
import pytest

from repro.core import DeepMappingConfig as JConfig
from repro.core import Table as JTable
from repro.core.multikey import MultiKeyMapping as JMultiKey
from repro.core.multikey import RelationGraph as JRelationGraph
from repro.core.trainer import TrainConfig as JTrainConfig
from repro.data import customer_demographics_like as j_customer_demographics_like
from repro_torch.core import DeepMappingConfig, Table, TrainConfig
from repro_torch.core.inference import INT32_MAX
from repro_torch.core.multikey import MultiKeyMapping, RelationGraph
from repro_torch.data import customer_demographics_like
from torch_port_util import assert_values_equal

FAST_KW = dict(shared=(48,), private=(16,))
FAST = DeepMappingConfig(**FAST_KW, train=TrainConfig(epochs=10, batch_size=512))
J_FAST = JConfig(**FAST_KW, train=JTrainConfig(epochs=10, batch_size=512))
#: The reference benchmark's DM-R config (``benchmarks/common.py``), at
#: a few epochs.
DMR_KW = dict(shared=(128, 64), private=(16,), codec="zstd", partition_bytes=64 * 1024,
              auto_residues=True)
DMR = DeepMappingConfig(**DMR_KW, train=TrainConfig(epochs=4, batch_size=8192))
J_DMR = JConfig(**DMR_KW, train=JTrainConfig(epochs=4, batch_size=8192))


def tables(make):
    """``make(cls)`` for the reference's ``Table`` and the port's."""
    return make(JTable), make(Table)


def orders(cls):
    n = 600
    keys = np.arange(n, dtype=np.int64)
    return cls(keys=keys, columns={
        "order_no": (10_000 + keys * 3).astype(np.int64),  # alt unique key
        "status": np.array(["F", "O", "P"])[(keys // 8) % 3],
        "clerk": ((keys // 4) % 50).astype(np.int32),
    })


def both_lookup(mks, choice, key_values, columns=None):
    """Lookup through both packages' mappings; the answers must be
    byte-identical.  Returns the port's ``(values, exists)``."""
    (jv, je), (v, e) = (mk.lookup(choice, key_values, columns) for mk in mks)
    np.testing.assert_array_equal(e, je)
    assert_values_equal(v, jv, exists=e)
    return v, e


def build_both(make, choices, configs=(J_FAST, FAST)):
    jt, t = tables(make)
    return (JMultiKey.build(jt, choices, configs[0]),
            MultiKeyMapping.build(t, choices, configs[1], device="cpu")), t


@pytest.fixture(scope="module")
def alt_key():
    return build_both(orders, [("__key__",), ("order_no",)])


class TestMultiKeyMapping:
    def test_lookup_by_alternate_key(self, alt_key):
        mks, t = alt_key
        vals, exists = both_lookup(mks, ("order_no",), [t.columns["order_no"][:50]])
        assert exists.all()
        np.testing.assert_array_equal(vals["status"], t.columns["status"][:50])
        np.testing.assert_array_equal(vals["clerk"], t.columns["clerk"][:50])

    def test_multiple_choices_coexist(self, alt_key):
        mks, t = alt_key
        assert set(mks[1].key_choices) == {("__key__",), ("order_no",)}
        v1, e1 = both_lookup(mks, ("__key__",), [t.keys[:20]])
        v2, e2 = both_lookup(mks, ("order_no",), [t.columns["order_no"][:20]])
        assert e1.all() and e2.all()
        np.testing.assert_array_equal(v1["status"], v2["status"])
        assert all(s.device.type == "cpu" for s in mks[1]._stores.values())
        assert mks[1].size_bytes() > 0

    def test_missing_alt_keys_null(self, alt_key):
        mks, _ = alt_key
        _, exists = both_lookup(mks, ("order_no",), [np.array([1, 2, 3], dtype=np.int64)])
        assert not exists.any()

    def test_non_unique_key_choice_rejected(self):
        jt, t = tables(orders)
        for cls, table, cfg, kw in ((JMultiKey, jt, J_FAST, {}),
                                    (MultiKeyMapping, t, FAST, {"device": "cpu"})):
            with pytest.raises(ValueError, match="uniquely"):
                cls.build(table, [("status",)], cfg, **kw)
            with pytest.raises(KeyError):
                cls.build(table, [("nope",)], cfg, **kw)

    def test_choice_covering_every_column_is_refused(self):
        """A key choice that holds every column leaves nothing to map:
        both packages refuse it (the model needs at least one task)."""
        jt, t = tables(orders)
        every = ("order_no", "status", "clerk")
        with pytest.raises(ValueError, match="at least one task"):
            JMultiKey.build(jt, [every], J_FAST)
        with pytest.raises(ValueError, match="at least one task"):
            MultiKeyMapping.build(t, [every], FAST, device="cpu")

    def test_composite_string_key(self):
        def make(cls):
            keys = np.arange(200, dtype=np.int64)
            return cls(keys=keys, columns={
                "region": np.array(["EU", "US"])[keys % 2],
                "seq": (keys // 2).astype(np.int64),
                "val": ((keys // 4) % 7).astype(np.int32),
            })
        mks, t = build_both(make, [("region", "seq")])
        vals, exists = both_lookup(mks, ("region", "seq"),
                                   [t.columns["region"][:30], t.columns["seq"][:30]])
        assert exists.all()
        np.testing.assert_array_equal(vals["val"], t.columns["val"][:30])
        _, e = both_lookup(mks, ("region", "seq"), [np.array(["XX"]), np.array([0])])
        assert not e.any()


class TestKeyDomainTiers:
    """Two composite choices over a ``customer_demographics`` prefix
    under DM-R: (key, credit rating) packs into int32 and serves through
    the fused tier; (key, purchase estimate) does not (purchase
    estimates are raw integers up to 10,000, so the radix is 10,001),
    and takes the host-digits tier."""

    N = 215_000  # 215,001 x 10,001 > 2**31 - 1

    @pytest.fixture(scope="class")
    def mks(self):
        choices = [("__key__", "cd_credit_rating"), ("__key__", "cd_purchase_estimate")]
        jt, t = j_customer_demographics_like(n=self.N), customer_demographics_like(n=self.N)
        return (JMultiKey.build(jt, choices, J_DMR),
                MultiKeyMapping.build(t, choices, DMR, device="cpu")), t

    @pytest.mark.parametrize("column,tier", (("cd_credit_rating", "fused"),
                                              ("cd_purchase_estimate", "pallas_digits")))
    def test_lossless_on_every_row_through_its_tier(self, mks, column, tier):
        mk, t = mks
        choice = ("__key__", column)
        store = mk[1]._stores[choice]
        wide = store.encoder.capacity > INT32_MAX
        assert wide == (tier == "pallas_digits")
        stats = store.engine.stats
        before = (stats.fused_calls, stats.pallas_calls)
        vals, exists = both_lookup(mk, choice, [t.keys, t.columns[column]])
        assert exists.all()
        for c, v in vals.items():
            np.testing.assert_array_equal(v, t.columns[c])
        assert set(vals) == set(t.columns) - {column}
        took = {"fused": stats.fused_calls - before[0],
                "pallas_digits": stats.pallas_calls - before[1]}
        assert took[tier] > 0 and sum(took.values()) == took[tier]
        assert stats.jit_calls == 0 and store.memorized_fraction() > 0

    @pytest.mark.parametrize("column", ("cd_credit_rating", "cd_purchase_estimate"))
    def test_unknown_combinations_read_as_absent(self, mks, column):
        mk, t = mks
        rng = np.random.default_rng(0)
        rows = rng.integers(0, t.num_rows, 500)
        domain = np.unique(t.columns[column])
        shifted = domain[(np.searchsorted(domain, t.columns[column][rows]) + 1) % domain.size]
        unseen = np.array(["Excellent"]) if column == "cd_credit_rating" else np.array([-5])
        for keys, values in ((t.keys[rows], shifted),          # wrong attribute for the key
                             (t.keys[rows] + self.N, t.columns[column][rows]),  # no such key
                             (t.keys[:1], unseen)):             # a value outside the domain
            _, exists = both_lookup(mk, ("__key__", column), [keys, values])
            assert not exists.any()


class TestRelationGraph:
    def test_star_schema_two_hop(self):
        def dim(cls):
            keys = np.arange(40, dtype=np.int64)
            return cls(keys=keys, columns={"part_name": np.array([f"part{i % 10}" for i in keys])})

        def fact(cls):
            keys = np.arange(500, dtype=np.int64)
            return cls(keys=keys, columns={"part_sk": ((keys * 7) % 40).astype(np.int32),
                                           "qty": ((keys // 8) % 5).astype(np.int32)})

        graphs = JRelationGraph(), RelationGraph()
        for g, cls, cfg, kw in ((graphs[0], JTable, J_FAST, {}),
                                (graphs[1], Table, FAST, {"device": "cpu"})):
            g.add_relation("part", dim(cls), cfg, **kw)
            g.add_relation("sales", fact(cls), cfg, **kw)
            g.add_foreign_key("sales", "part_sk", "part")
        keys = np.arange(64, dtype=np.int64)
        (jv, je), (v, e) = (g.lookup_through("sales", keys, "part_sk", columns=("part_name",))
                            for g in graphs)
        assert e.all() and je.all()
        assert_values_equal(v, jv)
        np.testing.assert_array_equal(v["part_name"], dim(Table).columns["part_name"][
            fact(Table).columns["part_sk"][:64]])
        (jv, je), (v, e) = (g.lookup("sales", keys[:10]) for g in graphs)
        assert_values_equal(v, jv)

    def test_unknown_fk_raises(self):
        g = RelationGraph()
        g.add_relation("a", Table(keys=np.arange(10), columns={"x": np.zeros(10, np.int32)}),
                       FAST, device="cpu")
        with pytest.raises(KeyError):
            g.add_foreign_key("a", "x", "missing")

    def test_size_accounting(self):
        t = Table(keys=np.arange(50), columns={"x": (np.arange(50) % 3).astype(np.int32)})
        g = RelationGraph()
        g.add_relation("a", t, FAST, device="cpu")
        assert g.size_bytes() == g._relations["a"].store.size_bytes() > 0
