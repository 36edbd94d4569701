"""The port's table generators (``repro_torch.data``) against the
reference's ``repro.data``: for the same arguments and seed, every
generator gives the same keys and columns, array for array (dtype and
bytes; no tolerance).  Also the cases of ``test_datasets.py``."""

import numpy as np
import pytest

import repro.data as jdata
import repro_torch.data as tdata
from repro.data.datasets import pearson_keyvalue as j_pearson
from repro_torch.core.table import pack_composite_key
from repro_torch.data.datasets import pearson_keyvalue

GENERATORS = (
    ("synthetic_single_column", dict(n=3000, correlation="low", seed=3)),
    ("synthetic_single_column", dict(n=3000, correlation="high", cardinality=5, seed=4)),
    ("synthetic_multi_column", dict(n=2000, correlation="low", seed=5)),
    ("synthetic_multi_column", dict(n=2000, correlation="high", cardinalities=(3, 5), seed=6)),
    ("cropland_like", dict(rows=64, cols=48, patch=8, seed=7)),
    ("orders_like", dict(n=1500, seed=8)),
    ("lineitem_like", dict(n=1500, seed=9)),
    ("part_like", dict(n=1500, seed=10)),
    ("customer_demographics_like", dict(n=40_000)),
    ("customer_demographics_like", dict()),
    ("catalog_sales_like", dict(n=2500, seed=11)),
    ("catalog_returns_like", dict(n=2500, seed=12)),
)


def test_exports_match_the_reference():
    assert {n for n in dir(jdata) if n.endswith("_like") or n.startswith("synthetic")} == {
        n for n in dir(tdata) if n.endswith("_like") or n.startswith("synthetic")}


@pytest.mark.parametrize("name,kw", GENERATORS,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(GENERATORS)])
def test_generator_equals_reference(name, kw):
    got, want = getattr(tdata, name)(**kw), getattr(jdata, name)(**kw)
    assert type(got).__module__.startswith("repro_torch.")
    assert got.keys.dtype == want.keys.dtype and got.keys.tobytes() == want.keys.tobytes()
    assert list(got.columns) == list(want.columns)
    for c in want.columns:
        g, w = got.columns[c], want.columns[c]
        assert g.dtype == w.dtype, c
        np.testing.assert_array_equal(g, w)
        assert g.tobytes() == w.tobytes(), c
    assert pearson_keyvalue(got) == j_pearson(want)


class TestSynthetic:
    def test_correlation_regimes(self):
        lo = tdata.synthetic_single_column(n=20000, correlation="low")
        hi = tdata.synthetic_single_column(n=20000, correlation="high")
        assert pearson_keyvalue(lo) < 0.05
        assert (np.diff(hi.columns["value"]) != 0).mean() < 0.05
        assert (np.diff(lo.columns["value"]) != 0).mean() > 0.4

    def test_unknown_correlation_raises(self):
        for fn in (tdata.synthetic_single_column, tdata.synthetic_multi_column):
            with pytest.raises(ValueError):
                fn(n=10, correlation="medium")


class TestTPC:
    def test_customer_demographics_cross_product(self):
        t = tdata.customer_demographics_like()
        assert t.num_rows == 1_920_800 and t.keys[0] == 1 and t.keys[-1] == t.num_rows
        combos = np.unique(np.stack([np.unique(v, return_inverse=True)[1]
                                     for v in t.columns.values()], axis=1), axis=0)
        assert combos.shape[0] == t.num_rows  # every attribute tuple once
        # the last attribute changes on every key (period 1), the first
        # on the half-way key
        assert (np.diff(t.columns["cd_dep_college_count"]) != 0).all()
        assert (t.columns["cd_gender"][: t.num_rows // 2] == "F").all()
        assert tdata.customer_demographics_like(n=4000).num_rows == 4000

    def test_orders_and_part_domains(self):
        t = tdata.orders_like(n=1000)
        assert set(np.unique(t.columns["o_orderstatus"])) <= {"F", "O", "P"}
        p = tdata.part_like(n=5000)
        assert len(np.unique(p.columns["p_brand"])) == 25

    def test_cropland_patches_and_keys(self):
        t = tdata.cropland_like(rows=64, cols=64, patch=8, noise=0.0)
        crop = t.columns["crop_type"].reshape(64, 64)
        assert (crop[:8, :8] == crop[0, 0]).all()
        assert len(np.unique(t.keys)) == 64 * 64
        with pytest.raises(ValueError):
            pack_composite_key([np.array([2**40]), np.array([2**40])])
