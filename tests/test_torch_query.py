"""The port's plan-based query layer, on the CPU, held against the
reference and the pure-numpy oracle ``tests/tpch_reference.py``.

Each package builds the same store from the same weights (a short run
of the reference trainer, carried over as numpy; ``store_pair``).  Every
plan runs through ``store.query()`` on both and must answer byte for
byte alike (keys, exists, values, aggregate groups and values), and
equal the oracle over the source table.  These are the single-store
cases of ``test_store_protocol.py``, ``test_streaming_executor.py``,
``test_aggregate_join.py``, ``test_range_queries.py`` and
``test_tpch_queries.py``.

The port's store serves through the fused tier (``use_kernels=True``),
which on the CPU runs K1's plain version: a ``where`` conjunction ships
its predicate code tables into it and filters on the match bits it
returns, so ``explain.kernel_filtered`` is true and the answers equal
``pushdown(False)``'s.
"""

import dataclasses

import numpy as np
import pytest
import torch
from tpch_reference import assert_aggregate_equal, ref_group_aggregate, ref_join_mask

import repro_torch
from repro_torch.api import (
    CONFORMANCE_METHODS,
    AggregateResult,
    ExplainStats,
    MappingStore,
    Predicate,
    QueryPlan,
    execute_plan,
    execute_plan_staged,
    execute_plans,
    next_morsel_rows,
    stream_plan,
)
from repro_torch.core import DeepMappingConfig, DeepMappingStore, Table
from repro_torch.data.tpch import lineitem_like, orders_like
from torch_port_util import store_pair

SHARED, PRIVATE = (32,), (8,)
SPECS = ("count", ("sum", "c"), ("min", "c"), ("max", "a"))
REF_SPECS = (("count", None), ("sum", "c"), ("min", "c"), ("max", "a"))


def make_table(n=900, stride=3, off=0, cls=Table):
    keys = np.arange(off, off + n * stride, stride, dtype=np.int64)
    return cls(
        keys=keys,
        columns={
            "a": ((keys // 16) % 5).astype(np.int32),
            "b": ((keys // 32) % 3).astype(np.int32),
            "c": ((keys // 8) % 7).astype(np.int32),
        },
    )


def query_keys(table, extra_missing=True):
    rng = np.random.default_rng(1)
    q = rng.choice(table.keys, size=220)
    if extra_missing:
        q = np.concatenate([q, np.array([1, table.max_key + 3, 10**8], dtype=np.int64)])
    return q


def cols(n, off):
    return {
        "a": (np.arange(n, dtype=np.int32) % 5) + off,
        "b": (np.arange(n, dtype=np.int32) % 3) + off,
        "c": (np.arange(n, dtype=np.int32) % 7) + off,
    }


def mutate(store, table, new_keys):
    """The reference suites' interleaved modification sequence."""
    store.insert(new_keys, cols(4, 10))
    store.update(table.keys[10:20], cols(10, 20))
    store.delete(table.keys[30:40])
    store.delete(new_keys[:1])
    store.update(new_keys[3:4], cols(1, 30))


NEW_KEYS = np.asarray([2, 5, 10**6, 10**6 + 4], dtype=np.int64)


def assert_result_bytes_equal(a, b):
    if hasattr(b, "aggregates"):  # either package's AggregateResult
        assert isinstance(a, AggregateResult)
        assert_aggregate_equal(a, b.groups, b.aggregates)
        for c in b.groups:
            assert np.asarray(a.groups[c]).dtype == np.asarray(b.groups[c]).dtype, c
        return
    np.testing.assert_array_equal(a.keys, b.keys)
    assert a.keys.tobytes() == b.keys.tobytes()
    np.testing.assert_array_equal(a.exists, b.exists)
    assert set(a.values) == set(b.values)
    for c in a.values:
        assert a.values[c].dtype == b.values[c].dtype, c
        assert a.values[c].tobytes() == b.values[c].tobytes(), c


def both(pair, build, right=None):
    """``build(store.query(), right store)`` on the port and on the
    reference; the answers must be byte-identical.  Returns the port's."""
    jstore, store = pair
    jright, pright = right if right is not None else (None, None)
    got = build(store.query(), pright).execute()
    want = build(jstore.query(), jright).execute()
    assert_result_bytes_equal(got, want)
    return got


@pytest.fixture(scope="module")
def table():
    return make_table()


@pytest.fixture(scope="module")
def pair(table):
    jstore, store, _ = store_pair(table, SHARED, PRIVATE)
    return jstore, store


@pytest.fixture(scope="module")
def mutated():
    table = make_table(n=400)
    jstore, store, _ = store_pair(table, SHARED, PRIVATE)
    for s in (jstore, store):
        mutate(s, table, NEW_KEYS)
    return table, (jstore, store)


# ------------------------------------------------------------ conformance
class TestConformanceSurface:
    def test_is_mapping_store(self, pair):
        store = pair[1]
        assert isinstance(store, MappingStore)
        for name in CONFORMANCE_METHODS:
            assert callable(getattr(store, name)), name

    def test_columns_and_size_breakdown(self, pair, table):
        jstore, store = pair
        assert set(store.columns) == set(table.columns)
        bd = store.size_breakdown()
        assert bd and all(v >= 0 for v in bd.values())
        assert store.size_bytes() == sum(bd.values())
        assert bd == jstore.size_breakdown()

    def test_store_memorizes_part_of_the_table(self, pair, table):
        """The weights are trained: the model answers a share of the
        rows itself, so the in-kernel match bits carry real rows, and
        T_aux holds the rest (both packages found the same T_aux)."""
        jstore, store = pair
        assert 0 < store.aux.num_rows < table.num_rows
        assert store.aux.num_rows == jstore.aux.num_rows


class TestPlanEquivalence:
    def test_point_query_matches_legacy_and_reference(self, pair, table):
        store = pair[1]
        q = query_keys(table)
        legacy_v, legacy_e = store.lookup(q)
        res = both(pair, lambda s, _: s.where_keys(q))
        np.testing.assert_array_equal(res.exists, legacy_e)
        for c in legacy_v:
            assert res.values[c].tobytes() == legacy_v[c].tobytes()
        assert res.explain.kind == "point" and res.explain.num_keys == q.shape[0]

    def test_point_query_matches_table(self, pair, table):
        res = both(pair, lambda s, _: s.where_keys(table.keys[::7]))
        assert res.exists.all()
        for c in table.columns:
            np.testing.assert_array_equal(res.values[c], table.columns[c][::7])

    def test_range_query_matches_legacy(self, pair, table):
        store = pair[1]
        lo, hi = int(table.keys[100]), int(table.keys[400])
        keys_l, vals_l = store.range_lookup(lo, hi)
        res = both(pair, lambda s, _: s.where_range(lo, hi))
        np.testing.assert_array_equal(keys_l, res.keys)
        for c in vals_l:
            assert vals_l[c].tobytes() == res.values[c].tobytes()
        assert res.exists.all()
        np.testing.assert_array_equal(res.keys, table.keys[(table.keys >= lo) & (table.keys < hi)])

    def test_scan_matches_legacy_and_table(self, pair, table):
        store = pair[1]
        keys_l, vals_l = store.scan()
        res = both(pair, lambda s, _: s.scan())
        np.testing.assert_array_equal(keys_l, res.keys)
        srt = table.sorted_by_key()
        np.testing.assert_array_equal(res.keys, srt.keys)
        for c in srt.columns:
            np.testing.assert_array_equal(res.values[c], srt.columns[c])
            assert vals_l[c].tobytes() == res.values[c].tobytes()

    def test_fanout_off_identical(self, pair, table):
        q = query_keys(table)
        on = both(pair, lambda s, _: s.where_keys(q))
        off = both(pair, lambda s, _: s.where_keys(q).fanout(False))
        assert_result_bytes_equal(on, off)
        assert not off.explain.async_fanout


class TestProjectionPushdown:
    def test_selected_columns_unchanged(self, pair, table):
        store = pair[1]
        q = query_keys(table)
        full_v, full_e = store.lookup(q)
        res = both(pair, lambda s, _: s.select("a", "c").where_keys(q))
        assert set(res.values) == {"a", "c"}
        for c in ("a", "c"):
            assert full_v[c].tobytes() == res.values[c].tobytes()
        np.testing.assert_array_equal(full_e, res.exists)
        assert res.explain.heads_skipped == ("b",)
        assert set(res.explain.heads_evaluated) == {"a", "c"}
        assert "b" in res.explain.columns_skipped and "b" not in res.explain.columns_decoded

    def test_select_validates_columns(self, pair):
        with pytest.raises(ValueError, match="unknown column"):
            pair[1].query().select("nope").scan().execute()

    def test_single_source_enforced(self, pair):
        store = pair[1]
        with pytest.raises(ValueError, match="key source"):
            store.query().where_keys([1]).scan()
        with pytest.raises(ValueError, match="no key source"):
            store.query().execute()


class TestZeroLengthBatches:
    def test_lookup_and_query_empty(self, pair):
        store = pair[1]
        values, exists = store.lookup(np.zeros(0, dtype=np.int64))
        assert exists.shape == (0,) and all(v.shape == (0,) for v in values.values())
        res = both(pair, lambda s, _: s.where_keys([]))
        assert res.exists.shape == (0,) and res.explain.num_keys == 0
        assert set(res.values) == set(store.columns) and res.explain.morsels == 1
        keys, _ = store.range_lookup(5, 5)
        assert keys.shape == (0,)

    def test_mutations_empty(self):
        table = make_table(n=200)
        _, store, _ = store_pair(table, (16,), (4,), epochs=1)
        empty = np.zeros(0, dtype=np.int64)
        no_cols = {c: np.zeros(0, dtype=np.int32) for c in table.columns}
        store.insert(empty, no_cols)
        store.delete(empty)
        store.update(empty, no_cols)
        assert store.num_rows == table.num_rows and store.mutation_version() == 0


class TestMutationValidation:
    def test_duplicate_insert_batch_rejected(self):
        _, store, _ = store_pair(make_table(n=200), (16,), (4,), epochs=1)
        before = store.num_rows
        dup = np.array([10**5, 10**5], dtype=np.int64)
        with pytest.raises(ValueError, match="duplicate"):
            store.insert(dup, {c: np.zeros(2, dtype=np.int32) for c in store.columns})
        assert store.num_rows == before and not store.lookup(dup[:1])[1][0]

    def test_duplicate_delete_batch_counts_once(self):
        table = make_table(n=200)
        _, store, _ = store_pair(table, (16,), (4,), epochs=1)
        store.delete(np.array([table.keys[3], table.keys[3]], dtype=np.int64))
        assert store.num_rows == table.num_rows - 1
        assert store.scan()[0].shape[0] == store.num_rows


class TestInterleavedModifications:
    def test_point_after_mods_matches_legacy(self, mutated):
        table, p = mutated
        q = np.concatenate([table.keys, NEW_KEYS])
        legacy_v, legacy_e = p[1].lookup(q)
        res = both(p, lambda s, _: s.where_keys(q))
        np.testing.assert_array_equal(legacy_e, res.exists)
        idx = {int(k): i for i, k in enumerate(q)}
        assert not res.exists[idx[int(table.keys[35])]]       # deleted
        assert not res.exists[idx[2]]                          # insert+delete
        assert res.exists[idx[10**6 + 4]]                      # insert+update
        assert int(res.values["a"][idx[10**6 + 4]]) == 30
        for c in legacy_v:
            assert legacy_v[c].tobytes() == res.values[c].tobytes()

    def test_range_after_mods_matches_legacy(self, mutated):
        table, p = mutated
        lo, hi = 0, int(table.max_key) + 10
        keys_l, _ = p[1].range_lookup(lo, hi)
        res = both(p, lambda s, _: s.where_range(lo, hi))
        np.testing.assert_array_equal(keys_l, res.keys)
        assert int(table.keys[35]) not in set(res.keys.tolist())

    def test_scan_after_mods_counts(self, mutated):
        table, p = mutated
        keys, _ = p[1].scan()
        assert keys.shape[0] == table.num_rows + 4 - 10 - 1 == p[1].num_rows
        assert np.all(np.diff(keys) > 0)

    def test_save_open_after_mods(self, mutated, tmp_path):
        table, p = mutated
        store = p[1]
        store.save(str(tmp_path / "m"))
        restored = repro_torch.open(str(tmp_path / "m"), device="cpu")
        assert type(restored) is type(store)
        q = np.concatenate([table.keys, NEW_KEYS])
        a = store.query().where_keys(q).execute()
        b = restored.query().where_keys(q).execute()
        assert_result_bytes_equal(a, b)
        assert restored.num_rows == store.num_rows


class TestEntrypoints:
    def test_build_and_open(self, pair, table, tmp_path):
        _, store = pair
        built = repro_torch.build(table, DeepMappingConfig(shared=SHARED, private=PRIVATE),
                                  spec=store.spec, params=store.params, device="cpu")
        assert isinstance(built, DeepMappingStore)
        q = query_keys(table)
        assert_result_bytes_equal(built.query().where_keys(q).execute(),
                                  store.query().where_keys(q).execute())
        built.save(str(tmp_path / "b"))
        assert isinstance(repro_torch.open(str(tmp_path / "b"), device="cpu"), DeepMappingStore)

    def test_timings_and_operators(self, pair, table):
        res = pair[1].query().where_keys(table.keys[:64]).execute()
        assert res.explain.total_s > 0 and res.explain.num_rows == 64
        names = [o.name for o in res.explain.operators]
        for expected in ("key_source", "infer", "aux_merge", "decode", "gather"):
            assert expected in names
        gather = next(o for o in res.explain.operators if o.name == "gather")
        assert gather.rows_out == 64
        assert dataclasses.asdict(res.explain)


# -------------------------------------------------------------- streaming
class TestStreamingVsStaged:
    @pytest.mark.parametrize("morsel", (64, 10_000))
    def test_point(self, pair, table, morsel):
        store = pair[1]
        plan = store.query().where_keys(query_keys(table)).morsel(morsel).plan()
        assert_result_bytes_equal(execute_plan(store, plan), execute_plan_staged(store, plan))
        both(pair, lambda s, _: s.where_keys(query_keys(table)).morsel(morsel))

    def test_range_and_scan(self, pair, table):
        store = pair[1]
        lo, hi = int(table.keys[50]), int(table.keys[500])
        for build in (lambda s, _: s.where_range(lo, hi).morsel(100),
                      lambda s, _: s.scan().morsel(128)):
            res = both(pair, build)
            plan = build(store.query(), None).plan()
            assert_result_bytes_equal(res, execute_plan_staged(store, plan))
            assert res.exists.all() and res.explain.morsels > 1

    def test_after_interleaved_mods(self, mutated):
        table, p = mutated
        store = p[1]
        q = np.concatenate([table.keys, NEW_KEYS])
        plan = store.query().where_keys(q).morsel(77).plan()
        res = execute_plan(store, plan)
        assert_result_bytes_equal(res, execute_plan_staged(store, plan))
        assert_result_bytes_equal(res, p[0].query().where_keys(q).morsel(77).execute())

    def test_stream_yields_aligned_morsels(self, pair, table):
        q = table.keys[:130]
        morsels = list(pair[1].query().where_keys(q).morsel(50).stream())
        assert [m.index for m in morsels] == [0, 1, 2]
        assert sum(m.keys.shape[0] for m in morsels) == 130
        assert all(m.match is None for m in morsels)
        np.testing.assert_array_equal(np.concatenate([m.keys for m in morsels]), q)


# ------------------------------------------------------ predicate pushdown
PREDS = (
    ("b", "==", 1),
    ("b", "!=", 0),
    ("a", ">=", 3),
    ("c", "<", 2),
    ("a", "in", (0, 4)),
)


class TestPredicatePushdown:
    @pytest.mark.parametrize("col,op,val", PREDS)
    def test_point_matches_posthoc_and_reference(self, pair, table, col, op, val):
        store = pair[1]
        q = query_keys(table)
        down = both(pair, lambda s, _: s.where(col, op, val).where_keys(q).morsel(64))
        ref = store.query().where(col, op, val).pushdown(False).where_keys(q).morsel(64).execute()
        assert_result_bytes_equal(down, ref)
        assert down.exists.all()
        assert down.explain.kernel_filtered and not ref.explain.kernel_filtered
        assert store.supports_kernel_filter((Predicate(col, op, val),))
        plain = store.query().where_keys(q).execute()
        m = plain.exists & Predicate(column=col, op=op, value=val).mask(plain.values[col])
        np.testing.assert_array_equal(down.keys, q[m])

    def test_scan_and_range_match_posthoc(self, pair, table):
        store = pair[1]
        for build in (lambda s, _: s.where("a", "==", 2).scan().morsel(128),
                      lambda s, _: s.where("c", ">", 3).where_range(0, int(table.max_key))):
            down = both(pair, build)
            ref = build(store.query(), None).pushdown(False).execute()
            assert_result_bytes_equal(down, ref)
            assert down.explain.kernel_filtered
        sel = table.columns["a"] == 2
        down = both(pair, lambda s, _: s.where("a", "==", 2).scan())
        np.testing.assert_array_equal(down.keys, table.keys[sel])

    def test_conjunction(self, pair, table):
        store = pair[1]
        q = query_keys(table)
        down = both(pair, lambda s, _: s.where("a", ">=", 1).where("b", "==", 2).where_keys(q))
        ref = (store.query().where("a", ">=", 1).where("b", "==", 2).pushdown(False)
               .where_keys(q).execute())
        assert_result_bytes_equal(down, ref)
        assert down.explain.kernel_filtered
        plain = store.query().where_keys(q).execute()
        m = (plain.exists & Predicate("a", ">=", 1).mask(plain.values["a"])
             & Predicate("b", "==", 2).mask(plain.values["b"]))
        assert down.keys.shape[0] == int(m.sum())

    def test_predicate_outside_projection(self, pair, table):
        store = pair[1]
        q = query_keys(table)
        down = both(pair, lambda s, _: s.select("a").where("b", "==", 1).where_keys(q))
        ref = store.query().select("a").where("b", "==", 1).pushdown(False).where_keys(q).execute()
        assert set(down.values) == {"a"} == set(ref.values)
        assert_result_bytes_equal(down, ref)
        assert "b" in down.explain.heads_evaluated
        assert "b" not in down.explain.columns_decoded
        assert "c" in down.explain.heads_skipped

    def test_after_interleaved_mods(self, mutated):
        """Predicates see T_aux: updated rows filtered by their NEW
        values, deleted rows gone, inserted rows included (the kernel's
        match bits re-checked on the rows T_aux overrides)."""
        table, p = mutated
        store = p[1]
        q = np.concatenate([table.keys, NEW_KEYS])
        down = both(p, lambda s, _: s.where("a", ">=", 10).where_keys(q).morsel(90))
        ref = store.query().where("a", ">=", 10).pushdown(False).where_keys(q).morsel(90).execute()
        assert_result_bytes_equal(down, ref)
        assert down.explain.kernel_filtered
        hit = set(down.keys.tolist())
        assert int(10**6) in hit
        assert hit <= set(table.keys[10:20].tolist()) | set(NEW_KEYS.tolist())

    def test_pushdown_decodes_fewer_rows(self, pair, table):
        store = pair[1]
        q = query_keys(table, extra_missing=False)
        down = both(pair, lambda s, _: s.where("b", "==", 1).where_keys(q))
        ref = store.query().where("b", "==", 1).pushdown(False).where_keys(q).execute()
        assert ref.explain.rows_decoded == q.shape[0]
        assert down.explain.rows_decoded == down.keys.shape[0] < ref.explain.rows_decoded
        # in-kernel, the host stage only patches the rows T_aux overrides
        f = next(o for o in down.explain.operators if o.name == "filter[kernel]")
        assert f.rows_out == down.keys.shape[0] <= f.rows_in

    def test_stream_applies_posthoc_predicates(self, pair, table):
        q = query_keys(table)
        base = pair[1].query().select("a").where("b", "==", 1).where_keys(q)
        down_morsels = list(base.morsel(64).stream())
        ref_morsels = list(base.pushdown(False).stream())
        assert all(m.match is not None for m in down_morsels + ref_morsels)
        assert all(set(m.values) == {"a"} for m in ref_morsels)
        executed = base.execute()
        for morsels in (down_morsels, ref_morsels):
            keys = np.concatenate([m.keys[m.match] for m in morsels])
            vals = np.concatenate([m.values["a"][m.match] for m in morsels])
            np.testing.assert_array_equal(keys, executed.keys)
            assert vals.tobytes() == executed.values["a"].tobytes()

    def test_host_filter_without_kernels(self, pair, table):
        """A store whose engine takes the plain tiers filters on the host
        (``kernel_filtered`` false) and answers the same bytes."""
        store = pair[1]
        plain = DeepMappingStore.build(
            table, dataclasses.replace(store.config, use_kernels=False), spec=store.spec,
            params=store.params, device="cpu")
        q = query_keys(table)
        got = plain.query().where("a", ">=", 2).where("c", "!=", 3).where_keys(q).execute()
        want = store.query().where("a", ">=", 2).where("c", "!=", 3).where_keys(q).execute()
        assert_result_bytes_equal(got, want)
        assert want.explain.kernel_filtered and not got.explain.kernel_filtered
        assert not plain.supports_kernel_filter((Predicate("a", ">=", 2),))

    def test_builder_validation(self, pair):
        store = pair[1]
        with pytest.raises(ValueError, match="unknown column"):
            store.query().where("nope", "==", 1)
        with pytest.raises(ValueError, match="unknown predicate op"):
            store.query().where("a", "~", 1)
        with pytest.raises(ValueError, match="single "):
            store.query().where("a", "in", "NEW")


class TestKernelPredicateSlots:
    """K1 takes at most ``MAX_PREDS`` predicate tables.  A plan ships one
    table per predicate column (its predicates ANDed), so any number of
    ``where`` clauses on few columns stays in the kernel; more columns
    than slots filter on the host.  Both kernel versions refuse more
    tables than slots alike."""

    NINE = (("a", ">=", 1), ("a", "<=", 4), ("a", "!=", 3), ("b", ">=", 0),
            ("b", "in", (1, 2)), ("c", "<", 6), ("c", "!=", 0), ("c", ">", 1),
            ("a", "in", (1, 2, 4)))

    def test_nine_predicates_on_three_columns(self, pair, table):
        store = pair[1]
        q = query_keys(table)

        def build(s, _):
            for col, op, val in self.NINE:
                s = s.where(col, op, val)
            return s.where_keys(q).morsel(64)

        down = both(pair, build)
        off = build(store.query(), None).pushdown(False).execute()
        assert_result_bytes_equal(down, off)
        assert down.explain.kernel_filtered and not off.explain.kernel_filtered
        plan = build(store.query(), None).plan()
        shipped = store._plan_lookup(None, plan.predicates)[4]
        assert [c for c, _ in shipped] == ["a", "b", "c"]
        pos = {int(k): i for i, k in enumerate(table.keys)}
        m = np.array([int(k) in pos for k in q])
        for col, op, val in self.NINE:
            rows = [pos.get(int(k), 0) for k in q]
            m &= Predicate(col, op, val).mask(table.columns[col][rows])
        np.testing.assert_array_equal(down.keys, q[m])

    def test_both_kernel_versions_refuse_more_tables_than_slots(self):
        from repro_torch.kernels import fused_mlp as fm
        from repro_torch.kernels import ref as kref

        tables = [torch.ones(128, dtype=torch.int32)] * (kref.MAX_PREDS + 1)
        tasks = [0] * len(tables)
        keys = torch.zeros(128, dtype=torch.int32)
        with pytest.raises(ValueError, match="predicate tables per launch"):
            kref.fused_lookup(keys, None, None, (), None, 0, tables, tasks)
        with pytest.raises(ValueError, match="predicate tables per launch"):
            fm.fused_lookup_call(keys, None, None, (), None, 128, 0, 0, tables, tasks)

    @pytest.mark.parametrize("n_cols,in_kernel", ((8, True), (9, False)))
    def test_predicate_columns_against_slots(self, n_cols, in_kernel):
        """One predicate per column on a nine-head store: eight columns
        fill K1's slots, nine filter on the host; both answer as the
        reference, ``pushdown(False)`` and the oracle do."""
        keys = np.arange(0, 1200, 3, dtype=np.int64)
        columns = {f"h{i}": ((keys // (4 + i)) % (3 + i % 3)).astype(np.int32)
                   for i in range(9)}
        t9 = Table(keys=keys, columns=columns)
        p9 = store_pair(t9, (16,), (4,), epochs=1)[:2]
        store = p9[1]
        preds = [(f"h{i}", "!=", 1) for i in range(n_cols)]

        def build(s, _):
            for col, op, val in preds:
                s = s.where(col, op, val)
            return s.scan()

        down = both(p9, build)
        off = build(store.query(), None).pushdown(False).execute()
        assert_result_bytes_equal(down, off)
        assert down.explain.kernel_filtered is in_kernel
        assert store.supports_kernel_filter(
            tuple(Predicate(*p) for p in preds)) is in_kernel
        m = np.ones(keys.shape[0], dtype=bool)
        for col, op, val in preds:
            m &= Predicate(col, op, val).mask(columns[col])
        np.testing.assert_array_equal(down.keys, keys[m])


class TestMultiPlanPipelining:
    def test_matches_serial_execution(self, pair, table):
        q = query_keys(table)
        builds = [
            lambda s: s.where_keys(q).morsel(64),
            lambda s: s.where("b", "==", 1).scan().morsel(128),
            lambda s: s.select("c").where_range(0, 999),
            lambda s: s.group_by("a").agg(*SPECS).scan(),
        ]
        for s in pair:
            pipelined = execute_plans([(s, b(s.query()).plan()) for b in builds])
            serial = [execute_plan(s, b(s.query()).plan()) for b in builds]
            for a, b in zip(pipelined, serial):
                assert_result_bytes_equal(a, b)
            if s is pair[1]:
                port = pipelined
        for a, b in zip(port, pipelined):  # port against reference
            assert_result_bytes_equal(a, b)


# ------------------------------------------------ plan cache and adaptive
class TestPlanCacheAndAdaptive:
    def test_warm_hits_and_matches_cold(self, pair):
        store = pair[1]
        q = store.query().where("b", "==", 1).scan().morsel(128)
        first = q.execute()
        warm = q.execute()
        cold = store.query().where("b", "==", 1).cached(False).scan().morsel(128).execute()
        assert first.explain.plan_cache in ("hit", "miss")
        assert warm.explain.plan_cache == "hit" and cold.explain.plan_cache == "bypass"
        assert_result_bytes_equal(warm, first)
        assert_result_bytes_equal(warm, cold)
        assert_result_bytes_equal(warm, execute_plan_staged(store, q.plan()))

    def test_point_plans_share_projection_artifacts(self, pair, table):
        store = pair[1]
        store.plan_cache().clear()
        r1 = store.query().select("a").where("b", "!=", 0).where_keys(table.keys[:50]).execute()
        r2 = store.query().select("a").where("b", "!=", 0).where_keys(table.keys[50:90]).execute()
        assert r1.explain.plan_cache == "miss" and r2.explain.plan_cache == "hit"
        ref = (store.query().select("a").where("b", "!=", 0).cached(False)
               .where_keys(table.keys[50:90]).execute())
        assert_result_bytes_equal(r2, ref)

    def test_invalidation_after_interleaved_mods(self):
        """Warm every cached artifact, then insert (growing the ``a``
        decode map past the model's card), update and delete: the warm
        re-run misses and stays byte-identical to the uncached path and
        to the reference."""
        table = make_table(n=400)
        p = store_pair(table, (16,), (4,), epochs=2)[:2]
        point_keys = np.concatenate([table.keys, [10**6, 10**6 + 2]])
        builds = (lambda s, _: s.where("a", ">=", 10).scan().morsel(90),
                  lambda s, _: s.where("a", ">=", 10).where_keys(point_keys))
        assert both(p, builds[0]).keys.shape[0] == 0
        both(p, builds[1])
        c = {k: np.asarray(v, np.int32) for k, v in
             (("a", [11, 12]), ("b", [11, 12]), ("c", [11, 12]))}
        u = {k: np.asarray([10, 10, 0, 0, 10], np.int32) for k in ("a", "b", "c")}
        for s in p:
            s.insert(np.array([10**6, 10**6 + 2], dtype=np.int64), c)
            s.update(table.keys[:5], u)
            s.delete(np.array([10**6 + 2], dtype=np.int64))
        store = p[1]
        for build in builds:
            warm = both(p, build)
            assert warm.explain.plan_cache == "miss" and warm.explain.kernel_filtered
            cold = build(store.query(), None).cached(False).execute()
            assert cold.explain.plan_cache == "bypass"
            assert_result_bytes_equal(warm, cold)
            assert_result_bytes_equal(warm, execute_plan_staged(store, build(store.query(),
                                                                             None).plan()))
            hit = set(warm.keys.tolist())
            assert 10**6 in hit and 10**6 + 2 not in hit
            assert set(table.keys[[0, 1, 4]].tolist()) <= hit
        assert builds[0](store.query(), None).execute().explain.plan_cache == "hit"

    def test_cache_bounded_and_clearable(self, pair):
        store = pair[1]
        cache = store.plan_cache()
        cache.clear()
        store.query().scan().morsel(200).execute()
        assert len(cache) == 1
        cache.clear()
        assert len(cache) == 0

    def test_adaptive_matches_fixed_and_staged(self, pair):
        store = pair[1]
        adaptive = both(pair, lambda s, _: s.where("c", "<", 5).scan())
        fixed = store.query().where("c", "<", 5).scan().morsel(64).execute()
        staged = execute_plan_staged(store, store.query().where("c", "<", 5).scan().plan())
        assert_result_bytes_equal(adaptive, fixed)
        assert_result_bytes_equal(adaptive, staged)
        assert sum(adaptive.explain.morsel_sizes) == adaptive.explain.num_keys
        assert fixed.explain.morsel_sizes[0] <= 64

    def test_next_morsel_rows_rule(self):
        from repro_torch.api.executor import ADAPT_HIGH_S, ADAPT_LOW_S, ADAPT_MAX, ADAPT_MIN

        assert next_morsel_rows(1 << 14, 0.0) == 1 << 15
        assert next_morsel_rows(1 << 14, ADAPT_HIGH_S * 2) == 1 << 13
        assert next_morsel_rows(1 << 14, ADAPT_LOW_S) == 1 << 14
        assert next_morsel_rows(ADAPT_MAX, 0.0) == ADAPT_MAX
        assert next_morsel_rows(ADAPT_MIN, 1.0) == ADAPT_MIN

    def test_mutation_version_moves_on_every_mutator(self, mutated):
        table, p = mutated
        store = p[1]
        v0 = store.mutation_version()
        one = {"a": np.array([1], np.int32), "b": np.array([1], np.int32),
               "c": np.array([1], np.int32)}
        p[0].update(table.keys[:1], one)
        store.update(table.keys[:1], one)
        v1 = store.mutation_version()
        assert v1 != v0
        p[0].delete(table.keys[:1])
        store.delete(table.keys[:1])
        assert store.mutation_version() not in (v0, v1)
        assert store.mutation_version() == p[0].mutation_version()


class TestRetrain:
    def test_should_retrain_materialize_retrain(self):
        """``should_retrain`` trips on the modified-bytes threshold;
        ``materialize`` is the logical table (scan order); ``retrain``
        trains a fresh store on it with the port's trainer, on the same
        device, answering every live key as before."""
        from repro_torch.core.trainer import TrainConfig

        table = make_table(n=300)
        cfg = DeepMappingConfig(shared=(16,), private=(4,), retrain_after_modified_bytes=1,
                                train=TrainConfig(epochs=2, batch_size=512))
        _, donor, _ = store_pair(table, (16,), (4,), epochs=1)
        store = DeepMappingStore.build(table, cfg, spec=donor.spec, params=donor.params,
                                       device="cpu")
        assert not store.should_retrain()
        mutate(store, table, NEW_KEYS)
        assert store.should_retrain()
        logical = store.materialize()
        keys, values = store.scan()
        np.testing.assert_array_equal(logical.keys, keys)
        fresh = store.retrain()
        assert fresh is not store and fresh.device == store.device
        assert fresh.num_rows == store.num_rows and not fresh.should_retrain()
        v, e = fresh.lookup(keys)
        assert e.all()
        for c in values:
            assert v[c].tobytes() == values[c].tobytes()


# ------------------------------------------------------------- aggregates
def rows_for_keys(table, keys):
    pos = {int(k): i for i, k in enumerate(table.keys)}
    rows = [pos[int(k)] for k in keys if int(k) in pos]
    return {c: np.asarray(v)[rows] for c, v in table.columns.items()}


class TestAggregateDifferential:
    def test_scan_groupby_all_funcs(self, pair, table):
        res = both(pair, lambda s, _: s.group_by("a", "b").agg(*SPECS).scan())
        assert isinstance(res, AggregateResult)
        groups, aggs = ref_group_aggregate(table.columns, ("a", "b"), REF_SPECS)
        assert_aggregate_equal(res, groups, aggs)
        ref = pair[1].query().group_by("a", "b").agg(*SPECS).pushdown(False).scan().execute()
        assert_aggregate_equal(ref, groups, aggs)
        assert res.explain.groups_emitted == res.num_groups

    @pytest.mark.parametrize("pushdown", (True, False))
    def test_predicate_pushdown_on_off(self, pair, table, pushdown):
        groups, aggs = ref_group_aggregate(table.columns, ("a",), REF_SPECS,
                                           table.columns["c"] < 4)
        res = both(pair, lambda s, _: s.where("c", "<", 4).group_by("a").agg(*SPECS)
                   .pushdown(pushdown).scan())
        assert_aggregate_equal(res, groups, aggs)
        assert res.explain.kernel_filtered is pushdown

    def test_point_keys_with_missing_and_duplicates(self, pair, table):
        rng = np.random.default_rng(7)
        q = np.concatenate([rng.choice(table.keys, 300), [1, table.max_key + 5, 10**8]])
        groups, aggs = ref_group_aggregate(rows_for_keys(table, q), ("b",), REF_SPECS)
        res = both(pair, lambda s, _: s.group_by("b").agg(*SPECS).where_keys(q))
        assert_aggregate_equal(res, groups, aggs)

    def test_global_aggregate_single_group(self, pair, table):
        res = both(pair, lambda s, _: s.agg("count", ("max", "c")).scan())
        assert res.num_groups == 1 and res.groups == {}
        assert int(res.aggregates["count"][0]) == len(table.keys)
        assert int(res.aggregates["max(c)"][0]) == int(table.columns["c"].max())

    def test_range_aggregate(self, pair, table):
        lo, hi = int(table.keys[100]), int(table.keys[700])
        groups, aggs = ref_group_aggregate(table.columns, ("a",), REF_SPECS,
                                           (table.keys >= lo) & (table.keys < hi))
        res = both(pair, lambda s, _: s.group_by("a").agg(*SPECS).where_range(lo, hi))
        assert_aggregate_equal(res, groups, aggs)

    def test_adaptive_fixed_and_staged(self, pair):
        store = pair[1]
        adaptive = store.query().group_by("a", "b").agg(*SPECS).scan().execute()
        fixed = both(pair, lambda s, _: s.group_by("a", "b").agg(*SPECS).morsel(70).scan())
        assert fixed.explain.morsels > 1
        assert_aggregate_equal(adaptive, fixed.groups, fixed.aggregates)
        staged = execute_plan_staged(store, store.query().group_by("a", "b").agg(*SPECS)
                                     .scan().plan())
        assert_aggregate_equal(adaptive, staged.groups, staged.aggregates)

    def test_count_only_decodes_zero_rows(self, pair, table):
        res = both(pair, lambda s, _: s.group_by("a", "b").agg("count").scan())
        groups, aggs = ref_group_aggregate(table.columns, ("a", "b"), (("count", None),))
        assert_aggregate_equal(res, groups, aggs)
        assert res.explain.rows_decoded == 0
        assert any(op.name == "aggregate" for op in res.explain.operators)

    def test_aggregate_after_mutations(self):
        table = make_table(n=400)
        p = store_pair(table, (16,), (4,), epochs=2)[:2]
        for s in p:
            mutate(s, table, NEW_KEYS)
        model = {int(k): {c: int(table.columns[c][i]) for c in table.columns}
                 for i, k in enumerate(table.keys)}
        for keys, vals in ((NEW_KEYS, cols(4, 10)), (table.keys[10:20], cols(10, 20)),
                           (NEW_KEYS[3:4], cols(1, 30))):
            for i, k in enumerate(keys):
                model[int(k)] = {c: int(vals[c][i]) for c in vals}
        for k in list(table.keys[30:40]) + [NEW_KEYS[0]]:
            del model[int(k)]
        live = sorted(model)
        logical = {c: np.asarray([model[k][c] for k in live], np.int32) for c in "abc"}
        groups, aggs = ref_group_aggregate(logical, ("a",), REF_SPECS)
        res = both(p, lambda s, _: s.group_by("a").agg(*SPECS).scan())
        assert_aggregate_equal(res, groups, aggs)
        assert res.explain.rows_decoded == 0
        ref = p[1].query().group_by("a").agg(*SPECS).pushdown(False).scan().execute()
        assert_aggregate_equal(ref, groups, aggs)

    def test_validation(self, pair):
        store = pair[1]
        with pytest.raises(ValueError):
            store.query().group_by("a").scan().plan()
        with pytest.raises(ValueError):
            store.query().select("a").agg("count").scan().plan()
        with pytest.raises(ValueError):
            store.query().agg("count").join(store).scan().plan()


# ------------------------------------------------------------------ joins
class TestJoinDifferential:
    @pytest.fixture(scope="class")
    def right(self):
        """Even keys only; column ``c`` collides with the left's."""
        def make(cls):
            keys = np.arange(0, 700, 2, dtype=np.int64)
            return cls(keys=keys, columns={"clerk": (keys % 11).astype(np.int32),
                                           "c": (keys % 13).astype(np.int32)})
        t = make(Table)
        return t, store_pair(t, (16,), (4,), epochs=2)[:2]

    def test_join_matches_mask(self, pair, table, right):
        rtable, rpair = right
        key_fn = lambda k: k % 700  # noqa: E731
        res = both(pair, lambda s, r: s.join(r, key=key_fn, columns=("clerk",)).scan(), rpair)
        mask = ref_join_mask(table.keys, key_fn, rtable.keys)
        np.testing.assert_array_equal(res.keys, table.keys[mask])
        clerk = dict(zip(rtable.keys.tolist(), rtable.columns["clerk"].tolist()))
        np.testing.assert_array_equal(np.asarray(res.values["clerk"]),
                                      [clerk[int(k) % 700] for k in res.keys])
        assert res.explain.join_probes == len(table.keys)

    def test_self_join_probe(self, pair, table):
        q = np.concatenate([table.keys[::5], [1, 4, table.max_key + 3]])
        res = both(pair, lambda s, r: s.select("a").where_keys(q).join(r, columns=("b",)), pair)
        present = np.isin(q, table.keys)
        np.testing.assert_array_equal(res.keys, q[present])
        lut = {c: dict(zip(table.keys.tolist(), table.columns[c].tolist())) for c in "ab"}
        for c in "ab":
            np.testing.assert_array_equal(res.values[c], [lut[c][int(k)] for k in res.keys])

    def test_collision_prefix_and_left_columns(self, pair, table, right):
        rtable, rpair = right
        key_fn = lambda k: k % 700  # noqa: E731
        res = both(pair, lambda s, r: s.join(r, key=key_fn).scan(), rpair)
        assert "r.c" in res.values and "clerk" in res.values
        mask = ref_join_mask(table.keys, key_fn, rtable.keys)
        np.testing.assert_array_equal(np.asarray(res.values["c"]), table.columns["c"][mask])
        cmap = dict(zip(rtable.keys.tolist(), rtable.columns["c"].tolist()))
        np.testing.assert_array_equal(np.asarray(res.values["r.c"]),
                                      [cmap[int(k) % 700] for k in res.keys])

    def test_with_predicate_pushdown_on_off(self, pair, table, right):
        rtable, rpair = right
        key_fn = lambda k: k % 700  # noqa: E731
        down = both(pair, lambda s, r: s.where("c", ">", 3).join(r, key=key_fn).scan(), rpair)
        ref = pair[1].query().where("c", ">", 3).join(rpair[1], key=key_fn).pushdown(False) \
            .scan().execute()
        assert_result_bytes_equal(down, ref)
        mask = ref_join_mask(table.keys, key_fn, rtable.keys) & (table.columns["c"] > 3)
        np.testing.assert_array_equal(down.keys, table.keys[mask])
        assert down.explain.kernel_filtered

    def test_staged_equals_streaming_and_probes(self, pair, table, right):
        _, rpair = right
        store, rstore = pair[1], rpair[1]
        plan = store.query().join(rstore, key=lambda k: k % 700).scan().plan()
        assert_result_bytes_equal(execute_plan(store, plan), execute_plan_staged(store, plan))
        res = both(pair, lambda s, r: s.where("c", "==", 2).join(r, key=lambda k: k % 700)
                   .scan(), rpair)
        assert res.explain.join_probes == int((table.columns["c"] == 2).sum())
        assert any("join[" in s for s in res.explain.plan)


# ------------------------------------------------------------ range (§IV-E)
class TestRangeLookup:
    @pytest.fixture(scope="class")
    def ranged(self):
        from conftest import make_periodic_table

        table = make_periodic_table(n=1200, stride=3)
        return table, store_pair(table, (32,), (8,), epochs=4)[:2]

    def test_exact_range_contents(self, ranged):
        table, p = ranged
        res = both(p, lambda s, _: s.where_range(30, 91))
        keys, values = p[1].range_lookup(30, 91)
        np.testing.assert_array_equal(keys, table.keys[(table.keys >= 30) & (table.keys < 91)])
        np.testing.assert_array_equal(res.keys, keys)
        lut = dict(zip(table.keys.tolist(), table.columns["col0"].tolist()))
        np.testing.assert_array_equal(values["col0"], [lut[int(k)] for k in keys])

    def test_empty_and_clamped(self, ranged):
        table, p = ranged
        assert p[1].range_lookup(31, 32)[0].size == 0
        assert p[1].range_lookup(0, 10**9)[0].size == table.num_rows

    def test_projection_then_deletes(self, ranged):
        _, p = ranged
        _, values = p[1].range_lookup(0, 50, columns=("col1",))
        assert set(values) == {"col1"}
        for s in p:
            s.delete(np.array([60], dtype=np.int64))
        res = both(p, lambda s, _: s.where_range(55, 70))
        assert 60 not in res.keys.tolist()


# -------------------------------------------------------------------- TPC-H
class TestTPCH:
    GROUP = ("l_returnflag", "l_linestatus")
    SPECS = ("count", ("sum", "l_quantity"), ("min", "l_quantity"), ("max", "l_quantity"))
    REF = (("count", None), ("sum", "l_quantity"), ("min", "l_quantity"),
           ("max", "l_quantity"))

    @pytest.fixture(scope="class")
    def lineitem(self):
        table = lineitem_like(n=8_400, seed=3)
        return table, store_pair(table, (16,), (4,), epochs=2)[:2]

    @pytest.fixture(scope="class")
    def orders(self):
        table = orders_like(n=2_000, seed=4)
        return table, store_pair(table, (16,), (4,), epochs=2)[:2]

    def test_q1_groupby_matches_oracle(self, lineitem):
        table, p = lineitem
        groups, aggs = ref_group_aggregate(table.columns, self.GROUP, self.REF)
        res = both(p, lambda s, _: s.group_by(*self.GROUP).agg(*self.SPECS).scan())
        assert_aggregate_equal(res, groups, aggs)
        assert res.num_groups == 6

    @pytest.mark.parametrize("pushdown", (True, False))
    def test_q1_with_quantity_predicate(self, lineitem, pushdown):
        table, p = lineitem
        groups, aggs = ref_group_aggregate(table.columns, self.GROUP, self.REF,
                                           table.columns["l_quantity"] <= 25)
        res = both(p, lambda s, _: s.where("l_quantity", "<=", 25).group_by(*self.GROUP)
                   .agg(*self.SPECS).pushdown(pushdown).scan())
        assert_aggregate_equal(res, groups, aggs)

    @pytest.mark.parametrize("group", (("l_returnflag", "l_linestatus"), ("l_shipmode",)))
    def test_count_only_decodes_zero_rows(self, lineitem, group):
        table, p = lineitem
        res = both(p, lambda s, _: s.group_by(*group).agg("count").scan())
        groups, aggs = ref_group_aggregate(table.columns, group, (("count", None),))
        assert_aggregate_equal(res, groups, aggs)
        assert res.explain.rows_decoded == 0

    def test_orders_where_two_heads(self, orders):
        """The smoke's ``where`` plan in small: a conjunction on two model
        heads over a scan, filtered by K1's match bits."""
        table, p = orders
        prio = table.columns["o_orderpriority"][0]
        res = both(p, lambda s, _: s.select("o_clerk").where("o_orderpriority", "==", prio)
                   .where("o_orderstatus", "in", ("F", "P")).scan())
        m = (table.columns["o_orderpriority"] == prio) & np.isin(table.columns["o_orderstatus"],
                                                                  ["F", "P"])
        o = np.argsort(table.keys[m])
        np.testing.assert_array_equal(res.keys, table.keys[m][o])
        np.testing.assert_array_equal(res.values["o_clerk"], table.columns["o_clerk"][m][o])
        assert res.explain.kernel_filtered

    def test_lineitem_orders_join(self, lineitem, orders):
        ltable, lp = lineitem
        otable, op = orders
        res = both(lp, lambda s, r: s.where("l_quantity", ">", 40)
                   .join(r, key=lambda k: k // 8, columns=("o_clerk",)).scan(), op)
        mask = ref_join_mask(ltable.keys, lambda k: k // 8, otable.keys)
        mask &= ltable.columns["l_quantity"] > 40
        assert mask.any() and not mask.all()
        np.testing.assert_array_equal(res.keys, ltable.keys[mask])
        clerk = dict(zip(otable.keys.tolist(), otable.columns["o_clerk"].tolist()))
        np.testing.assert_array_equal(np.asarray(res.values["o_clerk"]),
                                      [clerk[int(k) // 8] for k in res.keys])


# ---------------------------------------------------------- invariants
class _BrokenIndexStore(MappingStore):
    """Range keys that the lookup path denies — must raise, not assert."""

    columns = ("x",)

    def lookup(self, keys, columns=None):
        keys = np.asarray(keys, dtype=np.int64)
        return {"x": np.zeros(keys.shape[0], np.int32)}, np.zeros(keys.shape[0], bool)

    def insert(self, keys, columns):  # pragma: no cover - protocol stubs
        raise NotImplementedError

    delete = update = save = insert

    def size_breakdown(self):  # pragma: no cover
        return {}

    @classmethod
    def load(cls, path, pool=None):  # pragma: no cover
        raise NotImplementedError

    def _range_keys(self, lo, hi):
        return np.arange(10, dtype=np.int64)


class TestInvariantsAndStats:
    def test_range_invariant_raises_runtime_error(self):
        store = _BrokenIndexStore()
        plan = QueryPlan(kind="range", lo=0, hi=10)
        for run in (lambda: execute_plan(store, plan), lambda: execute_plan_staged(store, plan),
                    lambda: list(stream_plan(store, plan)), lambda: store.range_lookup(0, 10)):
            with pytest.raises(RuntimeError, match="existence index"):
                run()

    def test_merge_timings_unions_evidence(self):
        a = ExplainStats(heads_evaluated=("a",), heads_skipped=("b", "c"),
                         columns_decoded=("a",), columns_skipped=("b", "c"),
                         shards_visited=2, rows_decoded=5, infer_s=1.0)
        b = ExplainStats(heads_evaluated=("b",), heads_skipped=("a", "c"),
                         columns_decoded=("b",), columns_skipped=("c",), predicates=("a==1",),
                         shards_visited=3, rows_decoded=7, infer_s=0.5, filter_s=0.25,
                         kernel_filtered=True)
        a.merge_timings(b)
        assert a.heads_evaluated == ("a", "b") and a.heads_skipped == ("b", "c", "a")
        assert a.columns_decoded == ("a", "b") and a.predicates == ("a==1",)
        assert a.shards_visited == 3 and a.rows_decoded == 12 and a.kernel_filtered
        assert a.infer_s == pytest.approx(1.5) and a.filter_s == pytest.approx(0.25)
