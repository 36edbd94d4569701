"""The port's ``FederatedStore`` on the CPU, held against the reference's
``repro.api.FederatedStore`` and the numpy oracle
``tests/tpch_reference.py``.

The federation cases of ``tests/test_streaming_executor.py``
(``TestFederation``, the federated pruning case, and the sharded
fan-out evidence) and ``TestFederatedAggregateJoin`` (with the
federated member-loss case of ``TestDegradedAggregateJoin``) of
``tests/test_aggregate_join.py``.  Each federation is composed in both
packages over the same members: DeepMapping stores built from the same
weights (``store_pair``), ``HashStore``/``ArrayStore`` baselines built
by both packages from the same table, and clusters built and saved by
the reference and opened by the port (``cluster_pair``).  Every answer
must be byte for byte the reference federation's, and equal the oracle.
"""

import numpy as np
import pytest
from tpch_reference import assert_aggregate_equal, ref_group_aggregate, ref_join_mask

from repro import fault as jfault
from repro.api import FederatedStore as JFederated
from repro.baselines import ArrayStore as JArrayStore
from repro.baselines import HashStore as JHashStore
from repro.core import Table as JTable
from repro_torch.api import FederatedStore
from repro_torch.baselines import ArrayStore, HashStore
from repro_torch.core import Table
from repro_torch.fault import FaultPlan, FaultSpec, RetryPolicy
from torch_port_util import assert_values_equal, cluster_pair, store_pair

SPECS = ("count", ("sum", "c"), ("min", "c"), ("max", "a"))
REF_SPECS = (("count", None), ("sum", "c"), ("min", "c"), ("max", "a"))
TIGHT = RetryPolicy(max_attempts=2, backoff_s=0.0, max_backoff_s=0.0)
J_TIGHT = jfault.RetryPolicy(max_attempts=2, backoff_s=0.0, max_backoff_s=0.0)


def make_table(n=900, stride=3, off=0, cls=JTable):
    keys = np.arange(off, off + n * stride, stride, dtype=np.int64)
    return cls(keys=keys, columns={
        "a": ((keys // 16) % 5).astype(np.int32),
        "b": ((keys // 32) % 3).astype(np.int32),
        "c": ((keys // 8) % 7).astype(np.int32),
    })


def port_table(table):
    return Table(keys=table.keys.copy(),
                 columns={c: v.copy() for c, v in table.columns.items()})


def member(kind, table, tmp_path_factory=None):
    """``(reference store, port store)`` of one kind over a reference
    ``table``."""
    if kind == "deepmapping":
        return store_pair(port_table(table), (16,), (4,), epochs=2)[:2]
    if kind == "hash":
        return (JHashStore.build(table, codec="none", partition_bytes=2048),
                HashStore.build(port_table(table), codec="none", partition_bytes=2048))
    if kind == "array":
        return (JArrayStore.build(table, codec="zstd", partition_bytes=4096),
                ArrayStore.build(port_table(table), codec="zstd", partition_bytes=4096))
    if kind == "sharded":
        path = tmp_path_factory.mktemp("member") / "cluster"
        return cluster_pair(table, path, shared=(16,), private=(4,), epochs=2)
    raise ValueError(kind)


def federate(pairs, **kw):
    """The same federation in both packages -> ``(port, reference)``."""
    jkw = dict(kw)
    if "retry" in kw:
        jkw["retry"] = J_TIGHT
    return (FederatedStore([p[1] for p in pairs], **kw),
            JFederated([p[0] for p in pairs], **jkw))


def assert_rows_equal(a, b):
    assert a.keys.tobytes() == b.keys.tobytes()
    np.testing.assert_array_equal(a.exists, b.exists)
    assert_values_equal(a.values, b.values)


def oracle(table, group_by, sel=None, specs=REF_SPECS):
    return ref_group_aggregate(table.columns, group_by, specs, sel)


@pytest.fixture(scope="module")
def partitioned():
    """A DeepMapping member below key 5,000 and a ``HashStore`` above,
    and an ``ArrayStore`` of the union as the single-store reference."""
    t_lo, t_hi = make_table(n=300), make_table(n=300, off=10_000)
    union = JTable(keys=np.concatenate([t_lo.keys, t_hi.keys]),
                   columns={c: np.concatenate([t_lo.columns[c], t_hi.columns[c]])
                            for c in t_lo.columns})
    fed, jfed = federate([member("deepmapping", t_lo), member("hash", t_hi)],
                         mode="partition", boundaries=[5000])
    return fed, jfed, member("array", union)[1], union


class TestFederation:
    def test_partition_lookup_matches_reference(self, partitioned):
        fed, jfed, ref, union = partitioned
        rng = np.random.default_rng(3)
        q = np.concatenate([rng.choice(union.keys, 250), [4, 10**9]])
        fv, fe = fed.lookup(q)
        jv, je = jfed.lookup(q)
        np.testing.assert_array_equal(fe, je)
        assert_values_equal(fv, jv)
        rv, re_ = ref.lookup(q)
        np.testing.assert_array_equal(fe, re_)
        for c in rv:
            np.testing.assert_array_equal(np.asarray(fv[c])[fe], np.asarray(rv[c])[re_])

    def test_partition_scan_ascending_union(self, partitioned):
        fed, jfed, _, union = partitioned
        res = fed.query().scan().execute()
        np.testing.assert_array_equal(res.keys, np.sort(union.keys))
        assert res.exists.all()
        assert_rows_equal(res, jfed.query().scan().execute())

    def test_partition_predicate_matches_reference(self, partitioned):
        fed, jfed, ref, union = partitioned
        q = union.keys[::4]
        down = fed.query().where("b", "==", 1).where_keys(q).morsel(70).execute()
        assert_rows_equal(down, jfed.query().where("b", "==", 1).where_keys(q).morsel(70)
                          .execute())
        want = ref.query().where("b", "==", 1).where_keys(q).execute()
        np.testing.assert_array_equal(down.keys, want.keys)
        for c in want.values:
            np.testing.assert_array_equal(np.asarray(down.values[c]),
                                          np.asarray(want.values[c]))

    def test_partition_mutations_route(self, partitioned):
        fed, jfed, _, _ = partitioned
        keys = np.array([123_456, 7], dtype=np.int64)  # one per member
        cols = {c: np.array([90, 91], np.int32) for c in ("a", "b", "c")}
        for f in (fed, jfed):
            f.insert(keys, cols)
        v, e = fed.lookup(keys)
        assert e.all()
        np.testing.assert_array_equal(np.asarray(v["a"]), [90, 91])
        assert_values_equal(v, jfed.lookup(keys)[0])
        assert fed.members[1].lookup(keys[:1])[1][0]  # routed to the high member
        assert fed.members[0].lookup(keys[1:])[1][0]  # routed to the low member
        assert fed.mutation_version() == jfed.mutation_version()
        for f in (fed, jfed):
            f.delete(keys)
        assert not fed.lookup(keys)[1].any()

    def test_rejected_mutations_leave_federation_untouched(self, partitioned):
        fed, _, _, union = partitioned
        fresh_lo = np.array([4], dtype=np.int64)   # member 0, new key
        existing_hi = union.keys[-1:]              # member 1, present
        cols = {c: np.zeros(2, dtype=np.int32) for c in fed.columns}
        before = fed.num_rows
        with pytest.raises(ValueError, match="existing key"):
            fed.insert(np.concatenate([fresh_lo, existing_hi]), cols)
        assert fed.num_rows == before
        assert not fed.lookup(fresh_lo)[1][0]
        victim = union.keys[10:11]  # member 0
        with pytest.raises(ValueError, match="non-existing"):
            fed.update(np.concatenate([victim, np.array([10**9])]), cols)
        v, e = fed.lookup(victim)
        assert e[0] and int(np.asarray(v["a"])[0]) == int(union.columns["a"][10])

    def test_partition_zero_length_mutations_are_noops(self, partitioned):
        fed, _, _, _ = partitioned
        empty = np.zeros(0, dtype=np.int64)
        no_cols = {c: np.zeros(0, dtype=np.int32) for c in fed.columns}
        before = fed.num_rows
        fed.insert(empty, no_cols)
        fed.delete(empty)
        fed.update(empty, no_cols)
        assert fed.num_rows == before
        values, exists = fed.lookup(empty)
        assert exists.shape == (0,) and set(values) == set(fed.columns)

    def test_federated_shard_fanout_namespaced(self, tmp_path_factory):
        """Two sharded members both have a 'shard 0'; the federation
        unions namespaced ids, it does not dedupe them."""
        fed, jfed = federate([member("sharded", make_table(n=300), tmp_path_factory),
                              member("sharded", make_table(n=300, off=10_000),
                                     tmp_path_factory)],
                             mode="partition", boundaries=[5000])
        total = sum(m.num_shards for m in fed.members)
        res = fed.query().scan().execute()
        assert res.explain.shards_visited == total
        assert len(set(res.explain.shard_ids)) == total
        want = jfed.query().scan().execute()
        assert_rows_equal(res, want)
        assert sorted(res.explain.shard_ids) == sorted(want.explain.shard_ids)

    @pytest.mark.parametrize("policy", ("primary", "round_robin"))
    def test_replicate_policies(self, policy):
        table = make_table(n=250)
        fed, jfed = federate([member("deepmapping", table), member("hash", table)],
                             mode="replicate", policy=policy)
        q = table.keys[::2]
        res = fed.query().where_keys(q).morsel(40).execute()
        assert res.explain.morsels > 1
        assert res.exists.all()
        for c in table.columns:
            np.testing.assert_array_equal(np.asarray(res.values[c]), table.columns[c][::2])
        assert_rows_equal(res, jfed.query().where_keys(q).morsel(40).execute())
        for f in (fed, jfed):  # replicated mutations hit every member
            f.delete(table.keys[:1])
            for m in f.members:
                assert not m.lookup(table.keys[:1])[1][0]

    def test_constructor_validation(self):
        store = HashStore.build(port_table(make_table(n=100)), codec="none",
                                partition_bytes=2048)
        with pytest.raises(ValueError, match="boundaries"):
            FederatedStore([store, store], mode="partition")
        with pytest.raises(ValueError, match="ascending"):
            FederatedStore([store, store, store], mode="partition", boundaries=[9, 1])
        with pytest.raises(ValueError, match="mode"):
            FederatedStore([store], mode="magic")
        with pytest.raises(ValueError, match="policy"):
            FederatedStore([store], mode="replicate", policy="random")
        with pytest.raises(ValueError, match="mutation policy"):
            FederatedStore([store], mode="replicate", mutation_policy="drop")
        with pytest.raises(ValueError, match="no boundaries"):
            FederatedStore([store], mode="replicate", boundaries=[3])
        other = ArrayStore.build(Table(keys=np.arange(10, dtype=np.int64),
                                       columns={"z": np.arange(10, dtype=np.int32)}))
        with pytest.raises(ValueError, match="one schema"):
            FederatedStore([store, other], mode="replicate")
        with pytest.raises(NotImplementedError):
            FederatedStore([store], mode="replicate").save("/tmp/nope")
        with pytest.raises(NotImplementedError, match="repro_torch.open"):
            FederatedStore.load("/tmp/nope")

    def test_federated_pruning_evidence_propagates(self):
        """A federation with a prunable member reports the member's
        pruning through the merged explain stats."""
        n = 6000  # the reference suite's zoned table: one zone per long key run
        keys = np.arange(0, n * 3, 3, dtype=np.int64)
        zones = {"zone": ((keys // (n // 2)) % 5).astype(np.int32),
                 "b": ((keys // 32) % 3).astype(np.int32)}
        kw = dict(codec="zstd", dictionary=True, partition_bytes=4096)
        lo = (JArrayStore.build(JTable(keys=keys, columns=zones), **kw),
              ArrayStore.build(Table(keys=keys, columns=zones), **kw))
        hi = (JHashStore.build(JTable(keys=keys + 10**7, columns=zones), partition_bytes=2048),
              HashStore.build(Table(keys=keys + 10**7, columns=zones), partition_bytes=2048))
        fed, jfed = federate([lo, hi], mode="partition", boundaries=[10**6])
        res = fed.query().where("zone", "==", 4).scan().morsel(900).execute()
        want = jfed.query().where("zone", "==", 4).scan().morsel(900).execute()
        assert res.explain.partitions_pruned == want.explain.partitions_pruned > 0
        assert res.explain.async_fanout
        assert_rows_equal(res, want)


class TestFederatedAggregateJoin:
    def test_partition_aggregate_matches_union_oracle(self, partitioned):
        fed, jfed, _, union = partitioned
        groups, aggs = oracle(union, ("a", "b"))
        res = fed.query().group_by("a", "b").agg(*SPECS).scan().execute()
        assert_aggregate_equal(res, groups, aggs)
        want = jfed.query().group_by("a", "b").agg(*SPECS).scan().execute()
        assert_aggregate_equal(res, want.groups, want.aggregates)
        ref = fed.query().group_by("a", "b").agg(*SPECS).pushdown(False).scan().execute()
        assert_aggregate_equal(ref, groups, aggs)

    def test_replicate_aggregate(self):
        table = make_table(n=250)
        fed, jfed = federate([member("deepmapping", table), member("hash", table)],
                             mode="replicate", policy="round_robin")
        groups, aggs = oracle(table, ("a",))
        res = fed.query().group_by("a").agg(*SPECS).morsel(40).scan().execute()
        assert res.explain.morsels > 1
        assert_aggregate_equal(res, groups, aggs)
        want = jfed.query().group_by("a").agg(*SPECS).morsel(40).scan().execute()
        assert_aggregate_equal(res, want.groups, want.aggregates)

    def test_all_model_members_decode_zero_rows(self):
        fed, _ = federate([member("deepmapping", make_table(n=200)),
                           member("deepmapping", make_table(n=200, off=10_000))],
                          mode="partition", boundaries=[5000])
        res = fed.query().group_by("a").agg("count").scan().execute()
        assert res.explain.rows_decoded == 0

    def test_plan_cache_shared_across_members(self):
        table = make_table(n=300)
        m0, m1 = member("deepmapping", table)[1], member("deepmapping", table)[1]
        fed = FederatedStore([m0, m1], mode="replicate", policy="primary")
        cache = fed.plan_cache()
        assert m0.plan_cache() is cache and m1.plan_cache() is cache
        assert cache.table_hits == 0 and cache.table_misses == 0
        res = fed.query().group_by("a").agg(("sum", "c")).morsel(80).scan().execute()
        groups, aggs = oracle(table, ("a",), specs=(("sum", "c"),))
        assert_aggregate_equal(res, groups, aggs)
        first_misses = cache.table_misses
        assert first_misses >= 1
        fed.query().group_by("a").agg(("sum", "c")).scan().execute()
        m1.query().group_by("a").agg(("sum", "c")).scan().execute()
        assert cache.table_misses == first_misses
        assert cache.table_hits >= 1

    def test_join_across_federated_right(self, partitioned):
        fed, jfed, _, union = partitioned
        lt = make_table(n=400)
        left = member("hash", lt)
        key_fn = lambda k: (k * 7) % 12_000  # noqa: E731
        res = left[1].query().join(fed, key=key_fn).scan().execute()
        np.testing.assert_array_equal(res.keys, lt.keys[ref_join_mask(lt.keys, key_fn,
                                                                      union.keys)])
        assert_rows_equal(res, left[0].query().join(jfed, key=key_fn).scan().execute())

    def test_federated_member_loss_partial_aggregate(self):
        t_lo, t_hi = make_table(n=300), make_table(n=300, off=10_000)
        fed, jfed = federate([member("deepmapping", t_lo), member("hash", t_hi)],
                             mode="partition", boundaries=[5000], retry=TIGHT)
        groups, aggs = oracle(t_lo, ("a",))  # the healthy member only
        out = []
        for f, plan in ((fed, FaultPlan([FaultSpec(site="member_collect", owner="member:1",
                                                   kind="raise", times=99)])),
                        (jfed, jfault.FaultPlan([jfault.FaultSpec(
                            site="member_collect", owner="member:1", kind="raise",
                            times=99)]))):
            with plan.activate():
                res = f.query().group_by("a").agg(*SPECS).on_error("partial").scan().execute()
            out.append((res, plan.fired))
        (res, fired), (want, jfired) = out
        assert fired == jfired > 0
        assert res.explain.keys_unresolved == want.explain.keys_unresolved > 0
        assert res.explain.owners_failed == want.explain.owners_failed
        assert_aggregate_equal(res, groups, aggs)
