"""The port's sharded cluster (``repro_torch.cluster``) on the CPU, held
against the reference's ``repro.cluster``.

* The partitioners and the router, array for array against the
  reference's on the same keys.
* A cluster built and saved by the reference, opened by the port
  (``device="cpu"``, so every shard's fused tier runs K1's plain
  version): every key, absent keys and out-of-capacity keys answer byte
  for byte as in the reference, through ``lookup`` and ``query()``,
  fan-out and serial.  The port re-saves it: the manifest bytes equal
  the reference's, and the reference reopens it with the same answers.
* The port's own threaded build (one trainer per shard in a thread
  pool) is lossless on every key.
* The single-vs-cluster equivalence, modification equivalence,
  per-shard retrain, shared ``MemoryPool``, serialization and
  build-validation cases of ``tests/test_cluster.py``, on the port.
  ``TestServeIntegration`` there drives ``repro.serve.LookupServer``,
  which the port gets with ROADMAP item M9; it has no counterpart here
  yet.
* The kernel wrappers' launch counter and build lock under threads.
"""

import os
import threading

import numpy as np
import pytest

import repro
import repro_torch
from conftest import make_periodic_table, make_random_table
from repro.cluster import HashPartitioner as JHash
from repro.cluster import Partitioner as JPartitioner
from repro.cluster import RangePartitioner as JRange
from repro.cluster import ShardRouter as JRouter
from repro.cluster import partitioner as jpartitioner
from repro.cluster import plan_range_partitions as j_plan
from repro_torch import obs
from repro_torch.cluster import (
    ClusterConfig,
    HashPartitioner,
    Partitioner,
    RangePartitioner,
    ShardedDeepMappingStore,
    ShardRouter,
    load_sharded_store,
    make_partitioner,
    plan_range_partitions,
    save_sharded_store,
)
from repro_torch.cluster import partitioner as tpartitioner
from repro_torch.core import DeepMappingConfig, DeepMappingStore, Table
from repro_torch.core.trainer import TrainConfig
from repro_torch.kernels import build
from repro_torch.storage import MemoryPool
from torch_port_util import assert_values_equal, cluster_pair

FAST = DeepMappingConfig(
    shared=(64,), private=(16,), train=TrainConfig(epochs=15, batch_size=512)
)


def port_table(table):
    """The port's ``Table`` over a copy of a reference table's arrays."""
    return Table(keys=table.keys.copy(),
                 columns={c: v.copy() for c, v in table.columns.items()})


def periodic(n, **kw):
    return port_table(make_periodic_table(n=n, **kw))


def build_cluster(table, policy="range", num_shards=4, config=FAST, **kw):
    return ShardedDeepMappingStore.build(
        table, config, ClusterConfig(num_shards=num_shards, policy=policy),
        device="cpu", **kw)


def assert_equivalent(single, cluster, query_keys):
    """(values, exists) equality on the existence-masked contract."""
    v1, e1 = single.lookup(query_keys)
    v2, e2 = cluster.lookup(query_keys)
    np.testing.assert_array_equal(e1, e2)
    assert set(v1) == set(v2)
    for c in v1:
        np.testing.assert_array_equal(v1[c][e1], v2[c][e2])


def assert_answers_equal(a, b):
    """Two ``(values, exists)`` answers byte for byte."""
    np.testing.assert_array_equal(a[1], b[1])
    assert_values_equal(a[0], b[0])


# ------------------------------------------------------------ partitioner
class TestPartitioner:
    def test_range_planner_matches_reference_on_skewed_keys(self):
        rng = np.random.default_rng(0)
        # dense prefix + sparse tail: quantile boundaries, not equal widths
        keys = np.unique(np.concatenate(
            [np.arange(500), rng.integers(10_000, 10**6, 500)])).astype(np.int64)
        for k in (1, 2, 3, 4, 7, 64):
            part, ref = plan_range_partitions(keys, k), j_plan(keys, k)
            assert part.boundaries.tobytes() == ref.boundaries.tobytes()
            assert part.num_shards == ref.num_shards
            assert part.shard_of(keys).tobytes() == ref.shard_of(keys).tobytes()
        part = plan_range_partitions(keys, 4)
        counts = np.bincount(part.shard_of(keys), minlength=4)
        assert part.num_shards == 4 and counts.min() >= len(keys) // 8

    def test_range_assignment_and_shards_for_range(self):
        part, ref = RangePartitioner([100, 200]), JRange([100, 200])
        probe = np.array([-5, 0, 99, 100, 150, 199, 200, 10**9])
        np.testing.assert_array_equal(part.shard_of(probe), [0, 0, 0, 1, 1, 1, 2, 2])
        assert part.shard_of(probe).tobytes() == ref.shard_of(probe).tobytes()
        for lo, hi in ((0, 50), (50, 150), (0, 10**9), (5, 5), (200, 199), (199, 201)):
            assert (part.shards_for_range(lo, hi).tobytes()
                    == ref.shards_for_range(lo, hi).tobytes())
        np.testing.assert_array_equal(part.shards_for_range(50, 150), [0, 1])
        with pytest.raises(ValueError, match="distinct"):
            RangePartitioner([3, 3])

    @pytest.mark.parametrize("seed", (0, 7, 2**31 - 1))
    def test_splitmix64_on_edge_keys(self, seed):
        keys = np.array([0, 1, 2, 2**31 - 1, 2**31, 2**63 - 1, -1, -(2**63)],
                        dtype=np.int64)
        got = tpartitioner._splitmix64(keys, seed)
        want = jpartitioner._splitmix64(keys, seed)
        assert got.dtype == want.dtype == np.uint64
        assert got.tobytes() == want.tobytes()

    def test_hash_is_deterministic_uniform_and_equal(self):
        part, ref = HashPartitioner(8, seed=7), JHash(8, seed=7)
        keys = np.arange(0, 80_000, 2, dtype=np.int64)  # strided, low entropy
        sid = part.shard_of(keys)
        assert sid.tobytes() == ref.shard_of(keys).tobytes()
        assert np.bincount(sid, minlength=8).min() > 0.8 * keys.size / 8
        np.testing.assert_array_equal(part.shards_for_range(3, 9), np.arange(8))
        assert part.shards_for_range(9, 3).size == 0
        with pytest.raises(ValueError, match="at least one shard"):
            HashPartitioner(0)

    def test_state_roundtrips_across_packages(self):
        keys = np.arange(-50, 100, dtype=np.int64)
        for part, ref in ((RangePartitioner([10, 20, 30]), JRange([10, 20, 30])),
                          (HashPartitioner(5, seed=3), JHash(5, seed=3))):
            assert part.to_state() == ref.to_state()
            for clone in (Partitioner.from_state(ref.to_state()),
                          JPartitioner.from_state(part.to_state())):
                assert clone.shard_of(keys).tobytes() == part.shard_of(keys).tobytes()
        with pytest.raises(ValueError, match="unknown partition policy"):
            Partitioner.from_state({"policy": "zigzag"})

    def test_make_partitioner(self):
        keys = np.arange(0, 3000, 3, dtype=np.int64)
        assert make_partitioner("range", keys, 3).to_state() == \
            jpartitioner.make_partitioner("range", keys, 3).to_state()
        assert make_partitioner("hash", keys, 3, seed=5).to_state() == \
            {"policy": "hash", "num_shards": 3, "seed": 5}
        with pytest.raises(ValueError, match="unknown partition policy"):
            make_partitioner("round", keys, 3)


# ----------------------------------------------------------------- router
class TestRouter:
    @pytest.mark.parametrize("policy", ("range", "hash"))
    def test_scatter_matches_reference(self, policy):
        state = ({"policy": "range", "boundaries": [250, 600, 900]} if policy == "range"
                 else {"policy": "hash", "num_shards": 4, "seed": 0})
        router = ShardRouter(Partitioner.from_state(state))
        ref = JRouter(JPartitioner.from_state(state))
        keys = np.random.default_rng(2).integers(-10, 1200, 1000).astype(np.int64)
        got, want = router.scatter(keys), ref.scatter(keys)
        assert [b.shard_id for b in got] == [b.shard_id for b in want]
        for a, b in zip(got, want):
            assert a.positions.tobytes() == b.positions.tobytes()
            assert a.keys.tobytes() == b.keys.tobytes()
        recon = np.zeros_like(keys)
        for b in got:
            recon[b.positions] = b.keys
        np.testing.assert_array_equal(recon, keys)
        assert router.scatter(np.zeros(0, np.int64)) == []
        assert router.num_shards == 4

    def test_gather_and_gather_partial_match_reference(self):
        state = {"policy": "hash", "num_shards": 3, "seed": 1}
        router = ShardRouter(Partitioner.from_state(state))
        ref = JRouter(JPartitioner.from_state(state))
        keys = np.arange(0, 300, 7, dtype=np.int64)
        payload = {"v": (keys * 3).astype(np.int32), "s": keys.astype(str)}

        def parts(batches):
            return [(b, ShardRouter.take_columns(payload, b.positions),
                     b.keys % 2 == 0) for b in batches]

        got = ShardRouter.gather(keys.size, parts(router.scatter(keys)))
        want = JRouter.gather(keys.size, parts(ref.scatter(keys)))
        assert_answers_equal(got, want)
        np.testing.assert_array_equal(got[0]["v"], payload["v"])
        # One shard lost: its positions are uncovered and absent.
        healthy = parts(router.scatter(keys))[1:]
        got = ShardRouter.gather_partial(keys.size, healthy)
        want = JRouter.gather_partial(keys.size, parts(ref.scatter(keys))[1:])
        assert_answers_equal(got[:2], want[:2])
        np.testing.assert_array_equal(got[2], want[2])
        assert not got[2].all() and got[2].any()


# ------------------------------------------ a reference cluster in the port
@pytest.fixture(scope="module", params=("range", "hash"))
def ref_cluster(request, tmp_path_factory):
    table = make_periodic_table(n=1600)
    path = tmp_path_factory.mktemp(f"ref_{request.param}") / "cluster"
    jcluster, cluster = cluster_pair(table, path, policy=request.param)
    return table, jcluster, cluster, path


def probe_keys(table):
    """Every key shuffled, absent keys between them (stride 2), and keys
    outside every shard's capacity."""
    rng = np.random.default_rng(0)
    return np.concatenate([rng.permutation(table.keys), table.keys[:200] + 1,
                           np.array([10**8, 2**40, 2**62, -1, -7], dtype=np.int64)])


class TestReferenceClusterInPort:
    def test_opens_as_a_cluster_on_the_cpu(self, ref_cluster):
        _, jcluster, cluster, _ = ref_cluster
        assert isinstance(cluster, ShardedDeepMappingStore)
        assert cluster.num_shards == jcluster.num_shards == 3
        assert cluster.partitioner.to_state() == jcluster.partitioner.to_state()
        assert all(s.device.type == "cpu" and s.config.use_kernels for s in cluster.shards)
        # One engine cache for the fleet: every shard engine shares its stats.
        assert all(s.engine.stats is cluster.engines.stats for s in cluster.shards)
        assert cluster.columns == jcluster.columns
        assert cluster.num_rows == jcluster.num_rows
        assert cluster.size_breakdown() == jcluster.size_breakdown()
        assert cluster.memorized_fraction() == jcluster.memorized_fraction()
        assert [s.aux.num_rows for s in cluster.shards] == \
            [s.aux.num_rows for s in jcluster.shards]

    def test_lookup_every_key_absent_and_out_of_capacity(self, ref_cluster):
        table, jcluster, cluster, _ = ref_cluster
        q = probe_keys(table)
        got, want = cluster.lookup(q), jcluster.lookup(q)
        assert_answers_equal(got, want)
        n = table.num_rows
        assert got[1][:n].all() and not got[1][n:].any()
        order = np.argsort(q[:n])
        for c, col in table.columns.items():
            np.testing.assert_array_equal(got[0][c][:n][order], col)

    @pytest.mark.parametrize("fanout", (True, False))
    def test_query_fanout_and_serial(self, ref_cluster, fanout):
        table, jcluster, cluster, _ = ref_cluster
        q = probe_keys(table)
        got = cluster.query().where_keys(q).fanout(fanout).execute()
        want = jcluster.query().where_keys(q).fanout(fanout).execute()
        np.testing.assert_array_equal(got.exists, want.exists)
        assert_values_equal(got.values, want.values)
        assert ("fanout" if fanout else "serial") in got.explain.plan
        assert "mesh" not in got.explain.plan
        assert got.explain.shards_visited == 3
        assert got.explain.retries == 0 and got.explain.owners_failed == ()

    def test_plans_match_reference(self, ref_cluster):
        table, jcluster, cluster, _ = ref_cluster
        lo, hi = int(table.keys[100]), int(table.keys[1200])
        for build_q in (lambda s: s.scan(),
                        lambda s: s.where_range(lo, hi),
                        lambda s: s.select("col1").where("col0", "==", 2).scan(),
                        lambda s: s.where("col1", "!=", 1).where_keys(table.keys[::3]),
                        lambda s: s.group_by("col0").agg("count", ("sum", "col1")).scan()):
            got, want = build_q(cluster.query()).execute(), build_q(jcluster.query()).execute()
            if hasattr(want, "aggregates"):
                for c in want.groups:
                    np.testing.assert_array_equal(got.groups[c], want.groups[c])
                for k in want.aggregates:
                    np.testing.assert_array_equal(got.aggregates[k], want.aggregates[k])
                continue
            assert got.keys.tobytes() == want.keys.tobytes()
            np.testing.assert_array_equal(got.exists, want.exists)
            assert_values_equal(got.values, want.values)

    def test_shard_counters_and_spans(self, ref_cluster):
        table, _, cluster, _ = ref_cluster
        reg = obs.registry()

        def total(name):
            metric = reg.get(name)
            return 0.0 if metric is None else sum(v for _, v in metric.items())

        before = {n: total(n) for n in ("deepmap_shard_visits_total", "deepmap_shard_keys_total")}
        spans = len(obs.tracer().spans("shard_collect", track="shards"))
        res = cluster.query().where_keys(table.keys).morsel(1 << 14).execute()
        visits = total("deepmap_shard_visits_total") - before["deepmap_shard_visits_total"]
        assert visits >= 3
        assert total("deepmap_shard_keys_total") - before["deepmap_shard_keys_total"] \
            == table.num_rows
        assert reg.get("deepmap_shard_collect_seconds") is not None
        assert len(obs.tracer().spans("shard_collect", track="shards")) - spans == visits
        assert res.exists.all()

    def test_resaved_manifest_equals_reference_and_reopens_there(self, ref_cluster, tmp_path):
        table, jcluster, cluster, path = ref_cluster
        out = tmp_path / "resaved"
        cluster.save(str(out))
        assert (out / "manifest.msgpack").read_bytes() == \
            (path / "manifest.msgpack").read_bytes()
        assert sorted(os.listdir(out)) == sorted(os.listdir(path))
        for d in sorted(p for p in os.listdir(path) if p.startswith("shard_")):
            assert sorted(os.listdir(out / d)) == sorted(os.listdir(path / d))
            for f in ("aux.msgpack", "vexist.bin"):
                assert (out / d / f).read_bytes() == (path / d / f).read_bytes(), (d, f)
            a, b = np.load(out / d / "params.npz"), np.load(path / d / "params.npz")
            assert sorted(a.files) == sorted(b.files)
            for k in b.files:
                assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()
        q = probe_keys(table)
        reopened = repro.open(str(out))
        assert_answers_equal(reopened.lookup(q), jcluster.lookup(q))
        again = repro_torch.open(str(out), device="cpu")
        assert_answers_equal(again.lookup(q), cluster.lookup(q))


# ---------------------------------------------------- the port's own build
class TestPortBuild:
    @pytest.mark.parametrize("policy", ("range", "hash"))
    def test_threaded_build_is_lossless(self, policy):
        table = periodic(1600)
        cluster = repro_torch.build(table, FAST, cluster=ClusterConfig(
            num_shards=4, policy=policy, max_workers=4), device="cpu")
        assert isinstance(cluster, ShardedDeepMappingStore) and cluster.num_shards == 4
        assert all(s.device.type == "cpu" for s in cluster.shards)
        assert all(s.engine.stats is cluster.engines.stats for s in cluster.shards)
        values, exists = cluster.lookup(table.keys)
        assert exists.all()
        for c, col in table.columns.items():
            np.testing.assert_array_equal(values[c], col)
        res = cluster.query().where("col0", "==", 2).scan().execute()
        assert res.explain.kernel_filtered
        np.testing.assert_array_equal(res.keys, table.keys[table.columns["col0"] == 2])

    def test_spec_params_are_single_store_only(self):
        with pytest.raises(ValueError, match="single-store"):
            repro_torch.build(periodic(100), FAST, cluster=ClusterConfig(num_shards=2),
                              spec=object(), device="cpu")

    def test_one_shard_builds_a_single_store(self):
        store = repro_torch.build(periodic(200), FAST, cluster=ClusterConfig(num_shards=1),
                                  device="cpu")
        assert isinstance(store, DeepMappingStore)


# ----------------------------------- the cases of tests/test_cluster.py
@pytest.fixture(scope="module", params=["range", "hash"])
def equivalent_pair(request):
    table = periodic(1600)
    single = DeepMappingStore.build(table, FAST, device="cpu")
    cluster = build_cluster(table, request.param)
    return table, single, cluster


class TestEquivalence:
    def test_lookup_matches_single_store(self, equivalent_pair):
        table, single, cluster = equivalent_pair
        assert cluster.num_shards == 4
        rng = np.random.default_rng(0)
        q = np.concatenate([rng.permutation(table.keys), table.keys[:100] + 1,
                            np.array([10**8], dtype=np.int64)])
        assert_equivalent(single, cluster, q)

    def test_range_lookup_matches_single_store(self, equivalent_pair):
        table, single, cluster = equivalent_pair
        lo, hi = int(table.keys[100]), int(table.keys[900])
        k1, v1 = single.range_lookup(lo, hi)
        k2, v2 = cluster.range_lookup(lo, hi)
        np.testing.assert_array_equal(k1, k2)
        for c in v1:
            np.testing.assert_array_equal(v1[c], v2[c])

    def test_accounting_aggregates(self, equivalent_pair):
        _, _, cluster = equivalent_pair
        bd = cluster.size_breakdown()
        assert set(bd) == {"model", "aux_table", "exist_bitvector", "decode_map"}
        assert cluster.size_bytes() == sum(bd.values())
        assert 0.0 <= cluster.memorized_fraction() <= 1.0


class TestModificationEquivalence:
    @pytest.mark.parametrize("policy", ["range", "hash"])
    def test_interleaved_modifications_match_single_store(self, policy):
        table = periodic(900)
        single = DeepMappingStore.build(table, FAST, device="cpu")
        cluster = build_cluster(table, policy)
        rng = np.random.default_rng(1)
        base = int(table.keys.max())
        ins = np.arange(base + 3, base + 103, dtype=np.int64)
        cols = {"col0": rng.integers(0, 5, ins.size).astype(np.int32),
                "col1": rng.integers(0, 3, ins.size).astype(np.int32)}
        upd = {"col0": rng.integers(0, 5, 40).astype(np.int32),
               "col1": rng.integers(0, 3, 40).astype(np.int32)}
        for store in (single, cluster):
            store.insert(ins, cols)
            store.update(ins[:40], upd)
            store.delete(ins[40:70])
            store.delete(ins[40:70])  # idempotent
            store.update(table.keys[:10], {c: v[:10] for c, v in upd.items()})
            store.delete(table.keys[10:20])
        q = np.concatenate([table.keys, ins, ins + 200])
        assert_equivalent(single, cluster, q)
        assert single.num_rows == cluster.num_rows

    def test_insert_existing_raises_without_partial_mutation(self):
        table = periodic(600)
        cluster = build_cluster(table, "range")
        base = int(table.keys.max())
        keys = np.array([base + 11, int(table.keys[0])], dtype=np.int64)  # 2nd exists
        with pytest.raises(ValueError):
            cluster.insert(keys, {"col0": np.array([1, 1], np.int32),
                                  "col1": np.array([1, 1], np.int32)})
        _, exists = cluster.lookup(keys[:1])
        assert not exists.any()  # no shard mutated before validation failed
        with pytest.raises(ValueError, match="duplicate"):
            cluster.insert(np.array([base + 11] * 2), {"col0": np.array([1, 1], np.int32),
                                                        "col1": np.array([1, 1], np.int32)})

    def test_update_missing_raises(self):
        cluster = build_cluster(periodic(600), "hash")
        with pytest.raises(ValueError):
            cluster.update(np.array([10**7]), {"col0": np.array([1]), "col1": np.array([1])})


RETRAIN = DeepMappingConfig(shared=(64,), private=(16,),
                            train=TrainConfig(epochs=15, batch_size=512),
                            retrain_after_modified_bytes=1)


class TestPerShardRetrain:
    def test_only_dirty_shards_retrain(self):
        table = periodic(800)
        cluster = build_cluster(table, "range", config=RETRAIN)
        untouched = [id(s) for s in cluster.shards]
        assert not cluster.should_retrain()
        k = table.keys[:2]  # dirty exactly one shard: the lowest range
        cluster.update(k, {"col0": np.array([1, 2], np.int32),
                           "col1": np.array([0, 1], np.int32)})
        assert cluster.dirty_shards() == [0]
        v0 = cluster.mutation_version()
        assert cluster.retrain() == [0]
        assert cluster.mutation_version() != v0
        assert not cluster.should_retrain()
        assert id(cluster.shards[0]) != untouched[0]
        assert [id(s) for s in cluster.shards[1:]] == untouched[1:]
        # The rebuilt shard stays on the fleet's device and joins its stats.
        assert cluster.shards[0].device.type == "cpu"
        assert cluster.shards[0].engine.stats is cluster.engines.stats
        vals, exists = cluster.lookup(k)
        assert exists.all()
        np.testing.assert_array_equal(vals["col0"], [1, 2])

    def test_equivalence_after_retrain(self):
        table = periodic(800)
        single = DeepMappingStore.build(table, RETRAIN, device="cpu")
        cluster = build_cluster(table, "hash", config=RETRAIN)
        base = int(table.keys.max())
        ins = np.arange(base + 2, base + 42, dtype=np.int64)
        cols = {"col0": (ins % 5).astype(np.int32), "col1": (ins % 3).astype(np.int32)}
        single.insert(ins, cols)
        cluster.insert(ins, cols)
        single = single.retrain()   # whole-relation rebuild
        assert cluster.retrain()    # only dirty shards rebuild
        assert_equivalent(single, cluster, np.concatenate([table.keys, ins, ins + 99]))


class TestClusterSerialization:
    def test_roundtrip(self, tmp_path):
        table = periodic(800)
        cluster = build_cluster(table, "range")
        p = os.path.join(tmp_path, "cluster")
        save_sharded_store(cluster, p)
        clone = load_sharded_store(p, device="cpu")
        assert clone.num_shards == cluster.num_shards
        assert clone.cluster.policy == "range"
        q = np.concatenate([table.keys, table.keys[:64] + 1])
        assert_equivalent(cluster, clone, q)
        assert not os.path.exists(p + ".tmp")
        # The reference opens the port's save with the same answers.
        assert_equivalent(cluster, repro.open(p), q)

    def test_overwrite_is_atomic(self, tmp_path):
        cluster = build_cluster(periodic(600), "hash", num_shards=2)
        p = os.path.join(tmp_path, "cluster")
        save_sharded_store(cluster, p)
        save_sharded_store(cluster, p)
        assert not os.path.exists(p + ".tmp")
        assert load_sharded_store(p, device="cpu").num_shards == 2


class TestSharedMemoryPool:
    def test_shards_share_one_pool_under_eviction(self):
        table = port_table(make_random_table(n=1200, cards=(17, 11)))
        pool = MemoryPool(4096)  # tiny: forces partition eviction
        cfg = DeepMappingConfig(shared=(32,), private=(8,), partition_bytes=512,
                                train=TrainConfig(epochs=3, batch_size=512))
        cluster = build_cluster(table, "range", config=cfg, pool=pool)
        assert all(s.aux.pool is pool for s in cluster.shards)
        for _ in range(3):
            vals, exists = cluster.lookup(table.keys)
            assert exists.all()
            np.testing.assert_array_equal(vals["col0"], table.columns["col0"])
        assert pool.evictions > 0            # pressure actually happened
        assert pool.used_bytes <= pool.budget_bytes


class TestBuildValidation:
    def test_empty_hash_shard_raises(self):
        with pytest.raises(ValueError, match="empty"):
            build_cluster(periodic(6), "hash", num_shards=64)

    def test_range_planner_collapses_gracefully(self):
        table = periodic(6)
        cluster = build_cluster(table, "range")
        assert 1 <= cluster.num_shards <= 4
        _, exists = cluster.lookup(table.keys)
        assert exists.all()

    def test_range_planner_more_shards_than_rows(self):
        # num_shards > rows: quantile cuts hit the minimum key, which
        # must not become a boundary (empty shard 0); count collapses.
        part = plan_range_partitions(np.array([5, 10], dtype=np.int64), 4)
        assert part.num_shards <= 2
        counts = np.bincount(part.shard_of(np.array([5, 10])), minlength=part.num_shards)
        assert counts.min() > 0
        table = periodic(2)
        cluster = build_cluster(table, "range")
        _, exists = cluster.lookup(table.keys)
        assert exists.all()


# ------------------------------------------- the kernels' wrappers, threaded
class TestKernelsUnderThreads:
    def test_launch_counter_is_exact_across_threads(self):
        def call():
            pass
        call.launches = call.pred_launches = 0
        start = threading.Barrier(8)

        def work():
            start.wait()
            for i in range(1000):
                if i % 2:
                    build.count_launch(call, "launches", "pred_launches")
                else:
                    build.count_launch(call)

        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert call.launches == 8000 and call.pred_launches == 4000

    def test_first_use_from_many_threads_builds_once(self, tmp_path, monkeypatch):
        """With the build directory empty, eight threads asking for one
        library at once compile it once and load it once, after the
        compiler has finished writing it: ``nvcc`` here is a stand-in
        that writes its output slowly, in two halves."""
        monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "kernels"))
        monkeypatch.setattr(build, "_LIBS", {})
        monkeypatch.setattr(build, "BUILD_INFO", {})
        log = tmp_path / "nvcc.log"
        fake = tmp_path / "nvcc"
        fake.write_text(
            "#!/usr/bin/env python3\n"
            "import sys, time\n"
            f"open({str(log)!r}, 'a').write('run\\n')\n"
            "out = sys.argv[sys.argv.index('-o') + 1]\n"
            "with open(out, 'w') as f:\n"
            "    f.write('half,'); f.flush(); time.sleep(0.3); f.write('whole')\n")
        fake.chmod(0o755)
        monkeypatch.setattr(build, "_nvcc", lambda: str(fake))
        loads = []

        class FakeLib:
            def __init__(self, path):
                with open(path) as f:
                    loads.append(f.read())
                self.repro_error_string = type("Fn", (), {})()

        monkeypatch.setattr(build.ctypes, "CDLL", FakeLib)
        bound = []
        start = threading.Barrier(8)
        got = [None] * 8

        def work(i):
            start.wait()
            got[i] = build.library("bitvector.cu", bound.append)

        threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert log.read_text() == "run\n"
        assert loads == ["half,whole"] and len(bound) == 1
        assert all(lib is got[0] for lib in got)
        assert build.library_path("bitvector.cu").parent == tmp_path / "kernels"
