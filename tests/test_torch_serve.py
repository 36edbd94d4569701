"""The port's batched lookup server (``repro_torch.serve``) on the CPU,
held against the reference's ``repro.serve.LookupServer``.

Every case starts from stores the reference built and saved: both
packages open the same files (the port with ``device="cpu"``, so its
fused tier runs K1's plain version) and serve the same request lists,
made with numpy from a seed.  Per case:

* answers byte for byte: each column's values and dtype, and ``exists``;
* the integer ``ServeStats`` fields equal, and each timing field positive
  wherever the reference's is;
* the ``deepmap_serve_*`` families of the two packages' metrics
  registries (a fresh one each) equal in name, kind, help, label sets,
  counter values and histogram counts (the batch-size histogram's
  buckets too; latencies are times).

The cases are the eleven of ``tests/test_serve.py::TestLookupServer``,
with that file's assertions on the port's answers, and four more: an AB
baseline whose placeholder chunk promotes on gather, a federation of a
DeepMapping store and the AB store, and ``on_error="partial"`` over a
4-shard cluster with one shard, then every shard, failing at
``shard_collect`` under one ``FaultPlan`` per package.

The launcher (``repro_torch.launch.serve``): its dataset registry and
DM configs equal the benchmarks' (``benchmarks/common.py``), table for
table; ``main([... "--device", "cpu"])`` builds, saves and serves a
small DM-R store, then takes the reopen path of ``--store-dir``; without
``--device`` it runs on the card, and raises where there is none.
"""

import numpy as np
import pytest

import repro
import repro_torch
from conftest import make_periodic_table
from repro import fault as jfault
from repro import obs as jobs
from repro.api import FederatedStore as JFederated
from repro.baselines import BASELINE_FACTORIES as J_BASELINES
from repro.core import DeepMappingConfig as JConfig
from repro.core import DeepMappingStore as JStore
from repro.core import Table as JTable
from repro.core.trainer import TrainConfig as JTrainConfig
from repro.serve import LookupServer as JServer
from repro_torch import obs
from repro_torch.api import FederatedStore
from repro_torch.fault import FaultPlan, FaultSpec
from repro_torch.serve import LookupServer, ServeStats
from torch_port_util import assert_values_equal, cluster_pair

INT_FIELDS = ("requests", "keys", "batches", "cache_hits", "cache_misses", "cache_bypass")
TIME_FIELDS = ("total_s", "route_s", "infer_s", "exist_s", "aux_s", "filter_s", "decode_s",
               "gather_s")


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """The reference test's store (``make_periodic_table(n=2000)``,
    shared (64,), private (16,), 15 epochs), built and saved by the
    reference; an AB baseline of a table with a string column, and one
    of the upper half of the store's table (a federation member)."""
    root = tmp_path_factory.mktemp("serve")
    table = make_periodic_table(n=2000)
    JStore.build(table, JConfig(shared=(64,), private=(16,),
                                train=JTrainConfig(epochs=15, batch_size=512))
                 ).save(str(root / "dm"))
    keys = table.keys + 1
    ab_table = JTable(keys=keys, columns={
        "grade": np.array(["low", "mid", "high"])[(keys // 7) % 3],
        "col0": ((keys // 5) % 4).astype(np.int32),
    })
    J_BASELINES["AB"](ab_table).save(str(root / "ab.bin"))
    upper = table.keys >= np.median(table.keys)
    J_BASELINES["AB"](JTable(keys=table.keys[upper], columns={
        c: v[upper] for c, v in table.columns.items()})).save(str(root / "ab_upper.bin"))
    return table, ab_table, root


@pytest.fixture
def registries():
    """A fresh metrics registry in each package for one case."""
    jreg, reg = jobs.MetricsRegistry(), obs.MetricsRegistry()
    prev = jobs.set_registry(jreg), obs.set_registry(reg)
    yield jreg, reg
    jobs.set_registry(prev[0])
    obs.set_registry(prev[1])


class Pair:
    """One server per package over the same saved store."""

    def __init__(self, jstore, store, registries, **kw):
        self.jsrv, self.srv = JServer(jstore, **kw), LookupServer(store, **kw)
        self.jreg, self.reg = registries

    def serve(self, requests, columns=None):
        """Both servers answer ``requests``; the answers must be equal
        byte for byte.  Returns the port's."""
        want = self.jsrv.lookup_many(requests, columns)
        got = self.srv.lookup_many(requests, columns)
        assert len(got) == len(want)
        for (gv, ge), (wv, we) in zip(got, want):
            assert ge.dtype == we.dtype and ge.tobytes() == we.tobytes()
            assert_values_equal(gv, wv)
        self.check_stats()
        return got

    def check_stats(self):
        for f in INT_FIELDS:
            assert getattr(self.srv.stats, f) == getattr(self.jsrv.stats, f), f
        for f in TIME_FIELDS:
            if getattr(self.jsrv.stats, f) > 0:
                assert getattr(self.srv.stats, f) > 0, f
        assert serve_families(self.reg) == serve_families(self.jreg)

    def reset_stats(self):
        self.jsrv.stats = type(self.jsrv.stats)()
        self.srv.stats = ServeStats()


def serve_families(reg):
    """What the two packages' ``deepmap_serve_*`` families must share."""
    out = {}
    for m in reg.collect():
        if not m.name.startswith("deepmap_serve_"):
            continue
        if m.kind != "histogram":
            out[m.name] = (m.kind, m.help, m.items())
            continue
        sizes = m.name == "deepmap_serve_batch_keys"
        out[m.name] = (m.kind, m.help, tuple(m.buckets), [
            (k, st.count, (st.sum, tuple(st.counts)) if sizes else None) for k, st in m.items()])
    return out


@pytest.fixture
def pair(saved, registries):
    _, _, root = saved
    return Pair(repro.open(str(root / "dm")), repro_torch.open(str(root / "dm"), device="cpu"),
                registries, max_batch=512)


class TestLookupServer:
    def test_single_request(self, saved, pair):
        table = saved[0]
        ((vals, exists),) = pair.serve([table.keys[:100]])
        assert exists.all()
        np.testing.assert_array_equal(vals["col0"], table.columns["col0"][:100])

    def test_merged_requests_scatter_correctly(self, saved, pair):
        table = saved[0]
        rng = np.random.default_rng(0)
        reqs = [rng.choice(table.keys, size=s) for s in (17, 300, 5)]
        lut = dict(zip(table.keys.tolist(), table.columns["col0"].tolist()))
        for req, (vals, exists) in zip(reqs, pair.serve(reqs)):
            assert exists.all()
            assert [lut[k] for k in req.tolist()] == vals["col0"].tolist()

    def test_dedup_shares_inference(self, saved, pair):
        table = saved[0]
        same = np.full(1000, int(table.keys[3]), dtype=np.int64)
        out = pair.serve([same, same])
        assert all(e.all() for _, e in out)
        # 2000 requested keys collapse into one device batch
        assert pair.srv.stats.batches == 1 and pair.srv.stats.keys == 2000

    def test_missing_keys_null(self, saved, pair):
        table = saved[0]
        ((_, exists),) = pair.serve([np.array([table.max_key + 7, table.max_key + 9])])
        assert not exists.any()

    def test_column_projection(self, saved, pair):
        table = saved[0]
        ((vals, _),) = pair.serve([table.keys[:5]], columns=("col1",))
        assert set(vals) == {"col1"}

    def test_empty_request_list(self, pair):
        assert pair.jsrv.lookup_many([]) == [] and pair.srv.lookup_many([]) == []
        pair.check_stats()

    def test_zero_length_requests(self, pair):
        out = pair.serve([np.zeros(0, dtype=np.int64)] * 3)
        assert len(out) == 3
        for vals, exists in out:
            assert exists.shape == (0,)
            # typed empty columns, same contract as the store itself
            assert set(vals) == set(pair.srv.store.columns)
            assert all(arr.shape == (0,) for arr in vals.values())

    def test_stats_accumulate(self, saved, pair):
        table = saved[0]
        pair.serve([table.keys[:10]])
        pair.serve([table.keys[:10]])
        assert pair.srv.stats.requests == 2
        assert pair.srv.stats.qps() > 0

    def test_stats_record_all_pipeline_stages(self, saved, pair):
        table = saved[0]
        pair.reset_stats()
        pair.serve([table.keys[:200]])
        s = pair.srv.stats
        assert s.infer_s > 0 and s.decode_s > 0
        assert s.exist_s >= 0 and s.aux_s >= 0
        assert s.total_s > 0

    def test_stats_route_and_gather_timings(self, saved, pair):
        table = saved[0]
        pair.reset_stats()
        pair.serve([table.keys[:100], table.keys[50:150]])
        s = pair.srv.stats
        assert s.route_s >= 0 and s.filter_s >= 0
        assert s.gather_s > 0  # per-request scatter always does work

    def test_stats_plan_cache_outcomes(self, saved, pair):
        table = saved[0]
        pair.reset_stats()
        pair.serve([table.keys[:64]])
        pair.serve([table.keys[:64]])
        s = pair.srv.stats
        # every request is exactly one of hit/miss/bypass
        assert s.cache_hits + s.cache_misses + s.cache_bypass == 2


def requests_of(keys, rng, n, absent=()):
    """``n`` requests of 1 to 300 keys drawn from ``keys`` and ``absent``."""
    pool = np.concatenate([keys, np.asarray(absent, dtype=np.int64)])
    return [rng.choice(pool, size=int(rng.integers(1, 301))) for _ in range(n)]


class TestOtherStores:
    def test_ab_placeholder_chunk_promotes_on_gather(self, saved, registries):
        """The first morsel holds only absent keys, so the AB store
        answers it with int64 placeholder columns; the next morsels hold
        strings and int32: the gather promotes rather than truncates."""
        _, ab_table, root = saved
        pair = Pair(repro.open(str(root / "ab.bin")), repro_torch.open(str(root / "ab.bin")),
                    registries, max_batch=64)
        absent = -np.arange(1, 65, dtype=np.int64)
        reqs = requests_of(ab_table.keys, np.random.default_rng(1), 6, absent)
        out = pair.serve([absent] + reqs)
        assert pair.srv.stats.batches > 1
        vals, exists = out[0]
        assert not exists.any() and vals["grade"].dtype.kind == "U"
        assert vals["col0"].dtype == np.int64
        lut = dict(zip(ab_table.keys.tolist(), ab_table.columns["grade"].tolist()))
        for req, (v, e) in zip(reqs, out[1:]):
            assert (e == np.isin(req, ab_table.keys)).all()
            assert [lut[k] for k in req[e].tolist()] == v["grade"][e].tolist()

    def test_federation_of_deepmapping_and_ab(self, saved, registries):
        """The DeepMapping store owns the keys below the median, the AB
        store of the upper half the rest."""
        table, _, root = saved
        bound = int(np.median(table.keys))
        members = [(repro.open(str(root / "dm")), repro_torch.open(str(root / "dm"), device="cpu")),
                   (repro.open(str(root / "ab_upper.bin")),
                    repro_torch.open(str(root / "ab_upper.bin")))]
        pair = Pair(JFederated([m[0] for m in members], mode="partition", boundaries=[bound]),
                    FederatedStore([m[1] for m in members], mode="partition", boundaries=[bound]),
                    registries, max_batch=256)
        rng = np.random.default_rng(2)
        reqs = requests_of(table.keys, rng, 8, [-5, 1, 10**7])
        out = pair.serve(reqs, columns=("col0",))
        lut = dict(zip(table.keys.tolist(), table.columns["col0"].tolist()))
        for req, (v, e) in zip(reqs, out):
            assert (e == np.isin(req, table.keys)).all() and set(v) == {"col0"}
            assert [lut[k] for k in req[e].tolist()] == v["col0"][e].tolist()


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    table = make_periodic_table(n=1200)
    return (table,) + cluster_pair(table, tmp_path_factory.mktemp("srv") / "c",
                                   epochs=5, num_shards=4)


class TestPartialUnderFaults:
    @pytest.mark.parametrize("owner", ["shard:1", None], ids=["one_shard", "every_shard"])
    def test_partial_answers_match_reference(self, clusters, registries, owner):
        table, jcluster, cluster = clusters
        pair = Pair(jcluster, cluster, registries, max_batch=256, on_error="partial")
        reqs = requests_of(table.keys, np.random.default_rng(3), 6, [-3, 10**6])
        jplan = jfault.FaultPlan([jfault.FaultSpec(site="shard_collect", owner=owner)])
        plan = FaultPlan([FaultSpec(site="shard_collect", owner=owner)])
        with jplan.activate():
            want = pair.jsrv.lookup_many(reqs)
        with plan.activate():
            got = pair.srv.lookup_many(reqs)
        assert plan.fired == jplan.fired > 0
        for (gv, ge), (wv, we) in zip(got, want):
            assert ge.tobytes() == we.tobytes()
            assert_values_equal(gv, wv, ge)
        pair.check_stats()
        degraded = [r.get("deepmap_fault_degraded_morsels_total") for r in (pair.reg, pair.jreg)]
        counts = [0 if d is None else sum(v for _, v in d.items()) for d in degraded]
        assert counts[0] == counts[1]
        dead = np.ones(table.num_rows, dtype=bool) if owner is None else (
            cluster.partitioner.shard_of(table.keys) == 1)
        for req, (_, e) in zip(reqs, got):
            alive = np.isin(req, table.keys[~dead])
            assert (e == alive).all()
        if owner is None:
            assert counts[0] == pair.srv.stats.batches > 0
        else:
            assert counts[0] == 0


class TestLauncher:
    """``python -m repro_torch.launch.serve``, called in-process."""

    def test_registry_and_configs_are_the_benchmarks(self):
        import dataclasses

        from benchmarks import common
        from repro_torch.launch import serve as launcher

        assert list(launcher.DATASETS) == list(common.DATASETS)
        for name, make in common.DATASETS.items():
            want, got = make(), launcher.DATASETS[name]()
            assert got.keys.tobytes() == want.keys.tobytes(), name
            assert_values_equal(got.columns, want.columns)
        assert list(launcher.DM_CONFIGS) == list(common.DM_CONFIGS)
        for name, want in common.DM_CONFIGS.items():
            want = dataclasses.asdict(want)
            got = dataclasses.asdict(launcher.DM_CONFIGS[name])
            assert got.pop("use_kernels") is True and want.pop("use_pallas") is False
            assert got == want, name

    def test_builds_saves_then_reopens_and_serves(self, monkeypatch, capsys, tmp_path):
        from repro_torch.data import customer_demographics_like
        from repro_torch.launch import serve as launcher

        monkeypatch.setitem(launcher.DATASETS, "tpcds_customer_demographics",
                            lambda: customer_demographics_like(n=3000))
        table = launcher.DATASETS["tpcds_customer_demographics"]()
        argv = ["--dataset", "tpcds_customer_demographics", "--variant", "DM-R",
                "--requests", "12", "--request-size", "150", "--store-dir",
                str(tmp_path / "s"), "--device", "cpu"]
        for run in ("build", "reopen"):
            srv = launcher.main(argv)
            out = capsys.readouterr().out.splitlines()
            assert ("loaded store from " + str(tmp_path / "s") in out) == (run == "reopen")
            assert out[-2].startswith("store: ratio=")
            assert "all-found=12/12;" in out[-1] and out[-1].startswith("served 12 requests")
            assert srv.store.device.type == "cpu" and srv.store.encoder.residues
            assert (srv.stats.requests, srv.stats.keys) == (12, 1800)
            vals, exists = srv.lookup(table.keys)
            assert exists.all()
            assert_values_equal(vals, table.columns)
        assert (tmp_path / "s" / "meta.msgpack").exists()

    def test_runs_on_the_card_unless_told(self, monkeypatch):
        import torch

        from repro_torch.launch import serve as launcher

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        monkeypatch.setitem(launcher.DATASETS, "tpch_orders", lambda: launcher.orders_like(n=50))
        with pytest.raises(RuntimeError, match="CUDA"):
            launcher.main(["--dataset", "tpch_orders", "--requests", "1"])
