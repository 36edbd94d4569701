"""The port's retry, health and failure handling on the CPU, held against
the reference's ``repro.fault``, ``repro.cluster`` and
``repro.api.FederatedStore``.

* ``call_guarded`` and ``HealthTracker`` run the same scripted failures
  in both packages and give the same outcomes, retries and snapshots.
* The cases of ``TestDegradedCluster``, ``TestReplicateFailover`` and
  ``TestPoolLifecycle`` of ``tests/test_fault.py``: a cluster built and
  saved by the reference and opened by the port, and federations of
  ``HashStore`` replicas built by both packages, each run under the
  same fault plan in its own package's harness — the same ``fired``
  counts, the same owner errors and the same (partial) answers.
* ``TestShardQuarantine`` of ``tests/test_integrity.py``: the same
  flipped artifact leads to the same quarantined shard ids, the same
  refusals and the same healthy-shard answers.

Each package's stores consult only their own package's fault harness
and metrics registry, so every scenario activates one plan per package.
"""

import os
import shutil
import time

import numpy as np
import pytest

import repro
import repro_torch
from conftest import make_periodic_table
from repro import obs as jobs
from repro import fault as jfault
from repro.api import FederatedStore as JFederated
from repro.api.routing import LazyFanoutPool as JLazyPool
from repro.baselines import HashStore as JHashStore
from repro.cluster import load_sharded_store as j_load_sharded
from repro_torch import fault, obs
from repro_torch.api import FederatedStore
from repro_torch.api.routing import LazyFanoutPool
from repro_torch.baselines import HashStore
from repro_torch.cluster import load_sharded_store, save_sharded_store
from repro_torch.core import Table
from repro_torch.fault import (
    FaultPlan,
    FaultSpec,
    HealthPolicy,
    HealthTracker,
    IntegrityError,
    OwnerFailure,
    RetryPolicy,
    call_guarded,
)
from torch_port_util import assert_values_equal, cluster_pair

#: No backoff sleeps, two attempts — fault tests stay fast and exact.
TIGHT = RetryPolicy(max_attempts=2, backoff_s=0.0, max_backoff_s=0.0)
J_TIGHT = jfault.RetryPolicy(max_attempts=2, backoff_s=0.0, max_backoff_s=0.0)


def counter_value(reg, name, **labels):
    metric = reg.get(name)
    return 0.0 if metric is None else metric.value(**labels)


def both_plans(**spec):
    """The same one-spec fault plan in each package's harness:
    ``(port plan, reference plan)``."""
    return FaultPlan([FaultSpec(**spec)]), jfault.FaultPlan([jfault.FaultSpec(**spec)])


def errors_of(errs):
    """Owner errors as comparable tuples."""
    return [(e.owner, e.site, e.attempts, e.error_type, e.message, e.deadline_exceeded)
            for e in errs]


def port_table(table):
    return Table(keys=table.keys.copy(),
                 columns={c: v.copy() for c, v in table.columns.items()})


# ------------------------------------------------------------------ retry
def scripted(fails, value="ok", exc=RuntimeError, sleep=0.0):
    """``fn(attempt)`` that raises ``exc`` on its first ``fails`` tries."""
    def fn(attempt):
        if sleep:
            time.sleep(sleep)
        if attempt < fails:
            raise exc(f"try {attempt}")
        return value
    return fn


class TestCallGuarded:
    @pytest.mark.parametrize("fails,attempts", ((0, 3), (1, 3), (2, 3), (3, 3), (5, 1), (1, 2)))
    def test_same_outcome_as_reference(self, fails, attempts):
        kw = dict(max_attempts=attempts, backoff_s=0.0, max_backoff_s=0.0)
        site = "shard_collect"
        before = (counter_value(obs.registry(), "deepmap_fault_retries_total", site=site),
                  counter_value(obs.registry(), "deepmap_fault_owner_errors_total",
                                site=site, cause="error"))
        got = call_guarded(scripted(fails, exc=KeyError), owner="shard:2", site=site,
                           policy=RetryPolicy(**kw))
        want = jfault.call_guarded(scripted(fails, exc=KeyError), owner="shard:2", site=site,
                                   policy=jfault.RetryPolicy(**kw))
        assert (got.ok, got.value, got.retries) == (want.ok, want.value, want.retries)
        assert errors_of([got.error] if got.error else []) == \
            errors_of([want.error] if want.error else [])
        after = (counter_value(obs.registry(), "deepmap_fault_retries_total", site=site),
                 counter_value(obs.registry(), "deepmap_fault_owner_errors_total",
                               site=site, cause="error"))
        assert after[0] - before[0] == min(fails, attempts - 1)
        assert after[1] - before[1] == (0 if got.ok else 1)
        if not got.ok:
            assert got.error.describe() == want.error.describe()
            assert "shard:2@shard_collect" in got.error.describe()

    def test_slow_owner_blows_deadline(self):
        got = call_guarded(scripted(0, sleep=0.02), owner="o", site="member_collect",
                           policy=RetryPolicy(max_attempts=1, deadline_s=0.005))
        want = jfault.call_guarded(scripted(0, sleep=0.02), owner="o", site="member_collect",
                                   policy=jfault.RetryPolicy(max_attempts=1, deadline_s=0.005))
        assert not got.ok and got.error.deadline_exceeded
        assert errors_of([got.error]) == errors_of([want.error])

    def test_backoff_and_policy_validation(self):
        p = RetryPolicy(backoff_s=0.01, backoff_multiplier=2.0, max_backoff_s=0.03)
        j = jfault.RetryPolicy(backoff_s=0.01, backoff_multiplier=2.0, max_backoff_s=0.03)
        assert [p.backoff(i) for i in range(10)] == [j.backoff(i) for i in range(10)]
        assert fault.DEFAULT_POLICY == RetryPolicy() and fault.FAIL_FAST.max_attempts == 1
        for bad in (dict(max_attempts=0), dict(deadline_s=0.0), dict(backoff_s=-1.0),
                    dict(backoff_multiplier=0.5)):
            with pytest.raises(ValueError):
                RetryPolicy(**bad)
            with pytest.raises(ValueError):
                jfault.RetryPolicy(**bad)


# ----------------------------------------------------------------- health
#: One script of health events: (op, owner, latency or preferred index).
HEALTH_SCRIPT = (
    ("fail", "member:0", None), ("pick", None, 0), ("fail", "member:0", None),
    ("pick", None, 0), ("pick", None, 0), ("pick", None, 0), ("ok", "member:1", 0.2),
    ("ok", "member:1", 0.1), ("fail", "member:2", None), ("fail", "member:2", None),
    ("pick", None, 2), ("pick", None, 1), ("pick", None, 0), ("ok", "member:0", 0.05),
    ("fail", "member:1", None), ("ok", "member:1", 0.3), ("pick", None, 2),
)


class TestHealthTracker:
    @pytest.mark.parametrize("threshold,probe", ((1, 3), (2, 4), (2, 100)))
    def test_same_script_same_answers_and_snapshot(self, threshold, probe):
        owners = ("member:0", "member:1", "member:2")
        out = []
        for tracker in (HealthTracker(HealthPolicy(fail_threshold=threshold, probe_every=probe,
                                                   ewma_alpha=0.5)),
                        jfault.HealthTracker(jfault.HealthPolicy(
                            fail_threshold=threshold, probe_every=probe, ewma_alpha=0.5))):
            seen = []
            for op, owner, arg in HEALTH_SCRIPT:
                if op == "fail":
                    seen.append(tracker.record_failure(owner))
                elif op == "ok":
                    seen.append(tracker.record_success(owner, arg))
                else:
                    seen.append(tracker.pick(owners, arg))
            seen.append(tracker.healthy(owners))
            seen.append([tracker.is_quarantined(o) for o in owners])
            seen.append([tracker.latency(o) for o in owners + ("nobody",)])
            out.append((seen, tracker.snapshot()))
        assert out[0] == out[1]

    def test_cases_of_the_reference_suite(self):
        t = HealthTracker(HealthPolicy(fail_threshold=2))
        assert t.record_failure("m") is False and t.record_failure("m") is True
        assert t.record_failure("m") is False and t.is_quarantined("m")
        assert t.record_success("m", 0.001) is True and not t.is_quarantined("m")
        t = HealthTracker(HealthPolicy(fail_threshold=1, probe_every=3))
        t.record_failure("member:0")
        assert [t.pick(("member:0", "member:1"), 0) for _ in range(3)] == [1, 1, 0]
        t = HealthTracker(HealthPolicy(fail_threshold=1, probe_every=100))
        t.record_failure("a")
        t.record_failure("b")
        assert t.pick(("a", "b"), 1) == 1
        with pytest.raises(ValueError):
            t.pick((), 0)
        for bad in (dict(fail_threshold=0), dict(probe_every=0), dict(ewma_alpha=0.0)):
            with pytest.raises(ValueError):
                HealthPolicy(**bad)


# ------------------------------------------------- degraded cluster path
@pytest.fixture(scope="module")
def fault_cluster(tmp_path_factory):
    """A 3-shard range cluster of the reference, saved, and the port's
    copy opened from the save; both retry once without backoff."""
    table = make_periodic_table(n=1200)
    jcluster, cluster = cluster_pair(table, tmp_path_factory.mktemp("fault") / "cluster")
    jcluster.retry, cluster.retry = J_TIGHT, TIGHT
    return table, jcluster, cluster


def run_both(pair, build_q, **spec):
    """``build_q(store.query()).execute()`` in each package under its own
    copy of one fault plan -> ``((port result or exception, plan),
    (reference result or exception, plan))``."""
    plans = both_plans(**spec)
    out = []
    for store, plan in zip(pair, plans):
        with plan.activate():
            try:
                res = build_q(store.query()).execute()
            except Exception as exc:  # noqa: BLE001 — compared across packages
                res = exc
        out.append((res, plan))
    return out


class TestDegradedCluster:
    def test_raise_mode_surfaces_owner_failure(self, fault_cluster):
        table, jcluster, cluster = fault_cluster
        (got, plan), (want, jplan) = run_both(
            (cluster, jcluster), lambda q: q.where_keys(table.keys),
            site="shard_collect", owner="shard:1", kind="raise")
        assert isinstance(got, OwnerFailure) and isinstance(want, jfault.OwnerFailure)
        assert "shard:1@shard_collect" in str(got) and str(got) == str(want)
        assert errors_of(got.owners) == errors_of(want.owners)
        assert got.owners[0].attempts == 2  # retried once
        assert plan.fired == jplan.fired == 2

    def test_partial_mode_serves_healthy_shards_byte_identical(self, fault_cluster):
        table, jcluster, cluster = fault_cluster
        q = table.keys
        ref_values, ref_exists = cluster.lookup(q)  # fault-free
        healthy = cluster.partitioner.shard_of(q) != 1
        (got, plan), (want, jplan) = run_both(
            (cluster, jcluster), lambda s: s.where_keys(q).on_error("partial"),
            site="shard_collect", owner="shard:1", kind="raise")
        np.testing.assert_array_equal(got.exists, want.exists)
        assert_values_equal(got.values, want.values)
        np.testing.assert_array_equal(got.exists[healthy], ref_exists[healthy])
        for col in ref_values:
            np.testing.assert_array_equal(got.values[col][healthy], ref_values[col][healthy])
        assert not got.exists[~healthy].any()
        assert got.explain.keys_unresolved == want.explain.keys_unresolved == int((~healthy).sum())
        assert got.explain.owners_failed == want.explain.owners_failed
        assert len(got.explain.owners_failed) == 1
        assert any(s.startswith("degraded[") for s in got.explain.plan)
        assert plan.fired == jplan.fired

    def test_transient_fault_retried_to_full_result(self, fault_cluster):
        table, jcluster, cluster = fault_cluster
        ref_values, ref_exists = jcluster.lookup(table.keys)
        before = counter_value(obs.registry(), "deepmap_fault_retries_total",
                               site="shard_collect")
        (got, plan), (want, jplan) = run_both(
            (cluster, jcluster), lambda s: s.where_keys(table.keys).on_error("partial"),
            site="shard_collect", owner="shard:1", kind="raise", times=1)
        np.testing.assert_array_equal(got.exists, ref_exists)
        assert_values_equal(got.values, ref_values)
        assert got.explain.owners_failed == want.explain.owners_failed == ()
        assert got.explain.retries == want.explain.retries >= 1
        assert plan.fired == jplan.fired == 1
        assert counter_value(obs.registry(), "deepmap_fault_retries_total",
                             site="shard_collect") - before == got.explain.retries

    def test_injected_counter_matches_plan(self, fault_cluster):
        table, jcluster, cluster = fault_cluster
        labels = dict(site="shard_collect", kind="raise")
        before = (counter_value(obs.registry(), "deepmap_fault_injected_total", **labels),
                  counter_value(jobs.registry(), "deepmap_fault_injected_total", **labels))
        (_, plan), (_, jplan) = run_both(
            (cluster, jcluster), lambda s: s.where_keys(table.keys[:64]).on_error("partial"),
            site="shard_collect", owner="shard:0", kind="raise")
        after = (counter_value(obs.registry(), "deepmap_fault_injected_total", **labels),
                 counter_value(jobs.registry(), "deepmap_fault_injected_total", **labels))
        assert after[0] - before[0] == plan.fired == jplan.fired == after[1] - before[1] > 0

    def test_fault_free_plans_retry_nothing(self, fault_cluster):
        table, _, cluster = fault_cluster
        res = cluster.query().where_keys(table.keys).execute()
        assert res.explain.retries == 0 and res.explain.owners_failed == ()
        assert res.exists.all()

    def test_on_error_validation(self, fault_cluster):
        _, _, cluster = fault_cluster
        with pytest.raises(ValueError, match="on_error"):
            cluster.query().where_keys([1]).on_error("ignore").plan()


# -------------------------------------------------- replicate federation
def federations(table, mutation_policy="reject"):
    """The same 3-replica ``HashStore`` federation in both packages:
    ``(port federation, reference federation)``."""
    ptable = port_table(table)
    fed = FederatedStore(
        [HashStore.build(ptable, codec="none", partition_bytes=2048) for _ in range(3)],
        mode="replicate", retry=TIGHT, health=HealthPolicy(fail_threshold=2, probe_every=4),
        mutation_policy=mutation_policy)
    jfed = JFederated(
        [JHashStore.build(table, codec="none", partition_bytes=2048) for _ in range(3)],
        mode="replicate", retry=J_TIGHT,
        health=jfault.HealthPolicy(fail_threshold=2, probe_every=4),
        mutation_policy=mutation_policy)
    return fed, jfed


def kill_member_zero():
    return both_plans(site="member_collect", owner="member:0", kind="raise")


def quarantine_member_zero(feds, table):
    for fed, plan in zip(feds, kill_member_zero()):
        with plan.activate():
            for batch in np.array_split(table.keys, 4):
                fed.lookup(batch)
        assert fed.health.is_quarantined("member:0")


class TestReplicateFailover:
    def test_every_lookup_serves_through_failover(self):
        table = make_periodic_table(n=600)
        feds = federations(table)
        ref_values, ref_exists = feds[1].members[1].lookup(table.keys)
        before = counter_value(obs.registry(), "deepmap_fault_failovers_total", member=1)
        fired = []
        for fed, plan in zip(feds, kill_member_zero()):
            with plan.activate():
                for batch in np.array_split(table.keys, 6):
                    values, exists = fed.lookup(batch)
                    sel = np.isin(table.keys, batch)
                    np.testing.assert_array_equal(exists, ref_exists[sel])
                    assert_values_equal(values, {c: v[sel] for c, v in ref_values.items()})
            fired.append(plan.fired)
            assert fed.health.is_quarantined("member:0")
            assert not fed.health.is_quarantined("member:1")
        assert fired[0] == fired[1] >= 2
        assert feds[0].health.snapshot().keys() == feds[1].health.snapshot().keys()
        assert counter_value(obs.registry(), "deepmap_fault_failovers_total", member=1) \
            - before >= 1

    def test_probe_recovers_member_after_fault_clears(self):
        table = make_periodic_table(n=400)
        feds = federations(table)
        quarantine_member_zero(feds, table)
        recovered = []
        for fed in feds:
            for i in range(fed.health.policy.probe_every + 1):
                fed.lookup(table.keys[:16])
                if not fed.health.is_quarantined("member:0"):
                    break
            recovered.append(i)
        assert recovered[0] == recovered[1]
        assert not any(fed.health.is_quarantined("member:0") for fed in feds)

    def test_all_replicas_down_raises_owner_failure(self):
        table = make_periodic_table(n=200)
        got = []
        for fed, plan in zip(federations(table), both_plans(site="member_collect",
                                                             kind="raise")):
            with plan.activate():
                with pytest.raises(Exception) as exc_info:
                    fed.lookup(table.keys[:16])
            got.append((type(exc_info.value).__name__, errors_of(exc_info.value.owners),
                        plan.fired))
        assert got[0] == got[1]
        assert got[0][0] == "OwnerFailure" and len(got[0][1]) == 3

    def test_mutation_reject_while_quarantined(self):
        table = make_periodic_table(n=400)
        feds = federations(table, mutation_policy="reject")
        quarantine_member_zero(feds, table)
        before = counter_value(obs.registry(), "deepmap_fault_mutations_rejected_total",
                               op="insert")
        new_key = np.array([10**7], dtype=np.int64)
        cols = {c: np.zeros(1, dtype=v.dtype) for c, v in table.columns.items()}
        messages = []
        for fed in feds:
            with pytest.raises(RuntimeError, match="member:0") as exc_info:
                fed.insert(new_key, cols)
            messages.append(str(exc_info.value))
            for m in fed.members:
                assert not m.lookup(new_key)[1].any()
        assert messages[0] == messages[1]
        assert counter_value(obs.registry(), "deepmap_fault_mutations_rejected_total",
                             op="insert") - before == 1

    def test_mutation_queue_flushes_after_recovery(self):
        table = make_periodic_table(n=400)
        feds = federations(table, mutation_policy="queue")
        quarantine_member_zero(feds, table)
        new_key = np.array([10**7], dtype=np.int64)
        cols = {c: np.zeros(1, dtype=v.dtype) for c, v in table.columns.items()}
        for fed in feds:
            fed.insert(new_key, cols)  # queued, not applied
            assert not fed.lookup(new_key)[1].any()
            assert fed.flush_mutations() == 0  # still quarantined
            for _ in range(fed.health.policy.probe_every + 1):
                fed.lookup(table.keys[:8])
                if not fed.health.is_quarantined("member:0"):
                    break
            assert fed.flush_mutations() == 1
            for m in fed.members:
                assert m.lookup(new_key)[1].all()


# ------------------------------------------------------- pool lifecycle
class TestPoolLifecycle:
    @pytest.mark.parametrize("cls", (LazyFanoutPool, JLazyPool))
    def test_close_is_idempotent_and_reentrant(self, cls):
        pool = cls(2, "test-pool")
        assert pool.map(lambda x: x * 2, [1, 2, 3], owners=3) == [2, 4, 6]
        pool.close()
        pool.close()
        assert pool.map(lambda x: x + 1, [1], owners=1) == [2]
        pool.close()
        with cls(2, "test-pool") as pool:
            assert pool.map(lambda x: x, [7], owners=1) == [7]
        assert pool._pool is None

    def test_cluster_close_shuts_fanout_down(self, fault_cluster):
        table, _, cluster = fault_cluster
        cluster.query().where_keys(table.keys[:32]).execute()  # fan-out spins the pool up
        cluster.close()
        assert cluster._fanout._pool is None
        _, exists = cluster.lookup(table.keys[:32])
        assert exists.all()
        with cluster as same:
            assert same is cluster
        assert cluster._fanout._pool is None

    def test_federation_context_manager(self):
        table = make_periodic_table(n=200)
        fed, _ = federations(table)
        with fed as same:
            same.lookup(table.keys[:16])
        assert fed._fanout._pool is None


# ------------------------------------------------------ shard quarantine
@pytest.fixture(scope="module")
def saved_cluster(tmp_path_factory):
    table = make_periodic_table(n=800)
    path = tmp_path_factory.mktemp("quarantine") / "cluster"
    jcluster, _ = cluster_pair(table, path, num_shards=2)
    return table, jcluster, str(path)


def corrupted_copy(path, tmp_path, shards=(1,), artifact="aux.msgpack"):
    dst = str(tmp_path / os.path.basename(path))
    shutil.copytree(path, dst)
    for shard in shards:
        f = os.path.join(dst, f"shard_{shard:05d}", artifact)
        data = bytearray(open(f, "rb").read())
        data[len(data) // 2] ^= 0x01
        open(f, "wb").write(bytes(data))
    return dst


class TestShardQuarantine:
    def test_raise_mode_propagates(self, saved_cluster, tmp_path):
        _, _, path = saved_cluster
        dst = corrupted_copy(path, tmp_path)
        with pytest.raises(IntegrityError, match="aux.msgpack") as got:
            load_sharded_store(dst, device="cpu")
        with pytest.raises(jfault.IntegrityError) as want:
            j_load_sharded(dst)
        assert str(got.value) == str(want.value)
        with pytest.raises(IntegrityError, match="aux.msgpack"):
            repro_torch.open(dst, device="cpu")

    def test_invalid_on_corrupt_rejected(self, saved_cluster):
        _, _, path = saved_cluster
        with pytest.raises(ValueError, match="on_corrupt"):
            load_sharded_store(path, on_corrupt="bogus", device="cpu")

    @pytest.fixture()
    def quarantined(self, saved_cluster, tmp_path):
        table, jcluster, path = saved_cluster
        dst = corrupted_copy(path, tmp_path)
        before = counter_value(obs.registry(), "deepmap_fault_quarantines_total",
                               owner="shard:1")
        with pytest.warns(RuntimeWarning, match="quarantining shard 1"):
            loaded = repro_torch.open(dst, device="cpu", on_corrupt="quarantine")
        assert counter_value(obs.registry(), "deepmap_fault_quarantines_total",
                             owner="shard:1") - before == 1
        with pytest.warns(RuntimeWarning, match="quarantining shard 1"):
            jloaded = repro.open(dst, on_corrupt="quarantine")
        return table, jcluster, loaded, jloaded

    def test_healthy_shards_serve_byte_identical(self, quarantined):
        table, jcluster, loaded, jloaded = quarantined
        assert loaded.quarantined_shards() == jloaded.quarantined_shards() == [1]
        ref_values, ref_exists = jcluster.lookup(table.keys)
        healthy = loaded.partitioner.shard_of(table.keys) != 1
        got = loaded.query().where_keys(table.keys).on_error("partial").execute()
        want = jloaded.query().where_keys(table.keys).on_error("partial").execute()
        np.testing.assert_array_equal(got.exists, want.exists)
        assert_values_equal(got.values, want.values)
        np.testing.assert_array_equal(got.exists[healthy], ref_exists[healthy])
        for col in ref_values:
            np.testing.assert_array_equal(got.values[col][healthy], ref_values[col][healthy])
        assert not got.exists[~healthy].any()
        assert got.explain.keys_unresolved == int((~healthy).sum())
        assert got.explain.owners_failed == want.explain.owners_failed
        assert len(got.explain.owners_failed) == 1

    def test_point_lookup_raise_mode_refuses(self, quarantined):
        table, _, loaded, jloaded = quarantined
        with pytest.raises(OwnerFailure, match="shard:1") as got:
            loaded.query().where_keys(table.keys).execute()
        with pytest.raises(jfault.OwnerFailure) as want:
            jloaded.query().where_keys(table.keys).execute()
        assert errors_of(got.value.owners) == errors_of(want.value.owners)

    def test_scans_and_ranges_refuse_loudly(self, quarantined):
        table, _, loaded, jloaded = quarantined
        lo, hi = int(table.keys[0]), int(table.keys[-1])
        for build_q in (lambda q: q.scan(), lambda q: q.where_range(lo, hi)):
            with pytest.raises(IntegrityError, match="quarantined") as got:
                build_q(loaded.query()).execute()
            with pytest.raises(jfault.IntegrityError) as want:
                build_q(jloaded.query()).execute()
            assert str(got.value) == str(want.value)

    def test_mutations_refuse(self, quarantined):
        table, _, loaded, _ = quarantined
        # The last key routes to the quarantined range shard.
        with pytest.raises(IntegrityError):
            loaded.delete(table.keys[-1:])
        with pytest.raises(IntegrityError):
            loaded.update(table.keys[-1:], {c: v[-1:] for c, v in table.columns.items()})

    def test_resave_refuses_data_laundering(self, quarantined, tmp_path):
        _, _, loaded, _ = quarantined
        with pytest.raises(IntegrityError, match="refusing to save"):
            save_sharded_store(loaded, str(tmp_path / "resaved"))

    def test_row_accounting_survives_quarantine(self, quarantined):
        table, jcluster, loaded, jloaded = quarantined
        assert loaded.num_rows == jloaded.num_rows == jcluster.num_rows == table.keys.size
        assert loaded.columns == jloaded.columns
        assert loaded.size_breakdown() == jloaded.size_breakdown()

    def test_all_shards_corrupt_still_raises(self, saved_cluster, tmp_path):
        _, _, path = saved_cluster
        dst = corrupted_copy(path, tmp_path, shards=(0, 1))
        with pytest.warns(RuntimeWarning):
            with pytest.raises(IntegrityError, match="every shard"):
                load_sharded_store(dst, on_corrupt="quarantine", device="cpu")
