"""The port's observability layer (``repro_torch.obs``) and plan cache
(``repro_torch.api.cache``) on the CPU, held against the reference's
``repro.obs`` and ``repro.api.cache``.

The cases of ``tests/test_obs.py`` (``TestMetricsRegistry``,
``TestTracer``, ``TestExporters``, ``TestPlanCacheThreadSafety`` and
``TestInvariants``).  Each makes the same calls on both packages, each
with a fresh registry and tracer of its own, asserts that file's
expectations on the port, and then holds the two packages' exports
against each other: the Prometheus text and the JSON snapshot equal,
and the Chrome-trace events equal except for timestamps and durations.
Where a case needs a store, both packages open the one the reference
built and saved (the port with ``device="cpu"``).  The stores' own
telemetry then differs where the engines do (the reference's jit tier,
the port's fused tier with K1's plain version) and where a value is a
time, so those cases compare what the executor and the plan cache
record: family names and kinds, morsel counters and span structure.
"""

import json
import threading
import types

import numpy as np
import pytest

import repro
import repro_torch
from conftest import make_periodic_table
from repro import obs as jobs
from repro.api.cache import PlanCache as JPlanCache
from repro.core import DeepMappingConfig as JConfig
from repro.core import DeepMappingStore as JStore
from repro.core.trainer import TrainConfig as JTrainConfig
from repro_torch import obs
from repro_torch.api.cache import PlanCache


def side(module, cache_cls):
    reg, trc = module.MetricsRegistry(), module.Tracer()
    return types.SimpleNamespace(obs=module, reg=reg, trc=trc, PlanCache=cache_cls,
                                 prev=(module.set_registry(reg), module.set_tracer(trc)))


@pytest.fixture()
def both():
    """``(reference side, port side)``: each an isolated registry and
    tracer installed as its package's defaults (restored on teardown)."""
    sides = side(jobs, JPlanCache), side(obs, PlanCache)
    yield sides
    for s in sides:
        s.obs.set_registry(s.prev[0])
        s.obs.set_tracer(s.prev[1])


def events(trace):
    """Chrome-trace events without their timestamps and durations."""
    return [{k: v for k, v in e.items() if k not in ("ts", "dur")}
            for e in trace["traceEvents"]]


def assert_exports_equal(both, trace=True):
    j, t = both
    assert obs.to_prometheus(t.reg) == jobs.to_prometheus(j.reg)
    assert obs.to_json_snapshot(t.reg) == jobs.to_json_snapshot(j.reg)
    if trace:
        assert events(obs.to_chrome_trace(t.trc)) == events(jobs.to_chrome_trace(j.trc))


def run(both, fn):
    """``fn(side)`` on the reference, then the port; the port's result,
    after the exports are held equal."""
    fn(both[0])
    out = fn(both[1])
    assert_exports_equal(both)
    return out


@pytest.fixture(scope="module")
def obs_stores(tmp_path_factory):
    """The reference test's store, built and saved by the reference,
    opened by both packages: ``(table, reference store, port store)``."""
    path = str(tmp_path_factory.mktemp("obs") / "s")
    table = make_periodic_table(n=2000)
    JStore.build(table, JConfig(shared=(64,), private=(16,),
                                train=JTrainConfig(epochs=15, batch_size=512))).save(path)
    return table, repro.open(path), repro_torch.open(path, device="cpu")


class TestMetricsRegistry:
    def test_counter_labels_and_values(self, both):
        def fn(s):
            c = s.reg.counter("x_total", "help text")
            c.inc(kind="a")
            c.inc(3, kind="b")
            c.inc(kind="a")
            return c

        c = run(both, fn)
        assert c.value(kind="a") == 2
        assert c.value(kind="b") == 3
        assert c.value(kind="never") == 0

    def test_counter_rejects_negative(self, both):
        for s in both:
            with pytest.raises(ValueError):
                s.reg.counter("x_total").inc(-1)
        assert_exports_equal(both)

    def test_gauge_set_inc_dec(self, both):
        def fn(s):
            g = s.reg.gauge("depth")
            g.set(5)
            g.inc(2)
            g.dec(3)
            return g.value()

        assert run(both, fn) == 4

    def test_histogram_quantiles_bracket_observations(self, both):
        def fn(s):
            h = s.reg.histogram("lat_seconds")
            for v in (0.001, 0.002, 0.004, 0.008, 0.1):
                h.observe(v)
            return h.quantile(0.5), h.quantile(0.99)

        p50, p99 = run(both, fn)
        # log-bucket interpolation: within a factor of 2 of the truth
        assert 0.001 < p50 < 0.008
        assert 0.05 < p99 <= 0.2
        assert p50 <= p99
        jh = both[0].reg.histogram("lat_seconds")
        assert (p50, p99) == (jh.quantile(0.5), jh.quantile(0.99))

    def test_get_or_create_returns_same_family(self, both):
        for s in both:
            assert s.reg.counter("a_total") is s.reg.counter("a_total")
        assert_exports_equal(both)

    def test_kind_mismatch_raises(self, both):
        for s in both:
            s.reg.counter("name")
            with pytest.raises(TypeError):
                s.reg.gauge("name")
        assert_exports_equal(both)

    def test_enabled_flag_is_a_no_op_switch(self, both):
        def fn(s):
            c = s.reg.counter("x_total")
            c.inc()
            s.reg.enabled = False
            c.inc()
            s.reg.histogram("h").observe(1.0)
            s.reg.enabled = True
            return c.value(), s.reg.histogram("h").value()

        assert run(both, fn) == (1, 0)

    def test_registry_injection(self, both):
        def fn(s):
            assert s.obs.registry() is s.reg
            s.obs.counter("via_module_total").inc()
            return s.reg.counter("via_module_total").value()

        assert run(both, fn) == 1

    def test_concurrent_increments_lose_nothing(self, both):
        n_threads, per_thread = 8, 500

        def fn(s):
            c = s.reg.counter("hammer_total")
            h = s.reg.histogram("hammer_seconds")

            def work():
                for _ in range(per_thread):
                    c.inc(shard=1)
                    h.observe(0.001)

            threads = [threading.Thread(target=work) for _ in range(n_threads)]
            [t.start() for t in threads]
            [t.join(timeout=60) for t in threads]
            assert not any(t.is_alive() for t in threads)
            return c.value(shard=1), h.state().count

        assert run(both, fn) == (n_threads * per_thread, n_threads * per_thread)


class TestTracer:
    def test_span_context_manager_records(self, both):
        def fn(s):
            with s.trc.span("work", track="host", morsel=3):
                pass
            return s.trc.spans("work")

        (sp,) = run(both, fn)
        assert sp.track == "host" and sp.args["morsel"] == 3
        assert sp.end >= sp.start

    def test_add_span_clamps_negative_duration(self, both):
        def fn(s):
            s.trc.add_span("x", 2.0, 1.0)
            return s.trc.spans("x")

        (sp,) = run(both, fn)
        assert sp.duration == 0.0

    def test_ring_buffer_bounds_memory(self):
        tracers = jobs.Tracer(capacity=16), obs.Tracer(capacity=16)
        for trc in tracers:
            for i in range(100):
                trc.add_span(f"s{i}", 0.0, 1.0)
        assert len(tracers[1]) == 16
        assert tracers[1].spans()[0].name == "s84"  # oldest survivors
        assert obs.to_chrome_trace(tracers[1]) == jobs.to_chrome_trace(tracers[0])

    def test_disabled_tracer_records_nothing(self, both):
        def fn(s):
            s.trc.enabled = False
            with s.trc.span("nope"):
                pass
            s.trc.add_span("nope", 0.0, 1.0)
            return len(s.trc)

        assert run(both, fn) == 0

    def test_span_recorded_even_when_body_raises(self, both):
        def fn(s):
            with pytest.raises(RuntimeError):
                with s.trc.span("boom"):
                    raise RuntimeError()
            return len(s.trc.spans("boom"))

        assert run(both, fn) == 1


class TestExporters:
    def test_prometheus_text_format(self, both):
        def fn(s):
            s.reg.counter("c_total", "counts things").inc(2, kind="a")
            s.reg.histogram("h_seconds").observe(0.003)
            return s.obs.to_prometheus(s.reg)

        text = run(both, fn)
        assert "# HELP c_total counts things" in text
        assert "# TYPE c_total counter" in text
        assert 'c_total{kind="a"} 2' in text
        assert "# TYPE h_seconds histogram" in text
        assert 'h_seconds_bucket{le="+Inf"} 1' in text
        assert "h_seconds_count 1" in text

    def test_json_snapshot_round_trips(self, both):
        def fn(s):
            s.reg.counter("c_total").inc(kind="a")
            s.reg.histogram("h_seconds").observe(0.01, stage="infer")
            return json.loads(s.obs.to_json_snapshot(s.reg))

        snap = run(both, fn)
        assert snap["c_total"]["values"] == [{"labels": {"kind": "a"}, "value": 1.0}]
        hist = snap["h_seconds"]["values"][0]
        assert hist["count"] == 1 and hist["p50"] > 0

    def test_chrome_trace_round_trips_and_names_tracks(self, both):
        def fn(s):
            s.trc.add_span("infer_dispatch", 1.0, 2.0, track="device", morsel=0)
            s.trc.add_span("collect", 1.5, 1.8, track="host", morsel=0)
            return json.loads(json.dumps(s.obs.to_chrome_trace(s.trc)))

        doc = run(both, fn)
        assert doc == json.loads(json.dumps(jobs.to_chrome_trace(both[0].trc)))
        evs = doc["traceEvents"]
        names = {e["args"]["name"] for e in evs if e["ph"] == "M"}
        assert {"device", "host"} <= names
        xs = [e for e in evs if e["ph"] == "X"]
        assert len(xs) == 2
        # device pinned to tid 0; timestamps rebased to 0 in µs
        dev = next(e for e in xs if e["cat"] == "device")
        assert dev["tid"] == 0 and dev["ts"] == 0.0 and dev["dur"] == 1e6

    def test_write_helpers_produce_loadable_files(self, both, tmp_path):
        files = []
        for name, s in zip(("ref", "port"), both):
            s.reg.counter("c_total").inc()
            s.trc.add_span("s", 0.0, 1.0)
            files.append((s.obs.write_prometheus(str(tmp_path / f"{name}.prom"), s.reg),
                          s.obs.write_json_snapshot(str(tmp_path / f"{name}.json"), s.reg),
                          s.obs.write_chrome_trace(str(tmp_path / f"{name}_t.json"), s.trc)))
        prom, snap, trace = files[1]
        assert "c_total 1" in open(prom).read()
        assert json.load(open(snap))["c_total"]["kind"] == "counter"
        assert json.load(open(trace))["traceEvents"]
        for ref, port in zip(*files):
            assert open(port).read() == open(ref).read()

    def test_write_helpers_create_missing_directories(self, both, tmp_path):
        """Regression: ``--telemetry-dir NEW_DIR`` crashed because the
        sinks assumed the directory already existed."""
        for name, s in zip(("ref", "port"), both):
            s.reg.counter("c_total").inc()
            out = tmp_path / name / "not" / "yet" / "there"
            assert s.obs.write_prometheus(str(out / "m.prom"), s.reg) == str(out / "m.prom")
            assert s.obs.write_chrome_trace(str(out / "t.json"), s.trc)
            assert (out / "m.prom").exists()
        assert (tmp_path / "port/not/yet/there/m.prom").read_text() == \
            (tmp_path / "ref/not/yet/there/m.prom").read_text()


def hammer(n_threads, target):
    threads = [threading.Thread(target=target) for _ in range(n_threads)]
    [t.start() for t in threads]
    [t.join(timeout=60) for t in threads]
    assert not any(t.is_alive() for t in threads)


class TestPlanCacheThreadSafety:
    def test_hammered_hit_count_is_exact(self, both):
        """Regression: hits/misses were unlocked ``+=`` while sharded
        collect runs on fan-out pool threads."""
        n_threads, per_thread = 8, 400

        def fn(s):
            cache = s.PlanCache()
            fp = ("scan", None, (), True)
            cache.put(fp, 0, np.arange(64, dtype=np.int64), None)

            def work():
                for _ in range(per_thread):
                    assert cache.get(fp, 0) is not None

            hammer(n_threads, work)
            return cache.hits, cache.misses

        assert run(both, fn) == (n_threads * per_thread, 0)

    def test_bypass_counted_and_exact_under_threads(self, both):
        n_threads, per_thread = 4, 250

        def fn(s):
            cache = s.PlanCache()

            def work():
                for _ in range(per_thread):
                    cache.get(None, 0)

            hammer(n_threads, work)
            return cache.bypass

        assert run(both, fn) == n_threads * per_thread

    def test_concurrent_put_get_evict_is_crash_free(self):
        for cls in (JPlanCache, PlanCache):
            cache = cls(plan_entries=4)
            stop = threading.Event()
            errors = []

            def reader():
                try:
                    while not stop.is_set():
                        for i in range(8):
                            cache.get(("range", i, i + 1, None, (), True), 0)
                except Exception as e:  # noqa: BLE001
                    errors.append(e)

            def writer():
                try:
                    for i in range(400):
                        cache.put(("range", i % 8, i % 8 + 1, None, (), True), 0,
                                  np.arange(32, dtype=np.int64), None)
                except Exception as e:  # noqa: BLE001
                    errors.append(e)

            readers = [threading.Thread(target=reader) for _ in range(3)]
            writers = [threading.Thread(target=writer) for _ in range(2)]
            [t.start() for t in readers + writers]
            [t.join(timeout=60) for t in writers]
            stop.set()
            [t.join(timeout=60) for t in readers]
            assert not errors and not any(t.is_alive() for t in readers + writers)
            assert len(cache) <= 4

    def test_cache_events_mirrored_to_registry(self, both):
        def fn(s):
            cache = s.PlanCache()
            fp = ("scan", None, (), True)
            cache.get(fp, 0)            # miss
            cache.put(fp, 0, None, None)
            cache.get(fp, 0)            # hit
            cache.get(None, 0)          # bypass
            return s.reg.counter("deepmap_plan_cache_events_total")

        ev = run(both, fn)
        assert ev.value(outcome="miss") == 1
        assert ev.value(outcome="hit") == 1
        assert ev.value(outcome="bypass") == 1


def families(reg):
    """Family name -> kind, for the families both engines record."""
    return {m.name: m.kind for m in reg.collect() if not m.name.startswith("deepmap_engine_")}


def counter_values(snap):
    out = {}
    for name, fam in snap.items():
        if fam["kind"] != "counter":
            continue
        for v in fam["values"]:
            out[(name, tuple(sorted(v["labels"].items())))] = v["value"]
    return out


def span_shape(trc):
    """Each span's name, track and args other than times and sizes that
    adaptive morsels choose from timings."""
    return [(s.name, s.track, {k: v for k, v in s.args.items() if not k.endswith("_s")})
            for s in trc.spans()]


class TestInvariants:
    """Cross-layer invariants the telemetry must preserve."""

    def test_operator_rows_sum_to_plan_total(self, obs_stores):
        for store in obs_stores[1:]:
            s = store.query().scan().execute().explain
            op_sum = sum(o.seconds for o in s.operators)
            assert op_sum > 0
            assert op_sum <= s.total_s * 1.5
            assert op_sum >= s.total_s * 0.2
        names = [[o.name for o in st.query().scan().execute().explain.operators]
                 for st in obs_stores[1:]]
        assert names[1] == names[0]

    def test_registry_snapshots_monotone_across_repeated_plans(self, both, obs_stores):
        snaps = []
        for s, store in zip(both, obs_stores[1:]):
            store.query().scan().execute()
            first = counter_values(s.obs.snapshot())
            store.query().scan().execute()
            second = counter_values(s.obs.snapshot())
            assert first  # the executor actually recorded something
            for key, val in first.items():
                assert second.get(key, 0) >= val
            morsel_key = ("deepmap_executor_morsels_total", (("kind", "scan"),))
            assert second[morsel_key] > first[morsel_key]
            snaps.append(second)
        key = ("deepmap_plan_cache_events_total", (("outcome", "hit"),))
        assert snaps[1][key] == snaps[0][key]
        assert families(both[1].reg) == families(both[0].reg)

    def test_engine_and_morsel_metrics_recorded(self, both, obs_stores):
        table = obs_stores[0]
        for s, store in zip(both, obs_stores[1:]):
            store.query().where_keys(table.keys[:256]).execute()
            assert s.reg.counter("deepmap_executor_morsels_total").value(kind="point") > 0
            assert s.reg.counter("deepmap_engine_events_total").value(event="dispatches") > 0
            assert s.reg.counter("deepmap_plan_cache_events_total").items()
        j, t = (s.reg.counter("deepmap_plan_cache_events_total").items() for s in both)
        assert t == j
        assert families(both[1].reg) == families(both[0].reg)

    def test_dispatch_spans_overlap_collect_spans(self, both, obs_stores):
        """On the hybrid store, the device window (dispatch ->
        collect-start) of morsel i+1 brackets the host collect span of
        morsel i; the trace must show it, in both packages alike."""
        for s, store in zip(both, obs_stores[1:]):
            store.query().morsel(256).scan().execute()
            dispatch = {sp.args["morsel"]: sp
                        for sp in s.trc.spans("infer_dispatch", track="device")}
            collect = {sp.args["morsel"]: sp for sp in s.trc.spans("collect", track="host")}
            assert len(dispatch) >= 4  # multiple morsels actually streamed
            overlaps = 0
            for i, c in collect.items():
                d_next = dispatch.get(i + 1)
                if d_next is not None and d_next.start < c.start and d_next.end >= c.end:
                    overlaps += 1
            assert overlaps >= len(collect) - 1 - 1  # all but the final morsel
        assert span_shape(both[1].trc) == span_shape(both[0].trc)

    def test_chrome_trace_of_real_plan_is_perfetto_shaped(self, both, obs_stores):
        docs = []
        for s, store in zip(both, obs_stores[1:]):
            store.query().morsel(256).scan().execute()
            doc = json.loads(json.dumps(s.obs.to_chrome_trace()))
            xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
            assert {"device", "host", "plans"} <= {e["cat"] for e in xs}
            for e in xs:
                assert e["ts"] >= 0 and e["dur"] >= 0
                assert isinstance(e["pid"], int) and isinstance(e["tid"], int)
            docs.append([(e["name"], e.get("cat"), e["ph"], e["pid"], e["tid"])
                         for e in doc["traceEvents"]])
        assert docs[1] == docs[0]

    def test_set_enabled_kills_all_recording(self, both, obs_stores):
        table = obs_stores[0]
        for s, store in zip(both, obs_stores[1:]):
            s.obs.set_enabled(False)
            try:
                store.query().where_keys(table.keys[:64]).execute()
            finally:
                s.obs.set_enabled(True)
            assert len(s.trc) == 0
            assert s.reg.counter("deepmap_executor_morsels_total").value(kind="point") == 0
        # The engines' family is registered empty, under each engine's help text.
        prom = [[ln for ln in s.obs.to_prometheus(s.reg).splitlines()
                 if "deepmap_engine_" not in ln] for s in both]
        assert prom[1] == prom[0]
        assert families(both[1].reg) == families(both[0].reg)
