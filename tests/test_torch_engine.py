"""The port's ``InferenceEngine`` against the reference's on the CPU: tier
choice at the budget boundary (``REPRO_VMEM_BUDGET`` at budget-1, budget
and budget+1, as ``tests/test_engine_tiers.py::TestVmemBoundaryTiers``),
streamed page plans and results, the plain ``jit_*`` tiers, task subsets
in non-canonical order, engine-level predicate tables, and the caches.

Both engines get the same numpy-drawn weights.  The reference runs its
Pallas tiers in interpret mode; the port's kernel tiers run the kernels'
plain versions on CPU tensors.  Codes may differ only on reference
near-tie rows; existence and match bits are equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.inference import InferenceEngine as JEngine
from repro.core.model import forward_digits as j_forward_digits
from repro.kernels import ops as jops
from repro_torch import obs
from repro_torch.core.inference import EngineCache, InferenceEngine
from repro_torch.kernels import ops
from torch_port_util import assert_codes_close, margins
from test_torch_kernels import lookup_setup

TILE = 64


def engines(setup, monkeypatch, budget=None, use_kernels=True):
    enc, jspec, spec, jp, p, bv = setup
    if budget is None:
        monkeypatch.delenv("REPRO_VMEM_BUDGET", raising=False)
    else:
        monkeypatch.setenv("REPRO_VMEM_BUDGET", str(int(budget)))
    je = JEngine(enc, jspec, jp, bv, use_pallas=use_kernels, tile_n=TILE)
    te = InferenceEngine(enc, spec, p, bv, use_kernels=use_kernels, tile_n=TILE, device="cpu")
    assert te.vmem_budget == je.vmem_budget
    return je, te


def fused_need(te) -> int:
    entry = te._entry(te.spec.tasks)
    return (ops.padded_weight_bytes(entry.spec) + ops.activation_bytes(entry.spec, TILE)
            + int(te.vexist.words.nbytes))


def digits_need(te) -> int:
    entry = te._entry(te.spec.tasks)
    return ops.padded_weight_bytes(entry.spec) + ops.activation_bytes(entry.spec, TILE)


def compare(setup, je, te, keys, tasks=None, want_exists=True, pred_tables=None):
    """Dispatch on both engines; same tier, same exists/match, codes
    equal up to near-ties.  Returns the tier."""
    enc, jspec, spec, jp, p, bv = setup
    jt = je.dispatch(keys, tasks=tasks, want_exists=want_exists, pred_tables=pred_tables)
    tt = te.dispatch(keys, tasks=tasks, want_exists=want_exists, pred_tables=pred_tables)
    assert tt.path == jt.path
    jc, jx = je.collect(jt)
    tc, tx = te.collect(tt)
    in_cap = (keys >= 0) & (keys < enc.capacity)
    lg = j_forward_digits(jp, jnp.asarray(enc.digits(np.where(in_cap, keys, 0))), jspec)
    order = list(tasks) if tasks is not None else list(spec.tasks)
    assert_codes_close(tc, jc, margins(lg, order))
    assert (tc[~in_cap] == 0).all()
    if jx is None:
        assert tx is None
    else:
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(tx, bv.test(keys))
    if jt.match is None:
        assert tt.match is None
    else:
        ok = (tc == jc).all(axis=1)
        np.testing.assert_array_equal(tt.match[ok], jt.match[ok])
    return tt.path


@pytest.fixture(scope="module")
def setup():
    return lookup_setup(tasks=2)


class TestBudgetBoundaryTiers:
    def test_budget_surfaces_in_stats(self, setup, monkeypatch):
        _, te = engines(setup, monkeypatch, budget=123456)
        assert te.vmem_budget == 123456 and te.stats.vmem_budget_bytes == 123456

    @pytest.mark.parametrize("delta,tier", [(1, "fused"), (0, "fused"), (-1, "pallas_digits")])
    def test_tier_flips_at_budget(self, setup, monkeypatch, delta, tier):
        _, probe = engines(setup, monkeypatch)
        je, te = engines(setup, monkeypatch, budget=fused_need(probe) + delta)
        keys = np.random.default_rng(0).integers(0, 10000, 300).astype(np.int64)
        assert compare(setup, je, te, keys) == tier
        assert (te.stats.fused_calls > 0) == (tier == "fused")
        assert te.kernel_filter_capable() == (tier == "fused")

    def test_streamed_tier_page_counts(self, setup, monkeypatch):
        _, probe = engines(setup, monkeypatch)
        je, te = engines(setup, monkeypatch, budget=digits_need(probe) - 1)
        entry, jentry = te._entry(te.spec.tasks), je._entry(je.spec.tasks)
        plan = te._streamed_plan(entry, True)
        assert plan is not None and plan == je._streamed_plan(jentry, True)
        for n in (1, 63, 64, 65, 200):
            keys = np.random.default_rng(n).integers(0, 10000, n).astype(np.int64)
            assert compare(setup, je, te, keys) == "fused_streamed"
        assert te.stats.fused_streamed_calls == 5 == je.stats.fused_streamed_calls
        keys = np.array([0, 1, 9999, 10000, 2**31 - 1, 2**31, 2**40, -1, -7], dtype=np.int64)
        assert compare(setup, je, te, keys) == "fused_streamed"

    def test_plain_tiers(self, setup, monkeypatch):
        je, te = engines(setup, monkeypatch, use_kernels=False)
        keys = np.random.default_rng(2).integers(-5, 10050, 130).astype(np.int64)
        assert compare(setup, je, te, keys) == "jit_keys"
        assert te.stats.jit_calls == 1 and not te.kernel_filter_capable()

    def test_jit_digits_beyond_int32(self, monkeypatch):
        big = lookup_setup(max_key=2**33, tasks=1)
        je, te = engines(big, monkeypatch, use_kernels=False)
        keys = np.array([0, 5, 2**31 + 3, 2**33, 2**34, -1], dtype=np.int64)
        assert compare(big, je, te, keys) == "jit_digits"


class TestDispatchVariants:
    @pytest.mark.parametrize("subset", [("t1", "t0"), ("t1",)])
    def test_task_subsets_non_canonical(self, setup, monkeypatch, subset):
        je, te = engines(setup, monkeypatch)
        keys = np.random.default_rng(3).integers(0, 10000, 200).astype(np.int64)
        assert compare(setup, je, te, keys, tasks=subset) == "fused"

    def test_codes_only_dispatch_takes_digits_tier(self, setup, monkeypatch):
        je, te = engines(setup, monkeypatch)
        keys = np.random.default_rng(4).integers(-3, 10040, 100).astype(np.int64)
        assert compare(setup, je, te, keys, want_exists=False) == "pallas_digits"

    def test_engine_predicate_tables(self, setup, monkeypatch):
        je, te = engines(setup, monkeypatch)
        keys = np.random.default_rng(5).integers(0, 10000, 150).astype(np.int64)
        tables = (("t0", np.array([True, False, True, True])),
                  ("t1", np.array([False, True, True, True, False, True])))
        assert compare(setup, je, te, keys, pred_tables=tables) == "fused"


class TestCaches:
    def test_exists_tracks_bitvector_mutations(self, monkeypatch):
        own = lookup_setup(seed=7)
        enc, jspec, spec, jp, p, bv = own
        je, te = engines(own, monkeypatch)
        keys = np.arange(0, 128, dtype=np.int64)
        compare(own, je, te, keys)
        bv.set(np.array([2, 4, 6]), True)
        bv.set(np.array([1, 3]), False)
        compare(own, je, te, keys)
        bv.set(np.array([50_000]), True)
        compare(own, je, te, np.array([49_999, 50_000, 50_001], dtype=np.int64))
        assert te.stats.word_uploads == 3

    def test_buckets_and_weight_cache(self, setup):
        enc, jspec, spec, jp, p, bv = setup
        eng = InferenceEngine(enc, spec, p, bv, use_kernels=False, tile_n=256, device="cpu")
        rng = np.random.default_rng(0)
        for n in rng.choice(np.arange(1, 16384), size=30, replace=False):
            eng.infer(rng.integers(0, 10000, size=int(n)).astype(np.int64))
        assert eng.stats.compiles <= 8
        k = InferenceEngine(enc, spec, p, bv, use_kernels=True, tile_n=TILE, device="cpu")
        for _ in range(4):
            k.collect(k.dispatch(np.arange(200, dtype=np.int64), want_exists=True))
        assert k.stats.weight_cache_misses == 1 and k.stats.dispatches == 4

    def test_stats_mirror_and_engine_cache(self, setup):
        enc, jspec, spec, jp, p, bv = setup
        prev = obs.set_registry(obs.MetricsRegistry())
        try:
            eng = InferenceEngine(enc, spec, p, bv, tile_n=TILE, device="cpu")
            eng.collect(eng.dispatch(np.arange(10, dtype=np.int64), want_exists=True))
            ev = obs.counter("deepmap_engine_events_total")
            assert ev.value(event="fused_calls") == 1 == eng.stats.fused_calls
            assert ev.value(event="dispatches") == 1
        finally:
            obs.set_registry(prev)

        class _Store:
            pass

        cache = EngineCache()
        s = _Store()
        s._engine = eng
        assert cache.adopt(s) is eng and eng.stats is cache.stats
        assert jops.vmem_budget_bytes() == ops.vmem_budget_bytes()
