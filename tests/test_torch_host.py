"""The port's host half against the reference: the copied modules
(bitvector, aux table, table, codecs, pool, encoding, TPC-H data,
metrics, explain stats) and the kernels' host helpers (padding, page
planning, activation bytes, the tier budget, word packing).  Everything
here is numpy or shape arithmetic, so the two packages must agree
exactly."""

import jax
import numpy as np
import pytest
import torch

import repro.kernels.ops as jops
from repro.api.plan import ExplainStats as JExplainStats
from repro.core.aux_table import AuxTable as JAuxTable
from repro.core.bitvector import BitVector as JBitVector
from repro.core.encoding import KeyEncoder as JKeyEncoder
from repro.core.encoding import ValueCodec as JValueCodec
from repro.core.encoding import detect_residues as j_detect_residues
from repro.core.model import MLPSpec as JSpec
from repro.core.model import init_params as j_init_params
from repro.core.table import pack_composite_key as j_pack
from repro.data.tpch import lineitem_like as j_lineitem_like
from repro.data.tpch import orders_like as j_orders_like
from repro.kernels.bitvector import pack_words32 as j_pack_words32
from repro_torch import obs
from repro_torch.api.plan import ExplainStats
from repro_torch.core.aux_table import AuxTable
from repro_torch.core.bitvector import BitVector
from repro_torch.core.convert import params_from_numpy
from repro_torch.core.encoding import KeyEncoder, ValueCodec, detect_residues, onehot_digits
from repro_torch.core.inference import EngineStats
from repro_torch.core.model import MLPSpec
from repro_torch.core.table import Table, pack_composite_key
from repro_torch.data.tpch import lineitem_like, orders_like
from repro_torch.kernels import ops
from repro_torch.storage import CODECS, MemoryPool, get_codec

SPECS = [
    # (shared, private, cards, base, width)
    ((256, 256), (64,), (1000, 5, 3, 1), 10, 8),
    ((32,), (16,), (3, 5), 10, 4),
    ((), (24,), (9,), 10, 5),
    ((), (), (4,), 10, 5),
    ((32, 32), (16, 8), (300,), 16, 3),
    ((130,), (), (7, 129), 2, 12),
]


def specs_for(shared, private, cards, base, width):
    kw = dict(
        base=base, width=width, shared=shared,
        private={f"t{i}": private for i in range(len(cards))},
        out_cards={f"t{i}": c for i, c in enumerate(cards)},
    )
    return JSpec(**kw), MLPSpec(**kw)


class TestKernelHostHelpers:
    @pytest.mark.parametrize("case", SPECS)
    def test_padded_bytes_and_activation(self, case):
        jspec, spec = specs_for(*case)
        assert ops.padded_weight_parts(spec) == jops.padded_weight_parts(jspec)
        assert ops.padded_weight_bytes(spec) == jops.padded_weight_bytes(jspec)
        for tile in (8, 64, 256):
            assert ops.activation_bytes(spec, tile) == jops.activation_bytes(jspec, tile)

    @pytest.mark.parametrize("case", SPECS)
    def test_plan_head_pages(self, case):
        jspec, spec = specs_for(*case)
        trunk, heads = ops.padded_weight_parts(spec)
        act = ops.activation_bytes(spec, 64)
        full = trunk + sum(heads.values()) + act
        for budget in (full + 10_000, full, full - 1, trunk + act + max(heads.values()),
                       trunk + act + max(heads.values()) - 1, 1):
            for words in (0, 4096):
                assert ops.plan_head_pages(spec, 64, words, budget) == jops.plan_head_pages(
                    jspec, 64, words, budget
                )

    @pytest.mark.parametrize("case", SPECS[1:4])
    def test_pad_flat_weights_equal(self, case):
        jspec, spec = specs_for(*case)
        jparams = j_init_params(jspec, seed=1)
        flat_j, nbytes_j = jops.pad_flat_weights(jparams, jspec)
        params = params_from_numpy(jax.device_get(jparams), "cpu")
        flat, nbytes = ops.pad_flat_weights(params, spec)
        assert nbytes == nbytes_j == ops.padded_weight_bytes(spec)
        assert len(flat) == len(flat_j)
        for a, b in zip(flat, flat_j):
            assert tuple(a.shape) == tuple(b.shape)
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    @pytest.mark.parametrize("env", [None, "1", "123456", "99999999"])
    def test_budget_resolution(self, monkeypatch, env):
        if env is None:
            monkeypatch.delenv("REPRO_VMEM_BUDGET", raising=False)
        else:
            monkeypatch.setenv("REPRO_VMEM_BUDGET", env)
        assert ops.vmem_budget_bytes() == jops.vmem_budget_bytes()

    def test_check_budget_rejects_oversized(self):
        jspec, spec = specs_for((2048, 2048), (2048,), (1000,), 10, 5)
        with pytest.raises(ValueError, match="VMEM"):
            ops.check_vmem_budget(None, spec, tile_n=256)

    def test_pack_words32_and_tensor(self):
        bv = JBitVector.from_keys(np.array([0, 31, 32, 63, 64, 1000, 4095]))
        got = ops.pack_words32(bv.words)
        np.testing.assert_array_equal(got, j_pack_words32(bv.words))
        t = ops.words_tensor(bv.words, "cpu")
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy().view(np.uint32), got)


class TestBitVectorPort:
    def test_set_test_count(self):
        bv = BitVector(1000)
        keys = np.array([0, 63, 64, 65, 999])
        bv.set(keys, True)
        assert bv.test(keys).all()
        assert not bv.test(np.array([1, 62, 66, 998])).any()
        assert bv.count() == 5

    def test_grow_and_out_of_domain(self):
        bv = BitVector(10)
        bv.set(np.array([1_000_000]), True)
        assert bv.capacity == 1_000_001
        assert bv.test(np.array([-3, 999_999, 1_000_000, 2_000_000])).tolist() == [
            False, False, True, False,
        ]

    def test_serialize_roundtrip_and_version(self):
        keys = np.random.default_rng(0).permutation(10_000)[:777]
        bv = BitVector.from_keys(keys, capacity=10_000)
        bv2 = BitVector.from_bytes(bv.to_bytes())
        np.testing.assert_array_equal(bv2.words, bv.words)
        v0 = bv.version
        bv.set(np.array([2]), True)
        bv.set(np.array([], dtype=np.int64), True)
        assert bv.version == v0 + 1

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_matches_reference_through_mutations(self, seed):
        rng = np.random.default_rng(seed)
        keys = rng.choice(50_000, 5_000, replace=False)
        a, b = BitVector.from_keys(keys), JBitVector.from_keys(keys)
        for _ in range(5):
            ks = rng.integers(0, 70_000, 300)
            on = bool(rng.integers(0, 2))
            a.set(ks, on)
            b.set(ks, on)
            np.testing.assert_array_equal(a.words, b.words)
            q = rng.integers(-10, 80_000, 2000)
            np.testing.assert_array_equal(a.test(q), b.test(q))
            assert a.count() == b.count() and a.capacity == b.capacity
        np.testing.assert_array_equal(a.keys_in_range(100, 60_000), b.keys_in_range(100, 60_000))
        assert a.size_bytes() == b.size_bytes()


def make_aux(cls, n=500, m=3, codec="zstd", partition_bytes=1024, pool=None, seed=0):
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.permutation(10 * n)[:n]).astype(np.int64)
    codes = rng.integers(0, 100, size=(n, m)).astype(np.int32)
    return keys, codes, cls.build(keys, codes, codec=codec, partition_bytes=partition_bytes,
                                  pool=pool)


class TestAuxTablePort:
    @pytest.mark.parametrize("codec", ["zstd", "lzma", "gzip", "none"])
    def test_exact_lookup(self, codec):
        keys, codes, aux = make_aux(AuxTable, codec=codec)
        found, got = aux.get(keys)
        assert found.all()
        np.testing.assert_array_equal(got, codes)

    def test_overlay_tombstones_compact(self):
        keys, codes, aux = make_aux(AuxTable)
        aux.remove(keys[:5])
        nk = np.array([10**6], dtype=np.int64)
        aux.add(nk, np.array([[7, 7, 7]], dtype=np.int32))
        aux.update(keys[5:6], np.array([[9, 9, 9]], dtype=np.int32))
        q = np.concatenate([keys, nk])
        pre = aux.get(q)
        assert pre[0].tolist()[:6] == [False] * 5 + [True]
        aux.compact()
        post = aux.get(q)
        np.testing.assert_array_equal(pre[0], post[0])
        np.testing.assert_array_equal(pre[1][pre[0]], post[1][post[0]])

    def test_shared_pool_eviction(self):
        pool = MemoryPool(budget_bytes=4096)
        keys, codes, aux = make_aux(AuxTable, n=2000, partition_bytes=1024, pool=pool)
        assert aux.get(keys)[0].all()
        assert pool.evictions > 0 and pool.used_bytes <= 4096

    @pytest.mark.parametrize("codec", ["zstd", "none"])
    def test_matches_reference(self, codec):
        keys, codes, aux = make_aux(AuxTable, codec=codec, seed=3)
        _, _, jaux = make_aux(JAuxTable, codec=codec, seed=3)
        rng = np.random.default_rng(4)
        for a in (aux, jaux):
            a.remove(keys[10:20])
            a.add(np.array([7_777_777]), np.array([[1, 2, 3]], dtype=np.int32))
        q = np.concatenate([keys, rng.integers(0, 10_000, 300), [7_777_777]])
        f1, c1 = aux.get(q)
        f2, c2 = jaux.get(q)
        np.testing.assert_array_equal(f1, f2)
        np.testing.assert_array_equal(c1[f1], c2[f2])
        assert aux.num_rows == jaux.num_rows
        assert aux.size_bytes() == jaux.size_bytes()
        st = aux.to_state()
        assert st["partitions"] == jaux.to_state()["partitions"]
        f3, _ = AuxTable.from_state(st).get(q)
        np.testing.assert_array_equal(f3, f1)


class TestStorageAndTablePort:
    @pytest.mark.parametrize("name", sorted(CODECS))
    def test_codec_roundtrip(self, name):
        blob = bytes(range(256)) * 40
        c = get_codec(name)
        assert c.decompress(c.compress(blob)) == blob

    def test_pack_composite_and_table(self):
        rng = np.random.default_rng(0)
        parts = [rng.integers(0, 100, 50), rng.integers(0, 7, 50)]
        np.testing.assert_array_equal(pack_composite_key(parts), j_pack(parts))
        t = Table(keys=np.array([3, 1, 2]), columns={"a": np.array(["x", "yy", "z"])})
        assert t.max_key == 3 and t.sorted_by_key().keys.tolist() == [1, 2, 3]
        with pytest.raises(ValueError):
            Table(keys=np.array([1, 1]), columns={})

    @pytest.mark.parametrize("gen", [(orders_like, j_orders_like), (lineitem_like, j_lineitem_like)])
    def test_tpch_generators_match(self, gen):
        a, b = gen[0](3000, seed=5), gen[1](3000, seed=5)
        np.testing.assert_array_equal(a.keys, b.keys)
        for c in b.columns:
            np.testing.assert_array_equal(a.columns[c], b.columns[c])


class TestEncodingPort:
    @pytest.mark.parametrize("max_key,base,residues", [
        (9999, 10, ()), (11_999_972, 10, ()), (5000, 2, ()), (9999, 10, (7,)),
        (9999, 10, (5, 12)), (65535, 16, (1000,)),
    ])
    def test_encoder_matches_reference(self, max_key, base, residues):
        a, b = KeyEncoder(max_key, base, residues), JKeyEncoder(max_key, base, residues)
        assert (a.width, a.capacity, a.position_ops()) == (b.width, b.capacity, b.position_ops())
        keys = np.random.default_rng(0).integers(0, a.capacity, 500)
        np.testing.assert_array_equal(a.digits(keys), b.digits(keys))
        np.testing.assert_array_equal(a.onehot(keys), b.onehot(keys))
        dt = a.digits_torch(torch.from_numpy(keys))
        assert dt.dtype == torch.int32
        np.testing.assert_array_equal(dt.numpy(), b.digits(keys))
        oh = onehot_digits(dt, base)
        np.testing.assert_array_equal(oh.numpy(), b.onehot(keys))

    def test_value_codec_matches_reference(self):
        vals = np.array(["b", "a", "c", "a", "b"])
        a, b = ValueCodec("x", vals), JValueCodec("x", vals)
        np.testing.assert_array_equal(a.codes, b.codes)
        for v in (np.array(["dd", "a", "zz", "dd"]), np.array([], dtype="<U1")):
            a.extend(v)
            b.extend(v)
        np.testing.assert_array_equal(a.decode_map, b.decode_map)
        q = np.array(["zz", "a", "nope"])
        for x, y in zip(a.encode(q), b.encode(q)):
            np.testing.assert_array_equal(x, y)
        assert a.size_bytes() == b.size_bytes()

    def test_detect_residues_matches_reference(self):
        keys = np.arange(0, 6000, dtype=np.int64)
        cols = {"a": (keys // 3) % 5, "b": np.random.default_rng(0).integers(0, 4, keys.size)}
        assert detect_residues(keys, cols, 10) == j_detect_residues(keys, cols, 10)


class TestObsAndStats:
    def test_engine_stats_mirror_into_registry(self):
        prev = obs.set_registry(obs.MetricsRegistry())
        try:
            st = EngineStats()
            st.bump("fused_calls")
            st.bump("fused_calls", 2)
            st.note_compile(("a",))
            st.note_compile(("a",))
            assert st.fused_calls == 3 and st.compiles == 1
            c = obs.counter("deepmap_engine_events_total")
            assert c.value(event="fused_calls") == 3
            assert obs.counter("deepmap_engine_compiles_total").value() == 1
            assert "deepmap_engine_events_total" in obs.registry().snapshot()
        finally:
            obs.set_registry(prev)

    def test_explain_stats_merge_matches_reference(self):
        def fill(cls):
            a = cls(heads_evaluated=("x",), infer_s=1.0, rows_decoded=3, shard_ids=(1,))
            b = cls(heads_evaluated=("y", "x"), infer_s=0.5, rows_decoded=2, shard_ids=(2,),
                    kernel_filtered=True)
            a.merge_timings(b)
            return a

        a, b = fill(ExplainStats), fill(JExplainStats)
        for f in ("heads_evaluated", "infer_s", "rows_decoded", "shard_ids",
                  "shards_visited", "kernel_filtered"):
            assert getattr(a, f) == getattr(b, f), f
