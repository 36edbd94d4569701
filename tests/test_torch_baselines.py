"""The port's AB/HB baselines (``repro_torch.baselines``), on the CPU,
held against the reference package ``repro.baselines``.

Each case builds the same store in both packages from the same numpy
table and factory.  Answers must be byte for byte alike (values,
dtypes, existence), sizes equal, and the saved files byte-equal: AB
partitions are numpy bytes, HB partitions pickles of numpy scalars, and
the envelope is msgpack, written by the port's own codec.  A file saved
by either package opens through the other's ``open`` with the same
answers.  These are the cases of ``test_baselines.py`` and the baseline
cases of ``test_integrity.py``; no tolerance applies anywhere.
"""

import gzip
import os
import types

import msgpack
import numpy as np
import pytest

import repro
import repro_torch
from conftest import make_periodic_table
from repro.baselines import BASELINE_FACTORIES as J_FACTORIES
from repro.baselines import ArrayStore as JArrayStore
from repro.baselines import HashStore as JHashStore
from repro.core import Table as JTable
from repro.data import synthetic_multi_column as j_synthetic_multi_column
from repro.data.tpch import orders_like as j_orders_like
from repro.fault import IntegrityError as JIntegrityError
from repro.storage import MemoryPool as JMemoryPool
from repro_torch.baselines import BASELINE_FACTORIES, ArrayStore, HashStore
from repro_torch.baselines.partitioned import _array_to_state, _read_baseline_state
from repro_torch.core import Table
from repro_torch.data import synthetic_multi_column
from repro_torch.data.tpch import orders_like
from repro_torch.fault import FaultPlan, FaultSpec, IntegrityError
from repro_torch.storage import MemoryPool, codecs
from repro_torch.storage.msgpack_codec import packb, unpackb
from torch_port_util import assert_values_equal

KINDS = {"array": (ArrayStore, JArrayStore), "hash": (HashStore, JHashStore)}


def as_port(table):
    """The reference's numpy table as the port's ``Table``."""
    return Table(keys=table.keys.copy(), columns={c: v.copy() for c, v in table.columns.items()})


def same_answers(a, b, keys, columns=None):
    """Both stores answer ``keys`` byte for byte alike; returns them."""
    av, ae = a.lookup(keys, columns)
    bv, be = b.lookup(keys, columns)
    np.testing.assert_array_equal(ae, be)
    assert_values_equal(av, bv)
    return av, ae


def flip_byte(path, offset=None):
    with open(path, "rb") as f:
        data = bytearray(f.read())
    i = len(data) // 2 if offset is None else offset
    data[i] ^= 0x01
    with open(path, "wb") as f:
        f.write(bytes(data))


@pytest.fixture(scope="module")
def jtable():
    return j_synthetic_multi_column(n=5000, correlation="high", seed=1)


@pytest.fixture(scope="module")
def table():
    return synthetic_multi_column(n=5000, correlation="high", seed=1)


@pytest.fixture(scope="module")
def string_tables():
    return j_orders_like(n=2000), orders_like(n=2000)


@pytest.fixture
def frozen_gzip_clock(monkeypatch):
    """``gzip.compress`` writes the current second into each member's
    header (both packages' ``gzip`` codec calls it), so two stores
    compressed on either side of a second would differ in those bytes:
    the clock ``gzip`` reads stands still for the test."""
    monkeypatch.setattr(gzip, "time", types.SimpleNamespace(time=lambda: 1_700_000_000.0))


class TestBaselineStores:
    @pytest.mark.parametrize("name", sorted(BASELINE_FACTORIES))
    def test_exact_lookup_all(self, name, table, jtable, tmp_path, frozen_gzip_clock):
        store = BASELINE_FACTORIES[name](table, partition_bytes=4096)
        ref = J_FACTORIES[name](jtable, partition_bytes=4096)
        step = max(1, table.num_rows // 500)
        q = table.keys[::step]
        vals, exists = same_answers(store, ref, q)
        assert exists.all()
        for col in table.columns:
            np.testing.assert_array_equal(vals[col], table.columns[col][::step])
        assert store.size_breakdown() == ref.size_breakdown()
        store.save(str(tmp_path / "port.bin"))
        ref.save(str(tmp_path / "ref.bin"))
        assert (tmp_path / "port.bin").read_bytes() == (tmp_path / "ref.bin").read_bytes()

    @pytest.mark.parametrize("name", ["AB", "ABC-Z", "HB", "HBC-Z"])
    def test_missing_keys(self, name, table, jtable):
        store = BASELINE_FACTORIES[name](table, partition_bytes=4096)
        ref = J_FACTORIES[name](jtable, partition_bytes=4096)
        missing = np.array([table.max_key + 10, table.max_key + 11, -1], dtype=np.int64)
        _, exists = same_answers(store, ref, missing)
        assert not exists.any()

    @pytest.mark.parametrize("name", ["ABC-Z", "ABC-L", "ABC-G", "ABC-D"])
    def test_compression_shrinks(self, name, table, jtable):
        ab = BASELINE_FACTORIES["AB"](table, partition_bytes=65536)
        abc = BASELINE_FACTORIES[name](table, partition_bytes=65536)
        assert abc.size_bytes() < ab.size_bytes()
        assert abc.size_bytes() == J_FACTORIES[name](jtable, partition_bytes=65536).size_bytes()

    @pytest.mark.parametrize("name", ["AB", "ABC-Z", "HB"])
    def test_string_columns(self, name, string_tables):
        jt, t = string_tables
        store = BASELINE_FACTORIES[name](t, partition_bytes=8192)
        ref = J_FACTORIES[name](jt, partition_bytes=8192)
        vals, exists = same_answers(store, ref, t.keys[:100])
        assert exists.all()
        np.testing.assert_array_equal(vals["o_orderstatus"].astype(str),
                                      t.columns["o_orderstatus"][:100].astype(str))

    def test_shared_pool_pressure(self, table, jtable):
        pools = MemoryPool(budget_bytes=16 * 1024), JMemoryPool(16 * 1024)
        store = ArrayStore.build(table, codec="zstd", partition_bytes=4096, pool=pools[0])
        ref = JArrayStore.build(jtable, codec="zstd", partition_bytes=4096, pool=pools[1])
        _, exists = same_answers(store, ref, table.keys)
        assert exists.all()
        assert pools[0].evictions > 0
        assert (pools[0].evictions, pools[0].misses, pools[0].used_bytes) == (
            pools[1].evictions, pools[1].misses, pools[1].used_bytes)

    def test_hash_store_partition_count(self, table, jtable):
        hs = HashStore.build(table, codec="none", partition_bytes=2048)
        assert len(hs._partitions) > 1
        assert hs._partitions == JHashStore.build(jtable, codec="none",
                                                  partition_bytes=2048)._partitions

    def test_column_projection(self, table, jtable):
        store = ArrayStore.build(table, codec="zstd")
        vals, _ = same_answers(store, JArrayStore.build(jtable, codec="zstd"),
                               table.keys[:10], columns=["v0"])
        assert set(vals) == {"v0"}


class TestZoneMapPersistence:
    """Dictionary-mode zone maps ride the v2 envelope: built maps
    round-trip bit-exactly, equal the reference's, stale or malformed
    entries are dropped, and the payload crc covers them."""

    @pytest.fixture()
    def built(self, table):
        store = ArrayStore.build(table, codec="zlib", dictionary=True, partition_bytes=4096)
        zones = {c: store._partition_code_presence(c).copy() for c in store.names}
        return store, zones

    def test_round_trip_bit_exact(self, built, jtable, tmp_path):
        store, zones = built
        path = str(tmp_path / "ab.bin")
        store.save(path)
        loaded = ArrayStore.load(path)
        ref = JArrayStore.load(path)
        assert set(loaded._zone_maps) == set(zones) == set(ref._zone_maps)
        for c, z in zones.items():
            np.testing.assert_array_equal(loaded._zone_maps[c], z)
            np.testing.assert_array_equal(ref._zone_maps[c], z)

    def test_loaded_maps_match_lazy_rebuild(self, built, tmp_path):
        store, zones = built
        path = str(tmp_path / "ab.bin")
        store.save(path)
        loaded = ArrayStore.load(path)
        loaded._zone_maps.clear()
        for c, z in zones.items():
            np.testing.assert_array_equal(loaded._partition_code_presence(c), z)

    def test_unbuilt_maps_save_nothing(self, table, tmp_path):
        store = ArrayStore.build(table, codec="none", dictionary=True, partition_bytes=4096)
        path = str(tmp_path / "ab.bin")
        store.save(path)
        assert "zone_maps" not in store._extra_state()
        assert ArrayStore.load(path)._zone_maps == {}

    def test_stale_maps_dropped_gracefully(self, built, tmp_path):
        store, zones = built
        path = str(tmp_path / "ab.bin")
        store.save(path)
        state = _read_baseline_state(path)
        zm = state["extra"]["zone_maps"]
        col0, col1 = sorted(zm)[:2]
        zm[col0]["partitions"] += 1
        zm[col1]["bits"] = zm[col1]["bits"][:1]
        zm["ghost"] = {"partitions": 1, "cardinality": 2, "bits": b"\xff"}
        loaded = ArrayStore.from_saved_state(state)
        assert not {col0, col1, "ghost"} & set(loaded._zone_maps)
        for c, z in zones.items():
            np.testing.assert_array_equal(loaded._partition_code_presence(c), z)

    def test_checksum_covers_zone_maps(self, built, tmp_path):
        store, _ = built
        path = str(tmp_path / "ab.bin")
        store.save(path)
        flip_byte(path, os.path.getsize(path) - 16)
        with pytest.raises(IntegrityError):
            ArrayStore.load(path)
        with pytest.raises(JIntegrityError):
            JArrayStore.load(path)


# ---------------------------------------------------------- integrity
class TestIntegrity:
    @pytest.mark.parametrize("kind", sorted(KINDS))
    def test_baseline_stores(self, kind, tmp_path):
        """``repro_torch.open`` on a saved baseline file (no device)."""
        cls, jcls = KINDS[kind]
        jt = make_periodic_table(n=500)
        store = cls.build(as_port(jt), codec="none", partition_bytes=2048)
        path = str(tmp_path / "baseline.msgpack")
        store.save(path)
        loaded = repro_torch.open(path)
        assert type(loaded) is cls
        same_answers(store, loaded, jt.keys)
        same_answers(jcls.build(jt, codec="none", partition_bytes=2048), loaded, jt.keys)

    @pytest.mark.parametrize("kind", sorted(KINDS))
    def test_bit_flipped_baseline_detected(self, kind, tmp_path):
        cls, _ = KINDS[kind]
        store = cls.build(as_port(make_periodic_table(n=300)), codec="none",
                          partition_bytes=2048)
        path = str(tmp_path / "b.msgpack")
        store.save(path)
        flip_byte(path)
        with pytest.raises(IntegrityError) as err:
            repro_torch.open(path)
        assert "supported formats" not in str(err.value)
        with pytest.raises(JIntegrityError):
            repro.open(path)

    def test_artifact_read_site_fires_on_a_baseline_read(self, tmp_path):
        path = str(tmp_path / "h.msgpack")
        HashStore.build(as_port(make_periodic_table(n=300)), codec="none").save(path)
        plan = FaultPlan([FaultSpec(site="artifact_read", kind="corrupt",
                                    owner="h.msgpack")])
        with plan.activate():
            with pytest.raises(IntegrityError):
                repro_torch.open(path)
        assert plan.fired == 1

    def test_unknown_kind_and_newer_version_refused(self, tmp_path):
        path = str(tmp_path / "x.msgpack")
        ArrayStore.build(as_port(make_periodic_table(n=100)), codec="none").save(path)
        state = _read_baseline_state(path)
        with pytest.raises(ValueError, match="not 'hash_store'"):
            HashStore.from_saved_state(state)
        with pytest.raises(ValueError, match="newer"):
            ArrayStore.from_saved_state(dict(state, version=3))
        (tmp_path / "odd.msgpack").write_bytes(packb({"kind": "other", "version": 1}))
        with pytest.raises(ValueError, match="supported formats"):
            repro_torch.open(str(tmp_path / "odd.msgpack"))


# ---------------------------------------------------- across packages
def mixed_table(cls):
    """Keys with gaps; int, float and string columns."""
    keys = np.arange(0, 3000, 3, dtype=np.int64)
    return cls(keys=keys, columns={
        "i": ((keys // 7) % 11).astype(np.int32),
        "f": (keys / 8.0).astype(np.float64),
        "s": np.array(["red", "green", "blue", "cyan"])[(keys // 5) % 4],
    })


def mutate(store):
    """Inserts, updates and deletes, so the overlay holds float, string
    and int columns and the delete set is not empty."""
    new = np.array([1, 4, 10**6], dtype=np.int64)
    store.insert(new, {"i": np.array([1, 2, 3], np.int32), "f": np.array([0.5, -0.0, 1e300]),
                       "s": np.array(["violet", "x", "red"])})
    store.update(np.array([3, 6], dtype=np.int64),
                 {"i": np.array([-5, 99], np.int32), "f": np.array([np.inf, 2.25]),
                  "s": np.array(["a much longer string", "b"])})
    store.delete(np.array([9, 4], dtype=np.int64))


PROBE = np.concatenate([np.arange(0, 3100, dtype=np.int64), [10**6, -1, 10**9]])


@pytest.mark.parametrize("name", sorted(BASELINE_FACTORIES))
@pytest.mark.parametrize("mutated", (False, True), ids=("base", "overlay"))
def test_files_are_byte_equal_and_open_in_either_package(name, mutated, tmp_path):
    """Same table, factory and codec: the two packages' files are the
    same bytes, and each opens in the other with the same answers."""
    store = BASELINE_FACTORIES[name](mixed_table(Table), partition_bytes=4096)
    ref = J_FACTORIES[name](mixed_table(JTable), partition_bytes=4096)
    if mutated:
        mutate(store)
        mutate(ref)
    port_path, ref_path = str(tmp_path / "port.bin"), str(tmp_path / "ref.bin")
    store.save(port_path)
    ref.save(ref_path)
    blob = open(port_path, "rb").read()
    assert blob == open(ref_path, "rb").read()
    assert unpackb(blob) == msgpack.unpackb(blob)
    by_ref, by_port = repro.open(port_path), repro_torch.open(ref_path)
    for a, b in ((store, by_ref), (ref, by_port), (store, ref)):
        same_answers(a, b, PROBE)
    assert by_port.num_rows == store.num_rows == ref.num_rows


def test_overlay_state_packs_as_msgpack_does():
    """A real ArrayStore/HashStore state with a float, string and int
    overlay: the port's codec gives ``msgpack.packb``'s bytes."""
    for cls in (ArrayStore, HashStore):
        store = cls.build(mixed_table(Table), codec="none", partition_bytes=4096)
        mutate(store)
        state = {n: _array_to_state(np.asarray([store._overlay[k][n] for k in sorted(store._overlay)]))
                 for n in store.names}
        assert {s["enc"] for s in state.values()} == {"raw", "items"}
        items = state["s"]["items"]
        assert any(isinstance(v, str) for v in items)
        floats = {"enc": "items", "dtype": "<f8", "items": [0.5, -0.0, float("inf"), 1e300]}
        for obj in (state, floats, {"k": [1, 2.5, "x", b"y", None, True]}):
            assert packb(obj) == msgpack.packb(obj)
            assert repr(unpackb(packb(obj))) == repr(msgpack.unpackb(msgpack.packb(obj)))


def test_zstd_fallback_names_the_codec_as_the_reference_does(tmp_path, monkeypatch):
    """Without ``zstandard`` the port's "zstd" compresses through zlib
    and the file still records the codec as "zstd", so the reference
    opens it (its decompressor reads zlib blobs)."""
    fallback = codecs._fallback("zstd", codecs._ZSTD_MAGIC, level=3)
    monkeypatch.setitem(codecs.CODECS, "zstd", fallback)
    table = mixed_table(Table)
    store = BASELINE_FACTORIES["ABC-Z"](table, partition_bytes=4096)
    assert store._codec is fallback and store.codec_name == "zstd"
    path = str(tmp_path / "z.bin")
    store.save(path)
    assert _read_baseline_state(path)["codec"] == "zstd"
    same_answers(store, repro.open(path), PROBE)
