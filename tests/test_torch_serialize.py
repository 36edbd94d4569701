"""Save/load of the port in the reference's v2 layout, on the CPU.

* **Codec.**  ``repro_torch.storage.msgpack_codec`` against ``msgpack``:
  byte-equal ``packb`` and the same ``unpackb`` on the meta and aux
  dicts of stores the reference saves, and on a hypothesis sweep of the
  layout's subset (uint64 above 2**63, negative ints, nested maps).
* **Across packages.**  The reference saves a store (``use_pallas``
  off and on; Pallas in interpret mode); the port opens it and answers
  every key, present, absent and out of capacity, byte for byte as the
  reference does.  The same in reverse.  The port's engine codes on the
  present keys of a store the reference built must equal the
  reference's: the count of rows where they differ is asserted 0 (each
  would be a silent wrong answer, as T_aux corrects the other
  package's model).
* **Integrity.**  The single-store cases of ``tests/test_integrity.py``
  on stores the port saves: checksums, v1 layouts, corrupt and
  truncated artifacts, injected corruption, atomic-save hygiene.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import msgpack
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import repro
import repro_torch
from conftest import make_periodic_table
from repro.core.serialize import load_store as j_load_store
from repro_torch import obs
from repro_torch.core.serialize import (
    clean_stale_tmp,
    crc32,
    load_store,
    pack_meta,
    read_artifact,
    save_store,
    unpack_meta,
)
from repro_torch.fault import FaultPlan, FaultSpec, InjectedFault, IntegrityError
from repro_torch.storage.msgpack_codec import packb, unpackb
from torch_port_util import store_pair

ROOT = Path(__file__).resolve().parent.parent
SHARED, PRIVATE = (32,), (8,)


def flip_byte(path, offset=None):
    """Flip one bit of one byte in ``path`` (middle byte by default)."""
    with open(path, "rb") as f:
        data = bytearray(f.read())
    i = len(data) // 2 if offset is None else offset
    data[i] ^= 0x01
    with open(path, "wb") as f:
        f.write(bytes(data))


def probe_keys(table, enc_capacity):
    """Every present key, absent keys inside the domain, and keys out of
    capacity (negative, at and past the capacity, past int32)."""
    present = set(table.keys.tolist())
    absent = np.array([k for k in range(0, int(table.max_key) + 40) if k not in present][:400])
    out = np.array([-1, -7, enc_capacity, enc_capacity + 3, 2**31 - 1, 2**31, 2**40])
    return np.concatenate([table.keys, absent, out]).astype(np.int64)


def assert_same_answers(a, b, keys):
    """Byte-identical ``lookup`` answers, placeholders included."""
    av, ae = a.lookup(keys)
    bv, be = b.lookup(keys)
    np.testing.assert_array_equal(ae, be)
    assert set(av) == set(bv)
    for c in av:
        assert av[c].dtype == bv[c].dtype, c
        assert av[c].tobytes() == bv[c].tobytes(), c
    return av, ae


@pytest.fixture(scope="module")
def table():
    return make_periodic_table(n=1500, period=16, cards=(5, 3))


@pytest.fixture(scope="module", params=(False, True), ids=("jit", "pallas"))
def pair(request, table):
    jstore, store, _ = store_pair(table, SHARED, PRIVATE, use_pallas=request.param)
    return jstore, store


@pytest.fixture(scope="module")
def saved_single(table, tmp_path_factory):
    """One store saved by the port; corruption tests copy it."""
    _, store = store_pair(table, SHARED, PRIVATE)[:2]
    path = str(tmp_path_factory.mktemp("single") / "store")
    store.save(path)
    return table, store, path


def copy_of(saved_path, tmp_path):
    dst = str(tmp_path / os.path.basename(saved_path))
    shutil.copytree(saved_path, dst)
    return dst


# ------------------------------------------------------------------- codec
MSGPACK_VALUES = st.recursive(
    st.none() | st.booleans()
    | st.integers(min_value=-(2**63), max_value=2**64 - 1)
    | st.sampled_from([0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
                       2**63 - 1, 2**63, 2**64 - 1, -1, -32, -33, -128, -129,
                       -32768, -32769, -(2**31), -(2**31) - 1, -(2**63)])
    | st.floats() | st.sampled_from([0.0, -0.0, 1.5, float("inf"), float("-inf")])
    | st.text() | st.binary(max_size=300),
    lambda inner: st.lists(inner, max_size=20)
    | st.dictionaries(st.text(max_size=8), inner, max_size=20),
    max_leaves=40,
)


class TestCodec:
    @settings(max_examples=300, deadline=None, database=None)
    @given(MSGPACK_VALUES)
    def test_sweep_matches_msgpack(self, obj):
        # repr compares NaN, -0.0 and bool against int exactly.
        blob = msgpack.packb(obj)
        assert packb(obj) == blob
        assert repr(unpackb(blob)) == repr(msgpack.unpackb(blob))
        single = msgpack.packb(obj, use_single_float=True)  # float32 (0xca) on read
        assert repr(unpackb(single)) == repr(msgpack.unpackb(single))

    @pytest.mark.parametrize("n", (31, 32, 255, 256, 65535, 65536))
    def test_length_forms(self, n):
        for obj in ("x" * n, b"y" * n, list(range(n)), {str(i): i for i in range(n)}):
            blob = msgpack.packb(obj)
            assert packb(obj) == blob and unpackb(blob) == msgpack.unpackb(blob)

    def test_layout_dicts_of_reference_saves(self, pair, tmp_path):
        """The reference's own meta envelope, meta payload and aux blob:
        decoded as msgpack decodes them, and packed again to the same
        bytes."""
        jstore, _ = pair
        path = str(tmp_path / "ref")
        jstore.save(path)
        for name in ("meta.msgpack", "aux.msgpack"):
            blob = Path(path, name).read_bytes()
            obj = msgpack.unpackb(blob)
            assert unpackb(blob) == obj
            assert packb(obj) == blob == msgpack.packb(obj)
        envelope = msgpack.unpackb(Path(path, "meta.msgpack").read_bytes())
        meta = msgpack.unpackb(envelope["payload"])
        assert packb(meta) == envelope["payload"]
        assert meta["checksums"] and all(v >= 0 for v in meta["checksums"].values())
        assert pack_meta(meta) == Path(path, "meta.msgpack").read_bytes()

    @pytest.mark.parametrize("bad", (np.float32(1.5), np.int64(3), {1, 2}, object()))
    def test_rejects_types_outside_the_subset(self, bad):
        with pytest.raises(TypeError):
            packb(bad)

    @pytest.mark.parametrize("blob", (b"\xa5ab", b"\x92\x01", b"\x01\x02", b"\xc1",
                                      b"\x81\x01\x02"))
    def test_rejects_truncated_trailing_and_unknown(self, blob):
        with pytest.raises(ValueError):
            unpackb(blob)

    def test_out_of_range_int(self):
        for v in (2**64, -(2**63) - 1):
            with pytest.raises(OverflowError):
                packb(v)


# ---------------------------------------------------------- across packages
class TestAcrossPackages:
    def test_port_opens_reference_save(self, pair, table, tmp_path):
        jstore, _ = pair
        path = str(tmp_path / "ref")
        jstore.save(path)
        loaded = repro_torch.open(path, device="cpu")
        assert isinstance(loaded, repro_torch.DeepMappingStore)
        assert loaded.config.use_kernels
        keys = probe_keys(table, jstore.encoder.capacity)
        values, exists = assert_same_answers(jstore, loaded, keys)
        assert exists[: table.num_rows].all() and not exists[table.num_rows:].any()
        for c in table.columns:
            np.testing.assert_array_equal(values[c][: table.num_rows], table.columns[c])
        assert loaded.engine.stats.fused_calls > 0  # served through K1
        assert loaded.num_rows == jstore.num_rows
        assert loaded.size_breakdown() == jstore.size_breakdown()

    def test_reference_opens_port_save(self, pair, table, tmp_path):
        _, store = pair
        path = str(tmp_path / "port")
        store.save(path)
        loaded = repro.open(path)
        keys = probe_keys(table, store.encoder.capacity)
        values, exists = assert_same_answers(store, loaded, keys)
        assert exists[: table.num_rows].all() and not exists[table.num_rows:].any()
        for c in table.columns:
            np.testing.assert_array_equal(values[c][: table.num_rows], table.columns[c])
        assert loaded.size_breakdown() == store.size_breakdown()

    def test_round_trip_after_mutations_both_ways(self, table, tmp_path):
        jstore, store, _ = store_pair(table, SHARED, PRIVATE)
        new = np.array([1, 3, 10**5], dtype=np.int64)
        ins = {"col0": np.array([1, 2, 9], np.int32), "col1": np.array([0, 1, 7], np.int32)}
        upd = {"col0": np.array([4, 0], np.int32), "col1": np.array([2, 2], np.int32)}
        for s in (jstore, store):
            s.insert(new, ins)
            s.update(table.keys[5:7], upd)
            s.delete(table.keys[10:14])
        keys = np.concatenate([probe_keys(table, store.encoder.capacity), new])
        assert_same_answers(jstore, store, keys)
        store.save(str(tmp_path / "p"))
        jstore.save(str(tmp_path / "j"))
        assert_same_answers(store, repro.open(str(tmp_path / "p")), keys)
        assert_same_answers(jstore, repro_torch.open(str(tmp_path / "j"), device="cpu"), keys)
        assert repro_torch.open(str(tmp_path / "p"), device="cpu").modified_bytes == \
            store.modified_bytes

    def test_code_disagreements_are_zero(self, pair, table, tmp_path):
        """Present keys where the port's engine codes differ from the
        reference's, on a store the reference saved.  T_aux corrects the
        reference's model, so each such row would be a wrong answer."""
        jstore, _ = pair
        path = str(tmp_path / "ref")
        jstore.save(path)
        loaded = repro_torch.open(path, device="cpu")
        want = np.asarray(jstore._infer_codes(table.keys))
        got = loaded._infer_codes(table.keys)
        differ = np.flatnonzero((got != want).any(axis=1))
        assert differ.size == 0, (
            f"{differ.size} code disagreements; first key {int(table.keys[differ[0]])}: "
            f"port {got[differ[0]].tolist()} reference {want[differ[0]].tolist()}"
        )

    def test_params_npz_keys_are_the_reference_paths(self, pair, tmp_path):
        jstore, store = pair
        store.save(str(tmp_path / "p"))
        jstore.save(str(tmp_path / "j"))
        with np.load(tmp_path / "p" / "params.npz") as a, \
                np.load(tmp_path / "j" / "params.npz") as b:
            assert set(a.files) == set(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k

    def test_needs_neither_msgpack_nor_zstandard(self, tmp_path):
        """With msgpack, zstandard, jax and repro unimportable, the port
        saves and reopens a store (T_aux through the zlib fallback)."""
        code = (
            "import sys\n"
            "for m in ('jax', 'repro', 'msgpack', 'zstandard'):\n"
            "    sys.modules[m] = None\n"
            "import numpy as np, repro_torch\n"
            "from repro_torch.data.tpch import orders_like\n"
            "from repro_torch.core import DeepMappingConfig, KeyEncoder, MLPSpec, init_params\n"
            "t = orders_like(400, seed=0)\n"
            "cards = {c: len(np.unique(v)) for c, v in t.columns.items()}\n"
            "spec = MLPSpec(10, KeyEncoder(t.max_key).width, (8,), {c: (4,) for c in cards}, cards)\n"
            "s = repro_torch.build(t, DeepMappingConfig(), spec=spec,\n"
            "                      params=init_params(spec, device='cpu'), device='cpu')\n"
            f"s.save({str(tmp_path / 's')!r})\n"
            f"v, e = repro_torch.open({str(tmp_path / 's')!r}, device='cpu').lookup(t.keys)\n"
            "assert e.all() and all((v[c] == t.columns[c]).all() for c in t.columns)\n"
            "assert not any(m in sys.modules and sys.modules[m] is not None\n"
            "               for m in ('msgpack', 'zstandard', 'jax'))\n"
            "print('ok')\n"
        )
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                             env=env)
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip() == "ok"


# ---------------------------------------------------------------- integrity
class TestChecksumRoundTrip:
    def test_single_store(self, saved_single):
        table, store, path = saved_single
        loaded = repro_torch.open(path, device="cpu")
        assert_same_answers(store, loaded, np.concatenate([table.keys, table.keys[:50] + 1]))

    def test_meta_records_a_checksum_per_artifact(self, saved_single):
        _, _, path = saved_single
        meta = unpack_meta(read_artifact(path, "meta.msgpack", None), "meta.msgpack")
        checksums = meta["checksums"]
        assert set(checksums) == {f for f in os.listdir(path) if f != "meta.msgpack"}
        for name, stored in checksums.items():
            with open(os.path.join(path, name), "rb") as f:
                assert crc32(f.read()) == stored

    def test_v1_layout_without_checksums_still_loads(self, saved_single, tmp_path):
        table, store, path = saved_single
        dst = copy_of(path, tmp_path)
        meta = unpack_meta(read_artifact(dst, "meta.msgpack", None), "meta.msgpack")
        meta.pop("checksums")
        meta["version"] = 1
        with open(os.path.join(dst, "meta.msgpack"), "wb") as f:
            f.write(msgpack.packb(meta))  # flat, no crc envelope
        assert_same_answers(store, load_store(dst, device="cpu"), table.keys[:100])
        assert_same_answers(store, j_load_store(dst), table.keys[:100])


class TestCorruptionDetection:
    def test_bit_flipped_vexist_detected(self, saved_single, tmp_path):
        _, _, path = saved_single
        dst = copy_of(path, tmp_path)
        flip_byte(os.path.join(dst, "vexist.bin"))
        with pytest.raises(IntegrityError, match="vexist.bin"):
            load_store(dst, device="cpu")

    def test_truncated_params_detected(self, saved_single, tmp_path):
        _, _, path = saved_single
        dst = copy_of(path, tmp_path)
        params = os.path.join(dst, "params.npz")
        with open(params, "rb+") as f:
            f.truncate(os.path.getsize(params) // 2)
        with pytest.raises(IntegrityError, match="params.npz"):
            load_store(dst, device="cpu")

    def test_missing_decode_map_fails_loudly(self, saved_single, tmp_path):
        _, _, path = saved_single
        dst = copy_of(path, tmp_path)
        victim = next(f for f in os.listdir(dst) if f.startswith("decode_"))
        os.remove(os.path.join(dst, victim))
        with pytest.raises(FileNotFoundError):
            load_store(dst, device="cpu")

    def test_bit_flipped_meta_detected(self, saved_single, tmp_path):
        _, _, path = saved_single
        dst = copy_of(path, tmp_path)
        flip_byte(os.path.join(dst, "meta.msgpack"))
        with pytest.raises((IntegrityError, ValueError)):
            load_store(dst, device="cpu")

    def test_injected_corruption_detected(self, saved_single):
        _, _, path = saved_single
        counter = obs.counter("deepmap_fault_injected_total")
        before = counter.value(site="artifact_read", kind="corrupt")
        plan = FaultPlan([FaultSpec(site="artifact_read", kind="corrupt", owner="vexist.bin")])
        with plan.activate():
            with pytest.raises(IntegrityError, match="vexist.bin"):
                load_store(path, device="cpu")
        assert plan.fired == 1
        assert counter.value(site="artifact_read", kind="corrupt") == before + 1

    def test_engine_dispatch_site(self, saved_single):
        """The port's ``InferenceEngine.dispatch`` carries the
        reference's ``engine_dispatch`` site (after the empty early-out)."""
        table, store, _ = saved_single
        plan = FaultPlan([FaultSpec(site="engine_dispatch", kind="raise", times=1)])
        with plan.activate():
            store.lookup(table.keys[:0])  # zero keys never dispatch
            with pytest.raises(InjectedFault, match="engine_dispatch"):
                store.lookup(table.keys[:10])
            _, exists = store.lookup(table.keys[:10])  # times=1: next call runs
        assert exists.all() and plan.fired_at("engine_dispatch") == 1


class TestAtomicSaveHygiene:
    def test_stale_tmp_cleaned_on_load_with_warning(self, saved_single, tmp_path):
        table, store, path = saved_single
        dst = copy_of(path, tmp_path)
        os.makedirs(dst + ".tmp")
        with open(os.path.join(dst + ".tmp", "junk"), "wb") as f:
            f.write(b"half-written")
        with pytest.warns(RuntimeWarning, match="stale"):
            loaded = load_store(dst, device="cpu")
        assert not os.path.exists(dst + ".tmp")
        assert_same_answers(store, loaded, table.keys[:50])

    def test_interrupted_save_detected_by_open(self, tmp_path):
        path = str(tmp_path / "store")
        os.makedirs(path + ".tmp")
        with pytest.raises(ValueError, match="interrupted save"):
            repro_torch.open(path, device="cpu")

    def test_clean_stale_tmp_reports(self, tmp_path):
        path = str(tmp_path / "x")
        assert clean_stale_tmp(path) is False
        os.makedirs(path + ".tmp")
        with pytest.warns(RuntimeWarning):
            assert clean_stale_tmp(path) is True
        assert not os.path.exists(path + ".tmp")

    def test_save_is_atomic_over_existing(self, saved_single, tmp_path):
        table, store, _ = saved_single
        path = str(tmp_path / "store")
        save_store(store, path)
        save_store(store, path)
        assert not os.path.exists(path + ".tmp")
        assert_same_answers(store, load_store(path, device="cpu"), table.keys[:50])


class TestOpenFormats:
    def test_empty_formats_are_refused_as_the_reference_refuses_them(self, tmp_path):
        # Clusters are ported: an empty manifest is a truncated msgpack
        # blob, refused with ValueError by both packages.
        cluster = tmp_path / "cluster"
        cluster.mkdir()
        (cluster / "manifest.msgpack").write_bytes(b"")
        with pytest.raises(ValueError, match="truncated"):
            repro_torch.open(str(cluster), device="cpu")
        with pytest.raises(ValueError):
            repro.open(str(cluster))
        # Baselines are ported: an empty file is an unrecognized baseline
        # blob, refused as the reference refuses it.
        blob = tmp_path / "baseline.msgpack"
        blob.write_bytes(b"")
        with pytest.raises(ValueError, match="supported formats"):
            repro_torch.open(str(blob), device="cpu")
        with pytest.raises(ValueError, match="supported formats"):
            repro.open(str(blob))

    def test_open_rejects_garbage(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            repro_torch.open(str(tmp_path / "nope"), device="cpu")
        (tmp_path / "bad").mkdir()
        with pytest.raises(ValueError):
            repro_torch.open(str(tmp_path / "bad"), device="cpu")

    def test_open_defaults_to_cuda(self, saved_single, monkeypatch):
        import torch

        _, _, path = saved_single
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            repro_torch.open(path)
