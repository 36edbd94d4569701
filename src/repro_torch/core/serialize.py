"""On-disk format for DeepMapping hybrid stores — the port of
``repro.core.serialize``, reading and writing the SAME v2 layout, so a
store saved by either package opens in the other.

Directory layout (atomic: written to ``<dir>.tmp`` then renamed):

    store/
      meta.msgpack      — spec, encoder, config, counters, checksums
      params.npz        — model weights (flattened path -> array)
      aux.msgpack       — compacted T_aux state (compressed partitions)
      vexist.bin        — compressed existence bitvector
      decode_<col>.npy  — f_decode arrays (numpy native, no pickle for
                          numeric/string dtypes)

No pickle anywhere — partitions and weights are raw buffers, metadata is
msgpack, written and read by the port's own codec
(:mod:`repro_torch.storage.msgpack_codec`), so the port needs no
``msgpack`` package.

Durability discipline (v2):

* every artifact carries a ``zlib.crc32`` recorded in ``meta.msgpack``
  and verified on load — a bit-flipped or truncated artifact raises
  :class:`~repro_torch.fault.errors.IntegrityError` instead of decoding
  into wrong values;
* ``meta.msgpack`` is written LAST (a directory with a meta file is a
  complete save) and wrapped in a crc32 envelope of its own;
* every file is fsynced before the tmp-directory rename (and the parent
  directory after), so a crash cannot publish a store whose artifacts
  are still in the page cache;
* a stale ``<dir>.tmp`` from an interrupted save is removed (with a
  warning) on the next load of ``<dir>``.

Reads flow through :func:`read_artifact`, which is instrumented for the
``artifact_read`` fault-injection site.
"""

from __future__ import annotations

import io
import os
import shutil
import warnings
import zlib
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.aux_table import AuxTable
from repro_torch.core.bitvector import BitVector
from repro_torch.core.encoding import KeyEncoder, ValueCodec
from repro_torch.core.hybrid import DeepMappingConfig, DeepMappingStore
from repro_torch.core.model import MLPSpec
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.fault import injection as fault_injection
from repro_torch.fault.errors import IntegrityError
from repro_torch.storage import MemoryPool
from repro_torch.storage.msgpack_codec import packb, unpackb

#: v2 adds per-artifact crc32 checksums + the meta envelope; v1 stores
#: (no ``checksums`` map, flat meta) still load, without verification.
FORMAT_VERSION = 2


# ------------------------------------------------------------ durability
def crc32(data: bytes) -> int:
    """Stdlib crc32, normalized to unsigned (msgpack round-trip safe)."""
    return zlib.crc32(data) & 0xFFFFFFFF


def fsync_dir(path: str) -> None:
    """fsync a directory so its entries (renames, new files) are
    durable — POSIX requires syncing the directory, not just the
    files inside it."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def write_artifact(
    dirpath: str, name: str, data: bytes, checksums: Dict[str, int]
) -> None:
    """Write one artifact durably (flush + fsync) and record its crc."""
    with open(os.path.join(dirpath, name), "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    checksums[name] = crc32(data)


def read_artifact(
    dirpath: str, name: str, checksums: Optional[Dict[str, int]]
) -> bytes:
    """Read one artifact and verify its crc against ``checksums``.

    ``checksums=None`` (or a map without this artifact — a v1 save)
    skips verification.  The ``artifact_read`` injection site fires
    before the read (raise/delay) and on the payload (corrupt).
    """
    fault_injection.maybe_fail("artifact_read", owner=name)
    with open(os.path.join(dirpath, name), "rb") as f:
        data = f.read()
    data = fault_injection.corrupt("artifact_read", name, data)
    if checksums is not None and name in checksums:
        got = crc32(data)
        want = int(checksums[name])
        if got != want:
            raise IntegrityError(
                f"{os.path.join(dirpath, name)}: crc32 mismatch "
                f"(stored {want:#010x}, read {got:#010x}) — artifact is "
                f"corrupt or truncated"
            )
    return data


def clean_stale_tmp(path: str) -> bool:
    """Remove a stale ``<path>.tmp`` left by an interrupted save.

    Returns True (after warning) if one was removed."""
    tmp = path + ".tmp"
    if not os.path.exists(tmp):
        return False
    warnings.warn(
        f"removing stale {tmp!r} left by an interrupted save; the last "
        f"completed save at {path!r} is unaffected",
        RuntimeWarning,
        stacklevel=2,
    )
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    else:
        os.remove(tmp)
    return True


def pack_meta(meta: Dict) -> bytes:
    """Wrap a metadata dict in a self-verifying crc32 envelope."""
    payload = packb(meta)
    return packb({"crc32": crc32(payload), "payload": payload})


def unpack_meta(blob: bytes, label: str) -> Dict:
    """Open a metadata blob: crc32 envelope (v2) or flat dict (v1)."""
    obj = unpackb(blob)
    if isinstance(obj, dict) and "payload" in obj and "crc32" in obj:
        payload = obj["payload"]
        if crc32(payload) != int(obj["crc32"]):
            raise IntegrityError(
                f"{label}: metadata crc32 mismatch — file is corrupt"
            )
        return unpackb(payload)
    return obj  # v1 flat metadata, no checksum to verify


# ----------------------------------------------------------- store format
def _flatten_params(params: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    """``{"/shared/0/w": array, "/heads/<t>/out/b": array, ...}`` — the
    reference's ``params.npz`` keys, with host copies of the leaves."""
    flat: Dict[str, np.ndarray] = {}

    def rec(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                rec(v, f"{path}/{k}")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                rec(v, f"{path}/{i}")
        elif isinstance(node, torch.Tensor):
            flat[path] = node.detach().cpu().numpy()
        else:
            flat[path] = np.asarray(node)

    rec(params, prefix)
    return flat


def _unflatten_params(
    flat: Dict[str, np.ndarray], spec: MLPSpec, device: torch.device
) -> Dict:
    """The params tree of ``spec``'s layout from ``_flatten_params`` keys,
    as tensors on ``device``."""

    def layer(path):
        return {
            k: torch.from_numpy(np.array(flat[f"{path}/{k}"], copy=True)).to(device)
            for k in ("w", "b")
        }

    want = {f"/shared/{i}/{k}" for i in range(len(spec.shared)) for k in ("w", "b")}
    for t in spec.tasks:
        want |= {f"/heads/{t}/out/{k}" for k in ("w", "b")}
        want |= {f"/heads/{t}/hidden/{i}/{k}"
                 for i in range(len(spec.private_map[t])) for k in ("w", "b")}
    if want != set(flat):
        raise ValueError("param tree mismatch on load")
    return {
        "shared": [layer(f"/shared/{i}") for i in range(len(spec.shared))],
        "heads": {
            t: {
                "hidden": [layer(f"/heads/{t}/hidden/{i}")
                           for i in range(len(spec.private_map[t]))],
                "out": layer(f"/heads/{t}/out"),
            }
            for t in spec.tasks
        },
    }


def save_store(store: DeepMappingStore, path: str) -> None:
    """Write ``store`` to ``path`` in the v2 layout (atomic tmp+rename)."""
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    checksums: Dict[str, int] = {}

    buf = io.BytesIO()
    np.savez(buf, **_flatten_params(store.params))
    write_artifact(tmp, "params.npz", buf.getvalue(), checksums)

    aux_state = store.aux.to_state()
    aux_blob = packb(
        {
            "codec": aux_state["codec"],
            "partition_bytes": aux_state["partition_bytes"],
            "num_values": aux_state["num_values"],
            "partitions": aux_state["partitions"],
            "boundaries": aux_state["boundaries"].tobytes(),
            "part_rows": aux_state["part_rows"],
            "rows": aux_state["rows"],
        }
    )
    write_artifact(tmp, "aux.msgpack", aux_blob, checksums)

    write_artifact(tmp, "vexist.bin", store.vexist.to_bytes(), checksums)

    for col in store.spec.tasks:
        dm = store.codecs[col].decode_map
        if dm.dtype == object:
            dm = dm.astype(str)  # unicode arrays serialize without pickle
        buf = io.BytesIO()
        np.save(buf, dm, allow_pickle=False)
        write_artifact(tmp, f"decode_{col}.npy", buf.getvalue(), checksums)

    meta = {
        "version": FORMAT_VERSION,
        "spec": {
            "base": store.spec.base,
            "width": store.spec.width,
            "shared": list(store.spec.shared),
            "private": [[k, list(v)] for k, v in store.spec.private],
            "out_cards": [[k, v] for k, v in store.spec.out_cards],
            "dtype": store.spec.dtype,
        },
        "encoder": {
            "max_key_capacity": store.encoder.capacity,
            "base": store.encoder.base,
            "residues": list(store.encoder.residues),
        },
        "config": {
            "codec": store.config.codec,
            "partition_bytes": store.config.partition_bytes,
            "base": store.config.base,
        },
        "raw_bytes": store.raw_bytes,
        "num_rows": store.num_rows,
        "modified_bytes": store.modified_bytes,
        "columns": list(store.spec.tasks),
        "checksums": checksums,
    }
    # Meta goes LAST: its presence marks the save complete, so a crash
    # before this point leaves a tmp dir load will never touch.
    with open(os.path.join(tmp, "meta.msgpack"), "wb") as f:
        f.write(pack_meta(meta))
        f.flush()
        os.fsync(f.fileno())
    fsync_dir(tmp)

    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
    fsync_dir(os.path.dirname(os.path.abspath(path)))


def load_store(
    path: str, pool: Optional[MemoryPool] = None, device: DeviceLike = None
) -> DeepMappingStore:
    """Open a store saved by either package onto ``device`` (CUDA by
    default).

    The config is rebuilt as the reference's ``load_store`` rebuilds it
    (``base``, ``codec`` and ``partition_bytes`` from the meta, the rest
    at their defaults).  The defaults differ in one place: the port's
    ``use_kernels`` is True where the reference's ``use_pallas`` is
    False, so a store the port loads serves through the fused lookup
    kernel (K1), and on the CPU through its plain version.  T_aux stays
    as saved: it corrects the model of the package that built the
    store, so answers equal that package's wherever the two packages'
    codes agree (held on every key by ``tests/test_torch_serialize.py``).
    """
    dev = resolve_device(device)
    clean_stale_tmp(path)
    meta = unpack_meta(
        read_artifact(path, "meta.msgpack", None),
        os.path.join(path, "meta.msgpack"),
    )
    if meta["version"] > FORMAT_VERSION:
        raise ValueError(f"store format {meta['version']} newer than reader")
    checksums = meta.get("checksums")  # absent on v1 saves

    s = meta["spec"]
    spec = MLPSpec(
        base=s["base"],
        width=s["width"],
        shared=tuple(s["shared"]),
        private={k: tuple(v) for k, v in s["private"]},
        out_cards={k: v for k, v in s["out_cards"]},
        dtype=s["dtype"],
    )
    with np.load(io.BytesIO(read_artifact(path, "params.npz", checksums))) as z:
        flat = {k: z[k] for k in z.files}
    params = _unflatten_params(flat, spec, dev)

    a = unpackb(read_artifact(path, "aux.msgpack", checksums))
    aux = AuxTable.from_state(
        {
            "codec": a["codec"],
            "partition_bytes": a["partition_bytes"],
            "num_values": a["num_values"],
            "partitions": a["partitions"],
            "boundaries": np.frombuffer(a["boundaries"], dtype=np.int64),
            "part_rows": a["part_rows"],
            "rows": a["rows"],
        },
        pool=pool,
    )

    vexist = BitVector.from_bytes(read_artifact(path, "vexist.bin", checksums))

    codecs: Dict[str, ValueCodec] = {}
    for col in meta["columns"]:
        dm = np.load(
            io.BytesIO(read_artifact(path, f"decode_{col}.npy", checksums)),
            allow_pickle=False,
        )
        codecs[col] = ValueCodec.from_decode_map(col, dm)

    # Reconstruct the KeyEncoder with the same width/base/residues.
    base = meta["encoder"]["base"]
    cap = meta["encoder"]["max_key_capacity"]
    residues = tuple(meta["encoder"].get("residues", ()))
    enc = KeyEncoder(max_key=max(0, cap - 1), base=base, residues=residues)
    if enc.capacity != cap:
        raise RuntimeError(
            f"corrupt manifest: rebuilt encoder capacity {enc.capacity} "
            f"does not match stored capacity {cap}"
        )

    cfg = DeepMappingConfig(
        base=meta["config"]["base"],
        codec=meta["config"]["codec"],
        partition_bytes=meta["config"]["partition_bytes"],
    )
    store = DeepMappingStore(
        encoder=enc,
        spec=spec,
        params=params,
        codecs=codecs,
        aux=aux,
        vexist=vexist,
        raw_bytes=meta["raw_bytes"],
        num_rows=meta["num_rows"],
        config=cfg,
        device=dev,
    )
    store.modified_bytes = meta["modified_bytes"]
    return store
