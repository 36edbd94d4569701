"""Atomic, keep-k checkpointing of state trees: the port of
``repro.train.checkpoint``, in the reference's on-disk layout::

    ckpt_dir/
      step_00000100/
        manifest.json        — step, shapes, dtypes, a structure string
        arrays.npz           — flattened path -> host array
      step_00000200/ ...
      LATEST                 — last durable step (written after rename)

Writes go to ``<dir>.tmp`` then ``os.rename`` (atomic on POSIX), so a
crash mid-write never corrupts the latest durable checkpoint.
``AsyncCheckpointer`` snapshots to host memory synchronously and writes
on a background thread.

Each package opens the other's files.  The ``arrays.npz`` keys are the
reference's ``_flatten`` paths: dict keys (sorted, as ``jax.tree_util``
walks them), list indices as integers, NamedTuple fields as ``.name``
(JAX's ``GetAttrKey``), joined by ``/``; a ``None`` subtree gives no
leaf.  So a ``TrainState`` gives ``.params/…``, ``.opt/.step``,
``.opt/.mu/…`` and ``.opt/.nu/…``.  Every array is written as the
reference's ``np.savez`` writes it, member for member.  A bfloat16 leaf
is the raw 2-byte record ``np.savez`` makes of an ``ml_dtypes`` array
(descr ``<V2``), with ``"bfloat16"`` in the manifest; the restore reads
that dtype name and views the bits as ``torch.bfloat16``, bit for bit,
with no ``ml_dtypes``.  (The reference's own restore cannot cast that
record back and raises ``ValueError``.)  The manifest's ``treedef`` is
informative only: the reference writes JAX's ``PyTreeDef`` string there,
the port a structure string of its own, and neither restore reads it.

Restore builds the tree of ``like`` (tensors, numpy arrays or scalars):
each leaf on ``device`` when one is given, else on the device of
``like``'s tensor leaf (the CPU for a numpy leaf), in ``like``'s dtype.
The reference's ``shardings=`` becomes ``device=``; restoring onto
several GPUs waits for ROADMAP item M12d.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import zipfile
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.convert import BF16_BITS
from repro_torch.device import DeviceLike

#: npy header descr of a bf16 leaf, as ``np.savez`` writes ``ml_dtypes.bfloat16``.
BF16_DESCR = "<V2"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _rebuild(tree, fn: Callable[[str, Any], Any], path: Tuple[str, ...] = ()):
    """``tree``'s structure with every leaf replaced by ``fn(key, leaf)``,
    walked in ``jax.tree_util`` order; ``key`` is the reference's path
    string.  ``None`` subtrees stay ``None`` and call nothing."""
    if tree is None:
        return None
    if _is_namedtuple(tree):
        return type(tree)(*(_rebuild(getattr(tree, f), fn, path + ("." + f,))
                            for f in tree._fields))
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], fn, path + (str(k),)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, fn, path + (str(i),)) for i, v in enumerate(tree))
    return fn("/".join(path), tree)


def _structure(tree) -> str:
    """The port's informative stand-in for JAX's ``PyTreeDef`` string."""
    if tree is None:
        return "None"
    if _is_namedtuple(tree):
        return f"{type(tree).__name__}(" + ", ".join(
            f"{f}={_structure(getattr(tree, f))}" for f in tree._fields) + ")"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_structure(v) for v in tree)
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    return "*"


def _is_bf16(a: np.ndarray) -> bool:
    return a.dtype.name == "bfloat16" or (a.dtype.metadata or {}).get("dtype") == "bfloat16"


def _host(leaf) -> np.ndarray:
    """A leaf as a host numpy array; bf16 as its ``uint16`` bits
    (:data:`~repro_torch.core.convert.BF16_BITS`)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(BF16_BITS)
        return t.numpy()
    a = np.asarray(leaf)
    return a.view(BF16_BITS) if _is_bf16(a) else a


def _flatten(tree) -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {}

    def put(key, leaf):
        flat[key] = _host(leaf)

    _rebuild(tree, put)
    return flat


def _write_npz(path: str, flat: Dict[str, np.ndarray]) -> None:
    """``np.savez(path, **flat)``, member for member, with bf16 leaves
    under the reference's ``<V2`` header."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, arr in flat.items():
            bf16 = _is_bf16(arr)
            arr = np.require(arr.view(np.uint16) if bf16 else arr, requirements="C")
            header = np.lib.format.header_data_from_array_1_0(arr)
            if bf16:
                header["descr"] = BF16_DESCR
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                np.lib.format.write_array_header_1_0(fid, header)
                fid.write(arr.reshape(-1).view(np.uint8))


def save_checkpoint(ckpt_dir: str, step: int, state, keep: int = 3) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    name = f"step_{step:08d}"
    final = os.path.join(ckpt_dir, name)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    flat = _flatten(state)
    _write_npz(os.path.join(tmp, "arrays.npz"), flat)
    manifest = {
        "step": step,
        "format": 1,
        "treedef": _structure(state),
        "arrays": {k: {"shape": list(v.shape),
                       "dtype": "bfloat16" if _is_bf16(v) else str(v.dtype)}
                   for k, v in flat.items()},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    with open(os.path.join(ckpt_dir, "LATEST.tmp"), "w") as f:
        f.write(name)
    os.replace(os.path.join(ckpt_dir, "LATEST.tmp"), os.path.join(ckpt_dir, "LATEST"))
    _prune(ckpt_dir, keep)
    return final


def _prune(ckpt_dir: str, keep: int) -> None:
    steps = sorted(
        d for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp")
    )
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def list_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(
        int(d.split("_")[1])
        for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp")
    )


def _torch_dtype(like) -> torch.dtype:
    if isinstance(like, torch.Tensor):
        return like.dtype
    a = np.asarray(like)
    if _is_bf16(a):
        return torch.bfloat16
    return torch.from_numpy(np.zeros((), dtype=a.dtype)).dtype


def _restore_leaf(arr: np.ndarray, dtype_name: Optional[str], like,
                  device: Optional[torch.device]) -> torch.Tensor:
    arr = np.require(arr, requirements="C")
    if dtype_name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    dev = device if device is not None else (
        like.device if isinstance(like, torch.Tensor) else torch.device("cpu"))
    return t.to(device=dev, dtype=_torch_dtype(like))


def restore_checkpoint(ckpt_dir: str, step: int, like, device: DeviceLike = None):
    """Restore into the structure of ``like`` (a tree of tensors, numpy
    arrays or scalars; only shapes, dtypes and devices are read): a tree
    of tensors on ``device``, or each on ``like``'s leaf's device."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        dtypes = {k: v["dtype"] for k, v in json.load(f)["arrays"].items()}
    dev = torch.device(device) if device is not None else None
    with np.load(os.path.join(path, "arrays.npz")) as z:

        def leaf(key, like_leaf):
            arr = z[key]
            shape = tuple(like_leaf.shape) if hasattr(like_leaf, "shape") else ()
            if tuple(arr.shape) != shape:
                raise ValueError(f"shape mismatch at {key}: {arr.shape} vs {shape}")
            return _restore_leaf(arr, dtypes.get(key), like_leaf, dev)

        return _rebuild(like, leaf)


def skeleton(tree) -> Tuple[Any, Optional[torch.device]]:
    """A restore's ``like`` and ``device`` for ``tree`` that keep none of
    its storage alive: each tensor leaf becomes an empty one of its shape
    and dtype on the ``meta`` device, other leaves stay as they are, and
    the device is the one its tensors lie on (None when it holds none).
    The reference takes a host copy of the state for this."""
    devices = set()

    def leaf(_key, t):
        if not isinstance(t, torch.Tensor):
            return t
        devices.add(t.device)
        return torch.empty(t.shape, dtype=t.dtype, device="meta")

    like = _rebuild(tree, leaf)
    if len(devices) > 1:
        raise ValueError(f"a state on several devices ({sorted(map(str, devices))}): restoring "
                         "onto several GPUs is not ported yet (ROADMAP item M12d)")
    return like, next(iter(devices), None)


def restore_latest(ckpt_dir: str, like, device: DeviceLike = None) -> Tuple[Optional[int], Any]:
    latest = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(latest):
        return None, None
    with open(latest) as f:
        name = f.read().strip()
    step = int(name.split("_")[1])
    return step, restore_checkpoint(ckpt_dir, step, like, device)


class AsyncCheckpointer:
    """Snapshot-to-host synchronously, write-to-disk on a worker thread."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None

    def save(self, step: int, state) -> None:
        self.wait()
        host_state = _rebuild(state, lambda _k, leaf: _host(leaf))  # device->host snapshot

        def work():
            try:
                save_checkpoint(self.ckpt_dir, step, host_state, keep=self.keep)
            except BaseException as e:  # noqa: BLE001 — surfaced on wait()
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err
