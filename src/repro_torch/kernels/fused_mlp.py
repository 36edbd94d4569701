"""Build, bind and launch the fused CUDA kernels (``csrc/fused_mlp.cu``).

Two entry points share the kernel source's one device forward:

* ``fused_mlp_call``    — digits in, codes or logits out (K2; replaces
  ``repro.kernels.fused_mlp.fused_mlp_call``);
* ``fused_lookup_call`` — raw int32 keys in, per-task codes, existence
  bits and optional predicate match bits out, in one launch (K1;
  replaces ``repro.kernels.fused_mlp.fused_lookup_call``).

For tensors on the card each call launches its CUDA kernel or raises;
for tensors on the CPU it runs the plain version in
``repro_torch.kernels.ref``.  There is no fallback between the two:
a build or launch failure raises.

The source is compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``, under
``build/repro_torch_kernels/`` at the root of the checkout
(``REPRO_TORCH_BUILD_DIR`` overrides).  The library's file name carries
a hash of the source and flags, so an edited source is rebuilt.  Each
call function counts its launches in ``<function>.launches``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.model import MLPSpec
from repro_torch.kernels import ref

CSRC = Path(__file__).resolve().parents[1] / "csrc" / "fused_mlp.cu"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
#: Kernel limits fixed by the C interface's by-value model descriptor.
MAX_LAYERS = 64
MAX_HEADS = 32
MAX_PREDS = 8

#: What the last build did: seconds (None when the library was cached),
#: the library path and nvcc's output (``-Xptxas -v``: registers, spills).
BUILD_INFO: dict = {"seconds": None, "path": None, "log": ""}

_LIB: Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR", "").strip()
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        cand = Path(root) / "bin" / "nvcc"
        if root and cand.exists():
            return str(cand)
    raise RuntimeError("nvcc not found: the fused kernels are built at first use")


def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        tag = hashlib.sha1(CSRC.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        out = build_dir() / f"libfused_mlp-{tag}.so"
        if not out.exists():
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) on {CSRC}:\n{proc.stdout}{proc.stderr}"
                )
            os.replace(tmp, out)
            BUILD_INFO["seconds"] = time.perf_counter() - t0
            BUILD_INFO["log"] = proc.stdout + proc.stderr
        BUILD_INFO["path"] = str(out)
        lib = ctypes.CDLL(str(out))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        model = [p, p, p, i, i, p, i, i, i, i, i]
        lib.repro_fused_lookup.argtypes = model + [
            p, i, p, ll, p, i, i, p, p, i, p, p, p, p,
        ]
        lib.repro_fused_lookup.restype = i
        lib.repro_fused_mlp.argtypes = model + [p, i, i, p, p, p]
        lib.repro_fused_mlp.restype = i
        lib.repro_error_string.argtypes = [i]
        lib.repro_error_string.restype = ctypes.c_char_p
        _LIB = lib
        return lib


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class _ModelArgs:
    """Host descriptor arrays of one padded model, in the C interface's
    order; the arrays stay alive for the call."""

    def __init__(self, flat: Sequence[torch.Tensor], spec: MLPSpec, base_pad: int):
        trunk_kinds, head_kinds = ref._plan(spec)
        n_layers = len(flat) // 2
        if len(flat) != 2 * n_layers or n_layers != len(trunk_kinds) + sum(
            len(k) for k in head_kinds.values()
        ):
            raise ValueError("flat weights do not match the spec's layer plan")
        if n_layers > MAX_LAYERS or len(spec.tasks) > MAX_HEADS:
            raise ValueError(
                f"the fused kernels take at most {MAX_LAYERS} layers and "
                f"{MAX_HEADS} heads per launch; got {n_layers} and {len(spec.tasks)}"
            )
        dev = flat[0].device
        for w in flat:
            if w.device != dev or w.dtype != torch.float32 or not w.is_contiguous():
                raise ValueError("flat weights must be contiguous float32 on one device")
        self.w_ptrs = np.array([flat[2 * i].data_ptr() for i in range(n_layers)], np.int64)
        self.b_ptrs = np.array([flat[2 * i + 1].data_ptr() for i in range(n_layers)], np.int64)
        self.info = np.zeros((n_layers, 4), np.int32)
        self.heads = np.zeros((len(spec.tasks), 4), np.int32)
        widths = list(spec.shared)
        li = 0

        def add(in_dim: Optional[int], out_dim: int) -> None:
            nonlocal li
            w = flat[2 * li]
            embed = in_dim is None
            if embed and tuple(w.shape) != (spec.width, base_pad, w.shape[2]):
                raise ValueError(f"layer {li}: gather weights {tuple(w.shape)} mismatch")
            if not embed and (w.dim() != 2 or w.shape[0] < _round_up(in_dim, 4)):
                raise ValueError(f"layer {li}: dense weights {tuple(w.shape)} mismatch")
            ld = w.shape[-1]
            if ld < out_dim or flat[2 * li + 1].shape[0] != ld:
                raise ValueError(f"layer {li}: padded width {ld} < {out_dim}")
            self.info[li] = (in_dim or 0, out_dim, ld, int(embed))
            li += 1

        d = None
        for h in spec.shared:
            add(d, h)
            d = h
        priv, cards = spec.private_map, spec.card_map
        for ti, t in enumerate(spec.tasks):
            first, hd = li, d
            for h in priv[t]:
                add(hd, h)
                widths.append(h)
                hd = h
            add(hd, cards[t])
            self.heads[ti] = (first, li - first, cards[t], flat[2 * li - 2].shape[-1])
        self.n_layers = n_layers
        self.n_trunk = len(spec.shared)
        self.n_heads = len(spec.tasks)
        self.width = spec.width
        self.base = spec.base
        self.base_pad = base_pad
        self.hstride = _round_up(max(widths, default=4), 4)

    def args(self) -> list:
        return [
            self.w_ptrs.ctypes.data, self.b_ptrs.ctypes.data, self.info.ctypes.data,
            self.n_layers, self.n_trunk, self.heads.ctypes.data, self.n_heads,
            self.width, self.base, self.base_pad, self.hstride,
        ]


def _check(t: Optional[torch.Tensor], name: str, dev: torch.device, dtype, ndim: int) -> None:
    if t is None:
        raise ValueError(f"{name} is required")
    if t.device != dev or t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(
            f"{name}: need a contiguous {ndim}-d {dtype} tensor on {dev}, got "
            f"{tuple(t.shape)} {t.dtype} on {t.device}"
        )


#: What the C entries return when they refuse a model before launching.
#: The Python checks rule out the other causes (layer, head and predicate
#: counts), which leaves an activation tile too large for shared memory.
_CUDA_ERROR_INVALID_VALUE = 1


def _raise_on(err: int, lib: ctypes.CDLL, what: str, margs: _ModelArgs) -> None:
    if err == 0:
        return
    hint = ""
    if err == _CUDA_ERROR_INVALID_VALUE:
        hint = (f"; hidden width {margs.hstride} may leave no activation tile that "
                f"fits the 227 KB of shared memory a block may use")
    raise RuntimeError(
        f"{what} kernel launch failed: CUDA error {err} "
        f"({lib.repro_error_string(err).decode()}){hint}"
    )


def fused_mlp_call(
    digits: torch.Tensor,
    flat_weights: Sequence[torch.Tensor],
    spec: MLPSpec,
    tile_n: int,
    base_pad: int,
    card_pads: Tuple[Tuple[str, int], ...],
    emit_codes: bool,
):
    """digits (N_pad, width) int32; flat_weights in plan order (padded).

    Returns ``(N_pad, m)`` int32 codes if ``emit_codes`` else a tuple of
    ``(N_pad, card_pad)`` float32 logits, one per task.
    """
    n = digits.shape[0]
    if n == 0 or n % tile_n != 0:
        raise ValueError(f"batch size {n} must be a positive multiple of tile_n={tile_n}")
    if not digits.is_cuda:
        return ref.fused_mlp(digits, flat_weights, spec, emit_codes)
    dev = digits.device
    _check(digits, "digits", dev, torch.int32, 2)
    if digits.shape[1] != spec.width:
        raise ValueError(f"digits width {digits.shape[1]} != spec width {spec.width}")
    margs = _ModelArgs(flat_weights, spec, base_pad)
    if flat_weights[0].device != dev:
        raise ValueError("weights and digits must be on one device")
    lib = library()
    m = len(spec.tasks)
    codes = None
    logits: Tuple[torch.Tensor, ...] = ()
    logit_ptrs = None
    if emit_codes:
        codes = torch.empty((n, m), dtype=torch.int32, device=dev)
    else:
        logits = tuple(
            torch.empty((n, cp), dtype=torch.float32, device=dev) for _, cp in card_pads
        )
        logit_ptrs = np.array([t.data_ptr() for t in logits], np.int64)
    with torch.cuda.device(dev):
        err = lib.repro_fused_mlp(
            *margs.args(), digits.data_ptr(), n, int(emit_codes),
            codes.data_ptr() if codes is not None else None,
            logit_ptrs.ctypes.data if logit_ptrs is not None else None,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(err, lib, "fused_mlp", margs)
    fused_mlp_call.launches += 1
    return codes if emit_codes else logits


fused_mlp_call.launches = 0


def fused_lookup_call(
    keys: torch.Tensor,
    pos_ops: torch.Tensor,
    words32: Optional[torch.Tensor],
    flat_weights: Sequence[torch.Tensor],
    spec: MLPSpec,
    tile_n: int,
    base_pad: int,
    capacity: int,
    pred_tables: Sequence[torch.Tensor] = (),
    pred_tasks: Sequence[int] = (),
    with_exists: bool = True,
):
    """keys (N_pad,) int32 (padding -1); pos_ops (width, 2) int32
    ``[(mod, div)...]``; words32 (n_words,) int32 view of the packed
    uint32 words (None when ``with_exists=False``); flat_weights in plan
    order (padded); pred_tables one padded int32 0/1 vector per
    predicate, indexed by the code of head ``pred_tasks[j]``.

    Returns ``(codes, exists, match)``: codes (N_pad, m) int32; exists
    (N_pad,) int32 or None without ``with_exists``; match (N_pad,) int32
    or None without ``pred_tables``.
    """
    n = keys.shape[0]
    if n == 0 or n % tile_n != 0:
        raise ValueError(f"batch size {n} must be a positive multiple of tile_n={tile_n}")
    if pred_tables and not with_exists:
        raise ValueError("in-kernel predicate filtering requires with_exists")
    if len(pred_tables) != len(pred_tasks):
        raise ValueError("one pred_task per pred_table")
    if not keys.is_cuda:
        return ref.fused_lookup(
            keys, pos_ops, words32, flat_weights, spec, capacity,
            pred_tables, pred_tasks, with_exists,
        )
    dev = keys.device
    _check(keys, "keys", dev, torch.int32, 1)
    _check(pos_ops, "pos_ops", dev, torch.int32, 2)
    if tuple(pos_ops.shape) != (spec.width, 2):
        raise ValueError(f"pos_ops shape {tuple(pos_ops.shape)} != ({spec.width}, 2)")
    if with_exists:
        _check(words32, "words32", dev, torch.int32, 1)
    if len(pred_tables) > MAX_PREDS:
        raise ValueError(f"at most {MAX_PREDS} predicate tables per launch")
    cards = spec.card_map
    for tb, ti in zip(pred_tables, pred_tasks):
        _check(tb, "pred table", dev, torch.int32, 1)
        if not 0 <= ti < len(spec.tasks) or tb.shape[0] < cards[spec.tasks[ti]]:
            raise ValueError(f"pred table for head {ti} is shorter than its card")
    margs = _ModelArgs(flat_weights, spec, base_pad)
    if flat_weights[0].device != dev:
        raise ValueError("weights and keys must be on one device")
    lib = library()
    codes = torch.empty((n, len(spec.tasks)), dtype=torch.int32, device=dev)
    exists = torch.empty((n,), dtype=torch.int32, device=dev) if with_exists else None
    match = torch.empty((n,), dtype=torch.int32, device=dev) if pred_tables else None
    pred_ptrs = np.array([t.data_ptr() for t in pred_tables] or [0], np.int64)
    pred_idx = np.array(list(pred_tasks) or [0], np.int32)
    with torch.cuda.device(dev):
        err = lib.repro_fused_lookup(
            *margs.args(), keys.data_ptr(), n, pos_ops.data_ptr(), int(capacity),
            words32.data_ptr() if with_exists else None,
            words32.shape[0] if with_exists else 0, int(with_exists),
            pred_ptrs.ctypes.data, pred_idx.ctypes.data, len(pred_tables),
            codes.data_ptr(), exists.data_ptr() if exists is not None else None,
            match.data_ptr() if match is not None else None,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(err, lib, "fused_lookup", margs)
    fused_lookup_call.launches += 1
    return codes, exists, match


fused_lookup_call.launches = 0
