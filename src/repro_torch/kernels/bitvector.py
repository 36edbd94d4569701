"""Bind and launch the existence-bitvector test (``csrc/bitvector.cu``).

K3 tests keys against the packed uint32 words:
``bit = (words[k >> 5] >> (k & 31)) & 1``, and 0 for a key outside
``[0, min(32 * n_words, 2**31))``.  One kernel, two entries:
``bitvector_call`` keeps the contract of
``repro.kernels.bitvector.bitvector_call``, which it replaces (a padded
batch of int32 keys, int32 bits); ``bitvector_test_call`` takes the
caller's contiguous int32 or int64 keys as they are and returns bools,
in one launch (``ops.bitvector_test``).

For tensors on the card it launches the CUDA kernel or raises; for
tensors on the CPU it runs the plain version,
``repro_torch.kernels.ref.ref_bitvector_test``.  There is no fallback
between the two.  The source is built at first use by
``repro_torch.kernels.build``.  ``bitvector_call.launches`` counts the
kernel's launches through either entry.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build, ref

SOURCE = "bitvector.cu"


def pack_words32(words) -> np.ndarray:
    """Contiguous uint32 view of a packed existence bit buffer (a
    ``BitVector.words`` array) — the word layout every device existence
    path reads (``bit = (words[k >> 5] >> (k & 31)) & 1``): this
    module's kernel and the fused lookup kernel.  Copied from
    ``repro.kernels.bitvector``."""
    return np.ascontiguousarray(words).view(np.uint32)


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.repro_bitvector_test.argtypes = [p, i, ll, p, ll, p, i, p]
    lib.repro_bitvector_test.restype = ctypes.c_int


def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    return build.library(SOURCE, _bind)


def _check_words(keys: torch.Tensor, words32: torch.Tensor) -> None:
    if words32.dtype != torch.int32 or words32.dim() != 1 or not words32.is_contiguous():
        raise ValueError(f"words32: need a contiguous 1-d int32 tensor, got "
                         f"{tuple(words32.shape)} {words32.dtype}")
    if words32.device != keys.device:
        raise ValueError("keys and words32 must be on one device")


def _launch(keys: torch.Tensor, words32: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """One launch of the instantiation for ``keys``' and ``out``'s types,
    counted on ``bitvector_call.launches``."""
    lib = library()
    with torch.cuda.device(keys.device):
        err = lib.repro_bitvector_test(
            keys.data_ptr(), keys.element_size(), keys.shape[0], words32.data_ptr(),
            words32.shape[0], out.data_ptr(), out.element_size(),
            torch.cuda.current_stream(keys.device).cuda_stream,
        )
    build.raise_on(err, lib, "bitvector")
    build.count_launch(bitvector_call)
    return out


def bitvector_call(keys: torch.Tensor, words32: torch.Tensor, tile_n: int) -> torch.Tensor:
    """keys (N_pad,) int32; words32 (n_words,) int32 view of the packed
    uint32 words, on the keys' device.  Returns (N_pad,) int32 0/1: the
    reference's contract, the kernel's int32 -> int32 instantiation."""
    n = keys.shape[0]
    if n == 0 or n % tile_n != 0:
        raise ValueError(f"batch size {n} must be a positive multiple of tile_n={tile_n}")
    if keys.dtype != torch.int32 or keys.dim() != 1 or not keys.is_contiguous():
        raise ValueError(f"keys: need a contiguous 1-d int32 tensor, got "
                         f"{tuple(keys.shape)} {keys.dtype}")
    _check_words(keys, words32)
    if not keys.is_cuda:
        return ref.ref_bitvector_test(words32, keys)
    return _launch(keys, words32, torch.empty((n,), dtype=torch.int32, device=keys.device))


def bitvector_test_call(keys: torch.Tensor, words32: torch.Tensor) -> torch.Tensor:
    """keys (n,) contiguous int32 or int64, any length and alignment, as
    the caller holds them; words32 as for :func:`bitvector_call`.
    Returns (n,) bool: the kernel's int32/int64 -> bool instantiation,
    one launch with nothing around it."""
    if keys.dtype not in (torch.int32, torch.int64) or keys.dim() != 1 \
            or not keys.is_contiguous():
        raise ValueError(f"keys: need a contiguous 1-d int32 or int64 tensor, got "
                         f"{tuple(keys.shape)} {keys.dtype}")
    _check_words(keys, words32)
    if not keys.is_cuda:
        return ref.ref_bitvector_test(words32, keys).bool()
    out = torch.empty(keys.shape, dtype=torch.bool, device=keys.device)
    return _launch(keys, words32, out) if keys.numel() else out


bitvector_call.launches = 0
