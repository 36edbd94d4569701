"""Bind and launch the existence-bitvector test (``csrc/bitvector.cu``).

``bitvector_call`` is K3; it replaces
``repro.kernels.bitvector.bitvector_call``.  It tests a padded batch of
int32 keys against the packed uint32 words:
``bit = (words[k >> 5] >> (k & 31)) & 1``, and 0 for a key outside
``[0, 32 * n_words)``.

For tensors on the card it launches the CUDA kernel or raises; for
tensors on the CPU it runs the plain version,
``repro_torch.kernels.ref.ref_bitvector_test``.  There is no fallback
between the two.  The source is built at first use by
``repro_torch.kernels.build``.  ``bitvector_call.launches`` counts the
kernel's launches.
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
    p, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.repro_bitvector_test.argtypes = [p, ll, p, ll, p, p]
    lib.repro_bitvector_test.restype = ctypes.c_int


def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    return build.library(SOURCE, _bind)


def bitvector_call(keys: torch.Tensor, words32: torch.Tensor, tile_n: int) -> torch.Tensor:
    """keys (N_pad,) int32; words32 (n_words,) int32 view of the packed
    uint32 words, on the keys' device.  Returns (N_pad,) int32 0/1."""
    n = keys.shape[0]
    if n == 0 or n % tile_n != 0:
        raise ValueError(f"batch size {n} must be a positive multiple of tile_n={tile_n}")
    for name, t in (("keys", keys), ("words32", words32)):
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous 1-d int32 tensor, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if words32.device != keys.device:
        raise ValueError("keys and words32 must be on one device")
    if not keys.is_cuda:
        return ref.ref_bitvector_test(words32, keys)
    lib = library()
    out = torch.empty((n,), dtype=torch.int32, device=keys.device)
    with torch.cuda.device(keys.device):
        err = lib.repro_bitvector_test(
            keys.data_ptr(), n, words32.data_ptr(), words32.shape[0], out.data_ptr(),
            torch.cuda.current_stream(keys.device).cuda_stream,
        )
    build.raise_on(err, lib, "bitvector")
    build.count_launch(bitvector_call)
    return out


bitvector_call.launches = 0
