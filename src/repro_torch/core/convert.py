"""Carry model weights between the two packages.

``jax.random`` and ``torch.Generator`` draw different numbers from the
same seed, so the tests hand the reference's params (leaves as numpy
arrays, via ``jax.device_get``) to the port with
:func:`params_from_numpy`.  :func:`params_to_numpy` is its inverse.
Both keep the reference tree layout unchanged, and carry any tree of
dicts and lists the same way: the MHAS weight bank, the controller's
parameters, and the LM substrate's params and caches (stacked group
leaves keep their leading group dimension; ``None`` subtrees stay
``None``).

bfloat16: the reference hands out bf16 leaves as ``ml_dtypes`` arrays,
which ``torch.from_numpy`` refuses.  :func:`params_from_numpy` finds
them by the dtype's name (``"bfloat16"``; this module imports no
``ml_dtypes``) and carries them bit for bit as ``uint16`` viewed as
``torch.bfloat16``.  :func:`params_to_numpy` returns a bf16 leaf as its
``uint16`` bit patterns, the dtype name recorded in the array dtype's
metadata (``{"dtype": "bfloat16"}``), which :func:`params_from_numpy`
reads back; ``arr.view(ml_dtypes.bfloat16)`` gives the reference's
leaf.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.model import _map_tree
from repro_torch.device import DeviceLike, resolve_device

#: numpy dtype of a bf16 leaf handed out by :func:`params_to_numpy`.
BF16_BITS = np.dtype(np.uint16, metadata={"dtype": "bfloat16"})


def _is_bf16(a: np.ndarray) -> bool:
    return a.dtype.name == "bfloat16" or (a.dtype.metadata or {}).get("dtype") == "bfloat16"


def _leaf_from_numpy(a, dev: torch.device):
    if a is None:
        return None
    a = np.array(a, copy=True)
    if _is_bf16(a):
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(dev)
    return torch.from_numpy(a).to(dev)


def _leaf_to_numpy(t):
    if t is None:
        return None
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16_BITS)
    return t.numpy()


def params_from_numpy(tree: Dict, device: DeviceLike = None) -> Dict:
    """Numpy-leaf params tree -> the port's tensor tree on ``device``."""
    dev = resolve_device(device)
    return _map_tree(tree, lambda a: _leaf_from_numpy(a, dev))


def params_to_numpy(tree: Dict) -> Dict:
    """The port's tensor tree -> numpy-leaf tree (host copies); bf16
    leaves as ``uint16`` bit patterns of dtype :data:`BF16_BITS`."""
    return _map_tree(tree, _leaf_to_numpy)
