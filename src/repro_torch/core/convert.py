"""Carry model weights between the two packages.

``jax.random`` and ``torch.Generator`` draw different numbers from the
same seed, so the tests hand the reference's params (leaves as numpy
arrays, via ``jax.device_get``) to the port with
:func:`params_from_numpy`.  :func:`params_to_numpy` is its inverse.
Both keep the reference tree layout unchanged.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.model import _map_tree
from repro_torch.device import DeviceLike, resolve_device


def params_from_numpy(tree: Dict, device: DeviceLike = None) -> Dict:
    """Numpy-leaf params tree -> the port's tensor tree on ``device``."""
    dev = resolve_device(device)
    return _map_tree(
        tree, lambda a: torch.from_numpy(np.array(a, copy=True)).to(dev)
    )


def params_to_numpy(tree: Dict) -> Dict:
    """The port's tensor tree -> numpy-leaf tree (host copies)."""
    return _map_tree(tree, lambda t: t.detach().cpu().numpy())
