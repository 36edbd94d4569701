"""Compact multi-task MLP that memorizes key->value mappings (paper §IV-A).

The port of ``repro.core.model``.  Structure: a stack of *shared*
fully-connected layers abstracting the key, then per-value-column
*private* stacks ending in a logits layer (one softmax classifier per
column).

The params tree keeps the reference layout,
``{"shared": [{"w", "b"}], "heads": {task: {"hidden": [...], "out": {...}}}}``,
and the first dense layer from the input is a rank-3 ``(width, base,
out)`` tensor evaluated as a **gather** (sum of rows selected by digit
codes, in position order) — identical to a dense matmul on the one-hot
encoding, which ``forward_onehot`` keeps as the reference path.

:class:`MappingMLP` is the ``nn.Module`` form of the same tree:
``init_params`` builds one (He-normal, from a ``torch.Generator``) and
returns its tree; the functional ``forward_digits`` is what the module,
the engine's plain tiers and the kernels' plain versions all run.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class MLPSpec:
    """Architecture of one hybrid DeepMapping model.

    Hashable: dict-valued fields are normalized to sorted tuples of
    pairs at construction (a copy of the reference's ``MLPSpec``).
    """

    base: int
    width: int
    shared: Tuple[int, ...]
    private: Tuple[Tuple[str, Tuple[int, ...]], ...]
    out_cards: Tuple[Tuple[str, int], ...]
    dtype: str = "float32"

    def __init__(self, base, width, shared, private, out_cards, dtype="float32"):
        if isinstance(private, dict):
            private = tuple(sorted((k, tuple(v)) for k, v in private.items()))
        if isinstance(out_cards, dict):
            out_cards = tuple(sorted(out_cards.items()))
        object.__setattr__(self, "base", int(base))
        object.__setattr__(self, "width", int(width))
        object.__setattr__(self, "shared", tuple(shared))
        object.__setattr__(self, "private", tuple(private))
        object.__setattr__(self, "out_cards", tuple(out_cards))
        object.__setattr__(self, "dtype", dtype)
        if {k for k, _ in self.private} != {k for k, _ in self.out_cards}:
            raise ValueError("private/out_cards task mismatch")
        if not self.out_cards:
            raise ValueError("need at least one task")

    @property
    def tasks(self) -> Tuple[str, ...]:
        return tuple(k for k, _ in self.out_cards)

    @property
    def private_map(self) -> Dict[str, Tuple[int, ...]]:
        return dict(self.private)

    @property
    def card_map(self) -> Dict[str, int]:
        return dict(self.out_cards)

    @property
    def feature_dim(self) -> int:
        return self.base * self.width

    def num_params(self) -> int:
        total = 0
        priv, cards = self.private_map, self.card_map
        d = self.feature_dim
        for h in self.shared:
            total += d * h + h
            d = h
        trunk = d
        for t in self.tasks:
            d = trunk
            for h in priv[t]:
                total += d * h + h
                d = h
            total += d * cards[t] + cards[t]
        return total

    def size_bytes(self) -> int:
        """On-disk model size — Eq. 1's ``size(M)`` (fp32 serialized)."""
        return self.num_params() * np.dtype(self.dtype).itemsize


def torch_dtype(name: str) -> torch.dtype:
    """``MLPSpec.dtype`` string -> torch dtype."""
    return getattr(torch, np.dtype(name).name)


class _Layer(nn.Module):
    """One dense layer: ``w`` is (in, out), or (width, base, out) for
    the first layer from the input; ``b`` is (out,)."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)

    def tree(self) -> Dict[str, torch.Tensor]:
        return {"w": self.w, "b": self.b}


class MappingMLP(nn.Module):
    """The memorization MLP as a module.  Without ``params`` it draws
    He-normal weights from a ``torch.Generator`` seeded with ``seed``
    (drawn on the CPU, so a seed gives the same weights on every
    device); with ``params`` it adopts that tree's tensors."""

    def __init__(
        self,
        spec: MLPSpec,
        seed: int = 0,
        device: DeviceLike = None,
        params: Optional[Dict] = None,
    ):
        super().__init__()
        self.spec = spec
        dev = resolve_device(device)
        if params is None:
            params = _draw_params(spec, seed)
        mk = lambda layer: _Layer(layer["w"].to(dev), layer["b"].to(dev))  # noqa: E731
        self.shared = nn.ModuleList(mk(layer) for layer in params["shared"])
        # ModuleList in spec.tasks order: column names need not be valid
        # attribute names.
        self.hidden = nn.ModuleList(
            nn.ModuleList(mk(layer) for layer in params["heads"][t]["hidden"])
            for t in spec.tasks
        )
        self.out = nn.ModuleList(mk(params["heads"][t]["out"]) for t in spec.tasks)

    def tree(self) -> Dict:
        """The reference-layout params tree over this module's tensors."""
        return {
            "shared": [layer.tree() for layer in self.shared],
            "heads": {
                t: {
                    "hidden": [layer.tree() for layer in self.hidden[i]],
                    "out": self.out[i].tree(),
                }
                for i, t in enumerate(self.spec.tasks)
            },
        }

    def forward(self, digits: torch.Tensor) -> Dict[str, torch.Tensor]:
        return forward_digits(self.tree(), digits, self.spec)


def _draw_params(spec: MLPSpec, seed: int) -> Dict:
    """He-normal init (memorization nets are ReLU stacks), layers drawn
    in the reference's order: shared layers, then per task its hidden
    layers and its out layer."""
    dtype = torch_dtype(spec.dtype)
    gen = torch.Generator(device="cpu").manual_seed(int(seed))

    def dense(in_dim: int, out_dim: int) -> Dict[str, torch.Tensor]:
        w = torch.randn((in_dim, out_dim), generator=gen, dtype=dtype)
        w = w * math.sqrt(2.0 / in_dim)
        return {"w": w, "b": torch.zeros((out_dim,), dtype=dtype)}

    def first_from_input(out_dim: int) -> Dict[str, torch.Tensor]:
        p = dense(spec.feature_dim, out_dim)
        return {"w": p["w"].reshape(spec.width, spec.base, out_dim), "b": p["b"]}

    params: Dict = {"shared": [], "heads": {}}
    d = None
    for h in spec.shared:
        params["shared"].append(first_from_input(h) if d is None else dense(d, h))
        d = h
    priv, cards = spec.private_map, spec.card_map
    for t in spec.tasks:
        head: Dict = {"hidden": [], "out": None}
        hd = d
        for h in priv[t]:
            head["hidden"].append(first_from_input(h) if hd is None else dense(hd, h))
            hd = h
        head["out"] = (
            first_from_input(cards[t]) if hd is None else dense(hd, cards[t])
        )
        params["heads"][t] = head
    return params


def init_params(spec: MLPSpec, seed: int = 0, device: DeviceLike = None) -> Dict:
    """Initialize parameters as a plain tensor tree (no autograd).
    First layer from input is (width, base, out)."""
    module = MappingMLP(spec, seed=seed, device=device)
    return _map_tree(module.tree(), lambda t: t.detach())


def _map_tree(tree: Dict, fn) -> Dict:
    return {
        "shared": [{k: fn(v) for k, v in layer.items()} for layer in tree["shared"]],
        "heads": {
            t: {
                "hidden": [{k: fn(v) for k, v in layer.items()} for layer in head["hidden"]],
                "out": {k: fn(v) for k, v in head["out"].items()},
            }
            for t, head in tree["heads"].items()
        },
    }


def _leaves(tree: Dict):
    for layer in tree["shared"]:
        yield layer["w"]
        yield layer["b"]
    for head in tree["heads"].values():
        for layer in head["hidden"]:
            yield layer["w"]
            yield layer["b"]
        yield head["out"]["w"]
        yield head["out"]["b"]


def _apply(layer: Dict, x: Optional[torch.Tensor], digits: torch.Tensor) -> torch.Tensor:
    w = layer["w"]
    if w.dim() == 3:
        # Gather path: rows selected by digit codes, summed in position
        # order (the order the fused kernels use), then the bias.
        if x is not None:
            raise ValueError("rank-3 layer must be first from input")
        idx = digits.long()
        acc = w[0][idx[:, 0]]
        for p in range(1, w.shape[0]):
            acc = acc + w[p][idx[:, p]]
        return acc + layer["b"]
    return x @ w + layer["b"]


def forward_digits(params: Dict, digits: torch.Tensor, spec: MLPSpec) -> Dict[str, torch.Tensor]:
    """digits (n, width) int -> {task: (n, card) logits}. Gather path."""
    x = None
    for layer in params["shared"]:
        x = torch.relu(_apply(layer, x, digits))
    out = {}
    for t in spec.tasks:
        head = params["heads"][t]
        h = x
        for layer in head["hidden"]:
            h = torch.relu(_apply(layer, h, digits))
        out[t] = _apply(head["out"], h, digits)
    return out


def _apply_onehot(layer: Dict, x, onehot: torch.Tensor) -> torch.Tensor:
    w = layer["w"]
    if w.dim() == 3:
        if x is not None:
            raise ValueError("rank-3 layer must be first from input")
        return onehot @ w.reshape(-1, w.shape[-1]) + layer["b"]
    return x @ w + layer["b"]


def forward_onehot(params: Dict, onehot: torch.Tensor, spec: MLPSpec) -> Dict[str, torch.Tensor]:
    """Reference path: identical math on materialized one-hot features."""
    x = None
    for layer in params["shared"]:
        x = torch.relu(_apply_onehot(layer, x, onehot))
    out = {}
    for t in spec.tasks:
        head = params["heads"][t]
        h = x
        for layer in head["hidden"]:
            h = torch.relu(_apply_onehot(layer, h, onehot))
        out[t] = _apply_onehot(head["out"], h, onehot)
    return out


def predict_codes(params: Dict, digits: torch.Tensor, spec: MLPSpec) -> torch.Tensor:
    """argmax per task -> (n, m) int32 codes, tasks in spec.tasks order
    (ties go to the lowest index, as ``jnp.argmax``)."""
    logits = forward_digits(params, digits, spec)
    return torch.stack(
        [torch.argmax(logits[t], dim=-1) for t in spec.tasks], dim=1
    ).to(torch.int32)


def count_params(params: Dict) -> int:
    return sum(int(t.numel()) for t in _leaves(params))


def model_size_bytes(params: Dict) -> int:
    return sum(int(t.numel()) * t.element_size() for t in _leaves(params))
