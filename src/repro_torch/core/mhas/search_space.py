"""MHAS search space: weight bank + masked child forward (paper §IV-C1).

The port of ``repro.core.mhas.search_space``.  The space is the paper's
DAG per tree node: up to ``max_layers`` shared hidden layers and up to
``max_layers`` private hidden layers per task, with each hidden layer's
width chosen from ``layer_sizes`` (paper searches [100, 2000]).  A
sampled sub-graph = ``(shared_depth, shared_sizes[..], {task: (depth,
sizes[..])})``.

Weight sharing à la ENAS: one bank of ``(max_width, max_width)``
matrices; a child with width ``s`` uses the first ``s`` columns (mask)
and — because the previous activation is zero beyond its own width —
effectively the first ``prev`` rows.  Masked evaluation is exactly
equivalent to slicing, but keeps every child the same shape: the masked
forward reads the architecture only as tensors (0-d comparisons,
``torch.where``), so no child needs a copy to the host or a branch on
its widths, and the forward stays differentiable with respect to the
bank.

The bank's draws come from a ``torch.Generator`` on the bank's device, so
its numbers differ from the reference's ``jax.random`` draws; the tree
layout, shapes, scale and zero biases are the reference's, and
``repro_torch.core.convert`` carries a bank between the two packages.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core.model import MLPSpec
from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class SearchSpace:
    base: int
    width: int                       # key digit positions
    tasks: Tuple[str, ...]
    out_cards: Tuple[int, ...]       # aligned with tasks
    layer_sizes: Tuple[int, ...] = (100, 200, 400, 800, 1200, 1600, 2000)
    max_layers: int = 2              # paper §V-A6: up to 2 shared + 2 private

    @property
    def feature_dim(self) -> int:
        return self.base * self.width

    @property
    def max_width(self) -> int:
        return max(self.feature_dim, max(self.layer_sizes))

    @property
    def num_size_choices(self) -> int:
        return len(self.layer_sizes)

    @property
    def num_decisions(self) -> int:
        """Controller sequence length: (depth + max_layers sizes) for the
        trunk and for each task."""
        return (1 + self.max_layers) * (1 + len(self.tasks))

    def decision_kinds(self) -> np.ndarray:
        """0 = depth decision (choices: max_layers+1), 1 = size decision."""
        block = [0] + [1] * self.max_layers
        return np.asarray(block * (1 + len(self.tasks)), dtype=np.int32)

    # ------------------------------------------------------------- bank init
    def init_bank(self, seed: int = 0, dtype: torch.dtype = torch.float32,
                  device: DeviceLike = None) -> Dict:
        """He-normal ``(max_width, out)`` matrices and zero biases, drawn
        from a generator on ``device`` seeded with ``seed``, in the
        reference's order: the trunk's layers, then per task its hidden
        layers and its out layer."""
        dev = resolve_device(device)
        mw = self.max_width
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        scale = math.sqrt(2.0 / mw)

        def mat(out_dim):
            w = torch.randn((mw, out_dim), generator=gen, dtype=dtype, device=dev) * scale
            return {"w": w, "b": torch.zeros((out_dim,), dtype=dtype, device=dev)}

        return {
            "trunk": [mat(mw) for _ in range(self.max_layers)],
            "heads": {
                t: {
                    "hidden": [mat(mw) for _ in range(self.max_layers)],
                    "out": mat(card),
                }
                for t, card in zip(self.tasks, self.out_cards)
            },
        }

    # -------------------------------------------------------- arch encoding
    def tokens_to_arch(self, tokens) -> Dict:
        """Controller token sequence -> arch dict with ACTUAL widths.
        ``tokens`` may be the int32 tensor that ``sample_arch`` returns on
        the card: it is copied to the host once."""
        if isinstance(tokens, torch.Tensor):
            tokens = tokens.detach().cpu().numpy()
        tokens = np.asarray(tokens)
        sizes = np.asarray(self.layer_sizes, dtype=np.int32)
        ml = self.max_layers
        arch = {
            "trunk_depth": int(tokens[0]),
            "trunk_sizes": sizes[tokens[1 : 1 + ml] % len(sizes)],
        }
        off = 1 + ml
        heads = {}
        for t in self.tasks:
            heads[t] = {
                "depth": int(tokens[off]),
                "sizes": sizes[tokens[off + 1 : off + 1 + ml] % len(sizes)],
            }
            off += 1 + ml
        arch["heads"] = heads
        return arch

    def arch_arrays(self, arch: Dict, device: DeviceLike = None) -> Dict[str, torch.Tensor]:
        """Arch dict -> fixed-shape int32 tensors on ``device`` (the
        bank's) for the masked forward."""
        dev = resolve_device(device)
        T = len(self.tasks)
        ml = self.max_layers
        head_depth = np.zeros((T,), np.int32)
        head_sizes = np.zeros((T, ml), np.int32)
        for i, t in enumerate(self.tasks):
            head_depth[i] = arch["heads"][t]["depth"]
            head_sizes[i] = arch["heads"][t]["sizes"]
        return {
            "trunk_depth": torch.tensor(int(arch["trunk_depth"]), dtype=torch.int32, device=dev),
            "trunk_sizes": torch.from_numpy(np.asarray(arch["trunk_sizes"], np.int32)).to(dev),
            "head_depth": torch.from_numpy(head_depth).to(dev),
            "head_sizes": torch.from_numpy(head_sizes).to(dev),
        }

    # ------------------------------------------------------- masked forward
    def forward(self, bank: Dict, onehot_pad: torch.Tensor,
                aa: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Masked child forward. ``onehot_pad`` is (n, max_width) — the
        one-hot key features zero-padded to bank width.  Every layer runs
        at the bank's width; the arch enters only as tensors, so the
        forward never waits for the device."""
        iota = torch.arange(self.max_width, device=onehot_pad.device)

        def masked_layer(layer, x, active, size):
            h = torch.relu(x @ layer["w"] + layer["b"])
            h = h * (iota < size)[None, :]
            return torch.where(active, h, x)

        x = onehot_pad
        for i in range(self.max_layers):
            x = masked_layer(
                bank["trunk"][i], x, aa["trunk_depth"] > i, aa["trunk_sizes"][i]
            )
        out = {}
        for ti, t in enumerate(self.tasks):
            h = x
            head = bank["heads"][t]
            for j in range(self.max_layers):
                h = masked_layer(
                    head["hidden"][j], h, aa["head_depth"][ti] > j, aa["head_sizes"][ti, j]
                )
            out[t] = h @ head["out"]["w"] + head["out"]["b"]
        return out

    # ------------------------------------------------- child model metadata
    def child_num_params(self, arch: Dict) -> int:
        """Parameter count of the SLICED child (what Eq. 1's size(M) sees)."""
        total = 0
        d = self.feature_dim
        for i in range(arch["trunk_depth"]):
            h = int(arch["trunk_sizes"][i])
            total += d * h + h
            d = h
        trunk = d
        for t, card in zip(self.tasks, self.out_cards):
            d = trunk
            hd = arch["heads"][t]
            for j in range(hd["depth"]):
                h = int(hd["sizes"][j])
                total += d * h + h
                d = h
            total += d * card + card
        return total

    def child_spec(self, arch: Dict) -> MLPSpec:
        return MLPSpec(
            base=self.base,
            width=self.width,
            shared=tuple(int(s) for s in arch["trunk_sizes"][: arch["trunk_depth"]]),
            private={
                t: tuple(
                    int(s)
                    for s in arch["heads"][t]["sizes"][: arch["heads"][t]["depth"]]
                )
                for t in self.tasks
            },
            out_cards={t: c for t, c in zip(self.tasks, self.out_cards)},
        )

    def extract_child_params(self, bank: Dict, arch: Dict) -> Dict:
        """Slice the bank into a standalone ``repro_torch.core.model``
        param tree on the bank's device (used to warm-start the
        post-search fine-tune — the ENAS payoff).  Every leaf is a
        contiguous copy, detached: the child shares no storage with the
        bank."""
        fd = self.feature_dim

        def take(t):
            return t.detach().clone(memory_format=torch.contiguous_format)

        def first_from_input(layer, out_dim):
            return {
                "w": take(layer["w"][:fd, :out_dim]).reshape(self.width, self.base, out_dim),
                "b": take(layer["b"][:out_dim]),
            }

        def dense(layer, in_dim, out_dim):
            return {"w": take(layer["w"][:in_dim, :out_dim]), "b": take(layer["b"][:out_dim])}

        params: Dict = {"shared": [], "heads": {}}
        d = None
        for i in range(arch["trunk_depth"]):
            h = int(arch["trunk_sizes"][i])
            layer = bank["trunk"][i]
            params["shared"].append(
                first_from_input(layer, h) if d is None else dense(layer, d, h)
            )
            d = h
        trunk_dim = d
        for t, card in zip(self.tasks, self.out_cards):
            hd = arch["heads"][t]
            head = {"hidden": [], "out": None}
            cur = trunk_dim
            for j in range(hd["depth"]):
                h = int(hd["sizes"][j])
                layer = bank["heads"][t]["hidden"][j]
                head["hidden"].append(
                    first_from_input(layer, h) if cur is None else dense(layer, cur, h)
                )
                cur = h
            out_layer = bank["heads"][t]["out"]
            head["out"] = (
                first_from_input(out_layer, card) if cur is None else dense(out_layer, cur, card)
            )
            params["heads"][t] = head
        return params
