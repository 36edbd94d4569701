"""Architecture registry: full assigned configs + reduced smoke twins.

The port of ``repro.configs.base``, imports rewritten.

Every assigned architecture registers an :class:`ArchSpec` with
* ``config`` — the EXACT dimensions from the assignment (full scale,
  only ever lowered via ShapeDtypeStruct in the dry-run);
* ``smoke``  — a reduced same-family config for CPU tests;
* ``shapes`` — which assigned input-shape cells apply (decode cells need
  a decoder; ``long_500k`` needs sub-quadratic sequence handling — see
  DESIGN.md §5 for the skip rationale).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from repro_torch.models.config import ModelConfig

# Assigned input shapes (LM shapes are seq_len x global_batch).
SHAPES: Dict[str, Dict] = {
    "train_4k": {"seq_len": 4096, "global_batch": 256, "kind": "train"},
    "prefill_32k": {"seq_len": 32768, "global_batch": 32, "kind": "prefill"},
    "decode_32k": {"seq_len": 32768, "global_batch": 128, "kind": "decode"},
    "long_500k": {"seq_len": 524288, "global_batch": 1, "kind": "decode"},
}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    config: ModelConfig
    smoke: ModelConfig
    shapes: Tuple[str, ...]
    notes: str = ""


_REGISTRY: Dict[str, ArchSpec] = {}


def register(spec: ArchSpec) -> ArchSpec:
    if spec.arch_id in _REGISTRY:
        raise ValueError(f"duplicate arch {spec.arch_id}")
    _REGISTRY[spec.arch_id] = spec
    return spec


def get_arch(arch_id: str) -> ArchSpec:
    # import side-effect registration
    import repro_torch.configs  # noqa: F401

    try:
        return _REGISTRY[arch_id]
    except KeyError:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(_REGISTRY)}") from None


def list_archs() -> Tuple[str, ...]:
    import repro_torch.configs  # noqa: F401

    return tuple(sorted(_REGISTRY))
