"""DeepMapping in PyTorch and CUDA: the port of the JAX package ``repro``.

It imports ``torch`` and ``numpy``, never ``jax`` and nothing of
``repro``.  Entry points (``repro_torch.open``, ``repro_torch.build``,
``DeepMappingStore.build``/``load``, ``InferenceEngine``) run on the
CUDA device unless given ``device=``; without a GPU they raise.  The
fused lookup and fused MLP kernels are hand-written CUDA
(``csrc/fused_mlp.cu``), built with ``nvcc`` at first use.

- ``repro_torch.open(path)``           — load a store or cluster saved
                                         by either package (the
                                         reference's v2 directory layout
                                         and cluster manifest).
- ``repro_torch.build(table, config)`` — build a single store, or a
                                         sharded cluster with
                                         ``cluster=ClusterConfig(...)``.
- ``store.query()...execute()``        — the plan-based query layer.
- ``repro_torch.serve.LookupServer``   — the batched lookup server over
                                         any store, cluster or
                                         federation.
- ``python -m repro_torch.launch.serve`` — build or load a store and
                                         serve synthetic requests.
"""

from repro_torch.api.entry import build, open  # noqa: F401,A004
from repro_torch.core import (  # noqa: F401
    DeepMappingConfig,
    DeepMappingStore,
    InferenceEngine,
    MLPSpec,
    Table,
    init_params,
)
from repro_torch.core.convert import params_from_numpy, params_to_numpy  # noqa: F401

__version__ = "0.1.0"
