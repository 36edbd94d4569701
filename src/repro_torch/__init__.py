"""DeepMapping in PyTorch and CUDA: the port of the JAX package ``repro``.

It imports ``torch`` and ``numpy``, never ``jax`` and nothing of
``repro``.  Entry points (``DeepMappingStore.build``,
``InferenceEngine``) run on the CUDA device unless given ``device=``;
without a GPU they raise.  The fused lookup and fused MLP kernels are
hand-written CUDA (``csrc/fused_mlp.cu``), built with ``nvcc`` at first
use.
"""

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
