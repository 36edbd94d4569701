"""Hand-written CUDA kernels of the port, their wrappers and plain versions.

``fused_mlp`` builds and launches ``csrc/fused_mlp.cu`` (K1: keys-in
lookup; K2: digits-in MLP); ``ops`` is the wrapper layer with the
padding and tier-budget host half; ``ref`` holds the plain PyTorch
versions that CPU tensors take.
"""

from repro_torch.kernels.ops import (  # noqa: F401
    fused_lookup,
    fused_mlp_codes,
    fused_mlp_logits,
)
