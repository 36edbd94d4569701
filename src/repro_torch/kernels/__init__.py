"""Hand-written CUDA kernels of the port, their wrappers and plain versions.

``build`` compiles each source in ``csrc/`` at first use;
``fused_mlp`` launches ``csrc/fused_mlp.cu`` (K1: keys-in lookup; K2:
digits-in MLP) and ``bitvector`` launches ``csrc/bitvector.cu`` (K3:
the existence test); ``ops`` is the wrapper layer with the padding and
tier-budget host half; ``ref`` holds the plain PyTorch versions that
CPU tensors take.
"""

from repro_torch.kernels.ops import (  # noqa: F401
    bitvector_test,
    fused_lookup,
    fused_mlp_codes,
    fused_mlp_logits,
)
