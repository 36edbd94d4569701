"""Model substrate: the LM architectures' decoders.

The port of ``repro.models``: ``ModelConfig`` (every field of the
reference's) and ``DecoderLM`` for decoders of ``"attn"`` blocks with a
dense FFN, RWKV6 (``"rwkv"``) and RG-LRU (``"rglru"``) blocks
(:mod:`.ssm`), in plain PyTorch (params as trees of tensors, group
layers stacked on a leading dimension).  MLA + MoE wait for ROADMAP item
M12c-2; ``EncDecLM`` and the modality frontends for M12c-3.
"""

from repro_torch.models.config import ModelConfig  # noqa: F401
from repro_torch.models.transformer import DecoderLM  # noqa: F401
