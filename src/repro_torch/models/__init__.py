"""Model substrate: the LM architectures' dense GQA decoders.

The port of ``repro.models``: ``ModelConfig`` (every field of the
reference's) and ``DecoderLM`` for decoders of ``"attn"`` blocks with a
dense FFN, in plain PyTorch (params as trees of tensors, group layers
stacked on a leading dimension).  ``EncDecLM``, MLA + MoE, RWKV, RG-LRU
and the modality frontends wait for ROADMAP item M12c.
"""

from repro_torch.models.config import ModelConfig  # noqa: F401
from repro_torch.models.transformer import DecoderLM  # noqa: F401
