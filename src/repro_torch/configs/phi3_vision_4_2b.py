"""phi-3-vision-4.2b — phi3-mini backbone + CLIP frontend (stubbed)
[hf:microsoft/Phi-3-vision-128k-instruct].  32L d_model=3072 32H
(kv=32 -> MHA) d_ff=8192 vocab=32064.  ``input_specs`` supplies
precomputed patch embeddings merged as a sequence prefix."""

from repro_torch.configs.base import ArchSpec, register
from repro_torch.models.config import ModelConfig

NUM_PATCHES = 576  # 336px CLIP ViT-L/14 -> 24x24 patches

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    modality="vision",
)

SMOKE = ModelConfig(
    name="phi3v-smoke",
    family="dense",
    num_layers=2,
    d_model=48,
    num_heads=4,
    num_kv_heads=4,
    d_ff=96,
    vocab_size=128,
    modality="vision",
    dtype="float32",
    remat="none",
)

SPEC = register(
    ArchSpec(
        arch_id="phi-3-vision-4.2b",
        config=CONFIG,
        smoke=SMOKE,
        shapes=("train_4k", "prefill_32k", "decode_32k"),
        notes="VLM: text backbone + stub patch embeds; full attention -> long_500k skipped.",
    )
)
