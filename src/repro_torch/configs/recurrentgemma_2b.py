"""recurrentgemma-2b — RG-LRU + local attention, pattern 1 attn : 2
recurrent [arXiv:2402.19427].  26L d_model=2560 10H (GQA kv=1, head 256)
d_ff=7680 vocab=256000, local window 2048.  Constant recurrent state +
bounded window -> ``long_500k`` applies."""

from repro_torch.configs.base import ArchSpec, register
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256_000,
    block_pattern=("rglru", "rglru", "attn"),
    window_pattern=(0, 0, 2048),
    rglru_dim=2560,
    conv_width=4,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="rg-smoke",
    family="hybrid",
    num_layers=5,  # 1 full group + 2 remainder: exercises both paths
    d_model=40,
    num_heads=2,
    num_kv_heads=1,
    head_dim=20,
    d_ff=80,
    vocab_size=128,
    block_pattern=("rglru", "rglru", "attn"),
    window_pattern=(0, 0, 8),
    rglru_dim=40,
    tie_embeddings=True,
    dtype="float32",
    remat="none",
)

SPEC = register(
    ArchSpec(
        arch_id="recurrentgemma-2b",
        config=CONFIG,
        smoke=SMOKE,
        shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
        notes="Hybrid: RG-LRU state + 2048-window attn; long_500k applies.",
    )
)
