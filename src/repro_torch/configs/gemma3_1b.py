"""gemma3-1b — 5:1 local:global attention, 128k-capable
[hf:google/gemma-3-1b-pt; unverified].  26L d_model=1152 4H (kv=1,
head 256) d_ff=6912 vocab=262144, sliding window 512 on local layers.
Local layers bound the KV working set, so ``long_500k`` applies (the
lone global layer class holds full-context KV; decode stays O(seq))."""

from repro_torch.configs.base import ArchSpec, register
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    window_pattern=(512, 512, 512, 512, 512, 0),  # 5 local : 1 global
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="gemma3-smoke",
    family="dense",
    num_layers=8,  # 1 full 6-pattern group + 2 remainder
    d_model=48,
    num_heads=2,
    num_kv_heads=1,
    head_dim=24,
    d_ff=96,
    vocab_size=256,
    window_pattern=(8, 8, 8, 8, 8, 0),
    tie_embeddings=True,
    dtype="float32",
    remat="none",
)

SPEC = register(
    ArchSpec(
        arch_id="gemma3-1b",
        config=CONFIG,
        smoke=SMOKE,
        shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
        notes="5:1 local:global; long_500k runs (see DESIGN.md §5).",
    )
)
