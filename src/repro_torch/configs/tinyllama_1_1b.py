"""tinyllama-1.1b — llama2-arch small [arXiv:2401.02385].
22L d_model=2048 32H (kv=4, head 64) d_ff=5632 vocab=32000."""

from repro_torch.configs.base import ArchSpec, register
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    family="dense",
    num_layers=22,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=64,
    d_ff=5632,
    vocab_size=32000,
)

SMOKE = ModelConfig(
    name="tinyllama-smoke",
    family="dense",
    num_layers=2,
    d_model=32,
    num_heads=4,
    num_kv_heads=2,
    head_dim=8,
    d_ff=64,
    vocab_size=128,
    dtype="float32",
    remat="none",
)

SPEC = register(
    ArchSpec(
        arch_id="tinyllama-1.1b",
        config=CONFIG,
        smoke=SMOKE,
        shapes=("train_4k", "prefill_32k", "decode_32k"),
        notes="Pure full attention -> long_500k skipped.",
    )
)
