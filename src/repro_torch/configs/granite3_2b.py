"""granite-3-2b — dense GQA [hf:ibm-granite/granite-3.0-2b-base].
40L d_model=2048 32H (kv=8, head 64) d_ff=8192 vocab=49155."""

from repro_torch.configs.base import ArchSpec, register
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b",
    family="dense",
    num_layers=40,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=49155,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="granite-smoke",
    family="dense",
    num_layers=3,
    d_model=32,
    num_heads=4,
    num_kv_heads=2,
    head_dim=8,
    d_ff=64,
    vocab_size=128,
    tie_embeddings=True,
    dtype="float32",
    remat="none",
)

SPEC = register(
    ArchSpec(
        arch_id="granite-3-2b",
        config=CONFIG,
        smoke=SMOKE,
        shapes=("train_4k", "prefill_32k", "decode_32k"),
        notes="Pure full attention -> long_500k skipped.",
    )
)
