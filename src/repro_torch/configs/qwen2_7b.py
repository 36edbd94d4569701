"""qwen2-7b — dense GQA with QKV bias [arXiv:2407.10671].
28L d_model=3584 28H (kv=4, head 128) d_ff=18944 vocab=152064."""

from repro_torch.configs.base import ArchSpec, register
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b",
    family="dense",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="qwen2-smoke",
    family="dense",
    num_layers=2,
    d_model=56,
    num_heads=4,
    num_kv_heads=2,
    head_dim=14,
    d_ff=112,
    vocab_size=128,
    qkv_bias=True,
    dtype="float32",
    remat="none",
)

SPEC = register(
    ArchSpec(
        arch_id="qwen2-7b",
        config=CONFIG,
        smoke=SMOKE,
        shapes=("train_4k", "prefill_32k", "decode_32k"),
        notes="Pure full attention -> long_500k skipped.",
    )
)
