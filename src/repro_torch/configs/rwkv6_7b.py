"""rwkv6-7b — Finch: attention-free, data-dependent decay
[arXiv:2404.05892].  32L d_model=4096 d_ff=14336 vocab=65536; RWKV6
head size 64 -> 64 heads.  Constant-size WKV state makes this a
``long_500k`` arch."""

from repro_torch.configs.base import ArchSpec, register
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=64,            # head dim 64
    num_kv_heads=64,
    d_ff=14336,
    vocab_size=65536,
    block_pattern=("rwkv",),
)

SMOKE = ModelConfig(
    name="rwkv6-smoke",
    family="ssm",
    num_layers=2,
    d_model=32,
    num_heads=2,
    num_kv_heads=2,
    d_ff=64,
    vocab_size=128,
    block_pattern=("rwkv",),
    dtype="float32",
    remat="none",
)

SPEC = register(
    ArchSpec(
        arch_id="rwkv6-7b",
        config=CONFIG,
        smoke=SMOKE,
        shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
        notes="SSM family: O(1) decode state; long_500k applies.",
    )
)
