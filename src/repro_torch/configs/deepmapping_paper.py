"""The paper's own workload config: DeepMapping hybrid structures for
the evaluation datasets (§V-A6 search/training hyper-parameters) — the
port of ``repro.configs.deepmapping_paper``, built from the port's
``MHASConfig``, ``DeepMappingConfig`` and ``TrainConfig``.  The stores
take the fused CUDA kernels (``use_kernels``, the port's default), where
the reference's ``use_pallas`` is off by default."""

import dataclasses

from repro_torch.core.hybrid import DeepMappingConfig
from repro_torch.core.mhas.search import MHASConfig
from repro_torch.core.trainer import TrainConfig

# Paper-scale settings (§V-A6) — used on real hardware.
PAPER_MHAS = MHASConfig(
    layer_sizes=(100, 200, 400, 800, 1200, 1600, 2000),
    max_layers=2,
    total_iters=2000,
    model_iters=2000,
    controller_iters=40,
    model_epochs_per_iter=5,
    model_batch=16384,
    controller_batch=2048,
    lr_model=1e-3,
    lr_controller=3.5e-4,
    early_stop_tol=1e-4,
)

PAPER_STORE = DeepMappingConfig(
    base=10,
    codec="zstd",                  # DM-Z; "lzma" -> DM-L
    partition_bytes=4 * 1024 * 1024,  # §V-A5: ~4MB optimal for DM-Z
    train=TrainConfig(batch_size=16384, epochs=200, lr=1e-3, lr_decay=0.999,
                      early_stop_tol=1e-4),
)

# CPU-scale settings of the reference's benchmarks.
BENCH_MHAS = dataclasses.replace(
    PAPER_MHAS,
    layer_sizes=(32, 64, 128, 256),
    total_iters=120,
    model_iters=120,
    controller_iters=6,
    model_epochs_per_iter=2,
    model_batch=4096,
    controller_batch=2048,
    finetune_epochs=40,
)

BENCH_STORE = dataclasses.replace(
    PAPER_STORE,
    partition_bytes=128 * 1024,
    train=TrainConfig(batch_size=4096, epochs=120, lr=1e-3, lr_decay=0.999,
                      early_stop_tol=1e-4),
)
