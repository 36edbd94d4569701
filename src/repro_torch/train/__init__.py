"""Training substrate of the port: optimizers, schedules, train steps,
checkpointing, fault tolerance and gradient compression (the port of
``repro.train``), shared by the DeepMapping mapping-model trainer and
the LM train steps."""

from repro_torch.train.optimizer import (  # noqa: F401
    OptState,
    adam_init,
    adam_update,
    adamw,
    clip_by_global_norm,
    cosine_schedule,
    exponential_decay,
    warmup_cosine,
)
