"""Training configuration and the build-time misclassification pass.

The port of the parts of ``repro.core.trainer`` that the serving path
needs: :class:`TrainConfig` (carried by ``DeepMappingConfig``) and
:func:`evaluate_misclassified_engine`.  ``train()`` (Adam on the
multi-task cross entropy) comes with the next slice; until then a store
is built from given weights.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 16384          # paper §V-A6
    epochs: int = 50
    lr: float = 1e-3                 # paper §V-A6
    lr_decay: float = 0.999          # per iteration
    early_stop_tol: float = 1e-4     # |Δloss| threshold (paper §V-A6)
    seed: int = 0
    log_every: int = 0               # 0 = silent


def evaluate_misclassified_engine(
    engine,
    keys: np.ndarray,
    codes: np.ndarray,
    batch: int = 1 << 16,
) -> np.ndarray:
    """Row mask of tuples the model gets wrong in ANY column (§IV-B1);
    these rows become T_aux.  Drives the deployed
    :class:`~repro_torch.core.inference.InferenceEngine` from raw keys
    as a two-stage pipeline: the device infers chunk *i+1* while the host
    compares chunk *i*.  Because the engine is the SAME object the store
    serves lookups with, T_aux corrects exactly the deployed inference
    path — including its weight padding and argmax tie-breaking."""
    keys = np.asarray(keys, dtype=np.int64)
    n = keys.shape[0]
    wrong = np.zeros(n, dtype=bool)
    pending: list = []
    for start in range(0, n, batch):
        pending.append((start, engine.dispatch(keys[start : start + batch])))
        if len(pending) >= 2:  # two-stage pipeline: host trails by one
            s, t = pending.pop(0)
            pred, _ = engine.collect(t)
            wrong[s : s + t.n] = (pred != codes[s : s + t.n]).any(axis=1)
    for s, t in pending:
        pred, _ = engine.collect(t)
        wrong[s : s + t.n] = (pred != codes[s : s + t.n]).any(axis=1)
    return wrong
