"""Deterministic, stateless batch loader: the port of
``repro.data.loader`` (numpy only).

``batch_for_step(step)`` is a pure function of (seed, step, topology):
restart-safe (replays exactly), elastic-safe (a host owns
``process_index``-strided rows of the global batch), and usable as the
``batch_fn`` of the fault-tolerant runner.  Batches are numpy arrays;
the caller moves them to its device."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.data.tokens import DeepMappingTokenStore


@dataclasses.dataclass
class LoaderConfig:
    global_batch: int
    seq_len: int
    seed: int = 0
    process_index: int = 0
    process_count: int = 1


class TokenBatchLoader:
    """Batches from a raw array or a DeepMapping-compressed store."""

    def __init__(
        self,
        cfg: LoaderConfig,
        tokens: Optional[np.ndarray] = None,
        store: Optional[DeepMappingTokenStore] = None,
    ):
        if (tokens is None) == (store is None):
            raise ValueError("exactly one of tokens/store")
        self.cfg = cfg
        self._tokens = tokens
        self._store = store
        n = store.num_tokens if store is not None else tokens.shape[0]
        self._max_start = n - cfg.seq_len - 1
        if self._max_start <= 0:
            raise ValueError("corpus shorter than seq_len")

    def _starts(self, step: int) -> np.ndarray:
        rng = np.random.default_rng((self.cfg.seed, step))
        starts = rng.integers(0, self._max_start, size=self.cfg.global_batch)
        # host shard: strided rows of the global batch
        return starts[self.cfg.process_index :: self.cfg.process_count]

    def batch_for_step(self, step: int) -> Dict[str, np.ndarray]:
        starts = self._starts(step)
        if self._store is not None:
            toks = self._store.get_batch(starts, self.cfg.seq_len + 1)
        else:
            pos = starts[:, None] + np.arange(self.cfg.seq_len + 1)[None, :]
            toks = self._tokens[pos]
        return {"tokens": toks.astype(np.int32)}
