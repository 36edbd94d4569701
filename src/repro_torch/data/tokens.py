"""DeepMapping-compressed token store: the paper's technique as a
feature of the LM data pipeline (DESIGN.md §4).  The port of
``repro.data.tokens``.

A tokenized corpus is exactly a ``position -> token_id`` categorical
mapping.  The store compresses it as a DeepMapping hybrid structure and
the training loader materializes batches by BATCHED NN INFERENCE +
T_aux correction — losslessly, with the same Algorithm-1 path the paper
uses for tabular lookups.  In the port that path is the store's engine,
so on the card a batch's positions go through the fused lookup kernel
(K1) when the engine takes the ``fused`` tier.  ``lookups`` counts the
store's lookup calls (``kernels/build.py::count_launch``), so a caller
can set it to 0 before a path and read it after, as it does the
kernels' launch counts.  Token streams with local structure (runs,
templates, repeated spans) compress well; worst-case random tokens
degrade gracefully to T_aux ≈ zstd(data).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.hybrid import DeepMappingConfig, DeepMappingStore
from repro_torch.core.table import Table
from repro_torch.core.trainer import TrainConfig
from repro_torch.device import DeviceLike
from repro_torch.kernels import build


class DeepMappingTokenStore:
    """Lossless learned store for one token stream."""

    def __init__(self, store: DeepMappingStore, num_tokens: int):
        self._store = store
        self.num_tokens = int(num_tokens)
        self.lookups = 0

    @classmethod
    def build(
        cls,
        tokens: np.ndarray,
        config: Optional[DeepMappingConfig] = None,
        verbose: bool = False,
        device: DeviceLike = None,
    ) -> "DeepMappingTokenStore":
        """Train the store over ``tokens`` on ``device`` (CUDA by default)."""
        tokens = np.asarray(tokens)
        if tokens.ndim != 1:
            raise ValueError("tokens must be a flat stream")
        table = Table(
            keys=np.arange(tokens.shape[0], dtype=np.int64),
            columns={"token": tokens.astype(np.int32)},
        )
        cfg = config or DeepMappingConfig(
            shared=(256, 256),
            private=(64,),
            train=TrainConfig(epochs=60, batch_size=8192),
        )
        store = DeepMappingStore.build(table, cfg, verbose=verbose, device=device)
        return cls(store, tokens.shape[0])

    @property
    def store(self) -> DeepMappingStore:
        """The backing DeepMapping store (its engine, spec and weights)."""
        return self._store

    def get(self, positions: np.ndarray) -> np.ndarray:
        build.count_launch(self, "lookups")
        vals, exists = self._store.lookup(np.asarray(positions, dtype=np.int64))
        if not bool(exists.all()):
            raise KeyError("token positions must exist in the backing store")
        return vals["token"]

    def get_batch(self, starts: np.ndarray, seq_len: int) -> np.ndarray:
        """(batch,) window starts -> (batch, seq_len) token block."""
        starts = np.asarray(starts, dtype=np.int64)
        pos = starts[:, None] + np.arange(seq_len, dtype=np.int64)[None, :]
        flat = self.get(pos.reshape(-1))
        return flat.reshape(starts.shape[0], seq_len).astype(np.int32)

    # -- accounting --------------------------------------------------------
    def compression_ratio(self) -> float:
        return self._store.compression_ratio()

    def size_bytes(self) -> int:
        return self._store.size_bytes()

    def memorized_fraction(self) -> float:
        return self._store.memorized_fraction()


def make_structured_tokens(n: int, vocab: int, run_len: int = 8, seed: int = 0) -> np.ndarray:
    """Synthetic corpus with template structure (repeated n-gram runs) —
    the regime where learned mapping compression wins."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, vocab, size=max(2, n // run_len), dtype=np.int32)
    toks = np.repeat(base, run_len)[:n]
    flip = rng.random(n) < 0.02
    toks[flip] = rng.integers(0, vocab, size=int(flip.sum()))
    return toks
