"""Scatter/gather routing for the sharded DeepMapping cluster.

A copy of ``repro.cluster.router`` with its imports rewritten to the port, which
imports nothing of ``repro``.

The router turns one batched request over arbitrary keys into at most
one contiguous sub-batch per shard (scatter) and reassembles per-shard
results back into request order (gather).  Routing is a pure function
of the partitioner — the paper's batch discipline (§IV-B2: sort so
each compressed partition is decompressed at most once per batch)
extends here to: sort so each SHARD is visited at most once per batch.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Tuple

import numpy as np

from repro_torch.api.routing import gather_parts, gather_parts_partial, group_runs
from repro_torch.cluster.partitioner import Partitioner


@dataclasses.dataclass(frozen=True)
class ShardBatch:
    """One shard's slice of a scattered request.

    ``positions`` indexes into the original request array; gather
    writes this batch's results back through it.
    """

    shard_id: int
    positions: np.ndarray  # (m,) int64 indices into the request
    keys: np.ndarray       # (m,) int64 keys routed to this shard


class ShardRouter:
    """Routes key batches (and per-row column payloads) to shards."""

    def __init__(self, partitioner: Partitioner):
        self.partitioner = partitioner

    @property
    def num_shards(self) -> int:
        return self.partitioner.num_shards

    def scatter(self, keys: np.ndarray) -> List[ShardBatch]:
        """Group a key batch by owning shard (one batch per touched
        shard, shard-id ascending; empty shards are skipped)."""
        keys = np.asarray(keys, dtype=np.int64)
        if keys.size == 0:
            return []
        return [
            ShardBatch(shard_id=sid, positions=pos, keys=keys[pos])
            for sid, pos in group_runs(self.partitioner.shard_of(keys))
        ]

    @staticmethod
    def take_columns(
        columns: Dict[str, np.ndarray], positions: np.ndarray
    ) -> Dict[str, np.ndarray]:
        """Project per-row column payloads onto one shard's positions."""
        return {name: col[positions] for name, col in columns.items()}

    @staticmethod
    def gather(
        n: int, parts: Iterable[Tuple[ShardBatch, Dict[str, np.ndarray], np.ndarray]]
    ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
        """Reassemble per-shard ``(values, exists)`` into request order
        (see :func:`repro.api.routing.gather_parts` for the inverse-
        permutation discipline)."""
        return gather_parts(
            n, ((b.positions, v, e) for b, v, e in parts)
        )

    @staticmethod
    def gather_partial(
        n: int, parts: Iterable[Tuple[ShardBatch, Dict[str, np.ndarray], np.ndarray]]
    ) -> Tuple[Dict[str, np.ndarray], np.ndarray, np.ndarray]:
        """Degraded-mode gather over the *healthy* shards only ->
        ``(values, exists, covered)``; positions owned by a failed shard
        report ``exists=False`` with typed placeholder values and
        ``covered=False`` (see
        :func:`repro.api.routing.gather_parts_partial`)."""
        return gather_parts_partial(
            n, ((b.positions, v, e) for b, v, e in parts)
        )
