"""Key-space partitioning policies for the sharded DeepMapping cluster.

A copy of ``repro.cluster.partitioner`` with its imports rewritten to the port, which
imports nothing of ``repro``.

A :class:`Partitioner` maps every int64 key to one of ``K`` shard ids.
Two policies, mirroring the classic learned-index split (RMI assigns
contiguous key sub-ranges to leaf models; hash partitioning trades
range locality for load uniformity under adversarial key skew):

* :class:`RangePartitioner` — contiguous key ranges split at planner-
  chosen boundary keys.  Range queries touch only the overlapping
  shards; the size-balanced planner picks boundaries at row-count
  quantiles of the build keys so every shard trains on ~n/K rows.
* :class:`HashPartitioner` — a SplitMix64-style bit mixer mod ``K``.
  Every shard sees a uniform sample of the key domain; range queries
  must scatter to all shards.

Both are deterministic pure functions of the key (routing never
consults shard contents), serialize to a msgpack-friendly state dict,
and round-trip through the cluster manifest.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


class Partitioner:
    """Deterministic key -> shard-id mapping."""

    policy: str = "abstract"

    @property
    def num_shards(self) -> int:
        raise NotImplementedError

    def shard_of(self, keys: np.ndarray) -> np.ndarray:
        """Vectorized shard id for each key (int64 in, int64 out)."""
        raise NotImplementedError

    def shards_for_range(self, lo: int, hi: int) -> np.ndarray:
        """Shard ids that may hold keys in ``[lo, hi)`` — the router's
        range-scatter set.  Must be a superset of the true set."""
        raise NotImplementedError

    # -- manifest round-trip -------------------------------------------------
    def to_state(self) -> Dict:
        raise NotImplementedError

    @staticmethod
    def from_state(state: Dict) -> "Partitioner":
        policy = state["policy"]
        if policy == RangePartitioner.policy:
            return RangePartitioner(state["boundaries"])
        if policy == HashPartitioner.policy:
            return HashPartitioner(state["num_shards"], seed=state["seed"])
        raise ValueError(f"unknown partition policy {policy!r}")


class RangePartitioner(Partitioner):
    """Contiguous key ranges: shard ``i`` owns ``[b[i-1], b[i])`` with
    ``b`` the sorted boundary keys (``b[-1]`` is open-ended).  Keys
    below the first boundary belong to shard 0; there are ``K-1``
    interior boundaries for ``K`` shards."""

    policy = "range"

    def __init__(self, boundaries: Sequence[int]):
        self._boundaries = np.asarray(sorted(boundaries), dtype=np.int64)
        if np.unique(self._boundaries).size != self._boundaries.size:
            raise ValueError("range boundaries must be distinct")

    @property
    def num_shards(self) -> int:
        return int(self._boundaries.size) + 1

    @property
    def boundaries(self) -> np.ndarray:
        return self._boundaries

    def shard_of(self, keys: np.ndarray) -> np.ndarray:
        keys = np.asarray(keys, dtype=np.int64)
        return np.searchsorted(self._boundaries, keys, side="right")

    def shards_for_range(self, lo: int, hi: int) -> np.ndarray:
        if hi <= lo:
            return np.zeros(0, dtype=np.int64)
        first = int(np.searchsorted(self._boundaries, lo, side="right"))
        last = int(np.searchsorted(self._boundaries, hi - 1, side="right"))
        return np.arange(first, last + 1, dtype=np.int64)

    def to_state(self) -> Dict:
        return {"policy": self.policy, "boundaries": self._boundaries.tolist()}


def _splitmix64(keys: np.ndarray, seed: int) -> np.ndarray:
    """SplitMix64 finalizer — avalanches low-entropy (dense, strided)
    key patterns so ``mixed % K`` is uniform.  Pure uint64 numpy."""
    z = keys.astype(np.uint64) + np.uint64(seed) + np.uint64(0x9E3779B97F4A7C15)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


class HashPartitioner(Partitioner):
    """Uniform hash partitioning: ``splitmix64(key, seed) % K``."""

    policy = "hash"

    def __init__(self, num_shards: int, seed: int = 0):
        if num_shards < 1:
            raise ValueError("need at least one shard")
        self._num_shards = int(num_shards)
        self.seed = int(seed)

    @property
    def num_shards(self) -> int:
        return self._num_shards

    def shard_of(self, keys: np.ndarray) -> np.ndarray:
        keys = np.asarray(keys, dtype=np.int64)
        return (_splitmix64(keys, self.seed) % np.uint64(self._num_shards)).astype(
            np.int64
        )

    def shards_for_range(self, lo: int, hi: int) -> np.ndarray:
        if hi <= lo:
            return np.zeros(0, dtype=np.int64)
        return np.arange(self._num_shards, dtype=np.int64)  # no range locality

    def to_state(self) -> Dict:
        return {
            "policy": self.policy,
            "num_shards": self._num_shards,
            "seed": self.seed,
        }


def plan_range_partitions(keys: np.ndarray, num_shards: int) -> RangePartitioner:
    """Size-balanced range planner: boundaries at the ``i/K`` row-count
    quantiles of the build keys, so each shard owns ~``n/K`` rows
    regardless of key-space skew (dense prefix + sparse tail splits
    evenly where equal-width ranges would not)."""
    if num_shards < 1:
        raise ValueError("need at least one shard")
    keys = np.unique(np.asarray(keys, dtype=np.int64))  # sorted + dedup
    if num_shards == 1 or keys.size == 0:
        return RangePartitioner(np.zeros(0, dtype=np.int64)[: num_shards - 1])
    cuts = (np.arange(1, num_shards) * keys.size) // num_shards
    cuts = np.minimum(cuts, keys.size - 1)
    boundaries = np.unique(keys[cuts])  # degenerate quantiles collapse
    # A boundary at the minimum key would leave shard 0 (keys < b[0])
    # empty; drop it so the shard count collapses instead.
    boundaries = boundaries[boundaries > keys[0]]
    return RangePartitioner(boundaries)


def make_partitioner(
    policy: str, keys: np.ndarray, num_shards: int, seed: int = 0
) -> Partitioner:
    """Build-time factory used by ``ShardedDeepMappingStore.build``."""
    if policy == "range":
        return plan_range_partitions(keys, num_shards)
    if policy == "hash":
        return HashPartitioner(num_shards, seed=seed)
    raise ValueError(f"unknown partition policy {policy!r}; have 'range', 'hash'")
