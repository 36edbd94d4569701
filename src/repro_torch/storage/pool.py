"""Bounded LRU memory pool for decompressed partitions.

Models the paper's memory-constrained regime (§IV-B2): "we free up the
space of the least recently used (LRU) partition before loading the
subsequent partition ... when the memory becomes insufficient".  Every
store (DeepMapping aux table, AB/ABC/HB/HBC baselines) charges its
decompressed partitions against a shared pool so latency comparisons
see identical eviction pressure.
"""

from __future__ import annotations

import collections
import threading
from typing import Callable, Hashable, Tuple


class MemoryPool:
    """LRU cache of opaque objects with a byte budget.

    ``get(key, loader)`` returns the cached object or calls ``loader()``
    -> ``(obj, nbytes)`` and caches it, evicting least-recently-used
    entries until the budget holds.  Objects larger than the budget are
    returned uncached (pure streaming read — matches loading a partition,
    using it, and dropping it).
    """

    def __init__(self, budget_bytes: int):
        if budget_bytes <= 0:
            raise ValueError("budget must be positive")
        self.budget_bytes = int(budget_bytes)
        self._entries: "collections.OrderedDict[Hashable, Tuple[object, int]]" = (
            collections.OrderedDict()
        )
        self._used = 0
        self._lock = threading.Lock()
        # Statistics used by the latency-breakdown benchmark (paper Fig. 7).
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    @property
    def used_bytes(self) -> int:
        return self._used

    def get(self, key: Hashable, loader: Callable[[], Tuple[object, int]]):
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                return entry[0]
            self.misses += 1
        obj, nbytes = loader()
        with self._lock:
            if nbytes > self.budget_bytes:
                return obj  # uncacheable: stream through
            while self._used + nbytes > self.budget_bytes and self._entries:
                _, (_, evicted) = self._entries.popitem(last=False)
                self._used -= evicted
                self.evictions += 1
            self._entries[key] = (obj, nbytes)
            self._used += nbytes
            return obj

    def invalidate(self, key: Hashable) -> None:
        with self._lock:
            entry = self._entries.pop(key, None)
            if entry is not None:
                self._used -= entry[1]

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._used = 0

    def reset_stats(self) -> None:
        self.hits = self.misses = self.evictions = 0
