"""Shared scatter/gather primitives (numpy-only, store-agnostic).

A copy of ``repro.api.routing`` with its imports rewritten to the port, which
imports nothing of ``repro``.

One request batch fans out to several owners — shards behind a
``ShardRouter``, members behind a ``FederatedStore`` — and results come
back in request order.  Both layers used to carry private copies of
the same two nontrivial idioms; they live here once:

* :func:`group_runs` — stable group-by of positions per owner id
  (argsort + run cuts; one contiguous group per owner, ascending id);
* :func:`gather_parts` — reassemble per-owner ``(values, exists)``
  into request order via concatenate + inverse permutation, which
  sidesteps per-column dtype preallocation (owners may disagree on
  e.g. unicode widths of decode maps);
* :class:`LazyFanoutPool` — the lazily-created, double-checked-locked
  thread pool both fan-out stages (per-shard lookup visits, per-member
  federation collects) run on.

This module must stay dependency-light (numpy only): ``cluster``
imports it through ``api``, and ``api`` must never import the store
packages back.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np


class LazyFanoutPool:
    """Lazy, long-lived thread pool for scatter/gather fan-out stages.

    Shared by the sharded store (per-shard lookup visits) and the
    federation (per-member morsel collects): owners are independent
    stores whose host halves release the GIL inside compiled inference,
    so visits genuinely overlap.  Creation is double-checked-locked —
    two first-queries racing must not each build (and leak) a pool —
    and deferred until the first parallel call, so serial workloads
    never spawn threads.
    """

    def __init__(self, max_workers: Optional[int], name: str):
        """Remember the sizing policy; no threads start until needed.

        ``max_workers=None`` defers to ``min(owners, cpu_count)`` at
        the first :meth:`map` call (``owners`` passed there).
        """
        self._max_workers = max_workers
        self._name = name
        self._pool: Optional[ThreadPoolExecutor] = None  # guarded-by: _lock
        self._lock = threading.Lock()

    def map(self, fn, items, owners: Optional[int] = None) -> List:
        """``[fn(x) for x in items]`` on the pool (created on first
        use, sized by the configured cap or ``min(owners, cpus)``)."""
        pool = self._pool
        if pool is None:
            with self._lock:
                if self._pool is None:
                    workers = self._max_workers or min(
                        owners or (os.cpu_count() or 4), os.cpu_count() or 4
                    )
                    self._pool = ThreadPoolExecutor(
                        max_workers=max(1, workers),
                        thread_name_prefix=self._name,
                    )
                pool = self._pool
        return list(pool.map(fn, items))

    def close(self) -> None:
        """Shut down the worker threads (idempotent; in-flight work
        finishes first).  Without this, pool threads live until
        interpreter exit.  A later :meth:`map` lazily re-creates the
        pool, so closing a store twice — or using it again after an
        explicit close — stays safe."""
        with self._lock:
            pool = self._pool
            self._pool = None
        if pool is not None:
            pool.shutdown(wait=True)

    def __enter__(self) -> "LazyFanoutPool":
        """Context-manager entry (no threads start here)."""
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        """Shut the pool down on scope exit."""
        self.close()


def group_runs(ids: np.ndarray) -> List[Tuple[int, np.ndarray]]:
    """Group request positions by owner id -> ``[(id, positions), ...]``
    (ascending id; owners with no positions are skipped; empty input
    -> empty list).  ``positions`` index the original request array."""
    ids = np.asarray(ids)
    if ids.size == 0:
        return []
    order = np.argsort(ids, kind="stable")
    sorted_ids = ids[order]
    cut = np.flatnonzero(np.diff(sorted_ids)) + 1
    starts = np.concatenate([[0], cut])
    ends = np.concatenate([cut, [sorted_ids.size]])
    return [
        (int(sorted_ids[s]), order[s:e]) for s, e in zip(starts, ends)
    ]


def gather_parts(
    n: int,
    parts: Iterable[Tuple[np.ndarray, Dict[str, np.ndarray], np.ndarray]],
) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """Reassemble per-owner ``(positions, values, exists)`` parts into
    request order over ``n`` rows -> ``(values, exists)``."""
    parts = list(parts)
    exists = np.zeros(n, dtype=bool)
    if not parts:
        return {}, exists
    positions = np.concatenate([p for p, _, _ in parts])
    inv = np.empty(n, dtype=np.int64)
    inv[positions] = np.arange(positions.size)
    values: Dict[str, np.ndarray] = {}
    for name in parts[0][1]:
        values[name] = np.concatenate([v[name] for _, v, _ in parts])[inv]
    exists[positions] = np.concatenate([e for _, _, e in parts])
    return values, exists


def gather_parts_partial(
    n: int,
    parts: Iterable[Tuple[np.ndarray, Dict[str, np.ndarray], np.ndarray]],
) -> Tuple[Dict[str, np.ndarray], np.ndarray, np.ndarray]:
    """:func:`gather_parts` for a *partial* cover: some request
    positions may have no owning part (their owner failed terminally).

    Returns ``(values, exists, covered)`` where ``covered`` marks the
    positions an owner actually answered for.  Uncovered rows carry a
    placeholder value (a healthy row's bytes — never uninitialised
    memory) and ``exists=False``; callers must report them as
    *unreachable*, not *absent* (``ExplainStats.keys_unresolved``).

    Requires at least one part: with zero healthy owners there are no
    column dtypes to build placeholders from, and a fully-failed morsel
    must surface as :class:`~repro_torch.fault.errors.OwnerFailure` upstream.
    """
    parts = list(parts)
    if not parts:
        raise ValueError(
            "gather_parts_partial needs >= 1 healthy part; a fully-failed "
            "morsel must raise OwnerFailure instead of degrading"
        )
    exists = np.zeros(n, dtype=bool)
    covered = np.zeros(n, dtype=bool)
    positions = np.concatenate([p for p, _, _ in parts])
    covered[positions] = True
    # Uncovered rows map to concatenated index 0 — a real (healthy) row
    # used purely as a typed placeholder, masked by exists=False.
    inv = np.zeros(n, dtype=np.int64)
    inv[positions] = np.arange(positions.size)
    values: Dict[str, np.ndarray] = {}
    for name in parts[0][1]:
        values[name] = np.concatenate([v[name] for _, v, _ in parts])[inv]
    exists[positions] = np.concatenate([e for _, _, e in parts])
    return values, exists, covered
