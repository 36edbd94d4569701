"""Batched lookup serving engine — the paper's deployment scenario.

Requests (key batches) are queued, merged into device-sized batches,
deduplicated, sorted (so each T_aux partition is decompressed at most
once per batch — §IV-B2), answered via the hybrid store, and scattered
back to requesters.

Merged traffic rides the streaming operator pipeline
(:func:`repro_torch.api.executor.stream_plan`): the merged unique-key
batch becomes ONE point plan whose morsel size is the server's ``max_batch``,
and the executor keeps a window of morsels' device work in flight
ahead of the host half — existence fallback, aux merge, decode,
scatter — so consecutive morsels overlap while device residency stays
bounded for arbitrarily large merged requests.  For baseline stores
the store hooks degenerate to plain synchronous calls (no device stage
to overlap), so the pipeline is a no-op there.

A copy of ``repro.serve.engine`` with its imports rewritten: the port
imports nothing of ``repro``.  Over a store on the card, every merged
morsel's device half is one or more launches of the fused lookup kernel
(K1); the host half is the store's own.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.api.executor import MORSEL_WINDOW, PlanStream, _stream_run
from repro_torch.api.plan import QueryPlan
from repro_torch.api.protocol import MappingStore


@dataclasses.dataclass
class ServeStats:
    """Serving-side rollup of the SAME stage accounting the executor
    produces (per-morsel ``ExplainStats`` plus the plan stream's
    route/cache evidence) — not an independently-measured field set.
    The full pipeline is covered: route (key-source/plan compile),
    infer/exist/aux/decode from the store hooks, filter (zero unless a
    predicate plan is served), gather (scatter-back to requesters).
    Everything here is also mirrored into the process metrics registry
    under ``deepmap_serve_*`` for export."""

    requests: int = 0
    keys: int = 0
    batches: int = 0
    total_s: float = 0.0
    route_s: float = 0.0
    infer_s: float = 0.0
    exist_s: float = 0.0
    aux_s: float = 0.0
    filter_s: float = 0.0
    decode_s: float = 0.0
    gather_s: float = 0.0
    cache_hits: int = 0
    cache_misses: int = 0
    cache_bypass: int = 0

    def qps(self) -> float:
        return self.keys / self.total_s if self.total_s else 0.0


class LookupServer:
    """Merge-batch server over any :class:`~repro_torch.api.protocol.MappingStore`
    (single, sharded, baseline, or federated).

    Merged batches execute through the streaming executor, so the
    server gets the unified pipeline — projection pushdown, sharded
    thread-pool fan-out, infer/aux overlap across consecutive morsels,
    per-morsel stats — for free; merged batches arrive at the store
    sorted, so the sharded store's scatter sees at most one contiguous
    run per shard.
    """

    def __init__(
        self,
        store: MappingStore,
        max_batch: int = 65536,
        on_error: str = "raise",
    ):
        self.store = store
        self.max_batch = max_batch
        #: 'raise' fails the whole merged batch on any owner failure;
        #: 'partial' serves the healthy owners' keys (unreachable keys
        #: report exists=False) — QueryPlan validates the mode.
        self.on_error = on_error
        self.stats = ServeStats()

    def lookup(
        self, keys: np.ndarray, columns: Optional[Tuple[str, ...]] = None
    ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
        """Single-request path (still batched internally)."""
        return self.lookup_many([keys], columns)[0]

    def lookup_many(
        self,
        requests: List[np.ndarray],
        columns: Optional[Tuple[str, ...]] = None,
    ) -> List[Tuple[Dict[str, np.ndarray], np.ndarray]]:
        """Merge several key-batch requests into deduplicated device
        batches; scatter results back per request.  Device inference of
        morsel *i+1* overlaps the host half of morsel *i* (the
        streaming executor's window)."""
        if not requests:
            return []  # np.concatenate rejects an empty list
        t0 = time.perf_counter()
        reg = obs.registry()
        depth = reg.gauge(
            "deepmap_serve_queue_depth",
            "Requests currently being merged/answered by the server.",
        )
        depth.inc(len(requests))
        lens = [len(r) for r in requests]
        merged = np.concatenate([np.asarray(r, dtype=np.int64) for r in requests])
        uniq, inverse = np.unique(merged, return_inverse=True)  # sorted + dedup

        # One point plan over the merged uniques, morselized at the
        # server's batch size.  Columns pass straight through so
        # unknown names degrade to "ignored", like the legacy lookup
        # did; fanout=True keeps the sharded store's thread-pool
        # fan-out.  A zero-length merge still streams one empty morsel,
        # so callers get typed empty columns (same contract as the
        # stores' own zero-batch lookups).
        plan = QueryPlan(
            kind="point",
            keys=uniq,
            columns=tuple(columns) if columns is not None else None,
            fanout=True,
            morsel=self.max_batch,
            on_error=self.on_error,
        )
        chunks: Dict[str, List[np.ndarray]] = {}
        exists_u = np.zeros(uniq.shape[0], dtype=bool)
        # Drive the plan stream through an explicit PlanStream (rather
        # than the stream_plan convenience) so the server can read the
        # run's route time and plan-cache outcome — the ServeStats
        # fields are sourced from the executor's accounting, not
        # re-measured here.
        run = PlanStream(self.store, plan)
        for morsel in _stream_run(run, MORSEL_WINDOW):
            exists_u[morsel.start : morsel.start + morsel.exists.shape[0]] = (
                morsel.exists
            )
            for c, arr in morsel.values.items():
                chunks.setdefault(c, []).append(arr)
            self.stats.batches += 1
            self.stats.infer_s += morsel.stats.infer_s
            self.stats.exist_s += morsel.stats.exist_s
            self.stats.aux_s += morsel.stats.aux_s
            self.stats.filter_s += morsel.stats.filter_s
            self.stats.decode_s += morsel.stats.decode_s
        self.stats.route_s += run.route_s
        if run.cache_state == "hit":
            self.stats.cache_hits += 1
        elif run.cache_state == "miss":
            self.stats.cache_misses += 1
        else:
            self.stats.cache_bypass += 1
        # Gather: concatenate per column (rather than filling a
        # preallocated buffer) so chunks that disagree on dtype — e.g.
        # a baseline store's int placeholder chunk before a string
        # chunk — promote instead of crashing or truncating; then
        # scatter back to requesters.
        t_gather = time.perf_counter()
        vals_u = {c: np.concatenate(parts) for c, parts in chunks.items()}

        out: List[Tuple[Dict[str, np.ndarray], np.ndarray]] = []
        off = 0
        for n in lens:
            sel = inverse[off : off + n]
            out.append(({c: a[sel] for c, a in vals_u.items()}, exists_u[sel]))
            off += n
        elapsed_gather = time.perf_counter() - t_gather
        self.stats.gather_s += elapsed_gather
        self.stats.requests += len(requests)
        self.stats.keys += int(sum(lens))
        elapsed = time.perf_counter() - t0
        self.stats.total_s += elapsed
        depth.dec(len(requests))
        reg.counter(
            "deepmap_serve_requests_total", "Requests answered."
        ).inc(len(requests))
        reg.counter(
            "deepmap_serve_keys_total", "Keys looked up (pre-dedup)."
        ).inc(int(sum(lens)))
        reg.histogram(
            "deepmap_serve_batch_keys",
            "Unique keys per merged device batch.",
            buckets=obs.SIZE_BUCKETS,
        ).observe(int(uniq.shape[0]))
        lat = reg.histogram(
            "deepmap_serve_request_seconds",
            "Per-request latency (each merged request observes the "
            "merged batch's wall time — the caller-visible latency).",
        )
        for _ in range(len(requests)):
            lat.observe(elapsed)
        return out
