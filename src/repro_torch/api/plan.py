"""Per-lookup execution report.

A copy of ``ExplainStats`` (and the ``OperatorStats`` rows it holds)
from ``repro.api.plan``; the plan IR and the query layer come with a
later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class OperatorStats:
    """One executed operator's row in the explain output."""

    name: str
    rows_in: int
    rows_out: int
    seconds: float


def _union(a: Tuple[str, ...], b: Tuple[str, ...]) -> Tuple[str, ...]:
    """Order-preserving union of two evidence tuples."""
    seen = dict.fromkeys(a)
    seen.update(dict.fromkeys(b))
    return tuple(seen)


@dataclasses.dataclass
class ExplainStats:
    """Per-plan execution report (the paper's Fig. 7 latency breakdown,
    plus pushdown, fan-out, and per-operator evidence).

    ``plan`` lists the executed pipeline stages in order; ``operators``
    is the structured per-operator breakdown (rows in/out + seconds)
    the executor assembles after the morsel stream drains.
    ``heads_evaluated``/``heads_skipped`` record which model private
    heads ran (DeepMapping stores only — baselines always report all
    heads skipped since they have no model); ``columns_decoded``/
    ``columns_skipped`` record the decode projection every store type
    honours; ``predicates`` the pushed-down value filters and
    ``rows_decoded`` how many rows actually reached a decode call
    (strictly fewer than ``num_keys`` under selective pushdown).
    ``partitions_pruned`` counts baseline partitions skipped by the
    dictionary zone maps; ``plan_cache`` reports the plan-cache
    outcome (``"hit"``/``"miss"``/``"bypass"``) and ``morsel_sizes``
    the dispatched morsel row counts (adaptive sizing evidence).
    Timings are seconds; under shard fan-out / morsel merging the
    per-stage times are summed (CPU time), while ``total_s`` is wall
    clock.  See DESIGN.md §Explain-stats reference for the full
    field-by-field table.
    """

    kind: str = ""
    plan: Tuple[str, ...] = ()
    operators: Tuple[OperatorStats, ...] = ()
    num_keys: int = 0
    num_rows: int = 0
    morsels: int = 0
    shards_visited: int = 0
    #: Distinct shard ids behind ``shards_visited`` (sharded stores
    #: populate ints; the federation namespaces them per member, e.g.
    #: ``"m1:2"``; morsel merging unions them so disjoint morsels that
    #: each touch one shard still aggregate to the true fan-out).
    shard_ids: Tuple = ()
    async_fanout: bool = False
    heads_evaluated: Tuple[str, ...] = ()
    heads_skipped: Tuple[str, ...] = ()
    columns_decoded: Tuple[str, ...] = ()
    columns_skipped: Tuple[str, ...] = ()
    predicates: Tuple[str, ...] = ()
    rows_decoded: int = 0
    rows_matched: int = 0
    #: True when the pushed-down predicates were evaluated *in-kernel*
    #: (fused kernel tier emitted match bits with the codes), so the
    #: host filter stage only patched aux-overridden rows.  ``filter_s``
    #: then measures that patch, not a per-row table gather.
    kernel_filtered: bool = False
    partitions_pruned: int = 0
    plan_cache: str = ""
    morsel_sizes: Tuple[int, ...] = ()
    #: Terminal owner failures this plan degraded around, as compact
    #: ``OwnerError.describe()`` strings ("shard:2@shard_collect: ...").
    #: Non-empty only for ``on_error='partial'`` results.
    owners_failed: Tuple[str, ...] = ()
    #: Retry attempts (beyond each first try) spent across owners.
    retries: int = 0
    #: Requested keys whose owner failed terminally — *unreachable*,
    #: not absent: they report ``exists=False`` with placeholder values
    #: but may well exist on the failed owner.
    keys_unresolved: int = 0
    #: Result groups emitted by a ``group_by(...).agg(...)`` plan (set
    #: on the final plan stats; per-morsel partials leave it 0 — a
    #: group seen by many morsels is still one emitted group).
    groups_emitted: int = 0
    #: Probe keys scattered into the right store's existence index by
    #: a ``join(...)`` plan (summed across morsels).
    join_probes: int = 0
    route_s: float = 0.0
    infer_s: float = 0.0
    exist_s: float = 0.0
    aux_s: float = 0.0
    filter_s: float = 0.0
    decode_s: float = 0.0
    agg_s: float = 0.0
    gather_s: float = 0.0
    total_s: float = 0.0

    def merge_timings(self, other: "ExplainStats") -> None:
        """Accumulate another stats object's stage timings, counters,
        and pushdown evidence (shard fan-out / morsel / server batch
        aggregation).  Evidence tuples are unioned — a shard or morsel
        must never make the aggregate under-report which heads ran or
        which columns were decoded — and ``shards_visited`` keeps the
        widest fan-out seen rather than being dropped."""
        self.route_s += other.route_s
        self.infer_s += other.infer_s
        self.exist_s += other.exist_s
        self.aux_s += other.aux_s
        self.filter_s += other.filter_s
        self.decode_s += other.decode_s
        self.agg_s += other.agg_s
        self.gather_s += other.gather_s
        self.rows_decoded += other.rows_decoded
        self.rows_matched += other.rows_matched
        self.partitions_pruned += other.partitions_pruned
        self.retries += other.retries
        self.keys_unresolved += other.keys_unresolved
        self.join_probes += other.join_probes
        # one group seen by N morsels is still one group — keep the max
        self.groups_emitted = max(self.groups_emitted, other.groups_emitted)
        self.owners_failed = _union(self.owners_failed, other.owners_failed)
        self.shard_ids = tuple(
            dict.fromkeys(self.shard_ids + other.shard_ids)
        )
        # Distinct-id union when shards are tracked (disjoint morsels
        # each touching one shard still sum to the true fan-out); the
        # max keeps a count-only side (a store reporting no ids) from
        # being dropped.
        self.shards_visited = max(
            len(self.shard_ids), self.shards_visited, other.shards_visited
        )
        self.async_fanout = self.async_fanout or other.async_fanout
        self.heads_evaluated = _union(self.heads_evaluated, other.heads_evaluated)
        self.heads_skipped = _union(self.heads_skipped, other.heads_skipped)
        self.columns_decoded = _union(self.columns_decoded, other.columns_decoded)
        self.columns_skipped = _union(self.columns_skipped, other.columns_skipped)
        self.predicates = _union(self.predicates, other.predicates)
        self.kernel_filtered = self.kernel_filtered or other.kernel_filtered
