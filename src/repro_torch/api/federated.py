"""Cross-store federation: one plan over several member stores.

A copy of ``repro.api.federated`` with its imports rewritten to the port, which
imports nothing of ``repro``.

:class:`FederatedStore` composes N :class:`~repro_torch.api.protocol.MappingStore`
members — any mix of DeepMapping, sharded, and baseline stores —
behind the same protocol surface, so every query-layer feature (plans,
projection + predicate pushdown, the streaming executor, the serving
engine) runs unchanged against the federation.  Two composition modes:

* ``mode="partition"`` — members own **disjoint key ranges** split at
  ``boundaries`` (sorted ints, one fewer than members; member *i* owns
  ``[boundaries[i-1], boundaries[i])`` with open ends).  Lookups
  scatter per member and gather back in request order; range/scan key
  sources concatenate the members' ascending streams; mutations route
  to the owning member.  E.g. two sharded clusters over disjoint key
  spaces behind one facade.

* ``mode="replicate"`` — every member holds the **same relation**
  (e.g. a DeepMapping primary + a HashStore replica).  Each dispatched
  morsel is answered by ONE member: ``policy="primary"`` always asks
  member 0 (deterministic), ``policy="round_robin"`` rotates members
  per dispatch so a morsel stream load-balances across replicas while
  earlier morsels' host halves are still draining.  Mutations apply to
  every member, keeping replicas in sync.

Federation invariants:

* members expose identical column sets (checked at construction);
* partition members' key ranges are disjoint by construction — a key
  is answered by exactly one member, so scatter/gather is a
  permutation (the sharded-cluster invariant, one level up);
* replicate members agree on content (the caller's responsibility —
  e.g. built from one table or kept in sync through the facade);
  *values* equality across replicas is semantic, not byte-level
  (different store types may decode to different dtypes).

A federation is a runtime composition, not a storage format: ``save``
is intentionally unsupported — persist the members individually and
recompose.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.api.plan import ExplainStats, merge_agg_states
from repro_torch.api.protocol import MappingStore
from repro_torch.api.routing import (
    LazyFanoutPool,
    gather_parts,
    gather_parts_partial,
    group_runs,
)
from repro_torch.fault import injection as fault_injection
from repro_torch.fault.errors import OwnerFailure
from repro_torch.fault.health import HealthPolicy, HealthTracker
from repro_torch.fault.retry import DEFAULT_POLICY, RetryPolicy, call_guarded

MODES = ("partition", "replicate")
POLICIES = ("primary", "round_robin")

#: Replicate-mode behaviour for mutations while a replica is
#: quarantined: ``"reject"`` raises (no member mutates, replicas never
#: diverge); ``"queue"`` buffers the op and applies it — in order —
#: once every replica is healthy again (:meth:`FederatedStore
#: .flush_mutations`, also attempted before the next mutation).
MUTATION_POLICIES = ("reject", "queue")


class _PendingFederatedLookup:
    """Per-member dispatches in flight for one request batch."""

    __slots__ = (
        "keys", "parts", "route_s", "predicates", "member_ids", "use_fanout",
        "columns", "keys_exist", "on_error",
    )

    def __init__(self, keys, parts, route_s, predicates, member_ids,
                 use_fanout, columns, keys_exist, on_error):
        self.keys = keys
        self.parts = parts          # [(member, positions, (ok, payload))]
        self.route_s = route_s
        self.predicates = predicates
        self.member_ids = member_ids
        self.use_fanout = use_fanout
        self.columns = columns
        self.keys_exist = keys_exist
        self.on_error = on_error


class FederatedStore(MappingStore):
    """One logical store over several member stores (see module doc)."""

    def __init__(
        self,
        members: Sequence[MappingStore],
        mode: str = "partition",
        boundaries: Optional[Sequence[int]] = None,
        policy: str = "primary",
        retry: RetryPolicy = DEFAULT_POLICY,
        health: HealthPolicy = HealthPolicy(),
        mutation_policy: str = "reject",
    ):
        if not members:
            raise ValueError("federation needs at least one member store")
        if mode not in MODES:
            raise ValueError(f"unknown federation mode {mode!r}; have {MODES}")
        if policy not in POLICIES:
            raise ValueError(f"unknown routing policy {policy!r}; have {POLICIES}")
        if mutation_policy not in MUTATION_POLICIES:
            raise ValueError(
                f"unknown mutation policy {mutation_policy!r}; "
                f"have {MUTATION_POLICIES}"
            )
        cols = tuple(members[0].columns)
        for i, m in enumerate(members[1:], 1):
            # set equality: different store types canonicalize column
            # ORDER differently (MLPSpec sorts tasks, baselines keep
            # table order); values are keyed by name, so order is
            # presentation only and member 0's wins.
            if set(m.columns) != set(cols):
                raise ValueError(
                    f"member {i} columns {tuple(m.columns)} != member 0 "
                    f"columns {cols}; federation needs one schema"
                )
        if mode == "partition":
            if boundaries is None or len(boundaries) != len(members) - 1:
                raise ValueError(
                    "partition mode needs len(members)-1 sorted boundaries"
                )
            b = [int(x) for x in boundaries]
            if sorted(b) != b:
                raise ValueError(f"boundaries must be ascending: {b}")
            self.boundaries = np.asarray(b, dtype=np.int64)
        else:
            if boundaries is not None:
                raise ValueError("replicate mode takes no boundaries")
            self.boundaries = None
        self.members = list(members)
        self.mode = mode
        self.policy = policy
        self.retry = retry
        self.mutation_policy = mutation_policy
        self.health = HealthTracker(health)
        self._columns = cols
        self._names = tuple(f"member:{i}" for i in range(len(members)))
        self._rr = 0  # round-robin cursor (replicate mode)
        # Replicate-mode mutations deferred under mutation_policy=
        # "queue" while a replica is quarantined: [(op, keys, columns)].
        # Mutations are caller-serialized (same contract as the
        # members'), so no lock.
        self._mutation_queue: List[Tuple[str, np.ndarray, Optional[Dict]]] = []
        # Morsel-parallel collect: member host halves gather on the
        # same lazy fan-out pool machinery the sharded store uses.
        self._fanout = LazyFanoutPool(None, "fed-collect")
        # One PlanCache across the federation: a predicate/aggregate
        # code table compiled against one member's decode map is
        # content-matched (PlanCache._table_memo) and reused by every
        # member whose vocabulary coincides — a plan no longer
        # recompiles its tables per member.  Member versions fence
        # entries individually, so divergent members just occupy
        # separate variants.
        shared_cache = self.plan_cache()
        for m in self.members:
            m._plan_cache = shared_cache

    # --------------------------------------------------------------- routing
    def _member_of(self, keys: np.ndarray) -> np.ndarray:
        return np.searchsorted(self.boundaries, keys, side="right")

    def _scatter(self, keys: np.ndarray) -> List[Tuple[int, np.ndarray]]:
        """Partition-mode scatter -> ``[(member_id, positions), ...]``
        (ascending member id; empty members skipped).  Zero-length
        batches scatter to nobody — mutations stay no-ops."""
        if keys.shape[0] == 0:
            return []
        return group_runs(self._member_of(keys))

    def _pick_replica(self) -> int:
        if self.policy == "primary":
            return 0
        i = self._rr % len(self.members)
        self._rr += 1
        return i

    # -------------------------------------------------------------- protocol
    @property
    def columns(self) -> Tuple[str, ...]:
        """Member 0's column order (sets are identical by contract)."""
        return self._columns

    def _dispatch_lookup(self, keys, columns=None, fanout=None, predicates=(),
                         keys_exist=False, on_error="raise"):
        """Per-member scatter: every touched member's device work is
        enqueued before any host half runs, so a federated morsel
        overlaps member inference the same way the sharded store
        overlaps shard inference.  ``keys_exist`` forwards to every
        member (partition-mode range/scan keys come from the members'
        own existence indexes).

        In replicate mode the serving replica is the health tracker's
        :meth:`~repro_torch.fault.health.HealthTracker.pick` over the routing
        policy's preference — quarantined replicas are routed around
        (and periodically probed back in).  A member whose dispatch
        raises is captured in its handle slot; collect retries and, in
        replicate mode, fails over to the next replica."""
        keys = np.asarray(keys, dtype=np.int64)
        t0 = time.perf_counter()
        if self.mode == "replicate" or keys.shape[0] == 0:
            mid = 0
            if self.mode == "replicate":
                mid = self.health.pick(self._names, self._pick_replica())
            groups = [(mid, np.arange(keys.shape[0], dtype=np.int64))]
        else:
            groups = self._scatter(keys)
        route_s = time.perf_counter() - t0
        parts = []
        for m, pos in groups:
            try:
                parts.append((m, pos, (True, self.members[m]._dispatch_lookup(
                    keys[pos], columns, fanout=fanout, predicates=predicates,
                    keys_exist=keys_exist,
                ))))
            except Exception as exc:  # captured; retried at collect
                parts.append((m, pos, (False, exc)))
        use_fanout = (fanout is None or bool(fanout)) and len(parts) > 1
        return _PendingFederatedLookup(
            keys, parts, route_s, tuple(predicates), [m for m, _ in groups],
            use_fanout, columns, keys_exist, on_error,
        )

    def _visit_member(self, pending: _PendingFederatedLookup, part, aggregate=None):
        """Collect one member's part under the guarded retry loop ->
        ``(member, positions, values, exists, match, stats, outcome)``
        (result fields are ``None`` on terminal failure).  Health is
        recorded on every outcome, so replicate-mode routing learns.
        With ``aggregate=(group_by, aggregates)`` the member folds its
        part in code space instead (``_collect_aggregate``) and the
        partial state rides in the ``values`` slot — tuple shape is
        unchanged so the failover walk handles both."""
        m, pos, (ok, payload) = part
        owner = self._names[m]

        def attempt(i: int):
            fault_injection.maybe_fail("member_collect", owner)
            if i == 0 and ok:
                handle = payload
            elif i == 0 and payload is not None:
                raise payload  # dispatch-time failure = try 0
            else:
                # Retry, or a handle-less part (replicate failover):
                # dispatch fresh.
                handle = self.members[m]._dispatch_lookup(
                    pending.keys[pos], pending.columns,
                    predicates=pending.predicates,
                    keys_exist=pending.keys_exist,
                )
            if aggregate is not None:
                return self.members[m]._collect_aggregate(handle, *aggregate)
            return self.members[m]._collect_lookup(handle)

        outcome = call_guarded(
            attempt, owner=owner, site="member_collect", policy=self.retry
        )
        if not outcome.ok:
            self.health.record_failure(owner)
            return m, pos, None, None, None, None, outcome
        self.health.record_success(owner, outcome.latency_s)
        if aggregate is not None:
            state, stats = outcome.value
            stats.shard_ids = tuple(f"m{m}:{s}" for s in stats.shard_ids)
            return m, pos, state, None, None, stats, outcome
        values, exists, match, stats = outcome.value
        # Namespace member-local shard ids before the union: two
        # sharded members both have a "shard 0", and deduping them
        # would under-report the federation's true fan-out.
        stats.shard_ids = tuple(f"m{m}:{s}" for s in stats.shard_ids)
        return m, pos, values, exists, match, stats, outcome

    def _failover_replicate(
        self, pending: _PendingFederatedLookup, first, aggregate=None
    ):
        """Replicate-mode failover: the picked replica failed
        terminally — walk the remaining replicas in ring order (fresh
        dispatch each) until one serves.  Returns the winning visit
        plus the accumulated failures; raises :class:`OwnerFailure`
        when every replica is down (there is no partial result to
        degrade to — replicas hold the SAME relation)."""
        m0, pos = first[0], first[1]
        errors = [first[6].error]
        retries = first[6].retries
        for step in range(1, len(self.members)):
            mid = (m0 + step) % len(self.members)
            obs.registry().counter(
                "deepmap_fault_failovers_total",
                "Replicate-mode lookups failed over to another replica.",
            ).inc(member=mid)
            # Handle-less part: _visit_member's attempt 0 dispatches
            # fresh on the failover member.
            visit = self._visit_member(
                pending, (mid, pos, (False, None)), aggregate=aggregate
            )
            retries += visit[6].retries
            if visit[6].ok:
                return visit, tuple(errors), retries
            errors.append(visit[6].error)
        raise OwnerFailure(tuple(errors))

    def _collect_lookup(self, pending: _PendingFederatedLookup):
        """Morsel-parallel gather: collect the members' host halves —
        on the lazy fan-out pool when more than one member answered
        (``Query.fanout(False)`` restores serial visits) — and permute
        results back to request order.

        Failure semantics: each member's collect runs under the
        bounded-retry guard.  Replicate mode fails over to the next
        replica until one serves (lookups keep succeeding with any
        healthy replica); partition mode degrades around failed members
        under ``on_error='partial'`` or raises :class:`OwnerFailure`."""
        n = pending.keys.shape[0]
        agg = ExplainStats(route_s=pending.route_s, async_fanout=pending.use_fanout)

        if pending.use_fanout:
            visited = self._fanout.map(
                lambda p: self._visit_member(pending, p),
                pending.parts, owners=len(self.members),
            )
        else:
            visited = [self._visit_member(pending, p) for p in pending.parts]

        failover_errors: Tuple = ()
        if self.mode == "replicate" and not visited[0][6].ok:
            winner, failover_errors, retries = self._failover_replicate(
                pending, visited[0]
            )
            visited = [winner]
            agg.retries += retries - winner[6].retries

        healthy = [v for v in visited if v[6].ok]
        errors = tuple(v[6].error for v in visited if not v[6].ok)
        if errors and (pending.on_error != "partial" or not healthy):
            raise OwnerFailure(errors)
        agg.retries += sum(v[6].retries for v in visited)
        agg.owners_failed = tuple(
            e.describe() for e in tuple(failover_errors) + errors
        )
        agg.keys_unresolved = sum(
            int(v[1].shape[0]) for v in visited if not v[6].ok
        )

        collected = []
        member_plan: Tuple[str, ...] = ()
        for _, pos, values, exists, match, stats, _ in healthy:
            agg.merge_timings(stats)
            if not member_plan:
                member_plan = stats.plan
            collected.append((pos, values, exists, match))
        t0 = time.perf_counter()
        if pending.predicates and any(m is None for _, _, _, m in collected):
            # Contract: a member given predicates must return a match
            # selector; substituting "nothing matched" would silently
            # drop rows instead of surfacing the broken member hook.
            raise RuntimeError(
                "federation member returned match=None for a predicated "
                "lookup; its _collect_lookup violates the hook contract"
            )
        if len(collected) == 1 and not errors and np.array_equal(
            collected[0][0], np.arange(n, dtype=np.int64)
        ):
            # One member answered the whole batch in request order
            # (always true in replicate mode): the inverse permutation
            # is the identity — skip the per-column fancy-index copies.
            _, values, exists, match = collected[0]
        elif errors:
            values, exists, _covered = gather_parts_partial(
                n, ((p, v, e) for p, v, e, _ in collected)
            )
            match = None
            if pending.predicates:
                # Failed members' positions stay False: unreachable
                # rows are excluded from filtered results (the
                # keys_unresolved evidence keeps the count).
                match = np.zeros(n, dtype=bool)
                for pos, _, _, m in collected:
                    match[pos] = m
        else:
            values, exists = gather_parts(
                n, ((p, v, e) for p, v, e, _ in collected)
            )
            match = None
            if pending.predicates:
                match = np.zeros(n, dtype=bool)
                for pos, _, _, m in collected:
                    match[pos] = m
        agg.gather_s += time.perf_counter() - t0
        agg.plan = (
            f"federate[{self.mode}:"
            f"{','.join(str(m) for m in pending.member_ids)}]",
        ) + member_plan
        return values, exists, match, agg

    def _collect_aggregate(self, pending: _PendingFederatedLookup, group_by, aggregates):
        """Federated ``group_by(...).agg(...)``: each member folds its
        part through its own aggregate hook (code space on DeepMapping
        members — zero rows decoded; decode-then-aggregate on baseline
        members), and the facade merges the partial states.  Decoded
        group values are the shared vocabulary, so a federation mixing
        store types still aggregates exactly.  Replicate mode fails
        over to the next replica; partition mode degrades around failed
        members under ``on_error='partial')`` with the usual
        evidence."""
        agg = ExplainStats(route_s=pending.route_s, async_fanout=pending.use_fanout)
        spec = (group_by, aggregates)

        if pending.use_fanout:
            visited = self._fanout.map(
                lambda p: self._visit_member(pending, p, aggregate=spec),
                pending.parts, owners=len(self.members),
            )
        else:
            visited = [
                self._visit_member(pending, p, aggregate=spec)
                for p in pending.parts
            ]

        failover_errors: Tuple = ()
        if self.mode == "replicate" and not visited[0][6].ok:
            winner, failover_errors, retries = self._failover_replicate(
                pending, visited[0], aggregate=spec
            )
            visited = [winner]
            agg.retries += retries - winner[6].retries

        healthy = [v for v in visited if v[6].ok]
        errors = tuple(v[6].error for v in visited if not v[6].ok)
        if errors and (pending.on_error != "partial" or not healthy):
            raise OwnerFailure(errors)
        agg.retries += sum(v[6].retries for v in visited)
        agg.owners_failed = tuple(
            e.describe() for e in tuple(failover_errors) + errors
        )
        agg.keys_unresolved = sum(
            int(v[1].shape[0]) for v in visited if not v[6].ok
        )

        state: Dict[tuple, list] = {}
        member_plan: Tuple[str, ...] = ()
        for _, _, part_state, _, _, stats, _ in healthy:
            agg.merge_timings(stats)
            if not member_plan:
                member_plan = stats.plan
            merge_agg_states(state, part_state, aggregates)
        agg.plan = (
            f"federate[{self.mode}:"
            f"{','.join(str(m) for m in pending.member_ids)}]",
        ) + member_plan
        return state, agg

    def lookup(
        self, keys: np.ndarray, columns: Optional[Tuple[str, ...]] = None
    ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
        """Batched exact-match lookup across the members (scatter in
        partition mode, one replica in replicate mode)."""
        values, exists, _, _ = self._collect_lookup(
            self._dispatch_lookup(keys, columns)
        )
        return values, exists

    def _range_keys(self, lo: int, hi: Optional[int]) -> np.ndarray:
        if self.mode == "replicate":
            # Health-aware: a quarantined primary must not source the
            # range/scan key stream either.
            return self.members[self.health.pick(self._names, 0)]._range_keys(
                lo, hi
            )
        parts = []
        for i, m in enumerate(self.members):
            m_lo = lo if i == 0 else max(lo, int(self.boundaries[i - 1]))
            m_hi = hi if i == len(self.members) - 1 else (
                int(self.boundaries[i])
                if hi is None
                else min(hi, int(self.boundaries[i]))
            )
            if m_hi is not None and m_hi <= m_lo:
                continue
            part = m._range_keys(m_lo, m_hi)
            if part.size:
                parts.append(part)
        if not parts:
            return np.zeros(0, dtype=np.int64)
        # members are ordered by boundary, so concatenation is ascending
        return np.concatenate(parts)

    # ---------------------------------------------------------- mutations
    # Validated against EVERY affected member before mutating ANY
    # (same discipline as the sharded facade): a rejected batch must
    # leave the federation untouched, not half-mutated up to the
    # member that raised.
    # Queue bookkeeping is NOT store state: a queued op changes no
    # query result until flush applies it through the members' public
    # mutators, which bump their mutation versions themselves.
    # deeplint: ignore[mutation-version]
    def _mutation_gate(self, op: str, keys, columns) -> bool:
        """Replicate-mode admission for one mutation.  Returns True to
        proceed now.  With a quarantined replica: ``"reject"`` raises
        (nothing mutates, replicas cannot diverge); ``"queue"`` buffers
        the op — applied in order by :meth:`flush_mutations` — and
        returns False.  Queued ops are flushed here first, so a
        mutation can never overtake an earlier queued one."""
        if self.mode != "replicate":
            return True
        self.flush_mutations()
        quarantined = [
            n for n in self._names if self.health.is_quarantined(n)
        ]
        if not quarantined:
            return True
        reg = obs.registry()
        if self.mutation_policy == "reject":
            reg.counter(
                "deepmap_fault_mutations_rejected_total",
                "Replicate-mode mutations rejected while a replica is "
                "quarantined (mutation_policy='reject').",
            ).inc(op=op)
            raise RuntimeError(
                f"{op} rejected: replica(s) {quarantined} are quarantined "
                f"and would diverge; retry after recovery or construct the "
                f"federation with mutation_policy='queue'"
            )
        reg.counter(
            "deepmap_fault_mutations_queued_total",
            "Replicate-mode mutations queued while a replica is "
            "quarantined (mutation_policy='queue').",
        ).inc(op=op)
        self._mutation_queue.append((op, keys, columns))
        return False

    # Pops happen only after _apply_replicate already mutated through
    # the members' public ops (which bump their versions) — the queue
    # itself is never consulted by a lookup.
    # deeplint: ignore[mutation-version]
    def flush_mutations(self) -> int:
        """Apply queued replicate-mode mutations in arrival order, once
        every replica is healthy again; returns the number applied (0
        while any replica stays quarantined).  A queued op that fails
        validation at flush time raises, leaving it and its successors
        queued — order is never reordered around a failure."""
        if not self._mutation_queue:
            return 0
        if any(self.health.is_quarantined(n) for n in self._names):
            return 0
        applied = 0
        while self._mutation_queue:
            op, keys, columns = self._mutation_queue[0]
            self._apply_replicate(op, keys, columns)
            self._mutation_queue.pop(0)
            applied += 1
        return applied

    def _apply_replicate(self, op: str, keys, columns) -> None:
        """Validate-all-then-mutate one replicate-mode op (the pre-gate
        mutation body, shared by the direct path and the flush)."""
        if op == "insert":
            # every member validates (a drifted replica must reject the
            # batch BEFORE any member mutates, or replicas diverge more)
            for m in self.members:
                if m.lookup(keys, columns=())[1].any():
                    raise ValueError("insert of existing key; use update()")
            for m in self.members:
                m.insert(keys, columns)
        elif op == "delete":
            for m in self.members:
                m.delete(keys)
        else:
            for m in self.members:
                if not m.lookup(keys, columns=())[1].all():
                    raise ValueError("update of non-existing key; use insert()")
            for m in self.members:
                m.update(keys, columns)

    def insert(self, keys: np.ndarray, columns: Dict[str, np.ndarray]) -> None:
        """Insert new rows — routed to owners (partition) or applied to
        every member (replicate); validated before any member mutates."""
        keys = np.asarray(keys, dtype=np.int64)
        if keys.size and np.unique(keys).size != keys.size:
            raise ValueError("duplicate keys in insert batch")
        if self.mode == "replicate":
            if self._mutation_gate("insert", keys, columns):
                self._apply_replicate("insert", keys, columns)
            return
        batches = self._scatter(keys)
        for mid, pos in batches:
            if self.members[mid].lookup(keys[pos], columns=())[1].any():
                raise ValueError("insert of existing key; use update()")
        for mid, pos in batches:
            self.members[mid].insert(
                keys[pos], {c: v[pos] for c, v in columns.items()}
            )

    def delete(self, keys: np.ndarray) -> None:
        """Idempotent like the members — no validation needed."""
        keys = np.asarray(keys, dtype=np.int64)
        if self.mode == "replicate":
            if self._mutation_gate("delete", keys, None):
                self._apply_replicate("delete", keys, None)
            return
        for mid, pos in self._scatter(keys):
            self.members[mid].delete(keys[pos])

    def update(self, keys: np.ndarray, columns: Dict[str, np.ndarray]) -> None:
        """Overwrite existing rows (validated against every affected
        member before mutating any, like :meth:`insert`)."""
        keys = np.asarray(keys, dtype=np.int64)
        if self.mode == "replicate":
            if self._mutation_gate("update", keys, columns):
                self._apply_replicate("update", keys, columns)
            return
        batches = self._scatter(keys)
        for mid, pos in batches:
            if not self.members[mid].lookup(keys[pos], columns=())[1].all():
                raise ValueError("update of non-existing key; use insert()")
        for mid, pos in batches:
            self.members[mid].update(
                keys[pos], {c: v[pos] for c, v in columns.items()}
            )

    def mutation_version(self):
        """Tuple of member tokens: a mutation through the facade OR
        directly on a member store invalidates the federation's cached
        plans (members are caller-owned and reachable)."""
        return tuple(m.mutation_version() for m in self.members)

    # --------------------------------------------------------- accounting
    @property
    def num_rows(self) -> int:
        """Logical row count (member sum in partition mode; member 0's
        in replicate mode — replicas hold the same relation)."""
        if self.mode == "replicate":
            return int(self.members[0].num_rows)
        return int(sum(m.num_rows for m in self.members))

    def size_breakdown(self) -> Dict[str, int]:
        """Per-member storage accounting, keys namespaced ``memberN.*``."""
        out: Dict[str, int] = {}
        for i, m in enumerate(self.members):
            for k, v in m.size_breakdown().items():
                out[f"member{i}.{k}"] = v
        return out

    # ----------------------------------------------------------- teardown
    def close(self) -> None:
        """Release the collect fan-out pool's threads (idempotent; the
        federation stays usable — a later fan-out re-creates the pool).
        Member stores are caller-owned and NOT closed here; close a
        sharded member's own pool with ``member.close()``."""
        self._fanout.close()

    def __enter__(self) -> "FederatedStore":
        """Context-manager entry; :meth:`close` runs on exit."""
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        """Close the fan-out pool on scope exit."""
        self.close()

    # -------------------------------------------------------- persistence
    def save(self, path: str) -> None:
        """Intentionally unsupported — persist members individually."""
        raise NotImplementedError(
            "a federation is a runtime composition; save each member "
            "store individually and recompose with FederatedStore(...)"
        )

    @classmethod
    def load(cls, path: str, pool=None) -> "FederatedStore":
        """Intentionally unsupported — load members and recompose."""
        raise NotImplementedError(
            "load the member stores individually (repro_torch.open) and "
            "recompose with FederatedStore(...)"
        )
