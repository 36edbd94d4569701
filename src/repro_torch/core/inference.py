"""Device lookup inference engine — the port of ``repro.core.inference``.

:class:`InferenceEngine` owns the device side of Algorithm 1:

* **Cached padded weights.**  Per task subset (projection pushdown) the
  padded flat device weights and the subset spec/params view are built
  once and reused by every later call.
* **Power-of-two buckets.**  Batch sizes round up to powers of two at or
  above ``tile_n``; ``EngineStats.compiles`` counts distinct (tier,
  spec, bucket) signatures, as the reference counts compiled programs.
* **Fused key-encode + existence kernel.**  With ``use_kernels`` the
  engine ships raw int32 keys; digit/residue decomposition, the model,
  the argmax and the existence test run in one CUDA launch
  (``repro_torch.kernels.fused_mlp.fused_lookup_call``).
* **dispatch()/collect() pipeline.**  ``dispatch`` only enqueues work on
  the current CUDA stream and returns; ``collect`` copies the result to
  the host, which synchronises.  Callers dispatch chunk ``i+1`` before
  collecting chunk ``i``.

Tier ladder, chosen only by the reference's eligibility rules
(``repro.core.inference``; a kernel failure raises, it never moves a
call down the ladder): ``fused`` (K1) needs ``use_kernels``, an attached
:class:`BitVector`, key and word domains within int32, and the budget of
``kernels.ops.vmem_budget_bytes``; ``pallas_digits`` (K2 on host
digits; the tier keeps the reference's name, since stats key on it);
``fused_streamed`` (K1 per head page, pages after the first without
existence); ``jit_keys`` and ``jit_digits``, plain PyTorch because the
reference's are plain ``jax.jit``.  Every tier produces the same codes
and existence bits.  On CPU tensors the kernel tiers run the kernels'
plain versions.
"""

from __future__ import annotations

import dataclasses
import threading
import weakref
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import model as model_lib
from repro_torch.core.model import MLPSpec
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.fault import injection as fault_injection
from repro_torch.kernels import fused_mlp as fm_kernel
from repro_torch.kernels import ops as kops

INT32_MAX = 2**31 - 1

#: Host work trails device dispatch by this many in-flight chunks.
PIPELINE_DEPTH = 2


@dataclasses.dataclass
class EngineStats:
    """Aggregate engine counters.  One instance may be shared by every
    engine of an :class:`EngineCache`, so signatures dedupe across
    stores with identical architecture and bucket shapes."""

    dispatches: int = 0
    fused_calls: int = 0
    fused_streamed_calls: int = 0
    pallas_calls: int = 0
    jit_calls: int = 0
    host_featurize_calls: int = 0
    weight_cache_misses: int = 0
    word_uploads: int = 0
    #: Resolved tier budget (bytes) of the engine(s) sharing this stats
    #: object — not a counter.
    vmem_budget_bytes: int = 0

    def __post_init__(self) -> None:
        self._seen: set = set()  # guarded-by: _lock
        self._lock = threading.Lock()

    @property
    def compiles(self) -> int:
        """Distinct (tier, spec, bucket) signatures observed."""
        return len(self._seen)

    def note_compile(self, key: Tuple) -> None:
        with self._lock:
            new = key not in self._seen
            self._seen.add(key)
        if new:
            obs.counter(
                "deepmap_engine_compiles_total",
                "Distinct launch signatures (bucketed shapes dedupe; a "
                "shared EngineCache dedupes across stores).",
            ).inc()

    def bump(self, field: str, amount: int = 1) -> None:
        """Locked counter increment, mirrored into the metrics registry as
        ``deepmap_engine_events_total{event=<field>}``."""
        with self._lock:
            setattr(self, field, getattr(self, field) + amount)
        obs.counter(
            "deepmap_engine_events_total",
            "Engine events by type: dispatches, tier taken "
            "(fused_calls/pallas_calls/jit_calls), host featurize, "
            "weight-cache misses, bitvector word uploads.",
        ).inc(amount, event=field)


def _codes_from_keys(
    params: Dict,
    keys: torch.Tensor,
    spec: MLPSpec,
    pos_ops: Tuple[Tuple[int, int], ...],
    capacity: int,
) -> torch.Tensor:
    """Plain twin of the fused kernel's key path: digit/residue
    decomposition on the device, gather-forward, per-task argmax.  Rows
    outside ``[0, capacity)`` get code 0 — the ``_infer_codes`` zero-fill
    contract."""
    k = keys.to(torch.int64)
    in_cap = (k >= 0) & (k < capacity)
    safe = torch.where(in_cap, k, torch.zeros_like(k))
    digits = torch.stack(
        [((safe % mod) // div) % spec.base for mod, div in pos_ops], dim=1
    )
    codes = model_lib.predict_codes(params, digits, spec)
    return torch.where(in_cap[:, None], codes, torch.zeros_like(codes))


class _TaskEntry:
    """Per-task-subset cache: subset spec + params view, and (lazily)
    the padded flat device weights the kernel tiers reuse."""

    __slots__ = ("spec", "params", "_flat", "_wbytes")

    def __init__(self, spec: MLPSpec, params: Dict):
        self.spec = spec
        self.params = params
        self._flat: Optional[Tuple[torch.Tensor, ...]] = None
        self._wbytes = 0

    def flat(self) -> Tuple[Tuple[torch.Tensor, ...], int]:
        if self._flat is None:
            self._flat, self._wbytes = kops.pad_flat_weights(self.params, self.spec)
        return self._flat, self._wbytes


@dataclasses.dataclass
class InferTicket:
    """In-flight device work handle returned by ``dispatch``."""

    n: int
    tasks: Tuple[str, ...]                 # requested column order
    path: str
    keys: np.ndarray                       # original int64 chunk keys
    want_exists: bool = False
    codes_dev: object = None               # device tensor / tuple, path-shaped
    exists_dev: object = None              # (n_pad,) int32 device tensor (fused)
    match_dev: object = None               # (n_pad,) int32 kernel match bits
    in_cap: Optional[np.ndarray] = None    # host mask (digits paths only)
    task_order: Tuple[str, ...] = ()       # device result order (spec canonical)
    #: Host copy of the in-kernel predicate match bits, filled by
    #: ``collect`` — None when the kernel did not filter.
    match: Optional[np.ndarray] = None


class InferenceEngine:
    """Per-store device inference: weight cache, bucketing, pipeline.

    ``device=None`` means CUDA and raises without a GPU; pass
    ``device="cpu"`` for the plain PyTorch path.  ``use_kernels`` is the
    counterpart of the reference's ``use_pallas``.  ``vexist`` may be
    attached after construction (build-time misclassification evaluation
    runs before the bitvector exists).
    """

    def __init__(
        self,
        encoder,
        spec: MLPSpec,
        params: Dict,
        vexist=None,
        *,
        use_kernels: bool = True,
        tile_n: int = kops.DEFAULT_TILE_N,
        max_bucket: int = 1 << 16,
        stats: Optional[EngineStats] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.encoder = encoder
        self.spec = spec
        self.params = model_lib._map_tree(params, lambda t: t.detach().to(self.device))
        self.vexist = vexist
        self.use_kernels = bool(use_kernels)
        self.tile_n = int(tile_n)
        self.max_bucket = max(int(max_bucket), self.tile_n)
        # Resolved once per engine: tier selection must be stable across
        # a store's lifetime (REPRO_VMEM_BUDGET changes need a new engine).
        self.vmem_budget = kops.vmem_budget_bytes()
        self.stats = stats if stats is not None else EngineStats()
        self.stats.vmem_budget_bytes = self.vmem_budget
        self._lock = threading.Lock()
        self._entries: Dict[Tuple[str, ...], _TaskEntry] = {}  # guarded-by: _lock
        self._pos_ops = tuple(encoder.position_ops())
        self._pos_ops_dev: Optional[torch.Tensor] = None
        self._words_cache: Optional[Tuple[int, torch.Tensor]] = None  # guarded-by: _lock

    def bind_vexist(self, vexist) -> None:
        """Swap the engine's bitvector binding, dropping the device word
        cache (its version key is only meaningful per bitvector)."""
        with self._lock:
            self.vexist = vexist
            self._words_cache = None

    @classmethod
    def for_store(cls, store, stats: Optional[EngineStats] = None) -> "InferenceEngine":
        cfg = store.config
        return cls(
            store.encoder,
            store.spec,
            store.params,
            store.vexist,
            use_kernels=cfg.use_kernels,
            max_bucket=cfg.inference_batch,
            stats=stats,
            device=store.device,
        )

    # ------------------------------------------------------------- caches
    def _entry(self, tasks: Tuple[str, ...]) -> _TaskEntry:
        entry = self._entries.get(tasks)
        if entry is None:
            with self._lock:
                entry = self._entries.get(tasks)
                if entry is None:
                    if tasks == self.spec.tasks:
                        spec, params = self.spec, self.params
                    else:
                        spec = MLPSpec(
                            base=self.spec.base,
                            width=self.spec.width,
                            shared=self.spec.shared,
                            private={t: self.spec.private_map[t] for t in tasks},
                            out_cards={t: self.spec.card_map[t] for t in tasks},
                            dtype=self.spec.dtype,
                        )
                        params = {
                            "shared": self.params["shared"],
                            "heads": {t: self.params["heads"][t] for t in tasks},
                        }
                    entry = _TaskEntry(spec, params)
                    self._entries[tasks] = entry
                    self.stats.bump("weight_cache_misses")
        return entry

    def _device_words(self) -> torch.Tensor:
        """Device copy of the packed existence words (int32 view),
        re-uploaded only when the bitvector's mutation counter moves."""
        v = self.vexist
        with self._lock:
            cached = self._words_cache
            if cached is None or cached[0] != v.version:
                self._words_cache = (v.version, kops.words_tensor(v.words, self.device))
                self.stats.bump("word_uploads")
            return self._words_cache[1]

    def _device_pos_ops(self) -> torch.Tensor:
        if self._pos_ops_dev is None:
            self._pos_ops_dev = torch.tensor(
                self._pos_ops, dtype=torch.int32, device=self.device
            ).reshape(-1, 2)
        return self._pos_ops_dev

    def _bucket(self, n: int) -> int:
        b = self.tile_n
        while b < n:
            b <<= 1
        return b

    # -------------------------------------------------------- path choice
    # Eligibility uses shape-derived byte counts (padded_weight_bytes),
    # NOT entry.flat(): deciding against a kernel tier must not
    # materialize — and cache — a padded weight copy it never uses.
    def _fused_eligible(self, entry: _TaskEntry) -> bool:
        v = self.vexist
        if v is None or self.encoder.capacity > INT32_MAX:
            return False
        if v.capacity > INT32_MAX + 1:
            return False
        vmem = (
            kops.padded_weight_bytes(entry.spec)
            + kops.activation_bytes(entry.spec, self.tile_n)
            + int(v.words.nbytes)
        )
        return vmem <= self.vmem_budget

    def _pallas_eligible(self, entry: _TaskEntry) -> bool:
        return (
            kops.padded_weight_bytes(entry.spec)
            + kops.activation_bytes(entry.spec, self.tile_n)
            <= self.vmem_budget
        )

    def kernel_filter_capable(self, tasks: Optional[Tuple[str, ...]] = None) -> bool:
        """True when ``dispatch(..., want_exists=True, pred_tables=...)``
        for this task subset would take the resident ``fused`` tier — the
        only tier that evaluates predicate code tables in-kernel."""
        if not self.use_kernels:
            return False
        if tasks is None:
            canon = self.spec.tasks
        else:
            keep = frozenset(tasks)
            canon = tuple(t for t in self.spec.tasks if t in keep)
        if not canon:
            return False
        return self._fused_eligible(self._entry(canon))

    def _streamed_plan(
        self, entry: _TaskEntry, want_exists: bool
    ) -> Optional[Tuple[Tuple[Tuple[str, ...], ...], bool]]:
        """Page plan for the ``fused_streamed`` tier, or None when it
        cannot apply.  Returns ``(pages, with_exists)`` — existence rides
        with page 0 only when the bitvector fits alongside its heads."""
        if self.encoder.capacity > INT32_MAX:
            return None
        v = self.vexist
        with_exists = want_exists and v is not None and v.capacity <= INT32_MAX + 1
        words_bytes = int(v.words.nbytes) if with_exists else 0
        pages = kops.plan_head_pages(
            entry.spec, self.tile_n, words_bytes=words_bytes, budget=self.vmem_budget,
        )
        if pages is None and with_exists:
            with_exists = False
            pages = kops.plan_head_pages(entry.spec, self.tile_n, budget=self.vmem_budget)
        if pages is None:
            return None
        return pages, with_exists

    # ---------------------------------------------------- dispatch/collect
    def dispatch(
        self,
        keys: np.ndarray,
        tasks: Optional[Tuple[str, ...]] = None,
        want_exists: bool = False,
        pred_tables: Optional[Tuple[Tuple[str, np.ndarray], ...]] = None,
    ) -> InferTicket:
        """Enqueue device inference for one key chunk on the current
        stream; returns without waiting.  ``want_exists`` additionally
        requests existence bits — in-kernel on the fused tier, host
        ``BitVector.test`` by the caller otherwise.  ``pred_tables`` —
        ``((column, bool_code_table), ...)`` — asks the fused kernel for
        predicate match bits (``InferTicket.match`` after collect)."""
        keys = np.asarray(keys, dtype=np.int64)
        tasks = self.spec.tasks if tasks is None else tuple(tasks)
        n = keys.shape[0]
        if n == 0 or not tasks:
            return InferTicket(n=n, tasks=tasks, path="empty", keys=keys,
                               want_exists=want_exists)
        # Fault-injection site: after the zero-length early-out so the
        # executor's typed-empty probes (used to build placeholder
        # columns in degraded mode) are never themselves failed.
        fault_injection.maybe_fail("engine_dispatch")
        self.stats.bump("dispatches")
        # Device result columns follow spec order; collect() permutes
        # back to the requested order.
        canon = tuple(t for t in self.spec.tasks if t in frozenset(tasks))
        entry = self._entry(canon)
        bucket = self._bucket(n)

        with torch.no_grad():
            if self.use_kernels and want_exists and self._fused_eligible(entry):
                ticket = self._dispatch_fused(keys, tasks, entry, bucket, pred_tables)
            elif self.use_kernels and self._pallas_eligible(entry):
                ticket = self._dispatch_pallas_digits(keys, tasks, entry, bucket,
                                                      want_exists)
            elif self.use_kernels and (
                plan := self._streamed_plan(entry, want_exists)
            ) is not None:
                ticket = self._dispatch_fused_streamed(keys, tasks, entry, bucket, *plan)
            elif self.encoder.capacity <= INT32_MAX:
                ticket = self._dispatch_jit_keys(keys, tasks, entry, bucket, want_exists)
            else:
                ticket = self._dispatch_jit_digits(keys, tasks, entry, bucket,
                                                   want_exists)
        ticket.task_order = entry.spec.tasks
        return ticket

    def _keys_dev(self, keys: np.ndarray, bucket: int) -> torch.Tensor:
        """int32 device keys with a -1 sentinel for unrepresentable keys
        (masked to code 0 / exist 0 on the device, which matches the host
        contract because the gated domains fit int32); padding rows get
        the same sentinel."""
        kp = np.full(bucket, -1, dtype=np.int32)
        valid = (keys >= 0) & (keys <= INT32_MAX)
        kp[: keys.shape[0]] = np.where(valid, keys, -1).astype(np.int32)
        return torch.from_numpy(kp).to(self.device)

    def _kernel_pred_tables(
        self, entry: _TaskEntry, pred_tables
    ) -> Tuple[Tuple[int, ...], Tuple[torch.Tensor, ...]]:
        """Padded int32 device tables + head indices for in-kernel
        filtering, or ``((), ())`` when any table's column is outside the
        dispatched task subset.  Only the first ``card`` entries of each
        host table are shipped: model codes never reach past the card."""
        if not pred_tables:
            return (), ()
        spec = entry.spec
        cards = spec.card_map
        ptasks, ptabs = [], []
        for col, table in pred_tables:
            if col not in cards:
                return (), ()
            card = cards[col]
            padded = np.zeros(kops._round_up(card, kops.LANE), dtype=np.int32)
            padded[:card] = np.asarray(table[:card], dtype=np.int32)
            ptasks.append(spec.tasks.index(col))
            ptabs.append(torch.from_numpy(padded).to(self.device))
        return tuple(ptasks), tuple(ptabs)

    def _dispatch_fused(self, keys, tasks, entry, bucket, pred_tables=None) -> InferTicket:
        flat, _ = entry.flat()
        words = self._device_words()
        ptasks, ptabs = self._kernel_pred_tables(entry, pred_tables)
        self.stats.bump("fused_calls")
        self.stats.note_compile(
            ("fused", entry.spec, self.encoder.capacity, bucket,
             words.shape[0], ptasks, tuple(t.shape[0] for t in ptabs))
        )
        codes, exists, match = kops.fused_lookup(
            flat, entry.spec, self._keys_dev(keys, bucket),
            self._device_pos_ops(), words, self.encoder.capacity,
            tile_n=self.tile_n, pred_tables=ptabs, pred_tasks=ptasks,
        )
        return InferTicket(n=keys.shape[0], tasks=tasks, path="fused",
                           keys=keys, want_exists=True, codes_dev=codes,
                           exists_dev=exists, match_dev=match)

    def _dispatch_fused_streamed(
        self, keys, tasks, entry, bucket, pages, with_exists
    ) -> InferTicket:
        """Over-budget fused tier: one ``fused_lookup`` per head page on
        the same device key buffer, enqueued back to back.  The shared
        trunk is recomputed per page; each page is exactly the resident
        kernel on a task subset.  Existence rides with page 0 when
        ``with_exists``."""
        keys_dev = self._keys_dev(keys, bucket)
        pos_ops = self._device_pos_ops()
        words = self._device_words() if with_exists else None
        self.stats.bump("fused_streamed_calls")
        codes_pages = []
        exists_dev = None
        for i, page in enumerate(pages):
            page_entry = self._entry(page)
            flat, _ = page_entry.flat()
            page_exists = with_exists and i == 0
            self.stats.note_compile(
                ("fused_streamed", page_entry.spec, self.encoder.capacity,
                 bucket, words.shape[0] if page_exists else 0, page_exists)
            )
            codes, ex, _ = kops.fused_lookup(
                flat, page_entry.spec, keys_dev, pos_ops,
                words if page_exists else None, self.encoder.capacity,
                tile_n=self.tile_n, with_exists=page_exists,
            )
            codes_pages.append(codes)
            if page_exists:
                exists_dev = ex
        return InferTicket(n=keys.shape[0], tasks=tasks, path="fused_streamed",
                           keys=keys, want_exists=with_exists,
                           codes_dev=tuple(codes_pages), exists_dev=exists_dev)

    def _dispatch_jit_keys(self, keys, tasks, entry, bucket, want_exists):
        self.stats.bump("jit_calls")
        self.stats.note_compile(("jit_keys", entry.spec, self.encoder.capacity, bucket))
        codes = _codes_from_keys(
            entry.params, self._keys_dev(keys, bucket), entry.spec,
            self._pos_ops, self.encoder.capacity,
        )
        return InferTicket(n=keys.shape[0], tasks=tasks, path="jit_keys",
                           keys=keys, want_exists=want_exists, codes_dev=codes)

    def _host_digits(self, keys: np.ndarray, bucket: int):
        """Host featurization: digits of in-capacity keys, zero rows
        elsewhere."""
        self.stats.bump("host_featurize_calls")
        in_cap = (keys >= 0) & (keys < self.encoder.capacity)
        dp = np.zeros((bucket, self.encoder.width), dtype=np.int32)
        idx = np.flatnonzero(in_cap)
        if idx.size:
            dp[idx] = self.encoder.digits(keys[idx])
        return torch.from_numpy(dp).to(self.device), in_cap

    def _dispatch_pallas_digits(self, keys, tasks, entry, bucket, want_exists):
        flat, _ = entry.flat()
        dp, in_cap = self._host_digits(keys, bucket)
        self.stats.bump("pallas_calls")
        self.stats.note_compile(("pallas_digits", entry.spec, bucket))
        codes = fm_kernel.fused_mlp_call(
            dp, flat, entry.spec, self.tile_n,
            kops._round_up(entry.spec.base, kops.LANE), kops.card_pads(entry.spec),
            emit_codes=True,
        )
        return InferTicket(n=keys.shape[0], tasks=tasks, path="pallas_digits",
                           keys=keys, want_exists=want_exists,
                           codes_dev=codes, in_cap=in_cap)

    def _dispatch_jit_digits(self, keys, tasks, entry, bucket, want_exists):
        dp, in_cap = self._host_digits(keys, bucket)
        self.stats.bump("jit_calls")
        self.stats.note_compile(("jit_digits", entry.spec, bucket))
        codes = model_lib.predict_codes(entry.params, dp, entry.spec)
        return InferTicket(n=keys.shape[0], tasks=tasks, path="jit_digits",
                           keys=keys, want_exists=want_exists,
                           codes_dev=codes, in_cap=in_cap)

    def collect(self, ticket: InferTicket):
        """Copy a ticket's result to the host (synchronising) ->
        ``(codes (n, m) int32, exists | None)``.  ``exists`` is a bool
        array only when the fused kernel computed it; on every other path
        it is None and the caller runs the host ``BitVector.test``."""
        n = ticket.n
        if ticket.path == "empty":
            return np.zeros((n, len(ticket.tasks)), dtype=np.int32), None

        if ticket.path == "fused_streamed":
            # one (n_pad, page_tasks) block per page, spec order overall
            codes = torch.cat([c[:n] for c in ticket.codes_dev], dim=1)
        else:
            codes = ticket.codes_dev[:n]
        codes = codes.cpu().numpy()
        if ticket.task_order and ticket.tasks != ticket.task_order:
            # requested projection order differs from spec canonical
            perm = [ticket.task_order.index(t) for t in ticket.tasks]
            codes = codes[:, perm]
        if ticket.in_cap is not None and not ticket.in_cap.all():
            codes[~ticket.in_cap] = 0

        exists = None
        if ticket.exists_dev is not None:
            exists = ticket.exists_dev[:n].cpu().numpy().astype(bool)
        if ticket.match_dev is not None:
            ticket.match = ticket.match_dev[:n].cpu().numpy().astype(bool)
        return codes, exists

    # ------------------------------------------------------- convenience
    def stream(
        self,
        chunks,
        tasks: Optional[Tuple[str, ...]] = None,
        want_exists: bool = False,
        depth: int = PIPELINE_DEPTH,
    ):
        """Windowed dispatch/collect over an iterable of key chunks: chunk
        *i+1*'s device work is enqueued before chunk *i* is copied out,
        with at most ``depth`` chunks in flight.  Yields
        ``(ticket, codes, exists)`` per chunk in input order."""
        tasks = self.spec.tasks if tasks is None else tuple(tasks)
        pending: list = []
        for chunk in chunks:
            pending.append(self.dispatch(chunk, tasks, want_exists=want_exists))
            if len(pending) >= depth:
                t = pending.pop(0)
                codes, exists = self.collect(t)
                yield t, codes, exists
        for t in pending:
            codes, exists = self.collect(t)
            yield t, codes, exists

    def infer(self, keys: np.ndarray, tasks: Optional[Tuple[str, ...]] = None) -> np.ndarray:
        """Codes for a key batch of any size: chunks of ``max_bucket``
        flow through the dispatch/collect pipeline."""
        keys = np.asarray(keys, dtype=np.int64)
        tasks = self.spec.tasks if tasks is None else tuple(tasks)
        n = keys.shape[0]
        out = np.zeros((n, len(tasks)), dtype=np.int32)
        if n == 0 or not tasks:
            return out
        chunks = (
            keys[start : start + self.max_bucket]
            for start in range(0, n, self.max_bucket)
        )
        start = 0
        for ticket, codes, _ in self.stream(chunks, tasks):
            out[start : start + ticket.n] = codes
            start += ticket.n
        return out


class EngineCache:
    """Store -> engine map with ONE shared :class:`EngineStats` (weak
    keys: dropping a store drops its engine)."""

    def __init__(self) -> None:
        self.stats = EngineStats()
        self._engines: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()  # guarded-by: _lock
        self._lock = threading.Lock()

    def engine_for(self, store) -> InferenceEngine:
        eng = self._engines.get(store)
        if eng is None:
            with self._lock:
                eng = self._engines.get(store)
                if eng is None:
                    eng = InferenceEngine.for_store(store, stats=self.stats)
                    self._engines[store] = eng
        return eng

    def adopt(self, store) -> InferenceEngine:
        """Bind ``store``'s engine into this cache: a store that already
        owns an engine keeps its weight cache and switches to the shared
        stats; otherwise a fresh engine is attached."""
        eng = getattr(store, "_engine", None)
        if eng is not None:
            eng.stats = self.stats
            with self._lock:
                self._engines[store] = eng
            return eng
        eng = self.engine_for(store)
        store.attach_engine(eng)
        return eng
