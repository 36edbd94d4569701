"""Bind and launch the fused CUDA kernels (``csrc/fused_mlp.cu``).

Two entry points share the kernel source's one device forward:

* ``fused_mlp_call``    — digits in, codes or logits out (K2; replaces
  ``repro.kernels.fused_mlp.fused_mlp_call``);
* ``fused_lookup_call`` — raw int32 keys in, per-task codes, existence
  bits and optional predicate match bits out, in one launch (K1;
  replaces ``repro.kernels.fused_mlp.fused_lookup_call``).

For tensors on the card each call launches its CUDA kernel or raises;
for tensors on the CPU it runs the plain version in
``repro_torch.kernels.ref``.  There is no fallback between the two:
a build or launch failure raises.  The source is built at first use by
``repro_torch.kernels.build``.  Each call function counts its launches
in ``<function>.launches``; ``fused_lookup_call.pred_launches`` counts
K1's launches with predicate tables.

:func:`tile_plan` computes each launch's tiling and layer schedule from
the spec alone; the C entries only check it.  ``_fused_mlp`` and
``_fused_lookup`` take a forced plan, so that every plan can be held to
the same answers.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.model import MLPSpec
from repro_torch.kernels import build, ref

SOURCE = "fused_mlp.cu"
#: Kernel limits fixed by the C interface's by-value model descriptor.
MAX_LAYERS = 64
MAX_HEADS = 32
MAX_PREDS = ref.MAX_PREDS


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    model = [p, p, p, i, p, i, i, i, i] + [p, i, p, i, p, i]  # model, then plan
    lib.repro_fused_lookup.argtypes = model + [
        p, i, p, ll, p, i, i, p, p, i, p, p, p, p,
    ]
    lib.repro_fused_lookup.restype = i
    lib.repro_fused_mlp.argtypes = model + [p, i, i, p, p, p]
    lib.repro_fused_mlp.restype = i


def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    return build.library(SOURCE, _bind)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


#: Threads per block of every instantiation; and the copy stages of the
#: weight slabs.
THREADS = 256
STAGES = 2
#: Shared memory one block may use on sm_90 (227 KB).
SMEM_LIMIT = 232448


@dataclass(frozen=True)
class TileShape:
    """One instantiation of the kernels' templated forward.

    ``rows`` rows a block, ``rm`` x ``cn`` (rows x columns) register
    micro-tile a thread, ``xs`` floats per activation feature row in
    shared memory (``rows`` plus a pad against bank conflicts), and the
    weight slab depths (k-rows) its plans may take, in the order the
    planner tries them (0: weights are read from L2)."""

    name: str
    rows: int
    rm: int
    cn: int
    xs: int
    slabs: Tuple[int, ...]

    @property
    def col_threads(self) -> int:
        return THREADS // (self.rows // self.rm)

    @property
    def pass_cols(self) -> int:
        """Output columns one pass over the tile computes."""
        return self.col_threads * self.cn


#: The instantiations, widest first (``csrc/fused_mlp.cu``'s header says
#: which models take which).
TILES = (
    TileShape("full", 128, 16, 8, 132, (32, 16, 8)),
    TileShape("mid", 32, 8, 4, 36, (32, 16, 8)),
    TileShape("narrow", 8, 8, 4, 8, (8, 0)),
)


@dataclass(frozen=True, eq=False)
class TilePlan:
    """Everything a launch needs to know about its tiling, computed from
    the spec by :func:`tile_plan`; the C entries only check it.

    ``slab`` k-rows of weights per slab, staged through shared memory in
    ``STAGES`` buffers by asynchronous copies (0: read from L2).
    ``groups`` (G, 4) int32 rows ``(first member, members, columns,
    out)``: one pass loop over ``columns`` output columns (the members'
    fan-outs, each rounded up to 4, side by side); ``out`` 1 for head
    out layers (argmax or logits), 0 for hidden layers (ReLU into the
    activation buffer).  ``members`` (M, 5) int32 rows ``(layer, head,
    column, src, dst)``: the layer (index in the flat weights' layer
    order), its head (-1 for a trunk layer), its first column in the
    group, the activation feature row it reads from (-1: a gather from
    the digits) and the one it writes to (-1 for an out layer).  ``cap``
    feature rows of activations (plus one row of zeros) live in shared
    memory."""

    tile: TileShape
    schedule: str
    slab: int
    cap: int
    smem_bytes: int
    groups: np.ndarray
    members: np.ndarray

    def __post_init__(self):
        t = self.tile
        info = np.array([t.rows, t.rm, t.cn, self.slab, t.xs, self.cap], np.int32)
        object.__setattr__(self, "info", info)

    def args(self) -> list:
        """The C entries' plan arguments; the arrays live as long as the plan."""
        return [self.info.ctypes.data, self.smem_bytes, self.groups.ctypes.data,
                len(self.groups), self.members.ctypes.data, len(self.members)]

    def describe(self) -> str:
        t = self.tile
        weights = (f"weights in {self.slab}-row slabs x {STAGES} stages" if self.slab
                   else "weights from L2")
        return (f"{t.name} tile: {t.rows} rows, {t.rm}x{t.cn} micro-tile, {weights}, "
                f"{self.cap} activation rows, {len(self.groups)} layer groups "
                f"({self.schedule}), {self.smem_bytes} B of shared memory")


def _layer_plan(spec: MLPSpec):
    """Per layer in flat order: ``(head, fan-in, fan-out)``, fan-in None
    for a gather layer; and per task its layer indices."""
    layers, per_task = [], {}
    d = None
    for h in spec.shared:
        layers.append((-1, d, h))
        d = h
    priv, cards = spec.private_map, spec.card_map
    for hi, t in enumerate(spec.tasks):
        hd, idx = d, []
        for h in (*priv[t], cards[t]):
            idx.append(len(layers))
            layers.append((hi, hd, h))
            hd = h
        per_task[t] = idx
    return layers, per_task


def _schedule(spec: MLPSpec, together: bool):
    """Layer groups in execution order, as lists of ``(layer, reads,
    out)``: ``reads`` the producing layer (-1 for the digits), ``out``
    whether it is a head's out layer.  Heads together: each depth of the
    heads' hidden layers is one group, and all out layers form the last
    groups (split where gathers and dense layers meet); else head by
    head, one layer a group."""
    layers, per_task = _layer_plan(spec)
    groups = []
    prev = -1
    for li in range(len(spec.shared)):
        groups.append([(li, prev, False)])
        prev = li
    trunk_out = prev
    chains = [per_task[t] for t in spec.tasks]
    if not together:
        for chain in chains:
            src = trunk_out
            for li in chain:
                groups.append([(li, src, li == chain[-1])])
                src = li
        return layers, groups
    depth = max(len(c) - 1 for c in chains)
    for dpt in range(depth):
        groups.append([(c[dpt], c[dpt - 1] if dpt else trunk_out, False)
                       for c in chains if len(c) - 1 > dpt])
    outs = [(c[-1], c[-2] if len(c) > 1 else trunk_out, True) for c in chains]
    run = [outs[0]]
    for m in outs[1:]:
        if (m[1] < 0) != (run[-1][1] < 0):
            groups.append(run)
            run = []
        run.append(m)
    groups.append(run)
    return layers, groups


def _smem_words(tile: TileShape, cap: int, slab: int, width: int, n_heads: int) -> int:
    """Shared-memory words of one block: activations and the zero row,
    weight slabs, digits, (modulus, divisor) pairs, codes, and the
    cross-warp argmax scratch (values, indices) when a row's columns span
    several warps.  ``carve`` in the kernel source lays them out so."""
    words = (cap + 1) * tile.xs + tile.rows * width + 2 * width + tile.rows * n_heads
    words += STAGES * slab * tile.pass_cols
    if tile.col_threads > 32:
        words += 2 * (tile.col_threads // 32) * tile.rows
    return words


def _allocate(spec: MLPSpec, tile: TileShape, together: bool, slab: int) -> TilePlan:
    """Place each hidden group's output block in the activation buffer,
    first fit.  A group that finishes in one pass writes only after all
    its reads (the kernel syncs between them), so it may write over
    blocks that die in it; a longer group may not."""
    layers, groups = _schedule(spec, together)
    block_of = {}  # layer -> (producing group, its column there)
    last = {}  # producing group -> last group that reads it
    for gi, g in enumerate(groups):
        for _, src, _ in g:
            if src >= 0:
                last[block_of[src][0]] = gi
        col = 0
        for li, _, out in g:
            if not out:
                block_of[li] = (gi, col)
            col += _round_up(layers[li][2], 4)
    live = {}  # producing group -> (offset, size)
    g_rows, m_rows = [], []
    cap = 0
    for gi, g in enumerate(groups):
        cols = sum(_round_up(layers[li][2], 4) for li, _, _ in g)
        out = g[0][2]
        dst = -1
        if not out:
            one_pass = cols <= tile.pass_cols
            busy = sorted(v for k, v in live.items() if not (one_pass and last[k] == gi))
            dst = 0
            for off, size in busy:
                if dst + cols <= off:
                    break
                dst = max(dst, off + size)
            cap = max(cap, dst + cols)
        g_rows.append((len(m_rows), len(g), cols, int(out)))
        col = 0
        for li, src, _ in g:
            s = -1
            if src >= 0:
                k, c = block_of[src]
                s = live[k][0] + c
            m_rows.append((li, layers[li][0], col, s, -1 if out else dst + col))
            col += _round_up(layers[li][2], 4)
        live = {k: v for k, v in live.items() if last[k] > gi}
        if not out:
            live[gi] = (dst, cols)
    words = _smem_words(tile, cap, slab, spec.width, len(spec.tasks))
    return TilePlan(tile, "heads together" if together else "head by head", slab, cap, 4 * words,
                    np.array(g_rows, np.int32).reshape(-1, 4),
                    np.array(m_rows, np.int32).reshape(-1, 5))


def _candidate_plans(spec: MLPSpec) -> Iterator[TilePlan]:
    """Every (tile, schedule, slab depth) plan of ``spec``, fitting or
    not, in the planner's order of preference: tiles widest first, for
    each the heads together before head by head, and for each the tile's
    slab depths in its order."""
    _check_counts(spec)
    return (_allocate(spec, t, together, slab)
            for t in TILES for together in (True, False) for slab in t.slabs)


@functools.lru_cache(maxsize=64)
def tile_plan(spec: MLPSpec) -> TilePlan:
    """The launch plan of ``spec``: the first of :func:`_candidate_plans`
    whose shared memory fits (computed once per spec).  Heads together
    runs every head's hidden layers of one depth, and all out layers, as
    one group each.  Raises ``ValueError`` with each candidate's
    shared-memory bytes when none fits."""
    for plan in _candidate_plans(spec):
        if plan.smem_bytes <= SMEM_LIMIT:
            return plan
    raise ValueError(
        f"no tile plan fits the {SMEM_LIMIT} B of shared memory a block may use: "
        + "; ".join(f"{p.tile.name} {p.schedule} slab {p.slab}: {p.smem_bytes} B"
                    for p in _candidate_plans(spec))
    )


def _check_counts(spec: MLPSpec) -> None:
    n_layers = len(spec.shared) + sum(len(h) + 1 for _, h in spec.private)
    if n_layers > MAX_LAYERS or len(spec.tasks) > MAX_HEADS:
        raise ValueError(
            f"the fused kernels take at most {MAX_LAYERS} layers and "
            f"{MAX_HEADS} heads per launch; got {n_layers} and {len(spec.tasks)}"
        )


class _ModelArgs:
    """Host descriptor arrays of one padded model, in the C interface's
    order; the arrays stay alive for the call."""

    def __init__(self, flat: Sequence[torch.Tensor], spec: MLPSpec, base_pad: int):
        layers, per_task = _layer_plan(spec)
        n_layers = len(layers)
        if len(flat) != 2 * n_layers:
            raise ValueError("flat weights do not match the spec's layer plan")
        dev = flat[0].device
        for w in flat:
            if w.device != dev or w.dtype != torch.float32 or not w.is_contiguous():
                raise ValueError("flat weights must be contiguous float32 on one device")
        self.w_ptrs = np.array([flat[2 * i].data_ptr() for i in range(n_layers)], np.int64)
        self.b_ptrs = np.array([flat[2 * i + 1].data_ptr() for i in range(n_layers)], np.int64)
        self.info = np.zeros((n_layers, 4), np.int32)
        for li, (_, in_dim, out_dim) in enumerate(layers):
            w = flat[2 * li]
            embed = in_dim is None
            if embed and tuple(w.shape) != (spec.width, base_pad, w.shape[2]):
                raise ValueError(f"layer {li}: gather weights {tuple(w.shape)} mismatch")
            if not embed and (w.dim() != 2 or w.shape[0] < _round_up(in_dim, 4)):
                raise ValueError(f"layer {li}: dense weights {tuple(w.shape)} mismatch")
            ld = w.shape[-1]
            if ld < out_dim or flat[2 * li + 1].shape[0] != ld:
                raise ValueError(f"layer {li}: padded width {ld} < {out_dim}")
            self.info[li] = (in_dim or 0, out_dim, ld, int(embed))
        cards = spec.card_map
        self.heads = np.array(
            [(idx[0], len(idx), cards[t], flat[2 * idx[-1]].shape[-1])
             for t, idx in per_task.items()], np.int32)
        self.n_layers = n_layers
        self.n_heads = len(spec.tasks)
        self.width = spec.width
        self.base = spec.base
        self.base_pad = base_pad

    def args(self) -> list:
        return [
            self.w_ptrs.ctypes.data, self.b_ptrs.ctypes.data, self.info.ctypes.data,
            self.n_layers, self.heads.ctypes.data, self.n_heads,
            self.width, self.base, self.base_pad,
        ]


def _check(t: Optional[torch.Tensor], name: str, dev: torch.device, dtype, ndim: int) -> None:
    if t is None:
        raise ValueError(f"{name} is required")
    if t.device != dev or t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(
            f"{name}: need a contiguous {ndim}-d {dtype} tensor on {dev}, got "
            f"{tuple(t.shape)} {t.dtype} on {t.device}"
        )


#: What the C entries return when they refuse a model or a plan before
#: launching.  The Python checks rule out the other causes, which leaves
#: a plan the kernel source does not take.
_CUDA_ERROR_INVALID_VALUE = 1


def _raise_on(err: int, lib: ctypes.CDLL, what: str, plan: TilePlan) -> None:
    hint = ""
    if err == _CUDA_ERROR_INVALID_VALUE:
        hint = f"; the kernel refused the plan ({plan.describe()})"
    build.raise_on(err, lib, what, hint)


def fused_mlp_call(
    digits: torch.Tensor,
    flat_weights: Sequence[torch.Tensor],
    spec: MLPSpec,
    tile_n: int,
    base_pad: int,
    card_pads: Tuple[Tuple[str, int], ...],
    emit_codes: bool,
):
    """digits (N_pad, width) int32; flat_weights in plan order (padded).

    Returns ``(N_pad, m)`` int32 codes if ``emit_codes`` else a tuple of
    ``(N_pad, card_pad)`` float32 logits, one per task.
    """
    return _fused_mlp(digits, flat_weights, spec, tile_n, base_pad, card_pads, emit_codes)


def _fused_mlp(digits, flat_weights, spec, tile_n, base_pad, card_pads, emit_codes,
               plan: Optional[TilePlan] = None):
    """:func:`fused_mlp_call` under a forced ``plan`` (None: the spec's
    own), for the checks that hold every plan to the same answers."""
    n = digits.shape[0]
    if n == 0 or n % tile_n != 0:
        raise ValueError(f"batch size {n} must be a positive multiple of tile_n={tile_n}")
    if not digits.is_cuda:
        return ref.fused_mlp(digits, flat_weights, spec, emit_codes)
    dev = digits.device
    _check(digits, "digits", dev, torch.int32, 2)
    if digits.shape[1] != spec.width:
        raise ValueError(f"digits width {digits.shape[1]} != spec width {spec.width}")
    margs = _ModelArgs(flat_weights, spec, base_pad)
    if flat_weights[0].device != dev:
        raise ValueError("weights and digits must be on one device")
    plan = plan or tile_plan(spec)
    lib = library()
    m = len(spec.tasks)
    codes = None
    logits: Tuple[torch.Tensor, ...] = ()
    logit_ptrs = None
    if emit_codes:
        codes = torch.empty((n, m), dtype=torch.int32, device=dev)
    else:
        logits = tuple(
            torch.empty((n, cp), dtype=torch.float32, device=dev) for _, cp in card_pads
        )
        logit_ptrs = np.array([t.data_ptr() for t in logits], np.int64)
    with torch.cuda.device(dev):
        err = lib.repro_fused_mlp(
            *margs.args(), *plan.args(), digits.data_ptr(), n, int(emit_codes),
            codes.data_ptr() if codes is not None else None,
            logit_ptrs.ctypes.data if logit_ptrs is not None else None,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(err, lib, "fused_mlp", plan)
    fused_mlp_call.launches += 1
    return codes if emit_codes else logits


fused_mlp_call.launches = 0


def fused_lookup_call(
    keys: torch.Tensor,
    pos_ops: torch.Tensor,
    words32: Optional[torch.Tensor],
    flat_weights: Sequence[torch.Tensor],
    spec: MLPSpec,
    tile_n: int,
    base_pad: int,
    capacity: int,
    pred_tables: Sequence[torch.Tensor] = (),
    pred_tasks: Sequence[int] = (),
    with_exists: bool = True,
):
    """keys (N_pad,) int32 (padding -1); pos_ops (width, 2) int32
    ``[(mod, div)...]``; words32 (n_words,) int32 view of the packed
    uint32 words (None when ``with_exists=False``); flat_weights in plan
    order (padded); pred_tables one padded int32 0/1 vector per
    predicate, indexed by the code of head ``pred_tasks[j]``.

    Returns ``(codes, exists, match)``: codes (N_pad, m) int32; exists
    (N_pad,) int32 or None without ``with_exists``; match (N_pad,) int32
    or None without ``pred_tables``.
    """
    return _fused_lookup(keys, pos_ops, words32, flat_weights, spec, tile_n, base_pad,
                         capacity, pred_tables, pred_tasks, with_exists)


def _fused_lookup(keys, pos_ops, words32, flat_weights, spec, tile_n, base_pad, capacity,
                  pred_tables=(), pred_tasks=(), with_exists=True,
                  plan: Optional[TilePlan] = None):
    """:func:`fused_lookup_call` under a forced ``plan`` (None: the
    spec's own)."""
    n = keys.shape[0]
    if n == 0 or n % tile_n != 0:
        raise ValueError(f"batch size {n} must be a positive multiple of tile_n={tile_n}")
    if pred_tables and not with_exists:
        raise ValueError("in-kernel predicate filtering requires with_exists")
    if len(pred_tables) != len(pred_tasks):
        raise ValueError("one pred_task per pred_table")
    if len(pred_tables) > MAX_PREDS:
        raise ValueError(f"at most {MAX_PREDS} predicate tables per launch")
    if not keys.is_cuda:
        return ref.fused_lookup(
            keys, pos_ops, words32, flat_weights, spec, capacity,
            pred_tables, pred_tasks, with_exists,
        )
    dev = keys.device
    _check(keys, "keys", dev, torch.int32, 1)
    _check(pos_ops, "pos_ops", dev, torch.int32, 2)
    if tuple(pos_ops.shape) != (spec.width, 2):
        raise ValueError(f"pos_ops shape {tuple(pos_ops.shape)} != ({spec.width}, 2)")
    if with_exists:
        _check(words32, "words32", dev, torch.int32, 1)
    cards = spec.card_map
    for tb, ti in zip(pred_tables, pred_tasks):
        _check(tb, "pred table", dev, torch.int32, 1)
        if not 0 <= ti < len(spec.tasks) or tb.shape[0] < cards[spec.tasks[ti]]:
            raise ValueError(f"pred table for head {ti} is shorter than its card")
    margs = _ModelArgs(flat_weights, spec, base_pad)
    if flat_weights[0].device != dev:
        raise ValueError("weights and keys must be on one device")
    plan = plan or tile_plan(spec)
    lib = library()
    codes = torch.empty((n, len(spec.tasks)), dtype=torch.int32, device=dev)
    exists = torch.empty((n,), dtype=torch.int32, device=dev) if with_exists else None
    match = torch.empty((n,), dtype=torch.int32, device=dev) if pred_tables else None
    pred_ptrs = np.array([t.data_ptr() for t in pred_tables] or [0], np.int64)
    pred_idx = np.array(list(pred_tasks) or [0], np.int32)
    with torch.cuda.device(dev):
        err = lib.repro_fused_lookup(
            *margs.args(), *plan.args(), keys.data_ptr(), n, pos_ops.data_ptr(), int(capacity),
            words32.data_ptr() if with_exists else None,
            words32.shape[0] if with_exists else 0, int(with_exists),
            pred_ptrs.ctypes.data, pred_idx.ctypes.data, len(pred_tables),
            codes.data_ptr(), exists.data_ptr() if exists is not None else None,
            match.data_ptr() if match is not None else None,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(err, lib, "fused_lookup", plan)
    fused_lookup_call.launches += 1
    if pred_tables:
        fused_lookup_call.pred_launches += 1
    return codes, exists, match


fused_lookup_call.launches = 0
#: The launches above that carried predicate tables (match bits out).
fused_lookup_call.pred_launches = 0
