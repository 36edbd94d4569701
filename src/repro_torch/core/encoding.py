"""Key featurization and value codecs.

The paper encodes discrete keys "as integers using one-hot encoding"
(§IV-A).  Materializing one-hot vectors over a multi-million key domain
is infeasible, so — like the reference implementation — a key is first
decomposed into ``width`` digits of a fixed ``base`` and each digit
position is one-hot encoded, giving a ``width*base`` feature vector.

On the optimized path the one-hot never exists: the first dense layer is
evaluated as a gather over rows of its weight (``repro_torch.core.model``
and the fused kernels), which is mathematically identical.

The port of ``repro.core.encoding``: numpy code is copied as is; the
traceable helpers (``digits_torch``, ``onehot_digits``) are torch.

Values are factorized per column by :class:`ValueCodec`; the inverse
maps are the paper's ``f_decode`` and their bytes count toward Eq. 1.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class KeyEncoderSpec:
    base: int
    width: int

    @property
    def feature_dim(self) -> int:
        return self.base * self.width


class KeyEncoder:
    """Fixed-width, fixed-base digit decomposition of int64 keys.

    ``residues`` (beyond-paper, DESIGN.md §Perf) appends extra feature
    positions carrying ``key % r`` for each residue ``r`` — encoded as
    ``ceil(log_base r)`` base-``base`` digits, so any period fits.  A
    value column that is periodic in the key with period dividing ``r``
    becomes a function of those few positions only — cross-product
    tables (TPC-DS customer_demographics) go from hard to trivially
    memorizable.  Positions reuse the same one-hot granularity, so
    model/kernels are untouched; disabled (paper-faithful) by default.
    """

    def __init__(self, max_key: int, base: int = 10, residues: Tuple[int, ...] = ()):
        if base < 2:
            raise ValueError("base must be >= 2")
        if max_key < 0:
            raise ValueError("max_key must be >= 0")
        if any(r < 2 for r in residues):
            raise ValueError(f"residues must be >= 2: {residues}")

        def width_for(maxval: int) -> int:
            w, cap = 1, base
            while cap <= maxval:
                cap *= base
                w += 1
            return w

        digit_width = width_for(max_key)
        cap = base ** digit_width
        self.residues = tuple(int(r) for r in residues)
        self._digit_width = digit_width
        self._capacity = cap
        self._res_widths = tuple(width_for(r - 1) for r in self.residues)
        width = digit_width + sum(self._res_widths)
        self.spec = KeyEncoderSpec(base=base, width=width)
        # Most-significant digit first, so nearby keys share a prefix.
        divisors = [base ** (digit_width - 1 - i) for i in range(digit_width)]
        self._divisors = np.array(divisors, dtype=np.int64)
        self._res_divisors = [
            np.array([base ** (w - 1 - i) for i in range(w)], dtype=np.int64)
            for w in self._res_widths
        ]

    @property
    def base(self) -> int:
        return self.spec.base

    @property
    def width(self) -> int:
        return self.spec.width

    @property
    def feature_dim(self) -> int:
        return self.spec.feature_dim

    @property
    def capacity(self) -> int:
        """Exclusive upper bound on encodable keys."""
        return self._capacity

    def digits(self, keys: np.ndarray) -> np.ndarray:
        """(n,) int64 keys -> (n, width) int32 codes: digit positions in
        [0, base) then residue positions (key % r)."""
        keys = np.asarray(keys, dtype=np.int64)
        if keys.size and (keys.min() < 0 or keys.max() >= self.capacity):
            raise ValueError(
                f"key out of range [0, {self.capacity}) for encoder {self.spec}"
            )
        parts = [((keys[..., None] // self._divisors) % self.base).astype(np.int32)]
        for r, div in zip(self.residues, self._res_divisors):
            v = keys % r
            parts.append(((v[..., None] // div) % self.base).astype(np.int32))
        return np.concatenate(parts, axis=-1) if len(parts) > 1 else parts[0]

    def digits_torch(self, keys: torch.Tensor) -> torch.Tensor:
        """Digit decomposition of non-negative integer keys on the keys'
        device (the counterpart of the reference's ``digits_jax``)."""
        keys = keys.to(torch.int64)
        divs = torch.as_tensor(self._divisors, device=keys.device)
        parts = [((keys[..., None] // divs) % self.base).to(torch.int32)]
        for r, div in zip(self.residues, self._res_divisors):
            v = keys % r
            d = torch.as_tensor(div, device=keys.device)
            parts.append(((v[..., None] // d) % self.base).to(torch.int32))
        return torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]

    def position_ops(self) -> Tuple[Tuple[int, int], ...]:
        """Per-position ``(modulus, divisor)`` pairs such that position
        ``p``'s digit is ``((key % modulus) // divisor) % base`` — the
        uniform form the fused lookup kernel evaluates in-device (main
        digit positions use ``modulus = capacity``, a no-op for in-range
        keys, so every position is the same three integer ops)."""
        ops = [(self._capacity, int(d)) for d in self._divisors]
        for r, divs in zip(self.residues, self._res_divisors):
            ops.extend((int(r), int(d)) for d in divs)
        return tuple(ops)

    def onehot(self, keys: np.ndarray, dtype=np.float32) -> np.ndarray:
        """(n,) keys -> (n, width*base) one-hot features (reference path)."""
        d = self.digits(keys)
        n = d.shape[0]
        out = np.zeros((n, self.feature_dim), dtype=dtype)
        cols = d + (np.arange(self.width, dtype=np.int32) * self.base)[None, :]
        rows = np.repeat(np.arange(n), self.width)
        out[rows, cols.reshape(-1)] = 1
        return out

    def size_bytes(self) -> int:
        return 16  # (base, width) — negligible, but accounted.


def onehot_digits(
    digits: torch.Tensor, base: int, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """(..., width) int digit codes -> (..., width*base) flattened one-hot."""
    ar = torch.arange(base, dtype=digits.dtype, device=digits.device)
    eye = (digits[..., None] == ar).to(dtype)
    return eye.reshape(*digits.shape[:-1], digits.shape[-1] * base)


class ValueCodec:
    """Per-column factorization: original discrete values <-> int32 codes.

    ``decode_map`` (the paper's ``f_decode``) is an array of originals
    indexed by code; its serialized bytes count toward Eq. 1.
    """

    def __init__(self, name: str, values: np.ndarray):
        self.name = name
        uniques, codes = np.unique(np.asarray(values), return_inverse=True)
        self.decode_map = uniques
        self._codes = codes.astype(np.int32)
        # Encoding dict for modification-time encode of unseen values.
        self._encode: Dict[object, int] = {v: i for i, v in enumerate(uniques.tolist())}

    @property
    def cardinality(self) -> int:
        return int(self.decode_map.shape[0])

    @property
    def codes(self) -> np.ndarray:
        return self._codes

    def encode(self, values: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Encode possibly-unseen values.

        Returns ``(codes, known_mask)``; unseen values get code -1 and
        ``known_mask`` False (the caller must route them to T_aux as raw
        values — the model can never predict an unseen class).
        """
        values = np.asarray(values)
        codes = np.empty(values.shape[0], dtype=np.int32)
        known = np.ones(values.shape[0], dtype=bool)
        for i, v in enumerate(values.tolist()):
            c = self._encode.get(v, -1)
            codes[i] = c
            if c < 0:
                known[i] = False
        return codes, known

    @classmethod
    def from_decode_map(cls, name: str, decode_map: np.ndarray) -> "ValueCodec":
        """Rebuild a codec from its serialized ``decode_map`` (the load
        paths of ``core.serialize`` and the baseline stores)."""
        vc = cls.__new__(cls)
        vc.name = name
        vc.decode_map = decode_map
        vc._codes = np.zeros(0, dtype=np.int32)  # codes only needed at build
        vc._encode = {v: i for i, v in enumerate(decode_map.tolist())}
        return vc

    def extend(self, values: np.ndarray) -> None:
        """Register new categories (used on insert of unseen values).

        One ``np.unique`` + one concatenate regardless of batch size;
        new categories keep first-occurrence order, matching the code
        assignment the old per-value ``np.append`` loop produced."""
        values = np.asarray(values)
        if values.size == 0:
            return
        uniq, first = np.unique(values, return_index=True)
        fresh = [
            v for v in uniq[np.argsort(first, kind="stable")].tolist()
            if v not in self._encode
        ]
        if not fresh:
            return
        start = len(self._encode)
        for off, v in enumerate(fresh):
            self._encode[v] = start + off
        # plain concatenate so dtype promotion (e.g. wider strings)
        # matches what np.append did
        self.decode_map = np.concatenate([self.decode_map, np.asarray(fresh)])

    def decode(self, codes: np.ndarray) -> np.ndarray:
        return self.decode_map[np.asarray(codes, dtype=np.int64)]

    def size_bytes(self) -> int:
        dm = self.decode_map
        if dm.dtype == object:
            return int(sum(len(str(x)) for x in dm)) + 8 * len(dm)
        return int(dm.nbytes)


def build_codecs(columns: Dict[str, np.ndarray]) -> Dict[str, ValueCodec]:
    return {name: ValueCodec(name, col) for name, col in columns.items()}


def detect_column_period(
    keys: np.ndarray,
    col: np.ndarray,
    max_period: int = 1 << 22,
    min_purity: float = 0.98,
    sample: int = 200_000,
) -> int | None:
    """Detect whether ``col`` is (near-)periodic along the key dimension.

    Cross-product tables (TPC-DS dimension tables) and run-length data
    make every column a function of ``key % period``.  Heuristic:
    stride = modal run length of equal values in key order; candidate
    periods = stride × cardinality × {1,2,4}; accept the smallest whose
    groups are ``min_purity`` single-valued (tolerates the synthetic
    datasets' noise rows).  Returns the period or None.
    """
    n = keys.shape[0]
    if n < 16:
        return None
    if n > sample:
        idx = np.sort(np.random.default_rng(0).choice(n, size=sample, replace=False))
        keys, col = keys[idx], col[idx]
    order = np.argsort(keys)
    k, v = keys[order], col[order]
    _, codes = np.unique(v, return_inverse=True)
    card = int(codes.max()) + 1
    if card <= 1:
        return 1
    # modal run length in KEY units
    change = np.flatnonzero(np.diff(codes) != 0)
    if change.size == 0:
        return 1
    run_key_lens = np.diff(np.concatenate([[k[0]], k[change + 1]]))
    run_key_lens = run_key_lens[run_key_lens > 0]
    if run_key_lens.size == 0:
        return None
    vals, counts = np.unique(run_key_lens, return_counts=True)
    stride = int(vals[np.argmax(counts)])

    def purity(period: int) -> float:
        g = (k % period).astype(np.int64)
        o = np.argsort(g, kind="stable")
        gs, cs = g[o], codes[o]
        starts = np.flatnonzero(np.diff(gs)) + 1
        bounds = np.concatenate([[0], starts, [gs.size]])
        agree = 0
        for a, b in zip(bounds[:-1], bounds[1:]):
            seg = cs[a:b]
            agree += int(np.bincount(seg, minlength=card).max())
        return agree / gs.size

    for mult in (1, 2, 4):
        period = stride * card * mult
        if period <= 1 or period > max_period:
            continue
        if purity(period) >= min_purity:
            return period
    return None


def detect_residues(
    keys: np.ndarray,
    columns: Dict[str, np.ndarray],
    base: int,
    max_positions: int = 24,
    max_period: int = 1 << 22,
) -> Tuple[int, ...]:
    """Periods worth adding as residue features, deduplicated (a period
    dividing another is subsumed), capped by total digit positions."""
    periods = []
    for col in columns.values():
        if col.dtype == object or col.dtype.kind in "SU":
            _, codes = np.unique(col, return_inverse=True)
            col = codes
        p = detect_column_period(keys, np.asarray(col), max_period=max_period)
        if p is not None and p > 1:
            periods.append(int(p))
    # Exact-dedup only.  A multiple q of p carries key%p INFORMATION, but
    # extracting it is as hard as the original problem — each column keeps
    # its own period so its value is a function of few positions.
    kept = sorted(set(periods))

    def width_for(maxval: int) -> int:
        w, cap = 1, base
        while cap <= maxval:
            cap *= base
            w += 1
        return w

    out, used = [], 0
    for p in kept:
        w = width_for(p - 1)
        if used + w > max_positions:
            continue
        out.append(p)
        used += w
    return tuple(out)


def codes_matrix(codecs: Dict[str, ValueCodec], order: Sequence[str]) -> np.ndarray:
    """Stack per-column codes into an (n, m) int32 matrix in column order."""
    return np.stack([codecs[name].codes for name in order], axis=1)
