"""Existence bitvector ``V_exist`` (paper §IV-B).

One bit per slot of the key domain ``[0, capacity)``.  Runtime form is a
packed uint64 numpy array (vectorized test/set); the at-rest form is the
zstd-compressed pack — the paper compresses ``V_exist`` on disk (§V-C
notes "randomness in decompressing V_exist").

Copied from ``repro.core.bitvector`` (numpy only).  The device
existence test reads the same words through ``pack_words32``
(``repro_torch.kernels.ops``), inside the fused lookup kernel.
"""

from __future__ import annotations

import numpy as np

from repro_torch.storage import get_codec

# Per-byte popcounts — the count() fallback for numpy < 2.0 (no
# ``np.bitwise_count``) that stays O(#words) memory: a 256-bin byte
# histogram dotted with this table, instead of unpackbits' 8x blowup.
_POPCOUNT8 = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None], axis=1).sum(
    axis=1, dtype=np.int64
)


class BitVector:
    """Dynamic packed bitvector over a non-negative integer key domain."""

    __slots__ = ("_words", "_capacity", "_version")

    def __init__(self, capacity: int):
        if capacity < 0:
            raise ValueError("capacity must be >= 0")
        self._capacity = int(capacity)
        self._words = np.zeros((self._capacity + 63) // 64, dtype=np.uint64)
        self._version = 0

    # -- construction ------------------------------------------------------
    @classmethod
    def from_keys(cls, keys: np.ndarray, capacity: int | None = None) -> "BitVector":
        keys = np.asarray(keys, dtype=np.int64)
        cap = int(capacity if capacity is not None else (keys.max() + 1 if keys.size else 0))
        bv = cls(cap)
        bv.set(keys, True)
        return bv

    # -- core ops (vectorized) ---------------------------------------------
    @property
    def capacity(self) -> int:
        return self._capacity

    def _grow_to(self, capacity: int) -> None:
        if capacity <= self._capacity:
            return
        nwords = (capacity + 63) // 64
        if nwords > self._words.shape[0]:
            grown = np.zeros(nwords, dtype=np.uint64)
            grown[: self._words.shape[0]] = self._words
            self._words = grown
        self._capacity = capacity

    @property
    def version(self) -> int:
        """Monotonic mutation counter — device-side caches of the word
        array (``repro_torch.core.inference``) re-upload when it changes."""
        return self._version

    def set(self, keys: np.ndarray, value: bool) -> None:
        keys = np.asarray(keys, dtype=np.int64)
        if keys.size == 0:
            return
        self._version += 1
        if keys.min() < 0:
            raise ValueError("negative key")
        self._grow_to(int(keys.max()) + 1)
        word = keys >> 6
        bit = np.uint64(1) << (keys & 63).astype(np.uint64)
        if value:
            np.bitwise_or.at(self._words, word, bit)
        else:
            np.bitwise_and.at(self._words, word, ~bit)

    def test(self, keys: np.ndarray) -> np.ndarray:
        """Vectorized membership test; out-of-domain keys are False."""
        keys = np.asarray(keys, dtype=np.int64)
        if self._words.size == 0:
            return np.zeros(keys.shape, dtype=bool)
        in_domain = (keys >= 0) & (keys < self._capacity)
        safe = np.where(in_domain, keys, 0)
        word = self._words[safe >> 6]
        bit = (word >> (safe & 63).astype(np.uint64)) & np.uint64(1)
        return (bit.astype(bool)) & in_domain

    def count(self) -> int:
        """Set-bit total in O(#words) memory (the old ``np.unpackbits``
        materialized an 8x-larger bool array)."""
        if hasattr(np, "bitwise_count"):  # numpy >= 2.0: per-word popcount
            return int(np.bitwise_count(self._words).sum(dtype=np.int64))
        counts = np.bincount(self._words.view(np.uint8), minlength=256)
        return int(counts @ _POPCOUNT8)

    def keys_in_range(
        self, lo: int = 0, hi: int | None = None, chunk: int = 1 << 20
    ) -> np.ndarray:
        """All set keys in ``[lo, hi)``, ascending — the chunked
        existence scan shared by range lookup, materialization, and the
        cluster router's range scatter.  Scans ``chunk`` slots at a
        time so the working set stays bounded."""
        lo = max(0, int(lo))
        hi = self._capacity if hi is None else min(int(hi), self._capacity)
        parts = []
        for start in range(lo, hi, chunk):
            ks = np.arange(start, min(start + chunk, hi), dtype=np.int64)
            parts.append(ks[self.test(ks)])
        return np.concatenate(parts) if parts else np.zeros(0, dtype=np.int64)

    # -- storage accounting / (de)serialization -----------------------------
    @property
    def words(self) -> np.ndarray:
        return self._words

    def runtime_bytes(self) -> int:
        return int(self._words.nbytes)

    def to_bytes(self) -> bytes:
        header = np.array([self._capacity], dtype=np.int64).tobytes()
        return header + get_codec("zstd").compress(self._words.tobytes())

    @classmethod
    def from_bytes(cls, blob: bytes) -> "BitVector":
        capacity = int(np.frombuffer(blob[:8], dtype=np.int64)[0])
        raw = get_codec("zstd").decompress(blob[8:])
        bv = cls(capacity)
        bv._words = np.frombuffer(raw, dtype=np.uint64).copy()
        return bv

    def size_bytes(self) -> int:
        """At-rest (compressed) size — the Eq. 1 contribution."""
        return len(self.to_bytes())
