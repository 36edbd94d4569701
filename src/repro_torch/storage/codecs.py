"""Compression codec registry.

The paper evaluates Dictionary encoding, Gzip, Z-Standard and LZMA
(§V-A3) and tunes the compression level per use-case (§V-A4): zstd
level 1 for small-batch / latency-dominated workloads, higher levels
when decompression is off the critical path.  Codec identity strings
(``"zstd"``, ``"lzma"``, ...) are stable across save/load.

``zstandard`` (a third-party wheel) and ``lzma`` (absent from some
minimal CPython builds) are OPTIONAL: when unavailable, their codec
names stay registered but compress through stdlib ``zlib`` instead, so
a clean environment still imports, builds, and round-trips stores.
Decompression sniffs container magic bytes, so blobs written by the
fallback load fine on hosts that do have the real library (the reverse
— real-zstd blobs on a host without ``zstandard`` — raises a clear
error instead of corrupting).
"""

from __future__ import annotations

import dataclasses
import gzip
import zlib
from typing import Callable, Dict

try:  # pragma: no cover - exercised implicitly by the import
    import zstandard

    HAVE_ZSTD = True
except ImportError:  # clean environment: stdlib-only fallback
    zstandard = None
    HAVE_ZSTD = False

try:
    import lzma

    HAVE_LZMA = True
except ImportError:  # CPython built without _lzma
    lzma = None
    HAVE_LZMA = False

# Container magic bytes, used to route decompression when a codec name
# is served by the zlib fallback.
_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"
_XZ_MAGIC = b"\xfd7zXZ\x00"
_ZLIB_FIRST_BYTE = 0x78


@dataclasses.dataclass(frozen=True)
class Codec:
    name: str
    compress: Callable[[bytes], bytes]
    decompress: Callable[[bytes], bytes]


def _fallback(canonical_name: str, native_magic: bytes, level: int) -> Codec:
    """zlib-backed stand-in for an unavailable library, keyed under the
    canonical codec name so configs/saved stores keep working."""

    def comp(data: bytes, _level=level) -> bytes:
        return zlib.compress(data, _level)

    def decomp(data: bytes) -> bytes:
        if data[:1] and data[0] == _ZLIB_FIRST_BYTE:
            return zlib.decompress(data)
        if data.startswith(native_magic):
            raise RuntimeError(
                f"blob was written with the real {canonical_name!r} codec "
                f"but the library is not installed in this environment"
            )
        return zlib.decompress(data)

    return Codec(f"{canonical_name}(zlib-fallback)", comp, decomp)


def _zstd(level: int) -> Codec:
    name = f"zstd{'' if level == 3 else level}"
    if not HAVE_ZSTD:
        return _fallback(name, _ZSTD_MAGIC, level=min(level, 9))

    def comp(data: bytes, _level=level) -> bytes:
        return zstandard.ZstdCompressor(level=_level).compress(data)

    def decomp(data: bytes) -> bytes:
        if data[:1] and data[0] == _ZLIB_FIRST_BYTE and not data.startswith(_ZSTD_MAGIC):
            return zlib.decompress(data)  # written by the fallback
        return zstandard.ZstdDecompressor().decompress(data)

    return Codec(name, comp, decomp)


def _lzma() -> Codec:
    if not HAVE_LZMA:
        return _fallback("lzma", _XZ_MAGIC, level=9)

    def decomp(data: bytes) -> bytes:
        if data[:1] and data[0] == _ZLIB_FIRST_BYTE:
            return zlib.decompress(data)  # written by the fallback
        return lzma.decompress(data)

    return Codec("lzma", lambda b: lzma.compress(b, preset=6), decomp)


CODECS: Dict[str, Codec] = {
    "none": Codec("none", lambda b: b, lambda b: b),
    "zstd": _zstd(3),
    "zstd1": _zstd(1),
    "zstd9": _zstd(9),
    "gzip": Codec(
        "gzip",
        lambda b: gzip.compress(b, compresslevel=6),
        gzip.decompress,
    ),
    "zlib": Codec("zlib", lambda b: zlib.compress(b, 6), zlib.decompress),
    "lzma": _lzma(),
}


def get_codec(name: str) -> Codec:
    try:
        return CODECS[name]
    except KeyError:
        raise KeyError(f"unknown codec {name!r}; have {sorted(CODECS)}") from None
