"""The msgpack subset of the store's on-disk layout, without ``msgpack``.

The reference writes ``meta.msgpack`` and ``aux.msgpack`` with
``msgpack.packb`` at its defaults; the port must read and write the
same bytes on machines that have no ``msgpack`` package.  This codec
covers exactly what the layout holds:

* ``dict`` → map, ``list``/``tuple`` → array (fix, 16- and 32-bit
  lengths);
* ``str`` → str (UTF-8; fixstr, str8, str16, str32), ``bytes`` /
  ``bytearray`` / ``memoryview`` → bin (bin8, bin16, bin32);
* ``int`` from −2⁶³ to 2⁶⁴−1 in the smallest encoding msgpack picks
  (crc32s are unsigned 32-bit, so uint32 matters); ``bool``; ``None``;
* ``float`` → float64 (``0xcb``, as ``msgpack.packb`` packs a Python
  float); float32 (``0xca``) and float64 unpack to ``float``.  A
  baseline store's overlay rows hold float columns as item lists.

:func:`packb` gives the bytes of ``msgpack.packb(obj)`` (defaults:
``use_bin_type=True``) for every such object and raises ``TypeError``
on anything else, as ``msgpack.packb`` does on types it cannot pack.
:func:`unpackb` decodes what ``msgpack.unpackb(data)`` decodes at its
defaults (str as ``str``, bin as ``bytes``, arrays as lists, map keys
limited to ``str``/``bytes``) and raises ``ValueError`` on truncated
input, trailing bytes, or a type byte outside the subset.
"""

from __future__ import annotations

import struct
from typing import Tuple

__all__ = ["packb", "unpackb"]


def _pack_int(v: int, out: bytearray) -> None:
    if v >= 0:
        if v < 0x80:
            out.append(v)
        elif v <= 0xFF:
            out += b"\xcc" + struct.pack(">B", v)
        elif v <= 0xFFFF:
            out += b"\xcd" + struct.pack(">H", v)
        elif v <= 0xFFFFFFFF:
            out += b"\xce" + struct.pack(">I", v)
        elif v <= 0xFFFFFFFFFFFFFFFF:
            out += b"\xcf" + struct.pack(">Q", v)
        else:
            raise OverflowError("Integer value out of range")
    elif v >= -32:
        out += struct.pack(">b", v)
    elif v >= -0x80:
        out += b"\xd0" + struct.pack(">b", v)
    elif v >= -0x8000:
        out += b"\xd1" + struct.pack(">h", v)
    elif v >= -0x80000000:
        out += b"\xd2" + struct.pack(">i", v)
    elif v >= -0x8000000000000000:
        out += b"\xd3" + struct.pack(">q", v)
    else:
        raise OverflowError("Integer value out of range")


def _pack_len(n: int, fix: int, fix_max: int, codes: Tuple[bytes, ...],
              out: bytearray) -> None:
    """Header of a sized container: ``fix | n`` up to ``fix_max``, else
    the 8- (if any), 16- or 32-bit length form."""
    if n <= fix_max:
        out.append(fix | n)
        return
    forms = ((0xFF, ">B"), (0xFFFF, ">H"), (0xFFFFFFFF, ">I"))[3 - len(codes):]
    for code, (limit, fmt) in zip(codes, forms):
        if n <= limit:
            out += code + struct.pack(fmt, n)
            return
    raise ValueError("object too large to pack")


def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        n = len(data)
        if n < 32:
            out.append(0xA0 | n)
        else:
            _pack_len(n, 0, -1, (b"\xd9", b"\xda", b"\xdb"), out)
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _pack_len(len(data), 0, -1, (b"\xc4", b"\xc5", b"\xc6"), out)
        out += data
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 15, (b"\xde", b"\xdf"), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 15, (b"\xdc", b"\xdd"), out)
        for v in obj:
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj) -> bytes:
    """``msgpack.packb(obj)`` for the layout's subset (see module doc)."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


#: Fixed-width scalars: type byte -> struct format.
_SCALARS = {
    0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
    0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
    0xCA: ">f", 0xCB: ">d",
}
#: Sized payloads: type byte -> (kind, struct format of the length).
_SIZED = {
    0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
    0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
    0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
    0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
}


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, data) -> None:
        self.buf = memoryview(data).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("msgpack data is truncated")
        chunk = self.buf[self.pos:end]
        self.pos = end
        return chunk

    def fixed(self, fmt: str) -> int:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.take(1)[0]
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if b in _SCALARS:
            return self.fixed(_SCALARS[b])
        if 0xA0 <= b <= 0xBF:
            kind, n = "str", b & 0x1F
        elif 0x90 <= b <= 0x9F:
            kind, n = "array", b & 0x0F
        elif 0x80 <= b <= 0x8F:
            kind, n = "map", b & 0x0F
        elif b in _SIZED:
            kind, fmt = _SIZED[b]
            n = self.fixed(fmt)
        else:
            raise ValueError(f"msgpack type byte {b:#04x} is outside the store layout's subset")
        if kind == "str":
            return str(self.take(n), "utf-8")
        if kind == "bin":
            return bytes(self.take(n))
        if kind == "array":
            return [self.value() for _ in range(n)]
        out = {}
        for _ in range(n):
            k = self.value()
            if not isinstance(k, (str, bytes)):
                raise ValueError(f"{type(k).__name__} is not allowed for map key")
            out[k] = self.value()
        return out


def unpackb(data):
    """``msgpack.unpackb(data)`` for the layout's subset (see module doc)."""
    reader = _Reader(data)
    obj = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError("msgpack data has trailing bytes")
    return obj
