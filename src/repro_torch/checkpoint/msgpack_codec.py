"""A small MessagePack encoder and decoder in pure Python.

It covers the subset a checkpoint payload needs and writes the bytes
``msgpack.packb(obj, use_bin_type=True)`` writes for it, in the same
smallest forms:

  * ``None``, ``False``, ``True`` (nil, false, true);
  * ints from -2**63 to 2**64 - 1 (positive and negative fixint, uint
    8/16/32/64, int 8/16/32/64);
  * ``str`` (fixstr, str 8/16/32, UTF-8), ``bytes`` / ``bytearray`` /
    ``memoryview`` (bin 8/16/32);
  * ``list`` and ``tuple`` (fixarray, array 16/32), ``dict`` (fixmap, map
    16/32, in insertion order).

``unpackb`` reads those forms back as ``msgpack.unpackb(data, raw=False)``
does: arrays as lists, str as ``str``, bin as ``bytes``.  Anything else
(floats, extension types, timestamps) raises.
"""
from __future__ import annotations

import struct

_U8, _U16, _U32, _U64 = (struct.Struct(">B"), struct.Struct(">H"),
                         struct.Struct(">I"), struct.Struct(">Q"))
_I8, _I16, _I32, _I64 = (struct.Struct(">b"), struct.Struct(">h"),
                         struct.Struct(">i"), struct.Struct(">q"))


def _int(v: int, out: list) -> None:
    if 0 <= v < 0x80:
        out.append(_U8.pack(v))
    elif -32 <= v < 0:
        out.append(_U8.pack(v & 0xFF))
    elif v > 0:
        for tag, fmt, top in ((0xCC, _U8, 0xFF), (0xCD, _U16, 0xFFFF),
                              (0xCE, _U32, 0xFFFFFFFF),
                              (0xCF, _U64, 0xFFFFFFFFFFFFFFFF)):
            if v <= top:
                out.append(bytes((tag,)) + fmt.pack(v))
                return
        raise OverflowError(f"int {v} is too large for MessagePack")
    else:
        for tag, fmt, low in ((0xD0, _I8, -0x80), (0xD1, _I16, -0x8000),
                              (0xD2, _I32, -0x80000000),
                              (0xD3, _I64, -0x8000000000000000)):
            if v >= low:
                out.append(bytes((tag,)) + fmt.pack(v))
                return
        raise OverflowError(f"int {v} is too small for MessagePack")


def _header(n: int, fix: int | None, fix_max: int, tags, what: str,
            out: list) -> None:
    """A length header: the fix form below ``fix_max`` (if any), else the
    8/16/32-bit forms ``tags`` (None where a width does not exist)."""
    if fix is not None and n < fix_max:
        out.append(_U8.pack(fix | n))
        return
    for tag, fmt, top in zip(tags, (_U8, _U16, _U32),
                             (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if tag is not None and n <= top:
            out.append(bytes((tag,)) + fmt.pack(n))
            return
    raise ValueError(f"{what} of length {n} is too long for MessagePack")


def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is False:
        out.append(b"\xc2")
    elif obj is True:
        out.append(b"\xc3")
    elif isinstance(obj, int):
        _int(int(obj), out)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _header(len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB), "str", out)
        out.append(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _header(len(data), None, 0, (0xC4, 0xC5, 0xC6), "bin", out)
        out.append(data)
    elif isinstance(obj, (list, tuple)):
        _header(len(obj), 0x90, 16, (None, 0xDC, 0xDD), "array", out)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _header(len(obj), 0x80, 16, (None, 0xDE, 0xDF), "map", out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__!r} "
                        f"(this codec covers nil, bool, int, str, bin, "
                        f"array and map)")


def packb(obj) -> bytes:
    """``obj`` as MessagePack bytes (``msgpack.packb(obj,
    use_bin_type=True)`` for the covered types)."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated MessagePack data")
        view = self.data[self.pos:self.pos + n]
        self.pos += n
        return view

    def unpack(self, fmt: struct.Struct) -> int:
        return fmt.unpack(self.take(fmt.size))[0]


# tag -> (kind, length reader) for the sized forms
_SIZED = {0xC4: ("bin", _U8), 0xC5: ("bin", _U16), 0xC6: ("bin", _U32),
          0xD9: ("str", _U8), 0xDA: ("str", _U16), 0xDB: ("str", _U32),
          0xDC: ("array", _U16), 0xDD: ("array", _U32),
          0xDE: ("map", _U16), 0xDF: ("map", _U32)}
_INTS = {0xCC: _U8, 0xCD: _U16, 0xCE: _U32, 0xCF: _U64,
         0xD0: _I8, 0xD1: _I16, 0xD2: _I32, 0xD3: _I64}


def _read(r: _Reader):
    tag = r.unpack(_U8)
    if tag < 0x80:
        return tag
    if tag >= 0xE0:
        return tag - 0x100
    if tag in _INTS:
        return r.unpack(_INTS[tag])
    if tag == 0xC0:
        return None
    if tag in (0xC2, 0xC3):
        return tag == 0xC3
    if 0xA0 <= tag <= 0xBF:
        kind, n = "str", tag & 0x1F
    elif 0x90 <= tag <= 0x9F:
        kind, n = "array", tag & 0x0F
    elif 0x80 <= tag <= 0x8F:
        kind, n = "map", tag & 0x0F
    elif tag in _SIZED:
        kind, fmt = _SIZED[tag]
        n = r.unpack(fmt)
    else:
        raise ValueError(f"MessagePack type 0x{tag:02x} is not covered by "
                         f"this codec")
    if kind == "str":
        return str(r.take(n), "utf-8")
    if kind == "bin":
        return bytes(r.take(n))
    if kind == "array":
        return [_read(r) for _ in range(n)]
    out = {}
    for _ in range(n):
        k = _read(r)
        out[k] = _read(r)
    return out


def unpackb(data: bytes):
    """The object of MessagePack ``data`` (as ``msgpack.unpackb(data,
    raw=False)`` reads the covered types)."""
    r = _Reader(data)
    obj = _read(r)
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} bytes of extra data after "
                         f"the MessagePack object")
    return obj
