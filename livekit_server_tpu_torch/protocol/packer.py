"""A small MessagePack codec for the port's binary frames.

The binary signal frames (protocol/signal.py) and the WebSocket media
frames (service/roommanager.py, service/rtcservice.py) are MessagePack.
The reference encodes them with the `msgpack` package, which a machine
that serves the port need not have, so the port carries this codec. It
covers what those frames hold: maps, arrays, str, bin, int, bool, nil
and float.

`packb(obj)` gives the same bytes as `msgpack.packb(obj,
use_bin_type=True)`: the smallest encoding of each int (unsigned types
for values >= 0, signed for negatives), str8 for short strings, bin
types for bytes, float64 for floats, and maps in the dict's order, so a
reference client reads the port's frames unchanged. `unpackb(data)`
decodes what `msgpack.unpackb(data, raw=False)` decodes: str as str, bin
as bytes, arrays as lists, float32 and float64 as float; a map key must
be str or bytes, and malformed, truncated or trailing input raises
ValueError. Ext types are refused.
"""

from __future__ import annotations

import struct

_PACK_DOUBLE = struct.Struct(">d").pack
_B = struct.Struct(">B")
_H = struct.Struct(">H")
_I = struct.Struct(">I")
_Q = struct.Struct(">Q")
_b = struct.Struct(">b")
_h = struct.Struct(">h")
_i = struct.Struct(">i")
_q = struct.Struct(">q")
_f = struct.Struct(">f")
_d = struct.Struct(">d")

_MAX_DEPTH = 512


def _pack_int(x: int, out: bytearray) -> None:
    if x >= 0:
        if x < 0x80:
            out.append(x)
        elif x < 0x100:
            out += b"\xcc" + _B.pack(x)
        elif x < 0x10000:
            out += b"\xcd" + _H.pack(x)
        elif x < 0x100000000:
            out += b"\xce" + _I.pack(x)
        elif x < 0x10000000000000000:
            out += b"\xcf" + _Q.pack(x)
        else:
            raise OverflowError("Integer value out of range")
    elif x >= -32:
        out.append(x & 0xFF)
    elif x >= -0x80:
        out += b"\xd0" + _b.pack(x)
    elif x >= -0x8000:
        out += b"\xd1" + _h.pack(x)
    elif x >= -0x80000000:
        out += b"\xd2" + _i.pack(x)
    elif x >= -0x8000000000000000:
        out += b"\xd3" + _q.pack(x)
    else:
        raise OverflowError("Integer value out of range")


def _pack_len(n: int, fix: int, fix_max: int, codes: bytes, out: bytearray) -> None:
    """Header of a sized type: a fix form below `fix_max`, else the 8-,
    16- or 32-bit length form (codes[0] may be 0 where there is none)."""
    if n < fix_max:
        out.append(fix | n)
    elif n < 0x100 and codes[0]:
        out += bytes([codes[0]]) + _B.pack(n)
    elif n < 0x10000:
        out += bytes([codes[1]]) + _H.pack(n)
    elif n < 0x100000000:
        out += bytes([codes[2]]) + _I.pack(n)
    else:
        raise ValueError("object too large to pack")


def _pack(obj, out: bytearray, depth: int) -> None:
    if depth > _MAX_DEPTH:
        raise ValueError("recursion limit exceeded")
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out += b"\xcb" + _PACK_DOUBLE(obj)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        n = len(data)
        if n < 0x100:
            out += b"\xc4" + _B.pack(n)
        elif n < 0x10000:
            out += b"\xc5" + _H.pack(n)
        elif n < 0x100000000:
            out += b"\xc6" + _I.pack(n)
        else:
            raise ValueError("bytes object too large to pack")
        out += data
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(len(data), 0xA0, 32, b"\xd9\xda\xdb", out)
        out += data
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 16, b"\x00\xde\xdf", out)
        for k, v in obj.items():
            _pack(k, out, depth + 1)
            _pack(v, out, depth + 1)
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 16, b"\x00\xdc\xdd", out)
        for v in obj:
            _pack(v, out, depth + 1)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj) -> bytes:
    """`obj` as MessagePack bytes (msgpack.packb(obj, use_bin_type=True))."""
    out = bytearray()
    _pack(obj, out, 0)
    return bytes(out)


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("Unpack failed: incomplete input")
        view = self.buf[self.pos:end]
        self.pos = end
        return view

    def unpack(self, st: struct.Struct):
        return st.unpack(self.take(st.size))[0]


def _str(r: _Reader, n: int) -> str:
    try:
        return str(r.take(n), "utf-8")
    except UnicodeDecodeError as e:
        raise ValueError(f"invalid utf-8 in str: {e}") from None


def _array(r: _Reader, n: int, depth: int) -> list:
    return [_unpack(r, depth + 1) for _ in range(n)]


def _map(r: _Reader, n: int, depth: int) -> dict:
    out = {}
    for _ in range(n):
        k = _unpack(r, depth + 1)
        if not isinstance(k, (str, bytes)):
            raise ValueError(f"{type(k).__name__} is not allowed for map key")
        out[k] = _unpack(r, depth + 1)
    return out


def _unpack(r: _Reader, depth: int):
    if depth > _MAX_DEPTH:
        raise ValueError("recursion limit exceeded")
    c = r.unpack(_B)
    if c < 0x80:
        return c
    if c >= 0xE0:
        return c - 0x100
    if c < 0x90:
        return _map(r, c & 0x0F, depth)
    if c < 0xA0:
        return _array(r, c & 0x0F, depth)
    if c < 0xC0:
        return _str(r, c & 0x1F)
    if c == 0xC0:
        return None
    if c == 0xC2:
        return False
    if c == 0xC3:
        return True
    if c == 0xC4:
        return bytes(r.take(r.unpack(_B)))
    if c == 0xC5:
        return bytes(r.take(r.unpack(_H)))
    if c == 0xC6:
        return bytes(r.take(r.unpack(_I)))
    if c == 0xCA:
        return r.unpack(_f)
    if c == 0xCB:
        return r.unpack(_d)
    ints = {0xCC: _B, 0xCD: _H, 0xCE: _I, 0xCF: _Q, 0xD0: _b, 0xD1: _h, 0xD2: _i, 0xD3: _q}
    if c in ints:
        return r.unpack(ints[c])
    if c == 0xD9:
        return _str(r, r.unpack(_B))
    if c == 0xDA:
        return _str(r, r.unpack(_H))
    if c == 0xDB:
        return _str(r, r.unpack(_I))
    if c == 0xDC:
        return _array(r, r.unpack(_H), depth)
    if c == 0xDD:
        return _array(r, r.unpack(_I), depth)
    if c == 0xDE:
        return _map(r, r.unpack(_H), depth)
    if c == 0xDF:
        return _map(r, r.unpack(_I), depth)
    raise ValueError(f"unsupported MessagePack type byte 0x{c:02x}")


def unpackb(data: bytes):
    """Decode one MessagePack object (msgpack.unpackb(data, raw=False));
    ValueError on malformed, truncated or trailing input."""
    r = _Reader(bytes(data))
    obj = _unpack(r, 0)
    if r.pos != len(r.buf):
        raise ValueError("Unpack failed: extra data after the object")
    return obj
