"""MessagePack codec for the KV-event wire, in pure Python.

The event stream's payloads are MessagePack (``kvevents/events.py``).
The machines the port runs on need not have the ``msgpack`` library, so
the port carries its own codec with the library's semantics under the
two calls the event plane makes:

* :func:`packb` gives the bytes of ``msgpack.packb(obj,
  use_bin_type=True)``: the smallest format for each int, float64 for
  every float, str8 and bin for text and bytes, ``ExtType`` and
  ``Timestamp`` as ext, tuples as arrays, nesting past 511 levels
  refused;
* :func:`unpackb` gives the value of ``msgpack.unpackb(data, raw=False,
  strict_map_key=False)`` and raises where it raises: truncated input
  (``ValueError``), trailing bytes (:class:`ExtraData`), the reserved
  byte ``0xc1`` (:class:`FormatError`), more than 1024 open containers
  (:class:`StackError`), an array or map header that claims more
  elements than the input could hold (``ValueError``), invalid UTF-8 in
  a str (``UnicodeDecodeError``), an unhashable map key
  (``TypeError``), a bad timestamp or ext code (``ValueError``).

The decoder is iterative (no recursion limit to hit before the
library's own stack limit) and reads runs of integers inside an array
in one tight loop: token-id lists are most of every ``BlockStored``.
"""

from __future__ import annotations

import struct
from collections import namedtuple
from typing import Any, List

__all__ = [
    "ExtType",
    "ExtraData",
    "FormatError",
    "StackError",
    "Timestamp",
    "packb",
    "unpackb",
]

# msgpack's limits: an object nested deeper than this is refused by the
# packer; more open containers than this by the unpacker.
_PACK_NEST_LIMIT = 511
_UNPACK_STACK = 1024

_DOUBLE = struct.Struct(">d")
_FLOAT = struct.Struct(">f")
_U16 = struct.Struct(">H").unpack_from
_U32 = struct.Struct(">I").unpack_from
_TAG_U16 = struct.Struct(">BH").pack
_TAG_U32 = struct.Struct(">BI").pack


class FormatError(ValueError):
    """Invalid msgpack format (the reserved byte ``0xc1``)."""


class StackError(ValueError):
    """More open containers than the unpacker's stack holds."""


class ExtraData(ValueError):
    """The input holds bytes after its one object."""

    def __init__(self, unpacked, extra) -> None:
        super().__init__()
        self.unpacked = unpacked
        self.extra = extra

    def __str__(self) -> str:
        return "unpack(b) received extra data."


class ExtType(namedtuple("ExtType", "code data")):
    """An ext value of an application type code (0-127)."""

    def __new__(cls, code, data):
        if not isinstance(code, int):
            raise TypeError("code must be int")
        if not isinstance(data, bytes):
            raise TypeError("data must be bytes")
        if not 0 <= code <= 127:
            raise ValueError("code must be 0~127")
        return super().__new__(cls, code, data)


class Timestamp:
    """The timestamp extension (ext type -1): seconds since the epoch,
    which may be negative, plus 0-999,999,999 nanoseconds."""

    __slots__ = ("seconds", "nanoseconds")

    def __init__(self, seconds, nanoseconds=0) -> None:
        if not isinstance(seconds, int):
            raise TypeError("seconds must be an integer")
        if not isinstance(nanoseconds, int):
            raise TypeError("nanoseconds must be an integer")
        if not 0 <= nanoseconds < 10**9:
            raise ValueError(
                "nanoseconds must be a non-negative integer less than 999999999."
            )
        self.seconds = seconds
        self.nanoseconds = nanoseconds

    def __repr__(self) -> str:
        return f"Timestamp(seconds={self.seconds}, nanoseconds={self.nanoseconds})"

    def __eq__(self, other) -> bool:
        if type(other) is self.__class__:
            return (self.seconds, self.nanoseconds) == (other.seconds, other.nanoseconds)
        return False

    def __ne__(self, other) -> bool:
        return not self.__eq__(other)

    def __hash__(self) -> int:
        return hash((self.seconds, self.nanoseconds))

    @staticmethod
    def from_bytes(b: bytes) -> "Timestamp":
        if len(b) == 4:
            seconds, nanoseconds = struct.unpack(">I", b)[0], 0
        elif len(b) == 8:
            data64 = struct.unpack(">Q", b)[0]
            seconds, nanoseconds = data64 & 0x00000003FFFFFFFF, data64 >> 34
        elif len(b) == 12:
            nanoseconds, seconds = struct.unpack(">Iq", b)
        else:
            raise ValueError(
                "Timestamp type can only be created from 32, 64, or 96-bit byte objects"
            )
        return Timestamp(seconds, nanoseconds)

    def to_bytes(self) -> bytes:
        if (self.seconds >> 34) == 0:
            data64 = self.nanoseconds << 34 | self.seconds
            if data64 & 0xFFFFFFFF00000000 == 0:
                return struct.pack(">I", data64)
            return struct.pack(">Q", data64)
        try:
            return struct.pack(">Iq", self.nanoseconds, self.seconds)
        except struct.error as exc:
            raise OverflowError("Timestamp seconds out of range") from exc


# ---------------------------------------------------------------- packing


def _pack_int(x: int, out: bytearray) -> None:
    if x >= 0:
        if x < 0x80:
            out.append(x)
        elif x <= 0xFF:
            out += bytes((0xCC, x))
        elif x <= 0xFFFF:
            out.append(0xCD)
            out += x.to_bytes(2, "big")
        elif x <= 0xFFFFFFFF:
            out.append(0xCE)
            out += x.to_bytes(4, "big")
        elif x <= 0xFFFFFFFFFFFFFFFF:
            out.append(0xCF)
            out += x.to_bytes(8, "big")
        else:
            raise OverflowError("Integer value out of range")
    elif x >= -32:
        out.append(x & 0xFF)
    elif x >= -0x80:
        out.append(0xD0)
        out += x.to_bytes(1, "big", signed=True)
    elif x >= -0x8000:
        out.append(0xD1)
        out += x.to_bytes(2, "big", signed=True)
    elif x >= -0x80000000:
        out.append(0xD2)
        out += x.to_bytes(4, "big", signed=True)
    elif x >= -0x8000000000000000:
        out.append(0xD3)
        out += x.to_bytes(8, "big", signed=True)
    else:
        raise OverflowError("Integer value out of range")


def _pack_len(n: int, out: bytearray, tags, what: str) -> None:
    """Header of a str/bin/array/map: ``tags`` = (fix base or None,
    fix max, 8-bit tag or None, 16-bit tag, 32-bit tag)."""
    fix, fix_max, tag8, tag16, tag32 = tags
    if fix is not None and n <= fix_max:
        out.append(fix | n)
    elif tag8 is not None and n <= 0xFF:
        out += bytes((tag8, n))
    elif n <= 0xFFFF:
        out.append(tag16)
        out += n.to_bytes(2, "big")
    elif n <= 0xFFFFFFFF:
        out.append(tag32)
        out += n.to_bytes(4, "big")
    else:
        raise ValueError(f"{what} is too large")


_STR = (0xA0, 31, 0xD9, 0xDA, 0xDB)
_BIN = (None, 0, 0xC4, 0xC5, 0xC6)
_ARRAY = (0x90, 15, None, 0xDC, 0xDD)
_MAP = (0x80, 15, None, 0xDE, 0xDF)
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    n = len(data)
    tag = _FIXEXT.get(n)
    if tag is not None:
        out.append(tag)
    elif n <= 0xFF:
        out += bytes((0xC7, n))
    elif n <= 0xFFFF:
        out.append(0xC8)
        out += n.to_bytes(2, "big")
    elif n <= 0xFFFFFFFF:
        out.append(0xC9)
        out += n.to_bytes(4, "big")
    else:
        raise ValueError("EXT data is too large")
    out += code.to_bytes(1, "big", signed=True)
    out += data


def _pack(obj: Any, out: bytearray, depth: int) -> None:
    if depth > _PACK_NEST_LIMIT:
        raise ValueError("recursion limit exceeded.")
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += _DOUBLE.pack(obj)
    elif isinstance(obj, (bytes, bytearray)):
        _pack_len(len(obj), out, _BIN, "bytes object")
        out += obj
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(len(data), out, _STR, "unicode string")
        out += data
    elif isinstance(obj, dict):
        _pack_len(len(obj), out, _MAP, "dict")
        for key, value in obj.items():
            _pack(key, out, depth + 1)
            _pack(value, out, depth + 1)
    elif isinstance(obj, ExtType):
        _pack_ext(obj.code, obj.data, out)
    elif type(obj) is Timestamp:
        _pack_ext(-1, obj.to_bytes(), out)
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), out, _ARRAY, "list")
        if obj and depth >= _PACK_NEST_LIMIT:
            raise ValueError("recursion limit exceeded.")
        append, extend = out.append, out.extend
        for item in obj:
            # Token-id lists: exact uint32 ints inline, the rest through
            # the general path.
            if type(item) is int and 0 <= item <= 0xFFFFFFFF:
                if item < 0x80:
                    append(item)
                elif item <= 0xFF:
                    extend((0xCC, item))
                elif item <= 0xFFFF:
                    extend(_TAG_U16(0xCD, item))
                else:
                    extend(_TAG_U32(0xCE, item))
            else:
                _pack(item, out, depth + 1)
    elif isinstance(obj, memoryview):
        data = obj.tobytes() if obj.contiguous else None
        if data is None:
            raise BufferError("memoryview is not contiguous")
        _pack_len(len(data), out, _BIN, "memoryview")
        out += data
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj: Any) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)``."""
    out = bytearray()
    _pack(obj, out, 0)
    return bytes(out)


# -------------------------------------------------------------- unpacking


# A map awaiting its next key.
_NO_KEY = object()


def _incomplete() -> ValueError:
    return ValueError("Unpack failed: incomplete input")


# Fixed-width ints: tag -> (size in bytes, signed).
_INTS = {
    0xCC: (1, False), 0xCD: (2, False), 0xCE: (4, False), 0xCF: (8, False),
    0xD0: (1, True), 0xD1: (2, True), 0xD2: (4, True), 0xD3: (8, True),
}
_FIXEXT_LEN = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


def _int_run(data: bytes, pos: int, n: int, count: int, out: List[int]) -> int:
    """Append up to ``count`` consecutive int elements starting at
    ``pos``; stops at the first other element and short of the input's
    last five bytes (the general path reads those, truncation checks
    included).  Returns the new position."""
    append = out.append
    end = len(out) + count
    limit = n - 5
    while pos <= limit and len(out) < end:
        b = data[pos]
        if b < 0x80:
            append(b)
            pos += 1
        elif b == 0xCD:
            append(_U16(data, pos + 1)[0])
            pos += 3
        elif b == 0xCE:
            append(_U32(data, pos + 1)[0])
            pos += 5
        elif b == 0xCC:
            append(data[pos + 1])
            pos += 2
        elif b >= 0xE0:
            append(b - 0x100)
            pos += 1
        else:
            break
    return pos


def unpackb(data) -> Any:
    """``msgpack.unpackb(data, raw=False, strict_map_key=False)``;
    ``data`` is any bytes-like object."""
    if not isinstance(data, bytes):
        data = bytes(data)
    n = len(data)
    max_array, max_map = n, n // 2
    pos = 0
    # Open containers: [list_or_dict, remaining, pending map key or _NO_KEY].
    stack: List[list] = []
    while True:
        if pos >= n:
            raise _incomplete()
        b = data[pos]
        pos += 1
        container = None
        count = 0
        if b < 0x80:
            obj = b
        elif b >= 0xE0:
            obj = b - 0x100
        elif b >= 0xA0 and b <= 0xBF:
            size = b & 0x1F
            if pos + size > n:
                raise _incomplete()
            obj = data[pos:pos + size].decode("utf-8")
            pos += size
        elif b == 0xC4:  # bin8: a sha256_cbor block hash
            if pos >= n:
                raise _incomplete()
            size = data[pos]
            pos += 1
            if pos + size > n:
                raise _incomplete()
            obj = data[pos:pos + size]
            pos += size
        elif b >= 0x90 and b <= 0x9F:
            container, count = "array", b & 0x0F
        elif b >= 0x80 and b <= 0x8F:
            container, count = "map", b & 0x0F
        elif b == 0xC0:
            obj = None
        elif b == 0xC2:
            obj = False
        elif b == 0xC3:
            obj = True
        elif b in _INTS:
            size, signed = _INTS[b]
            if pos + size > n:
                raise _incomplete()
            obj = int.from_bytes(data[pos:pos + size], "big", signed=signed)
            pos += size
        elif b == 0xCB or b == 0xCA:
            size = 8 if b == 0xCB else 4
            if pos + size > n:
                raise _incomplete()
            obj = (_DOUBLE if size == 8 else _FLOAT).unpack_from(data, pos)[0]
            pos += size
        elif b in (0xD9, 0xDA, 0xDB, 0xC5, 0xC6):
            width = {0xD9: 1, 0xDA: 2, 0xDB: 4, 0xC5: 2, 0xC6: 4}[b]
            if pos + width > n:
                raise _incomplete()
            size = int.from_bytes(data[pos:pos + width], "big")
            pos += width
            if pos + size > n:
                raise _incomplete()
            raw = data[pos:pos + size]
            pos += size
            obj = raw.decode("utf-8") if b >= 0xD9 else raw
        elif b in (0xDC, 0xDD, 0xDE, 0xDF):
            width = 2 if b in (0xDC, 0xDE) else 4
            if pos + width > n:
                raise _incomplete()
            count = int.from_bytes(data[pos:pos + width], "big")
            pos += width
            container = "array" if b in (0xDC, 0xDD) else "map"
        elif b in _FIXEXT_LEN or b in (0xC7, 0xC8, 0xC9):
            if b in _FIXEXT_LEN:
                size = _FIXEXT_LEN[b]
            else:
                width = {0xC7: 1, 0xC8: 2, 0xC9: 4}[b]
                if pos + width > n:
                    raise _incomplete()
                size = int.from_bytes(data[pos:pos + width], "big")
                pos += width
            if pos + 1 + size > n:
                raise _incomplete()
            code = int.from_bytes(data[pos:pos + 1], "big", signed=True)
            ext = data[pos + 1:pos + 1 + size]
            pos += 1 + size
            obj = Timestamp.from_bytes(ext) if code == -1 else ExtType(code, ext)
        else:  # 0xc1, the one byte msgpack reserves
            raise FormatError()

        if container is not None:
            if len(stack) >= _UNPACK_STACK:
                raise StackError()
            if container == "array":
                if count > max_array:
                    raise ValueError(f"{count} exceeds max_array_len({max_array})")
                items: List[Any] = []
                if count:
                    pos = _int_run(data, pos, n, count, items)
                    left = count - len(items)
                    if left:
                        stack.append([items, left, None])
                        continue
                obj = items
            else:
                if count > max_map:
                    raise ValueError(f"{count} exceeds max_map_len({max_map})")
                if count:
                    stack.append([{}, count, _NO_KEY])
                    continue
                obj = {}

        # Hand the finished object to its container, closing every
        # container it completes.
        while stack:
            top = stack[-1]
            holder = top[0]
            if type(holder) is list:
                holder.append(obj)
                top[1] -= 1
                if top[1]:
                    before = len(holder)
                    pos = _int_run(data, pos, n, top[1], holder)
                    top[1] -= len(holder) - before
            elif top[2] is _NO_KEY:
                top[2] = obj
                break
            else:
                holder[top[2]] = obj
                top[2] = _NO_KEY
                top[1] -= 1
            if top[1]:
                break
            stack.pop()
            obj = holder
        else:
            if pos < n:
                raise ExtraData(obj, data[pos:])
            return obj
