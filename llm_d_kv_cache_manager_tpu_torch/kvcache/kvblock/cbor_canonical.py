"""Minimal canonical (deterministic) CBOR encoder for block-hash payloads.

The cross-fleet block-hash contract requires bit-exact agreement with the
reference indexer, which hashes ``FNV-64a(CBOR-canonical([parent, tokens,
extra]))`` per chunk (reference: pkg/kvcache/kvblock/token_processor.go:94-112
using fxamacker/cbor CanonicalEncOptions).  Only the types that can appear in
that payload are supported: unsigned/negative integers, byte strings, text
strings, lists, booleans and null.  Canonical form here means RFC 8949 §4.2.1
core deterministic encoding: shortest-form integer heads, definite lengths.

A nil Go slice encodes as CBOR null (fxamacker default NilContainers mode);
callers express that by passing ``None`` rather than ``[]``.
"""

from __future__ import annotations

import struct
from typing import Any, Sequence

_UINT64_MAX = 0xFFFFFFFFFFFFFFFF


def _head(major: int, value: int) -> bytes:
    """Encode a major type + shortest-form unsigned argument."""
    mt = major << 5
    if value < 24:
        return bytes((mt | value,))
    if value < 0x100:
        return bytes((mt | 24, value))
    if value < 0x10000:
        return struct.pack(">BH", mt | 25, value)
    if value < 0x100000000:
        return struct.pack(">BI", mt | 26, value)
    if value <= _UINT64_MAX:
        return struct.pack(">BQ", mt | 27, value)
    raise ValueError(f"integer too large for CBOR head: {value}")


def _encode_into(item: Any, out: bytearray) -> None:
    if item is None:
        out.append(0xF6)
    elif item is True:
        out.append(0xF5)
    elif item is False:
        out.append(0xF4)
    elif isinstance(item, int):
        if item >= 0:
            out += _head(0, item)
        else:
            out += _head(1, -1 - item)
    elif isinstance(item, bytes):
        out += _head(2, len(item))
        out += item
    elif isinstance(item, str):
        raw = item.encode("utf-8")
        out += _head(3, len(raw))
        out += raw
    elif isinstance(item, (list, tuple)):
        out += _head(4, len(item))
        for element in item:
            _encode_into(element, out)
    else:
        raise TypeError(f"unsupported CBOR type: {type(item)!r}")


def encode_canonical(item: Any) -> bytes:
    """Encode ``item`` as deterministic CBOR bytes."""
    out = bytearray()
    _encode_into(item, out)
    return bytes(out)


class CborDecodeError(ValueError):
    """Malformed or unsupported CBOR input."""


def _read_head(data: bytes, pos: int) -> tuple:
    """Decode one major-type head; returns (major, value, next_pos)."""
    if pos >= len(data):
        raise CborDecodeError("truncated CBOR head")
    initial = data[pos]
    major, info = initial >> 5, initial & 0x1F
    pos += 1
    if info < 24:
        return major, info, pos
    widths = {24: 1, 25: 2, 26: 4, 27: 8}
    width = widths.get(info)
    if width is None:
        raise CborDecodeError(f"unsupported CBOR head info {info}")
    if pos + width > len(data):
        raise CborDecodeError("truncated CBOR head argument")
    return (
        major,
        int.from_bytes(data[pos : pos + width], "big"),
        pos + width,
    )


def _decode_at(data: bytes, pos: int, depth: int = 0) -> tuple:
    if depth > 64:
        raise CborDecodeError("CBOR nesting too deep")
    if pos < len(data) and data[pos] in (0xF4, 0xF5, 0xF6):
        simple = {0xF4: False, 0xF5: True, 0xF6: None}[data[pos]]
        return simple, pos + 1
    major, value, pos = _read_head(data, pos)
    if major == 0:
        return value, pos
    if major == 1:
        return -1 - value, pos
    if major in (2, 3):
        if pos + value > len(data):
            raise CborDecodeError("truncated CBOR string body")
        raw = data[pos : pos + value]
        if major == 3:
            try:
                return raw.decode("utf-8"), pos + value
            except UnicodeDecodeError as exc:
                raise CborDecodeError(f"invalid UTF-8 text: {exc}") from exc
        return raw, pos + value
    if major == 4:
        out = []
        for _ in range(value):
            item, pos = _decode_at(data, pos, depth + 1)
            out.append(item)
        return out, pos
    raise CborDecodeError(f"unsupported CBOR major type {major}")


def decode_canonical(data: bytes) -> Any:
    """Decode bytes produced by :func:`encode_canonical` (same type
    subset: ints, byte/text strings, lists, booleans, null).  Raises
    :class:`CborDecodeError` on truncation, trailing garbage, or types
    outside the subset — a torn snapshot/journal record must fail
    loudly, never decode to a half-document."""
    item, pos = _decode_at(data, 0)
    if pos != len(data):
        raise CborDecodeError(
            f"{len(data) - pos} trailing bytes after CBOR item"
        )
    return item


def encode_hash_payload(
    parent: int, tokens: Sequence[int] | None, extra: Any
) -> bytes:
    """Encode the 3-element ``[parent, tokens, extra]`` block-hash payload."""
    out = bytearray()
    out += _head(4, 3)
    _encode_into(parent, out)
    if tokens is None:
        out.append(0xF6)
    else:
        out += _head(4, len(tokens))
        for token in tokens:
            out += _head(0, token)
    _encode_into(extra, out)
    return bytes(out)


# ---- chunk-payload fast path (the pure-Python hash hot loop) ----------
#
# Every link of a block-hash chain encodes ``[parent, chunk_tokens,
# null]`` where parent is a uint64 and the token-list length equals the
# configured block size — so the array head, the 9-byte parent head
# shape, the token-list head, and the trailing null are invariant
# framing that `encode_hash_payload` re-derived per chunk through
# generic dispatch.  `encode_chunk_payload` precomputes the invariant
# pieces and inlines shortest-form uint heads for the tokens; output is
# bit-identical to ``encode_hash_payload(parent, tokens, None)``
# (pinned by tests/test_read_path_fastlane.py against the generic
# encoder and the golden chain vectors).  It returns a ``bytearray`` so
# the caller can hash it without a defensive ``bytes`` copy.

_TOKENS_HEAD_CACHE: dict = {}


def _tokens_head(n: int) -> bytes:
    head = _TOKENS_HEAD_CACHE.get(n)
    if head is None:
        head = _head(4, n)
        _TOKENS_HEAD_CACHE[n] = head
    return head


def encode_chunk_payload(parent: int, tokens: Sequence[int]) -> bytearray:
    """``[parent, tokens, null]`` as canonical CBOR, framing precomputed."""
    out = bytearray(b"\x83")  # array(3), invariant
    if parent < 24:
        out.append(parent)
    else:
        out += _head(0, parent)
    out += _tokens_head(len(tokens))
    pack = struct.pack
    for token in tokens:
        if token < 24:
            out.append(token)
        elif token < 0x100:
            out.append(0x18)
            out.append(token)
        elif token < 0x10000:
            out += pack(">BH", 0x19, token)
        elif token < 0x100000000:
            out += pack(">BI", 0x1A, token)
        else:
            out += _head(0, token)
    out.append(0xF6)  # null extra, invariant
    return out
