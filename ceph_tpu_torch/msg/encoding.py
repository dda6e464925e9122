"""Typed wire encoding — the src/messages/ encode/decode role.

Every daemon payload is a tree of {None, bool, int, float, str, bytes,
list/tuple, dict}; this module serializes exactly that set with
tag-length-value framing and NOTHING else.  Replaces pickle on all
network input (unauthenticated pickle is RCE-adjacent; the reference encodes typed message structs, it never
deserializes arbitrary objects — src/include/encoding.h).

Wire grammar (all integers little-endian):
    N                         None
    T / F                     True / False
    i <i64>                   int (fits 64-bit signed)
    I <u32 len> <bytes>       big int (signed, two's complement)
    d <f64>                   float
    s <u32 len> <utf8>        str
    b <u32 len> <bytes>       bytes
    l <u32 count> item*       list (tuples encode as lists)
    m <u32 count> (key value)*  dict
Decoding enforces a depth limit and rejects unknown tags.
"""
from __future__ import annotations

import struct
from typing import Any, Tuple

_I64 = struct.Struct("<q")
_U32 = struct.Struct("<I")
_F64 = struct.Struct("<d")

MAX_DEPTH = 32


class EncodingError(ValueError):
    pass


def _hashable(k):
    """Decoded dict keys: lists (wire form of tuples) convert back to
    tuples RECURSIVELY so nested-tuple keys round-trip."""
    if isinstance(k, list):
        return tuple(_hashable(x) for x in k)
    return k


def _enc(obj: Any, out: bytearray, depth: int) -> None:
    if depth > MAX_DEPTH:
        raise EncodingError("structure too deep")
    if obj is None:
        out.append(ord("N"))
    elif obj is True:
        out.append(ord("T"))
    elif obj is False:
        out.append(ord("F"))
    elif isinstance(obj, int):
        if -(1 << 63) <= obj < (1 << 63):
            out.append(ord("i"))
            out.extend(_I64.pack(obj))
        else:
            raw = obj.to_bytes((obj.bit_length() + 8) // 8,
                               "little", signed=True)
            out.append(ord("I"))
            out.extend(_U32.pack(len(raw)))
            out.extend(raw)
    elif isinstance(obj, float):
        out.append(ord("d"))
        out.extend(_F64.pack(obj))
    elif isinstance(obj, str):
        raw = obj.encode()
        out.append(ord("s"))
        out.extend(_U32.pack(len(raw)))
        out.extend(raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        out.append(ord("b"))
        out.extend(_U32.pack(len(raw)))
        out.extend(raw)
    elif isinstance(obj, (list, tuple)):
        out.append(ord("l"))
        out.extend(_U32.pack(len(obj)))
        for item in obj:
            _enc(item, out, depth + 1)
    elif isinstance(obj, dict):
        out.append(ord("m"))
        out.extend(_U32.pack(len(obj)))
        for k, v in obj.items():
            _enc(k, out, depth + 1)
            _enc(v, out, depth + 1)
    else:
        raise EncodingError(
            f"type {type(obj).__name__} is not wire-encodable")


def dumps(obj: Any) -> bytes:
    out = bytearray()
    _enc(obj, out, 0)
    return bytes(out)


def _dec(buf: bytes, pos: int, depth: int) -> Tuple[Any, int]:
    if depth > MAX_DEPTH:
        raise EncodingError("structure too deep")
    if pos >= len(buf):
        raise EncodingError("truncated")
    tag = buf[pos]
    pos += 1
    if tag == ord("N"):
        return None, pos
    if tag == ord("T"):
        return True, pos
    if tag == ord("F"):
        return False, pos
    if tag == ord("i"):
        if pos + 8 > len(buf):
            raise EncodingError("truncated i64")
        return _I64.unpack_from(buf, pos)[0], pos + 8
    if tag == ord("d"):
        if pos + 8 > len(buf):
            raise EncodingError("truncated f64")
        return _F64.unpack_from(buf, pos)[0], pos + 8
    if tag in (ord("I"), ord("s"), ord("b")):
        if pos + 4 > len(buf):
            raise EncodingError("truncated length")
        (n,) = _U32.unpack_from(buf, pos)
        pos += 4
        raw = buf[pos:pos + n]
        if len(raw) != n:
            raise EncodingError("truncated payload")
        pos += n
        if tag == ord("I"):
            return int.from_bytes(raw, "little", signed=True), pos
        if tag == ord("s"):
            return raw.decode(), pos
        return raw, pos
    if tag == ord("l"):
        if pos + 4 > len(buf):
            raise EncodingError("truncated count")
        (n,) = _U32.unpack_from(buf, pos)
        pos += 4
        items = []
        for _ in range(n):
            item, pos = _dec(buf, pos, depth + 1)
            items.append(item)
        return items, pos
    if tag == ord("m"):
        if pos + 4 > len(buf):
            raise EncodingError("truncated count")
        (n,) = _U32.unpack_from(buf, pos)
        pos += 4
        d = {}
        for _ in range(n):
            k, pos = _dec(buf, pos, depth + 1)
            v, pos = _dec(buf, pos, depth + 1)
            d[_hashable(k)] = v
        return d, pos
    raise EncodingError(f"unknown tag {tag:#x}")


def loads(buf: bytes) -> Any:
    obj, pos = _dec(bytes(buf), 0, 0)  # noqa: CTL130 — typed metas
    # are ~100 bytes; bulk payloads never pass through this decoder
    # (they ride the scatter-gather frame tail / shm ring)
    if pos != len(buf):
        raise EncodingError(f"{len(buf) - pos} trailing bytes")
    return obj
