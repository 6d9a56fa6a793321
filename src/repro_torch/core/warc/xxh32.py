"""Pure-Python xxHash-32 (needed for LZ4 frame header/content checksums).

The LZ4 frame format (lz4.github.io/lz4/lz4_Frame_format.md) mandates
xxHash-32 for its header checksum and optional content checksum. No lz4 or
xxhash wheel is available offline, so the hash is implemented here and
round-trip verified against published test vectors in the test suite.
"""
from __future__ import annotations

import struct

_P1 = 2654435761
_P2 = 2246822519
_P3 = 3266489917
_P4 = 668265263
_P5 = 374761393
_M32 = 0xFFFFFFFF


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def _round(acc: int, lane: int) -> int:
    acc = (acc + lane * _P2) & _M32
    return (_rotl(acc, 13) * _P1) & _M32


def xxh32(data: bytes | bytearray | memoryview, seed: int = 0) -> int:
    """xxHash-32 of ``data`` with ``seed``; returns an unsigned 32-bit int."""
    data = bytes(data)
    n = len(data)
    i = 0
    if n >= 16:
        v1 = (seed + _P1 + _P2) & _M32
        v2 = (seed + _P2) & _M32
        v3 = seed & _M32
        v4 = (seed - _P1) & _M32
        limit = n - 16
        unpack = struct.unpack_from
        while i <= limit:
            l1, l2, l3, l4 = unpack("<IIII", data, i)
            v1 = _round(v1, l1)
            v2 = _round(v2, l2)
            v3 = _round(v3, l3)
            v4 = _round(v4, l4)
            i += 16
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M32
    else:
        h = (seed + _P5) & _M32
    h = (h + n) & _M32
    while i + 4 <= n:
        (lane,) = struct.unpack_from("<I", data, i)
        h = (h + lane * _P3) & _M32
        h = (_rotl(h, 17) * _P4) & _M32
        i += 4
    while i < n:
        h = (h + data[i] * _P5) & _M32
        h = (_rotl(h, 11) * _P1) & _M32
        i += 1
    h ^= h >> 15
    h = (h * _P2) & _M32
    h ^= h >> 13
    h = (h * _P3) & _M32
    h ^= h >> 16
    return h
