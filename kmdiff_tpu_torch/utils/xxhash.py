"""Pure-Python xxHash (XXH32 / XXH64), clean-room from the public spec.

Used for LZ4 frame header checksums and for k-mer hashing parity with the
reference's hash-set accumulator (reference: include/kmdiff/kmer.hpp:157-173
hashes km::Kmer data words with XXH64 seed 0).
"""

from __future__ import annotations

import struct

_M32 = 0xFFFFFFFF
_P32_1 = 2654435761
_P32_2 = 2246822519
_P32_3 = 3266489917
_P32_4 = 668265263
_P32_5 = 374761393

def _rotl32(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def xxh32(data: bytes, seed: int = 0) -> int:
    n = len(data)
    i = 0
    if n >= 16:
        v1 = (seed + _P32_1 + _P32_2) & _M32
        v2 = (seed + _P32_2) & _M32
        v3 = seed & _M32
        v4 = (seed - _P32_1) & _M32
        while i + 16 <= n:
            for _ in range(1):
                lanes = struct.unpack_from("<IIII", data, i)
            v1 = (_rotl32((v1 + lanes[0] * _P32_2) & _M32, 13) * _P32_1) & _M32
            v2 = (_rotl32((v2 + lanes[1] * _P32_2) & _M32, 13) * _P32_1) & _M32
            v3 = (_rotl32((v3 + lanes[2] * _P32_2) & _M32, 13) * _P32_1) & _M32
            v4 = (_rotl32((v4 + lanes[3] * _P32_2) & _M32, 13) * _P32_1) & _M32
            i += 16
        h = (_rotl32(v1, 1) + _rotl32(v2, 7) + _rotl32(v3, 12) + _rotl32(v4, 18)) & _M32
    else:
        h = (seed + _P32_5) & _M32
    h = (h + n) & _M32
    while i + 4 <= n:
        (k,) = struct.unpack_from("<I", data, i)
        h = (_rotl32((h + k * _P32_3) & _M32, 17) * _P32_4) & _M32
        i += 4
    while i < n:
        h = (_rotl32((h + data[i] * _P32_5) & _M32, 11) * _P32_1) & _M32
        i += 1
    h ^= h >> 15
    h = (h * _P32_2) & _M32
    h ^= h >> 13
    h = (h * _P32_3) & _M32
    h ^= h >> 16
    return h

