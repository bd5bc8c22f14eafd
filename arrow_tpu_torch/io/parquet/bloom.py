"""Parquet's split-block bloom filter (counterpart of
``arrow_tpu/io/parquet/bloom.py``; reference: cpp/src/parquet/
bloom_filter.h BlockSplitBloomFilter and the format's BloomFilter.md).

A value hashes as xxhash64 of its PLAIN encoding; its block is
``((h >> 32) * num_blocks) >> 32``, and each of the block's 8 words gets
the bit ``(uint32)(h * SALT[j]) >> 27``.
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np

_SALT = np.array([0x47B6137B, 0x44974D91, 0x8824AD5B, 0xA2B7289D,
                  0x705495C7, 0x2DF1424B, 0x9EFC4947, 0x5C6BFB31],
                 dtype=np.uint64)

_P1 = np.uint64(0x9E3779B185EBCA87)
_P2 = np.uint64(0xC2B2AE3D27D4EB4F)
_P3 = np.uint64(0x165667B19E3779F9)
_P4 = np.uint64(0x85EBCA77C2B2AE63)
_P5 = np.uint64(0x27D4EB2F165667C5)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint64(r)) | (x >> np.uint64(64 - r))


def _avalanche(h: np.ndarray) -> np.ndarray:
    h = h ^ (h >> np.uint64(33))
    h = h * _P2
    h = h ^ (h >> np.uint64(29))
    h = h * _P3
    h = h ^ (h >> np.uint64(32))
    return h


def xxhash64_u64(words: np.ndarray) -> np.ndarray:
    """XXH64(8-byte little-endian input, seed 0), vectorized."""
    with np.errstate(over="ignore"):
        h = _P5 + np.uint64(8)
        k1 = words.astype(np.uint64) * _P2
        k1 = _rotl(k1, 31)
        k1 = k1 * _P1
        h = h ^ k1
        h = _rotl(h, 27) * _P1 + _P4
        return _avalanche(h)


def xxhash64_u32(words: np.ndarray) -> np.ndarray:
    """XXH64(4-byte little-endian input, seed 0), vectorized."""
    with np.errstate(over="ignore"):
        h = _P5 + np.uint64(4)
        k = words.astype(np.uint64)
        h = h ^ (k * _P1)
        h = _rotl(h, 23) * _P2 + _P3
        return _avalanche(h)


def xxhash64_bytes(b: bytes) -> int:
    """XXH64 of arbitrary bytes, seed 0 (scalar; strings/binary values)."""
    n = len(b)
    with np.errstate(over="ignore"):
        if n >= 32:
            v1 = _P1 + _P2
            v2 = _P2
            v3 = np.uint64(0)
            v4 = np.uint64(0) - _P1
            i = 0
            while i + 32 <= n:
                for j, v in enumerate((v1, v2, v3, v4)):
                    lane = np.uint64(int.from_bytes(
                        b[i + 8 * j:i + 8 * j + 8], "little"))
                    v = v + lane * _P2
                    v = _rotl(v, 31) * _P1
                    if j == 0:
                        v1 = v
                    elif j == 1:
                        v2 = v
                    elif j == 2:
                        v3 = v
                    else:
                        v4 = v
                i += 32
            h = _rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + \
                _rotl(v4, 18)
            for v in (v1, v2, v3, v4):
                k = _rotl(v * _P2, 31) * _P1
                h = (h ^ k) * _P1 + _P4
        else:
            h = _P5
            i = 0
        h = h + np.uint64(n)
        while i + 8 <= n:
            k = np.uint64(int.from_bytes(b[i:i + 8], "little"))
            k = _rotl(k * _P2, 31) * _P1
            h = (h ^ k)
            h = _rotl(h, 27) * _P1 + _P4
            i += 8
        if i + 4 <= n:
            k = np.uint64(int.from_bytes(b[i:i + 4], "little"))
            h = (h ^ (k * _P1))
            h = _rotl(h, 23) * _P2 + _P3
            i += 4
        while i < n:
            h = (h ^ (np.uint64(b[i]) * _P5))
            h = _rotl(h, 11) * _P1
            i += 1
        return int(_avalanche(h))


class SplitBlockBloomFilter:
    def __init__(self, num_bytes: int, bitset: Optional[bytes] = None):
        # numBytes must be a power of two >= 32
        nb = 32
        while nb < num_bytes:
            nb <<= 1
        self.num_bytes = nb
        self.num_blocks = nb // 32
        if bitset is not None:
            self.words = np.frombuffer(bitset, np.uint32).reshape(
                self.num_blocks, 8).copy()
        else:
            self.words = np.zeros((self.num_blocks, 8), np.uint32)

    @classmethod
    def for_ndv(cls, ndv: int, fpp: float = 0.01):
        import math
        bits = max(256.0, -ndv * math.log(max(fpp, 1e-9))
                   / (math.log(2) ** 2))
        return cls(int(bits) // 8 + 1)

    def _block_and_mask(self, h: int):
        block = ((h >> 32) * self.num_blocks) >> 32
        x = np.uint32(h & 0xFFFFFFFF)
        with np.errstate(over="ignore"):
            bits = ((x * _SALT.astype(np.uint32)) >>
                    np.uint32(27)).astype(np.uint32)
        mask = (np.uint32(1) << bits).astype(np.uint32)
        return block, mask

    def insert_hash(self, h: int) -> None:
        block, mask = self._block_and_mask(h)
        self.words[block] |= mask

    def check_hash(self, h: int) -> bool:
        block, mask = self._block_and_mask(h)
        return bool(((self.words[block] & mask) == mask).all())

    def bitset(self) -> bytes:
        return self.words.tobytes()


def hash_value(v, physical: int) -> int:
    """Hash one python value as its parquet plain encoding."""
    from .reader import BOOLEAN, BYTE_ARRAY, DOUBLE, FLOAT, INT32, INT64
    if physical == INT32:
        return xxhash64_bytes(struct.pack("<i", int(v)))
    if physical == INT64:
        return xxhash64_bytes(struct.pack("<q", int(v)))
    if physical == FLOAT:
        return xxhash64_bytes(struct.pack("<f", float(v)))
    if physical == DOUBLE:
        return xxhash64_bytes(struct.pack("<d", float(v)))
    if physical == BYTE_ARRAY:
        b = v.encode() if isinstance(v, str) else bytes(v)
        return xxhash64_bytes(b)
    if physical == BOOLEAN:
        return xxhash64_bytes(b"\x01" if v else b"\x00")
    raise NotImplementedError(f"bloom hash for physical {physical}")
