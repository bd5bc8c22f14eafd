"""The LZ4 frame format (counterpart of ``arrow_tpu/utils/lz4frame.py``;
reference: cpp/src/arrow/util/compression_lz4.cc, Lz4FrameCodec, Arrow
IPC's BodyCompression LZ4_FRAME).

The card's machine has no ``lz4`` package, so the blocks and the frames are
coded by the port's own host library, ``csrc/lz4_host.cpp``, built with the
host C++ compiler at first use (``kernels/_build.host_library``) and loaded
with ``ctypes``. A frame is the reference's byte for byte: magic,
descriptor (FLG 0x60, BD 0x70) with its xxhash32 header checksum, 4 MiB
blocks coded by the reference's greedy matcher (raw where that does not
shrink them), the end mark. The frame's independent blocks are coded on
several threads, which changes no byte. Without a compiler,
``compress``/``decompress`` raise NotImplementedError, as the reference's
do without its native library; nothing is ever written uncompressed in a
frame's place.
"""

from __future__ import annotations

import ctypes
import functools
import os
import struct
from typing import Optional

import numpy as np

_MAGIC = 0x184D2204
_XP1, _XP2, _XP3, _XP4, _XP5 = (2654435761, 2246822519, 3266489917,
                                668265263, 374761393)
_M32 = 0xFFFFFFFF
_BLOCK_MAX = 4 * 1024 * 1024  # BD 0x70


def _rotl32(x, r):
    return ((x << r) | (x >> (32 - r))) & _M32


def xxhash32(data: bytes, seed: int = 0) -> int:
    """xxhash32 of ``data`` (the frame descriptor's checksum)."""
    n = len(data)
    i = 0
    if n >= 16:
        v = [(seed + _XP1 + _XP2) & _M32, (seed + _XP2) & _M32,
             seed & _M32, (seed - _XP1) & _M32]
        while i + 16 <= n:
            for j in range(4):
                lane = struct.unpack_from("<I", data, i + 4 * j)[0]
                v[j] = (_rotl32((v[j] + lane * _XP2) & _M32, 13)
                        * _XP1) & _M32
            i += 16
        h = (_rotl32(v[0], 1) + _rotl32(v[1], 7) + _rotl32(v[2], 12) +
             _rotl32(v[3], 18)) & _M32
    else:
        h = (seed + _XP5) & _M32
    h = (h + n) & _M32
    while i + 4 <= n:
        lane = struct.unpack_from("<I", data, i)[0]
        h = (_rotl32((h + lane * _XP3) & _M32, 17) * _XP4) & _M32
        i += 4
    while i < n:
        h = (_rotl32((h + data[i] * _XP5) & _M32, 11) * _XP1) & _M32
        i += 1
    h ^= h >> 15
    h = (h * _XP2) & _M32
    h ^= h >> 13
    h = (h * _XP3) & _M32
    h ^= h >> 16
    return h


_DESCRIPTOR = bytes([0x60, 0x70])
_HEADER_CHECKSUM = (xxhash32(_DESCRIPTOR) >> 8) & 0xFF


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built codec, or NotImplementedError where it cannot be built."""
    from ..kernels._build import BuildError, host_library
    try:
        lib = host_library("lz4_host")
    except BuildError as exc:
        raise NotImplementedError(f"native lz4 unavailable: {exc}") from None
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    for name, args in (
            ("lz4_frame_compress", [p, i64, p, ctypes.c_uint8,
                                    ctypes.c_int32]),
            ("lz4_frame_bound", [p, i64]),
            ("lz4_frame_decompress", [p, i64, p, i64, ctypes.c_int32])):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = i64
    return lib


def _threads(nbytes: int) -> int:
    return max(1, min(os.cpu_count() or 1, -(-nbytes // _BLOCK_MAX)))


def _bytes_of(data) -> np.ndarray:
    """``data`` (bytes, a buffer or a numpy array) as uint8 numpy, without
    a copy where it is contiguous."""
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data).view(np.uint8).reshape(-1)
    return np.frombuffer(data, dtype=np.uint8)


def compress_array(data) -> np.ndarray:
    """The LZ4 frame of ``data``, as uint8 numpy."""
    lib = library()
    src = _bytes_of(data)
    n = src.size
    out = np.empty(11 + n + 4 * (-(-n // _BLOCK_MAX)), dtype=np.uint8)
    size = lib.lz4_frame_compress(src.ctypes.data, n, out.ctypes.data,
                                  _HEADER_CHECKSUM, _threads(n))
    if size < 0:
        raise MemoryError("lz4: out of memory compressing a frame")
    return out[:size]


def compress(data) -> bytes:
    """LZ4 frame encode (independent blocks, no checksums beyond the
    header's)."""
    return compress_array(data).tobytes()


def decompress_array(data, expected_size: Optional[int] = None
                     ) -> np.ndarray:
    """The bytes of an LZ4 frame, as uint8 numpy: decoded into
    ``expected_size`` bytes where that is given and enough, else into the
    frame's bound."""
    lib = library()
    src = _bytes_of(data)
    if src.size < 7 or struct.unpack_from("<I", src[:4].tobytes())[0] \
            != _MAGIC:
        raise ValueError("not an lz4 frame")
    caps = [] if expected_size is None else [int(expected_size)]
    bound = lib.lz4_frame_bound(src.ctypes.data, src.size)
    if bound == -3:
        raise MemoryError("lz4: out of memory reading a frame")
    caps.append(bound)
    for cap in caps:
        out = np.empty(max(cap, 0), dtype=np.uint8)
        n = lib.lz4_frame_decompress(src.ctypes.data, src.size,
                                     out.ctypes.data, cap, _threads(cap))
        if n >= 0:
            return out[:n]
        if n == -1:
            break
        if n == -3:
            raise MemoryError("lz4: out of memory decoding a frame")
    raise ValueError("malformed lz4 block")


def decompress(data, expected_size: Optional[int] = None) -> bytes:
    return decompress_array(data, expected_size).tobytes()
