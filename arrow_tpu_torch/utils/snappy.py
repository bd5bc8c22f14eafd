"""The raw snappy codec (counterpart of the reference's snappy entry points
in ``arrow_tpu/native/__init__.py``; reference:
cpp/src/arrow/util/compression_snappy.cc).

The card's machine has no snappy package, so the codec is the port's own
host library, ``csrc/snappy_host.cpp``, built with the host C++ compiler
at first use (``kernels/_build.host_library``) and loaded with ``ctypes``.
Its compressor is the reference's, so a buffer compresses to the
reference's bytes. Without a compiler, ``compress``/``decompress`` raise
NotImplementedError, as the reference's do without its native library.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built codec, or NotImplementedError where it cannot be built."""
    from ..kernels._build import BuildError, host_library
    try:
        lib = host_library("snappy_host")
    except BuildError as exc:
        raise NotImplementedError(
            f"snappy needs its host library, which failed to build: {exc}"
        ) from None
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    for name, args in (("snappy_compress", [p, i64, p]),
                       ("snappy_max_compressed", [i64]),
                       ("snappy_decompress", [p, i64, p, i64])):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = i64
    return lib


def _bytes_of(data) -> np.ndarray:
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data).view(np.uint8).reshape(-1)
    return np.frombuffer(data, dtype=np.uint8)


def uncompressed_length(data) -> int:
    """The length a raw snappy stream declares (its leading varint)."""
    src = _bytes_of(data)
    out = shift = 0
    for b in src[:10].tolist():
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out
        shift += 7
    raise ValueError("malformed snappy data")


def compress(data) -> bytes:
    lib = library()
    src = _bytes_of(data)
    out = np.empty(lib.snappy_max_compressed(src.size), dtype=np.uint8)
    n = lib.snappy_compress(src.ctypes.data, src.size, out.ctypes.data)
    return out[:n].tobytes()


def decompress(data, out_size: Optional[int] = None) -> bytes:
    """The bytes of a raw snappy stream, into ``out_size`` bytes at most
    (the stream's own length where None); ValueError where it is
    malformed."""
    lib = library()
    src = _bytes_of(data)
    cap = uncompressed_length(src) if out_size is None else int(out_size)
    out = np.empty(max(cap, 1), dtype=np.uint8)
    n = lib.snappy_decompress(src.ctypes.data, src.size, out.ctypes.data,
                              cap)
    if n < 0:
        raise ValueError("malformed snappy data")
    return out[:n].tobytes()
