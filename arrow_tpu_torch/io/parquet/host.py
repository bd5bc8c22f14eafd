"""Bindings of Parquet's host library, ``csrc/parquet_host.cpp`` (the
counterpart of the Parquet entry points of ``arrow_tpu/native/__init__.py``):
the RLE / bit-packed hybrid, the page walker of flat column chunks,
BYTE_ARRAY's PLAIN codec, binary min/max, gathers of variable-length
values and dictionary encoding in order of first appearance.

The library is required: it is built with the host C++ compiler at first
use (``kernels/_build.host_library``), and where it cannot be built every
call raises NotImplementedError. No call falls back to a slower path. The
calls release Python's lock.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np

from ...utils.snappy import _bytes_of

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
_SIGNATURES = {
    "rle_decode": (_I64, [_P, _I64, _I64, _I64, _I32, _P]),
    "rle_encode": (_I64, [_P, _I64, _I32, _P]),
    "rle_max_encoded": (_I64, [_I64]),
    "plain_decode_byte_array": (_I64, [_P, _I64, _I64, _P, _P]),
    "plain_encode_byte_array": (_I64, [_P, _P, _P, _I64, _P]),
    "minmax_binary": (_I64, [_P, _P, _P, _I64, _P]),
    "gather_var_bytes": (None, [_P, _P, _P, _I64, _P, _P]),
    "dict_encode_binary": (_P, [_P, _P, _P, _I64]),
    "dict_encode_n_unique": (_I64, [_P]),
    "dict_encode_uniq_bytes": (_I64, [_P]),
    "dict_encode_fill": (None, [_P, _P, _P, _P]),
    "dict_encode_free": (None, [_P]),
    "pq_scan_pages": (_I64, [_P, _I64, _I64, _I64, _P]),
    "pq_decode_flat": (_I64, [_P, _I64, _P, _I64, _I32, _I32, _I32, _I32,
                              _P, _I64, _P, _I64, _P, _I64, _P, _I64,
                              _P, _P, _P]),
}


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built library, or NotImplementedError where it cannot be
    built."""
    from ...kernels._build import BuildError, host_library
    try:
        lib = host_library("parquet_host")
    except BuildError as exc:
        raise NotImplementedError(
            f"Parquet needs its host library, which failed to build: {exc}"
        ) from None
    for name, (res, args) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args
    return lib


def _ptr(arr: np.ndarray) -> int:
    return arr.ctypes.data


def rle_decode(data, pos: int, num_values: int, bit_width: int
               ) -> np.ndarray:
    """``num_values`` int64 values of the hybrid stream at ``data[pos:]``;
    ValueError where the stream ends early."""
    src = _bytes_of(data)
    out = np.empty(num_values, dtype=np.int64)
    if num_values == 0:
        return out
    used = library().rle_decode(_ptr(src), src.size, pos, num_values,
                                bit_width, _ptr(out))
    if used < 0:
        raise ValueError("RLE stream truncated")
    return out


def rle_encode(values: np.ndarray, bit_width: int) -> bytes:
    lib = library()
    values = np.ascontiguousarray(values, dtype=np.int64)
    out = np.empty(lib.rle_max_encoded(len(values)), dtype=np.uint8)
    n = lib.rle_encode(_ptr(values), len(values), bit_width, _ptr(out))
    return out[:n].tobytes()


def plain_decode_byte_array(data, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """(offsets int64[n + 1], the values' bytes) of ``n`` length-prefixed
    values; ValueError where the data ends early."""
    src = _bytes_of(data)
    offsets = np.empty(n + 1, np.int64)
    out = np.empty(max(src.size, 1), np.uint8)
    written = library().plain_decode_byte_array(
        _ptr(src), src.size, n, _ptr(offsets), _ptr(out))
    if written < 0:
        raise ValueError("parquet BYTE_ARRAY data truncated")
    return offsets, out[:written]


def plain_encode_byte_array(pool: np.ndarray, offsets: np.ndarray,
                            present: Optional[np.ndarray]) -> bytes:
    """The present values (all where ``present`` is None) length-prefixed."""
    pool = np.ascontiguousarray(pool, np.uint8)
    offsets = np.ascontiguousarray(offsets, np.int64)
    n = len(offsets) - 1
    lens = offsets[1:] - offsets[:-1]
    pptr = None
    if present is not None:
        present = np.ascontiguousarray(present, np.uint8)
        pptr = _ptr(present)
        keep = present != 0
        cap = int(lens[keep].sum()) + 4 * int(keep.sum())
    else:
        cap = int(lens.sum()) + 4 * n
    out = np.empty(max(cap, 1), np.uint8)
    written = library().plain_encode_byte_array(_ptr(pool), _ptr(offsets),
                                                pptr, n, _ptr(out))
    return out[:written].tobytes()


def minmax_binary(pool: np.ndarray, offsets: np.ndarray,
                  valid: Optional[np.ndarray]) -> Tuple[int, int, int]:
    """(the least value's index, the greatest's, the valid count) by
    unsigned byte order; the indices are -1 where none is valid."""
    pool = np.ascontiguousarray(pool, np.uint8)
    offsets = np.ascontiguousarray(offsets, np.int64)
    vptr = None
    if valid is not None:
        valid = np.ascontiguousarray(valid, np.uint8)
        vptr = _ptr(valid)
    idx = np.empty(2, np.int64)
    count = library().minmax_binary(_ptr(pool), _ptr(offsets), vptr,
                                    len(offsets) - 1, _ptr(idx))
    return int(idx[0]), int(idx[1]), int(count)


def gather_var_bytes(pool: np.ndarray, offsets: np.ndarray,
                     ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(offsets int64[len(ids) + 1], bytes): values ``ids`` of (pool,
    offsets) laid end to end."""
    pool = np.ascontiguousarray(pool, np.uint8)
    offsets = np.ascontiguousarray(offsets, np.int64)
    ids = np.ascontiguousarray(ids, np.int64)
    lens = offsets[ids + 1] - offsets[ids]
    out_offsets = np.zeros(len(ids) + 1, np.int64)
    np.cumsum(lens, out=out_offsets[1:])
    total = int(out_offsets[-1])
    out = np.empty(max(total, 1), np.uint8)
    library().gather_var_bytes(_ptr(pool), _ptr(offsets), _ptr(ids),
                               len(ids), _ptr(out_offsets), _ptr(out))
    return out_offsets, out[:total]


def dict_encode_binary(data: np.ndarray, offsets: np.ndarray,
                       valid: Optional[np.ndarray]):
    """(codes int32[n], the distinct values' offsets int32[u + 1] and bytes)
    in order of first appearance; a null is coded as the empty value."""
    lib = library()
    n = len(offsets) - 1
    data = np.ascontiguousarray(data, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    vptr = None
    if valid is not None:
        valid = np.ascontiguousarray(valid, dtype=np.uint8)
        vptr = _ptr(valid)
    handle = lib.dict_encode_binary(_ptr(data), _ptr(offsets), vptr, n)
    try:
        u = lib.dict_encode_n_unique(handle)
        nbytes = lib.dict_encode_uniq_bytes(handle)
        codes = np.empty(n, dtype=np.int32)
        uoffs = np.empty(u + 1, dtype=np.int32)
        ubytes = np.empty(max(nbytes, 1), dtype=np.uint8)
        lib.dict_encode_fill(handle, _ptr(codes), _ptr(uoffs), _ptr(ubytes))
        return codes, uoffs, ubytes[:nbytes]
    finally:
        lib.dict_encode_free(handle)


def pq_scan_pages(blob, expect_values: int) -> Optional[np.ndarray]:
    """Every page header of a column chunk in one call: an (n_pages, 10)
    int64 table, a row a page ([page type, payload offset, compressed,
    uncompressed, values, encoding, nulls, definition levels' bytes,
    repetition levels' bytes, v2 values compressed]); None where the chunk
    is malformed or truncated."""
    lib = library()
    src = _bytes_of(blob)
    max_pages = 8
    while True:
        tab = np.zeros((max_pages, 10), dtype=np.int64)
        n = lib.pq_scan_pages(_ptr(src), src.size, expect_values, max_pages,
                              _ptr(tab))
        if n >= 0:
            return tab[:n]
        # a full table may only have run out of rows: try a larger one
        if max_pages < (1 << 22) and int((tab[:, 4] > 0).sum()) >= \
                max_pages - 1:
            max_pages *= 8
            continue
        return None


def pq_decode_flat(blob, tab: np.ndarray, codec: int, max_def: int,
                   def_bw: int, byte_width: int, expect_values: int):
    """A flat fixed-width column chunk decoded in one call: (validity
    uint8, PLAIN bytes, dictionary indices int64, each page's kind, each
    page's present values, the dictionary page's bytes), or None where an
    encoding or codec is one the call does not decode. A malformed chunk
    raises OSError."""
    lib = library()
    src = _bytes_of(blob)
    tab = np.ascontiguousarray(tab, dtype=np.int64)
    n_pages = len(tab)
    dict_rows = tab[tab[:, 0] == 2]
    dict_cap = int(dict_rows[:, 3].max()) if len(dict_rows) else 1
    encs = tab[(tab[:, 0] == 0) | (tab[:, 0] == 3), 5]
    validity = np.empty(max(expect_values, 1), dtype=np.uint8)
    plain = np.empty(max(int(tab[:, 3].sum()), 1) if (encs == 0).any()
                     else 1, dtype=np.uint8)
    idx = np.empty(max(expect_values, 1) if ((encs == 2) | (encs == 8)).any()
                   else 1, dtype=np.int64)
    dict_buf = np.empty(max(dict_cap, 1), dtype=np.uint8)
    page_kind = np.empty(n_pages, dtype=np.int64)
    page_np = np.empty(n_pages, dtype=np.int64)
    totals = np.zeros(6, dtype=np.int64)
    rc = lib.pq_decode_flat(
        _ptr(src), src.size, _ptr(tab), n_pages, codec, max_def, def_bw,
        byte_width, _ptr(validity), validity.size, _ptr(plain), plain.size,
        _ptr(idx), idx.size, _ptr(dict_buf), dict_buf.size, _ptr(page_kind),
        _ptr(page_np), _ptr(totals))
    if rc == -2:
        raise OSError("malformed Parquet column chunk: a page's sizes or "
                      "levels overrun it")
    if rc != 0:
        return None
    nv, _, pbytes, icount, dbytes = (int(totals[i]) for i in range(5))
    return (validity[:nv], plain[:pbytes], idx[:icount], page_kind,
            page_np, dict_buf[:dbytes].tobytes())
