"""Bindings of the CSV and JSON host library, ``csrc/csv_host.cpp`` (the
counterpart of the CSV and JSON entry points of
``arrow_tpu/native/__init__.py``; reference: cpp/src/arrow/csv/ and
cpp/src/arrow/json/): the tokenizers, the bulk field parsers, the per-column
transpose, the flat JSON tokenizer and the writer's cell formatters.

The library is required: it is built with the host C++ compiler at first
use (``kernels/_build.host_library``), and where it cannot be built every
call raises NotImplementedError. No call falls back to a slower path. The
calls release Python's lock, so blocks tokenize and convert on threads.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional, Tuple

import numpy as np

_P, _I64, _I32, _U8 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
                       ctypes.c_uint8)
_PARSE = (_I64, [_P] * 4 + [_I64, _P, _P])
_SIGNATURES = {
    "csv_parse": (_P, [_P, _I64, _U8, _U8, _I32, _I32, _I32]),
    "csv_parse_sizes": (None, [_P, _P, _P, _P]),
    "csv_parse_fill": (None, [_P] * 5),
    "csv_parse_free": (None, [_P]),
    "csv_parse_nq": (_P, [_P, _I64, _U8]),
    "csv_parse_zc": (_P, [_P, _I64, _U8, _U8, _I32, _I32]),
    "csv_parse_n_offsets": (_I64, [_P]),
    "csv_parse_int64": _PARSE,
    "csv_parse_float64": _PARSE,
    "csv_parse_int64p": _PARSE,
    "csv_parse_float64p": _PARSE,
    "csv_transpose_columns": (None, [_P] * 4 + [_I64] * 3 + [_P, _P]),
    "csv_parse_date32": (_I64, [_P] * 4 + [_I64, _P]),
    "csv_parse_ts_micros": (_I64, [_P] * 4 + [_I64, _P]),
    "csv_parse_bool": (_I64, [_P, _P, _P, _P, _I64, _P, _P, _I32, _P, _P,
                              _I32, _P]),
    "csv_match_tokens": (None, [_P, _P, _P, _I64, _P, _P, _I32, _P]),
    "csv_gather_bytes": (None, [_P, _P, _P, _P, _I64, _P, _P]),
    "json_parse_flat": (_P, [_P, _I64]),
    "json_parse_sizes": (None, [_P] * 6),
    "json_parse_fill": (None, [_P] * 6),
    "json_parse_free": (None, [_P]),
    "csv_format_f64": (_I64, [_P, _P, _I64, _P, _P]),
    "csv_format_i64": (_I64, [_P, _P, _I64, _P, _P]),
    "csv_quote_cells": (_I64, [_P, _P, _P, _I64, _U8, _P, _P]),
    "csv_interleave": (_I64, [_I64, _P, _P, _I64, _U8, _P]),
}


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built library, or NotImplementedError where it cannot be
    built."""
    from ..kernels._build import BuildError, host_library
    try:
        lib = host_library("csv_host")
    except BuildError as exc:
        raise NotImplementedError(
            f"CSV and JSON need their host library, which failed to build: "
            f"{exc}") from None
    for name, (res, args) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args
    return lib


def _ptr(arr: np.ndarray) -> int:
    return arr.ctypes.data


class CsvBlock:
    """A tokenized CSV block.

    Copying form (id_scale=1): offsets int64[n_fields+1] into an unescaped
    pool; field k spans offsets[k]..offsets[k+1]. Zero-copy form
    (id_scale=2): the pool is the source bytes and offsets hold (start,
    end) pairs; field k spans offsets[2k]..offsets[2k+1]. The bulk parsers
    work on either by multiplying field ids by id_scale.
    """

    __slots__ = ("offsets", "pool", "quoted", "row_counts", "id_scale")

    def __init__(self, offsets, pool, quoted, row_counts, id_scale=1):
        self.offsets = offsets
        self.pool = pool
        self.quoted = quoted
        self.row_counts = row_counts
        self.id_scale = id_scale

    def field_bytes(self, fid: int) -> bytes:
        o = fid * self.id_scale
        return bytes(self.pool[int(self.offsets[o]):
                               int(self.offsets[o + 1])])


def csv_parse(data, delimiter: str, quote_char, doublequote: bool,
              escape_char, needs_copy: Optional[bool] = None) -> CsvBlock:
    """Tokenize a CSV byte block (csv/parser.cc). A block with no quote or
    escape byte takes the zero-copy tokenizer; a quoted one the zero-copy
    quoted tokenizer unless a field needs rewriting, then the copying
    one. ``data`` may be bytes or a memoryview."""
    lib = library()
    src = np.frombuffer(data, np.uint8) if len(data) else \
        np.empty(0, np.uint8)
    sptr = _ptr(src) if len(src) else None
    if needs_copy is None:
        needs_copy = _block_needs_copy(data, quote_char, escape_char)

    def pairs_block(handle):
        try:
            n_offs = lib.csv_parse_n_offsets(handle)
            n_fields, n_rows, pool_bytes = (ctypes.c_int64()
                                            for _ in range(3))
            lib.csv_parse_sizes(handle, ctypes.byref(n_fields),
                                ctypes.byref(n_rows),
                                ctypes.byref(pool_bytes))
            offsets = np.empty(max(n_offs, 1), np.int64)
            quoted = np.zeros(max(n_fields.value, 1), np.uint8)
            row_counts = np.empty(max(n_rows.value, 1), np.int64)
            dummy = np.empty(1, np.uint8)
            lib.csv_parse_fill(handle, _ptr(offsets), _ptr(dummy),
                               _ptr(quoted), _ptr(row_counts))
            return CsvBlock(offsets[:n_offs], src, quoted[:n_fields.value],
                            row_counts[:n_rows.value], id_scale=2)
        finally:
            lib.csv_parse_free(handle)

    if not needs_copy:
        return pairs_block(lib.csv_parse_nq(sptr, len(src), ord(delimiter)))
    # quote bytes present: the zero-copy quoted tokenizer first (quotes
    # stripped by offset arithmetic); a null handle means a field needs
    # rewriting (a doubled quote, an escape), and the copying one runs
    if quote_char and not isinstance(escape_char, str):
        handle = lib.csv_parse_zc(sptr, len(src), ord(delimiter),
                                  ord(quote_char), 1 if doublequote else 0,
                                  -1)
        if handle:
            return pairs_block(handle)
    handle = lib.csv_parse(
        sptr, len(src), ord(delimiter), ord(quote_char) if quote_char else 0,
        1 if quote_char else 0, 1 if doublequote else 0,
        ord(escape_char) if isinstance(escape_char, str) else -1)
    try:
        n_fields, n_rows, pool_bytes = (ctypes.c_int64() for _ in range(3))
        lib.csv_parse_sizes(handle, ctypes.byref(n_fields),
                            ctypes.byref(n_rows), ctypes.byref(pool_bytes))
        offsets = np.empty(n_fields.value + 1, np.int64)
        pool = np.empty(max(pool_bytes.value, 1), np.uint8)
        quoted = np.empty(max(n_fields.value, 1), np.uint8)
        row_counts = np.empty(max(n_rows.value, 1), np.int64)
        lib.csv_parse_fill(handle, _ptr(offsets), _ptr(pool), _ptr(quoted),
                           _ptr(row_counts))
        return CsvBlock(offsets, pool[:pool_bytes.value],
                        quoted[:n_fields.value], row_counts[:n_rows.value])
    finally:
        lib.csv_parse_free(handle)


def _block_needs_copy(data, quote_char, escape_char) -> bool:
    if isinstance(data, memoryview):
        arr = np.frombuffer(data, np.uint8)
        if quote_char is not None and bool((arr == ord(quote_char)).any()):
            return True
        return isinstance(escape_char, str) and bool(
            (arr == ord(escape_char)).any())
    return (quote_char is not None and
            data.find(quote_char.encode()) >= 0) or \
        (isinstance(escape_char, str) and
         data.find(escape_char.encode()) >= 0)


def csv_parse_parallel(data: bytes, delimiter: str, quote_char,
                       doublequote: bool, escape_char,
                       max_workers: int = 8) -> CsvBlock:
    """Tokenize in chunks split at newlines, on threads, and merge (valid
    where no value holds a newline: csv/chunker.cc assumes the same).
    Below ``ARROW_TPU_CSV_PARALLEL_MIN`` bytes (64 MB) one chunk."""
    n = len(data)
    try:
        min_bytes = int(os.environ.get("ARROW_TPU_CSV_PARALLEL_MIN",
                                       str(1 << 26)))
    except ValueError:
        min_bytes = 1 << 26
    ncpu = os.cpu_count() or 1
    nchunks = min(max_workers, ncpu, max(1, n >> 20))
    if n < min_bytes or nchunks <= 1:
        return csv_parse(data, delimiter, quote_char, doublequote,
                         escape_char)
    bounds = [0]
    for k in range(1, nchunks):
        target = n * k // nchunks
        cut = data.find(b"\n", max(target, bounds[-1]))
        bounds.append(n if cut < 0 else cut + 1)
    bounds.append(n)
    spans = [(bounds[k], bounds[k + 1]) for k in range(nchunks)
             if bounds[k + 1] > bounds[k]]
    if len(spans) <= 1:
        return csv_parse(data, delimiter, quote_char, doublequote,
                         escape_char)
    needs_copy = _block_needs_copy(data, quote_char, escape_char)
    mv = memoryview(data)
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=len(spans)) as ex:
        blocks = list(ex.map(
            lambda s: csv_parse(mv[s[0]:s[1]], delimiter, quote_char,
                                doublequote, escape_char,
                                needs_copy=needs_copy), spans))
    quoted = np.concatenate([b.quoted for b in blocks])
    row_counts = np.concatenate([b.row_counts for b in blocks])
    if all(b.id_scale == 2 for b in blocks):
        # every chunk a zero-copy view of `data`: its pairs rebased by
        # the chunk's start, the merged pool the source
        offsets = np.concatenate(
            [b.offsets + s[0] for s, b in zip(spans, blocks)])
        return CsvBlock(offsets, np.frombuffer(data, np.uint8), quoted,
                        row_counts, id_scale=2)
    # mixed forms: every chunk as (start, end) pairs over one pool
    pair_offs, pools, bias = [], [], 0
    for b in blocks:
        if b.id_scale == 1:
            po = np.empty(2 * (len(b.offsets) - 1), np.int64)
            po[0::2] = b.offsets[:-1]
            po[1::2] = b.offsets[1:]
        else:
            po = b.offsets.astype(np.int64, copy=True)
        pair_offs.append(po + bias)
        pools.append(b.pool)
        bias += len(b.pool)
    return CsvBlock(np.concatenate(pair_offs), np.concatenate(pools), quoted,
                    row_counts, id_scale=2)


def _ids_and_skip(block, ids, skip):
    ids = np.ascontiguousarray(ids, np.int64)
    if block.id_scale != 1:
        ids = ids * block.id_scale
    if skip is None:
        return ids, None, None
    skip = np.ascontiguousarray(skip, np.uint8)
    return ids, skip, _ptr(skip)


def _parse(strict_name, permissive_name, dtype, block, ids, skip, strict):
    n = len(ids)
    ids, skip, sptr = _ids_and_skip(block, ids, skip)
    out = np.empty(n, dtype)
    ok = np.empty(n, np.uint8)
    lib = library()
    fn = getattr(lib, strict_name if strict else permissive_name)
    failures = fn(_ptr(block.pool), _ptr(block.offsets), _ptr(ids), sptr, n,
                  _ptr(out), _ptr(ok))
    if not strict:
        return out, ok, failures
    return None if failures else (out, ok)


def csv_parse_int64(block: CsvBlock, ids: np.ndarray,
                    skip: Optional[np.ndarray], strict: bool = True):
    """Parse fields ``ids`` as int64 (``skip[i] != 0``: a null, 0): (values,
    ok bytes), or None where a field fails. ``strict=False`` gives (values,
    ok, failure count) whatever fails."""
    return _parse("csv_parse_int64", "csv_parse_int64p", np.int64, block,
                  ids, skip, strict)


def csv_parse_float64(block: CsvBlock, ids: np.ndarray,
                      skip: Optional[np.ndarray], strict: bool = True):
    """``csv_parse_int64`` for float64 (std::from_chars: bit for bit)."""
    return _parse("csv_parse_float64", "csv_parse_float64p", np.float64,
                  block, ids, skip, strict)


def csv_transpose_columns(block: CsvBlock, row_starts: np.ndarray,
                          row_counts: np.ndarray, ncols: int
                          ) -> Optional[list]:
    """One sequential pass over the field table into one CsvBlock a column
    (pair offsets and quoted flags, id_scale=2, identity ids), so the
    parsers scan contiguously. None for no column."""
    if ncols == 0:
        return None
    n = len(row_starts)
    row_starts = np.ascontiguousarray(row_starts, np.int64)
    row_counts = np.ascontiguousarray(row_counts, np.int64)
    out_off = np.empty((ncols, 2 * n), np.int64)
    out_q = np.empty((ncols, n), np.uint8)
    library().csv_transpose_columns(
        _ptr(block.offsets), _ptr(block.quoted), _ptr(row_starts),
        _ptr(row_counts), n, ncols, block.id_scale, _ptr(out_off),
        _ptr(out_q))
    return [CsvBlock(out_off[j], block.pool, out_q[j], row_counts,
                     id_scale=2) for j in range(ncols)]


def _parse_temporal(name, dtype, block, ids, skip):
    n = len(ids)
    ids, skip, sptr = _ids_and_skip(block, ids, skip)
    out = np.empty(n, dtype)
    failures = getattr(library(), name)(_ptr(block.pool),
                                        _ptr(block.offsets), _ptr(ids),
                                        sptr, n, _ptr(out))
    return None if failures else out


def csv_parse_date32(block: CsvBlock, ids: np.ndarray,
                     skip: Optional[np.ndarray]) -> Optional[np.ndarray]:
    """ISO dates of fields ``ids`` as date32 days, or None where a field
    fails (the caller parses in Python)."""
    return _parse_temporal("csv_parse_date32", np.int32, block, ids, skip)


def csv_parse_ts_micros(block: CsvBlock, ids: np.ndarray,
                        skip: Optional[np.ndarray]) -> Optional[np.ndarray]:
    """ISO timestamps of fields ``ids`` as int64 microseconds since the
    epoch, or None where a field fails. An offset is checked and then
    dropped (wall-clock time, as the Python parse gives)."""
    return _parse_temporal("csv_parse_ts_micros", np.int64, block, ids,
                           skip)


def _token_buffers(tokens):
    toks = [t.encode() for t in tokens]
    tok_bytes = np.frombuffer(b"".join(toks) or b"\0", np.uint8)
    tok_offs = np.zeros(len(toks) + 1, np.int32)
    if toks:
        tok_offs[1:] = np.cumsum([len(t) for t in toks])
    return tok_bytes, tok_offs, len(toks)


def csv_match_tokens(block: CsvBlock, ids: np.ndarray,
                     tokens) -> np.ndarray:
    """Bytes: 1 where field ``ids[i]`` is one of ``tokens`` (str)."""
    tok_bytes, tok_offs, m = _token_buffers(tokens)
    ids, _, _ = _ids_and_skip(block, ids, None)
    out = np.empty(len(ids), np.uint8)
    library().csv_match_tokens(_ptr(block.pool), _ptr(block.offsets),
                               _ptr(ids), len(ids), _ptr(tok_bytes),
                               _ptr(tok_offs), m, _ptr(out))
    return out


def csv_parse_bool(block: CsvBlock, ids: np.ndarray,
                   skip: Optional[np.ndarray], true_tokens,
                   false_tokens) -> Optional[np.ndarray]:
    """Bytes 1/0 where every field not skipped is a true or false token,
    else None."""
    tb, to, nt = _token_buffers(true_tokens)
    fb, fo, nf = _token_buffers(false_tokens)
    ids, skip, sptr = _ids_and_skip(block, ids, skip)
    out = np.empty(len(ids), np.uint8)
    failures = library().csv_parse_bool(
        _ptr(block.pool), _ptr(block.offsets), _ptr(ids), sptr, len(ids),
        _ptr(tb), _ptr(to), nt, _ptr(fb), _ptr(fo), nf, _ptr(out))
    return None if failures else out


def csv_gather_bytes(block, ids: np.ndarray,
                     skip: Optional[np.ndarray] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """(offsets int64[n+1], bytes) of fields ``ids`` end to end;
    ``skip[i] != 0`` gathers an empty value."""
    ids, skip, sptr = _ids_and_skip(block, ids, skip)
    lens = block.offsets[ids + 1] - block.offsets[ids]
    if skip is not None:
        lens = np.where(skip != 0, 0, lens)
    out_offsets = np.zeros(len(ids) + 1, np.int64)
    np.cumsum(lens, out=out_offsets[1:])
    total = int(out_offsets[-1])
    out = np.empty(max(total, 1), np.uint8)
    library().csv_gather_bytes(_ptr(block.pool), _ptr(block.offsets),
                               _ptr(ids), sptr, len(ids), _ptr(out_offsets),
                               _ptr(out))
    return out_offsets, out[:total]


class JsonBlock:
    """A tokenized flat ndjson block: the values' pool and a kind byte a
    field (0 null, 1 false, 2 true, 3 number, 4 string, 5 nested JSON
    text); field (row, col) is ``row * ncols + col``."""

    id_scale = 1  # the bulk parsers scale field ids by this

    __slots__ = ("offsets", "pool", "kinds", "keys", "n_rows", "ncols")

    def __init__(self, offsets, pool, kinds, keys, n_rows, ncols):
        self.offsets = offsets
        self.pool = pool
        self.kinds = kinds
        self.keys = keys
        self.n_rows = n_rows
        self.ncols = ncols


def json_parse_flat(data: bytes) -> Optional[JsonBlock]:
    """Tokenize flat ndjson whose records share their keys in order; None
    where the input needs the general parser."""
    lib = library()
    src = np.frombuffer(data, np.uint8) if data else np.empty(0, np.uint8)
    handle = lib.json_parse_flat(_ptr(src) if len(src) else None, len(src))
    try:
        ok, ncols = ctypes.c_int32(), ctypes.c_int32()
        n_rows, pool_bytes, key_bytes = (ctypes.c_int64() for _ in range(3))
        lib.json_parse_sizes(handle, ctypes.byref(ok), ctypes.byref(n_rows),
                             ctypes.byref(ncols), ctypes.byref(pool_bytes),
                             ctypes.byref(key_bytes))
        if not ok.value:
            return None
        n_fields = n_rows.value * ncols.value
        offsets = np.empty(n_fields + 1, np.int64)
        pool = np.empty(max(pool_bytes.value, 1), np.uint8)
        kinds = np.empty(max(n_fields, 1), np.uint8)
        kb = np.empty(max(key_bytes.value, 1), np.uint8)
        ko = np.empty(ncols.value + 1, np.int32)
        lib.json_parse_fill(handle, _ptr(offsets), _ptr(pool), _ptr(kinds),
                            _ptr(kb), _ptr(ko))
        raw = kb.tobytes()
        keys = [raw[ko[i]:ko[i + 1]].decode("utf8")
                for i in range(ncols.value)]
        return JsonBlock(offsets, pool[:pool_bytes.value], kinds[:n_fields],
                         keys, n_rows.value, ncols.value)
    finally:
        lib.json_parse_free(handle)


def _valid_ptr(valid):
    if valid is None:
        return None, None
    valid = np.ascontiguousarray(valid, np.uint8)
    return valid, _ptr(valid)


def _cells(offs, pool, total, n, raw):
    if raw:
        return offs, pool[:total]
    text = pool[:total].tobytes().decode("ascii")
    ol = offs.tolist()
    return [text[ol[i]:ol[i + 1]] for i in range(n)]


def csv_format_f64(vals: np.ndarray, valid: Optional[np.ndarray],
                   raw: bool = False):
    """The cells of a float64 column as Python's repr writes them (an
    invalid row empty): a list of str, or (offsets int64[n+1], bytes)
    where ``raw``."""
    vals = np.ascontiguousarray(vals, np.float64)
    n = len(vals)
    pool = np.empty(max(n * 32, 1), np.uint8)
    offs = np.empty(n + 1, np.int64)
    valid, vptr = _valid_ptr(valid)
    total = library().csv_format_f64(_ptr(vals), vptr, n, _ptr(pool),
                                     _ptr(offs))
    return _cells(offs, pool, total, n, raw)


def csv_format_i64(vals: np.ndarray, valid: Optional[np.ndarray],
                   raw: bool = False):
    """``csv_format_f64`` for int64 (``str``'s text)."""
    vals = np.ascontiguousarray(vals, np.int64)
    n = len(vals)
    pool = np.empty(max(n * 24, 1), np.uint8)
    offs = np.empty(n + 1, np.int64)
    valid, vptr = _valid_ptr(valid)
    total = library().csv_format_i64(_ptr(vals), vptr, n, _ptr(pool),
                                     _ptr(offs))
    return _cells(offs, pool, total, n, raw)


def csv_quote_cells(pool: np.ndarray, offsets_i32: np.ndarray,
                    valid: Optional[np.ndarray], delim: str):
    """QUOTE_MINIMAL over a string column's (bytes, int32 offsets): a cell
    holding the delimiter, a quote or a line break quoted, its quotes
    doubled; an invalid row empty. (offsets int64[n+1], bytes)."""
    n = len(offsets_i32) - 1
    pool = np.ascontiguousarray(pool, np.uint8)
    offsets_i32 = np.ascontiguousarray(offsets_i32, np.int32)
    valid, vptr = _valid_ptr(valid)
    out_pool = np.empty(2 * len(pool) + 2 * n + 2, np.uint8)
    out_offs = np.empty(n + 1, np.int64)
    total = library().csv_quote_cells(_ptr(pool), _ptr(offsets_i32), vptr,
                                      n, ord(delim), _ptr(out_pool),
                                      _ptr(out_offs))
    return out_offs, out_pool[:total]


def csv_interleave(cols, n: int, delim: str) -> np.ndarray:
    """Rows of per-column (offsets int64[n+1], bytes) cells: cells joined
    by ``delim``, each row ended by CRLF; the body as uint8."""
    ncols = len(cols)
    offs_arr = (ctypes.c_void_p * ncols)()
    pool_arr = (ctypes.c_void_p * ncols)()
    total = n * (ncols + 1)          # delimiters and CRLF
    keep = []
    for i, (offs, pool) in enumerate(cols):
        offs = np.ascontiguousarray(offs, np.int64)
        pool = np.ascontiguousarray(pool, np.uint8)
        if not pool.size:
            pool = np.zeros(1, np.uint8)
        keep.append((offs, pool))
        offs_arr[i] = _ptr(offs)
        pool_arr[i] = _ptr(pool)
        total += int(offs[-1])
    out = np.empty(max(total, 1), np.uint8)
    written = library().csv_interleave(
        ncols, ctypes.cast(offs_arr, ctypes.c_void_p),
        ctypes.cast(pool_arr, ctypes.c_void_p), n, ord(delim), _ptr(out))
    return out[:written]
