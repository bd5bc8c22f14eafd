"""Array validation (counterpart of ``arrow_tpu/array/validate.py``;
reference: cpp/src/arrow/array/validate.h:32-53): ``validate`` checks an
ArrayData's structure (buffer counts, bitmap and offsets sizes, null
counts), ``validate_full`` its data too (offsets monotonic and in bounds,
dictionary indices in range, UTF-8, run ends increasing). Host only.

One departure, a reference defect the port does not copy: a string or
binary view counts its variadic data buffers (two buffers and any number
of them) and a list view its sizes (three buffers); the reference expects
two of each and refuses its own arrays of these types."""

from __future__ import annotations

import numpy as np

from ..types import TypeId
from .data import ArrayData


class ValidationError(ValueError):
    pass


def _fail(msg):
    raise ValidationError(msg)


def validate(data: ArrayData, full: bool = False):
    """Structural validation; ``full=True`` adds data-level checks."""
    t = data.type
    tid = t.id
    n = data.length
    if n < 0:
        _fail("negative length")
    if data.offset < 0:
        _fail("negative offset")

    if tid in (TypeId.STRING_VIEW, TypeId.BINARY_VIEW):
        if len(data.buffers) < 2:
            _fail(f"{t!r}: expected at least 2 buffers, got "
                  f"{len(data.buffers)}")
        if data.buffers[1] is not None and \
                data.buffers[1].size < 16 * (data.offset + n):
            _fail("views buffer too small")
    expected_buffers = _expected_buffer_count(tid, t)
    if expected_buffers is not None and len(data.buffers) not in \
            (expected_buffers, 0 if tid == TypeId.NA else expected_buffers):
        if not (tid == TypeId.NA and len(data.buffers) == 0):
            _fail(f"{t!r}: expected {expected_buffers} buffers, got "
                  f"{len(data.buffers)}")

    if data.buffers and data.buffers[0] is not None and \
            tid not in (TypeId.SPARSE_UNION, TypeId.DENSE_UNION,
                        TypeId.RUN_END_ENCODED, TypeId.NA):
        need = (data.offset + n + 7) // 8
        if data.buffers[0].size < need:
            _fail("validity bitmap too small")

    if data.null_count > n:
        _fail("null_count > length")
    if data.null_count > 0 and (not data.buffers or
                                data.buffers[0] is None) and \
            tid != TypeId.NA:
        _fail("null_count > 0 but no validity bitmap")

    if tid in (TypeId.STRING, TypeId.BINARY, TypeId.LARGE_STRING,
               TypeId.LARGE_BINARY, TypeId.LIST, TypeId.MAP,
               TypeId.LARGE_LIST):
        if data.buffers[1] is not None:
            offs = data.offsets()
            if len(offs) != n + 1:
                _fail("offsets length != length+1")
            if full and n > 0:
                if (np.diff(offs.astype(np.int64)) < 0).any():
                    _fail("offsets not monotonically non-decreasing")
                limit = (data.data_bytes().size
                         if tid in (TypeId.STRING, TypeId.BINARY,
                                    TypeId.LARGE_STRING,
                                    TypeId.LARGE_BINARY)
                         else data.children[0].length)
                if int(offs[-1]) > limit:
                    _fail("offsets exceed values length")
                if int(offs[0]) < 0:
                    _fail("negative offset value")
        elif n > 0:
            _fail("missing offsets buffer")

    if full and tid in (TypeId.STRING, TypeId.LARGE_STRING):
        try:
            data.data_bytes().tobytes().decode("utf-8")
        except UnicodeDecodeError:
            _fail("invalid UTF-8 data")

    if tid == TypeId.DICTIONARY:
        if data.dictionary is None:
            _fail("dictionary array missing dictionary")
        if full:
            idx = data.values()
            mask = data.validity_mask()
            live = idx if mask is None else idx[mask[:len(idx)]]
            if len(live) and (live.min() < 0 or
                              live.max() >= data.dictionary.length):
                _fail("dictionary indices out of range")
        validate(data.dictionary, full)

    if tid == TypeId.RUN_END_ENCODED and full:
        ends = data.children[0].values()
        if len(ends):
            if (np.diff(ends.astype(np.int64)) <= 0).any():
                _fail("run ends not strictly increasing")
            if int(ends[0]) <= 0:
                _fail("first run end must be positive")

    for child in data.children:
        validate(child, full)


def _expected_buffer_count(tid, t):
    if tid == TypeId.NA:
        return 0
    if tid in (TypeId.STRING, TypeId.BINARY, TypeId.LARGE_STRING,
               TypeId.LARGE_BINARY):
        return 3
    if tid in (TypeId.STRING_VIEW, TypeId.BINARY_VIEW):
        return None  # two and the variadic data buffers
    if tid in (TypeId.LIST_VIEW, TypeId.LARGE_LIST_VIEW):
        return 3
    if tid in (TypeId.LIST, TypeId.MAP, TypeId.LARGE_LIST,
               TypeId.DENSE_UNION):
        return 2
    if tid in (TypeId.STRUCT, TypeId.FIXED_SIZE_LIST, TypeId.SPARSE_UNION):
        return 1
    if tid == TypeId.RUN_END_ENCODED:
        return 0
    return 2  # validity + data


def validate_full(data: ArrayData):
    validate(data, full=True)
