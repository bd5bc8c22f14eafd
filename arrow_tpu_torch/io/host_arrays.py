"""Host Array work shared by the text and ORC readers and writers: the
dictionary encoding, decoding and widening casts that the reference runs
through its eager compute API, done here in numpy on host Arrays (a reader
or writer names no device), with the reference's results.
"""

from __future__ import annotations

import numpy as np

from .. import types as T
from ..api import nulls
from ..array.array import Array, array as make_array
from ..array.data import ArrayData
from ..buffer import Buffer


def _string_parts(arr: Array):
    d = arr.data
    offs = d.offsets().astype(np.int64)
    return d.data_bytes(), offs


def dictionary_encode(arr: Array) -> Array:
    """A string Array as dictionary<int32, string>: its distinct non-null
    values in order of first appearance, a null row null (the reference's
    ``dictionary_encode``)."""
    from .parquet.host import dict_encode_binary, gather_var_bytes
    n = len(arr)
    pool, offs = _string_parts(arr)
    valid = arr.is_valid_mask() if arr.null_count else None
    live = np.flatnonzero(valid) if valid is not None else None
    if live is not None:
        offs, pool = gather_var_bytes(pool, offs, live)
    codes, uoffs, ubytes = dict_encode_binary(pool, offs, None)
    full = codes
    if live is not None:
        full = np.zeros(n, np.int32)
        full[live] = codes
    dictionary = ArrayData(arr.type, len(uoffs) - 1,
                           [None, Buffer(uoffs), Buffer(ubytes)],
                           null_count=0)
    return Array(ArrayData(T.dictionary(T.int32(), arr.type), n,
                           [_validity(valid), Buffer(full)],
                           null_count=arr.null_count, dictionary=dictionary))


def _validity(valid):
    from ..utils import bits as bitutil
    return None if valid is None else Buffer(bitutil.pack_bits(valid))


def decoded(arr: Array) -> Array:
    """A dictionary Array as an Array of its value type (a null row
    null)."""
    d = arr.data
    codes = d.values().astype(np.int64)
    valid = arr.is_valid_mask() if arr.null_count else None
    if valid is not None:
        codes = np.where(valid, codes, 0)
    vt = arr.type.value_type
    values = Array(d.dictionary)
    if len(values) == 0:
        return nulls(len(arr), vt)
    if vt.id in (T.TypeId.STRING, T.TypeId.BINARY, T.TypeId.LARGE_STRING,
                 T.TypeId.LARGE_BINARY):
        from .parquet.host import gather_var_bytes
        pool, offs = _string_parts(values)
        new_offs, data = gather_var_bytes(pool, offs, codes)
        if valid is not None:
            lens = np.diff(new_offs)
            lens[~valid] = 0
            keep = np.repeat(valid, np.diff(new_offs))
            data = data[keep]
            new_offs = np.zeros(len(codes) + 1, np.int64)
            np.cumsum(lens, out=new_offs[1:])
        wide = vt.id in (T.TypeId.LARGE_STRING, T.TypeId.LARGE_BINARY)
        return Array(ArrayData(vt, len(arr), [
            _validity(valid),
            Buffer(new_offs if wide else new_offs.astype(np.int32)),
            Buffer(data)]))
    if vt.is_numeric or vt.is_temporal:
        vals = values.data.values()[codes]
        if valid is not None:
            vals = np.where(valid, vals, np.zeros(1, vals.dtype))
        return Array(ArrayData(vt, len(arr), [_validity(valid),
                                              Buffer(vals)]))
    pyvals = values.to_pylist()
    return make_array([pyvals[c] if valid is None or valid[i] else None
                       for i, c in enumerate(codes.tolist())], vt)


def widened(arr: Array, t) -> Array:
    """``arr`` cast to ``t`` where the readers unify block types: a null
    Array to any type and int64 to float64 in numpy, any other pair by the
    eager ``cast`` on the CPU (the reference's cast)."""
    if arr.type.id == T.TypeId.NA:
        return nulls(len(arr), t)
    if arr.type.id == T.TypeId.INT64 and t.id == T.TypeId.DOUBLE:
        vals = arr.data.values().astype(np.float64)
        valid = arr.is_valid_mask() if arr.null_count else None
        if valid is not None:
            vals[~valid] = 0.0
        return Array(ArrayData(t, len(arr), [_validity(valid),
                                             Buffer(vals)]))
    return arr.cast(t, device="cpu")
