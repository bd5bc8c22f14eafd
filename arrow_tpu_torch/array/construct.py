"""Arrays from Python sequences and numpy arrays (counterpart of
``arrow_tpu/array/construct.py``): ``infer_type``,
``array_data_from_sequence`` and ``_from_numpy``. Host construction is
ingest: a numpy array converts without a loop over its rows, a Python
sequence with one pass."""

from __future__ import annotations

import datetime as _dt
import decimal as _decimal
from itertools import chain
from typing import Any, Optional, Sequence

import numpy as np

from .. import types as T
from ..buffer import Buffer
from ..types import DataType, TypeId
from ..utils import bits as bitutil
from .data import ArrayData

_VAR_BINARY = (TypeId.STRING, TypeId.BINARY, TypeId.LARGE_STRING,
               TypeId.LARGE_BINARY)
_FIXED_BYTES = (TypeId.FIXED_SIZE_BINARY, TypeId.DECIMAL128,
                TypeId.DECIMAL256, TypeId.DECIMAL32, TypeId.DECIMAL64)
_UNIT_DIV = {"s": 1_000_000, "ms": 1000, "us": 1}


def infer_type(values: Sequence[Any]) -> DataType:
    """The type of Python values, as the reference infers it: bool, int64,
    float64 (ints and floats mixed), string, binary, decimal128(38, s),
    timestamp[us], date32, duration[us], struct of dicts, list of lists;
    all None is null."""
    has_float = has_int = has_bool = False
    sample = None
    for v in values:
        if v is None:
            continue
        if isinstance(v, (bool, np.bool_)):
            has_bool = True
        elif isinstance(v, (int, np.integer)):
            has_int = True
        elif isinstance(v, (float, np.floating)):
            has_float = True
        else:
            sample = v
            break
    if sample is None:
        if has_bool and not (has_int or has_float):
            return T.bool_()
        if has_float:
            return T.float64()
        if has_int:
            return T.int64()
        return T.null()
    if isinstance(sample, str):
        return T.string()
    if isinstance(sample, (bytes, bytearray)):
        return T.binary()
    if isinstance(sample, _decimal.Decimal):
        return T.decimal128(38, max(0, -sample.as_tuple().exponent))
    if isinstance(sample, _dt.datetime):
        return T.timestamp("us")
    if isinstance(sample, _dt.date):
        return T.date32()
    if isinstance(sample, _dt.timedelta):
        return T.duration("us")
    if isinstance(sample, dict):
        keys = {}
        for v in values:
            if v is not None:
                for k, item in v.items():
                    keys.setdefault(k, []).append(item)
        return T.struct([(k, infer_type(vs)) for k, vs in keys.items()])
    if isinstance(sample, (list, tuple, np.ndarray)):
        flat = [x for v in values if v is not None for x in v]
        return T.list_(infer_type(flat))
    raise TypeError(f"cannot infer arrow type for {type(sample)}")


def _make_validity(mask: np.ndarray) -> Optional[Buffer]:
    """mask (True = valid) -> a packed bitmap, or None when all valid."""
    if mask.all():
        return None
    return Buffer(bitutil.pack_bits(mask))


def _scaled(us: int, unit: str) -> int:
    return us * 1000 if unit == "ns" else us // _UNIT_DIV[unit]


def _temporal_to_int(v, type: DataType) -> int:
    tid = type.id
    if isinstance(v, (int, np.integer)):
        return int(v)
    if tid == TypeId.DATE32 and isinstance(v, _dt.date):
        return (v - _dt.date(1970, 1, 1)).days
    if tid == TypeId.DATE64 and isinstance(v, _dt.date):
        return (v - _dt.date(1970, 1, 1)).days * 86400000
    if tid == TypeId.TIMESTAMP and isinstance(v, _dt.datetime):
        epoch = _dt.datetime(1970, 1, 1, tzinfo=v.tzinfo)
        return _scaled((v - epoch) // _dt.timedelta(microseconds=1),
                       type.unit)
    if tid == TypeId.DURATION and isinstance(v, _dt.timedelta):
        return _scaled(v // _dt.timedelta(microseconds=1), type.unit)
    if tid in (TypeId.TIME32, TypeId.TIME64) and isinstance(v, _dt.time):
        us = ((v.hour * 3600 + v.minute * 60 + v.second) * 1_000_000
              + v.microsecond)
        return _scaled(us, type.unit)
    raise TypeError(f"cannot convert {v!r} to {type!r}")


def _decimal_to_bytes(v, type) -> bytes:
    if isinstance(v, _decimal.Decimal):
        unscaled = int(v.scaleb(type.scale).to_integral_value())
    else:
        unscaled = int(v)
    return unscaled.to_bytes(type.byte_width, "little", signed=True)


def _var_binary(values, n, mask, type) -> ArrayData:
    tid = type.id
    off_dt = np.int32 if tid in (TypeId.STRING, TypeId.BINARY) else np.int64
    if tid in (TypeId.STRING, TypeId.LARGE_STRING) and n:
        # one join and one encode; for ASCII the byte offsets are the
        # character offsets
        try:
            strs = ["" if v is None else v for v in values]
            joined = "".join(strs)
        except TypeError:
            strs = None
        if strs is not None:
            data = joined.encode()
            if len(data) == len(joined):
                offsets = np.zeros(n + 1, dtype=off_dt)
                np.cumsum(np.fromiter(map(len, strs), np.int64, n),
                          out=offsets[1:])
                return ArrayData(type, n, [_make_validity(mask),
                                           Buffer(offsets), Buffer(data)])
    chunks = [b"" if v is None else
              (v.encode() if isinstance(v, str) else bytes(v))
              for v in values]
    offsets = np.zeros(n + 1, dtype=off_dt)
    np.cumsum(np.fromiter(map(len, chunks), np.int64, n), out=offsets[1:])
    return ArrayData(type, n, [_make_validity(mask), Buffer(offsets),
                               Buffer(b"".join(chunks))])


def array_data_from_sequence(values: Sequence[Any],
                             type: Optional[DataType] = None) -> ArrayData:
    if isinstance(values, np.ndarray) and values.dtype != object:
        return _from_numpy(values, type)
    values = list(values)
    if type is None:
        type = infer_type(values)
    n = len(values)
    mask = np.fromiter((v is not None for v in values), np.bool_, n)
    tid = type.id

    if tid == TypeId.NA:
        return ArrayData(type, n, [], null_count=n)
    if tid == TypeId.BOOL:
        data = np.fromiter((bool(v) if v is not None else False
                            for v in values), np.bool_, n)
        return ArrayData(type, n, [_make_validity(mask),
                                   Buffer(bitutil.pack_bits(data))])
    if type.is_numeric:
        dt = type.to_numpy_dtype()
        data = np.array([v if v is not None else 0 for v in values], dtype=dt)
        return ArrayData(type, n, [_make_validity(mask), Buffer(data)])
    if tid == TypeId.INTERVAL_DAY_TIME:
        # (days, milliseconds) int32 pairs
        data = np.zeros((n, 2), dtype=np.int32)
        for i, v in enumerate(values):
            if v is not None:
                data[i] = (v.days, v.milliseconds) if hasattr(v, "days") \
                    else (v[0], v[1])
        return ArrayData(type, n, [_make_validity(mask),
                                   Buffer(data.reshape(-1))])
    if tid == TypeId.INTERVAL_MONTH_DAY_NANO:
        # (months int32, days int32, nanoseconds int64) records
        rec = np.zeros(n, dtype=[("m", "<i4"), ("d", "<i4"), ("ns", "<i8")])
        for i, v in enumerate(values):
            if v is not None:
                rec[i] = (v.months, v.days, v.nanoseconds) \
                    if hasattr(v, "months") else (v[0], v[1], v[2])
        return ArrayData(type, n, [_make_validity(mask),
                                   Buffer(rec.view(np.uint8))])
    if type.is_temporal or tid == TypeId.INTERVAL_MONTHS:
        data = np.array([_temporal_to_int(v, type) if v is not None else 0
                         for v in values], dtype=type.to_numpy_dtype())
        return ArrayData(type, n, [_make_validity(mask), Buffer(data)])
    if tid in _VAR_BINARY:
        return _var_binary(values, n, mask, type)
    if tid in _FIXED_BYTES:
        w = type.byte_width
        buf = bytearray(n * w)
        for i, v in enumerate(values):
            if v is None:
                continue
            if tid == TypeId.FIXED_SIZE_BINARY:
                b = bytes(v)
                if len(b) != w:
                    raise ValueError(f"expected {w} bytes, got {len(b)}")
            else:
                b = _decimal_to_bytes(v, type)
            buf[i * w:(i + 1) * w] = b
        return ArrayData(type, n, [_make_validity(mask), Buffer(bytes(buf))])
    if tid in (TypeId.LIST, TypeId.LARGE_LIST, TypeId.MAP):
        off_dt = np.int64 if tid == TypeId.LARGE_LIST else np.int32
        if tid == TypeId.MAP:
            values = [None if v is None else
                      [{"key": k, "value": it} for k, it in
                       (v.items() if isinstance(v, dict) else v)]
                      for v in values]
        offsets = np.zeros(n + 1, dtype=off_dt)
        np.cumsum(np.fromiter((0 if v is None else len(v) for v in values),
                              np.int64, n), out=offsets[1:])
        flat = list(chain.from_iterable(v for v in values if v is not None))
        child = array_data_from_sequence(flat, type.value_type)
        return ArrayData(type, n, [_make_validity(mask), Buffer(offsets)],
                         [child])
    if tid == TypeId.FIXED_SIZE_LIST:
        sz = type.list_size
        flat = []
        for v in values:
            if v is None:
                flat.extend([None] * sz)
            else:
                if len(v) != sz:
                    raise ValueError(f"expected lists of size {sz}")
                flat.extend(v)
        child = array_data_from_sequence(flat, type.value_type)
        return ArrayData(type, n, [_make_validity(mask)], [child])
    if tid == TypeId.STRUCT:
        children = [array_data_from_sequence(
            [None if v is None else v.get(f.name) for v in values], f.type)
            for f in type.fields]
        return ArrayData(type, n, [_make_validity(mask)], children)
    if tid == TypeId.DICTIONARY:
        memo: dict = {}
        uniques = []
        indices = np.zeros(n, dtype=type.index_type.to_numpy_dtype())
        for i, v in enumerate(values):
            if v is None:
                continue
            if v not in memo:
                memo[v] = len(uniques)
                uniques.append(v)
            indices[i] = memo[v]
        return ArrayData(type, n, [_make_validity(mask), Buffer(indices)],
                         dictionary=array_data_from_sequence(
                             uniques, type.value_type))
    if tid in (TypeId.STRING_VIEW, TypeId.BINARY_VIEW):
        return _binary_view(values, n, mask, type)
    if tid in (TypeId.LIST_VIEW, TypeId.LARGE_LIST_VIEW):
        off_dt = np.int64 if tid == TypeId.LARGE_LIST_VIEW else np.int32
        sizes = np.fromiter((0 if v is None else len(v) for v in values),
                            np.int64, n)
        offsets = np.zeros(n, dtype=np.int64)
        np.cumsum(sizes[:-1], out=offsets[1:])
        offsets[~mask] = 0
        flat = list(chain.from_iterable(v for v in values if v is not None))
        child = array_data_from_sequence(flat, type.value_type)
        return ArrayData(type, n, [_make_validity(mask),
                                   Buffer(offsets.astype(off_dt)),
                                   Buffer(sizes.astype(off_dt))], [child])
    # a union is built from its buffers (Array.from_buffers), as in the
    # reference
    raise NotImplementedError(f"construction for {type!r}")


VIEW_INLINE = 12  # a view's bytes held in the view itself, at most


def _binary_view(values, n, mask, type) -> ArrayData:
    """A sequence's values in the view layout (``binary_view_data``)."""
    chunks = [b"" if v is None else
              (v.encode() if isinstance(v, str) else bytes(v))
              for v in values]
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.fromiter(map(len, chunks), np.int64, n), out=offsets[1:])
    return binary_view_data(offsets, np.frombuffer(b"".join(chunks),
                                                   np.uint8), mask, type)


def binary_view_data(offsets, data, mask, type) -> ArrayData:
    """Values given by their ``offsets`` (n + 1 of them) into ``data``
    (uint8) in the view layout (format/Columnar.rst "Variable-size Binary
    View"): 16 bytes a row, the length (int32) then either the value
    inline (12 bytes at most) or its 4-byte prefix, the data buffer's
    index (0: the one buffer of the values longer than 12 bytes) and the
    value's offset there. A null row's view is zeros (``mask``: True =
    valid, or None)."""
    offs = np.asarray(offsets, dtype=np.int64)
    n = len(offs) - 1
    lens = offs[1:] - offs[:-1]
    if mask is not None:
        lens = np.where(mask, lens, 0)
    views = np.zeros((n, 16), dtype=np.uint8)
    views[:, 0:4] = lens.astype("<i4").view(np.uint8).reshape(n, 4)
    # the first 12 bytes of every value (a long one's prefix is its first
    # 4, the rest overwritten below)
    head = np.minimum(lens, VIEW_INLINE)
    rows = np.repeat(np.arange(n), head)
    within = np.arange(int(head.sum())) - np.repeat(np.cumsum(head) - head,
                                                    head)
    views[rows, 4 + within] = data[np.repeat(offs[:-1], head) + within]
    long = lens > VIEW_INLINE
    long_lens = lens[long]
    starts = np.zeros(len(long_lens), dtype=np.int64)
    np.cumsum(long_lens[:-1], out=starts[1:])
    views[long, 8:16] = 0
    views[long, 12:16] = starts.astype("<i4").view(np.uint8).reshape(-1, 4)
    at = np.repeat(offs[:-1][long] - starts, long_lens) + \
        np.arange(int(long_lens.sum()))
    return ArrayData(type, n, [None if mask is None else _make_validity(mask),
                               Buffer(views), Buffer(data[at])])


def _from_numpy(arr: np.ndarray, type: Optional[DataType]) -> ArrayData:
    if arr.dtype.kind in "US":
        if type is None:
            type = T.string() if arr.dtype.kind == "U" else T.binary()
        return array_data_from_sequence(arr.tolist(), type)
    if type is None:
        type = T.from_numpy_dtype(arr.dtype)
    if arr.dtype.kind in "Mm":
        arr = arr.view(np.int64)
    if type.id == TypeId.BOOL:
        return ArrayData(type, len(arr),
                         [None, Buffer(bitutil.pack_bits(arr.astype(np.bool_)))],
                         null_count=0)
    target = type.to_numpy_dtype()
    if arr.dtype != target:
        arr = arr.astype(target)
    return ArrayData(type, len(arr), [None, Buffer(arr)], null_count=0)
