"""The dataframe interchange protocol, version 1 (counterpart of
``arrow_tpu/interchange.py``; reference: python/pyarrow/interchange/):
protocol objects over a Table's or RecordBatch's own buffers (no copy),
and ``from_dataframe`` of any producer (pandas, polars, pyarrow, the port
itself) into a host Table.

The consumer builds each column from the producer's buffers with numpy,
where the reference goes through Python values; the Arrays it gives are
the reference's (types, values and nulls): strings as ``string``,
categoricals as ``dictionary<int32, string|int64>`` in first-appearance
order, a null's slot zero or empty.
"""

from __future__ import annotations

import ctypes
import enum
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import types as T
from .array.array import Array, array as make_array
from .array.construct import array_data_from_sequence
from .array.data import ArrayData
from .buffer import Buffer
from .types import DataType, Field, Schema, TypeId
from .utils import bits as bitutil


class DtypeKind(enum.IntEnum):
    INT = 0
    UINT = 1
    FLOAT = 2
    BOOL = 20
    STRING = 21
    DATETIME = 22
    CATEGORICAL = 23


class ColumnNullType(enum.IntEnum):
    NON_NULLABLE = 0
    USE_NAN = 1
    USE_SENTINEL = 2
    USE_BITMASK = 3
    USE_BYTEMASK = 4


class DlpackDeviceType(enum.IntEnum):
    CPU = 1
    CUDA = 2


_KIND_FOR: Dict[int, Tuple[DtypeKind, int]] = {
    TypeId.INT8: (DtypeKind.INT, 8), TypeId.INT16: (DtypeKind.INT, 16),
    TypeId.INT32: (DtypeKind.INT, 32), TypeId.INT64: (DtypeKind.INT, 64),
    TypeId.UINT8: (DtypeKind.UINT, 8), TypeId.UINT16: (DtypeKind.UINT, 16),
    TypeId.UINT32: (DtypeKind.UINT, 32),
    TypeId.UINT64: (DtypeKind.UINT, 64),
    TypeId.HALF_FLOAT: (DtypeKind.FLOAT, 16),
    TypeId.FLOAT: (DtypeKind.FLOAT, 32),
    TypeId.DOUBLE: (DtypeKind.FLOAT, 64),
    TypeId.BOOL: (DtypeKind.BOOL, 1),
    TypeId.STRING: (DtypeKind.STRING, 8),
    TypeId.LARGE_STRING: (DtypeKind.STRING, 8),
    TypeId.DATE32: (DtypeKind.DATETIME, 32),
    TypeId.DATE64: (DtypeKind.DATETIME, 64),
    TypeId.TIMESTAMP: (DtypeKind.DATETIME, 64),
    TypeId.DURATION: (DtypeKind.DATETIME, 64),
    TypeId.TIME32: (DtypeKind.DATETIME, 32),
    TypeId.TIME64: (DtypeKind.DATETIME, 64),
}


def _dtype_tuple(t: DataType) -> Tuple[DtypeKind, int, str, str]:
    from .c_data import format_for_type
    if t.id == TypeId.DICTIONARY:
        kind, bits = _KIND_FOR[t.index_type.id]
        return (DtypeKind.CATEGORICAL, bits, format_for_type(t.index_type),
                "=")
    if t.id not in _KIND_FOR:
        raise NotImplementedError(
            f"type {t!r} not supported by the interchange protocol")
    kind, bits = _KIND_FOR[t.id]
    return (kind, bits, format_for_type(t), "=")


class _ATBuffer:
    """A protocol Buffer over one of an Array's buffers."""

    def __init__(self, buf: Buffer):
        self._buf = buf
        self._np = buf.to_numpy()

    @property
    def bufsize(self) -> int:
        return int(self._np.nbytes)

    @property
    def ptr(self) -> int:
        return self._np.ctypes.data

    def __dlpack__(self):
        return self._np.__dlpack__()

    def __dlpack_device__(self):
        return (DlpackDeviceType.CPU, None)

    def __repr__(self) -> str:
        return (f"ATBuffer(bufsize={self.bufsize}, ptr={self.ptr}, "
                f"device='CPU')")


class _ATColumn:
    """A protocol Column over one Array (one chunk)."""

    def __init__(self, arr: Array, allow_copy: bool = True):
        self._arr = arr
        self._allow_copy = allow_copy

    def size(self) -> int:
        return len(self._arr)

    @property
    def offset(self) -> int:
        return self._arr.offset

    @property
    def dtype(self) -> Tuple[DtypeKind, int, str, str]:
        return _dtype_tuple(self._arr.type)

    @property
    def describe_categorical(self):
        t = self._arr.type
        if t.id != TypeId.DICTIONARY:
            raise TypeError("describe_categorical only works on a column "
                            "with categorical dtype")
        return {"is_ordered": bool(getattr(t, "ordered", False)),
                "is_dictionary": True,
                "categories": _ATColumn(self._arr.dictionary,
                                        self._allow_copy)}

    @property
    def describe_null(self) -> Tuple[int, Any]:
        if self._arr.null_count == 0 and self._arr.data.buffers[0] is None:
            return (ColumnNullType.NON_NULLABLE, None)
        return (ColumnNullType.USE_BITMASK, 0)

    @property
    def null_count(self) -> int:
        return self._arr.null_count

    @property
    def metadata(self) -> Dict[str, Any]:
        return {"arrow_tpu.type": repr(self._arr.type)}

    def num_chunks(self) -> int:
        return 1

    def get_chunks(self, n_chunks: Optional[int] = None):
        if n_chunks and n_chunks > 1:
            n = len(self._arr)
            step = max(1, (n + n_chunks - 1) // n_chunks)
            for start in range(0, max(n, 1), step):
                yield _ATColumn(self._arr.slice(start, min(step, n - start)),
                                self._allow_copy)
        else:
            yield self

    def get_buffers(self):
        from .c_data import format_for_type
        t = self._arr.type
        bufs = self._arr.data.buffers
        out: Dict[str, Any] = {"data": None, "validity": None,
                               "offsets": None}
        if bufs and bufs[0] is not None:
            out["validity"] = (_ATBuffer(bufs[0]),
                               (DtypeKind.BOOL, 1, "b", "="))
        if t.id == TypeId.DICTIONARY:
            # the physical index dtype; the consumer reads the values
            # through describe_categorical
            idx = t.index_type
            kind, bits = _KIND_FOR[idx.id]
            out["data"] = (_ATBuffer(bufs[1]),
                           (kind, bits, format_for_type(idx), "="))
            return out
        kind, bits, fmt, _ = self.dtype
        if kind == DtypeKind.STRING:
            off_bits = 64 if t.id == TypeId.LARGE_STRING else 32
            out["offsets"] = (_ATBuffer(bufs[1]),
                              (DtypeKind.INT, off_bits,
                               "l" if off_bits == 64 else "i", "="))
            out["data"] = (_ATBuffer(bufs[2] if bufs[2] is not None
                                     else Buffer(b"")),
                           (DtypeKind.STRING, 8, "u", "="))
        else:
            out["data"] = (_ATBuffer(bufs[1]), (kind, bits, fmt, "="))
        return out


class _ATDataFrame:
    """A protocol DataFrame over a Table or a RecordBatch."""

    def __init__(self, table, nan_as_null: bool = False,
                 allow_copy: bool = True):
        self._tbl = table
        self._nan_as_null = nan_as_null
        self._allow_copy = allow_copy

    def __dataframe__(self, nan_as_null: bool = False,
                      allow_copy: bool = True):
        return _ATDataFrame(self._tbl, nan_as_null, allow_copy)

    @property
    def metadata(self) -> Dict[str, Any]:
        return {"arrow_tpu.num_rows": self._tbl.num_rows}

    def num_columns(self) -> int:
        return len(self._tbl.schema)

    def num_rows(self) -> int:
        return self._tbl.num_rows

    def num_chunks(self) -> int:
        return 1

    def column_names(self) -> List[str]:
        return list(self._tbl.schema.names)

    def _chunk_array(self, i: int) -> Array:
        col = self._tbl.column(i)
        return col if isinstance(col, Array) else col.combine()

    def get_column(self, i: int) -> _ATColumn:
        return _ATColumn(self._chunk_array(i), self._allow_copy)

    def get_column_by_name(self, name: str) -> _ATColumn:
        return self.get_column(self._tbl.schema.names.index(name))

    def get_columns(self) -> List[_ATColumn]:
        return [self.get_column(i) for i in range(self.num_columns())]

    def select_columns(self, indices: Sequence[int]) -> "_ATDataFrame":
        return self.select_columns_by_name(
            [self._tbl.schema.names[i] for i in indices])

    def select_columns_by_name(self, names: Sequence[str]):
        return _ATDataFrame(self._tbl.select(list(names)),
                            self._nan_as_null, self._allow_copy)

    def get_chunks(self, n_chunks: Optional[int] = None):
        if n_chunks and n_chunks > 1:
            n = self._tbl.num_rows
            step = max(1, (n + n_chunks - 1) // n_chunks)
            for start in range(0, max(n, 1), step):
                yield _ATDataFrame(
                    self._tbl.slice(start, min(step, n - start)),
                    self._nan_as_null, self._allow_copy)
        else:
            yield self


# --- the consumer ----------------------------------------------------------------

def _raw(ptr: int, nbytes: int) -> np.ndarray:
    """``nbytes`` at ``ptr`` as uint8, not copied."""
    if nbytes <= 0:
        return np.zeros(0, dtype=np.uint8)
    return np.frombuffer((ctypes.c_ubyte * nbytes).from_address(ptr),
                         dtype=np.uint8)


def _np_from_buffer(buf, n_items: int, bits: int, np_dtype,
                    offset_items: int = 0) -> np.ndarray:
    """Items ``offset_items`` .. ``offset_items + n_items`` of a protocol
    buffer, copied."""
    raw = _raw(buf.ptr, (n_items + offset_items) * (bits // 8))
    return raw.view(np_dtype)[offset_items:].copy()


_NP_FOR = {(DtypeKind.INT, 8): np.int8, (DtypeKind.INT, 16): np.int16,
           (DtypeKind.INT, 32): np.int32, (DtypeKind.INT, 64): np.int64,
           (DtypeKind.UINT, 8): np.uint8, (DtypeKind.UINT, 16): np.uint16,
           (DtypeKind.UINT, 32): np.uint32,
           (DtypeKind.UINT, 64): np.uint64,
           (DtypeKind.FLOAT, 16): np.float16,
           (DtypeKind.FLOAT, 32): np.float32,
           (DtypeKind.FLOAT, 64): np.float64}

_AT_FOR = {(DtypeKind.INT, 8): T.int8, (DtypeKind.INT, 16): T.int16,
           (DtypeKind.INT, 32): T.int32, (DtypeKind.INT, 64): T.int64,
           (DtypeKind.UINT, 8): T.uint8, (DtypeKind.UINT, 16): T.uint16,
           (DtypeKind.UINT, 32): T.uint32, (DtypeKind.UINT, 64): T.uint64,
           (DtypeKind.FLOAT, 16): T.float16, (DtypeKind.FLOAT, 32):
           T.float32, (DtypeKind.FLOAT, 64): T.float64}
_UNITS = {"s": "s", "m": "ms", "u": "us", "n": "ns"}


def _bits_at(ptr: int, n: int, offset: int) -> np.ndarray:
    raw = _raw(ptr, (n + offset + 7) // 8)
    return np.unpackbits(raw, bitorder="little")[offset:offset + n] \
        .astype(bool)


def _valid_mask(col, n: int) -> np.ndarray:
    kind, value = col.describe_null
    bufs = col.get_buffers()
    vb = bufs.get("validity")
    if kind == ColumnNullType.NON_NULLABLE or vb is None:
        if kind == ColumnNullType.USE_NAN:
            dbuf, ddt = bufs["data"]
            vals = _np_from_buffer(dbuf, n, ddt[1],
                                   _NP_FOR[(ddt[0], ddt[1])], col.offset)
            return ~np.isnan(vals)
        return np.ones(n, dtype=bool)
    buf, _ = vb
    if kind == ColumnNullType.USE_BITMASK:
        mask = _bits_at(buf.ptr, n, col.offset)
    else:  # a byte a row
        mask = _raw(buf.ptr, n + col.offset)[col.offset:].astype(bool)
    return ~mask if value == 1 else mask


def _validity(mask: np.ndarray) -> Optional[Buffer]:
    return None if mask.all() else Buffer(bitutil.pack_bits(mask))


def _fixed(values: np.ndarray, mask: np.ndarray, t: DataType) -> Array:
    values = values.astype(t.to_numpy_dtype())
    values[~mask] = 0
    return Array(ArrayData(t, len(values), [_validity(mask), Buffer(values)]))


def _strings(col, n: int, mask: np.ndarray) -> Array:
    obuf, odt = col.get_buffers()["offsets"]
    offs = _np_from_buffer(obuf, n + 1, odt[1],
                           _NP_FOR[(DtypeKind.INT, odt[1])],
                           col.offset).astype(np.int64)
    dbuf, _ = col.get_buffers()["data"]
    raw = _raw(dbuf.ptr, int(offs[-1]))[int(offs[0]):]
    lens = np.diff(offs)
    if not mask.all():  # a null keeps no bytes
        raw = raw[np.repeat(mask, lens)]
        lens = np.where(mask, lens, 0)
    out = np.zeros(n + 1, dtype=np.int32)
    np.cumsum(lens, out=out[1:])
    data = raw.tobytes()
    data.decode("utf-8")  # the reference decodes every value
    return Array(ArrayData(T.string(), n, [_validity(mask), Buffer(out),
                                           Buffer(data)]))


def _categorical(col, n: int, mask: np.ndarray) -> Array:
    dbuf, ddt = col.get_buffers()["data"]
    idx = _np_from_buffer(dbuf, n, ddt[1],
                          _NP_FOR[(DtypeKind(ddt[0]), ddt[1])], col.offset)
    cats = _column_to_array(col.describe_categorical["categories"]) \
        .to_pylist()
    first = next((c for c in cats if c is not None), "")
    vt = T.string() if cats and isinstance(first, str) else T.int64()
    live = idx[mask].astype(np.int64)
    codes, at = np.unique(live, return_index=True)
    codes = codes[np.argsort(at, kind="stable")]  # first appearance
    uniques = [cats[c] for c in codes.tolist()]
    if len(set(uniques)) != len(uniques):
        # equal categories under two codes: the reference's memo of values
        vals = [cats[int(i)] if m else None for i, m in zip(idx, mask)]
        return make_array(vals, T.dictionary(T.int32(), vt))
    remap = np.zeros(max(len(cats), 1), dtype=np.int32)
    remap[codes] = np.arange(len(codes), dtype=np.int32)
    live_idx = np.where(mask, idx, codes[0] if len(codes) else 0)
    indices = np.where(mask, remap[live_idx], 0).astype(np.int32)
    return Array(ArrayData(T.dictionary(T.int32(), vt), n,
                           [_validity(mask), Buffer(indices)],
                           dictionary=array_data_from_sequence(uniques, vt)))


def _datetime_type(fmt: str, bits: int) -> DataType:
    if fmt.startswith("ts"):
        tz = fmt.split(":", 1)[1] if ":" in fmt else ""
        return T.timestamp(_UNITS[fmt[2]], tz or None)
    if fmt == "tdD":
        return T.date32()
    if fmt == "tdm":
        return T.date64()
    if fmt.startswith("tt"):
        unit = _UNITS[fmt[2]]
        return T.time32(unit) if bits == 32 else T.time64(unit)
    if fmt.startswith("tD"):
        return T.duration(_UNITS[fmt[2]])
    raise NotImplementedError(f"datetime format {fmt!r}")


def _column_to_array(col) -> Array:
    n = col.size() if callable(col.size) else col.size
    kind, bits, fmt, _ = col.dtype
    mask = _valid_mask(col, n)
    if kind == DtypeKind.STRING:
        return _strings(col, n, mask)
    if kind == DtypeKind.CATEGORICAL:
        return _categorical(col, n, mask)
    dbuf, ddt = col.get_buffers()["data"]
    if kind == DtypeKind.BOOL:
        if ddt[1] == 1:  # bit-packed
            vals = _bits_at(dbuf.ptr, n, col.offset)
        else:
            vals = _raw(dbuf.ptr, n + col.offset)[col.offset:].astype(bool)
        vals = vals & mask
        return Array(ArrayData(T.bool_(), n, [
            _validity(mask), Buffer(bitutil.pack_bits(vals))]))
    if kind == DtypeKind.DATETIME:
        vals = _np_from_buffer(dbuf, n, bits,
                               np.int64 if bits == 64 else np.int32,
                               col.offset)
        return _fixed(vals, mask, _datetime_type(fmt, bits))
    vals = _np_from_buffer(dbuf, n, bits, _NP_FOR[(kind, bits)], col.offset)
    return _fixed(vals, mask, _AT_FOR[(kind, bits)]())


def from_dataframe(df, allow_copy: bool = True):
    """A host Table of any ``__dataframe__`` producer (pandas, polars,
    pyarrow, the port); a Table or RecordBatch of the port as it is
    (python/pyarrow/interchange/from_dataframe.py)."""
    from .table import RecordBatch, Table
    if isinstance(df, (Table, RecordBatch)):
        return df if isinstance(df, Table) else Table.from_batches([df])
    if not hasattr(df, "__dataframe__"):
        raise TypeError("`df` does not support __dataframe__")
    proto = df.__dataframe__(allow_copy=allow_copy)
    names = list(proto.column_names())
    batches = []
    for chunk in proto.get_chunks():
        arrays = [_column_to_array(chunk.get_column(i))
                  for i in range(chunk.num_columns())]
        fields = [Field(nm, a.type, True) for nm, a in zip(names, arrays)]
        batches.append(RecordBatch(Schema(fields), arrays))
    if not batches:
        raise ValueError("empty interchange dataframe")
    return Table.from_batches(batches, batches[0].schema)
