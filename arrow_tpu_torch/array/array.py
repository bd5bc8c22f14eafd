"""The host Array (counterpart of ``arrow_tpu/array/array.py``; reference:
cpp/src/arrow/array/array_base.h:53): one class over ArrayData, its type id
driving its behaviour. The methods that compute go through the port's eager
API (``compute``), which runs them on the card unless ``device="cpu"`` is
given."""

from __future__ import annotations

import datetime as _dt
import decimal as _decimal
import zoneinfo
from typing import Any, List, Optional

import numpy as np

from ..types import DataType, TypeId
from .construct import VIEW_INLINE, array_data_from_sequence
from .data import ArrayData


class Array:
    __slots__ = ("data",)

    def __init__(self, data: ArrayData):
        self.data = data

    @property
    def type(self) -> DataType:
        return self.data.type

    @property
    def null_count(self) -> int:
        return self.data.null_count

    @property
    def offset(self) -> int:
        return self.data.offset

    def __len__(self) -> int:
        return self.data.length

    @property
    def dictionary(self) -> Optional["Array"]:
        return Array(self.data.dictionary) if self.data.dictionary else None

    @property
    def indices(self) -> "Array":
        if self.type.id != TypeId.DICTIONARY:
            raise ValueError("not a dictionary array")
        d = self.data
        return Array(ArrayData(self.type.index_type, d.length,
                               [d.buffers[0], d.buffers[1]],
                               null_count=d._null_count, offset=d.offset))

    @property
    def values(self) -> "Array":
        """The flattened child of a list type; a run-end encoded array's
        values, one a run."""
        if self.type.id in (TypeId.LIST, TypeId.LARGE_LIST,
                            TypeId.FIXED_SIZE_LIST, TypeId.MAP):
            return Array(self.data.children[0])
        if self.type.id == TypeId.RUN_END_ENCODED:
            return Array(self.data.children[1])
        raise ValueError(f"{self.type!r} has no values child")

    @property
    def run_ends(self) -> "Array":
        """A run-end encoded array's run ends."""
        if self.type.id != TypeId.RUN_END_ENCODED:
            raise ValueError("not a run-end encoded array")
        return Array(self.data.children[0])

    def is_valid_mask(self) -> np.ndarray:
        m = self.data.validity_mask()
        return np.ones(len(self), dtype=np.bool_) if m is None else m

    def to_numpy(self, zero_copy_only: bool = False) -> np.ndarray:
        """A primitive array as numpy; nulls only in a float array (as
        NaN)."""
        vals = self.data.values()
        if self.null_count:
            if zero_copy_only:
                raise ValueError("nulls present")
            if not self.type.is_floating:
                raise ValueError("nulls present in non-float array")
            vals = vals.copy()
            vals[~self.is_valid_mask()] = np.nan
        return vals

    def to_pylist(self) -> List[Any]:
        return _to_pylist(self.data)

    tolist = to_pylist

    def __getitem__(self, i):
        if isinstance(i, slice):
            start, stop, step = i.indices(len(self))
            if step != 1:
                raise ValueError("only unit-step slices")
            return Array(self.data.slice(start, stop - start))
        if i < 0:
            i += len(self)
        if not 0 <= i < len(self):
            raise IndexError(i)
        return _to_pylist(self.data.slice(i, 1))[0]

    def slice(self, offset: int, length: Optional[int] = None) -> "Array":
        return Array(self.data.slice(offset, length))

    def equals(self, other: "Array") -> bool:
        """Deep equality with NaN equal to NaN (the reference's
        ``nans_equal=True``)."""
        if self.type != other.type or len(self) != len(other):
            return False
        return pylist_equal(self.to_pylist(), other.to_pylist())

    def __eq__(self, other):
        return isinstance(other, Array) and self.equals(other)

    __hash__ = None

    def __repr__(self):
        vals = self.to_pylist()
        shown = vals if len(vals) <= 20 else vals[:10] + ["..."] + vals[-5:]
        return f"<arrow_tpu_torch.Array {self.type!r}>\n{shown}"

    def buffers(self):
        return list(self.data.buffers)

    # interop: the C data interface, dlpack and pandas
    def __arrow_c_array__(self, requested_schema=None):
        """(schema capsule, array capsule) of the Arrow PyCapsule
        interface; the capsules point at this Array's buffers."""
        from ..c_data import array_capsules
        return array_capsules(self)

    def __dlpack__(self, stream=None):
        """A primitive Array without nulls, through numpy without a copy
        (reference: c/dlpack.cc)."""
        return self.to_numpy(zero_copy_only=True).__dlpack__()

    def __dlpack_device__(self):
        return self.to_numpy(zero_copy_only=True).__dlpack_device__()

    def to_pandas(self):
        """A pandas Series, as the reference converts (needs pandas)."""
        import pandas as pd
        t = self.type
        if t.id in (TypeId.TIMESTAMP, TypeId.DURATION):
            kind = "datetime64" if t.id == TypeId.TIMESTAMP else \
                "timedelta64"
            vals = np.asarray(self.data.values(),
                              np.int64).astype(f"{kind}[{t.unit}]")
            if self.null_count:
                vals = vals.copy()
                vals[~self.is_valid_mask()] = "NaT"
            s = pd.Series(vals)
            if t.id == TypeId.TIMESTAMP and t.tz:
                s = s.dt.tz_localize("UTC").dt.tz_convert(t.tz)
            return s
        if t.id == TypeId.DICTIONARY:
            codes = np.asarray(self.indices.data.values(), np.int64)
            if self.null_count:
                codes = codes.copy()
                codes[~self.is_valid_mask()] = -1
            return pd.Series(pd.Categorical.from_codes(
                codes, categories=pd.Index(self.dictionary.to_pylist())))
        if t.is_numeric and self.null_count == 0:
            return pd.Series(self.data.values())
        if t.is_floating:
            return pd.Series(self.to_numpy())
        return pd.Series(self.to_pylist(), dtype=object)

    @staticmethod
    def from_pandas(obj, type: Optional[DataType] = None) -> "Array":
        """An Array of a pandas Series (NaN and None null) or of a
        sequence (needs pandas)."""
        import pandas as pd
        vals = [None if v is None or (isinstance(v, float) and v != v)
                else v for v in obj.tolist()] \
            if isinstance(obj, pd.Series) else list(obj)
        return array(vals, type)

    @property
    def nbytes(self) -> int:
        return sum(b.size for b in self.data.buffers if b is not None)

    # the methods that compute, through the eager API
    def _call(self, fname, *args, device=None, **opts):
        from ..compute.registry import call_function
        return call_function(fname, [self, *args], options=opts or None,
                             device=device)

    def cast(self, target: DataType, device=None) -> "Array":
        return self._call("cast", device=device, to_type=target)

    def filter(self, mask, null_selection_behavior: str = "drop",
               device=None):
        return self._call("filter", mask, device=device,
                          null_selection_behavior=null_selection_behavior)

    def take(self, indices, device=None):
        return self._call("take", indices, device=device)

    def drop_null(self, device=None):
        return self._call("drop_null", device=device)

    def sort(self, order: str = "ascending", device=None, **kwargs):
        idx = self._call("array_sort_indices", device=device, order=order,
                         **kwargs)
        return self.take(idx, device=device)

    def unique(self, device=None):
        return self._call("unique", device=device)

    def value_counts(self, device=None):
        from ..compute import value_counts
        return value_counts(self, device=device)

    def dictionary_encode(self, device=None):
        if self.type.id == TypeId.DICTIONARY:
            return self
        from ..compute import dictionary_encode
        return dictionary_encode(self, device=device)

    def fill_null(self, fill_value, device=None):
        return self._call("coalesce", fill_value, device=device)

    def is_null(self, nan_is_null: bool = False, device=None):
        return self._call("is_null", device=device, nan_is_null=nan_is_null)

    def is_valid(self, device=None):
        return self._call("is_valid", device=device)

    def is_nan(self, device=None):
        return self._call("is_nan", device=device)

    def sum(self, device=None, **kwargs):
        return self._call("sum", device=device, **kwargs)

    def index(self, value, start=None, end=None, device=None) -> int:
        """The first row in ``[start, end)`` that equals ``value``, or -1
        (compute ``index``)."""
        a, base = self, 0
        if start is not None or end is not None:
            base = start or 0
            a = a.slice(base, (len(a) if end is None else end) - base)
        r = a._call("index", device=device, value=value)
        v = r.as_py() if hasattr(r, "as_py") else r
        return v + base if v >= 0 else -1

    # host work
    def to_string(self, **kwargs) -> str:
        return repr(self)

    def view(self, target_type: DataType) -> "Array":
        """The same buffers read as another type of the same width
        (array.h View)."""
        if not isinstance(target_type, DataType):
            raise TypeError("view() expects a DataType")
        d = self.data
        return Array(ArrayData(target_type, d.length, list(d.buffers),
                               children=list(d.children),
                               null_count=d._null_count, offset=d.offset,
                               dictionary=d.dictionary))

    def diff(self, other: "Array") -> str:
        """The rows where two Arrays differ, one ``@ i: -a +b`` line each;
        empty where they are equal (array/diff.h)."""
        if self.equals(other):
            return ""
        a, b = self.to_pylist(), other.to_pylist()
        lines = []
        for i in range(max(len(a), len(b))):
            va = a[i] if i < len(a) else "<absent>"
            vb = b[i] if i < len(b) else "<absent>"
            if va != vb:
                lines.append(f"@ {i}: -{va!r} +{vb!r}")
        return "\n".join(lines)

    @staticmethod
    def from_buffers(type: DataType, length: int, buffers,
                     null_count: int = -1, offset: int = 0,
                     children=None) -> "Array":
        from ..buffer import Buffer
        bufs = [b if b is None or isinstance(b, Buffer) else Buffer(b)
                for b in buffers]
        return Array(ArrayData(type, length, bufs,
                               children=[c.data for c in children or []],
                               null_count=null_count, offset=offset))

    def get_total_buffer_size(self) -> int:
        return self.nbytes

    @property
    def is_cpu(self) -> bool:
        return True

    @property
    def device_type(self):
        from ..device import DeviceAllocationType
        return DeviceAllocationType.CPU

    def copy_to(self, destination) -> "Array":
        return self

    def validate(self, *, full: bool = False) -> None:
        from .validate import validate
        validate(self.data, full)

    @property
    def statistics(self):
        """None: no reader of the port attaches statistics to an Array."""
        return None


def pylist_equal(a, b) -> bool:
    """Element equality with NaN equal to NaN, into containers."""
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (a != a and b != b)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(pylist_equal(x, y)
                                        for x, y in zip(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return (a.keys() == b.keys()
                and all(pylist_equal(a[k], b[k]) for k in a))
    if isinstance(a, tuple) and isinstance(b, tuple):
        return len(a) == len(b) and all(pylist_equal(x, y)
                                        for x, y in zip(a, b))
    return a == b


def array(values, type: Optional[DataType] = None) -> Array:
    """An Array from a Python sequence or a numpy array."""
    if isinstance(values, Array):
        return values if type is None else values.cast(type)
    return Array(array_data_from_sequence(values, type))


_EPOCH = _dt.date(1970, 1, 1)
_EPOCH_DT = _dt.datetime(1970, 1, 1)
_UNIT_US = {"s": 1_000_000, "ms": 1000, "us": 1}


def _micros(x: int, unit: str) -> int:
    return x // 1000 if unit == "ns" else x * _UNIT_US[unit]


def _temporal(t: DataType):
    """The conversion of one stored integer of a temporal type to the
    Python value the reference gives."""
    tid = t.id
    if tid == TypeId.DATE32:
        return lambda x: _EPOCH + _dt.timedelta(days=x)
    if tid == TypeId.DATE64:
        return lambda x: _EPOCH + _dt.timedelta(milliseconds=x)
    unit = t.unit
    if tid == TypeId.TIMESTAMP:
        tz = None if t.tz is None else (
            _dt.timezone.utc if t.tz.upper() == "UTC"
            else zoneinfo.ZoneInfo(t.tz))

        def ts(x):
            out = _EPOCH_DT + _dt.timedelta(microseconds=_micros(x, unit))
            return out if tz is None else out.replace(
                tzinfo=_dt.timezone.utc).astimezone(tz)
        return ts
    if tid == TypeId.DURATION:
        return lambda x: _dt.timedelta(microseconds=_micros(x, unit))

    def tm(x):
        us = _micros(x, unit)
        return _dt.time(us // 3600_000_000, us // 60_000_000 % 60,
                        us // 1_000_000 % 60, us % 1_000_000)
    return tm


def _with_nulls(out: list, mask) -> list:
    if mask is None:
        return out
    return [v if m else None for v, m in zip(out, mask.tolist())]


def _views_to_pylist(d: ArrayData, mask) -> List[Any]:
    """A string or binary view's values: inline ones from the views, the
    others from their data buffers."""
    n = d.length
    if n == 0 or d.buffers[1] is None:
        return []
    views = d.buffers[1].to_numpy().reshape(-1, 16)[d.offset:d.offset + n]
    words = np.ascontiguousarray(views).view("<i4")  # (n, 4)
    lens = words[:, 0].tolist()
    buf_ids = words[:, 2].tolist()
    offs = words[:, 3].tolist()
    inline = np.ascontiguousarray(views[:, 4:]).tobytes()
    data = [b"" if b is None else b.to_pybytes() for b in d.buffers[2:]]
    w = VIEW_INLINE
    out = [inline[w * i:w * i + ln] if ln <= w else
           data[buf_ids[i]][offs[i]:offs[i] + ln]
           for i, ln in enumerate(lens)]
    if d.type.id == TypeId.BINARY_VIEW:
        return _with_nulls(out, mask)
    if mask is None:
        return [b.decode() for b in out]
    return [b.decode() if m else None for b, m in zip(out, mask.tolist())]


def _union_to_pylist(d: ArrayData) -> List[Any]:
    """A union's rows, each its child's value: a dense union's at its
    offset, a sparse union's at the row."""
    t = d.type
    n = d.length
    code_to_child = {c: j for j, c in enumerate(t.type_codes)}
    kids = [_to_pylist(c) for c in d.children]
    which = [code_to_child[c] for c in d.type_ids().tolist()]
    if t.id == TypeId.DENSE_UNION:
        offs = d.buffers[1].view(np.int32)[d.offset:d.offset + n].tolist()
    else:
        offs = range(d.offset, d.offset + n)
    return [kids[j][o] for j, o in zip(which, offs)]


def _to_pylist(d: ArrayData) -> List[Any]:
    t = d.type
    tid = t.id
    n = d.length
    if tid == TypeId.EXTENSION:
        storage = d.copy()
        storage.type = t.storage_type
        return _to_pylist(storage)
    if tid == TypeId.NA:
        return [None] * n
    if tid in (TypeId.SPARSE_UNION, TypeId.DENSE_UNION):
        return _union_to_pylist(d)
    mask = d.validity_mask()

    if tid in (TypeId.STRING_VIEW, TypeId.BINARY_VIEW):
        return _views_to_pylist(d, mask)

    if tid in (TypeId.LIST_VIEW, TypeId.LARGE_LIST_VIEW):
        if n == 0 or d.buffers[1] is None:
            return []
        dt = np.int64 if tid == TypeId.LARGE_LIST_VIEW else np.int32
        offs = d.buffers[1].view(dt)[d.offset:d.offset + n].tolist()
        sizes = d.buffers[2].view(dt)[d.offset:d.offset + n].tolist()
        child = _to_pylist(d.children[0])
        return _with_nulls([child[o:o + z] for o, z in zip(offs, sizes)],
                           mask)

    if tid == TypeId.BOOL or t.is_numeric or tid == TypeId.INTERVAL_MONTHS:
        return _with_nulls(np.asarray(d.values()).tolist(), mask)

    if tid == TypeId.INTERVAL_DAY_TIME:
        pairs = d.buffers[1].view(np.int32).reshape(-1, 2)[
            d.offset:d.offset + n]
        return _with_nulls([tuple(p) for p in pairs.tolist()], mask)

    if tid == TypeId.INTERVAL_MONTH_DAY_NANO:
        raw = d.buffers[1].to_numpy().reshape(-1, 16)[d.offset:d.offset + n]
        md = np.ascontiguousarray(raw[:, :8]).view(np.int32).tolist()
        ns = np.ascontiguousarray(raw[:, 8:]).view(np.int64)[:, 0].tolist()
        return _with_nulls([(m, dd, x) for (m, dd), x in zip(md, ns)],
                           mask)

    if tid == TypeId.RUN_END_ENCODED:
        # logical row i is in the first run whose end exceeds it
        ends = np.asarray(d.children[0].values(), np.int64)
        run = np.searchsorted(ends, np.arange(d.offset, d.offset + n),
                              side="right")
        vals = _to_pylist(d.children[1])
        return [vals[r] for r in run.tolist()]

    if t.is_temporal:
        conv = _temporal(t)
        vals = d.values().tolist()
        if mask is None:
            return [conv(x) for x in vals]
        return [conv(x) if m else None for x, m in zip(vals, mask.tolist())]

    if tid in (TypeId.STRING, TypeId.LARGE_STRING, TypeId.BINARY,
               TypeId.LARGE_BINARY):
        offl = np.asarray(d.offsets()).tolist()
        raw = d.data_bytes().tobytes()
        if tid in (TypeId.STRING, TypeId.LARGE_STRING):
            # one decode of the whole buffer; for ASCII the byte offsets
            # are the character offsets
            try:
                text = raw.decode("utf-8")
            except UnicodeDecodeError:
                text = None
            if text is not None and len(text) == len(raw):
                out = [text[offl[i]:offl[i + 1]] for i in range(n)]
            else:
                out = [raw[offl[i]:offl[i + 1]].decode("utf-8", "replace")
                       if mask is None or mask[i] else None
                       for i in range(n)]
        else:
            out = [raw[offl[i]:offl[i + 1]] for i in range(n)]
        return _with_nulls(out, mask)

    if tid == TypeId.FIXED_SIZE_BINARY:
        vals = d.values()
        return _with_nulls([r.tobytes() for r in vals], mask)

    if t.is_decimal:
        vals = d.values()
        scale = -t.scale
        out = [_decimal.Decimal(int.from_bytes(r.tobytes(), "little",
                                               signed=True)).scaleb(scale)
               for r in vals]
        return _with_nulls(out, mask)

    if tid in (TypeId.LIST, TypeId.LARGE_LIST):
        offs = d.offsets().tolist()
        child = _to_pylist(d.children[0])
        return _with_nulls([child[offs[i]:offs[i + 1]] for i in range(n)],
                           mask)

    if tid == TypeId.MAP:
        offs = d.offsets().tolist()
        entries = _to_pylist(d.children[0])
        return _with_nulls([[(e["key"], e["value"])
                             for e in entries[offs[i]:offs[i + 1]]]
                            for i in range(n)], mask)

    if tid == TypeId.FIXED_SIZE_LIST:
        sz = t.list_size
        child = _to_pylist(d.children[0].slice(d.offset * sz, n * sz))
        return _with_nulls([child[i * sz:(i + 1) * sz] for i in range(n)],
                           mask)

    if tid == TypeId.STRUCT:
        cols = [_to_pylist(c.slice(d.offset, n)) for c in d.children]
        names = [f.name for f in t.fields]
        return _with_nulls([dict(zip(names, row)) for row in zip(*cols)]
                           if cols else [{} for _ in range(n)], mask)

    if tid == TypeId.DICTIONARY:
        dict_vals = _to_pylist(d.dictionary)
        idx = d.values().tolist()
        if mask is None:
            return [dict_vals[i] for i in idx]
        return [dict_vals[i] if m else None
                for i, m in zip(idx, mask.tolist())]

    raise NotImplementedError(f"to_pylist for {t!r}")
