"""Device-resident columnar data (counterpart of ``arrow_tpu/device/column.py``).

* values: a padded, fixed-capacity tensor on the device
* validity: an optional bool mask tensor (a byte mask, not packed bits)
* strings are dictionary codes: kernels see int32 codes, and the
  dictionary (a tuple of Python values) stays on the host
* a DeviceBatch carries its ``row_count`` as a 0-d tensor beside the static
  capacity, so a data-dependent size (the number of groups) needs no
  device-to-host copy until the result is downloaded.

Every type is stored at the reference's width (``dtypes``): uint16, uint32
and uint64 as the bits of the signed dtype of that width, decimals of up
to 18 digits as their unscaled int64, dates, timestamps, times and
durations as their integer count of the type's unit, month intervals as
int32 and the all-null type as int8 zeros under an all-false validity.
"""

from __future__ import annotations

import datetime
import decimal
import zoneinfo
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import default_device, dtypes
from .. import types as T
from ..types import HOST_BOUNDARY, DataType, Field, Schema, TypeId

# Row capacities are padded to a multiple of this.
BLOCK = 1024


def round_up(n: int, m: int = BLOCK) -> int:
    return max(m, (n + m - 1) // m * m)


def capacity_class(n: int) -> int:
    """A data-dependent output size (join matches) rounded up to its
    power-of-two capacity class, at least BLOCK."""
    return max(BLOCK, 1 << (max(n, 1) - 1).bit_length())


def torch_dtype_for(t: DataType) -> torch.dtype:
    """The storage dtype of a logical type: ``dtypes.STORAGE`` of its
    value dtype (uint16/32/64 as the signed dtype of their width)."""
    return dtypes.STORAGE[dtypes.dtype_of_type(t)]


class DeviceColumn:
    """One padded device column. ``dictionary`` holds the host values that
    int32 codes index, or None."""

    __slots__ = ("values", "validity", "type", "dictionary")

    def __init__(self, values: torch.Tensor, validity: Optional[torch.Tensor],
                 type: DataType, dictionary: Optional[Tuple] = None):
        self.values = values
        self.validity = validity
        self.type = type
        self.dictionary = dictionary

    @property
    def capacity(self) -> int:
        return self.values.shape[0]

    @property
    def value_dtype(self) -> str:
        """The dtype name of the values (``dtypes``): the type's, so an
        unsigned column reads as unsigned."""
        return dtypes.dtype_of_values(self.values, self.type)

    def valid_mask(self, row_mask: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
        """bool[capacity]: validity combined with the batch row mask."""
        m = self.validity
        if m is None:
            m = torch.ones(self.capacity, dtype=torch.bool,
                           device=self.values.device)
        if row_mask is not None:
            m = m & row_mask
        return m

    def __repr__(self):
        return (f"DeviceColumn({self.type!r}, cap={self.capacity}, "
                f"validity={'yes' if self.validity is not None else 'no'})")


class DeviceBatch:
    """Equal-capacity DeviceColumns plus the live row count (a 0-d integer
    tensor on the columns' device)."""

    __slots__ = ("schema", "columns", "row_count")

    def __init__(self, schema: Schema, columns: Sequence[DeviceColumn],
                 row_count: torch.Tensor):
        self.schema = schema
        self.columns = list(columns)
        self.row_count = row_count

    @property
    def capacity(self) -> int:
        return self.columns[0].capacity if self.columns else 0

    def column(self, i: Union[int, str]) -> DeviceColumn:
        if isinstance(i, str):
            idx = self.schema.get_field_index(i)
            if idx < 0:
                raise KeyError(f"no column named {i!r}")
            i = idx
        return self.columns[i]

    def row_mask(self) -> torch.Tensor:
        """bool[capacity]: True on the live rows."""
        return (torch.arange(self.capacity, dtype=torch.int32,
                             device=self.row_count.device) < self.row_count)

    def select(self, names: Sequence[str]) -> "DeviceBatch":
        idxs = [self.schema.get_field_index(n) for n in names]
        return DeviceBatch(Schema([self.schema.fields[i] for i in idxs]),
                           [self.columns[i] for i in idxs], self.row_count)

    def __repr__(self):
        return (f"DeviceBatch(cap={self.capacity}, "
                f"cols={self.schema.names})")


def batch_from_numpy(columns: Sequence[tuple], row_count: int,
                     device=None) -> DeviceBatch:
    """Build a DeviceBatch from plain numpy arrays.

    ``columns`` holds ``(name, type, values, validity_or_None,
    dictionary_values_or_None)`` per column; ``type`` is a DataType or a
    name for ``types.type_for_name``. ``values`` are the values of the
    type's value dtype (unsigned ones as unsigned), or
    ``datetime64``/``timedelta64`` values for a temporal type (converted
    to its unit), or ``decimal.Decimal`` values for a decimal (scaled to
    its unscaled integers exactly). Values are padded with zeros, and
    validity with False, to ``round_up`` of the longest column. A null
    column is all null. Decimals wider than 18 digits raise
    NotImplementedError."""
    dev = default_device(device)
    cap = round_up(max([row_count] + [len(c[2]) for c in columns]))
    fields, cols = [], []
    for name, type_, values, validity, dictionary in columns:
        t = T.type_for_name(type_) if isinstance(type_, str) else type_
        vals = np.zeros(cap, dtype=_numpy_dtype(t))
        vals[:len(values)] = _host_values(t, values)
        mask = None
        if t.id == TypeId.NA:
            validity = np.zeros(len(values), dtype=np.bool_)
        if validity is not None:
            m = np.zeros(cap, dtype=np.bool_)
            m[:len(validity)] = validity
            mask = torch.from_numpy(m).to(dev)
        fields.append(Field(name, t))
        cols.append(DeviceColumn(
            torch.from_numpy(vals).to(dev), mask, t,
            tuple(dictionary) if dictionary is not None else None))
    return DeviceBatch(Schema(fields), cols,
                       torch.tensor(row_count, dtype=torch.int32,
                                    device=dev))


def batch_from_arrays(schema: Schema, columns: Sequence[tuple],
                      row_count: int) -> DeviceBatch:
    """A CPU DeviceBatch from numpy arrays already in their storage dtype
    (what a download of the columns gives): ``(values, validity_or_None,
    dictionary_or_None)`` a field of ``schema``, padded with zeros (and
    False) to ``round_up(row_count)``."""
    cap = round_up(row_count)
    cols = []
    for values, validity, dictionary in columns:
        vals = np.zeros(cap, dtype=values.dtype)
        vals[:row_count] = values
        mask = None
        if validity is not None:
            mask = np.zeros(cap, dtype=np.bool_)
            mask[:row_count] = validity
            mask = torch.from_numpy(mask)
        cols.append((torch.from_numpy(vals), mask, dictionary))
    return DeviceBatch(schema, [DeviceColumn(v, m, f.type, d) for (v, m, d), f
                                in zip(cols, schema.fields)],
                       torch.tensor(row_count, dtype=torch.int32))


def _map_tensors(batch: DeviceBatch, fn) -> DeviceBatch:
    return DeviceBatch(batch.schema, [
        DeviceColumn(fn(c.values), None if c.validity is None
                     else fn(c.validity), c.type, c.dictionary)
        for c in batch.columns], fn(batch.row_count))


def batch_to(batch: DeviceBatch, device) -> DeviceBatch:
    """``batch`` with every tensor on ``device`` (the same tensors where
    they are there already); dictionaries are shared."""
    dev = torch.device(device)
    return _map_tensors(batch, lambda t: t.to(dev))


def pin_batch(batch: DeviceBatch) -> DeviceBatch:
    """A CPU ``batch`` with every tensor in pinned (page-locked) memory, so
    a copy to the card can run asynchronously: a tensor already pinned is
    kept, any other is copied once."""
    return _map_tensors(
        batch, lambda t: t if t.is_pinned() else t.pin_memory())


def slice_rows(batch: DeviceBatch, start: int, length: int, capacity: int,
               row_count: torch.Tensor) -> DeviceBatch:
    """Rows ``[start, start + length)`` of ``batch`` at ``capacity`` on
    ``row_count``'s device, dictionaries shared. On the batch's own device
    a column is a view where ``capacity`` rows from ``start`` lie within
    its buffer (the rows past ``length`` are then padding the row count
    masks), else a copy padded with zeros and False. To another device
    each column is copied with ``non_blocking=True`` on the current
    stream, its tail zeroed: from pinned memory to the card the copy runs
    asynchronously."""
    dev = row_count.device
    same = batch.row_count.device == dev
    fits = start + capacity <= batch.capacity

    def part(t: torch.Tensor) -> torch.Tensor:
        if same and fits:
            return t[start:start + capacity]
        out = torch.empty(capacity, dtype=t.dtype, device=dev)
        out[:length].copy_(t[start:start + length], non_blocking=True)
        out[length:].zero_()
        return out

    return DeviceBatch(batch.schema, [
        DeviceColumn(part(c.values), None if c.validity is None
                     else part(c.validity), c.type, c.dictionary)
        for c in batch.columns], row_count)


_NP_UNITS = {"s": "s", "ms": "ms", "us": "us", "ns": "ns"}


def _host_values(t: DataType, values) -> np.ndarray:
    """Host values of type ``t`` -> its storage dtype's numpy array (the
    bits of an unsigned value, the unscaled integer of a decimal)."""
    store = _numpy_dtype(t)
    if t.is_decimal:
        if t.precision > 18:
            raise NotImplementedError(
                f"{t!r}: decimals wider than 18 digits ride the reference's "
                "device as dictionary codes of a host Array; not ported yet "
                + HOST_BOUNDARY)
        vals = list(values)
        if vals and isinstance(vals[0], decimal.Decimal):
            return np.array([0 if v is None else int(v.scaleb(t.scale))
                             for v in vals], dtype=np.int64)
        return np.asarray(vals, dtype=np.int64)
    arr = np.asarray(values)
    if arr.dtype.kind in "mM":
        unit = {TypeId.DATE32: "D", TypeId.DATE64: "ms"}.get(
            t.id, getattr(t, "unit", None))
        kind = "datetime64" if arr.dtype.kind == "M" else "timedelta64"
        return arr.astype(f"{kind}[{unit}]").view(np.int64).astype(store)
    if t.id in (TypeId.STRING, TypeId.DICTIONARY) or t.id == TypeId.NA:
        return arr.astype(store)
    value_dtype = dtypes.dtype_of_type(t)
    return arr.astype(value_dtype).view(store)


def _numpy_dtype(t: DataType) -> np.dtype:
    return torch.empty(0, dtype=torch_dtype_for(t)).numpy().dtype


_EPOCH = datetime.date(1970, 1, 1)
_EPOCH_DT = datetime.datetime(1970, 1, 1)
_UNIT_US = {"s": 1_000_000, "ms": 1000, "us": 1}


def _micros(x: int, unit: str) -> int:
    return x // 1000 if unit == "ns" else x * _UNIT_US[unit]


def _py_value(t: DataType, x: int):
    """One stored integer of a temporal or decimal type as the Python
    value the reference's ``to_pylist`` gives."""
    tid = t.id
    if t.is_decimal:
        return decimal.Decimal(x).scaleb(-t.scale)
    if tid == TypeId.DATE32:
        return _EPOCH + datetime.timedelta(days=x)
    if tid == TypeId.DATE64:
        return _EPOCH + datetime.timedelta(milliseconds=x)
    us = _micros(x, t.unit)
    if tid == TypeId.TIMESTAMP:
        out = _EPOCH_DT + datetime.timedelta(microseconds=us)
        if t.tz is not None:
            tz = (datetime.timezone.utc if t.tz.upper() == "UTC"
                  else zoneinfo.ZoneInfo(t.tz))
            out = out.replace(tzinfo=datetime.timezone.utc).astimezone(tz)
        return out
    if tid == TypeId.DURATION:
        return datetime.timedelta(microseconds=us)
    return datetime.time(us // 3600_000_000, us // 60_000_000 % 60,
                         us // 1_000_000 % 60, us % 1_000_000)


def download(batch: DeviceBatch) -> Dict[str, List]:
    """The live rows as Python lists by column name, as the reference's
    ``download_table(...).to_pydict()`` gives them: None for nulls,
    dictionary codes decoded, unsigned values unsigned, decimals as
    ``decimal.Decimal``, dates as ``datetime.date``, timestamps as
    ``datetime.datetime``, times as ``datetime.time`` and durations as
    ``datetime.timedelta``."""
    n = int(batch.row_count)
    out = {}
    for f, c in zip(batch.schema.fields, batch.columns):
        t = f.type
        if t.id == TypeId.NA:
            out[f.name] = [None] * n
            continue
        vals = c.values[:n].cpu().numpy()
        mask = (np.ones(n, dtype=np.bool_) if c.validity is None
                else c.validity[:n].cpu().numpy())
        if c.dictionary is not None:
            py = [c.dictionary[int(v)] for v in np.where(mask, vals, 0)]
        elif t.is_temporal or t.is_decimal:
            py = [_py_value(t, int(v)) for v in vals.astype(np.int64)]
        else:
            py = vals.view(dtypes.dtype_of_type(t)).tolist() \
                if t.is_unsigned_integer else vals.tolist()
        out[f.name] = [v if ok else None for v, ok in zip(py, mask)]
    return out
