"""Implicit casts of the eager API (counterpart of
``arrow_tpu/compute/dispatch.py``; reference: DispatchBest,
compute/function.cc:298).

Numeric promotion is the port's typed device functions' own (``dtypes``),
so nothing is cast twice for it here. This module supplies what they do
not see:

- temporal arguments of different units or ids -> the common timestamp,
  date or duration type (the finest unit), cast before upload;
- Python str, bytes, datetime and Decimal scalars beside columns ->
  constant columns, so the device function sees uniform operands;
- a dictionary of numbers beside other arguments -> decoded (dictionary
  decay);
- two or more dictionary-coded device columns -> recoded against their
  sorted union dictionary, so code order is value order and every
  comparison is right on codes.
"""

from __future__ import annotations

import datetime as _dt
import decimal as _decimal
from typing import List, Sequence

import numpy as np
import torch

from .. import types as T
from ..array.array import Array, array as make_array
from ..device.column import host_take
from ..table import ChunkedArray
from ..types import DataType, TypeId

_TS_IDS = (TypeId.TIMESTAMP, TypeId.DATE32, TypeId.DATE64)
_UNIT_RANK = {"s": 0, "ms": 1, "us": 2, "ns": 3}
_BYTES_KIND = (TypeId.STRING, TypeId.LARGE_STRING, TypeId.BINARY,
               TypeId.LARGE_BINARY)


def _common_timestamp(types: Sequence[DataType]) -> DataType:
    unit = "s"
    tz = None
    any_ts = False
    for t in types:
        if t.id == TypeId.TIMESTAMP:
            any_ts = True
            if _UNIT_RANK[t.unit] > _UNIT_RANK[unit]:
                unit = t.unit
            tz = tz or t.tz
        elif t.id == TypeId.DATE64 and _UNIT_RANK["ms"] > _UNIT_RANK[unit]:
            unit = "ms"
    if not any_ts and all(t.id == TypeId.DATE32 for t in types):
        return T.date32()
    return T.timestamp(unit, tz)


def unify_inputs(name: str, args: Sequence, options, device=None) -> List:
    """The Array-level implicit casts, before upload; a cast runs on
    ``device``."""
    out = list(args)
    arr_idx = [i for i, a in enumerate(out)
               if isinstance(a, (Array, ChunkedArray))]
    if not arr_idx:
        return out
    for i in arr_idx:
        if isinstance(out[i], ChunkedArray):
            out[i] = out[i].combine()
    n = len(out[arr_idx[0]])
    for i in arr_idx:
        t = out[i].type
        if t.id == TypeId.DICTIONARY and t.value_type.id not in _BYTES_KIND:
            # decoded on the host: its values at its codes
            out[i] = host_take(out[i], np.arange(len(out[i])))
    types = [out[i].type for i in arr_idx]
    temporal = [t for t in types if t.id in _TS_IDS]
    if len({(t.id, getattr(t, "unit", None), getattr(t, "tz", None))
            for t in temporal}) > 1:
        target = _common_timestamp(temporal)
        for i in arr_idx:
            if out[i].type.id in _TS_IDS and out[i].type != target:
                out[i] = out[i].cast(target, device=device)
    durations = [t for t in types if t.id == TypeId.DURATION]
    if len({t.unit for t in durations}) > 1:
        unit = max((t.unit for t in durations), key=_UNIT_RANK.get)
        for i in arr_idx:
            if out[i].type.id == TypeId.DURATION and \
                    out[i].type.unit != unit:
                out[i] = out[i].cast(T.duration(unit), device=device)
    types = [out[i].type for i in arr_idx]
    bytes_kind = any(t.id in _BYTES_KIND or (
        t.id == TypeId.DICTIONARY and t.value_type.id in _BYTES_KIND)
        for t in types)
    fsb = [t for t in types if t.id == TypeId.FIXED_SIZE_BINARY]
    decs = [t for t in types if t.is_decimal]
    for i, a in enumerate(out):
        if i in arr_idx:
            continue
        if isinstance(a, str) and bytes_kind:
            out[i] = make_array([a] * n, T.string())
        elif isinstance(a, bytes) and bytes_kind:
            out[i] = make_array([a] * n, T.binary())
        elif isinstance(a, bytes) and fsb:
            out[i] = make_array([a] * n, T.fixed_size_binary(len(a)))
        elif isinstance(a, _decimal.Decimal) and decs:
            out[i] = _decimal_literal(a, decs[0], n)
        elif isinstance(a, (_dt.datetime, _dt.date)):
            ts = [t for t in types if t.id in _TS_IDS]
            if ts:
                out[i] = make_array([a] * n, ts[0])
    return out


def _decimal_literal(a: _decimal.Decimal, t0, n: int) -> Array:
    from .registry import ArrowInvalid
    exp = -a.as_tuple().exponent
    if t0.precision <= 18:
        # an unscaled int64 on the device: the literal must be exact at
        # the column's scale
        if exp > t0.scale:
            raise ArrowInvalid(
                f"decimal literal {a} has more fractional digits than "
                f"{t0!r}; rescale the literal or cast")
        return make_array([a] * n, t0)
    # codes over values: the literal keeps its own exact scale
    prec = max(t0.precision, len(a.as_tuple().digits), 19)
    mk = T.decimal256 if (t0.id == TypeId.DECIMAL256 or prec > 38) \
        else T.decimal128
    return make_array([a] * n, mk(min(prec, 76), max(exp, 0)))


def unify_device_dicts(prepared: List) -> List:
    """Two or more dictionary-coded DeviceColumns recoded against the
    sorted union of their dictionaries (codes become value ranks); one
    dictionary object shared by all is left as it is."""
    from ..device.column import DeviceColumn
    pos = [i for i, p in enumerate(prepared)
           if isinstance(p, DeviceColumn) and p.dictionary is not None]
    if len(pos) < 2:
        return prepared
    dicts = [prepared[i].dictionary for i in pos]
    if all(d is dicts[0] for d in dicts[1:]):
        return prepared
    union = tuple(sorted({v for d in dicts for v in d if v is not None}))
    rank = {v: r for r, v in enumerate(union)}
    out = list(prepared)
    for i in pos:
        col = prepared[i]
        mapping = torch.from_numpy(np.asarray(
            [rank.get(v, 0) for v in col.dictionary] or [0], np.int32)).to(
                col.values.device)
        codes = mapping[col.values.long().clamp(0, len(mapping) - 1)]
        out[i] = DeviceColumn(codes, col.validity, col.type, union)
    return out
