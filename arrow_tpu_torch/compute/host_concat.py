"""Host concatenation of arrays (counterpart of
``arrow_tpu/compute/host_concat.py``; reference:
cpp/src/arrow/array/concatenate.cc): buffer by buffer for fixed-width and
variable-size binary types, through Python values for nested and
dictionary types, as the reference does."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ..array.array import Array, array
from ..array.data import ArrayData
from ..buffer import Buffer
from ..types import DataType, TypeId
from ..utils import bits as bitutil

_FIXED_BYTES = (TypeId.FIXED_SIZE_BINARY, TypeId.DECIMAL128,
                TypeId.DECIMAL256, TypeId.DECIMAL32, TypeId.DECIMAL64)


def _concat_validity(datas: Sequence[ArrayData]) -> tuple:
    total = sum(d.length for d in datas)
    if all(d.null_count == 0 for d in datas):
        return None, 0
    mask = np.concatenate([np.ones(d.length, dtype=np.bool_)
                           if d.validity_mask() is None
                           else d.validity_mask() for d in datas])
    return Buffer(bitutil.pack_bits(mask)), int(total - mask.sum())


def concat_arrays(arrays: Sequence[Array], type: DataType = None) -> Array:
    datas = [a.data for a in arrays]
    if type is None:
        type = datas[0].type
    tid = type.id
    total = sum(d.length for d in datas)
    if tid == TypeId.NA:
        return Array(ArrayData(type, total, [], null_count=total))
    if tid == TypeId.BOOL:
        validity, nc = _concat_validity(datas)
        vals = np.concatenate([d.values() for d in datas]) if datas else \
            np.zeros(0, np.bool_)
        return Array(ArrayData(type, total,
                               [validity, Buffer(bitutil.pack_bits(vals))],
                               null_count=nc))
    if tid in _FIXED_BYTES:
        validity, nc = _concat_validity(datas)
        vals = np.concatenate([d.values().reshape(-1) for d in datas]) \
            if datas else np.zeros(0, np.uint8)
        return Array(ArrayData(type, total, [validity, Buffer(vals)],
                               null_count=nc))
    if tid in (TypeId.STRING, TypeId.BINARY, TypeId.LARGE_STRING,
               TypeId.LARGE_BINARY):
        validity, nc = _concat_validity(datas)
        off_dt = np.int32 if tid in (TypeId.STRING, TypeId.BINARY) \
            else np.int64
        parts, offs_all, pos = [], [np.zeros(1, dtype=off_dt)], 0
        for d in datas:
            offs = d.offsets().astype(np.int64)
            start, end = int(offs[0]), int(offs[-1])
            parts.append(d.data_bytes()[start:end])
            offs_all.append((offs[1:] - start + pos).astype(off_dt))
            pos += end - start
        data = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
        return Array(ArrayData(type, total,
                               [validity, Buffer(np.concatenate(offs_all)),
                                Buffer(data)], null_count=nc))
    if tid != TypeId.DICTIONARY and not type.is_nested:
        validity, nc = _concat_validity(datas)
        vals = np.concatenate([d.values() for d in datas]) if datas else \
            np.zeros(0, type.to_numpy_dtype())
        return Array(ArrayData(type, total, [validity, Buffer(vals)],
                               null_count=nc))
    vals: List = []
    for a in arrays:
        vals.extend(a.to_pylist())
    return array(vals, type)
