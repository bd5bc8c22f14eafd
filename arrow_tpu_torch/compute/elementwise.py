"""Element-wise kernels: arithmetic and comparisons (counterpart of
``arrow_tpu/compute/elementwise.py``).

Nulls follow the reference's intersection policy: the result is null where
any input is null. Numeric value lanes at null positions hold zeros, so
downstream reductions are deterministic.
"""

from __future__ import annotations

import operator
from typing import Optional

import torch

from ..device.column import DeviceColumn
from ..types import DataType, TypeId, bool_, from_torch_dtype
from .registry import register


def _require_numeric(name, *args):
    """Dictionary-coded (string) columns must not reach numeric kernels:
    codes are not values."""
    for x in args:
        if isinstance(x, DeviceColumn) and (
                x.dictionary is not None
                or x.type.id in (TypeId.STRING, TypeId.DICTIONARY)):
            raise NotImplementedError(
                f"{name}: not supported for {x.type!r} columns")


def _as_values(x):
    """DeviceColumn | Python scalar -> (values, validity)."""
    if isinstance(x, DeviceColumn):
        return x.values, x.validity
    return x, None


def _and_validity(*vs):
    out = None
    for v in vs:
        if v is not None:
            out = v if out is None else out & v
    return out


def _col(values: torch.Tensor, validity: Optional[torch.Tensor],
         type: Optional[DataType] = None) -> DeviceColumn:
    if type is None:
        type = from_torch_dtype(values.dtype)
    # zero the null lanes for deterministic downstream math
    if validity is not None and values.dtype != torch.bool:
        values = torch.where(validity, values, values.new_zeros(()))
    return DeviceColumn(values, validity, type)


def _arith_type(a, b) -> Optional[DataType]:
    cols = [x for x in (a, b) if isinstance(x, DeviceColumn)]
    if cols and all(c.type.is_temporal for c in cols):
        return cols[0].type
    return None


def _binary_arith(name: str, op):
    @register(name, "elementwise")
    def _fn(ctx, a, b):
        _require_numeric(name, a, b)
        av, avd = _as_values(a)
        bv, bvd = _as_values(b)
        return _col(op(av, bv), _and_validity(avd, bvd), _arith_type(a, b))
    return _fn


add = _binary_arith("add", operator.add)
subtract = _binary_arith("subtract", operator.sub)
multiply = _binary_arith("multiply", operator.mul)


def _compare(name: str, op):
    @register(name, "elementwise")
    def _fn(ctx, a, b):
        av, avd = _as_values(a)
        bv, bvd = _as_values(b)
        return _col(op(av, bv), _and_validity(avd, bvd), bool_())
    return _fn


equal = _compare("equal", operator.eq)
not_equal = _compare("not_equal", operator.ne)
less = _compare("less", operator.lt)
less_equal = _compare("less_equal", operator.le)
greater = _compare("greater", operator.gt)
greater_equal = _compare("greater_equal", operator.ge)
