"""Element-wise kernels: arithmetic, comparisons and boolean logic
(counterpart of ``arrow_tpu/compute/elementwise.py``).

Nulls follow the reference's intersection policy: the result is null where
any input is null. Numeric value lanes at null positions hold zeros, so
downstream reductions are deterministic. ``and_kleene`` and ``or_kleene``
(the ``&`` and ``|`` of expressions) follow Kleene logic instead: a valid
false decides an AND and a valid true an OR, null or not.
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


# --- boolean ----------------------------------------------------------------

def _bool_pair(a, b):
    """(a values, a validity, b values, b validity): bool tensors of one
    shape on one device; a literal broadcasts and has no validity."""
    av, avd = _as_values(a)
    bv, bvd = _as_values(b)
    dev = next((x.device for x in (av, bv) if isinstance(x, torch.Tensor)),
               None)
    av, bv = torch.broadcast_tensors(
        torch.as_tensor(av, device=dev).to(torch.bool),
        torch.as_tensor(bv, device=dev).to(torch.bool))
    return av, avd, bv, bvd


def _bool_col(values, validity) -> DeviceColumn:
    return DeviceColumn(values, validity, bool_())


@register("and", "elementwise")
def and_(ctx, a, b):
    """Intersection null policy: null where either side is null."""
    av, avd, bv, bvd = _bool_pair(a, b)
    return _bool_col(av & bv, _and_validity(avd, bvd))


@register("or", "elementwise")
def or_(ctx, a, b):
    av, avd, bv, bvd = _bool_pair(a, b)
    return _bool_col(av | bv, _and_validity(avd, bvd))


@register("invert", "elementwise")
def invert(ctx, a):
    av, avd = _as_values(a)
    return _bool_col(~av.to(torch.bool), avd)


def _valid(v: torch.Tensor, validity):
    return validity if validity is not None else torch.ones_like(v)


@register("and_kleene", "elementwise")
def and_kleene(ctx, a, b):
    """Kleene AND: false where either side is a valid false, else null
    where either side is null (``false & null`` is false)."""
    av, avd, bv, bvd = _bool_pair(a, b)
    a_valid, b_valid = _valid(av, avd), _valid(bv, bvd)
    any_false = (a_valid & ~av) | (b_valid & ~bv)
    out = ((av & a_valid) | ~a_valid) & ((bv & b_valid) | ~b_valid)
    return _bool_col(out & ~any_false, any_false | (a_valid & b_valid))


@register("or_kleene", "elementwise")
def or_kleene(ctx, a, b):
    """Kleene OR: true where either side is a valid true, else null where
    either side is null (``true | null`` is true)."""
    av, avd, bv, bvd = _bool_pair(a, b)
    a_valid, b_valid = _valid(av, avd), _valid(bv, bvd)
    any_true = (a_valid & av) | (b_valid & bv)
    return _bool_col(any_true, any_true | (a_valid & b_valid))
