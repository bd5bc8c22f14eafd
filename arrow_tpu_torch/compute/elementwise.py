"""Element-wise kernels: arithmetic, comparisons, boolean logic,
``if_else`` and ``cast`` (counterpart of
``arrow_tpu/compute/elementwise.py``).

Nulls follow the reference's intersection policy: the result is null where
any input is null. Numeric value lanes at null positions hold zeros, so
downstream reductions are deterministic. ``and_kleene`` and ``or_kleene``
(the ``&`` and ``|`` of expressions) follow Kleene logic instead: a valid
false decides an AND and a valid true an OR, null or not.

A Python or numpy literal takes numpy's dtype (``literal_tensor``: a
float is f64, an int int64), the dtype JAX gives it under the reference's
x64 setting. A Python literal, as a 0-d tensor, then promotes against a
column as a JAX weak type does (an int literal keeps an int32 column
int32, a float literal makes it f64). A numpy scalar literal is strongly
typed, as in JAX: the arithmetic and comparisons promote both operands by
the type lattice first (``torch.promote_types``, which is JAX's for these
types), so ``np.int64`` widens an int32 column and ``np.float64`` an f32
one.
"""

from __future__ import annotations

import operator
from typing import Optional

import numpy as np
import torch

from ..device.column import DeviceColumn, torch_dtype_for
from ..types import (DataType, TypeId, bool_, from_torch_dtype,
                     type_for_name)
from .registry import register


def literal_tensor(value, device) -> torch.Tensor:
    """A Python or numpy scalar as a 0-d tensor of numpy's dtype for it:
    float64 for a float, int64 for an int, bool for a bool."""
    arr = np.asarray(value)
    if arr.dtype.kind not in "biuf":
        raise NotImplementedError(
            f"no device literal for {type(value).__name__} values")
    return torch.from_numpy(arr).to(device)


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
         type: Optional[DataType] = None, dictionary=None) -> DeviceColumn:
    if type is None:
        type = from_torch_dtype(values.dtype)
    # zero the null lanes for deterministic downstream math
    if validity is not None and values.dtype != torch.bool:
        values = torch.where(validity, values, values.new_zeros(()))
    return DeviceColumn(values, validity, type, dictionary)


def _device_of(*args):
    return next(x.values.device for x in args if isinstance(x, DeviceColumn))


def _operand(x, device) -> torch.Tensor:
    """A column's values, or a literal as ``literal_tensor``."""
    return x.values if isinstance(x, DeviceColumn) \
        else literal_tensor(x, device)


def _operands(a, b, device):
    """Both operands' values; where one is a numpy scalar literal, both
    cast to their promoted dtype first."""
    av, bv = _operand(a, device), _operand(b, device)
    if isinstance(a, np.generic) or isinstance(b, np.generic):
        dt = torch.promote_types(av.dtype, bv.dtype)
        av, bv = av.to(dt), bv.to(dt)
    return av, bv


def _arith_type(a, b) -> Optional[DataType]:
    cols = [x for x in (a, b) if isinstance(x, DeviceColumn)]
    if cols and all(c.type.is_temporal for c in cols):
        return cols[0].type
    return None


def _validity_of(*args):
    return _and_validity(*(x.validity for x in args
                           if isinstance(x, DeviceColumn)))


def _binary_arith(name: str, op):
    @register(name, "elementwise")
    def _fn(ctx, a, b):
        _require_numeric(name, a, b)
        return _col(op(*_operands(a, b, _device_of(a, b))),
                    _validity_of(a, b), _arith_type(a, b))
    return _fn


add = _binary_arith("add", operator.add)
subtract = _binary_arith("subtract", operator.sub)
multiply = _binary_arith("multiply", operator.mul)


def _compare(name: str, op):
    @register(name, "elementwise")
    def _fn(ctx, a, b):
        return _col(op(*_operands(a, b, _device_of(a, b))),
                    _validity_of(a, b), bool_())
    return _fn


@register("divide", "elementwise")
def divide(ctx, a, b):
    """Integers divide truncating toward zero, ``sign(a) sign(b) (|a| //
    |b|)``, in their own dtype and type (a date32 column over an int is
    date32, as in the reference); an integer division by zero on a live
    row raises ZeroDivisionError: a literal zero divisor on the host, a
    column divisor by one read of a device flag. Floats divide as IEEE
    does."""
    _require_numeric("divide", a, b)
    av, bv = _operands(a, b, _device_of(a, b))
    validity = _validity_of(a, b)
    if av.dtype.is_floating_point or bv.dtype.is_floating_point:
        return _col(av / bv, validity, _arith_type(a, b))
    if isinstance(b, DeviceColumn):
        live = ctx.row_mask() if validity is None \
            else ctx.row_mask() & validity
        zero = bool(((bv == 0) & live).any())
    else:
        zero = b == 0
    if zero:
        raise ZeroDivisionError("divide by zero")
    safe_b = torch.where(bv == 0, torch.ones_like(bv), bv)
    out = torch.sign(av) * torch.sign(safe_b) \
        * (torch.abs(av) // torch.abs(safe_b))
    return _col(out, validity, _arith_type(a, b))


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


# --- conditional ------------------------------------------------------------

@register("if_else", "elementwise")
def if_else(ctx, cond, a, b):
    """``a`` where ``cond`` is true, else ``b``; null where ``cond`` is null
    or the chosen branch is. A non-numeric branch column (date32, a
    dictionary) gives its type and dictionary to the result; both branch
    dictionaries must be one."""
    dev = _device_of(cond, a, b)
    dicts = [x.dictionary for x in (a, b)
             if isinstance(x, DeviceColumn) and x.dictionary is not None]
    if dicts and (len(dicts) != 2 or dicts[0] != dicts[1]):
        raise NotImplementedError(
            "if_else over branches that do not share one dictionary is not "
            "ported yet (ROADMAP.md, queue 1, item 9: the long tail)")
    cv = _operand(cond, dev).to(torch.bool)
    av, bv = _operand(a, dev), _operand(b, dev)
    out = torch.where(cv, av, bv)
    avd, bvd = (x.validity if isinstance(x, DeviceColumn) else None
                for x in (a, b))
    branch_validity = None
    if avd is not None or bvd is not None:
        ones = torch.ones(out.shape, dtype=torch.bool, device=dev)
        branch_validity = torch.where(cv, ones if avd is None else avd,
                                      ones if bvd is None else bvd)
    cvd = cond.validity if isinstance(cond, DeviceColumn) else None
    t = next((x.type for x in (a, b) if isinstance(x, DeviceColumn)), None)
    return _col(out, _and_validity(cvd, branch_validity),
                t if t is not None and not t.is_numeric else None,
                dicts[0] if dicts else None)


# --- cast -------------------------------------------------------------------

@register("cast", "elementwise")
def cast(ctx, a, to_type=None, target_type=None, safe: bool = True):
    """Numeric to numeric or bool, and date32 to date32 or to and from
    integers. ``to_type`` or ``target_type`` is a DataType or a type name
    (``"float64"``). With ``safe``, a cast that loses data on a live row
    (a float with a fraction or out of range to an integer, an integer out
    of the target's range) raises ValueError, where the reference returns
    a deferred error. A dictionary-coded (string) column raises
    NotImplementedError: the reference parses its dictionary on the host
    (``_cast_parse_strings``)."""
    t = to_type if to_type is not None else target_type
    if t is None:
        raise ValueError("cast requires to_type")
    if isinstance(t, str):
        t = type_for_name(t)
    if not isinstance(a, DeviceColumn):
        raise NotImplementedError("cast of a literal is not ported yet "
                                  "(ROADMAP.md, queue 1, item 9: the long "
                                  "tail)")
    if a.dictionary is not None or t.id in (TypeId.STRING,
                                            TypeId.DICTIONARY):
        raise NotImplementedError(
            f"cast from {a.type!r} to {t!r} (the string tiers) is not "
            "ported yet (ROADMAP.md, queue 1, item 9: the long tail)")
    av = a.values
    if a.type.is_temporal and t.is_temporal:
        # date32 is the port's one temporal type: no unit to rescale
        return _col(av, a.validity, t)
    out = av.to(torch_dtype_for(t))
    if safe and t.id != TypeId.BOOL and not out.dtype.is_floating_point \
            and av.dtype != torch.bool:
        live = a.valid_mask(ctx.row_mask())
        if av.dtype.is_floating_point:
            whole = torch.trunc(av)
            bad = (av != whole) | (out.to(av.dtype) != whole)
        else:
            bad = out.to(av.dtype) != av
        if bool((bad & live).any()):
            raise ValueError(f"cast to {t!r} would lose data (use "
                             "safe=False to allow)")
    return _col(out, a.validity, t)
