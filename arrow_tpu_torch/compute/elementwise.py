"""Element-wise kernels: arithmetic and its ``_checked`` forms, the math
unaries, rounding, bit-wise functions and shifts, comparisons,
``between``, element-wise min and max, boolean logic, the null and float
predicates, ``if_else``, ``coalesce``, ``fill_null``, ``choose`` and
``cast`` (counterpart of ``arrow_tpu/compute/elementwise.py``).

Nulls follow the reference's intersection policy: the result is null where
any input is null. Numeric value lanes at null positions hold zeros, so
downstream reductions are deterministic. ``and_kleene``, ``or_kleene`` and
``and_not_kleene`` follow Kleene logic instead: a valid false decides an
AND and a valid true an OR, null or not.

Types follow JAX under x64, as the reference's ``jnp`` operations do: the
operands promote by JAX's lattice (``dtypes.promote``), a Python int or
float literal as a weak type (an int8 column plus 1 stays int8, a weak
int wraps to the width) and a numpy scalar as a strong one. Each operand
is loaded into its ``COMPUTE`` dtype (uint16 and uint32 widened, uint64
as its bits), the operation runs there, and the result is stored at its
own width, so integer arithmetic wraps as the reference's does.

Where the reference defers an error to an ``ErrGuard`` (the checked
arithmetic, an integer division by zero, a lossy safe cast, a string that
does not parse), the port raises at once: ArithmeticError,
ZeroDivisionError or ValueError. The other ``_checked`` names are aliases
of their plain forms, as in the reference.

``if_else`` and ``coalesce`` over dictionary columns with different
dictionaries re-encode them against their union first
(``unify_device_dicts``), as the reference's eager call does.
"""

from __future__ import annotations

import datetime
import operator
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import dtypes
from .. import types as T
from ..device.column import DeviceColumn
from ..types import DataType, TypeId, bool_, type_for_name
from .registry import ExecContext, register, register_alias


# --- operands -------------------------------------------------------------

def _require_numeric(name, *args):
    """Dictionary-coded (string) columns must not reach numeric kernels:
    codes are not values."""
    for x in args:
        if isinstance(x, DeviceColumn) and (
                x.dictionary is not None
                or x.type.id in (TypeId.STRING, TypeId.DICTIONARY)):
            raise NotImplementedError(
                f"{name}: not supported for {x.type!r} columns")


def _kind(x) -> str:
    """An operand's promotion kind: a column's value dtype, a literal's
    kind (``dtypes.literal_kind``), or the kind of a (kind, values) pair
    that an earlier step computed."""
    if isinstance(x, DeviceColumn):
        return x.value_dtype
    if isinstance(x, tuple):
        return x[0]
    return dtypes.literal_kind(x)


def _device_of(*args):
    return next(x.values.device for x in args if isinstance(x, DeviceColumn))


def _load(x, name: str, device) -> torch.Tensor:
    """An operand as ``COMPUTE`` values of dtype ``name``."""
    if isinstance(x, DeviceColumn):
        src = x.value_dtype
        return dtypes.convert(dtypes.load(x.values, src), src, name)
    if isinstance(x, tuple):
        return dtypes.convert(x[1], dtypes.promote(x[0]), name)
    return dtypes.literal(x, name, device)


def _promoted(*args, device=None) -> Tuple[str, list]:
    """The operands' promoted dtype and each operand loaded in it."""
    name = dtypes.promote(*(_kind(x) for x in args))
    dev = _device_of(*args) if device is None else device
    return name, [_load(x, name, dev) for x in args]


def literal_column(value, capacity: int, device) -> DeviceColumn:
    """A literal broadcast to ``capacity`` rows, in the dtype it takes
    alone (a Python float is f64, an int int64), as the reference's
    ``jnp.full`` under x64."""
    name = dtypes.literal_dtype(value)
    v = dtypes.literal(value, name, device).expand(capacity).clone()
    return DeviceColumn(dtypes.store(v, name), None,
                        dtypes.type_of_dtype(name))


def _and_validity(*vs):
    out = None
    for v in vs:
        if v is not None:
            out = v if out is None else out & v
    return out


def _validity_of(*args):
    return _and_validity(*(x.validity for x in args
                           if isinstance(x, DeviceColumn)))


def _col(values: torch.Tensor, validity: Optional[torch.Tensor],
         type: Optional[DataType] = None, dictionary=None,
         name: Optional[str] = None) -> DeviceColumn:
    """A result column. ``values`` are ``COMPUTE`` values of dtype
    ``name`` (default: the tensor's own dtype), stored at that dtype's
    width; ``type`` defaults to the dtype's logical type."""
    if name is None:
        name = dtypes.dtype_of_values(values)
    values = dtypes.store(values, name)
    if type is None:
        type = dtypes.type_of_dtype(name)
    # zero the null lanes for deterministic downstream math
    if validity is not None and values.dtype != torch.bool:
        values = torch.where(validity, values, values.new_zeros(()))
    return DeviceColumn(values, validity, type, dictionary)


def _is_decimal_col(x) -> bool:
    return isinstance(x, DeviceColumn) and x.type.is_decimal


def _arith_type(a, b=None, op: str = "add") -> Optional[DataType]:
    """The reference's decimal and temporal result rules
    (``elementwise.py`` ``_arith_type``): a decimal with a plain operand
    keeps its type (the operand acts on the unscaled value); two decimals
    add at one scale with a digit more, multiply at the sum of the
    scales; temporal operands keep the first one's type. None: the
    promoted dtype's type."""
    cols = [x for x in (a, b) if isinstance(x, DeviceColumn)]
    if not cols:
        return None
    dec = [c for c in cols if c.type.is_decimal]
    if dec:
        if len(dec) != len(cols):
            return dec[0].type
        s = [c.type.scale for c in dec]
        p = [c.type.precision for c in dec]
        if op in ("add", "subtract"):
            if len(dec) == 2 and s[0] != s[1]:
                raise ValueError(
                    f"decimal {op} requires equal scales, got {s}")
            return T.decimal128(min(max(p) + 1, 18), s[0])
        if op == "multiply":
            ss = sum(s) if len(dec) == 2 else s[0]
            pp = sum(p) + 1 if len(dec) == 2 else p[0]
            if ss > 18:
                raise ValueError(
                    "decimal multiply result scale exceeds device limit "
                    "18; cast to float64 first")
            return T.decimal128(min(pp, 18), ss)
        raise ValueError(
            f"decimal {op} not supported on device; cast to float64")
    if all(c.type.is_temporal for c in cols):
        return cols[0].type
    return None


def _check_dtype(fn: str, name: str, allowed: Sequence[str]):
    """JAX's dtype check of a ``jnp`` function: TypeError outside
    ``allowed`` (``"int"``, ``"float"``, ``"bool"``)."""
    kind = ("bool" if name == "bool" else "float" if dtypes.is_float(name)
            else "int")
    if kind not in allowed:
        raise TypeError(f"{fn} does not accept dtype {name}")


# --- arithmetic -------------------------------------------------------------

def _overflow_flags(dt: str, op: str, a, b, out) -> torch.Tensor:
    """The reference's checked-arithmetic overflow test in the promoted
    dtype, on results wrapped to its width: ``(b > 0 & out < a) | (b < 0
    & out > a)`` for add (the signs swapped for subtract), ``out // a !=
    b`` for multiply (a divisor of -1 negates, as XLA divides the signed
    minimum by -1)."""
    def wrap(x):
        return dtypes.load(dtypes.store(x, dt), dt)

    a, b, out = wrap(a), wrap(b), wrap(out)
    if op == "multiply":
        neg_one = (a == -1) if not dtypes.is_unsigned(dt) \
            else torch.zeros_like(a, dtype=torch.bool)
        safe = torch.where((a == 0) | neg_one, torch.ones_like(a), a)
        q = torch.where(neg_one, -out, _int_floordiv(out, safe, dt))
        return ~((a == 0) | (wrap(q) == b))
    a, b, out = (dtypes.order_key(x, dt) for x in (a, b, out))
    zero = dtypes.order_key(torch.zeros((), dtype=a.dtype,
                                        device=a.device), dt)
    if op == "add":
        return ((b > zero) & (out < a)) | ((b < zero) & (out > a))
    return ((b < zero) & (out < a)) | ((b > zero) & (out > a))


def _int_floordiv(a: torch.Tensor, b: torch.Tensor, name: str):
    """Floor division of ``COMPUTE`` integers (``b`` != 0)."""
    if name == "uint64":
        return dtypes.u64_floordiv(a, b)
    return a // b


_ARITH = {"add": operator.add, "subtract": operator.sub,
          "multiply": operator.mul}


def _arith(name: str, ctx, a, b, checked: bool):
    _require_numeric(name, a, b)
    kinds = (_kind(a), _kind(b))
    dt, (av, bv) = _promoted(a, b)
    if dt == "bool" and name == "subtract":
        raise TypeError("subtract does not accept dtype bool")
    if name == "multiply" and dt != "bool" and "bool" in kinds:
        # jnp.multiply by a bool selects: false gives 0 even against an
        # infinity or NaN
        flag, other = (av, bv) if kinds[0] == "bool" else (bv, av)
        out = torch.where(flag != 0, other, torch.zeros_like(other))
    else:
        out = _ARITH[name](av, bv)
    validity = _validity_of(a, b)
    if checked and dtypes.is_integer(dt):
        bad = _overflow_flags(dt, name, av, bv, out)
        live = ctx.row_mask() if validity is None \
            else ctx.row_mask() & validity
        if bool((bad & live).any()):
            raise ArithmeticError(
                f"overflow / domain error in {name}_checked")
    return _col(out, validity, _arith_type(a, b, name), name=dt)


def _binary_arith(name: str):
    @register(name, "elementwise")
    def _fn(ctx, a, b):
        return _arith(name, ctx, a, b, False)

    @register(name + "_checked", "elementwise")
    def _fn_checked(ctx, a, b):
        """Raises ArithmeticError where an integer result overflows on a
        live row (the reference defers it to an ErrGuard)."""
        return _arith(name, ctx, a, b, True)
    return _fn, _fn_checked


add, add_checked = _binary_arith("add")
subtract, subtract_checked = _binary_arith("subtract")
multiply, multiply_checked = _binary_arith("multiply")


@register("divide", "elementwise")
def divide(ctx, a, b):
    """Integers divide truncating toward zero, ``sign(a) sign(b) (|a| //
    |b|)``, in their promoted dtype (uint64 unsigned); the type follows
    ``_arith_type`` (a date32 column over an int is date32, as in the
    reference). An integer division by zero on a live row raises
    ZeroDivisionError: a literal zero divisor on the host, a column
    divisor by one read of a device flag. Floats divide as IEEE does;
    decimals raise ValueError, as in the reference."""
    _require_numeric("divide", a, b)
    if _is_decimal_col(a) or _is_decimal_col(b):
        raise ValueError(
            "decimal divide not supported on device; cast to float64")
    ka, kb = _kind(a), _kind(b)
    dt, (av, bv) = _promoted(a, b)
    dev = _device_of(a, b)
    validity = _validity_of(a, b)
    ints = all(k == dtypes.WEAK_INT or dtypes.is_integer(k)
               for k in (ka, kb))
    if not ints:
        # true division: the promoted kind's float (two bools: f32)
        dt = _inexact(ka, kb)
        av, bv = _load(a, dt, dev), _load(b, dt, dev)
        return _col(av / bv, validity, _arith_type(a, b), name=dt)
    if isinstance(b, DeviceColumn):
        live = ctx.row_mask() if validity is None \
            else ctx.row_mask() & validity
        zero = bool(((bv == 0) & live).any())
    else:
        zero = b == 0
    if zero:
        raise ZeroDivisionError("divide by zero")
    safe_b = torch.where(bv == 0, torch.ones_like(bv), bv)
    if dt == "uint64":
        out = dtypes.u64_floordiv(av, safe_b)
    elif dtypes.is_float(dt):
        # int64 with uint64: the sign-magnitude division runs in f64
        out = torch.sign(av) * torch.sign(safe_b) \
            * torch.floor_divide(torch.abs(av), torch.abs(safe_b))
    else:
        out = torch.sign(av) * torch.sign(safe_b) \
            * (torch.abs(av) // torch.abs(safe_b))
    return _col(out, validity, _arith_type(a, b), name=dt)


register_alias("divide_checked", "divide")


@register("negate", "elementwise")
def negate(ctx, a):
    """In the value's own dtype (unsigned values wrap); a decimal keeps
    its type with a digit more, as ``_arith_type`` gives it."""
    dt = _kind(a)
    _check_dtype("neg", dt, ("int", "float"))
    av = _load(a, dt, _device_of(a))
    return _col(-av, _validity_of(a), _arith_type(a), name=dt)


register_alias("negate_checked", "negate")


def _unary(name: str, op: Callable, float_only: bool = False,
           accepts: Sequence[str] = ("int", "float"),
           wide: bool = False, keeps_bool: bool = False):
    """A unary in the value's dtype. ``float_only``: integers (decimals'
    unscaled values too) convert to f64 first and bool to f32, as the
    reference and ``jnp`` promote them (``keeps_bool``: bool comes back
    as it is); the result is typed by its dtype. ``wide``: f16 and f32
    compute in f64 and round once."""
    @register(name, "elementwise")
    def _fn(ctx, a):
        _require_numeric(name, a)
        dt = _kind(a)
        av = _load(a, dt, _device_of(a))
        if float_only and dt == "bool":
            if keeps_bool:
                return _col(av, _validity_of(a), name=dt)
            dt, av = "float32", av.to(torch.float32)
        elif float_only and not dtypes.is_float(dt):
            av = dtypes.convert(av, dt, "float64")
            dt = "float64"
        else:
            _check_dtype(name, dt, accepts)
        if wide and dt != "float64":
            out = op(av.to(torch.float64), "float64").to(av.dtype)
        else:
            out = op(av, dt)
        return _col(out, _validity_of(a), name=dt)
    return _fn


def _abs(v, dt):
    return v if dt == "bool" or dtypes.is_unsigned(dt) else torch.abs(v)


def _sign(v, dt):
    """-1, 0 or 1; a float's NaN and signed zero come back as they are,
    as ``jnp.sign`` gives them."""
    if dtypes.is_unsigned(dt):
        return (v != 0).to(v.dtype)
    if not dtypes.is_float(dt):
        return torch.sign(v)
    one = torch.ones((), dtype=v.dtype, device=v.device)
    return torch.where(v > 0, one, torch.where(v < 0, -one, v))


_unary("abs", _abs, accepts=("int", "float", "bool"))
register_alias("abs_checked", "abs")
_unary("sign", _sign)

_FLOAT_UNARIES = (
    ("sqrt", torch.sqrt, True), ("exp", torch.exp, False),
    ("expm1", torch.expm1, False), ("ln", torch.log, True),
    ("log2", torch.log2, True), ("log10", torch.log10, True),
    ("log1p", torch.log1p, True), ("sin", torch.sin, True),
    ("cos", torch.cos, True), ("tan", torch.tan, True),
    ("asin", torch.asin, True), ("acos", torch.acos, True),
    ("atan", torch.atan, False), ("sinh", torch.sinh, False),
    ("cosh", torch.cosh, False), ("tanh", torch.tanh, False),
    ("asinh", torch.asinh, False), ("acosh", torch.acosh, True),
    ("atanh", torch.atanh, True))
for _name, _op, _alias in _FLOAT_UNARIES:
    _unary(_name, lambda v, dt, _op=_op: _op(v), float_only=True,
           wide=True)
    if _alias:
        register_alias(_name + "_checked", _name)

_unary("floor", lambda v, dt: torch.floor(v), float_only=True,
       keeps_bool=True)
_unary("ceil", lambda v, dt: torch.ceil(v), float_only=True,
       keeps_bool=True)
_unary("trunc", lambda v, dt: torch.trunc(v), float_only=True,
       keeps_bool=True)


def _float_kind(x) -> str:
    """An operand's kind once the reference converts integers (weak or
    strong, not bool) to f64."""
    k = _kind(x)
    return "float64" if k == dtypes.WEAK_INT or dtypes.is_integer(k) else k


def _inexact(*kinds) -> str:
    """The dtype a ``jnp`` float function computes in over these kinds."""
    return dtypes.promote(dtypes.to_inexact(dtypes.lub(*kinds)))


def _wide(fn: Callable, *xs: torch.Tensor) -> torch.Tensor:
    """``fn`` of f16 or f32 values computed in f64, rounded once."""
    if xs[0].dtype == torch.float64:
        return fn(*xs)
    return fn(*(x.to(torch.float64) for x in xs)).to(xs[0].dtype)


@register("atan2", "elementwise")
def atan2(ctx, y, x):
    dt = _inexact(_float_kind(y), _float_kind(x))
    dev = _device_of(y, x)
    yv, xv = _load(y, dt, dev), _load(x, dt, dev)
    return _col(_wide(torch.atan2, yv, xv), _validity_of(y, x), name=dt)


@register("logb", "elementwise")
def logb(ctx, a, b):
    """``log(a) / log(b)``, each log in its operand's own float dtype
    (integers as f64), then divided at their promoted dtype."""
    dev = _device_of(a, b)
    kinds, logs = [], []
    for x in (a, b):
        k = dtypes.to_inexact(_float_kind(x))
        dt = dtypes.promote(k)
        logs.append(_wide(torch.log, _load(x, dt, dev)))
        kinds.append(k)
    dt = _inexact(*kinds)
    la, lb = (dtypes.convert(v, dtypes.promote(k), dt)
              for v, k in zip(logs, kinds))
    return _col(la / lb, _validity_of(a, b), name=dt)


register_alias("logb_checked", "logb")


def _pow_int(x1: torch.Tensor, x2: torch.Tensor, dt: str) -> torch.Tensor:
    """``jnp.power`` of integers: six rounds of binary exponentiation
    (``_pow_int_int``), wrapping at the width; the exponent shifts
    logically."""
    width = dtypes.bits(dt)
    logical = (1 << (width - 1)) - 1
    acc = torch.where((x1 == 0) & (x2 != 0), 0, 1).to(x1.dtype)
    for _ in range(6):
        acc = torch.where((x2 & 1) != 0, acc * x1, acc)
        x1 = x1 * x1
        x2 = (x2 >> 1) & logical
    return acc


def _integer_pow(x: torch.Tensor, n: int) -> torch.Tensor:
    """``lax.integer_pow``: binary exponentiation by a constant, each
    product rounded in the dtype; a negative power divides 1 by it (an
    integer division for integers)."""
    if n == 0:
        return torch.ones_like(x)
    m, acc = abs(n), None
    while m > 0:
        if m & 1:
            acc = x if acc is None else acc * x
        m >>= 1
        if m > 0:
            x = x * x
    if n > 0:
        return acc
    if acc.dtype.is_floating_point:
        return torch.ones_like(acc) / acc
    # 1 // acc truncating: 1 and -1 keep themselves, 0 gives XLA's -1
    return torch.where((acc == 1) | (acc == -1) | (acc == 0),
                       torch.where(acc == 0, -1, acc), 0).to(acc.dtype)


def _numeric(kind: str) -> str:
    """``to_numeric_dtype``: a bool result computes as int32."""
    name = dtypes.promote(kind)
    return "int32" if name == "bool" else name


@register("power", "elementwise")
def power(ctx, a, b):
    """``jnp.power``: an integer literal exponent is a constant power of
    the base in its own dtype (``_integer_pow``); integers (and bools, as
    int32) by six rounds of binary exponentiation (``_pow_int``); a float
    base with an integer exponent keeps the base's dtype; otherwise the
    promoted float."""
    ka, kb = _kind(a), _kind(b)
    dev = _device_of(a, b)
    validity = _validity_of(a, b)
    if not isinstance(b, DeviceColumn) and (
            kb == dtypes.WEAK_INT or dtypes.is_integer(kb) or kb == "bool"):
        dt = _numeric(ka)
        return _col(_integer_pow(_load(a, dt, dev), int(b)), validity,
                    name=dt)
    dt = _numeric(dtypes.lub(ka, kb))
    if not dtypes.is_float(dt):
        av, bv = _load(a, dt, dev), _load(b, dt, dev)
        return _col(_pow_int(av, bv, dt), validity, name=dt)
    base = dtypes.promote(ka)
    if dtypes.is_float(base) and dtypes.is_integer(kb):
        av = _load(a, base, dev)
        return _col(_wide(torch.pow, av, _load(b, base, dev)), validity,
                    name=base)
    av, bv = _load(a, dt, dev), _load(b, dt, dev)
    return _col(_wide(torch.pow, av, bv), validity, name=dt)


register_alias("power_checked", "power")


# --- bit-wise ---------------------------------------------------------------

def _bitwise(name: str, op: Callable, numeric: bool = False):
    """``numeric``: a bool result computes as int32 (the shifts)."""
    @register(name, "elementwise")
    def _fn(ctx, a, b):
        _require_numeric(name, a, b)
        dt = dtypes.promote(_kind(a), _kind(b))
        _check_dtype(name, dt, ("int", "bool"))
        if numeric and dt == "bool":
            dt = "int32"
        dev = _device_of(a, b)
        av, bv = _load(a, dt, dev), _load(b, dt, dev)
        return _col(op(av, bv, dt), _validity_of(a, b),
                    _arith_type(a, b, name), name=dt)
    return _fn


def _shift_left(a, s, dt):
    big = (s < 0) | (s >= dtypes.bits(dt))
    out = a << torch.where(big, torch.zeros_like(s), s)
    return torch.where(big, torch.zeros_like(out), out)


def _shift_right(a, s, dt):
    """Arithmetic for signed values, logical for unsigned; a shift of
    the width or more (or negative) gives the sign fill or 0, as XLA's
    shifts do."""
    width = dtypes.bits(dt)
    big = (s < 0) | (s >= width)
    s0 = torch.where(big, torch.zeros_like(s), s)
    out = a >> s0
    if dt == "uint64":
        # logical: clear the sign-extended high bits
        keep = torch.where(s0 == 0, -1, (1 << (64 - s0)) - 1)
        out = out & keep
    fill = torch.where(a < 0, -1, 0).to(out.dtype) \
        if dtypes.is_integer(dt) and not dtypes.is_unsigned(dt) \
        else torch.zeros_like(out)
    return torch.where(big, fill, out)


_unary("bit_wise_not", lambda v, dt: ~v, accepts=("int", "bool"))
_bitwise("bit_wise_and", lambda a, b, dt: a & b)
_bitwise("bit_wise_or", lambda a, b, dt: a | b)
_bitwise("bit_wise_xor", lambda a, b, dt: a ^ b)
_bitwise("shift_left", _shift_left, numeric=True)
register_alias("shift_left_checked", "shift_left")
_bitwise("shift_right", _shift_right, numeric=True)
register_alias("shift_right_checked", "shift_right")


# --- rounding ---------------------------------------------------------------

def _round_values(v: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "half_to_even":
        return torch.round(v)
    if mode == "down":
        return torch.floor(v)
    if mode == "up":
        return torch.ceil(v)
    if mode == "towards_zero":
        return torch.trunc(v)
    if mode == "towards_infinity":
        return torch.where(v >= 0, torch.ceil(v), torch.floor(v))
    if mode == "half_down":
        return torch.ceil(v - 0.5)
    if mode == "half_up":
        return torch.floor(v + 0.5)
    if mode == "half_towards_zero":
        return torch.where(v >= 0, torch.ceil(v - 0.5), torch.floor(v + 0.5))
    if mode == "half_towards_infinity":
        return torch.where(v >= 0, torch.floor(v + 0.5), torch.ceil(v - 0.5))
    if mode == "half_to_odd":
        r = torch.round(v)
        t = torch.trunc(v)
        half = torch.abs(v - t) == 0.5
        even = torch.remainder(t, 2) == 0
        step = torch.where(v >= 0, torch.where(even, 1.0, 0.0),
                           torch.where(even, -1.0, 0.0)).to(v.dtype)
        return torch.where(half, t + step, r)
    raise ValueError(f"unknown round mode {mode!r}")


@register("round", "elementwise")
def round_(ctx, a, ndigits: int = 0, round_mode: str = "half_to_even"):
    """Integers (a decimal's unscaled values too) come back as they are,
    with their type; floats round in their own dtype, at ``ndigits`` by
    ``round(v * 10**n) / 10**n``."""
    dt = _kind(a)
    av = _load(a, dt, _device_of(a))
    if dtypes.is_integer(dt):
        return _col(av, _validity_of(a), a.type, name=dt)
    if dt == "bool":
        raise ValueError("round: data type bool not inexact")
    if ndigits == 0:
        return _col(_round_values(av, round_mode), _validity_of(a), name=dt)
    scale = 10.0 ** ndigits
    out = _round_values(av * scale, round_mode) / torch.tensor(
        scale, dtype=av.dtype, device=av.device)
    return _col(out, _validity_of(a), name=dt)


@register("round_to_multiple", "elementwise")
def round_to_multiple(ctx, a, multiple: float = 1.0,
                      round_mode: str = "half_to_even"):
    dt = _kind(a)
    av = _load(a, dt, _device_of(a))
    if not dtypes.is_float(dt):
        av, dt = dtypes.convert(av, dt, "float64"), "float64"
    out = _round_values(av / multiple, round_mode) * multiple
    return _col(out, _validity_of(a), name=dt)


# --- comparison -------------------------------------------------------------

def compare_values(op: Callable, a, b, device=None) -> torch.Tensor:
    """``op`` over both operands promoted (uint64 by unsigned order)."""
    dt, (av, bv) = _promoted(a, b, device=device)
    return op(dtypes.order_key(av, dt), dtypes.order_key(bv, dt))


def _compare(name: str, op: Callable):
    @register(name, "elementwise")
    def _fn(ctx, a, b):
        return _col(compare_values(op, a, b), _validity_of(a, b), bool_())
    return _fn


equal = _compare("equal", operator.eq)
not_equal = _compare("not_equal", operator.ne)
less = _compare("less", operator.lt)
less_equal = _compare("less_equal", operator.le)
greater = _compare("greater", operator.gt)
greater_equal = _compare("greater_equal", operator.ge)


@register("between", "elementwise")
def between(ctx, x, low, high, inclusive: str = "both"):
    lo = compare_values(operator.le if inclusive in ("both", "left")
                        else operator.lt, low, x)
    hi = compare_values(operator.le if inclusive in ("both", "right")
                        else operator.lt, x, high)
    return _col(lo & hi, _validity_of(x, low, high), bool_())


def _shared_dictionary(*args):
    return next((x.dictionary for x in args if isinstance(x, DeviceColumn)
                 and x.dictionary is not None), None)


def _select(cond: torch.Tensor, a, b, dev):
    """``jnp.where(cond, a, b)`` over operands or (kind, values) pairs:
    the (kind, ``COMPUTE`` values) pair of the result."""
    kind = dtypes.lub(_kind(a), _kind(b))
    name = dtypes.promote(kind)
    return kind, torch.where(cond, _load(a, name, dev), _load(b, name, dev))


def _minmax_elementwise(name: str, op: Callable):
    @register(name, "elementwise")
    def _fn(ctx, *args, skip_nulls: bool = True):
        """Values promote pairwise as ``jnp.where`` does; with
        ``skip_nulls`` a null loses to a value, else it nulls the
        row."""
        args = unify_device_dicts(list(args))
        dev = _device_of(*args)
        first = args[0]
        out = (_kind(first), _load(first, dtypes.promote(_kind(first)),
                                   dev))
        out_d = _validity_of(first)
        for x in args[1:]:
            d = _validity_of(x)
            better = compare_values(op, x, out, dev)
            if skip_nulls:
                take_b = better
                if d is not None:
                    take_b = take_b & d
                if out_d is not None:
                    take_b = take_b | ~out_d
                    if d is not None:
                        take_b = take_b & (d | out_d)
                new_d = None
                if out_d is not None or d is not None:
                    ones = torch.ones_like(take_b)
                    new_d = (out_d if out_d is not None else ones) | \
                        (d if d is not None else ones)
                out, out_d = _select(take_b, x, out, dev), new_d
            else:
                out = _select(better, x, out, dev)
                out_d = _and_validity(out_d, d)
        t = next((a.type for a in args if isinstance(a, DeviceColumn)),
                 None)
        dictionary = _shared_dictionary(*args)
        return _col(out[1], out_d,
                    t if t and (t.is_temporal or dictionary is not None)
                    else None, dictionary, name=dtypes.promote(out[0]))
    return _fn


min_element_wise = _minmax_elementwise("min_element_wise", operator.lt)
max_element_wise = _minmax_elementwise("max_element_wise", operator.gt)


# --- boolean ----------------------------------------------------------------

def _bool_pair(a, b):
    """(a values, a validity, b values, b validity): bool tensors of one
    shape on one device; a literal broadcasts and has no validity."""
    vals = []
    for x in (a, b):
        vals.append(x.values if isinstance(x, DeviceColumn) else x)
    dev = next((v.device for v in vals if isinstance(v, torch.Tensor)),
               None)
    av, bv = torch.broadcast_tensors(
        *(torch.as_tensor(v, device=dev).to(torch.bool) for v in vals))
    avd, bvd = (x.validity if isinstance(x, DeviceColumn) else None
                for x in (a, b))
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


@register("xor", "elementwise")
def xor(ctx, a, b):
    av, avd, bv, bvd = _bool_pair(a, b)
    return _bool_col(av ^ bv, _and_validity(avd, bvd))


@register("and_not", "elementwise")
def and_not(ctx, a, b):
    av, avd, bv, bvd = _bool_pair(a, b)
    return _bool_col(av & ~bv, _and_validity(avd, bvd))


@register("invert", "elementwise")
def invert(ctx, a):
    av = a.values if isinstance(a, DeviceColumn) else torch.as_tensor(a)
    return _bool_col(~av.to(torch.bool), _validity_of(a))


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


@register("and_not_kleene", "elementwise")
def and_not_kleene(ctx, a, b):
    return and_kleene(ctx, a, invert(ctx, b))


# --- validity and float predicates -------------------------------------------

def _values_of(a) -> torch.Tensor:
    return a.values if isinstance(a, DeviceColumn) else torch.as_tensor(a)


@register("is_null", "elementwise")
def is_null(ctx, a, nan_is_null: bool = False):
    av, avd = _values_of(a), _validity_of(a)
    out = torch.zeros(av.shape, dtype=torch.bool, device=av.device) \
        if avd is None else ~avd
    if nan_is_null and av.dtype.is_floating_point:
        out = out | torch.isnan(av)
    return _bool_col(out, None)


@register("is_valid", "elementwise")
def is_valid(ctx, a):
    av, avd = _values_of(a), _validity_of(a)
    out = torch.ones(av.shape, dtype=torch.bool, device=av.device) \
        if avd is None else avd
    return _bool_col(out, None)


def _float_predicate(name: str, op: Callable, otherwise: bool):
    @register(name, "elementwise")
    def _fn(ctx, a):
        """``otherwise`` for integer and bool values."""
        av = _values_of(a)
        out = op(av) if av.dtype.is_floating_point else torch.full(
            av.shape, otherwise, dtype=torch.bool, device=av.device)
        return _bool_col(out, _validity_of(a))
    return _fn


is_nan = _float_predicate("is_nan", torch.isnan, False)
is_finite = _float_predicate("is_finite", torch.isfinite, True)
is_inf = _float_predicate("is_inf", torch.isinf, False)


@register("true_unless_null", "elementwise")
def true_unless_null(ctx, a):
    av = _values_of(a)
    return _bool_col(torch.ones(av.shape, dtype=torch.bool,
                                device=av.device), _validity_of(a))


# --- conditional ------------------------------------------------------------

def _branch_type(*args) -> Optional[DataType]:
    """The first column's type where it is not numeric (a date, a
    decimal, a dictionary), else None: the promoted dtype's."""
    t = next((x.type for x in args if isinstance(x, DeviceColumn)), None)
    return t if t is not None and not t.is_numeric else None


@register("if_else", "elementwise")
def if_else(ctx, cond, a, b):
    """``a`` where ``cond`` is true, else ``b``, promoted as
    ``jnp.where``; null where ``cond`` is null or the chosen branch is. A
    non-numeric first branch column (a date, a decimal, a dictionary)
    gives its type and dictionary to the result; two branch dictionaries
    that differ are re-encoded against their union first."""
    dev = _device_of(cond, a, b)
    a, b = one_dictionary([a, b])
    cv = _load(cond, "bool", dev)
    kind, out = _select(cv, a, b, dev)
    avd, bvd = (x.validity if isinstance(x, DeviceColumn) else None
                for x in (a, b))
    branch_validity = None
    if avd is not None or bvd is not None:
        ones = torch.ones(out.shape, dtype=torch.bool, device=dev)
        branch_validity = torch.where(cv, ones if avd is None else avd,
                                      ones if bvd is None else bvd)
    return _col(out, _and_validity(_validity_of(cond), branch_validity),
                _branch_type(a, b), _shared_dictionary(a, b),
                name=dtypes.promote(kind))


@register("coalesce", "elementwise")
def coalesce(ctx, *args):
    """The first valid value of the arguments, promoted as ``jnp.where``
    promotes them; dictionaries that differ are re-encoded against their
    union first. A first argument without nulls comes back typed by its
    dtype, as in the reference, but a dictionary column, which comes back
    as itself (Arrow's answer; the reference gives its codes as int32)."""
    first = args[0]
    if isinstance(first, DeviceColumn) and first.dictionary is not None \
            and first.validity is None:
        return first
    args = one_dictionary(list(args))
    first = args[0]
    dev = _device_of(*args)
    kind = _kind(first)
    out_v = _load(first, dtypes.promote(kind), dev)
    out_d = _validity_of(first)
    if out_d is None:
        return _col(out_v, None, name=dtypes.promote(kind))
    for x in args[1:]:
        need = ~out_d
        kind, out_v = _select(need, x, (kind, out_v), dev)
        xd = _validity_of(x)
        out_d = out_d | (need & (xd if xd is not None
                                 else torch.ones_like(out_d)))
    return _col(out_v, out_d, _branch_type(*args), _shared_dictionary(*args),
                name=dtypes.promote(kind))


@register("fill_null", "elementwise")
def fill_null(ctx, a, fill_value):
    return coalesce(ctx, a, fill_value)


def _gather_fill(name: str):
    """``jnp.take_along_axis``'s fill for an index out of range: NaN, the
    signed minimum, the unsigned maximum, or True."""
    if dtypes.is_float(name):
        return float("nan")
    if name == "bool":
        return True
    if name == "uint64":
        return -1
    lo, hi = dtypes.int_range(name)
    return hi if dtypes.is_unsigned(name) else lo


@register("choose", "elementwise")
def choose(ctx, indices, *cases):
    """The value of case ``indices[i]`` at each row (a negative index
    counts from the end; one out of range gives ``_gather_fill``); null
    where the index or the chosen case is null."""
    dev = _device_of(indices, *cases)
    name, vals = _promoted(*cases, device=dev)
    n = len(cases)
    cap = indices.values.shape[0]
    stacked = torch.stack([v.expand(cap) for v in vals])
    iv = _load(indices, dtypes.promote(_kind(indices)), dev).long()
    iv = torch.where(iv < 0, iv + n, iv)
    inside = (iv >= 0) & (iv < n)
    safe = torch.where(inside, iv, 0)
    out = torch.gather(stacked, 0, safe[None, :])[0]
    fill = torch.tensor(_gather_fill(name), device=dev).to(out.dtype)
    out = torch.where(inside, out, fill)
    validity = _validity_of(indices)
    case_valid = [c.validity if isinstance(c, DeviceColumn) else None
                  for c in cases]
    if any(v is not None for v in case_valid):
        ones = torch.ones(cap, dtype=torch.bool, device=dev)
        vm = torch.stack([v if v is not None else ones for v in case_valid])
        sel = torch.gather(vm, 0, safe[None, :])[0] | ~inside
        validity = _and_validity(validity, sel)
    return _col(out, validity, name=name)


# --- dictionaries -----------------------------------------------------------

def unify_device_dicts(prepared: list) -> list:
    """Two or more dictionary-coded columns re-encoded against their
    sorted union dictionary, so codes are order-preserving ranks
    (counterpart of ``arrow_tpu/compute/dispatch.py``
    ``unify_device_dicts``): host work on the dictionaries, one gather per
    column on the device."""
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
        mapping = torch.tensor([rank.get(v, 0) for v in col.dictionary],
                               dtype=torch.int32,
                               device=col.values.device)
        codes = mapping[col.values.long().clamp(0, len(col.dictionary) - 1)]
        out[i] = DeviceColumn(codes, col.validity, col.type, union)
    return out


def one_dictionary(args: list) -> list:
    """``args`` with one dictionary among their dictionary columns: as
    they are where the dictionaries are equal, else re-encoded against
    their union (``unify_device_dicts``)."""
    dicts = [x.dictionary for x in args
             if isinstance(x, DeviceColumn) and x.dictionary is not None]
    if all(d == dicts[0] for d in dicts[1:]):
        return args
    return unify_device_dicts(args)


# --- cast -------------------------------------------------------------------

_UNIT_NS = {"day": 86_400_000_000_000, "s": 1_000_000_000, "ms": 1_000_000,
            "us": 1000, "ns": 1}


def _unit_of(t: DataType) -> str:
    if t.id == TypeId.DATE32:
        return "day"
    if t.id == TypeId.DATE64:
        return "ms"
    return t.unit


def temporal_rescale(v: torch.Tensor, src: DataType,
                     dst: DataType) -> torch.Tensor:
    """Stored temporal values of ``src`` in ``dst``'s unit, in int64: a
    finer unit multiplies, a coarser one floor-divides (reference:
    ``_temporal_rescale``)."""
    s, d = _UNIT_NS[_unit_of(src)], _UNIT_NS[_unit_of(dst)]
    v = v.to(torch.int64)
    if s > d:
        return v * (s // d)
    if s < d:
        return torch.div(v, d // s, rounding_mode="floor")
    return v


@register("cast", "elementwise")
def cast(ctx, a, to_type=None, target_type=None, safe: bool = True):
    """``astype`` to the target's value dtype, as in the reference: no
    rescale to or from a decimal (the unscaled values convert), temporal
    to temporal through ``temporal_rescale`` (no safe check), to bool as
    ``!= 0``. ``to_type`` or ``target_type`` is a DataType or a type name
    (``"float64"``). With ``safe``, a float to integer cast of a live row
    with a fraction or out of range, and an integer to integer cast that
    does not convert back to the same value, raise ValueError, where the
    reference returns a deferred error. A dictionary (string) column
    parses its dictionary (``_cast_strings``); a literal casts as the
    reference's ``jnp.asarray`` of it does, to a 0-d column."""
    t = to_type if to_type is not None else target_type
    if t is None:
        raise ValueError("cast requires to_type")
    if isinstance(t, str):
        t = type_for_name(t)
    if not isinstance(a, DeviceColumn):
        return _cast_literal(ctx, a, t, safe)
    if t.id in (TypeId.STRING, TypeId.DICTIONARY):
        if a.dictionary is not None:
            return a
        # the reference's plan gives codes with no dictionary, which its
        # download refuses with this message; an eager cast of a host
        # Array formats on the host (registry._cast_to_string_host)
        raise ValueError("string column missing dictionary")
    if a.dictionary is not None:
        return _cast_strings(ctx, a, t, safe)
    if t.is_decimal and t.precision > 18:
        raise ValueError(
            f"cast to {t!r} in a plan: a decimal wider than 18 digits is "
            "codes over a dictionary on the device; cast the host Array "
            "(compute.cast, decimal_host)")
    if a.type.is_temporal and t.is_temporal:
        return _col(temporal_rescale(a.values, a.type, t), a.validity, t,
                    name=dtypes.dtype_of_type(t))
    src = a.value_dtype
    dst = dtypes.dtype_of_type(t)
    av = dtypes.load(a.values, src)
    out = dtypes.convert(av, src, dst)
    if safe and dst != "bool" and src != "bool" \
            and dtypes.is_integer(dst):
        back = dtypes.convert(out, dst, src)
        if dtypes.is_float(src):
            whole = torch.trunc(av)
            bad = (av != whole) | (back != whole)
        else:
            bad = back != av
        if bool((bad & a.valid_mask(ctx.row_mask())).any()):
            raise ValueError(f"cast to {t!r} would lose data (use "
                             "safe=False to allow)")
    return _col(out, a.validity, t, name=dst)


def _cast_literal(ctx, x, t: DataType, safe: bool) -> DeviceColumn:
    """A Python or numpy literal in the dtype ``jnp.asarray`` gives it,
    cast as a one-row column: a 0-d column of type ``t``, which
    broadcasts against the columns it meets."""
    if isinstance(x, (str, bytes)):
        raise TypeError(f"cast of the string literal {x!r}: a device "
                        "literal is a number, as in the reference")
    src = dtypes.literal_dtype(x)
    dev = ctx.row_count.device
    one = DeviceColumn(dtypes.store(dtypes.literal(x, src, dev), src)
                       .reshape(1), None, dtypes.type_of_dtype(src))
    r = cast(ExecContext(1, torch.ones((), dtype=torch.int32, device=dev)),
             one, to_type=t, safe=safe)
    return DeviceColumn(r.values[0], None, r.type)


# the reference's units of a parsed timestamp (``_UNIT_US``, ``_UNIT_US_INV``)
_US_PER_UNIT = {"s": 1_000_000, "ms": 1000, "us": 1, "ns": 1}
_UNITS_PER_US = {"s": 1, "ms": 1, "us": 1, "ns": 1000}
_EPOCH_ORDINAL = datetime.date(1970, 1, 1).toordinal()


def _parse_one(v: str, t: DataType):
    """One string as the Python value of ``t``, by the reference's rules
    (``arrow_tpu/compute/elementwise.py`` ``_parse_one``); ValueError where
    it does not parse."""
    s = v.strip()
    if t.id == TypeId.BOOL:
        lv = s.lower()
        if lv in ("true", "1", "t", "yes"):
            return True
        if lv in ("false", "0", "f", "no"):
            return False
        raise ValueError(s)
    if t.is_integer:
        return int(s)
    if t.is_floating:
        return float(s)
    if t.id == TypeId.DATE32:
        return datetime.date.fromisoformat(s).toordinal() - _EPOCH_ORDINAL
    if t.id == TypeId.DATE64:
        return (datetime.date.fromisoformat(s).toordinal()
                - _EPOCH_ORDINAL) * 86_400_000
    if t.id == TypeId.TIMESTAMP:
        dt = datetime.datetime.fromisoformat(s)
        delta = dt - datetime.datetime(1970, 1, 1, tzinfo=dt.tzinfo)
        us = (delta.days * 86_400 + delta.seconds) * 1_000_000 \
            + delta.microseconds
        return us * _UNITS_PER_US[t.unit] // _US_PER_UNIT[t.unit]
    raise ValueError(f"cannot parse string as {t!r}")


def _cast_strings(ctx, a: DeviceColumn, t: DataType,
                  safe: bool) -> DeviceColumn:
    """A string column to bool, a number, a date or a timestamp: each
    dictionary value parsed once on the host, the results gathered by the
    codes on the device. A live row that does not parse raises ValueError
    with ``safe``, else is null."""
    parsed, bad = [], []
    for v in a.dictionary:
        try:
            parsed.append(0 if v is None else _parse_one(v, t))
            bad.append(False)
        except (ValueError, ArithmeticError):
            parsed.append(0)
            bad.append(True)
    from .strings import slot_lookup
    name = dtypes.dtype_of_type(t)
    table = np.asarray(parsed, dtype=name).view(
        torch.empty(0, dtype=dtypes.STORAGE[name]).numpy().dtype)
    out = slot_lookup(a, table)
    unparsed = slot_lookup(a, np.asarray(bad, dtype=np.bool_))
    if safe:
        if bool((unparsed & a.valid_mask(ctx.row_mask())).any()):
            raise ValueError(f"cast: could not parse string as {t!r}")
        return _col(out, a.validity, t, name=name)
    return _col(out, a.valid_mask() & ~unparsed, t, name=name)
