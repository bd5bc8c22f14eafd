"""Exact compute on decimals wider than the device's int64 (precision over
18), on the host (counterpart of ``arrow_tpu/compute/decimal_host.py``;
reference: util/basic_decimal.h and the decimal paths of
aggregate_basic.cc and scalar_arithmetic.cc).

On the device such a column rides as codes over a value-sorted dictionary
(``device/column.py``), so its comparisons, selections and sorts run there;
its sums, means and arithmetic run here on Python ``decimal`` values, bit
exact: mean and product round half away from zero at the input's scale,
add and subtract widen the precision by one, and a result past the 38 or
76-digit ceiling raises, as the reference's do."""

from __future__ import annotations

import decimal as _dec
from typing import List, Sequence

from .. import types as T
from ..array.array import Array, array as make_array
from ..table import ChunkedArray
from ..types import DataType, TypeId
from .registry import ArrowInvalid, Scalar

_DEC_IDS = (TypeId.DECIMAL128, TypeId.DECIMAL256, TypeId.DECIMAL32,
            TypeId.DECIMAL64)


def is_wide_decimal(t: DataType) -> bool:
    return t.id in _DEC_IDS and t.precision > 18


def _max_precision(t: DataType) -> int:
    return 76 if t.id == TypeId.DECIMAL256 else 38


def _mk(t: DataType, precision: int, scale: int) -> DataType:
    if t.id == TypeId.DECIMAL256 or precision > 38:
        return T.decimal256(min(precision, 76), scale)
    return T.decimal128(precision, scale)


def _quant(scale: int) -> _dec.Decimal:
    return _dec.Decimal(1).scaleb(-scale)


def _round_half_away(v: _dec.Decimal, scale: int) -> _dec.Decimal:
    return v.quantize(_quant(scale), rounding=_dec.ROUND_HALF_UP)


_AGG_NAMES = {"sum", "mean", "product", "min", "max", "min_max",
              "variance", "stddev", "quantile", "approximate_median"}
_ARITH_NAMES = {"add", "add_checked", "subtract", "subtract_checked",
                "multiply", "multiply_checked", "negate", "negate_checked",
                "abs", "abs_checked", "sign"}
# the reference has no kernel of these for a wide decimal either
_PARITY_RAISE = {"first", "last", "first_last", "skew", "kurtosis",
                 "divide", "divide_checked", "power", "power_checked",
                 "sqrt", "sqrt_checked", "exp", "ln", "cumulative_sum",
                 "cumulative_prod", "cumulative_mean", "tdigest", "mode"}


def maybe_wide_decimal_call(name: str, args: Sequence, options):
    """The result of a compute call with a wide decimal argument, or None
    where this tier does not take it (comparisons, selections and the like
    ride the dictionary codes on the device)."""
    norm: List = [a.combine() if isinstance(a, ChunkedArray) else a
                  for a in args]
    wide = [a for a in norm
            if isinstance(a, Array) and is_wide_decimal(a.type)]
    if not wide:
        return None
    if name in _PARITY_RAISE:
        raise ArrowInvalid(
            f"{name} has no kernel for {wide[0].type!r}; cast first")
    if name in _AGG_NAMES:
        return _agg(name, norm[0], dict(options or {}))
    if name in _ARITH_NAMES:
        return _arith(name, norm)
    return None


def _agg(name: str, arr: Array, opts):
    t = arr.type
    vals = [v for v in arr.to_pylist() if v is not None]
    n_null = len(arr) - len(vals)
    ok = len(vals) >= opts.get("min_count", 1) and (
        opts.get("skip_nulls", True) or n_null == 0)
    wide_t = _mk(t, _max_precision(t), t.scale)
    if name == "sum":
        return Scalar(sum(vals, _dec.Decimal(0)).quantize(_quant(t.scale))
                      if ok else None, wide_t)
    if name == "product":
        p = _dec.Decimal(1)
        for v in vals:
            p *= v
        return Scalar(_round_half_away(p, t.scale) if ok else None, wide_t)
    if name == "mean":
        if not vals or not ok:
            return Scalar(None, wide_t)
        with _dec.localcontext() as cctx:
            cctx.prec = 80
            m = sum(vals, _dec.Decimal(0)) / len(vals)
        return Scalar(_round_half_away(m, t.scale), wide_t)
    if name in ("min", "max"):
        ok = ok and bool(vals)
        return Scalar((min(vals) if name == "min" else max(vals))
                      if ok else None, t)
    if name == "min_max":
        st = T.struct([("min", t), ("max", t)])
        if not (ok and vals):
            return Scalar({"min": None, "max": None}, st)
        return Scalar({"min": min(vals), "max": max(vals)}, st)
    if name in ("variance", "stddev"):
        ddof = opts.get("ddof", 0)
        fv = [float(v) for v in vals]
        n = len(fv)
        if n - ddof <= 0 or not ok:
            return Scalar(None, T.float64())
        mu = sum(fv) / n
        var = sum((x - mu) ** 2 for x in fv) / (n - ddof)
        return Scalar(var if name == "variance" else var ** 0.5,
                      T.float64())
    # quantile, approximate_median: over the values as doubles, as the
    # reference converts them
    import numpy as np
    if not vals or not ok:
        return Scalar(None, T.float64())
    q = opts.get("q", 0.5) if name == "quantile" else 0.5
    interp = opts.get("interpolation", "linear")
    kw = {"method": interp} if interp in (
        "linear", "lower", "higher", "nearest", "midpoint") else {}
    r = float(np.quantile(np.array([float(v) for v in vals]), q, **kw))
    if name == "quantile":
        return make_array([r], T.float64())
    return Scalar(r, T.float64())


def _operand_type(a, t0: DataType, base: str) -> DataType:
    if isinstance(a, Array):
        if a.type.id not in _DEC_IDS:
            raise ArrowInvalid(f"decimal {base} requires decimal operands")
        return a.type
    if isinstance(a, _dec.Decimal):
        tup = a.as_tuple()
        return _mk(t0, len(tup.digits), max(-tup.exponent, 0))
    if isinstance(a, int):
        return _mk(t0, len(str(abs(a))) or 1, 0)
    raise ArrowInvalid(
        f"decimal {base} with {type(a)} not supported; cast first")


def _arith(name: str, norm):
    base = name.replace("_checked", "")
    arrs = [a for a in norm if isinstance(a, Array)]
    t0 = arrs[0].type
    n = len(arrs[0])
    if base in ("negate", "abs", "sign"):
        vals = arrs[0].to_pylist()
        if base == "negate":
            return make_array([None if v is None else -v for v in vals], t0)
        if base == "abs":
            return make_array([None if v is None else abs(v)
                               for v in vals], t0)
        return make_array([None if v is None else
                           (0 if v == 0 else (1 if v > 0 else -1))
                           for v in vals], T.int64())
    t1, t2 = (_operand_type(a, t0, base) for a in norm[:2])
    p1, s1, p2, s2 = t1.precision, t1.scale, t2.precision, t2.scale
    ceiling = max(_max_precision(t1), _max_precision(t2))
    if base in ("add", "subtract"):
        # scalar_arithmetic.cc: scale max(s1, s2), precision
        # max(p1 - s1, p2 - s2) + scale + 1
        s = max(s1, s2)
        p = max(p1 - s1, p2 - s2) + s + 1
    else:
        s = s1 + s2
        p = p1 + p2 + 1
    if p > ceiling:
        raise ArrowInvalid(
            f"Decimal precision out of range [1, {ceiling}]: {p}")
    out_t = _mk(t1 if t1.id == TypeId.DECIMAL256 else t2, p, s)
    a, b = norm[0], norm[1]
    av = a.to_pylist() if isinstance(a, Array) else [a] * n
    bv = b.to_pylist() if isinstance(b, Array) else [b] * n
    q = _quant(s)
    out = []
    for x, y in zip(av, bv):
        if x is None or y is None:
            out.append(None)
            continue
        x, y = _dec.Decimal(x), _dec.Decimal(y)
        with _dec.localcontext() as cctx:
            cctx.prec = 160
            r = x + y if base == "add" else (
                x - y if base == "subtract" else x * y)
        # quantized in the default context, as the reference does
        out.append(r.quantize(q))
    return make_array(out, out_t)
