"""Scalar (whole-column) aggregates (counterpart of
``arrow_tpu/compute/aggregate.py``): sum, product, mean, count,
count_all, min, max, min_max, any, all, first, last, first_last, index,
variance, stddev, skew, kurtosis, quantile, median, approximate_median and
count_distinct, with their options; and the helpers the grouped
aggregates share (sum types, dictionary decoding, decimal means).

Each is one masked reduction over the padded column: the live rows are
the rows of the batch's row mask (narrowed by a filter folded into the
aggregate) whose value is valid. The result is a 0-d value (a tuple of
them for a struct result), a 0-d validity and the result type, all on the
column's device, so nothing is read back. Null semantics are
ScalarAggregateOptions' (``skip_nulls``, ``min_count``; reference
``_agg_valid``). Sums accumulate as the reference's ``jnp.sum`` does
(int64 for signed integers and bool, uint64 for unsigned ones, f64 for
floats, an exact int64 for a decimal's unscaled values); a decimal's mean
stays a decimal, rounded half away from zero. Min, max, first and last
of a dictionary column give a code into ``dictionary``.

Two results follow Arrow where the reference's sentinel departs from it
(ROADMAP.md §3): ``count_distinct`` counts equality words, as
``hash_count_distinct`` does (NaN is one value, -0.0 and 0.0 are two), and
``quantile`` leaves NaN out. No kernel runs here.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import dtypes
from .. import types as T
from ..device.column import DeviceColumn
from ..types import DataType, TypeId
from .keys import equality_word
from .registry import ExecContext, register


class AggResult(NamedTuple):
    value: object            # 0-d tensor, or a tuple of them (``fields``)
    valid: object            # 0-d bool tensor, or a tuple of them
    type: DataType
    fields: Optional[Tuple[str, ...]] = None  # names of a struct result
    dictionary: Optional[tuple] = None        # values a code result indexes


# --- helpers shared with the grouped aggregates --------------------------

def _sum_dtype(name: str) -> str:
    """The accumulator of a value dtype (reference: ``aggregate.py``
    ``_sum_dtype``): uint64 for unsigned values, int64 for signed ones and
    bool, f64 for floats."""
    if dtypes.is_unsigned(name):
        return "uint64"
    if dtypes.is_integer(name) or name == "bool":
        return "int64"
    return "float64"


def _sum_type(t: DataType) -> DataType:
    """The type of a sum (reference: ``aggregate.py`` ``_sum_type``): a
    decimal keeps its scale at the widest precision, a bool or an
    unsigned integer is uint64, a signed one int64, anything else f64."""
    if t.is_decimal:
        return T.decimal256(76, t.scale) if t.id == TypeId.DECIMAL256 \
            else T.decimal128(38, t.scale)
    if t.id == TypeId.BOOL or t.is_unsigned_integer:
        return T.uint64()
    if t.is_integer:
        return T.int64()
    return T.float64()


def sum_values(col: DeviceColumn) -> torch.Tensor:
    """A column's values in its sum accumulator's dtype (``COMPUTE``:
    uint64 as its int64 bits, which wrap as the reference's do)."""
    name = col.value_dtype
    return dtypes.convert(dtypes.load(col.values, name), name,
                          _sum_dtype(name))


def decimal_mean(sums: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """int64 sums of unscaled values over counts, rounded half away from
    zero exactly (reference: ``|m| = (2|s| + c) // (2c)``)."""
    c = counts.clamp(min=1)
    mag = (2 * torch.abs(sums) + c) // (2 * c)
    return torch.where(sums < 0, -mag, mag)


def _dec_factor(t: DataType):
    """10**-scale for a decimal (float aggregates descale its unscaled
    int64), else None."""
    return 10.0 ** (-t.scale) if t.is_decimal else None


_NUMERIC_DICT_IDS = (
    TypeId.INT8, TypeId.INT16, TypeId.INT32, TypeId.INT64, TypeId.UINT8,
    TypeId.UINT16, TypeId.UINT32, TypeId.UINT64, TypeId.HALF_FLOAT,
    TypeId.FLOAT, TypeId.DOUBLE, TypeId.BOOL)


def _storage(name: str) -> str:
    """The numpy dtype of a value dtype's storage (uint32 as int32)."""
    return str(dtypes.STORAGE[name]).replace("torch.", "")


def decode_numeric_dict(col: DeviceColumn) -> DeviceColumn:
    """A dictionary column of numbers decoded to plain values (host work
    on the dictionary, one gather on the device); a null dictionary value
    is a null row. A dictionary of strings raises ValueError, as the
    reference's ArrowInvalid does. Other columns come back as they are."""
    if col.dictionary is None:
        return col
    vt = col.type.value_type if col.type.id == TypeId.DICTIONARY \
        else col.type
    if vt.id not in _NUMERIC_DICT_IDS:
        raise ValueError(
            f"numeric aggregate on code-valued column of type {col.type!r}"
            " is not supported on device; it runs on the host tier")
    name = dtypes.dtype_of_type(vt)
    dev = col.values.device
    dvals = np.asarray([0 if v is None else v for v in col.dictionary] or
                       [0], dtype=name).view(_storage(name))
    table = torch.from_numpy(dvals).to(dev)
    codes = col.values.long().clamp(0, len(dvals) - 1)
    validity = col.validity
    if any(v is None for v in col.dictionary):
        ok = torch.tensor([v is not None for v in col.dictionary],
                          dtype=torch.bool, device=dev)[codes]
        validity = ok if validity is None else validity & ok
    return DeviceColumn(table[codes], validity, vt)


def rank_recode(col: DeviceColumn) -> DeviceColumn:
    """A dictionary-coded column recoded so that its codes are the ranks
    of their values, with the value-sorted dictionary (a null value last):
    host work on the dictionary, one gather on the device (reference:
    ``aggregate.py`` ``rank_recode``). Other columns come back as they
    are."""
    if col.dictionary is None:
        return col
    vals = list(col.dictionary)
    order = sorted(range(len(vals)), key=lambda i: (vals[i] is None, vals[i]))
    if order == list(range(len(vals))):
        return col
    rank = torch.empty(len(vals), dtype=torch.int32)
    rank[torch.tensor(order)] = torch.arange(len(vals), dtype=torch.int32)
    codes = rank.to(col.values.device)[col.values.long().clamp(
        0, len(vals) - 1)]
    return DeviceColumn(codes, col.validity, col.type,
                        tuple(vals[i] for i in order))


def _minmax_identity(values: torch.Tensor, name: str, is_min: bool):
    """What fills the rows that are not live before a min (max): +-inf,
    True/False, or the end of the integer's order-key range."""
    if values.dtype == torch.bool:
        return is_min
    if values.dtype.is_floating_point:
        return float("inf") if is_min else float("-inf")
    info = torch.iinfo(dtypes.COMPUTE[name])
    return info.max if is_min else info.min


# --- null semantics -------------------------------------------------------

def _live_count(ctx, a: DeviceColumn):
    live = a.valid_mask(ctx.row_mask())
    return live, live.sum(dtype=torch.int64)


def _has_null(ctx, a: DeviceColumn) -> torch.Tensor:
    """A row of the row mask holds a null."""
    if a.validity is None:
        return torch.zeros((), dtype=torch.bool, device=a.values.device)
    return (~a.validity & ctx.row_mask()).any()


def _agg_valid(ctx, a, n, skip_nulls: bool, min_count: int):
    """At least ``min_count`` live values, and no null where
    ``skip_nulls`` is False."""
    ok = n >= max(min_count, 0)
    if not skip_nulls:
        ok = ok & ~_has_null(ctx, a)
    return ok


def _true(like: torch.Tensor) -> torch.Tensor:
    return torch.ones((), dtype=torch.bool, device=like.device)


# --- sums, products, means ------------------------------------------------

@register("sum", "aggregate")
def scalar_sum(ctx, a: DeviceColumn, skip_nulls: bool = True,
               min_count: int = 1) -> AggResult:
    a = decode_numeric_dict(a)
    live, n = _live_count(ctx, a)
    v = sum_values(a)
    total = torch.where(live, v, torch.zeros((), dtype=v.dtype,
                                             device=v.device)).sum()
    return AggResult(total, _agg_valid(ctx, a, n, skip_nulls, min_count),
                     _sum_type(a.type))


@register("product", "aggregate")
def scalar_product(ctx, a: DeviceColumn, skip_nulls: bool = True,
                   min_count: int = 1) -> AggResult:
    """In the sum's accumulator, wrapping for integers; a decimal
    raises ValueError, as the reference does."""
    a = decode_numeric_dict(a)
    if a.type.is_decimal:
        raise ValueError("product of decimal not supported; cast first")
    live, n = _live_count(ctx, a)
    v = sum_values(a)
    total = torch.where(live, v, torch.ones((), dtype=v.dtype,
                                            device=v.device)).prod()
    return AggResult(total, _agg_valid(ctx, a, n, skip_nulls, min_count),
                     _sum_type(a.type))


@register("mean", "aggregate")
def scalar_mean(ctx, a: DeviceColumn, skip_nulls: bool = True,
                min_count: int = 1) -> AggResult:
    """0/0 gives NaN, valid where ``min_count`` is 0."""
    a = decode_numeric_dict(a)
    live, n = _live_count(ctx, a)
    valid = _agg_valid(ctx, a, n, skip_nulls, min_count)
    if a.type.is_decimal:
        s = torch.where(live, a.values.to(torch.int64), 0).sum()
        return AggResult(decimal_mean(s, n), valid, a.type)
    f = torch.where(live, dtypes.as_float64(a.values, a.value_dtype), 0.0)
    return AggResult(f.sum() / n.to(torch.float64), valid, T.float64())


# --- min, max, any, all, first, last, index --------------------------------

def _minmax(ctx, a: DeviceColumn, skip_nulls: bool, min_count: int,
            is_min: bool) -> AggResult:
    """The identity fills the rows that are not live, so it is also what
    an empty input gives, under a null. Integers reduce by their order
    keys, so an unsigned column orders as unsigned; a dictionary column
    by its values' ranks, giving a code into the sorted dictionary."""
    a = rank_recode(a)
    live, n = _live_count(ctx, a)
    name = a.value_dtype
    v = a.values
    ident = _minmax_identity(v, name, is_min)
    if v.dtype.is_floating_point or v.dtype == torch.bool:
        v = torch.where(live, v, torch.tensor(ident, dtype=v.dtype,
                                              device=v.device))
        out = v.min() if is_min else v.max()
    else:
        k = dtypes.order_key(dtypes.load(v, name), name)
        k = torch.where(live, k, ident)
        out = dtypes.store(dtypes.order_key(k.min() if is_min else k.max(),
                                            name), name)
    valid = _agg_valid(ctx, a, n, skip_nulls, min_count) & (n > 0)
    return AggResult(out, valid, a.type, dictionary=a.dictionary)


@register("min", "aggregate")
def scalar_min(ctx, a: DeviceColumn, skip_nulls: bool = True,
               min_count: int = 1) -> AggResult:
    return _minmax(ctx, a, skip_nulls, min_count, True)


@register("max", "aggregate")
def scalar_max(ctx, a: DeviceColumn, skip_nulls: bool = True,
               min_count: int = 1) -> AggResult:
    return _minmax(ctx, a, skip_nulls, min_count, False)


@register("min_max", "aggregate")
def scalar_min_max(ctx, a: DeviceColumn, skip_nulls: bool = True,
                   min_count: int = 1) -> AggResult:
    lo = _minmax(ctx, a, skip_nulls, min_count, True)
    hi = _minmax(ctx, a, skip_nulls, min_count, False)
    return AggResult((lo.value, hi.value), (lo.valid, hi.valid),
                     T.struct([("min", lo.type), ("max", lo.type)]),
                     ("min", "max"), lo.dictionary)


@register("count", "aggregate")
def scalar_count(ctx, a: DeviceColumn, mode: str = "only_valid"
                 ) -> AggResult:
    if mode == "only_valid":
        n = a.valid_mask(ctx.row_mask()).sum(dtype=torch.int64)
    elif mode == "only_null":
        n = (~a.valid_mask() & ctx.row_mask()).sum(dtype=torch.int64)
    elif mode == "all":
        n = ctx.row_mask().sum(dtype=torch.int64)
    else:
        raise ValueError(f"bad count mode {mode!r}")
    return AggResult(n, _true(n), T.int64())


@register("count_all", "aggregate")
def scalar_count_all(ctx, a: Optional[DeviceColumn] = None) -> AggResult:
    """The rows of the row mask; the column, as in the reference, is not
    read."""
    n = ctx.row_mask().sum(dtype=torch.int64)
    return AggResult(n, _true(n), T.int64())


@register("any", "aggregate")
def scalar_any(ctx, a: DeviceColumn, skip_nulls: bool = True,
               min_count: int = 1) -> AggResult:
    """With ``skip_nulls=False``, Kleene: a null nulls the result unless
    a true was seen."""
    live, n = _live_count(ctx, a)
    out = (a.values.to(torch.bool) & live).any()
    ok = n >= max(min_count, 0)
    if not skip_nulls:
        ok = ok & (out | ~_has_null(ctx, a))
    return AggResult(out, ok, T.bool_())


@register("all", "aggregate")
def scalar_all(ctx, a: DeviceColumn, skip_nulls: bool = True,
               min_count: int = 1) -> AggResult:
    live, n = _live_count(ctx, a)
    any_false = (~a.values.to(torch.bool) & live).any()
    ok = n >= max(min_count, 0)
    if not skip_nulls:
        ok = ok & (any_false | ~_has_null(ctx, a))
    return AggResult(~any_false, ok, T.bool_())


def _first_last(ctx, a: DeviceColumn, skip_nulls: bool, is_first: bool
                ) -> AggResult:
    """The value at the first (last) live row, or at row 0 (the last row)
    under a null where there is none: the reference's ``argmax`` of the
    mask, here the least (greatest) live row index. With
    ``skip_nulls=False`` a null row counts and gives a null."""
    live = a.valid_mask(ctx.row_mask()) if skip_nulls else ctx.row_mask()
    cap = a.capacity
    idx = torch.arange(cap, device=live.device)
    if is_first:
        pos = torch.where(live, idx, cap).min()
        has = pos < cap
        pos = torch.where(has, pos, 0)
    else:
        pos = torch.where(live, idx, -1).max()
        has = pos >= 0
        pos = torch.where(has, pos, cap - 1)
    valid = has
    if not skip_nulls and a.validity is not None:
        valid = has & a.validity[pos]
    return AggResult(a.values[pos], valid, a.type, dictionary=a.dictionary)


@register("first", "aggregate")
def scalar_first(ctx, a: DeviceColumn, skip_nulls: bool = True,
                 min_count: int = 1) -> AggResult:
    return _first_last(ctx, a, skip_nulls, True)


@register("last", "aggregate")
def scalar_last(ctx, a: DeviceColumn, skip_nulls: bool = True,
                min_count: int = 1) -> AggResult:
    return _first_last(ctx, a, skip_nulls, False)


@register("first_last", "aggregate")
def scalar_first_last(ctx, a: DeviceColumn, skip_nulls: bool = True,
                      min_count: int = 1) -> AggResult:
    f = _first_last(ctx, a, skip_nulls, True)
    last = _first_last(ctx, a, skip_nulls, False)
    return AggResult((f.value, last.value), (f.valid, last.valid),
                     T.struct([("first", a.type), ("last", a.type)]),
                     ("first", "last"), a.dictionary)


@register("index", "aggregate")
def scalar_index(ctx, a: DeviceColumn, value=None) -> AggResult:
    """The first live row equal to ``value`` (converted to the column's
    dtype; a dictionary column compares codes), or -1."""
    if value is None:
        raise ValueError("index requires a value option")
    live = a.valid_mask(ctx.row_mask())
    name = a.value_dtype
    # the value in the column's dtype, as ``jnp.asarray(value, dtype)``
    x = np.asarray(value, dtype=name).reshape(1).view(_storage(name))
    want = dtypes.load(torch.from_numpy(x).to(live.device), name)[0]
    hit = live & (dtypes.load(a.values, name) == want)
    cap = a.capacity
    pos = torch.where(hit, torch.arange(cap, device=live.device), cap).min()
    return AggResult(torch.where(pos < cap, pos, -1), _true(pos), T.int64())


# --- moments ----------------------------------------------------------------

def _moments(ctx, a: DeviceColumn):
    """(live count, mean, and the sums of the centred values' squares,
    cubes and fourth powers), in f64, a decimal descaled: two passes."""
    a = decode_numeric_dict(a)
    live, n = _live_count(ctx, a)
    vf = torch.where(live, dtypes.as_float64(a.values, a.value_dtype), 0.0)
    f = _dec_factor(a.type)
    if f is not None:
        vf = vf * f
    mean = vf.sum() / n.clamp(min=1).to(torch.float64)
    c = torch.where(live, vf - mean, 0.0)
    c2 = c * c
    return a, n, mean, c2.sum(), (c2 * c).sum(), (c2 * c2).sum()


@register("variance", "aggregate")
def scalar_variance(ctx, a: DeviceColumn, ddof: int = 0,
                    skip_nulls: bool = True, min_count: int = 0
                    ) -> AggResult:
    a, n, _, m2, _, _ = _moments(ctx, a)
    var = m2 / (n.to(torch.float64) - ddof).clamp(min=1.0)
    ok = (n > ddof) & _agg_valid(ctx, a, n, skip_nulls, min_count)
    return AggResult(var, ok, T.float64())


@register("stddev", "aggregate")
def scalar_stddev(ctx, a: DeviceColumn, ddof: int = 0,
                  skip_nulls: bool = True, min_count: int = 0) -> AggResult:
    r = scalar_variance(ctx, a, ddof, skip_nulls, min_count)
    return AggResult(torch.sqrt(r.value), r.valid, T.float64())


@register("skew", "aggregate")
def scalar_skew(ctx, a: DeviceColumn, skip_nulls: bool = True,
                biased: bool = True, min_count: int = 0) -> AggResult:
    a, n, _, m2, m3, _ = _moments(ctx, a)
    nf = n.to(torch.float64)
    var = m2 / nf.clamp(min=1.0)
    sk = (m3 / nf.clamp(min=1.0)) / var.clamp(min=1e-300) ** 1.5
    if not biased:
        sk = sk * torch.sqrt(nf * (nf - 1.0)) / (nf - 2.0).clamp(min=1.0)
    return AggResult(sk, _agg_valid(ctx, a, n, skip_nulls,
                                    max(min_count, 1)), T.float64())


@register("kurtosis", "aggregate")
def scalar_kurtosis(ctx, a: DeviceColumn, skip_nulls: bool = True,
                    biased: bool = True, min_count: int = 0) -> AggResult:
    a, n, _, m2, _, m4 = _moments(ctx, a)
    nf = n.to(torch.float64)
    var = m2 / nf.clamp(min=1.0)
    kt = (m4 / nf.clamp(min=1.0)) / var.clamp(min=1e-300) ** 2 - 3.0
    if not biased:
        kt = ((nf - 1.0) / ((nf - 2.0) * (nf - 3.0)).clamp(min=1.0)
              * ((nf + 1.0) * kt + 6.0))
    return AggResult(kt, _agg_valid(ctx, a, n, skip_nulls,
                                    max(min_count, 1)), T.float64())


# --- quantiles ---------------------------------------------------------------

_INTERPOLATIONS = ("linear", "lower", "higher", "nearest", "midpoint")


@register("quantile", "aggregate")
def scalar_quantile(ctx, a: DeviceColumn, q=0.5,
                    interpolation: str = "linear", skip_nulls: bool = True,
                    min_count: int = 0) -> AggResult:
    """One sort of the live values in f64 (a decimal descaled), the rest
    at +inf; each ``q`` reads the two values around ``q * (n - 1)``. NaN
    is left out of the values and of ``n``, as in Arrow (the reference
    counts it and reads the sentinel). Several ``q`` give a list result,
    one field each."""
    if interpolation not in _INTERPOLATIONS:
        raise ValueError(f"bad interpolation {interpolation!r}")
    qs = list(q) if isinstance(q, (list, tuple)) else [q]
    av = dtypes.as_float64(a.values, a.value_dtype)
    f = _dec_factor(a.type)
    if f is not None:
        av = av * f
    live = a.valid_mask(ctx.row_mask()) & ~torch.isnan(av)
    n = live.sum(dtype=torch.int64)
    sv = torch.sort(torch.where(live, av, float("inf"))).values
    nf = n.clamp(min=1).to(torch.float64)
    outs = []
    for qi in qs:
        pos = qi * (nf - 1.0)
        lo, hi = torch.floor(pos), torch.ceil(pos)
        frac = pos - lo
        vlo, vhi = sv[lo.long()], sv[hi.long()]
        outs.append({"linear": lambda: vlo + (vhi - vlo) * frac,
                     "lower": lambda: vlo, "higher": lambda: vhi,
                     "nearest": lambda: torch.where(frac <= 0.5, vlo, vhi),
                     "midpoint": lambda: (vlo + vhi) * 0.5}[interpolation]())
    ok = _agg_valid(ctx, a, n, skip_nulls, max(min_count, 1))
    if len(outs) == 1:
        return AggResult(outs[0], ok, T.float64())
    return AggResult(tuple(outs), tuple(ok for _ in outs),
                     T.list_(T.float64()),
                     tuple(f"q{i}" for i in range(len(outs))))


@register("median", "aggregate")
def scalar_median(ctx, a: DeviceColumn, skip_nulls: bool = True,
                  min_count: int = 0) -> AggResult:
    return scalar_quantile(ctx, a, 0.5, "linear", skip_nulls, min_count)


@register("approximate_median", "aggregate")
def scalar_approximate_median(ctx, a: DeviceColumn, skip_nulls: bool = True,
                              min_count: int = 0) -> AggResult:
    """The exact median, as the reference gives it."""
    return scalar_median(ctx, a, skip_nulls, min_count)


@register("count_distinct", "aggregate")
def scalar_count_distinct(ctx, a: DeviceColumn,
                          mode: str = "only_valid") -> AggResult:
    """Distinct equality words among the live values: one sort with the
    rest at the largest word, then the run heads among the first ``n``
    (a live value at that word sorts among them, so it counts once).
    ``only_null`` gives 1 where a null is present, ``all`` adds it."""
    live, n = _live_count(ctx, a)
    top = torch.iinfo(torch.int64).max
    sv = torch.sort(torch.where(live, equality_word(a), top)).values
    head = torch.ones_like(live)
    head[1:] = sv[1:] != sv[:-1]
    idx = torch.arange(a.capacity, device=live.device)
    distinct = (head & (idx < n)).sum(dtype=torch.int64)
    has_null = _has_null(ctx, a).to(torch.int64)
    out = {"only_valid": distinct, "only_null": has_null,
           "all": distinct + has_null}[mode]
    return AggResult(out, _true(out), T.int64())
