"""Grouped ("hash_") aggregates (counterpart of
``arrow_tpu/compute/hash_agg.py`` and of the grouped ones of
``arrow_tpu/compute/extra_kernels.py``): sum, product, mean, count,
count_all, min, max, min_max, any, all, variance, stddev, first, last,
one and count_distinct, with their options; first_last, skew, kurtosis,
approximate_median and tdigest.

Each takes (values, group ids int64[capacity] with ``capacity`` on dead
rows) and returns per-group results at the static segment bound plus the
group count. Float sums and means add in an order fixed by the input
(``move.segment_sum``: the grouped-sum kernel up to 1,024 segments), so a
run repeats its bits; integer sums and counts add through ``index_add_``,
exact in any order. Sums take the reference's types: a signed integer
sums to int64, an unsigned one or a bool to uint64, a float (f16 and
f32 too) to f64 and a decimal to decimal128(38, scale) as an exact int64
sum of its unscaled values. A decimal's mean stays a decimal of its
type, rounded half away from zero in int64, as the reference's is. Min
and max compare a dictionary column by value (``rank_recode``) and keep its sorted dictionary; count_distinct sorts
(group, value word) pairs and counts their boundaries. A dictionary of
numbers decodes to its values for the sums, means, products and
variances (``aggregate.decode_numeric_dict``).

Every function reduces at ``num_segments`` (the node passes the bound to
all of them; the reference passes it only where a signature names it, and
its any, all, variance and first run at the row capacity: the two agree
on the live groups). Float products multiply in an order fixed by the
input (``move.segment_product``); the variance's two sums go through
``move.segment_sum``. First and last take each group's least (greatest)
live row index, dead rows at an identity position. Skew and kurtosis
sum the centred moments through ``move.segment_sum`` too, so a run
repeats their bits. The grouped quantiles sort the live rows by (group,
value) and read each group's run; NaN is left out of the values and the
counts, as the port's scalar ``quantile`` leaves it out.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import dtypes
from .. import types as T
from ..device.column import DeviceColumn
from .aggregate import (_dec_factor, _sum_type, decimal_mean,
                        decode_numeric_dict, rank_recode, sum_values)
from .keys import _LOW63, equality_word, order_word, stable_sort_indices
from .move import (_empty_value, segment_count, segment_product,
                   segment_reduce, segment_sum)
from .registry import register
from .selection import Compacted


def _prep(ctx, values: DeviceColumn, gids: torch.Tensor,
          num_segments=None):
    """(segment bound, live mask, in-range segment ids)."""
    cap = ctx.capacity
    nseg = num_segments if num_segments is not None else cap
    live = values.valid_mask(ctx.row_mask()) & (gids < cap)
    seg = torch.where(live, gids, 0).to(torch.int32)
    return nseg, live, seg


def _segment_sum(v: torch.Tensor, live, seg, nseg) -> torch.Tensor:
    """Integer sums through ``index_add_`` (exact in any order), float
    sums in a fixed order (``move.segment_sum``), dead rows left out."""
    v = torch.where(live, v, torch.zeros((), dtype=v.dtype, device=v.device))
    if v.dtype.is_floating_point:
        return segment_sum(v, seg, nseg, live)
    return segment_reduce(v, seg, nseg, "sum", 0)


def _validity(ctx, values, gids, counts, nseg, min_count, skip_nulls):
    """At least ``min_count`` live values (0 keeps even an empty group's
    identity), and no null in the group where ``skip_nulls`` is False."""
    ok = counts >= min_count
    if not skip_nulls:
        ok = ok & ~_group_has_null(ctx, values, gids, nseg)
    return ok


def _out(column: DeviceColumn, num_groups) -> Compacted:
    return Compacted(column, num_groups.to(torch.int32))


@register("hash_sum", "hash_aggregate")
def grouped_sum(ctx, values: DeviceColumn, gids, num_groups,
                skip_nulls: bool = True, min_count: int = 1,
                num_segments=None):
    values = decode_numeric_dict(values)
    nseg, live, seg = _prep(ctx, values, gids, num_segments)
    sums = _segment_sum(sum_values(values), live, seg, nseg)
    counts = segment_count(live, seg, nseg)
    return _out(DeviceColumn(sums, _validity(
        ctx, values, gids, counts, nseg, min_count, skip_nulls),
        _sum_type(values.type)), num_groups)


@register("hash_product", "hash_aggregate")
def grouped_product(ctx, values: DeviceColumn, gids, num_groups,
                    skip_nulls: bool = True, min_count: int = 1,
                    num_segments=None):
    """In the sum's accumulator (an integer product wraps at 64 bits, as
    numpy's does); an empty group holds 1. A decimal multiplies its
    unscaled values, as the reference does."""
    values = decode_numeric_dict(values)
    nseg, live, seg = _prep(ctx, values, gids, num_segments)
    prods = segment_product(sum_values(values), seg, nseg, live)
    counts = segment_count(live, seg, nseg)
    return _out(DeviceColumn(prods, _validity(
        ctx, values, gids, counts, nseg, min_count, skip_nulls),
        _sum_type(values.type)), num_groups)


@register("hash_mean", "hash_aggregate")
def grouped_mean(ctx, values: DeviceColumn, gids, num_groups,
                 skip_nulls: bool = True, min_count: int = 1,
                 num_segments=None):
    values = decode_numeric_dict(values)
    nseg, live, seg = _prep(ctx, values, gids, num_segments)
    counts = segment_count(live, seg, nseg)
    validity = _validity(ctx, values, gids, counts, nseg, min_count,
                         skip_nulls)
    if values.type.is_decimal:
        sums = _segment_sum(values.values.to(torch.int64), live, seg, nseg)
        return _out(DeviceColumn(decimal_mean(sums, counts), validity,
                                 values.type), num_groups)
    name = values.value_dtype
    sums = _segment_sum(dtypes.as_float64(values.values, name), live, seg,
                        nseg)
    means = sums / counts.clamp(min=1).to(torch.float64)
    return _out(DeviceColumn(means, validity, T.float64()), num_groups)


@register("hash_count", "hash_aggregate")
def grouped_count(ctx, values: DeviceColumn, gids, num_groups,
                  mode: str = "only_valid", num_segments=None):
    """The group's valid rows (``only_valid``), null rows
    (``only_null``) or all its rows (``all``)."""
    cap = ctx.capacity
    nseg = num_segments if num_segments is not None else cap
    if mode == "only_valid":
        live = values.valid_mask(ctx.row_mask())
    elif mode == "only_null":
        live = ~values.valid_mask() & ctx.row_mask()
    else:
        live = ctx.row_mask()
    live = live & (gids < cap)
    seg = torch.where(live, gids, 0).to(torch.int32)
    return _out(DeviceColumn(segment_count(live, seg, nseg), None,
                             T.int64()), num_groups)


@register("hash_count_all", "hash_aggregate")
def grouped_count_all(ctx, gids, num_groups, num_segments=None):
    cap = ctx.capacity
    nseg = num_segments if num_segments is not None else cap
    live = ctx.row_mask() & (gids < cap)
    seg = torch.where(live, gids, 0).to(torch.int32)
    return Compacted(DeviceColumn(segment_count(live, seg, nseg), None,
                                  T.int64()),
                     num_groups.to(torch.int32))


def _group_has_null(ctx, values: DeviceColumn, gids, nseg) -> torch.Tensor:
    """bool[nseg]: the group has a live row whose value is null."""
    if values.validity is None:
        return torch.zeros(nseg, dtype=torch.bool, device=gids.device)
    isnull = ~values.validity & ctx.row_mask() & (gids < ctx.capacity)
    seg = torch.where(isnull, gids, 0)
    return segment_count(isnull, seg, nseg) > 0


def _grouped_minmax(ctx, values: DeviceColumn, gids, num_groups, is_min,
                    skip_nulls, num_segments):
    """A group is valid iff it saw a value (``min_count`` does not apply,
    as in the reference); with ``skip_nulls=False`` a null in the group
    nulls it. Empty groups hold the reduction's identity. Floats reduce
    as the reference's segment min and max do: a NaN in the group gives
    NaN, and -0.0 orders below 0.0 (through ``_float_minmax``)."""
    values = rank_recode(values)
    nseg, live, seg = _prep(ctx, values, gids, num_segments)
    v = values.values
    op = "min" if is_min else "max"
    name = values.value_dtype
    if v.dtype.is_floating_point:
        out = _float_minmax(v, live, seg, nseg, op)
    elif v.dtype == torch.bool:
        # min is an AND, max an OR: reduce the bools as bytes
        ident = int(is_min)
        b = torch.where(live, v.to(torch.uint8), ident)
        out = segment_reduce(b, seg, nseg, op, ident).to(torch.bool)
    else:
        # unsigned values reduce by their order keys, in their width's
        # compute dtype (the identity is an end of that dtype's range)
        k = dtypes.order_key(dtypes.load(v, name), name)
        ident = _empty_value(k.dtype, op)
        k = torch.where(live, k, torch.tensor(ident, dtype=k.dtype,
                                              device=k.device))
        k = segment_reduce(k, seg, nseg, op, ident)
        out = dtypes.store(dtypes.order_key(k, name), name)
    validity = segment_count(live, seg, nseg) > 0
    if not skip_nulls:
        validity = validity & ~_group_has_null(ctx, values, gids, nseg)
    return Compacted(DeviceColumn(out, validity, values.type,
                                  values.dictionary),
                     num_groups.to(torch.int32))


def _float_minmax(v, live, seg, nseg, op) -> torch.Tensor:
    """Segment min or max of floats by their order words (-0.0 below
    0.0, as XLA orders them), NaN rows left out and a group with one set
    to NaN afterwards; empty groups hold +-inf."""
    nan = torch.isnan(v) & live
    inf = _empty_value(v.dtype, op)
    w = torch.where(live & ~nan, order_word(DeviceColumn(v, None, None)),
                    _order_word_host(inf))
    w = segment_reduce(w, seg, nseg, op, None)
    # a group with no row keeps the int64 identity: give it +-inf's word
    w = torch.where(w == _empty_value(torch.int64, op), _order_word_host(inf),
                    w)
    out = torch.where(w < 0, w ^ _LOW63, w).view(torch.float64).to(v.dtype)
    has_nan = segment_count(nan, torch.where(nan, seg, 0), nseg) > 0
    return torch.where(has_nan, torch.tensor(float("nan"), dtype=v.dtype,
                                             device=v.device), out)


def _order_word_host(x: float) -> int:
    """``keys.order_word`` of one f64 value, on the host."""
    bits = int(np.array(x, dtype=np.float64).view(np.int64))
    return bits ^ _LOW63 if bits < 0 else bits


@register("hash_min", "hash_aggregate")
def grouped_min(ctx, values: DeviceColumn, gids, num_groups,
                skip_nulls: bool = True, min_count: int = 1,
                num_segments=None):
    return _grouped_minmax(ctx, values, gids, num_groups, True, skip_nulls,
                           num_segments)


@register("hash_max", "hash_aggregate")
def grouped_max(ctx, values: DeviceColumn, gids, num_groups,
                skip_nulls: bool = True, min_count: int = 1,
                num_segments=None):
    return _grouped_minmax(ctx, values, gids, num_groups, False, skip_nulls,
                           num_segments)


@register("hash_min_max", "hash_aggregate")
def grouped_min_max(ctx, values: DeviceColumn, gids, num_groups,
                    skip_nulls: bool = True, min_count: int = 1,
                    num_segments=None):
    """``{"min": ..., "max": ...}``: the node makes two columns of it."""
    return {"min": _grouped_minmax(ctx, values, gids, num_groups, True,
                                   skip_nulls, num_segments),
            "max": _grouped_minmax(ctx, values, gids, num_groups, False,
                                   skip_nulls, num_segments)}


def _any_true(ctx, values, gids, num_segments, want: bool):
    """(group has a live row whose value is ``want``, live counts)."""
    nseg, live, seg = _prep(ctx, values, gids, num_segments)
    hit = live & (values.values.to(torch.bool) == want)
    return (segment_count(hit, torch.where(hit, seg, 0), nseg) > 0,
            segment_count(live, seg, nseg))


@register("hash_any", "hash_aggregate")
def grouped_any(ctx, values: DeviceColumn, gids, num_groups,
                skip_nulls: bool = True, min_count: int = 0,
                num_segments=None):
    """Nulls are skipped whatever ``skip_nulls`` says, as in the
    reference; a validity only where ``min_count`` > 0."""
    out, counts = _any_true(ctx, values, gids, num_segments, True)
    validity = counts >= min_count if min_count > 0 else None
    return _out(DeviceColumn(out, validity, T.bool_()), num_groups)


@register("hash_all", "hash_aggregate")
def grouped_all(ctx, values: DeviceColumn, gids, num_groups,
                skip_nulls: bool = True, min_count: int = 0,
                num_segments=None):
    """As ``hash_any``; an empty group is True."""
    any_false, counts = _any_true(ctx, values, gids, num_segments, False)
    validity = counts >= min_count if min_count > 0 else None
    return _out(DeviceColumn(~any_false, validity, T.bool_()), num_groups)


@register("hash_variance", "hash_aggregate")
def grouped_variance(ctx, values: DeviceColumn, gids, num_groups,
                     ddof: int = 0, skip_nulls: bool = True,
                     min_count: int = 0, num_segments=None):
    """Two passes in f64 (a decimal descaled): the group means, then the
    sums of squared deviations, each through ``move.segment_sum`` (the
    grouped-sum kernel up to 1,024 groups). Valid where the group has
    more than ``ddof`` and at least ``min_count`` values."""
    values = decode_numeric_dict(values)
    nseg, live, seg = _prep(ctx, values, gids, num_segments)
    v = dtypes.as_float64(values.values, values.value_dtype)
    f = _dec_factor(values.type)
    if f is not None:
        v = v * f
    v = torch.where(live, v, 0.0)
    counts = segment_count(live, seg, nseg)
    means = segment_sum(v, seg, nseg, live) / counts.clamp(min=1).to(
        torch.float64)
    centred = torch.where(live, v - means[seg.long()], 0.0)
    m2 = segment_sum(centred * centred, seg, nseg, live)
    var = m2 / (counts.to(torch.float64) - ddof).clamp(min=1.0)
    validity = (counts > ddof) & _validity(ctx, values, gids, counts, nseg,
                                           min_count, skip_nulls)
    return _out(DeviceColumn(var, validity, T.float64()), num_groups)


@register("hash_stddev", "hash_aggregate")
def grouped_stddev(ctx, values: DeviceColumn, gids, num_groups,
                   ddof: int = 0, skip_nulls: bool = True,
                   min_count: int = 0, num_segments=None):
    r = grouped_variance(ctx, values, gids, num_groups, ddof, skip_nulls,
                         min_count, num_segments)
    return Compacted(DeviceColumn(torch.sqrt(r.column.values),
                                  r.column.validity, T.float64()), r.count)


def _grouped_first_last(ctx, values: DeviceColumn, gids, num_groups,
                        is_first: bool, skip_nulls: bool, num_segments):
    """Each group's first (last) live row: a segment min (max) of row
    indices, dead rows at ``cap`` (-1). With ``skip_nulls=False`` a null
    row counts and gives a null. A group with no such row is null over
    row 0's value."""
    cap = ctx.capacity
    nseg = num_segments if num_segments is not None else cap
    live = values.valid_mask(ctx.row_mask()) if skip_nulls \
        else ctx.row_mask()
    live = live & (gids < cap)
    seg = torch.where(live, gids, 0)
    # int32 positions: the card's native 32-bit atomic min and max
    idx = torch.arange(cap, dtype=torch.int32, device=gids.device)
    ident = cap if is_first else -1
    pos = segment_reduce(torch.where(live, idx, ident), seg, nseg,
                         "min" if is_first else "max", ident).long()
    has = (pos >= 0) & (pos < cap)
    safe = torch.where(has, pos, 0)
    validity = has
    if values.validity is not None and not skip_nulls:
        validity = has & values.validity[safe]
    return _out(DeviceColumn(values.values[safe], validity, values.type,
                             values.dictionary), num_groups)


@register("hash_first", "hash_aggregate")
def grouped_first(ctx, values: DeviceColumn, gids, num_groups,
                  skip_nulls: bool = True, min_count: int = 0,
                  num_segments=None):
    return _grouped_first_last(ctx, values, gids, num_groups, True,
                               skip_nulls, num_segments)


@register("hash_last", "hash_aggregate")
def grouped_last(ctx, values: DeviceColumn, gids, num_groups,
                 skip_nulls: bool = True, min_count: int = 0,
                 num_segments=None):
    return _grouped_first_last(ctx, values, gids, num_groups, False,
                               skip_nulls, num_segments)


@register("hash_one", "hash_aggregate")
def grouped_one(ctx, values: DeviceColumn, gids, num_groups,
                num_segments=None):
    """A group's first valid value."""
    return _grouped_first_last(ctx, values, gids, num_groups, True, True,
                               num_segments)


@register("hash_count_distinct", "hash_aggregate")
def grouped_count_distinct(ctx, values: DeviceColumn, gids, num_groups,
                           mode: str = "only_valid", num_segments=None):
    """Distinct valid values per group: a stable sort of the (group id,
    equality word) pairs of the live rows, then the pairs that start a run
    counted by group. ``mode="only_null"`` gives 1 where the group has a
    null, ``"all"`` adds that 1 to the distinct count."""
    cap = ctx.capacity
    nseg = num_segments if num_segments is not None else cap
    live = values.valid_mask(ctx.row_mask()) & (gids < cap)
    gkey = torch.where(live, gids, cap)
    vkey = torch.where(live, equality_word(values), 0)
    perm = stable_sort_indices([gkey, vkey])
    sg, sv = gkey[perm], vkey[perm]
    new_pair = torch.ones(cap, dtype=torch.bool, device=gids.device)
    new_pair[1:] = (sg[1:] != sg[:-1]) | (sv[1:] != sv[:-1])
    new_pair &= live[perm]
    counts = segment_count(new_pair, torch.where(new_pair, sg, 0), nseg)
    if mode in ("only_null", "all"):
        has_null = _group_has_null(ctx, values, gids, nseg).to(torch.int64)
        counts = has_null if mode == "only_null" else counts + has_null
    return Compacted(DeviceColumn(counts, None, T.int64()),
                     num_groups.to(torch.int32))


@register("hash_first_last", "hash_aggregate")
def grouped_first_last(ctx, values: DeviceColumn, gids, num_groups,
                       skip_nulls: bool = True, min_count: int = 0,
                       num_segments=None):
    """``{"first": ..., "last": ...}``: the node makes two columns of it."""
    return {"first": grouped_first(ctx, values, gids, num_groups,
                                   skip_nulls, min_count, num_segments),
            "last": grouped_last(ctx, values, gids, num_groups, skip_nulls,
                                 min_count, num_segments)}


def _centred_moments(ctx, values: DeviceColumn, gids, num_segments,
                     power: int):
    """(segment bound, live counts, the sums of the centred values'
    squares and of their ``power``-th powers), in f64, a decimal
    descaled: three ``segment_sum`` calls, the reference's two passes."""
    values = decode_numeric_dict(values)
    nseg, live, seg = _prep(ctx, values, gids, num_segments)
    v = dtypes.as_float64(values.values, values.value_dtype)
    f = _dec_factor(values.type)
    if f is not None:
        v = v * f
    v = torch.where(live, v, 0.0)
    counts = segment_count(live, seg, nseg)
    means = segment_sum(v, seg, nseg, live) / counts.clamp(min=1).to(
        torch.float64)
    c = torch.where(live, v - means[seg.long()], 0.0)
    m2 = segment_sum(c * c, seg, nseg, live)
    mp = segment_sum(c * c * c if power == 3 else c * c * c * c, seg, nseg,
                     live)
    return nseg, counts, m2, mp


@register("hash_skew", "hash_aggregate")
def grouped_skew(ctx, values: DeviceColumn, gids, num_groups,
                 skip_nulls: bool = True, biased: bool = True,
                 min_count: int = 0, num_segments=None):
    """``sqrt(n) * m3 / m2**1.5``, as the reference's; ``biased=False``
    and ``skip_nulls=False`` as the port's scalar ``skew`` (the reference
    ignores both here). Valid where the group has ``max(min_count, 1)``
    values."""
    nseg, counts, m2, m3 = _centred_moments(ctx, values, gids,
                                            num_segments, 3)
    n = counts.to(torch.float64)
    sk = torch.sqrt(n.clamp(min=1.0)) * m3 / m2.clamp(min=1e-300) ** 1.5
    if not biased:
        sk = sk * torch.sqrt(n * (n - 1.0)) / (n - 2.0).clamp(min=1.0)
    return _out(DeviceColumn(sk, _validity(
        ctx, values, gids, counts, nseg, max(min_count, 1), skip_nulls),
        T.float64()), num_groups)


@register("hash_kurtosis", "hash_aggregate")
def grouped_kurtosis(ctx, values: DeviceColumn, gids, num_groups,
                     skip_nulls: bool = True, biased: bool = True,
                     min_count: int = 0, num_segments=None):
    """``n * m4 / m2**2 - 3``, as the reference's; ``biased`` and
    ``skip_nulls`` as ``hash_skew``'s."""
    nseg, counts, m2, m4 = _centred_moments(ctx, values, gids,
                                            num_segments, 4)
    n = counts.to(torch.float64)
    kt = n.clamp(min=1.0) * m4 / (m2 * m2).clamp(min=1e-300) - 3.0
    if not biased:
        kt = ((n - 1.0) / ((n - 2.0) * (n - 3.0)).clamp(min=1.0)
              * ((n + 1.0) * kt + 6.0))
    return _out(DeviceColumn(kt, _validity(
        ctx, values, gids, counts, nseg, max(min_count, 1), skip_nulls),
        T.float64()), num_groups)


def _grouped_quantile(ctx, values: DeviceColumn, gids, num_groups,
                      q: float, num_segments) -> Compacted:
    """Each group's linear quantile: the live, non-NaN rows sorted by
    (group, value order), each group's run read at ``q * (n - 1)``; null
    where the group has no such row."""
    values = decode_numeric_dict(values)
    cap = ctx.capacity
    nseg, live, _ = _prep(ctx, values, gids, num_segments)
    v = dtypes.as_float64(values.values, values.value_dtype)
    f = _dec_factor(values.type)
    if f is not None:
        v = v * f
    live = live & ~torch.isnan(v)
    seg = torch.where(live, gids, 0)
    gkey = torch.where(live, gids, cap)
    perm = stable_sort_indices([gkey, order_word(DeviceColumn(v, None,
                                                              None))])
    sv = torch.where(live, v, float("inf"))[perm]
    counts = segment_count(live, seg, nseg)
    starts = torch.cumsum(counts, 0) - counts
    pos = q * (counts.clamp(min=1).to(torch.float64) - 1.0)
    lo, hi = torch.floor(pos), torch.ceil(pos)
    vlo = sv[(starts + lo.long()).clamp(0, cap - 1)]
    vhi = sv[(starts + hi.long()).clamp(0, cap - 1)]
    return _out(DeviceColumn(vlo + (vhi - vlo) * (pos - lo), counts > 0,
                             T.float64()), num_groups)


@register("hash_approximate_median", "hash_aggregate")
def grouped_approximate_median(ctx, values: DeviceColumn, gids, num_groups,
                               skip_nulls: bool = True, min_count: int = 0,
                               num_segments=None):
    """The exact median, as the reference gives it (which ignores
    ``skip_nulls`` and ``min_count`` here, as the port does)."""
    return _grouped_quantile(ctx, values, gids, num_groups, 0.5,
                             num_segments)


@register("hash_tdigest", "hash_aggregate")
def grouped_tdigest(ctx, values: DeviceColumn, gids, num_groups, q=0.5,
                    delta: int = 100, buffer_size: int = 500,
                    skip_nulls: bool = True, min_count: int = 0,
                    num_segments=None):
    """The exact linear quantile at ``q`` (the first of several)."""
    qq = q[0] if isinstance(q, (list, tuple)) else q
    return _grouped_quantile(ctx, values, gids, num_groups, float(qq),
                             num_segments)
