"""Grouped ("hash_") aggregates: sum, mean, count, count_all, min, max and
count_distinct (counterpart of ``arrow_tpu/compute/hash_agg.py``).

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
(group, value word) pairs and counts their boundaries. The aggregate
options other than the defaults, and sums over dictionary columns, raise
NotImplementedError naming their ROADMAP item.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import dtypes
from .. import types as T
from ..device.column import DeviceColumn
from ..types import DataType, TypeId
from .keys import _LOW63, equality_word, order_word, stable_sort_indices
from .move import _empty_value, segment_count, segment_reduce, segment_sum
from .registry import register
from .selection import Compacted


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


_LONG_TAIL = "(ROADMAP.md, queue 1, item 9.7: aggregates)"


def _require_values(name: str, values: DeviceColumn):
    if values.dictionary is not None:
        raise NotImplementedError(
            f"{name} over a dictionary-coded column is not ported yet "
            + _LONG_TAIL)


def _require_defaults(name: str, skip_nulls: bool, min_count: int):
    if not skip_nulls or min_count != 1:
        raise NotImplementedError(
            f"{name} with skip_nulls={skip_nulls}, min_count={min_count} is "
            "not ported yet; only the defaults are " + _LONG_TAIL)


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


@register("hash_sum", "hash_aggregate")
def grouped_sum(ctx, values: DeviceColumn, gids, num_groups,
                skip_nulls: bool = True, min_count: int = 1,
                num_segments=None):
    _require_values("hash_sum", values)
    _require_defaults("hash_sum", skip_nulls, min_count)
    nseg, live, seg = _prep(ctx, values, gids, num_segments)
    sums = _segment_sum(sum_values(values), live, seg, nseg)
    validity = segment_count(live, seg, nseg) >= 1
    return Compacted(DeviceColumn(sums, validity, _sum_type(values.type)),
                     num_groups.to(torch.int32))


@register("hash_mean", "hash_aggregate")
def grouped_mean(ctx, values: DeviceColumn, gids, num_groups,
                 skip_nulls: bool = True, min_count: int = 1,
                 num_segments=None):
    _require_values("hash_mean", values)
    _require_defaults("hash_mean", skip_nulls, min_count)
    nseg, live, seg = _prep(ctx, values, gids, num_segments)
    counts = segment_count(live, seg, nseg)
    if values.type.is_decimal:
        sums = _segment_sum(values.values.to(torch.int64), live, seg, nseg)
        return Compacted(DeviceColumn(decimal_mean(sums, counts),
                                      counts >= 1, values.type),
                         num_groups.to(torch.int32))
    name = values.value_dtype
    sums = _segment_sum(dtypes.as_float64(values.values, name), live, seg,
                        nseg)
    means = sums / counts.clamp(min=1).to(torch.float64)
    return Compacted(DeviceColumn(means, counts >= 1, T.float64()),
                     num_groups.to(torch.int32))


@register("hash_count", "hash_aggregate")
def grouped_count(ctx, values: DeviceColumn, gids, num_groups,
                  mode: str = "only_valid", num_segments=None):
    if mode != "only_valid":
        raise NotImplementedError(
            f"hash_count with mode={mode!r} is not ported yet " + _LONG_TAIL)
    cap = ctx.capacity
    nseg = num_segments if num_segments is not None else cap
    live = values.valid_mask(ctx.row_mask()) & (gids < cap)
    seg = torch.where(live, gids, 0).to(torch.int32)
    return Compacted(DeviceColumn(segment_count(live, seg, nseg), None,
                                  T.int64()),
                     num_groups.to(torch.int32))


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
