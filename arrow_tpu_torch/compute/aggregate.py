"""Scalar (whole-column) aggregates: sum, mean, count, count_all, min and
max (counterpart of ``arrow_tpu/compute/aggregate.py``).

Each is one masked reduction over the padded column: the live rows are
the rows of the batch's row mask (narrowed by a filter folded into the
aggregate) whose value is valid. The result is a 0-d value, a 0-d
validity and the result type, all on the column's device, so nothing is
read back. Null semantics are ScalarAggregateOptions' defaults
(``skip_nulls=True, min_count=1``): an empty or all-null input gives a
null sum, mean, min or max; other options raise NotImplementedError.
Sums accumulate as the reference's ``jnp.sum`` does (int64 for signed
integers and bool, uint64 for unsigned ones, f64 for floats, an exact
int64 for a decimal's unscaled values); a decimal's mean stays a decimal,
rounded half away from zero. No kernel runs here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import dtypes
from .. import types as T
from ..device.column import DeviceColumn
from ..types import DataType
from .hash_agg import (_LONG_TAIL, _require_defaults, _require_values,
                       _sum_type, decimal_mean, sum_values)
from .registry import ExecContext, register


class AggResult(NamedTuple):
    value: torch.Tensor  # 0-d, on the column's device
    valid: torch.Tensor  # 0-d bool
    type: DataType


def _masked(ctx: ExecContext, col: DeviceColumn, identity):
    """(values with ``identity`` on the rows that are not live, live row
    count as a 0-d int64)."""
    live = col.valid_mask(ctx.row_mask())
    fill = torch.tensor(identity, dtype=col.values.dtype,
                        device=col.values.device)
    return (torch.where(live, col.values, fill),
            live.sum(dtype=torch.int64))


@register("sum", "aggregate")
def scalar_sum(ctx, a: DeviceColumn, skip_nulls: bool = True,
               min_count: int = 1) -> AggResult:
    _require_values("sum", a)
    _require_defaults("sum", skip_nulls, min_count)
    live = a.valid_mask(ctx.row_mask())
    v = sum_values(a)
    v = torch.where(live, v, torch.zeros((), dtype=v.dtype, device=v.device))
    return AggResult(v.sum(), live.sum(dtype=torch.int64) >= 1,
                     _sum_type(a.type))


@register("mean", "aggregate")
def scalar_mean(ctx, a: DeviceColumn, skip_nulls: bool = True,
                min_count: int = 1) -> AggResult:
    """0/0 gives NaN, under a null (``min_count=1``)."""
    _require_values("mean", a)
    _require_defaults("mean", skip_nulls, min_count)
    v, n = _masked(ctx, a, 0)
    if a.type.is_decimal:
        return AggResult(decimal_mean(v.to(torch.int64).sum(), n), n >= 1,
                         a.type)
    f = dtypes.as_float64(v, a.value_dtype)
    return AggResult(f.sum() / n.to(torch.float64), n >= 1, T.float64())


def _minmax(name: str, ctx, a: DeviceColumn, skip_nulls: bool,
            min_count: int, is_min: bool) -> AggResult:
    """The identity (+-inf, the integer range's end, True/False) fills
    the rows that are not live, so it is also what an empty input gives,
    under a null."""
    if a.dictionary is not None:
        raise NotImplementedError(
            f"{name} over a dictionary-coded column is not ported yet "
            + _LONG_TAIL)
    _require_defaults(name, skip_nulls, min_count)
    dt = a.values.dtype
    if dt == torch.bool:
        identity = is_min
    elif dt.is_floating_point:
        identity = float("inf") if is_min else float("-inf")
    else:
        # integers reduce by their order keys (``dtypes.order_key``)
        name = a.value_dtype
        k = dtypes.order_key(dtypes.load(a.values, name), name)
        info = torch.iinfo(k.dtype)
        live = a.valid_mask(ctx.row_mask())
        k = torch.where(live, k, info.max if is_min else info.min)
        out = k.min() if is_min else k.max()
        return AggResult(dtypes.store(dtypes.order_key(out, name), name),
                         live.sum(dtype=torch.int64) >= 1, a.type)
    v, n = _masked(ctx, a, identity)
    return AggResult(v.min() if is_min else v.max(), n >= 1, a.type)


@register("min", "aggregate")
def scalar_min(ctx, a: DeviceColumn, skip_nulls: bool = True,
               min_count: int = 1) -> AggResult:
    return _minmax("min", ctx, a, skip_nulls, min_count, True)


@register("max", "aggregate")
def scalar_max(ctx, a: DeviceColumn, skip_nulls: bool = True,
               min_count: int = 1) -> AggResult:
    return _minmax("max", ctx, a, skip_nulls, min_count, False)


@register("count", "aggregate")
def scalar_count(ctx, a: DeviceColumn, mode: str = "only_valid"
                 ) -> AggResult:
    if mode != "only_valid":
        raise NotImplementedError(
            f"count with mode={mode!r} is not ported yet " + _LONG_TAIL)
    n = a.valid_mask(ctx.row_mask()).sum(dtype=torch.int64)
    return AggResult(n, torch.ones_like(n, dtype=torch.bool), T.int64())


@register("count_all", "aggregate")
def scalar_count_all(ctx) -> AggResult:
    """The rows of the row mask."""
    n = ctx.row_mask().sum(dtype=torch.int64)
    return AggResult(n, torch.ones_like(n, dtype=torch.bool), T.int64())
