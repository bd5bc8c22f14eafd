"""Grouped ("hash_") aggregates: sum, mean, count, count_all (counterpart of
``arrow_tpu/compute/hash_agg.py``).

Each takes (values, group ids int64[capacity] with ``capacity`` on dead
rows) and returns per-group results at the static segment bound plus the
group count. Sums and means reduce through ``move.segment_reduce``, which
sends float sums to the grouped-sum kernel.
"""

from __future__ import annotations

import torch

from .. import types as T
from ..device.column import DeviceColumn
from ..types import DataType, TypeId
from .move import segment_count, segment_reduce
from .registry import register
from .selection import Compacted


def _sum_dtype(dt: torch.dtype) -> torch.dtype:
    return torch.float64 if dt.is_floating_point else torch.int64


def _sum_type(t: DataType) -> DataType:
    if t.id in (TypeId.BOOL, TypeId.INT32, TypeId.INT64):
        return T.int64()
    return T.float64()


_LONG_TAIL = "(ROADMAP.md, queue 1, item 9: the long tail)"


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
    v = torch.where(live, v, torch.zeros((), dtype=v.dtype, device=v.device))
    return segment_reduce(v, seg, nseg, "sum", 0)


@register("hash_sum", "hash_aggregate")
def grouped_sum(ctx, values: DeviceColumn, gids, num_groups,
                skip_nulls: bool = True, min_count: int = 1,
                num_segments=None):
    _require_values("hash_sum", values)
    _require_defaults("hash_sum", skip_nulls, min_count)
    nseg, live, seg = _prep(ctx, values, gids, num_segments)
    sums = _segment_sum(values.values.to(_sum_dtype(values.values.dtype)),
                        live, seg, nseg)
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
    sums = _segment_sum(values.values.to(torch.float64), live, seg, nseg)
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
