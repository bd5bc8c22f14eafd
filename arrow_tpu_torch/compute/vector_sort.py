"""The sort family (counterpart of ``arrow_tpu/compute/vector_sort.py``):
``sort_indices``, ``array_sort_indices``, ``select_k_unstable``,
``partition_nth_indices``, ``rank``, the ``cumulative_*`` functions and
``pairwise_diff``.

Every sort is the stable multi-key sort of ``keys.sort_key_arrays``
(``keys.stable_sort_indices``), so each result is the reference's
permutation exactly: ``select_k_unstable`` is that sort's head, and
``partition_nth_indices`` the whole sort. A dictionary column sorts by its
codes, as the reference's ``order_word`` does. Indices come out as uint64
(stored as int64 bits).

A cumulative function keeps the reference's value dtypes (``jnp.cumsum``
keeps int8-int32 and turns bool into int64; torch would widen every
integer), and its float sums and products run in an order fixed by the
input (``_scan``), so a column gives the same bits on every run.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .. import dtypes
from .. import types as T
from ..device.column import DeviceColumn
from .keys import group_key_arrays, sort_key_arrays, stable_sort_indices
from .registry import ExecContext, register, register_alias
from .selection import Compacted

_SCAN_BLOCK = 1024


def device_sort_indices(ctx: ExecContext, cols: Sequence[DeviceColumn],
                        orders: Sequence[str],
                        null_placement: str = "at_end") -> torch.Tensor:
    return stable_sort_indices(sort_key_arrays(cols, orders, null_placement,
                                               ctx.row_mask()))


def _orders(sort_keys, n: int):
    """Each key's order from a ``sort_keys`` of orders or (name, order)
    pairs; all ascending when it is None."""
    return [sk[1] if isinstance(sk, (list, tuple)) else sk
            for sk in (sort_keys or ["ascending"] * n)]


def _indices(perm: torch.Tensor, count) -> Compacted:
    return Compacted(DeviceColumn(perm.to(torch.int64), None, T.uint64()),
                     count)


@register("sort_indices", "vector")
def sort_indices(ctx, *cols, sort_keys=None,
                 null_placement: str = "at_end") -> Compacted:
    perm = device_sort_indices(ctx, list(cols),
                               _orders(sort_keys, len(cols)), null_placement)
    return _indices(perm, ctx.row_count)


@register("array_sort_indices", "vector")
def array_sort_indices(ctx, col, order: str = "ascending",
                       null_placement: str = "at_end") -> Compacted:
    return _indices(device_sort_indices(ctx, [col], [order], null_placement),
                    ctx.row_count)


@register("select_k_unstable", "vector")
def select_k_unstable(ctx, *cols, k: int = 1, sort_keys=None) -> Compacted:
    """The stable sort's first ``k`` rows (nulls last: the reference
    takes no ``null_placement`` here)."""
    perm = device_sort_indices(ctx, list(cols),
                               _orders(sort_keys, len(cols)), "at_end")
    return _indices(perm, ctx.row_count.clamp(max=k).to(torch.int32))


@register("partition_nth_indices", "vector")
def partition_nth_indices(ctx, col, pivot: int = 0,
                          null_placement: str = "at_end") -> Compacted:
    """The whole sort, which meets any pivot's partition contract."""
    return _indices(device_sort_indices(ctx, [col], ["ascending"],
                                        null_placement), ctx.row_count)


@register("rank", "vector")
def rank(ctx, col, sort_keys="ascending", null_placement: str = "at_end",
         tiebreaker: str = "first") -> Compacted:
    """1-based ranks in row order. Ties (equal equality words: nulls tie,
    NaNs tie, -0.0 and 0.0 do not) take the run's first position
    (``min``), its last (``max``), the run's number (``dense``) or each
    row's own position (``first``). Padding rows rank too, last."""
    if tiebreaker not in ("first", "min", "max", "dense"):
        raise ValueError(f"bad tiebreaker {tiebreaker!r}")
    order = sort_keys if isinstance(sort_keys, str) else _orders(
        sort_keys, 1)[0]
    cap = ctx.capacity
    perm = device_sort_indices(ctx, [col], [order], null_placement)
    idx = torch.arange(cap, dtype=torch.int64, device=perm.device)
    ranks = torch.empty(cap, dtype=torch.int64, device=perm.device)
    if tiebreaker == "first":
        ranks[perm] = idx + 1
        return _indices(ranks, ctx.row_count)
    is_new = torch.zeros(cap, dtype=torch.bool, device=perm.device)
    is_new[0] = True
    for k in group_key_arrays([col], ctx.row_mask()):
        sk = k[perm]
        is_new[1:] |= sk[1:] != sk[:-1]
    if tiebreaker == "dense":
        rank_sorted = torch.cumsum(is_new, 0)
    else:
        run_start = _scan(torch.where(is_new, idx, 0), "max", 0)
        rank_sorted = run_start + 1
        if tiebreaker == "max":
            # run lengths by integer index_add_: exact in any order
            run_id = torch.cumsum(is_new, 0) - 1
            run_len = torch.zeros(cap, dtype=torch.int64, device=perm.device)
            run_len.index_add_(0, run_id, torch.ones_like(run_id))
            rank_sorted = run_start + run_len[run_id]
    ranks[perm] = rank_sorted
    return _indices(ranks, ctx.row_count)


# --- cumulative / pairwise ------------------------------------------------

_SCANS = {"sum": (torch.cumsum, torch.add), "prod": (torch.cumprod, torch.mul),
          "min": (lambda x, d: torch.cummin(x, d).values, torch.minimum),
          "max": (lambda x, d: torch.cummax(x, d).values, torch.maximum)}


def _scan(x: torch.Tensor, op: str, ident=None) -> torch.Tensor:
    """Inclusive scan of a 1-d tensor by ``op`` ("sum", "prod", "min" or
    "max"; ``ident`` its identity for the padding, needed for min and
    max). Float sums and products, and every min and max, run block by
    block: each block of ``_SCAN_BLOCK`` rows scans alone (one row of a 2-d
    scan), the blocks' totals scan the same way, and each block combines
    its predecessors' total. So a float scan adds in an order fixed by the
    input (a 1-d scan on the card combines its tiles in an order that
    varies from run to run), and a min or max scan runs in many blocks
    (torch's 1-d ``cummin``/``cummax`` on the card scans in one)."""
    scan, combine = _SCANS[op]
    n = x.shape[0]
    if op in ("sum", "prod") and not x.dtype.is_floating_point:
        return scan(x, 0, dtype=x.dtype)
    if n <= _SCAN_BLOCK:
        return scan(x, 0) if op in ("min", "max") else scan(x, 0,
                                                             dtype=x.dtype)
    if ident is None:
        ident = 0 if op == "sum" else 1
    rows = -(-n // _SCAN_BLOCK)
    pad = torch.full((rows * _SCAN_BLOCK - n,), ident, dtype=x.dtype,
                     device=x.device)
    blocks = scan(torch.cat([x, pad]).view(rows, _SCAN_BLOCK), 1)
    carry = _scan(blocks[:, -1].contiguous(), op, ident)
    first = torch.full((1,), ident, dtype=x.dtype, device=x.device)
    carry = torch.cat([first, carry[:-1]]).unsqueeze(1)
    return combine(blocks, carry).flatten()[:n]


_SCAN_DTYPES = {"bool": "int64"}


def _cumulative(ctx, col: DeviceColumn, op: str, skip_nulls: bool
                ) -> DeviceColumn:
    """``op`` ("sum", "prod", "min", "max" or None) over the column with
    the rows that are not live at the identity, in the reference's value
    dtype, typed as the column. With ``skip_nulls`` the column keeps its
    own validity (the reference's); else a null on a live row nulls every
    live row from it on."""
    live = col.valid_mask(ctx.row_mask())
    name = col.value_dtype
    out = None
    if op in ("sum", "prod"):
        acc = _SCAN_DTYPES.get(name, name)
        # integer sums and products wrap at the width, so the stored bits
        # (uint32 as int32) scan as the values would
        v = dtypes.convert(dtypes.load(col.values, name), name,
                           acc).to(dtypes.STORAGE[acc])
        out = _scan(torch.where(live, v, 0 if op == "sum" else 1), op)
    elif op in ("min", "max"):
        out = _running_minmax(col.values, live, name, op == "min")
    if skip_nulls:
        validity = col.validity
    else:
        seen_null = torch.cumsum(~live, 0) > 0
        base = col.valid_mask()
        validity = base & ~(seen_null & ctx.row_mask())
    return DeviceColumn(out, validity, col.type)


def _running_minmax(values, live, name, is_min) -> torch.Tensor:
    """``jnp.minimum.accumulate`` (``maximum``) with the rows that are not
    live at the identity: a NaN carries on; integers through their order
    keys (unsigned ones widened), bools as bytes."""
    op = "min" if is_min else "max"
    if values.dtype.is_floating_point:
        ident = float("inf") if is_min else float("-inf")
        v = torch.where(live, values, torch.tensor(ident, dtype=values.dtype,
                                                   device=values.device))
        return _scan(v, op, ident)
    if values.dtype == torch.bool:
        v = torch.where(live, values, is_min).to(torch.uint8)
        return _scan(v, op, int(is_min)).to(torch.bool)
    k = dtypes.order_key(dtypes.load(values, name), name)
    info = torch.iinfo(k.dtype)
    ident = info.max if is_min else info.min
    k = torch.where(live, k, ident)
    return dtypes.store(dtypes.order_key(_scan(k, op, ident), name), name)


def _with_start(r: DeviceColumn, start, combine) -> DeviceColumn:
    if start is None:
        return r
    name = dtypes.dtype_of_values(r.values, r.type)
    s = dtypes.literal(start, name, r.values.device)
    v = dtypes.store(combine(dtypes.load(r.values, name), s), name)
    return DeviceColumn(v, r.validity, r.type)


def _in_order(fn, name):
    """``fn`` (``torch.minimum`` or ``maximum``) of two ``COMPUTE``
    tensors of dtype ``name`` in value order (uint64 by its order key)."""
    def combine(a, b):
        return dtypes.order_key(fn(dtypes.order_key(a, name),
                                   dtypes.order_key(b, name)), name)
    return combine


@register("cumulative_sum", "elementwise")
def cumulative_sum(ctx, col, start=None, skip_nulls: bool = False):
    return _with_start(_cumulative(ctx, col, "sum", skip_nulls), start,
                       torch.add)


@register("cumulative_prod", "elementwise")
def cumulative_prod(ctx, col, start=None, skip_nulls: bool = False):
    return _with_start(_cumulative(ctx, col, "prod", skip_nulls), start,
                       torch.mul)


@register("cumulative_min", "elementwise")
def cumulative_min(ctx, col, start=None, skip_nulls: bool = False):
    return _with_start(_cumulative(ctx, col, "min", skip_nulls), start,
                       _in_order(torch.minimum, col.value_dtype))


@register("cumulative_max", "elementwise")
def cumulative_max(ctx, col, start=None, skip_nulls: bool = False):
    return _with_start(_cumulative(ctx, col, "max", skip_nulls), start,
                       _in_order(torch.maximum, col.value_dtype))


@register("cumulative_mean", "elementwise")
def cumulative_mean(ctx, col, skip_nulls: bool = False):
    """The running sum of the live values in f64 (unscaled, for a
    decimal) over the running count of live rows."""
    live = col.valid_mask(ctx.row_mask())
    v = torch.where(live, dtypes.as_float64(col.values, col.value_dtype),
                    0.0)
    counts = torch.cumsum(live, 0).to(torch.float64)
    out = _scan(v, "sum") / counts.clamp(min=1.0)
    validity = _cumulative(ctx, col, None, skip_nulls).validity
    return DeviceColumn(out, validity, T.float64())


@register("pairwise_diff", "elementwise")
def pairwise_diff(ctx, col, period: int = 1):
    """``values - roll(values, period)`` in the values' dtype (wrapping),
    valid where both rows are and the shifted row lies inside the
    column."""
    cap = ctx.capacity
    name = col.value_dtype
    if name == "bool":
        raise TypeError("pairwise_diff of a bool column: numpy boolean "
                        "subtract is not supported")
    v = col.values
    if dtypes.is_float(name):
        out = v - torch.roll(v, period)
    else:
        # two's complement: the stored bits subtract as the unsigned do
        out = (v.to(torch.int64) - torch.roll(v, period).to(torch.int64)
               ).to(v.dtype)
    idx = torch.arange(cap, dtype=torch.int64, device=v.device)
    in_range = idx >= period if period >= 0 else idx < cap + period
    base = col.valid_mask()
    validity = base & torch.roll(base, period) & in_range
    return DeviceColumn(out, validity, col.type)


register_alias("pairwise_diff_checked", "pairwise_diff")
# the reference registers these two with extra_kernels.py
register_alias("cumulative_sum_checked", "cumulative_sum")
register_alias("cumulative_prod_checked", "cumulative_prod")
