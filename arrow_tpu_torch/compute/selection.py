"""Selection (counterpart of ``arrow_tpu/compute/selection.py``): filter
masks, compaction of filtered rows, row gathers, and the registered vector
functions ``filter``, ``array_filter``, ``drop_null``, ``take``,
``array_take``, ``inverse_permutation`` and ``scatter``.

Filtered rows keep the batch's static capacity: the kept rows move to the
front and the live count rides as a 0-d device tensor. ``compact_columns``
moves every buffer of a batch through one launch of the compaction kernel
(``move.compact_by_mask``): ``filter``, ``array_filter`` and ``drop_null``
are one launch each. ``take`` with ``boundscheck=True`` reads one flag
back and raises IndexError on a live index out of range, where the
reference returns an ``ErrGuard``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from .. import dtypes
from ..device.column import DeviceBatch, DeviceColumn
from .move import compact_by_mask
from .registry import ExecContext, register


class Compacted:
    """A vector-kernel result: a column at static capacity + live count."""

    __slots__ = ("column", "count")

    def __init__(self, column: DeviceColumn, count: torch.Tensor):
        self.column = column
        self.count = count


def selection_mask(ctx: ExecContext, mask_col: DeviceColumn,
                   null_selection: str = "drop"):
    """bool keep-mask per Arrow FilterOptions semantics: null mask slots
    drop (default) or emit null rows. Returns (keep, emit_null)."""
    mv = mask_col.values.to(torch.bool)
    if mask_col.validity is None or null_selection == "drop":
        keep = mv
        if mask_col.validity is not None:
            keep = keep & mask_col.validity
        emit_null = None
    else:
        keep = (mv & mask_col.validity) | ~mask_col.validity
        emit_null = ~mask_col.validity
    return keep & ctx.row_mask(), emit_null


def _buffers(cols: Sequence[DeviceColumn],
             extra_null: Optional[torch.Tensor]):
    """Every values and validity buffer of ``cols``, with ``extra_null``
    rows turned null, and per column whether it has validity."""
    arrays, spec = [], []
    for c in cols:
        arrays.append(c.values)
        validity = c.validity
        if extra_null is not None:
            base = validity if validity is not None else torch.ones(
                c.capacity, dtype=torch.bool, device=c.values.device)
            validity = base & ~extra_null
        if validity is not None:
            arrays.append(validity)
        spec.append(validity is not None)
    return arrays, spec


def _columns(cols: Sequence[DeviceColumn], spec,
             outs: Sequence[torch.Tensor]) -> List[DeviceColumn]:
    res, i = [], 0
    for c, has_v in zip(cols, spec):
        vals = outs[i]
        i += 1
        validity = None
        if has_v:
            validity = outs[i]
            i += 1
        res.append(DeviceColumn(vals, validity, c.type, c.dictionary))
    return res


def compact_columns(cols: Sequence[DeviceColumn], keep: torch.Tensor,
                    extra_null: Optional[torch.Tensor] = None):
    """Kept rows to the front across all columns, every values and
    validity buffer in one compaction. Returns (columns, count)."""
    arrays, spec = _buffers(cols, extra_null)
    outs, count = compact_by_mask(keep, arrays)
    return _columns(cols, spec, outs), count


def filter_batch(batch: DeviceBatch, mask_col: DeviceColumn,
                 null_selection: str = "drop") -> DeviceBatch:
    ctx = ExecContext(batch.capacity, batch.row_count)
    keep, emit_null = selection_mask(ctx, mask_col, null_selection)
    cols, count = compact_columns(batch.columns, keep, emit_null)
    return DeviceBatch(batch.schema, cols, count)


def gather_columns(cols: Sequence[DeviceColumn], idx: torch.Tensor,
                   valid: Optional[torch.Tensor] = None
                   ) -> List[DeviceColumn]:
    """Rows ``idx`` of every column. Indices out of range read the nearest
    end row, as the reference's ``move.gather_rows`` does; callers mask
    them. ``valid`` (the reference's ``join.gather_batch_columns``) nulls
    the rows where it is False, on top of each column's own validity."""
    out = []
    for c in cols:
        safe = idx.clamp(0, c.capacity - 1)
        validity = c.validity[safe] if c.validity is not None else None
        if valid is not None:
            validity = valid if validity is None else validity & valid
        out.append(DeviceColumn(c.values[safe], validity, c.type,
                                c.dictionary))
    return out


def take_batch(batch: DeviceBatch, indices: torch.Tensor,
               count: torch.Tensor) -> DeviceBatch:
    """Whole batch rows gathered by a plain index tensor (no null
    indices)."""
    return DeviceBatch(batch.schema, gather_columns(batch.columns, indices),
                       count)


# --- registered vector functions ----------------------------------------------

@register("filter", "vector")
def filter_values(ctx, values: DeviceColumn, mask: DeviceColumn,
                  null_selection_behavior: str = "drop") -> Compacted:
    keep, emit_null = selection_mask(ctx, mask, null_selection_behavior)
    (out,), count = compact_columns([values], keep, emit_null)
    return Compacted(out, count)


@register("array_filter", "vector")
def array_filter(ctx, values: DeviceColumn, mask: DeviceColumn,
                 null_selection_behavior: str = "drop") -> Compacted:
    return filter_values(ctx, values, mask, null_selection_behavior)


@register("drop_null", "vector")
def drop_null(ctx, values: DeviceColumn) -> Compacted:
    (out,), count = compact_columns([values],
                                    values.valid_mask(ctx.row_mask()))
    return Compacted(out, count)


@register("take", "vector", ctx_arg=1)
def take(ctx, values: DeviceColumn, indices: DeviceColumn, n_values=None,
         boundscheck: bool = True) -> Compacted:
    """Rows ``indices`` of ``values``; ``ctx`` is the indices' context. A
    null index gives a null row; an index out of ``[0, n_values)`` (the
    values' capacity by default) reads row 0, under the indices' and row
    0's validity, as the reference's does, or raises IndexError where
    ``boundscheck`` is set."""
    idx = dtypes.load(indices.values, indices.value_dtype).to(torch.int64)
    live = indices.valid_mask(ctx.row_mask())
    limit = values.capacity if n_values is None else n_values
    in_range = (idx >= 0) & (idx < limit)
    if boundscheck and bool((live & ~in_range).any()):
        raise IndexError("take: index out of bounds")
    safe = torch.where(live & in_range, idx, 0).clamp(0, values.capacity - 1)
    validity = None
    if indices.validity is not None or values.validity is not None:
        validity = torch.ones(indices.capacity, dtype=torch.bool,
                              device=idx.device)
        if indices.validity is not None:
            validity = validity & indices.validity
        if values.validity is not None:
            validity = validity & values.validity[safe]
    return Compacted(DeviceColumn(values.values[safe], validity, values.type,
                                  values.dictionary), ctx.row_count)


@register("array_take", "vector", ctx_arg=1)
def array_take(ctx, values: DeviceColumn, indices: DeviceColumn,
               n_values=None, boundscheck: bool = True) -> Compacted:
    return take(ctx, values, indices, n_values, boundscheck)


def _scatter_slots(ctx, indices: DeviceColumn) -> torch.Tensor:
    """Each row's slot for ``.at[idx].set(..., mode="drop")``: negative
    indices count from the end, as jnp's do; dead rows and indices out of
    range go to the extra slot ``cap``, which is cut off."""
    cap = ctx.capacity
    idx = dtypes.load(indices.values, indices.value_dtype).to(torch.int64)
    idx = torch.where(idx < 0, idx + cap, idx)
    ok = indices.valid_mask(ctx.row_mask()) & (idx >= 0) & (idx < cap)
    return torch.where(ok, idx, cap)


@register("inverse_permutation", "vector")
def inverse_permutation(ctx, indices: DeviceColumn,
                        max_index=None) -> Compacted:
    """``out[indices[i]] = i`` over the live indices, in the indices'
    dtype; slots no index reached are null."""
    cap = ctx.capacity
    slot = _scatter_slots(ctx, indices)
    dev = slot.device
    out = torch.zeros(cap + 1, dtype=indices.values.dtype, device=dev)
    out[slot] = torch.arange(cap, device=dev).to(indices.values.dtype)
    hit = torch.zeros(cap + 1, dtype=torch.bool, device=dev)
    hit[slot] = True
    return Compacted(DeviceColumn(out[:cap], hit[:cap], indices.type),
                     ctx.row_count)


@register("scatter", "vector")
def scatter(ctx, values: DeviceColumn, indices: DeviceColumn,
            max_index=None) -> Compacted:
    """``out[indices[i]] = values[i]`` over the live indices; a slot is
    valid where the value written there was."""
    cap = values.capacity
    slot = _scatter_slots(ctx, indices)
    dev = slot.device
    out = torch.zeros(cap + 1, dtype=values.values.dtype, device=dev)
    out[slot] = values.values
    hit = torch.zeros(cap + 1, dtype=torch.bool, device=dev)
    hit[slot] = values.valid_mask()
    return Compacted(DeviceColumn(out[:cap], hit[:cap], values.type,
                                  values.dictionary), ctx.row_count)
