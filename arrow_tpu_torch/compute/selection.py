"""Selection helpers (counterpart of ``arrow_tpu/compute/selection.py``):
filter masks, compaction of filtered rows and row gathers.

Filtered rows keep the batch's static capacity: the kept rows move to the
front and the live count rides as a 0-d device tensor. ``compact_columns``
moves every buffer of a batch through one launch of the compaction kernel
(``move.compact_by_mask``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..device.column import DeviceBatch, DeviceColumn
from .move import compact_by_mask
from .registry import ExecContext


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
