"""Selection helpers (counterpart of ``arrow_tpu/compute/selection.py``):
filter masks and direct row gathers. Compaction of filtered rows, the
K2 kernel's work, is not ported yet."""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..device.column import DeviceColumn
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


def gather_columns(cols: Sequence[DeviceColumn],
                   idx: torch.Tensor) -> List[DeviceColumn]:
    """Rows ``idx`` of every column. Indices out of range read row 0, as
    the reference's ``move.gather_rows`` does; callers mask them."""
    out = []
    for c in cols:
        safe = torch.where((idx >= 0) & (idx < c.capacity), idx, 0)
        validity = c.validity[safe] if c.validity is not None else None
        out.append(DeviceColumn(c.values[safe], validity, c.type,
                                c.dictionary))
    return out


def filter_batch(batch, mask_col, null_selection: str = "drop"):
    raise NotImplementedError(
        "a standalone filter compacts rows, which the K2 compaction kernel "
        "will do (ROADMAP.md, queue 1, item 5: selection and compaction)")
