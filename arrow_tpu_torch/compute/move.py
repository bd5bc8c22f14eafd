"""Bulk data movement and segment reductions (counterpart of
``arrow_tpu/compute/move.py``).

The port follows the reference's ``direct`` movement semantics, the ones it
uses on CPU and GPU: native scatters and gathers, 64-bit values kept at
full width. Compaction runs the compaction kernel
(``kernels/compact.py``) and float sums over at most 1024 segments the
grouped-sum kernel (``kernels/grouped_sum.py``); everything else is plain
PyTorch.

Float sums add in an order fixed by the input, so one input gives the same
bits on every run, as the reference's sums do: the grouped-sum kernel sums
its per-block partials in block order, and a sum over more segments sorts
the live rows by segment (stably) and reduces each segment's run without
atomics (``torch.segment_reduce``). ``index_add_``'s atomics serve only integer
sums and counts, which are exact in any order.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..kernels.compact import compact
from ..kernels.grouped_sum import MAX_SEGMENTS, grouped_sum


# Rows where ``keep`` is True moved to the front in order, zeros after them,
# in every array through one compaction; plus the kept count as a 0-d int32
# tensor on the device (the reference's ``direct`` contract).
compact_by_mask = compact


def gather_rows(arrays: Sequence[torch.Tensor],
                idx: torch.Tensor) -> List[torch.Tensor]:
    """``out_k[j] = arrays_k[idx[j]]``; indices out of range read the
    nearest end row (callers mask them)."""
    safe = idx.clamp(0, arrays[0].shape[0] - 1)
    return [a[safe] for a in arrays]


def _empty_value(dtype: torch.dtype, op: str):
    """What an empty segment holds, as in ``jax.ops.segment_min``/``max``:
    the identity of the reduction."""
    if dtype.is_floating_point:
        return float("inf") if op == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


def segment_reduce(values: torch.Tensor, gids: torch.Tensor,
                   num_segments: int, op: str, identity) -> torch.Tensor:
    """Per-segment integer sum, min or max (exact in any order; a float
    sum takes ``segment_sum``). ``gids`` must lie in
    ``[0, num_segments)``; dead rows are mapped to an in-range slot by the
    caller, with ``values`` holding ``identity`` there."""
    if op == "sum":
        out = torch.zeros(num_segments, dtype=values.dtype,
                          device=values.device)
        return out.index_add_(0, gids.long(), values)
    if op in ("min", "max"):
        out = torch.full((num_segments,), _empty_value(values.dtype, op),
                         dtype=values.dtype, device=values.device)
        return out.scatter_reduce_(0, gids.long(), values, "a" + op,
                                   include_self=True)
    raise ValueError(f"unknown segment reduction {op!r}")


def segment_sum(values: torch.Tensor, gids: torch.Tensor,
                num_segments: int,
                live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-segment float sum in an order fixed by the input: the
    grouped-sum kernel for at most ``MAX_SEGMENTS`` segments; else the live
    rows, stably sorted by segment, each segment's run summed by
    ``torch.segment_reduce`` over the runs present. Rows where ``live`` is
    False are left out (the kernel path takes them with the value 0 the
    caller gave them)."""
    if num_segments <= MAX_SEGMENTS:
        return grouped_sum(values, gids.to(torch.int32), num_segments)
    out = torch.zeros(num_segments, dtype=values.dtype, device=values.device)
    # int32 sort keys: segment ids lie below 2**31
    seg, v = gids.to(torch.int32), values
    if live is not None:
        rows = live.nonzero().squeeze(1)
        seg, v = seg[rows], v[rows]
    if not seg.numel():
        return out
    order = torch.argsort(seg, stable=True)
    present, lengths = torch.unique_consecutive(seg[order],
                                                return_counts=True)
    out[present.long()] = torch.segment_reduce(v[order], "sum", lengths=lengths,
                                        unsafe=True)
    return out


def segment_count(live: torch.Tensor, gids: torch.Tensor,
                  num_segments: int) -> torch.Tensor:
    """Count live rows per segment (int64)."""
    out = torch.zeros(num_segments, dtype=torch.int64, device=live.device)
    return out.index_add_(0, gids.long(), live.long())
