"""Segment reductions (counterpart of ``arrow_tpu/compute/move.py``).

The port follows the reference's ``direct`` movement semantics, the ones it
uses on CPU and GPU: native scatters and gathers, 64-bit values kept at
full width. Float sums over at most 1024 segments run the grouped-sum
kernel (``kernels/grouped_sum.py``); everything else is plain PyTorch.
"""

from __future__ import annotations

import torch

from ..kernels.grouped_sum import MAX_SEGMENTS, grouped_sum


def _empty_value(dtype: torch.dtype, op: str):
    """What an empty segment holds, as in ``jax.ops.segment_min``/``max``:
    the identity of the reduction."""
    if dtype.is_floating_point:
        return float("inf") if op == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


def segment_reduce(values: torch.Tensor, gids: torch.Tensor,
                   num_segments: int, op: str, identity) -> torch.Tensor:
    """Per-segment sum, min or max. ``gids`` must lie in
    ``[0, num_segments)``; dead rows are mapped to an in-range slot by the
    caller, with ``values`` holding ``identity`` there."""
    if op == "sum":
        if values.dtype in (torch.float32, torch.float64) and \
                num_segments <= MAX_SEGMENTS:
            return grouped_sum(values, gids.to(torch.int32), num_segments)
        out = torch.zeros(num_segments, dtype=values.dtype,
                          device=values.device)
        return out.index_add_(0, gids.long(), values)
    if op in ("min", "max"):
        out = torch.full((num_segments,), _empty_value(values.dtype, op),
                         dtype=values.dtype, device=values.device)
        return out.scatter_reduce_(0, gids.long(), values, "a" + op,
                                   include_self=True)
    raise ValueError(f"unknown segment reduction {op!r}")


def segment_count(live: torch.Tensor, gids: torch.Tensor,
                  num_segments: int) -> torch.Tensor:
    """Count live rows per segment (int64)."""
    out = torch.zeros(num_segments, dtype=torch.int64, device=live.device)
    return out.index_add_(0, gids.long(), live.long())
