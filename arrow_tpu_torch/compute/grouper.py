"""Grouper: multi-column key -> dense group ids (counterpart of
``arrow_tpu/compute/grouper.py``).

Only the perfect-hash path is ported: when every key is dictionary-coded or
bool and the combined slot space is small, a group's slot is the
mixed-radix code of its keys and grouping needs no sort. Group ids are
assigned in order of first appearance, as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from ..device.column import DeviceColumn, round_up
from ..types import TypeId
from .move import segment_reduce
from .registry import ExecContext


class GroupResult(NamedTuple):
    group_ids: torch.Tensor    # int64[capacity]; capacity on dead rows
    num_groups: torch.Tensor   # int64 scalar
    rep_indices: torch.Tensor  # int64[capacity]: each group's first row
                               # (garbage past num_groups)


_PERFECT_HASH_MAX_SLOTS = 1 << 16


def _perfect_hash_sizes(key_cols: Sequence[DeviceColumn], cap: int):
    """Per-key radix sizes (each with a null bucket) when every key is
    dictionary-coded or bool and the slot space fits, else None."""
    sizes = []
    total = 1
    for c in key_cols:
        if c.dictionary is not None:
            size = len(c.dictionary) + 1
        elif c.type.id == TypeId.BOOL:
            size = 3
        else:
            return None
        sizes.append(size)
        total *= size
        if total > min(cap, _PERFECT_HASH_MAX_SLOTS):
            return None
    return sizes


def _group_ids_perfect(ctx: ExecContext, key_cols: Sequence[DeviceColumn],
                       sizes) -> GroupResult:
    cap = ctx.capacity
    row_mask = ctx.row_mask()
    dev = row_mask.device
    n_slots = 1
    for s in sizes:
        n_slots *= s
    slot = torch.zeros(cap, dtype=torch.int32, device=dev)
    for c, size in zip(key_cols, sizes):
        code = c.values.to(torch.int32)
        null_code = size - 1
        if c.validity is not None:
            code = torch.where(c.validity, code, null_code)
        slot = slot * size + code.clamp(0, null_code)
    idx32 = torch.arange(cap, dtype=torch.int32, device=dev)
    seg = torch.where(row_mask, slot, 0)
    first_pos = segment_reduce(torch.where(row_mask, idx32, cap), seg,
                               n_slots, "min", cap).long()
    observed = first_pos < cap
    order = torch.argsort(torch.where(observed, first_pos, 2 * cap),
                          stable=True)
    rank = torch.empty(n_slots, dtype=torch.int64, device=dev)
    rank[order] = torch.arange(n_slots, dtype=torch.int64, device=dev)
    num_groups = observed.sum(dtype=torch.int64)
    gids = torch.where(row_mask, rank[slot.long()], cap)
    rep = first_pos[order]
    if n_slots < cap:
        rep = torch.cat([rep, torch.zeros(cap - n_slots, dtype=torch.int64,
                                          device=dev)])
    return GroupResult(gids, num_groups, rep[:cap])


def group_ids(ctx: ExecContext,
              key_cols: Sequence[DeviceColumn]) -> GroupResult:
    sizes = _perfect_hash_sizes(key_cols, ctx.capacity)
    if sizes is None:
        raise NotImplementedError(
            "grouping on keys that are not perfect-hashable needs the "
            "sort-based grouper (ROADMAP.md, queue 1, item 6: sort keys, "
            "the general grouper and sort)")
    return _group_ids_perfect(ctx, key_cols, sizes)


def group_slot_bound_exact(key_cols: Sequence[DeviceColumn],
                           cap: int) -> int:
    """Exact perfect-hash slot count (unpadded), or cap when the keys are
    not perfect-hashable. Kernels reduce at this bound."""
    sizes = _perfect_hash_sizes(key_cols, cap)
    if sizes is None:
        return cap
    n = 1
    for s in sizes:
        n *= s
    return min(n, cap)


def group_capacity_bound(key_cols: Sequence[DeviceColumn], cap: int) -> int:
    """Static bound on the number of groups, padded to a block: the
    capacity of an aggregate's output batch."""
    sizes = _perfect_hash_sizes(key_cols, cap)
    if sizes is None:
        return cap
    n = 1
    for s in sizes:
        n *= s
    return min(cap, round_up(n, 1024))
