"""Grouper: multi-column key -> dense group ids (counterpart of
``arrow_tpu/compute/grouper.py``).

When every key is dictionary-coded or bool and the combined slot space is
small, a group's slot is the mixed-radix code of its keys and grouping
needs no sort (the perfect-hash path). Other keys take the general
grouper: a stable sort of the keys' equality words, run heads, and a rank
by first appearance. Either way group ids are assigned in order of first
appearance, as in the reference.

The same grouping serves ``unique``, ``value_counts``,
``dictionary_encode`` and ``unique_batch``: values come out in order of
first appearance (``torch.unique`` would sort them).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from .. import types as T
from ..device.column import DeviceBatch, DeviceColumn, round_up
from ..types import TypeId
from .keys import GROUP_KEY_DEAD, group_key_arrays, stable_sort_indices
from .move import segment_count, segment_reduce
from .registry import ExecContext, register
from .selection import Compacted, gather_columns, take_batch


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


def _group_ids_sorted(ctx: ExecContext,
                      key_cols: Sequence[DeviceColumn]) -> GroupResult:
    """The reference's general grouper, ``direct`` branch
    (``grouper.py:121-146,187-207``): a stable sort of the equality words,
    run heads, then a rank by first appearance."""
    cap = ctx.capacity
    row_mask = ctx.row_mask()
    dev = row_mask.device
    keys = group_key_arrays(key_cols, row_mask)
    perm = stable_sort_indices(keys)
    sorted_keys = [k[perm] for k in keys]
    # dead runs are marked by the class word: all-ones sorts first as int64
    sorted_mask = sorted_keys[0] != GROUP_KEY_DEAD
    is_new = torch.zeros(cap, dtype=torch.bool, device=dev)
    is_new[0] = True
    for k in sorted_keys:
        is_new[1:] |= k[1:] != k[:-1]
    is_new &= sorted_mask
    gid_sorted = torch.cumsum(is_new, 0) - 1
    num_groups = is_new.sum(dtype=torch.int64)
    perm32 = perm.to(torch.int32)
    # each group's first row: the min of its rows' indices (slot cap drops)
    first_pos32 = torch.full((cap + 1,), cap, dtype=torch.int32, device=dev)
    first_pos32.scatter_reduce_(
        0, torch.where(sorted_mask, gid_sorted, cap),
        torch.where(sorted_mask, perm32, cap), "amin", include_self=True)
    first_pos = first_pos32[:cap].to(torch.int64)
    # rank groups by first appearance -> appearance-order ids
    idx = torch.arange(cap, dtype=torch.int64, device=dev)
    order = torch.argsort(torch.where(idx < num_groups, first_pos, 2 * cap),
                          stable=True)
    rank32 = torch.empty(cap, dtype=torch.int32, device=dev)
    rank32[order] = torch.arange(cap, dtype=torch.int32, device=dev)
    gid_appearance_sorted = rank32[gid_sorted.clamp(0, cap - 1)]
    gids32 = torch.empty(cap, dtype=torch.int32, device=dev)
    gids32[perm] = torch.where(sorted_mask, gid_appearance_sorted, cap)
    return GroupResult(gids32.to(torch.int64), num_groups, first_pos[order])


def group_ids(ctx: ExecContext,
              key_cols: Sequence[DeviceColumn]) -> GroupResult:
    sizes = _perfect_hash_sizes(key_cols, ctx.capacity)
    if sizes is None:
        return _group_ids_sorted(ctx, key_cols)
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


def _first_rows(ctx: ExecContext, g: GroupResult) -> torch.Tensor:
    """Each group's first row, 0 past the group count."""
    idx = torch.arange(ctx.capacity, dtype=torch.int64,
                       device=g.rep_indices.device)
    return torch.where(idx < g.num_groups, g.rep_indices, 0)


def unique_batch(ctx: ExecContext, batch: DeviceBatch,
                 key_names: Sequence[str]) -> DeviceBatch:
    """The distinct rows of ``key_names``, in order of first appearance."""
    g = group_ids(ctx, [batch.column(n) for n in key_names])
    return take_batch(batch.select(list(key_names)), _first_rows(ctx, g),
                      g.num_groups.to(torch.int32))


@register("unique", "vector")
def unique(ctx, col: DeviceColumn) -> Compacted:
    g = group_ids(ctx, [col])
    (out,) = gather_columns([col], _first_rows(ctx, g))
    return Compacted(out, g.num_groups.to(torch.int32))


@register("value_counts", "vector")
def value_counts(ctx, col: DeviceColumn):
    """``{"values": the distinct values, "counts": their rows}``, in order
    of first appearance."""
    g = group_ids(ctx, [col])
    cap = ctx.capacity
    live = g.group_ids < cap
    counts = segment_count(live, torch.where(live, g.group_ids, 0), cap)
    (rep,) = gather_columns([col], _first_rows(ctx, g))
    n = g.num_groups.to(torch.int32)
    return {"values": Compacted(rep, n),
            "counts": Compacted(DeviceColumn(counts, None, T.int64()), n)}


@register("dictionary_encode", "vector")
def dictionary_encode(ctx, col: DeviceColumn) -> Compacted:
    """Each row's group id as an int32 code (0 on dead rows), typed as a
    dictionary of the column's type: the codes of the values in order of
    first appearance. The values themselves stay with the column, as in
    the reference."""
    g = group_ids(ctx, [col])
    codes = torch.where(g.group_ids < ctx.capacity, g.group_ids,
                        0).to(torch.int32)
    return Compacted(DeviceColumn(codes, col.validity,
                                  T.dictionary(T.int32(), col.type)),
                     ctx.row_count)
