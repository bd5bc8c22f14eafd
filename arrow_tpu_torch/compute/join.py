"""Equi-join kernels (counterpart of ``arrow_tpu/compute/join.py``).

The build side is sorted by key, and every probe row finds its run of
matches with two binary searches (``torch.searchsorted``). A single key of
one dtype kind takes the direct path: the build side's order words are
sorted and searched as they are. Other keys go through one shared grouper
over both sides' equality words, which maps equal keys to equal dense
ids. Matches expand by an exclusive prefix sum and a search of the output
row in it.

Two phases: ``build_join_plan`` returns everything sized by the inputs,
the total match count included; the caller reads the total back, picks the
output capacity, and ``join_gather_indices`` makes the row indices.

Only inner joins are ported (ROADMAP.md, queue 1, item 7). Null keys never
match. Within each probe row, matches come in ascending build-row order.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from ..device.column import DeviceColumn
from .keys import equality_word, order_word, stable_sort_indices
from .move import compact_by_mask, gather_rows

_INT64_MAX = (1 << 63) - 1


class JoinPlan(NamedTuple):
    """Probe state sized by the input capacities."""
    order_b: torch.Tensor     # build rows in sorted order (int64)
    left: torch.Tensor        # per probe row: first match in order_b
    counts: torch.Tensor      # per probe row: number of matches
    offsets: torch.Tensor     # exclusive prefix sum of the counts
    total: torch.Tensor       # total output rows (0-d int64)
    probe_live: torch.Tensor  # probe row is live


def _require_inner(join_type: str):
    if join_type != "inner":
        raise NotImplementedError(
            f"{join_type!r} joins are not ported yet; only inner joins "
            "are (ROADMAP.md, queue 1, item 7: joins)")


def _null_mask(col: DeviceColumn) -> torch.Tensor:
    if col.validity is None:
        return torch.zeros(col.capacity, dtype=torch.bool,
                           device=col.values.device)
    return ~col.validity


def _side_gids(build_cols: Sequence[DeviceColumn],
               probe_cols: Sequence[DeviceColumn],
               build_mask: torch.Tensor, probe_mask: torch.Tensor):
    """Both sides' keys mapped to shared dense ids by one sorted grouping
    over the concatenation; null keys and dead rows get per-row negative
    ids that match nothing."""
    b_cap = build_cols[0].capacity
    n = b_cap + probe_cols[0].capacity
    null_b = torch.zeros_like(build_mask)
    null_p = torch.zeros_like(probe_mask)
    keys = []
    for bc, pc in zip(build_cols, probe_cols):
        null_b = null_b | _null_mask(bc)
        null_p = null_p | _null_mask(pc)
        keys.append(torch.cat([equality_word(bc), equality_word(pc)]))
    live = torch.cat([build_mask & ~null_b, probe_mask & ~null_p])
    all_keys = [torch.where(live, 0, 1)] + [torch.where(live, k, 0)
                                            for k in keys]
    perm = stable_sort_indices(all_keys)
    is_new = torch.zeros(n, dtype=torch.bool, device=live.device)
    is_new[0] = True
    for k in all_keys:
        sk = k[perm]
        is_new[1:] |= sk[1:] != sk[:-1]
    gids = torch.empty(n, dtype=torch.int64, device=live.device)
    gids[perm] = torch.cumsum(is_new, 0) - 1
    idx = torch.arange(n, dtype=torch.int64, device=live.device)
    gids = torch.where(live, gids, -(idx + 2))
    return gids[:b_cap], gids[b_cap:]


def _direct_key_kind(col: DeviceColumn) -> Optional[str]:
    """Dtype kind for the direct single-key path: both sides must share
    one, because order words normalise kinds differently."""
    dt = col.values.dtype
    if dt == torch.bool:
        return "b"
    if dt.is_floating_point:
        return "f"
    return "i"


def _use_direct_single_key(build_cols, probe_cols) -> bool:
    if len(build_cols) != 1 or len(probe_cols) != 1:
        return False
    return _direct_key_kind(build_cols[0]) == _direct_key_kind(probe_cols[0])


def _direct_word(col: DeviceColumn) -> torch.Tensor:
    """Order word that is also equality-preserving: every NaN maps to the
    top of the signed order (no non-NaN float reaches it), so NaN joins
    NaN as on the grouper path."""
    w = order_word(col)
    if col.values.dtype.is_floating_point:
        w = torch.where(torch.isnan(col.values), _INT64_MAX, w)
    return w


def build_join_plan(build_cols: Sequence[DeviceColumn],
                    probe_cols: Sequence[DeviceColumn],
                    build_count, probe_count,
                    join_type: str = "inner") -> JoinPlan:
    _require_inner(join_type)
    b_cap = build_cols[0].capacity
    p_cap = probe_cols[0].capacity
    dev = build_cols[0].values.device
    build_mask = torch.arange(b_cap, dtype=torch.int32,
                              device=dev) < build_count
    probe_mask = torch.arange(p_cap, dtype=torch.int32,
                              device=dev) < probe_count

    if _use_direct_single_key(build_cols, probe_cols):
        # sort only the build side by (live class, word) and search the
        # probe's words in it
        bc, pc = build_cols[0], probe_cols[0]
        wb, wp = _direct_word(bc), _direct_word(pc)
        live_b = build_mask & ~_null_mask(bc)
        live_p = probe_mask & ~_null_mask(pc)
        order_b = stable_sort_indices([torch.where(live_b, 0, 1), wb])
        live_count = live_b.sum()
        # dead rows sort to the tail: pin their words to the top so the
        # array stays monotone, then clamp the searches to the live region,
        # so an INT64_MAX probe word (int64 max, NaN) only matches a live
        # INT64_MAX build row
        pos = torch.arange(b_cap, device=dev)
        sorted_w = torch.where(pos < live_count, wb[order_b], _INT64_MAX)
        left = torch.searchsorted(sorted_w, wp).clamp(max=live_count)
        right = torch.searchsorted(sorted_w, wp, right=True) \
            .clamp(max=live_count)
        counts = torch.where(live_p, right - left, 0)
    else:
        gb, gp = _side_gids(build_cols, probe_cols, build_mask, probe_mask)
        # build rows by id, dead rows (negative ids) last
        order_b = torch.argsort(torch.where(gb >= 0, gb * 2, _INT64_MAX),
                                stable=True)
        sorted_gb_raw = gb[order_b]
        sorted_gb = torch.where(sorted_gb_raw >= 0, sorted_gb_raw, 1 << 62)
        valid = gp >= 0
        gp_search = torch.where(valid, gp, -1)
        left = torch.searchsorted(sorted_gb, gp_search)
        right = torch.searchsorted(sorted_gb, gp_search, right=True)
        counts = torch.where(valid, right - left, 0)

    out_counts = torch.where(probe_mask, counts, 0)
    offsets = torch.cumsum(out_counts, 0) - out_counts
    total = out_counts.sum()
    return JoinPlan(order_b, left, counts, offsets, total, probe_mask)


def join_gather_indices(plan: JoinPlan, out_capacity: int,
                        join_type: str = "inner",
                        unique_build: bool = False):
    """The plan expanded into (probe_idx, build_idx), each of length
    ``out_capacity``; rows from ``plan.total`` on are padding.

    ``unique_build`` is the primary-key path (the caller saw every probe
    row match at most one build row): the matched probe rows are the
    output rows, in order, so one compaction of the probe indices and
    their match positions replaces the expansion search. The reference
    sorts by the drop flag for this; both give the same live rows."""
    _require_inner(join_type)
    b_len = plan.order_b.shape[0]
    dev = plan.counts.device
    if unique_build:
        p_cap = plan.counts.shape[0]
        iota = torch.arange(p_cap, dtype=torch.int64, device=dev)
        (s_iota, s_left), _ = compact_by_mask(plan.counts > 0,
                                              [iota, plan.left])
        probe_idx = s_iota[:out_capacity]
        (build_idx,) = gather_rows([plan.order_b],
                                   s_left[:out_capacity].clamp(max=b_len - 1))
        return probe_idx, build_idx
    # the probe row of output row i: the first inclusive prefix sum past i
    out_i = torch.arange(out_capacity, dtype=torch.int64, device=dev)
    inclusive = plan.offsets + plan.counts.where(plan.probe_live, 0)
    probe_idx = torch.searchsorted(inclusive, out_i, right=True) \
        .clamp(max=plan.offsets.shape[0] - 1)
    g_offsets, g_counts, g_left = gather_rows(
        [plan.offsets, plan.counts, plan.left], probe_idx)
    k = out_i - g_offsets
    sorted_pos = g_left + torch.minimum(k, (g_counts - 1).clamp(min=0))
    (build_idx,) = gather_rows([plan.order_b],
                               sorted_pos.clamp(max=b_len - 1))
    return probe_idx, build_idx

