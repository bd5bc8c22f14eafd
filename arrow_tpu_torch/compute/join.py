"""Equi-join kernels (counterpart of ``arrow_tpu/compute/join.py``).

The build side is sorted by key, and every probe row finds its run of
matches with two binary searches (``torch.searchsorted``). A single key of
one dtype kind takes the direct path: the build side's order words are
sorted and searched as they are. Other keys go through one shared grouper
over both sides' equality words, which maps equal keys to equal dense
ids. Matches expand by an exclusive prefix sum and a search of the output
row in it.

Two phases: ``build_join_plan`` returns everything sized by the inputs,
the total output count included; the caller reads the total back, picks
the output capacity, and ``join_gather_indices`` makes the row indices.

Join types: inner, left/right/full outer, left/right semi/anti. Null keys
never match but still come out of the outer joins. Within each probe row,
matches come in ascending build-row order.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from .. import dtypes
from ..device.column import DeviceColumn
from .keys import equality_word, order_word, stable_sort_indices
from .move import compact_by_mask, gather_rows

_INT64_MAX = (1 << 63) - 1
# the join types whose output needs to know which build rows matched
BUILD_SIDE_TYPES = ("right outer", "full outer", "right semi", "right anti")


class JoinPlan(NamedTuple):
    """Probe state sized by the input capacities."""
    order_b: torch.Tensor     # build rows in sorted order (int64)
    left: torch.Tensor        # per probe row: first match in order_b
    counts: torch.Tensor      # per probe row: number of matches
    out_counts: torch.Tensor  # per probe row: output rows of the join type
    offsets: torch.Tensor     # exclusive prefix sum of out_counts
    total: torch.Tensor       # total probe-side output rows (0-d int64)
    probe_live: torch.Tensor  # probe row is live
    # per build row: matched a live probe row (BUILD_SIDE_TYPES only)
    build_matched: Optional[torch.Tensor]


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
    one, because order words normalise kinds differently (an unsigned
    key joined to a signed one takes the grouper path, whose equality
    words share one space)."""
    name = col.value_dtype
    if name == "bool":
        return "b"
    if dtypes.is_float(name):
        return "f"
    return "u" if dtypes.is_unsigned(name) else "i"


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

    if join_type in ("left outer", "full outer"):
        # an unmatched live probe row still gives one row
        out_counts = torch.where(counts == 0, 1, counts)
    elif join_type == "left semi":
        out_counts = (counts > 0).long()
    elif join_type == "left anti":
        out_counts = (counts == 0).long()
    else:
        out_counts = counts
    out_counts = torch.where(probe_mask, out_counts, 0)
    offsets = torch.cumsum(out_counts, 0) - out_counts
    total = out_counts.sum()
    build_matched = None
    if join_type in BUILD_SIDE_TYPES:
        build_matched = _build_matched(order_b, left, counts)
    return JoinPlan(order_b, left, counts, out_counts, offsets, total,
                    probe_mask, build_matched)


def _build_matched(order_b, left, counts) -> torch.Tensor:
    """Build rows inside some live probe row's match run, by a difference
    array over the sorted build positions: +1 where a run opens, -1 where
    it closes, a prefix sum, then a scatter back to build-row order. (The
    reference sorts the run ends instead, because scatters serialize on a
    TPU.) Runs lie in the live region of the sorted build side, so dead
    and padding build rows are never matched."""
    b_cap = order_b.shape[0]
    is_match = counts > 0
    diff = torch.zeros(b_cap + 1, dtype=torch.int32, device=counts.device)
    # unmatched probe rows add +1 and -1 at the unused slot b_cap
    diff.index_add_(0, torch.where(is_match, left, b_cap),
                    torch.ones_like(left, dtype=torch.int32))
    diff.index_add_(0, torch.where(is_match, left + counts, b_cap),
                    torch.full_like(left, -1, dtype=torch.int32))
    covered = torch.cumsum(diff[:b_cap], 0) > 0
    matched = torch.empty(b_cap, dtype=torch.bool, device=counts.device)
    matched[order_b] = covered
    return matched


def join_gather_indices(plan: JoinPlan, out_capacity: int,
                        join_type: str = "inner",
                        unique_build: bool = False):
    """The plan expanded into (probe_idx, build_idx, build_valid), the
    indices of length ``out_capacity``; rows from ``plan.total`` on are
    padding. ``build_valid`` is False on the rows of an unmatched probe
    row, whose build side is null, and None for the join types that have
    no such rows (all but left and full outer).

    ``unique_build`` is the primary-key path (the caller saw every probe
    row match at most one build row). For a left outer join each probe row
    gives exactly its own output row, so the expansion is the identity and
    ``out_capacity`` must be the probe capacity. For an inner join the
    matched probe rows are the output rows, in order, so one compaction of
    the probe indices and their match positions replaces the expansion
    search (the reference sorts by the drop flag; both give the same live
    rows)."""
    b_len = plan.order_b.shape[0]
    p_cap = plan.counts.shape[0]
    dev = plan.counts.device
    if unique_build and join_type == "left outer":
        if out_capacity != p_cap:
            raise ValueError(f"the identity expansion needs the probe "
                             f"capacity {p_cap}, not {out_capacity}")
        (build_idx,) = gather_rows([plan.order_b],
                                   plan.left.clamp(max=b_len - 1))
        probe_idx = torch.arange(p_cap, dtype=torch.int64, device=dev)
        return probe_idx, build_idx, (plan.counts > 0) & plan.probe_live
    if unique_build and join_type == "inner":
        iota = torch.arange(p_cap, dtype=torch.int64, device=dev)
        (s_iota, s_left), _ = compact_by_mask(plan.counts > 0,
                                              [iota, plan.left])
        probe_idx = s_iota[:out_capacity]
        (build_idx,) = gather_rows([plan.order_b],
                                   s_left[:out_capacity].clamp(max=b_len - 1))
        return probe_idx, build_idx, None
    if unique_build:
        raise ValueError(f"no unique-build expansion for {join_type!r} "
                         "joins")
    # the probe row of output row i: the first inclusive prefix sum past i
    out_i = torch.arange(out_capacity, dtype=torch.int64, device=dev)
    probe_idx = torch.searchsorted(plan.offsets + plan.out_counts, out_i,
                                   right=True).clamp(max=p_cap - 1)
    g_offsets, g_counts, g_left = gather_rows(
        [plan.offsets, plan.counts, plan.left], probe_idx)
    k = out_i - g_offsets
    sorted_pos = g_left + torch.minimum(k, (g_counts - 1).clamp(min=0))
    (build_idx,) = gather_rows([plan.order_b],
                               sorted_pos.clamp(max=b_len - 1))
    build_valid = None
    if join_type in ("left outer", "full outer"):
        build_valid = (g_counts > 0) & (out_i < plan.total)
    return probe_idx, build_idx, build_valid


def unmatched_build_plan(plan: JoinPlan, build_count):
    """(unmatched, matched) masks of the live build rows, for the
    BUILD_SIDE_TYPES."""
    b_cap = plan.build_matched.shape[0]
    build_mask = torch.arange(b_cap, dtype=torch.int32,
                              device=plan.build_matched.device) < build_count
    return (build_mask & ~plan.build_matched,
            build_mask & plan.build_matched)
