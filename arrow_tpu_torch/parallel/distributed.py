"""Distributed execution over a ``torch.distributed`` process group
(counterpart of ``arrow_tpu/parallel/distributed.py``).

The reference runs one controller over a device ``Mesh`` under
``shard_map``. The port runs SPMD: a rank is a process, every rank calls
the same function with the same arguments, and a ``Mesh`` is a process
group with this process's rank and device (``make_mesh``). Every decision
that leads to a collective reads global quantities only (row totals, the
counts the ranks exchanged), so the ranks take the same branches.

* A batch is either whole (every rank holds the same rows) or a
  ``ShardBatch``: this rank's contiguous rows of it, with their global
  ``offset`` and the ``total`` over all ranks. A whole batch of ``n`` rows
  splits into ranges of ``ceil(n / W)`` rows (``shard_batch``), as the
  reference's ``shard_table`` does.
* The exchange (``exchange_rows``) sends each live row to the rank its
  partition id names: rows are ordered stably by partition id, the W
  counts (with each column's validity flag and dictionary digest) go in one
  ``all_to_all_single`` of int64s read back once, then every column's
  bytes, validity bits included, go packed as one ``(rows, B)`` uint8
  tensor in one ``all_to_all_single`` with those split sizes. One
  collective carries all columns, no padding travels, and no backend has
  to support bool, f16 or uint64. Received rows come ordered by source
  rank, then in send order: the reference's order after its
  ``all_to_all`` and compaction.
* Dictionary-coded columns travel as codes. Where the ranks' dictionaries
  of a column differ (their digests ride the counts), the dictionaries are
  all-gathered and every rank recodes into their union, in rank order.
* The collectives take the tensors where they lie. gloo takes tensors on
  the card and moves their bytes through host memory itself (PyTorch
  2.11's ``ProcessGroupGloo``, checked on an H100 for
  ``all_to_all_single`` and ``all_gather``); under NCCL they never leave
  the card. The group's backend is the caller's choice.

The partition hash is the reference's splitmix64 chain, bit for bit, over
the equality words held as int64 (``compute/keys.py``): shifts are
logical and the remainder is the unsigned one.
"""

from __future__ import annotations

import hashlib
import os
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .. import default_device, dtypes
from .. import types as T
from ..compute.grouper import group_ids, group_slot_bound_exact
from ..compute.keys import (equality_word, sort_key_arrays,
                            stable_sort_indices)
from ..compute.move import segment_count, segment_reduce, segment_sum
from ..compute.registry import ExecContext
from ..compute.selection import compact_columns, gather_columns, take_batch
from ..device.column import (DeviceBatch, DeviceColumn, round_up,
                             slice_rows)
from ..dtypes import INT64_MIN
from ..io.tpch_device import _as_int64, _mix as _mix64, _srl, shard_rows
from ..types import Field, Schema

# the reference's null-key words: a grouping key's (distributed.py:188)
# and a join key's (distributed.py:473)
NULL_GROUP_WORD = 0x517CC1B727220A95
NULL_JOIN_WORD = _as_int64(0x9E3779B97F4A7C15)
_INT64_MAX = (1 << 63) - 1

#: what the exchanges of this process moved: collectives called, the bytes
#: it sent (``bytes_remote``: to other ranks) and their host wall time
STATS: Dict[str, float] = {}

#: this rank's received rows of the last join exchange (the spread of a
#: skewed join)
LAST_JOIN: Dict[str, int] = {}


def reset_stats() -> None:
    STATS.update(collectives=0, bytes_sent=0, bytes_remote=0, seconds=0.0)


reset_stats()


class Mesh:
    """A process group as the distributed layer's mesh: this process's
    ``rank`` in it, its ``size``, the ``device`` this rank's tensors live on
    and the group's ``backend``."""

    def __init__(self, group, rank: int, size: int, device: torch.device,
                 backend: str):
        self.group = group
        self.rank = rank
        self.size = size
        self.device = device
        self.backend = backend

    def __repr__(self):
        return (f"Mesh(rank={self.rank}, size={self.size}, "
                f"device={self.device}, backend={self.backend!r})")


def make_mesh(group=None, device=None) -> Mesh:
    """The mesh of ``group`` (the default group where None) for this
    process. Raises where no process group is initialized: the caller makes
    it (``torch.distributed.init_process_group``). The device is the card
    unless another is named: ``cuda:{LOCAL_RANK}`` under NCCL (one rank a
    card), the default card under gloo."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("no torch.distributed process group is "
                           "initialized; call init_process_group first")
    rank = dist.get_rank(group)
    if rank < 0:
        raise ValueError("this process is not a member of the group")
    backend = str(dist.get_backend(group)).lower()
    if device is None and backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        device = f"cuda:{local % max(torch.cuda.device_count(), 1)}"
    dev = default_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    return Mesh(group, rank, dist.get_world_size(group), dev, backend)


class ShardBatch(DeviceBatch):
    """This rank's contiguous rows of a distributed batch: ``offset`` is
    the global index of its first row, ``total`` the rows over all
    ranks."""

    __slots__ = ("offset", "total")

    def __init__(self, schema: Schema, columns: Sequence[DeviceColumn],
                 row_count: torch.Tensor, offset: int, total: int):
        super().__init__(schema, columns, row_count)
        self.offset = int(offset)
        self.total = int(total)

    def select(self, names: Sequence[str]) -> "ShardBatch":
        b = super().select(names)
        return ShardBatch(b.schema, b.columns, b.row_count, self.offset,
                          self.total)

    def __repr__(self):
        return (f"ShardBatch(cap={self.capacity}, offset={self.offset}, "
                f"total={self.total}, cols={self.schema.names})")


def total_rows(batch: DeviceBatch) -> int:
    """The rows of a batch over all ranks."""
    if isinstance(batch, ShardBatch):
        return batch.total
    return int(batch.row_count)


def shard_batch(mesh: Mesh, batch: DeviceBatch) -> ShardBatch:
    """This rank's range of a whole ``batch`` on the mesh's device (a view
    where it lies there already); a ShardBatch is returned as it is."""
    if isinstance(batch, ShardBatch):
        return batch
    n = int(batch.row_count)
    start, stop = shard_rows(n, mesh.rank, mesh.size)
    length = stop - start
    part = slice_rows(batch, start, length, round_up(length),
                      torch.tensor(length, dtype=torch.int32,
                                   device=mesh.device))
    return ShardBatch(part.schema, part.columns, part.row_count, start, n)


def as_part(mesh: Mesh, local: DeviceBatch) -> ShardBatch:
    """``local`` (this rank's rows, in global order after the rows of the
    ranks before it) as a ShardBatch: one all-gather of the counts."""
    counts = [c[0] for c in _all_gather_ints(mesh, [int(local.row_count)])]
    return ShardBatch(local.schema, local.columns, local.row_count,
                      sum(counts[:mesh.rank]), sum(counts))


# --- collectives -------------------------------------------------------------

def _sync(mesh: Mesh):
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


def _all_to_all(mesh: Mesh, out: torch.Tensor, inp: torch.Tensor,
                out_splits=None, in_splits=None):
    t0 = time.perf_counter()
    dist.all_to_all_single(out, inp.contiguous(), out_splits, in_splits,
                           group=mesh.group)
    _sync(mesh)
    STATS["collectives"] += 1
    STATS["seconds"] += time.perf_counter() - t0


def _all_gather(mesh: Mesh, t: torch.Tensor) -> List[torch.Tensor]:
    """Every rank's ``t`` (all of one shape), in rank order."""
    t0 = time.perf_counter()
    src = t.contiguous()
    outs = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(outs, src, group=mesh.group)
    _sync(mesh)
    STATS["collectives"] += 1
    STATS["seconds"] += time.perf_counter() - t0
    return outs


def _all_gather_ints(mesh: Mesh, values: Sequence[int]) -> List[List[int]]:
    """Every rank's list of ints (all of one length), in rank order."""
    t = torch.tensor(list(values), dtype=torch.int64, device=mesh.device)
    return torch.stack(_all_gather(mesh, t)).tolist()


# --- dictionaries ------------------------------------------------------------

_DIGESTS: Dict[int, Tuple[tuple, int]] = {}


def _digest(d: tuple) -> int:
    """A 63-bit digest of a dictionary's values, the same in every process
    (Python's ``hash`` of a str is not); cached by identity."""
    hit = _DIGESTS.get(id(d))
    if hit is not None and hit[0] is d:
        return hit[1]
    h = hashlib.blake2b(repr(d).encode(), digest_size=8).digest()
    v = int.from_bytes(h, "little") >> 1
    if len(_DIGESTS) > 1024:
        _DIGESTS.clear()
    _DIGESTS[id(d)] = (d, v)
    return v


def _column_meta(cols: Sequence[DeviceColumn]) -> List[int]:
    """Per column: whether it has a validity mask, its dictionary's
    digest (0 without one)."""
    out = []
    for c in cols:
        out += [int(c.validity is not None),
                _digest(c.dictionary) if c.dictionary is not None else 0]
    return out


def _union_across(mesh: Mesh, col: DeviceColumn) -> DeviceColumn:
    """``col`` recoded into the union of every rank's dictionary of it, in
    rank order (the dictionaries are all-gathered)."""
    from ..acero.exec import _plan_unify, _recode
    dicts: List = [None] * mesh.size
    dist.all_gather_object(dicts, col.dictionary, group=mesh.group)
    union, maps = _plan_unify(dicts)
    return _recode(col, maps[mesh.rank], union)


def _settle(mesh: Mesh, cols: Sequence[DeviceColumn],
            metas: Sequence[Sequence[int]]):
    """From every rank's ``_column_meta``: the columns that carry validity
    on some rank, and ``cols`` with each dictionary that differs between
    ranks recoded into their union."""
    cols = list(cols)
    vcols = []
    for j, c in enumerate(cols):
        if any(m[2 * j] for m in metas):
            vcols.append(j)
        if c.dictionary is not None and \
                len({m[2 * j + 1] for m in metas}) > 1:
            cols[j] = _union_across(mesh, c)
    return vcols, cols


def settle_dictionaries(mesh: Mesh, cols: Sequence[DeviceColumn]
                        ) -> List[DeviceColumn]:
    """``cols`` with the same dictionaries on every rank (one all-gather of
    the digests where a column has one): codes then mean the same value
    on every rank, as a partition hash of them needs."""
    if all(c.dictionary is None for c in cols):
        return list(cols)
    metas = _all_gather_ints(mesh, _column_meta(cols))
    return _settle(mesh, cols, metas)[1]


# --- packing -----------------------------------------------------------------

_BIT_WEIGHTS = (1, 2, 4, 8, 16, 32, 64, 128)


def _pack(cols: Sequence[DeviceColumn], vcols: Sequence[int],
          rows: torch.Tensor) -> torch.Tensor:
    """Rows ``rows`` of every column as one (len(rows), B) uint8 tensor:
    each column's value bytes, then the validity bits of the columns
    ``vcols``, eight to a byte."""
    parts = []
    n = rows.shape[0]
    for c in cols:
        v = c.values.index_select(0, rows)
        parts.append(v.contiguous().view(torch.uint8).reshape(
            n, v.element_size()))
    if vcols:
        bits = torch.stack([cols[j].valid_mask().index_select(0, rows)
                            for j in vcols], 1)
        nb = -(-len(vcols) // 8)
        if bits.shape[1] < nb * 8:
            bits = torch.cat([bits, bits.new_zeros(n, nb * 8 - bits.shape[1])],
                             1)
        w = torch.tensor(_BIT_WEIGHTS, dtype=torch.int32, device=rows.device)
        parts.append((bits.view(n, nb, 8).to(torch.int32) * w).sum(2)
                     .to(torch.uint8))
    return torch.cat(parts, 1)


def _unpack(buf: torch.Tensor, like: Sequence[DeviceColumn],
            vcols: Sequence[int], capacity: int) -> List[DeviceColumn]:
    """The columns of ``_pack``'s rows, padded with zeros (and False) to
    ``capacity``; a column carries validity where it is in ``vcols``."""
    n = buf.shape[0]
    dev = buf.device
    out, off = [], 0
    for c in like:
        es = c.values.element_size()
        v = torch.zeros(capacity, dtype=c.values.dtype, device=dev)
        if n:
            # the column's bytes copied out: a view of them need not lie on
            # the element size
            x = torch.empty((n, es), dtype=torch.uint8, device=dev)
            x.copy_(buf[:, off:off + es])
            v[:n] = x.view(c.values.dtype).view(n)
        off += es
        out.append(DeviceColumn(v, None, c.type, c.dictionary))
    if vcols:
        nb = -(-len(vcols) // 8)
        shifts = torch.arange(8, dtype=torch.uint8, device=dev)
        bits = ((buf[:, off:off + nb].unsqueeze(2) >> shifts) & 1) \
            .bool().reshape(n, nb * 8)
        for i, j in enumerate(vcols):
            m = torch.zeros(capacity, dtype=torch.bool, device=dev)
            m[:n] = bits[:, i]
            out[j].validity = m
    return out


def _batch(schema: Schema, cols: List[DeviceColumn], n: int,
           device) -> DeviceBatch:
    return DeviceBatch(schema, cols, torch.tensor(n, dtype=torch.int32,
                                                  device=device))


def exchange_rows(mesh: Mesh, batch: DeviceBatch,
                  dest: torch.Tensor) -> DeviceBatch:
    """Each live row of ``batch`` sent to rank ``dest[row]``; returns the
    rows this rank received, ordered by source rank and then in the
    source's row order, at ``round_up`` of their count. Two
    ``all_to_all_single`` calls: the counts with each column's metadata
    (int64), then every column packed into one uint8 tensor."""
    W = mesh.size
    dev = batch.row_count.device
    cols = batch.columns
    key = torch.where(batch.row_mask(), dest.to(torch.int64), W)
    order = torch.sort(key, stable=True).indices
    counts = torch.bincount(key, minlength=W + 1)[:W]
    meta = torch.tensor(_column_meta(cols), dtype=torch.int64, device=dev)
    send = torch.cat([counts.view(W, 1), meta.view(1, -1).expand(W, -1)], 1)
    recv = torch.empty_like(send)
    _all_to_all(mesh, recv, send)
    host = torch.cat([counts, recv.flatten()]).tolist()
    in_splits = host[:W]
    width = send.shape[1]
    table = [host[W + s * width:W + (s + 1) * width] for s in range(W)]
    out_splits = [row[0] for row in table]
    vcols, cols = _settle(mesh, cols, [row[1:] for row in table])
    n_send, n_recv = sum(in_splits), sum(out_splits)
    buf = _pack(cols, vcols, order[:n_send])
    out = torch.empty((n_recv, buf.shape[1]), dtype=torch.uint8, device=dev)
    _all_to_all(mesh, out, buf, out_splits, in_splits)
    STATS["bytes_sent"] += buf.numel()
    STATS["bytes_remote"] += (n_send - in_splits[mesh.rank]) * buf.shape[1]
    return _batch(batch.schema, _unpack(out, cols, vcols, round_up(n_recv)),
                  n_recv, dev)


def _gather_rows(mesh: Mesh, batch: DeviceBatch):
    """(counts by rank, settled columns, validity columns, each rank's
    packed live rows) of one all-gather of the metadata and one of the
    rows, padded to the largest count."""
    n = int(batch.row_count)
    metas = _all_gather_ints(mesh, [n] + _column_meta(batch.columns))
    counts = [m[0] for m in metas]
    vcols, cols = _settle(mesh, batch.columns, [m[1:] for m in metas])
    top = max(counts)
    dev = batch.row_count.device
    rows = torch.arange(top, device=dev).clamp(max=max(batch.capacity - 1, 0))
    buf = _pack(cols, vcols, rows) if top else None
    pieces = _all_gather(mesh, buf) if top else [None] * mesh.size
    if top:
        STATS["bytes_sent"] += buf.numel()
        STATS["bytes_remote"] += buf.numel() * (mesh.size - 1)
    return counts, cols, vcols, pieces


def gather_host(mesh: Mesh, batch: DeviceBatch) -> DeviceBatch:
    """Every rank's rows of a distributed batch, in rank order, on every
    rank (an all-gather of the ranks' parts), at ``round_up`` of the
    total."""
    counts, cols, vcols, pieces = _gather_rows(mesh, batch)
    n = sum(counts)
    dev = batch.row_count.device
    if n:
        buf = torch.cat([p[:c] for p, c in zip(pieces, counts)])
    else:
        buf = torch.empty((0, 1), dtype=torch.uint8, device=dev)
    return _batch(batch.schema, _unpack(buf, cols, vcols, round_up(n)), n,
                  dev)


def gather_each(mesh: Mesh, batch: DeviceBatch,
                capacity: int) -> List[DeviceBatch]:
    """Every rank's live rows of ``batch`` as its own batch at
    ``capacity``, in rank order, on every rank."""
    counts, cols, vcols, pieces = _gather_rows(mesh, batch)
    dev = batch.row_count.device
    empty = torch.empty((0, 1), dtype=torch.uint8, device=dev)
    return [_batch(batch.schema, _unpack(p[:c] if c else empty, cols, vcols,
                                         capacity), c, dev)
            for p, c in zip(pieces, counts)]


# --- partitioning ------------------------------------------------------------

def partition_ids(key_words: Sequence[torch.Tensor],
                  n_parts: int) -> torch.Tensor:
    """The reference's partition of each row (int32): splitmix64 over the
    key words (uint64 bits held as int64), ``h % n_parts`` unsigned."""
    h = torch.zeros_like(key_words[0], dtype=torch.int64)
    for w in key_words:
        h = _mix64(h ^ _mix64(w.to(torch.int64)))
    r = torch.remainder(h, n_parts)
    # h < 0 holds h + 2**64 as unsigned
    r = torch.where(h < 0, (r + (1 << 64) % n_parts) % n_parts, r)
    return r.to(torch.int32)


def _key_words(cols: Sequence[DeviceColumn],
               null_word: int) -> List[torch.Tensor]:
    return [torch.where(c.valid_mask(), equality_word(c), null_word)
            for c in cols]


def _owner(starts: Sequence[int], ids: torch.Tensor) -> torch.Tensor:
    """The rank whose range holds each global row id (ranges start at
    ``starts``, in rank order); ids past the last row go to the last
    rank."""
    s = torch.tensor(starts, dtype=torch.int64, device=ids.device)
    return (torch.bucketize(ids, s, right=True) - 1).clamp(0, len(starts) - 1)


def _with(batch: DeviceBatch, name: str, col: DeviceColumn) -> DeviceBatch:
    return DeviceBatch(Schema(list(batch.schema.fields) + [Field(name,
                                                                 col.type)]),
                       list(batch.columns) + [col], batch.row_count)


def _drop(batch: DeviceBatch, prefix: str) -> DeviceBatch:
    """``batch`` without the columns whose names start with ``prefix``, by
    position (a join's output may hold one name twice)."""
    keep = [i for i, f in enumerate(batch.schema.fields)
            if not f.name.startswith(prefix)]
    return DeviceBatch(Schema([batch.schema.fields[i] for i in keep]),
                       [batch.columns[i] for i in keep], batch.row_count)


def _ids(start: int, batch: DeviceBatch) -> DeviceColumn:
    return DeviceColumn(start + torch.arange(batch.capacity, dtype=torch.int64,
                                             device=batch.row_count.device),
                        None, T.int64())


# --- grouped aggregation -----------------------------------------------------

class DistAggSpec(NamedTuple):
    column: str          # value column name
    fn: str              # sum | count | min | max | mean
    out_name: str


_AGG_FNS = ("sum", "count", "min", "max", "mean")


def _groupby_part(mesh: Mesh, batch: DeviceBatch, key_names: Sequence[str],
                  aggs: Sequence[DistAggSpec]) -> ShardBatch:
    """This rank's groups of a distributed group-by: local partial
    aggregation, the groups sent to the rank their keys hash to, and the
    final aggregation of what each rank received."""
    for a in aggs:
        if a.fn not in _AGG_FNS:
            raise NotImplementedError(f"distributed aggregate {a.fn!r}")
    part = shard_batch(mesh, batch)
    dev = part.row_count.device
    cap = part.capacity
    kcols = settle_dictionaries(mesh, [part.column(k) for k in key_names])
    ctx = ExecContext(cap, part.row_count)
    g = group_ids(ctx, kcols)
    nseg = group_slot_bound_exact(kcols, cap)
    live_row = g.group_ids < cap
    grp = torch.arange(nseg, dtype=torch.int64, device=dev) < g.num_groups
    cols = gather_columns(kcols, torch.where(grp, g.rep_indices[:nseg], 0))
    fields = [Field(k, c.type) for k, c in zip(key_names, kcols)]
    for i, a in enumerate(aggs):
        c = part.column(a.column)
        alive = live_row & c.valid_mask()
        seg = torch.where(alive, g.group_ids, 0)
        if a.fn != "count":
            v = dtypes.as_float64(c.values, c.value_dtype)
            if a.fn in ("sum", "mean"):
                s = segment_sum(torch.where(alive, v, 0.0), seg, nseg, alive)
            else:
                inf = float("inf") if a.fn == "min" else float("-inf")
                s = segment_reduce(torch.where(alive, v, inf), seg, nseg,
                                   a.fn, inf)
            cols.append(DeviceColumn(s, None, T.float64()))
            fields.append(Field(f"__s{i}", T.float64()))
        cols.append(DeviceColumn(segment_count(alive, seg, nseg), None,
                                 T.int64()))
        fields.append(Field(f"__c{i}", T.int64()))
    groups = DeviceBatch(Schema(fields), cols, g.num_groups.to(torch.int32))
    pid = partition_ids(_key_words(cols[:len(kcols)], NULL_GROUP_WORD),
                        mesh.size)
    recv = exchange_rows(mesh, groups, pid)

    rcap = recv.capacity
    rkeys = recv.columns[:len(kcols)]
    ctx2 = ExecContext(rcap, recv.row_count)
    g2 = group_ids(ctx2, rkeys)
    nseg2 = group_slot_bound_exact(rkeys, rcap)
    live2 = g2.group_ids < rcap
    seg2 = torch.where(live2, g2.group_ids, 0)
    grp2 = torch.arange(nseg2, dtype=torch.int64, device=dev) < g2.num_groups
    out = gather_columns(rkeys, torch.where(grp2, g2.rep_indices[:nseg2], 0))
    out_fields = list(fields[:len(kcols)])
    for i, a in enumerate(aggs):
        c = recv.column(f"__c{i}").values
        csum = segment_reduce(torch.where(live2, c, 0), seg2, nseg2, "sum", 0)
        if a.fn == "count":
            out.append(DeviceColumn(csum, None, T.int64()))
            out_fields.append(Field(a.out_name, T.int64()))
            continue
        s = recv.column(f"__s{i}").values
        if a.fn in ("sum", "mean"):
            r = segment_sum(torch.where(live2, s, 0.0), seg2, nseg2, live2)
            if a.fn == "mean":
                r = r / csum.clamp(min=1).to(torch.float64)
        else:
            inf = float("inf") if a.fn == "min" else float("-inf")
            r = segment_reduce(torch.where(live2, s, inf), seg2, nseg2, a.fn,
                               inf)
        out.append(DeviceColumn(r, csum > 0, T.float64()))
        out_fields.append(Field(a.out_name, T.float64()))
    return as_part(mesh, DeviceBatch(Schema(out_fields), out,
                                     g2.num_groups.to(torch.int32)))


def distributed_groupby(mesh: Mesh, batch: DeviceBatch,
                        key_names: Sequence[str],
                        aggs: Sequence[DistAggSpec]) -> DeviceBatch:
    """Distributed group-by: local partial aggregation, the groups
    hash-partitioned by key across the ranks, final aggregation on each
    (reference ``distributed_groupby``). ``batch`` is whole or a
    ShardBatch. Returns the whole result on every rank: keys, then each
    aggregate (count as int64, the rest f64 with validity where a value
    was counted); rows in rank order, each rank's groups in order of
    first appearance in what it received, as the reference's host
    Table."""
    return gather_host(mesh, _groupby_part(mesh, batch, key_names, aggs))


_Q1_AGGS = [DistAggSpec("qty_m", "sum", "sum_qty"),
            DistAggSpec("price_m", "sum", "sum_base_price"),
            DistAggSpec("disc_price", "sum", "sum_disc_price"),
            DistAggSpec("charge", "sum", "sum_charge"),
            DistAggSpec("qty_m", "mean", "avg_qty"),
            DistAggSpec("price_m", "mean", "avg_price"),
            DistAggSpec("disc_m", "mean", "avg_disc"),
            DistAggSpec("qty_m", "count", "count_order")]


def distributed_q1(mesh: Mesh, lineitem: DeviceBatch,
                   cutoff_days: int = 10471) -> DeviceBatch:
    """TPC-H Q1 over the ranks (reference ``distributed_q1``): the filter
    and projection fold into each value column's validity on each rank,
    then ``distributed_groupby``; the result sorted by the two flags, on
    every rank."""
    from ..acero.exec import _node_order_by
    from ..acero.options import OrderByNodeOptions
    part = shard_batch(mesh, lineitem)
    price = part.column("l_extendedprice")
    disc = part.column("l_discount")
    qty = part.column("l_quantity")
    keep = part.column("l_shipdate").values.long() <= cutoff_days
    disc_price = price.values * (1.0 - disc.values)
    charge = disc_price * (1.0 + part.column("l_tax").values)
    cols, fields = list(part.columns), list(part.schema.fields)
    for name, vals, src in [("disc_price", disc_price, price),
                            ("charge", charge, price),
                            ("qty_m", qty.values, qty),
                            ("price_m", price.values, price),
                            ("disc_m", disc.values, disc)]:
        cols.append(DeviceColumn(vals, src.valid_mask() & keep, T.float64()))
        fields.append(Field(name, T.float64()))
    db = ShardBatch(Schema(fields), cols, part.row_count, part.offset,
                    part.total)
    out = distributed_groupby(mesh, db, ["l_returnflag", "l_linestatus"],
                              _Q1_AGGS)
    return _node_order_by(OrderByNodeOptions(
        [("l_returnflag", "ascending"), ("l_linestatus", "ascending")]),
        None)[0](out)


# --- joins -------------------------------------------------------------------

# hidden columns: the join's row ids, the sort's ranked keys
_HIDDEN = "__dist_"
RID_L, RID_R = "__dist_rid_l__", "__dist_rid_r__"
JOIN_TYPES = ("inner", "left outer", "left semi", "left anti", "right semi",
              "right anti", "right outer", "full outer")


def _unify_join_keys(mesh: Mesh, probe: DeviceBatch, build: DeviceBatch,
                     left_keys, right_keys):
    """The dictionary-coded key pairs recoded into one dictionary on every
    rank (the same on each side), so that equal values hash alike."""
    from ..acero.exec import _unify_dictionaries
    lcols, rcols = list(probe.columns), list(build.columns)
    for lk, rk in zip(left_keys, right_keys):
        li = probe.schema.get_field_index(lk)
        ri = build.schema.get_field_index(rk)
        lc, rc = lcols[li], rcols[ri]
        if lc.dictionary is None and rc.dictionary is None:
            continue
        if lc.dictionary is None or rc.dictionary is None:
            raise ValueError(
                "hashjoin key mixes dictionary-coded and plain columns")
        lc, rc = settle_dictionaries(mesh, [lc, rc])
        lcols[li], rcols[ri] = _unify_dictionaries([lc, rc])
    return (DeviceBatch(probe.schema, lcols, probe.row_count),
            DeviceBatch(build.schema, rcols, build.row_count))


def join_parts(mesh: Mesh, probe: ShardBatch, build: ShardBatch, options,
               build_ids: Optional[torch.Tensor] = None) -> ShardBatch:
    """The hash join of ``options`` (a ``HashJoinNodeOptions`` without a
    residual filter) over two distributed sides, in the single-rank
    join's output order:

    * each probe row carries its global row id (its part's offset plus
      its index), each build row its id (``build_ids``, else the same);
    * both sides go to the rank their join keys hash to (the reference's
      partition, null keys on its fixed word), and each rank runs the
      executor's join on what it received (the bloom where its probe is at
      least 4x its build);
    * each joined row goes back to the rank whose range holds its probe
      row id (its build row id for right semi and anti joins; the unmatched
      build rows of right and full outer joins, with no probe id, to the
      last rank), and each rank sorts by (probe id, build id). Each rank
      then holds a contiguous range of the single-rank join's output."""
    from ..acero.exec import _execute_hashjoin
    from ..acero.options import HashJoinNodeOptions
    jt = options.join_type
    if jt not in JOIN_TYPES or options.filter_expression is not None:
        raise NotImplementedError(f"distributed join {jt!r}"
                                  + (" with a residual filter"
                                     if options.filter_expression is not None
                                     else ""))
    probe_only = jt in ("left semi", "left anti")
    build_only = jt in ("right semi", "right anti")
    starts = _all_gather_ints(mesh, [probe.offset, build.offset])
    p_total = probe.total
    lnames = list(options.left_output) if options.left_output is not None \
        else list(probe.schema.names)
    rnames = list(options.right_output) if options.right_output is not None \
        else list(build.schema.names)
    p, b = _unify_join_keys(mesh, probe, build, options.left_keys,
                            options.right_keys)
    W = mesh.size
    pid_p = partition_ids(_key_words([p.column(k) for k in options.left_keys],
                                     NULL_JOIN_WORD), W)
    pid_b = partition_ids(_key_words([b.column(k)
                                      for k in options.right_keys],
                                     NULL_JOIN_WORD), W)
    bid = _ids(build.offset, b) if build_ids is None else \
        DeviceColumn(build_ids, None, T.int64())
    lx = exchange_rows(mesh, _with(p, RID_L, _ids(probe.offset, p)), pid_p)
    bx = exchange_rows(mesh, _with(b, RID_R, bid), pid_b)
    LAST_JOIN.update(probe_rows=int(lx.row_count),
                     build_rows=int(bx.row_count))
    local = HashJoinNodeOptions(
        jt, options.left_keys, options.right_keys,
        left_output=lnames + [RID_L], right_output=rnames + [RID_R],
        output_suffix_for_left=options.output_suffix_for_left,
        output_suffix_for_right=options.output_suffix_for_right,
        disable_bloom_filter=options.disable_bloom_filter)
    joined = _execute_hashjoin(local, lx, bx)

    def sort_keys(batch):
        if build_only:
            return [batch.column(RID_R).values]
        rl = batch.column(RID_L)
        keys = [torch.where(rl.valid_mask(), rl.values, p_total)]
        if not probe_only:
            rr = batch.column(RID_R)
            keys.append(torch.where(rr.valid_mask(), rr.values, -1))
        return keys

    if build_only:
        dest = _owner([s[1] for s in starts], sort_keys(joined)[0])
    else:
        dest = _owner([s[0] for s in starts], sort_keys(joined)[0])
    back = exchange_rows(mesh, joined, dest)
    live = back.row_mask()
    perm = stable_sort_indices([(~live).long()] + sort_keys(back))
    return as_part(mesh, _drop(take_batch(back, perm, back.row_count),
                               _HIDDEN))


def distributed_join_batches(mesh: Mesh, left: DeviceBatch,
                             right: DeviceBatch, left_keys: Sequence[str],
                             right_keys: Sequence[str],
                             join_type: str = "inner",
                             left_pre_fns: Sequence = ()) -> ShardBatch:
    """Distributed equi-join of two batches (whole or ShardBatch) of any of
    the eight join types (reference ``distributed_join_tables``):
    ``left_pre_fns`` (DeviceBatch -> DeviceBatch, the executor's lowered
    filter/project middles) run on each rank's probe rows before the
    exchange. Output columns as the reference's: left semi/anti the probe
    columns, right semi/anti the build columns, else both, a name on both
    sides suffixed ``_l``/``_r``. Rows come in the single-rank join's order
    (``join_parts``); the reference leaves them in its devices' order, for
    its caller to restore by hidden row ids."""
    from ..acero.options import HashJoinNodeOptions
    if join_type not in JOIN_TYPES:
        raise NotImplementedError(f"distributed join type {join_type!r}")
    probe = shard_batch(mesh, left)
    if left_pre_fns:
        b = probe
        for f in left_pre_fns:
            b = f(b)
        probe = as_part(mesh, b)
    opts = HashJoinNodeOptions(join_type, left_keys, right_keys,
                               output_suffix_for_left="_l",
                               output_suffix_for_right="_r")
    return join_parts(mesh, probe, shard_batch(mesh, right), opts)


def broadcast_join_batches(mesh: Mesh, left: DeviceBatch, right: DeviceBatch,
                           left_keys: Sequence[str],
                           right_keys: Sequence[str],
                           join_type: str = "inner") -> ShardBatch:
    """Skew-immune join for a small build side (reference
    ``broadcast_join_tables``): the build side whole on every rank (an
    all-gather where it is a ShardBatch), the probe side's range on each,
    no exchange of rows. Inner and left outer joins; rows in the
    single-rank order (the probe ranges are contiguous)."""
    from ..acero.exec import _execute_hashjoin
    from ..acero.options import HashJoinNodeOptions
    from ..device.column import batch_to
    if join_type not in ("inner", "left outer"):
        raise NotImplementedError(join_type)
    probe = shard_batch(mesh, left)
    build = gather_host(mesh, right) if isinstance(right, ShardBatch) \
        else batch_to(right, mesh.device)
    opts = HashJoinNodeOptions(join_type, left_keys, right_keys,
                               output_suffix_for_left="_l",
                               output_suffix_for_right="_r")
    return as_part(mesh, _execute_hashjoin(opts, probe, build))


def _hot_rows(keys: Sequence[DeviceColumn], live: torch.Tensor,
              hot: DeviceBatch, hot_names) -> torch.Tensor:
    """bool per row: its key tuple (nulls equal) is one of ``hot``'s
    rows."""
    from ..acero.chunked import _concat
    nh = hot.capacity
    cols = [_concat(hot.column(n), k) for n, k in zip(hot_names, keys)]
    n = cols[0].capacity
    ctx = ExecContext(n, torch.tensor(n, dtype=torch.int32,
                                      device=live.device))
    ctx.row_mask_ = torch.cat([hot.row_mask(), live])
    g = group_ids(ctx, cols)
    # the hot rows come first, each its own group: ids below their count
    return (g.group_ids[nh:] < hot.row_count) & live


def salted_join_batches(mesh: Mesh, left: DeviceBatch, right: DeviceBatch,
                        left_keys: Sequence[str], right_keys: Sequence[str],
                        join_type: str = "inner",
                        hot_threshold: Optional[int] = None,
                        n_salts: Optional[int] = None) -> ShardBatch:
    """Skew-resistant distributed join (reference ``salted_join_tables``,
    ``BASELINE.json`` config 5). The probe keys counted over the ranks
    (``distributed_groupby``'s grouping) give the hot keys, those with more
    than ``hot_threshold`` rows (default 4x a rank's share of the probe,
    at least 64); the few are all-gathered. Hot probe rows take a salt
    ``i mod n_salts`` (``n_salts`` defaults to the rank count) by their
    index among the hot rows in row order, cold rows salt 0; each hot
    build row is replicated once a salt. The (keys, salt) join is then
    ``join_parts``', so no rank receives a hot key's whole row mass. The
    salt columns are dropped (the reference's drop misses the suffixed
    ``__salt___l``/``__salt___r``). Rows in the single-rank order of the
    salted join."""
    from ..acero.options import HashJoinNodeOptions
    if join_type not in JOIN_TYPES:
        raise NotImplementedError(f"distributed join type {join_type!r}")
    W = mesh.size
    probe_part, build_part = shard_batch(mesh, left), shard_batch(mesh, right)
    n_salts = int(n_salts or W)
    hot_threshold = int(hot_threshold or max(4 * probe_part.total // max(W, 1),
                                             64))
    opts = HashJoinNodeOptions(join_type, left_keys, right_keys,
                               output_suffix_for_left="_l",
                               output_suffix_for_right="_r")
    probe, build = _unify_join_keys(mesh, probe_part, build_part, left_keys,
                                    right_keys)
    # every probe key tuple's rows, counted over the ranks; the hot few
    # gathered to every rank
    counted = _with(probe, "__rows__", DeviceColumn(
        torch.zeros(probe.capacity, dtype=torch.int8,
                    device=probe.row_count.device), None, T.int8()))
    groups = _groupby_part(mesh, ShardBatch(
        counted.schema, counted.columns, counted.row_count,
        probe_part.offset, probe_part.total), left_keys,
        [DistAggSpec("__rows__", "count", "__n__")])
    hot_keys, nh_local = compact_columns(
        groups.columns[:len(left_keys)],
        groups.column("__n__").values > hot_threshold)
    hot = gather_host(mesh, DeviceBatch(Schema(groups.schema.fields[
        :len(left_keys)]), hot_keys, nh_local))
    if int(hot.row_count) == 0 or n_salts <= 1:
        return join_parts(mesh, probe_part, build_part, opts)
    dev = probe.row_count.device
    lhot = _hot_rows([probe.column(k) for k in left_keys], probe.row_mask(),
                     hot, left_keys)
    rhot = _hot_rows([build.column(k) for k in right_keys], build.row_mask(),
                     hot, left_keys)
    n_b = int(build.row_count)
    hot_rows = rhot[:n_b].nonzero().squeeze(1)
    nh = hot_rows.numel()
    counts = _all_gather_ints(mesh, [int(lhot.sum()), nh])
    l_off = sum(c[0] for c in counts[:mesh.rank])
    r_off = sum(c[1] for c in counts[:mesh.rank])
    nh_total = sum(c[1] for c in counts)
    # probe: the i-th hot row over all ranks takes salt i mod n_salts
    rank_among = torch.cumsum(lhot.long(), 0) - 1 + l_off
    lsalt = torch.where(lhot, rank_among % n_salts, 0)
    probe_s = ShardBatch(*_salted(probe, lsalt), probe_part.offset,
                         probe_part.total)
    # build: every row with salt 0, then the hot rows once a salt 1..S-1,
    # each copy's id after all rows and the copies of lower salts
    base = torch.arange(n_b, device=dev)
    idx = torch.cat([base] + [hot_rows] * (n_salts - 1))
    salts = torch.cat([torch.zeros(n_b, dtype=torch.int64, device=dev)] + [
        torch.full((nh,), s, dtype=torch.int64, device=dev)
        for s in range(1, n_salts)])
    ids = torch.cat([build_part.offset + base] + [
        build_part.total + (s - 1) * nh_total + r_off
        + torch.arange(nh, device=dev) for s in range(1, n_salts)])
    m = idx.numel()
    cap = round_up(m)
    rep = take_batch(build, torch.cat([idx, idx.new_zeros(cap - m)]),
                     torch.tensor(m, dtype=torch.int32, device=dev))
    rep_s = ShardBatch(*_salted(rep, torch.cat([salts, salts.new_zeros(
        cap - m)])), build_part.offset, build_part.total)
    salted_opts = HashJoinNodeOptions(
        join_type, list(left_keys) + ["__salt__"],
        list(right_keys) + ["__salt__"], output_suffix_for_left="_l",
        output_suffix_for_right="_r")
    out = join_parts(mesh, probe_s, rep_s, salted_opts,
                     build_ids=torch.cat([ids, ids.new_zeros(cap - m)]))
    sel = _drop(out, "__salt__")
    return ShardBatch(sel.schema, sel.columns, sel.row_count, out.offset,
                      out.total)


def _salted(batch: DeviceBatch, salt: torch.Tensor):
    b = _with(batch, "__salt__", DeviceColumn(salt, None, T.int64()))
    return b.schema, b.columns, b.row_count


# --- sort --------------------------------------------------------------------

def _split_word(cls: torch.Tensor, word: torch.Tensor) -> torch.Tensor:
    """One int64 per row, nondecreasing in (class, word) order: the
    reference's ``cls << 62 | word >> 2`` on the unsigned word, its sign
    bit flipped for signed comparison."""
    u = (cls << 62) | _srl(word ^ INT64_MIN, 2)
    return u ^ INT64_MIN


_SAMPLES = 32


def _splitters(mesh: Mesh, s: torch.Tensor, n: int) -> torch.Tensor:
    """W - 1 splitters from up to 32 evenly spaced samples of each rank's
    sorted live words, all-gathered."""
    dev = s.device
    vals = torch.sort(s[:n]).values
    samp = vals[::max(n // _SAMPLES, 1)][:_SAMPLES]
    row = torch.full((_SAMPLES + 1,), _INT64_MAX, dtype=torch.int64,
                     device=dev)
    row[0] = samp.numel()
    row[1:1 + samp.numel()] = samp
    got = torch.stack(_all_gather(mesh, row))
    counts = got[:, 0].tolist()
    allv = torch.sort(torch.cat([g[1:1 + c] for g, c in zip(got, counts)])
                      ).values
    n_s = allv.numel()
    if n_s == 0:
        return allv
    step = n_s // mesh.size
    return allv[torch.arange(1, mesh.size, device=dev) * step]


def _sort_keys_of(batch: DeviceBatch, keyspec, null_placement):
    return sort_key_arrays([batch.column(k) for k, _ in keyspec],
                           [o for _, o in keyspec], null_placement,
                           batch.row_mask())


def distributed_sort_batch(mesh: Mesh, batch: DeviceBatch, sort_keys,
                           null_placement: str = "at_end") -> ShardBatch:
    """Distributed sort (reference ``distributed_sort_table``): splitters
    from samples of the first key on every rank (an all-gather), each row
    sent to the rank of its key range, a stable local sort of what each
    received. Ties keep the global input order: rows arrive by source rank,
    each rank's in its order. Dictionary keys sort by value: their
    dictionaries made the same on every rank, then ranked (``_rank_col``)
    into hidden keys. Each rank ends with a contiguous range of the sorted
    rows."""
    from ..acero.exec import _rank_col
    part = shard_batch(mesh, batch)
    sort_keys = [(k, "ascending") if isinstance(k, str) else (k[0], k[1])
                 for k in sort_keys]
    cols, fields = list(part.columns), list(part.schema.fields)
    keyspec = []
    for k, (name, order) in enumerate(sort_keys):
        i = part.schema.get_field_index(name)
        if cols[i].dictionary is None:
            keyspec.append((name, order))
            continue
        (cols[i],) = settle_dictionaries(mesh, [cols[i]])
        hidden = f"__dist_rank_{k}__"
        cols.append(_rank_col(cols[i]))
        fields.append(Field(hidden, T.int64()))
        keyspec.append((hidden, order))
    work = DeviceBatch(Schema(fields), cols, part.row_count)
    keys = _sort_keys_of(work, keyspec, null_placement)
    s = _split_word(keys[0], keys[1])
    splitters = _splitters(mesh, s, int(part.row_count))
    if splitters.numel():
        pid = torch.searchsorted(splitters, s).clamp(max=mesh.size - 1)
    else:
        pid = torch.zeros_like(s)
    recv = exchange_rows(mesh, work, pid)
    perm = stable_sort_indices(_sort_keys_of(recv, keyspec, null_placement))
    return as_part(mesh, _drop(take_batch(recv, perm, recv.row_count),
                               "__dist_rank_"))


def fetch_part(mesh: Mesh, part: ShardBatch, offset: int,
               count: int) -> ShardBatch:
    """Rows ``[offset, offset + count)`` of a distributed batch (to its end
    where ``count < 0``), each rank keeping its share."""
    n = int(part.row_count)
    stop = part.total if count < 0 else offset + count
    lo = min(max(offset - part.offset, 0), n)
    hi = min(max(stop - part.offset, lo), n)
    dev = part.row_count.device
    local = slice_rows(part, lo, hi - lo, round_up(hi - lo),
                       torch.tensor(hi - lo, dtype=torch.int32, device=dev))
    return as_part(mesh, local)



# --- the Table-level entry points --------------------------------------------
#
# The reference's user-facing forms of the joins and the sort take host
# Tables and give one. Every rank calls them with the same Tables; each
# uploads only its ``shard_rows`` range (``shard_table``), the batch forms
# above run over the ranks' parts, and every rank gets the whole result as
# a host Table (the ranks' parts all-gathered, then downloaded), as
# ``to_table(mesh=...)`` gives a plan's. ``axis``, ``out_cap_per_device``
# and the reference's static shapes serve its ``shard_map`` and change no
# result here: they are accepted and ignored. The reference truncates a 1:N
# join at its static output capacity (``ndev`` times the probe capacity,
# the probe capacity for a broadcast join); the port sizes each rank's
# output from its match count, so no row is lost.

def shard_table(mesh: Mesh, table, axis: str = "d") -> ShardBatch:
    """This rank's ``shard_rows`` range of the host ``table`` on the mesh's
    device (reference ``shard_table``): a string column is coded once over
    the whole column, as a distributed plan's host source is
    (``source_cache``), and every dictionary is then made the same on
    every rank (``settle_dictionaries``). ``axis`` is accepted and
    ignored."""
    from ..acero.options import TableSourceNodeOptions
    n = table.num_rows
    rows = shard_rows(n, mesh.rank, mesh.size)
    b = TableSourceNodeOptions(table).upload(mesh.device, rows)
    return ShardBatch(b.schema, settle_dictionaries(mesh, b.columns),
                      b.row_count, rows[0], n)


def _whole_table(mesh: Mesh, part: ShardBatch):
    """Every rank's rows of ``part``, in rank order, as one host Table on
    every rank."""
    from ..device.column import download_table
    return download_table(gather_host(mesh, part))


def distributed_join_tables(mesh: Mesh, left, right,
                            left_keys: Sequence[str],
                            right_keys: Sequence[str],
                            join_type: str = "inner",
                            out_cap_per_device: Optional[int] = None,
                            axis: str = "d",
                            left_pre_fns: Sequence = ()):
    """Distributed equi-join of two host Tables, any of the eight join
    types (reference ``distributed_join_tables``): both uploaded by rank
    range, ``distributed_join_batches`` over them (``left_pre_fns`` run on
    each rank's probe rows first), the whole joined Table on every rank.
    Columns as the reference's (probe columns only for left semi and anti,
    build columns only for right semi and anti, ``_l``/``_r`` on a name
    both sides have); rows in the single-rank join's order, where the
    reference leaves them in its devices' order. ``out_cap_per_device`` and
    ``axis`` are ignored (see above)."""
    if join_type not in JOIN_TYPES:
        raise NotImplementedError(
            f"distributed join type {join_type!r} (use single-device plan)")
    out = distributed_join_batches(
        mesh, shard_table(mesh, left), shard_table(mesh, right), left_keys,
        right_keys, join_type, left_pre_fns)
    return _whole_table(mesh, out)


def distributed_sort_table(mesh: Mesh, table, sort_keys,
                           null_placement: str = "at_end",
                           axis: str = "d"):
    """Distributed sort of a host Table (reference
    ``distributed_sort_table``): ``distributed_sort_batch`` over the ranks'
    ranges, the globally sorted Table on every rank; ties keep the input
    order. ``axis`` is ignored."""
    return _whole_table(mesh, distributed_sort_batch(
        mesh, shard_table(mesh, table), sort_keys, null_placement))


def broadcast_join_tables(mesh: Mesh, left, right,
                          left_keys: Sequence[str],
                          right_keys: Sequence[str],
                          join_type: str = "inner", axis: str = "d"):
    """Join for a small build side (reference ``broadcast_join_tables``):
    ``right`` uploaded whole on every rank, ``left`` by rank range, no
    exchange of rows; inner and left outer joins (NotImplementedError for
    the rest). The whole joined Table on every rank, in the single-rank
    order. ``axis`` is ignored."""
    from ..acero.options import TableSourceNodeOptions
    if join_type not in ("inner", "left outer"):
        raise NotImplementedError(join_type)
    build = TableSourceNodeOptions(right).upload(mesh.device)
    return _whole_table(mesh, broadcast_join_batches(
        mesh, shard_table(mesh, left), build, left_keys, right_keys,
        join_type))


def salted_join_tables(mesh: Mesh, left, right, left_keys: Sequence[str],
                       right_keys: Sequence[str], join_type: str = "inner",
                       hot_threshold: Optional[int] = None,
                       n_salts: Optional[int] = None,
                       out_cap_per_device: Optional[int] = None,
                       axis: str = "d"):
    """Skew-resistant join of two host Tables (reference
    ``salted_join_tables``): ``salted_join_batches`` over the ranks'
    ranges, with its defaults (``hot_threshold`` 4x a rank's share of the
    probe rows, at least 64; ``n_salts`` the rank count). The whole joined
    Table on every rank, without the salt columns (the reference's keeps
    the suffixed ``__salt___l``/``__salt___r`` of a join that outputs both
    sides). ``out_cap_per_device`` and ``axis`` are ignored."""
    return _whole_table(mesh, salted_join_batches(
        mesh, shard_table(mesh, left), shard_table(mesh, right), left_keys,
        right_keys, join_type, hot_threshold, n_salts))
