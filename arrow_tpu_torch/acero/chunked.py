"""Chunked (streaming) execution (counterpart of
``arrow_tpu/acero/chunked.py``): the morsel analogue.

Reference analogues: Acero bounds working sets by slicing sources into
morsels and streaming them through the plan (acero/exec_plan.h:57,
source_node.cc:122 SliceAndDeliverMorsel), accumulating build sides
(acero/accumulation_queue.h:74) and merging per-thread aggregate states
(groupby_aggregate_node.cc:255 consume/merge/finalize); sorts run per
chunk, then a merge (compute/kernels/vector_sort.cc:47).

A plan over one large source runs as a sequence of fixed-capacity
DeviceBatch chunks with carry state on the card, so the card's working set
is O(chunk + state) whatever the source's size:

* grouped or scalar aggregate: each chunk's partial states are merged into
  a state batch of bounded capacity (consume / merge / finalize). Group ids
  stay in order of first appearance across chunks, because the merge puts
  the state (earlier appearances) before the chunk;
* order_by: each chunk downloads its live rows with their sort-key words,
  and one host ``np.lexsort`` over the words merges them: host memory, not
  the card's, bounds the sort, and the order is the device order_by's;
* order_by + fetch (top-k): each chunk is sorted with the k rows kept so
  far and truncated to k on the card;
* hashjoin: the build side runs once, whole; the probe side streams;
* filter / project: a stateless map over each chunk.

The source is a table source's host Table or DeviceBatch. A host Table
streams through its columns' device representations (``HostColumn``),
each prepared once (``source_cache``), so every chunk shares one
dictionary a column. Held in host memory and run on the card, the source is pinned once
and each chunk is copied with ``non_blocking=True`` on a copy stream of
its own, chunk i+1's copy enqueued before chunk i's compute
(``_ChunkSource``); already on the card it is sliced in place.

Streaming is asked for by ``Declaration.to_table(chunk_rows=N)`` or
``ARROW_TPU_CHUNK_ROWS=N``; ``ARROW_TPU_STATE_ROWS`` sets the aggregate
state's capacity (the chunk capacity by default). A plan of another shape
makes ``maybe_execute_chunked`` return None, with the reason in
``LAST_FALLBACK_REASON``, and runs whole.

Float caveat: chunked sums reassociate float addition at chunk
boundaries, so a float aggregate matches the whole-table result up to the
order of summation (integers, decimals of up to 18 digits, counts, keys
and min/max are exact). Each float sum adds in an order fixed by its input
(``move.segment_sum``: the grouped-sum kernel up to 1,024 segments, else a
stable sort), so one chunked plan gives the same bits on every run.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import default_device, dtypes
from .. import types as T
from ..cancel import default_stop_token
from ..compute.aggregate import (_dec_factor, _sum_dtype, _sum_type,
                                 decimal_mean, decode_numeric_dict,
                                 rank_recode, sum_values)
from ..compute.grouper import group_capacity_bound, group_ids
from ..compute.hash_agg import segment_minmax
from ..compute.keys import sort_key_arrays, stable_sort_indices
from ..compute.move import (gather_rows, segment_count, segment_product,
                            segment_reduce, segment_sum)
from ..compute.registry import ExecContext
from ..compute.selection import gather_columns
from ..device.column import (BLOCK, DeviceBatch, DeviceColumn,
                             batch_from_arrays, download_batch,
                             download_table, pin_batch,
                             round_up, slice_rows)
from ..table import Table
from ..types import Field, Schema
from .exec import (Declaration, _execute_hashjoin, _fit, _rank_col,
                   _segment_fns, _sources_on, _unify_dictionaries,
                   execute_declaration, last_plan_metrics)
from .options import (AggregateNodeOptions, FetchNodeOptions,
                      OrderByNodeOptions, TableSourceNodeOptions)
from .query_context import current_query_context
from .source_cache import host_column

# a streamed probe cannot carry the build side's matched state across
# chunks, so right semi/anti/outer and full outer joins do not stream; the
# distributed layer partitions by key instead and takes all eight
# (``dist_exec`` passes ``_ALL_JOIN_TYPES`` to ``_linearize``)
_STREAM_JOIN_TYPES = ("inner", "left outer", "left semi", "left anti")
_ALL_JOIN_TYPES = _STREAM_JOIN_TYPES + (
    "right semi", "right anti", "right outer", "full outer")


def chunk_rows_env() -> int:
    try:
        return int(os.environ.get("ARROW_TPU_CHUNK_ROWS", "0"))
    except ValueError:
        return 0


def state_rows_env(default: int) -> int:
    try:
        return int(os.environ.get("ARROW_TPU_STATE_ROWS", "0")) or default
    except ValueError:
        return default


# --- plan linearization ------------------------------------------------------

class _Linear:
    """A table source + middle ops (filter/project/probe-side joins) + an
    optional terminal (aggregate / order_by [+fetch] / fetch). An aggregate
    terminal may carry post_ops: the nodes above it, run whole over its
    small result (Q1's and Q3's order_by [-> fetch] tails)."""

    def __init__(self, source, middle, terminal, post_fetch, post_ops=()):
        self.source = source          # TableSourceNodeOptions
        self.middle = middle          # list[Declaration]
        self.terminal = terminal      # Declaration | None
        self.post_fetch = post_fetch  # FetchNodeOptions | None
        self.post_ops = list(post_ops)  # Declarations after an aggregate


#: why the last maybe_execute_chunked call fell back (None: it streamed or
#: the source fits one chunk). ``Declaration.to_table`` warns with it, or
#: raises under ARROW_TPU_REQUIRE_CHUNKED=1: the memory bound must not go
#: away in silence.
LAST_FALLBACK_REASON: Optional[str] = None

def _reject(reason: str):
    global LAST_FALLBACK_REASON
    LAST_FALLBACK_REASON = reason
    return None


def _linearize(decl, join_types=_STREAM_JOIN_TYPES) -> Optional[_Linear]:
    chain = []
    cur = decl
    while True:
        f = cur.factory_name
        if f == "table_source":
            chain.reverse()
            return _split_chain(cur.options, chain)
        if f in ("filter", "project", "order_by", "fetch", "aggregate",
                 "hashjoin"):
            if f == "aggregate" and cur.options.segment_keys:
                return _reject("segmented aggregate")
            if f == "hashjoin":
                if cur.options.join_type not in join_types:
                    return _reject("hashjoin type "
                                   f"{cur.options.join_type!r}")
                if cur.options.filter_expression is not None:
                    return _reject("hashjoin residual filter")
            chain.append(cur)
            cur = cur.inputs[0]
            continue
        return _reject(f"unsupported node {f!r}")


def _split_chain(source, chain) -> Optional[_Linear]:
    # the terminal is the first aggregate/order_by/fetch; only
    # fetch-after-order_by, or anything after an aggregate, may follow
    middle: List = []
    terminal = None
    post_fetch = None
    post_ops: List = []
    for i, d in enumerate(chain):
        f = d.factory_name
        if terminal is not None and terminal.factory_name == "aggregate":
            # the tail after the aggregate runs whole over its small
            # result, each hashjoin keeping its own build subtree
            post_ops.append(d)
            continue
        if f in ("filter", "project", "hashjoin"):
            if terminal is not None:
                return _reject(f"node {f!r} after terminal")
            middle.append(d)
        elif f == "aggregate":
            if terminal is not None:
                return _reject("aggregate after terminal")
            terminal = d
        elif f == "order_by":
            if terminal is not None:
                return _reject("order_by after terminal")
            terminal = d
        elif f == "fetch":
            if terminal is None and i == len(chain) - 1:
                terminal = d
            elif (terminal is not None
                  and terminal.factory_name == "order_by"
                  and i == len(chain) - 1):
                post_fetch = d.options
            else:
                return _reject("fetch in unsupported position")
    return _Linear(source, middle, terminal, post_fetch, post_ops)


# --- chunk source ------------------------------------------------------------

def _poll():
    default_stop_token().poll()
    qc = current_query_context()
    if qc is not None:
        qc.stop_token.poll()


class _ChunkSource:
    """A table source's batch cut into chunks of ``chunk_rows`` rows, each
    at one fixed capacity on ``device``, every chunk sharing the batch's
    dictionary tuples.

    A batch in host memory run on the card is pinned once (``pin_batch``;
    cached on the source options; a host Table's columns on the columns) and each chunk is copied on a copy
    stream of its own with ``non_blocking=True``: chunk i+1's copy is
    enqueued before chunk i is handed on, the compute stream waits on an
    event recorded after chunk i's copy, and each chunk tensor is marked
    with ``record_stream`` so that the caching allocator gives its memory
    to no later copy before the compute that reads it is done. Otherwise
    a chunk is a slice of the batch (``slice_rows``). Counts the bytes
    copied to the card (``h2d_bytes``) and the copies' card time
    (``copy_ms``)."""

    def __init__(self, options: TableSourceNodeOptions, chunk_rows: int,
                 device: torch.device):
        cuda = device.type == "cuda"
        batch = _host_batch(options, cuda) if options.is_host \
            else options.batch
        self.n = int(batch.row_count)
        self.chunk_rows = chunk_rows
        self.capacity = round_up(min(chunk_rows, max(self.n, 1)))
        self.n_chunks = max(1, -(-self.n // chunk_rows))
        self.lengths = [max(0, min(chunk_rows, self.n - i * chunk_rows))
                        for i in range(self.n_chunks)]
        self.stream = None
        self.h2d_bytes = 0
        self._events: List[Tuple[torch.cuda.Event, torch.cuda.Event]] = []
        if cuda and batch.row_count.device.type == "cpu":
            if not options.is_host:
                if getattr(options, "_pinned", None) is None:
                    options._pinned = pin_batch(batch)
                batch = options._pinned
            self.stream = torch.cuda.Stream(device)
        self.batch = batch
        # every chunk's row count, moved once
        self.counts = torch.tensor(self.lengths, dtype=torch.int32).to(device)

    def _slice(self, i: int) -> DeviceBatch:
        return slice_rows(self.batch, i * self.chunk_rows, self.lengths[i],
                          self.capacity, self.counts[i])

    def _upload(self, i: int):
        """Chunk i's copies enqueued on the copy stream; (chunk, the event
        after them)."""
        with torch.cuda.stream(self.stream):
            start = torch.cuda.Event(enable_timing=True)
            done = torch.cuda.Event(enable_timing=True)
            start.record()
            chunk = self._slice(i)
            done.record()
        self._events.append((start, done))
        self.h2d_bytes += self.lengths[i] * sum(
            c.values.element_size() + (c.validity is not None)
            for c in self.batch.columns)
        return chunk, done

    @staticmethod
    def _ready(chunk: DeviceBatch, done: torch.cuda.Event):
        compute = torch.cuda.current_stream()
        compute.wait_event(done)
        for c in chunk.columns:
            c.values.record_stream(compute)
            if c.validity is not None:
                c.validity.record_stream(compute)

    def __iter__(self):
        if self.stream is None:
            for i in range(self.n_chunks):
                _poll()
                yield self._slice(i)
            return
        nxt = self._upload(0)
        for i in range(self.n_chunks):
            _poll()
            chunk, done = nxt
            if i + 1 < self.n_chunks:
                # the next copy is queued before this chunk's compute
                nxt = self._upload(i + 1)
            self._ready(chunk, done)
            yield chunk

    @property
    def uploads(self) -> int:
        """The chunk copies enqueued so far."""
        return len(self._events)

    def copy_ms(self) -> float:
        """The card time of the copies enqueued so far (synchronizes)."""
        for _, done in self._events:
            done.synchronize()
        return sum(s.elapsed_time(d) for s, d in self._events)


def _host_batch(options: TableSourceNodeOptions,
                pinned: bool) -> DeviceBatch:
    """A host source's prepared columns as an unpadded CPU DeviceBatch,
    one dictionary a column for every chunk: over their numpy memory, or,
    for the card, pinned once (``source_cache.host_column``)."""
    return DeviceBatch(options.table.schema,
                       [host_column(c, pinned)
                        for c in options.table.columns],
                       torch.tensor(options.num_rows, dtype=torch.int32))


# --- middle pipeline ---------------------------------------------------------

def _middle_runner(middle, device) -> Callable[[DeviceBatch], DeviceBatch]:
    """The middle ops as one per-chunk callable: runs of filter/project as
    the executor's node functions, each join through the executor's join
    with its build side run once, here, on ``device``."""
    stages = []  # ("fns", [fn, ...]) | ("join", options, build batch)
    run: List = []

    def flush():
        if run:
            stages.append(("fns", _segment_fns(run)))
            run.clear()

    for d in middle:
        if d.factory_name == "hashjoin":
            flush()
            build = execute_declaration(_sources_on(d.inputs[1], device),
                                        _root=False)
            stages.append(("join", d.options, build))
        else:
            run.append(d)
    flush()

    def runner(batch: DeviceBatch) -> DeviceBatch:
        for st in stages:
            if st[0] == "fns":
                for f in st[1]:
                    batch = f(batch)
            else:
                batch = _execute_hashjoin(st[1], batch, st[2])
        return batch

    return runner


# --- grouped aggregate: consume / merge / finalize ---------------------------

_SUPPORTED_AGGS = {"sum", "product", "mean", "min", "max", "min_max",
                   "count", "count_all", "any", "all", "first", "last",
                   "one", "variance", "stddev"}


class _AggState:
    """Partial-state field layout for one aggregate; ``vname`` is the
    value dtype of its prepared value column, set by the first chunk."""

    def __init__(self, j, fname, target, opts, out_name):
        self.j = j
        self.fname = fname
        self.target = target
        self.opts = dict(opts or {})
        self.out_name = out_name
        self.prefix = f"__p{j}_"
        self.vname: Optional[str] = None


def _norm_aggs(options: AggregateNodeOptions) -> Optional[List[_AggState]]:
    out = []
    for j, (target, fname, opts, out_name) in enumerate(options.aggregates):
        f = fname[5:] if fname.startswith("hash_") else fname
        if f not in _SUPPORTED_AGGS:
            return None
        if isinstance(target, (list, tuple)):
            target = target[0] if target else None
        out.append(_AggState(j, f, target, opts, out_name))
    return out


def _partial_fields(a: _AggState, vname: str) -> List[Tuple[str, str]]:
    """(suffix, value dtype) of the partial arrays of one aggregate over
    values of dtype ``vname``; each is stored as ``dtypes.STORAGE`` of its
    dtype (a sum's accumulator is ``_sum_dtype``'s)."""
    f = a.fname
    if f in ("sum", "product", "mean"):
        return [("s", _sum_dtype(vname)), ("c", "int64"), ("hn", "bool")]
    if f == "min":
        return [("mn", vname), ("c", "int64"), ("hn", "bool")]
    if f == "max":
        return [("mx", vname), ("c", "int64"), ("hn", "bool")]
    if f == "min_max":
        return [("mn", vname), ("mx", vname), ("c", "int64"),
                ("hn", "bool")]
    if f in ("count", "count_all"):
        return [("c", "int64")]
    if f == "any":
        return [("t", "bool"), ("c", "int64")]
    if f == "all":
        return [("fl", "bool"), ("c", "int64")]
    if f in ("first", "last", "one"):
        return [("v", vname), ("h", "bool"), ("vv", "bool")]
    if f in ("variance", "stddev"):
        return [("c", "int64"), ("s", "float64"), ("ss", "float64"),
                ("hn", "bool")]
    raise AssertionError(f)


def _prep_value_col(a: _AggState, batch: DeviceBatch) -> DeviceColumn:
    """The aggregate's target column normalized as the grouped functions
    normalize it (a numeric dictionary decoded, a string one recoded by
    rank)."""
    if a.fname == "count_all":
        return batch.columns[0]
    col = batch.column(a.target)
    if a.fname in ("min", "max", "min_max"):
        return rank_recode(col)
    if a.fname in ("sum", "product", "mean", "variance", "stddev"):
        return decode_numeric_dict(col)
    return col


def _sum(v: torch.Tensor, live, seg, nseg) -> torch.Tensor:
    """Integer sums through ``segment_reduce`` (exact in any order), float
    sums through ``segment_sum`` (an order fixed by the input)."""
    v = torch.where(live, v, torch.zeros((), dtype=v.dtype, device=v.device))
    if v.dtype.is_floating_point:
        return segment_sum(v, seg, nseg, live)
    return segment_reduce(v, seg, nseg, "sum", 0)


def _seg(mask, gids) -> torch.Tensor:
    return torch.where(mask, gids, 0).to(torch.int32)


def _consume_partials(a: _AggState, ctx, col: DeviceColumn, gids,
                      nseg: int) -> Dict[str, torch.Tensor]:
    """One chunk's partial state arrays at bound ``nseg``."""
    cap = ctx.capacity
    row_live = ctx.row_mask() & (gids < cap)
    valid = col.valid_mask()
    live = row_live & valid
    seg = _seg(live, gids)
    f = a.fname
    p: Dict[str, torch.Tensor] = {}

    def has_null():
        if col.validity is None:
            return torch.zeros(nseg, dtype=torch.bool, device=gids.device)
        isnull = row_live & ~col.validity
        return segment_count(isnull, _seg(isnull, gids), nseg) > 0

    if f in ("sum", "product", "mean"):
        acc = sum_values(col)
        if f == "product":
            p["s"] = segment_product(acc, seg, nseg, live)
        else:
            p["s"] = _sum(acc, live, seg, nseg)
        p["c"] = segment_count(live, seg, nseg)
        p["hn"] = has_null()
    elif f in ("min", "max", "min_max"):
        if f in ("min", "min_max"):
            p["mn"] = segment_minmax(col.values, a.vname, live, seg, nseg,
                                     "min")
        if f in ("max", "min_max"):
            p["mx"] = segment_minmax(col.values, a.vname, live, seg, nseg,
                                     "max")
        p["c"] = segment_count(live, seg, nseg)
        p["hn"] = has_null()
    elif f == "count":
        mode = a.opts.get("mode", "only_valid")
        if mode == "only_valid":
            m = live
        elif mode == "only_null":
            m = row_live & ~valid
        else:
            m = row_live
        p["c"] = segment_count(m, _seg(m, gids), nseg)
    elif f == "count_all":
        p["c"] = segment_count(row_live, _seg(row_live, gids), nseg)
    elif f in ("any", "all"):
        want = f == "any"
        hit = live & (col.values.to(torch.bool) == want)
        p["t" if want else "fl"] = segment_count(hit, _seg(hit, gids),
                                                 nseg) > 0
        p["c"] = segment_count(live, seg, nseg)
    elif f in ("first", "last", "one"):
        skip_nulls = a.opts.get("skip_nulls", True) or f == "one"
        m = live if skip_nulls else row_live
        p["v"], p["vv"], p["h"] = _positional_pick(
            ctx, col, gids, nseg, m, f in ("first", "one"))
    elif f in ("variance", "stddev"):
        fv = dtypes.as_float64(col.values, a.vname)
        fac = _dec_factor(col.type)
        if fac is not None:
            fv = fv * fac
        v = torch.where(live, fv, 0.0)
        p["c"] = segment_count(live, seg, nseg)
        p["s"] = segment_sum(v, seg, nseg, live)
        p["ss"] = segment_sum(v * v, seg, nseg, live)
        p["hn"] = has_null()
    return {a.prefix + k: v for k, v in p.items()}


def _positional_pick(ctx, col, gids, nseg, m, is_first):
    """(value, value validity, has) per group for its first (last) row
    where ``m`` holds: an int32 position reduce, then one gather."""
    cap = ctx.capacity
    seg = _seg(m, gids)
    idx = torch.arange(cap, dtype=torch.int32, device=gids.device)
    if is_first:
        pos = segment_reduce(torch.where(m, idx, cap), seg, nseg, "min", cap)
        has = pos < cap
    else:
        pos = segment_reduce(torch.where(m, idx, -1), seg, nseg, "max", -1)
        has = pos >= 0
    safe = torch.where(has, pos, 0)
    if col.validity is not None:
        v, vv = gather_rows([col.values, col.validity], safe)
    else:
        (v,) = gather_rows([col.values], safe)
        vv = torch.ones(nseg, dtype=torch.bool, device=gids.device)
    return v, vv & has, has


def _merge_partials(a: _AggState, state_p, chunk_p, state_live, chunk_live,
                    gids2, nseg: int):
    """Merge concatenated (state ++ chunk) partial rows by combined group
    id. State rows come first, so the positional merges (first/last) see
    the rows in order. Groups past ``nseg`` (an overflow, which the state
    flags) are dropped."""
    f = a.fname
    live = torch.cat([state_live, chunk_live]) & (gids2 < nseg)
    seg = _seg(live, gids2)
    out: Dict[str, torch.Tensor] = {}

    def cat(suffix):
        return torch.cat([state_p[a.prefix + suffix],
                          chunk_p[a.prefix + suffix]])

    def mbool_or(suffix):
        v = cat(suffix) & live
        return segment_count(v, _seg(v, gids2), nseg) > 0

    if f in ("sum", "mean", "variance", "stddev", "count", "count_all",
             "min", "max", "min_max", "any", "all"):
        out["c"] = _sum(cat("c"), live, seg, nseg)
    if f in ("sum", "mean"):
        out["s"] = _sum(cat("s"), live, seg, nseg)
    elif f == "product":
        out["s"] = segment_product(cat("s"), seg, nseg, live)
        out["c"] = _sum(cat("c"), live, seg, nseg)
    elif f in ("variance", "stddev"):
        out["s"] = _sum(cat("s"), live, seg, nseg)
        out["ss"] = _sum(cat("ss"), live, seg, nseg)
    elif f in ("min", "max", "min_max"):
        if f in ("min", "min_max"):
            out["mn"] = segment_minmax(cat("mn"), a.vname, live, seg, nseg,
                                       "min")
        if f in ("max", "min_max"):
            out["mx"] = segment_minmax(cat("mx"), a.vname, live, seg, nseg,
                                       "max")
    elif f in ("any", "all"):
        k = "t" if f == "any" else "fl"
        out[k] = mbool_or(k)
    elif f in ("first", "last", "one"):
        h = cat("h") & live
        n2 = gids2.shape[0]
        idx = torch.arange(n2, dtype=torch.int32, device=gids2.device)
        seg_h = _seg(h, gids2)
        if f in ("first", "one"):
            pos = segment_reduce(torch.where(h, idx, n2), seg_h, nseg,
                                 "min", n2)
            has = pos < n2
        else:
            pos = segment_reduce(torch.where(h, idx, -1), seg_h, nseg,
                                 "max", -1)
            has = pos >= 0
        v, vv = gather_rows([cat("v"), cat("vv")], torch.where(has, pos, 0))
        out["v"] = v
        out["vv"] = vv & has
        out["h"] = has
    if f in ("sum", "mean", "product", "min", "max", "min_max", "variance",
             "stddev"):
        out["hn"] = mbool_or("hn")
    return {a.prefix + k: v for k, v in out.items()}


def _finalize_agg(a: _AggState, p: Dict[str, torch.Tensor], vtype,
                  vdict) -> List[Tuple[str, DeviceColumn]]:
    """The output column(s) of one aggregate from its merged partial
    state."""
    f = a.fname
    skip_nulls = a.opts.get("skip_nulls", True)
    min_count = a.opts.get("min_count",
                           1 if f in ("sum", "product", "mean") else 0)

    def g(suffix):
        return p[a.prefix + suffix]

    def counted(validity):
        return validity if skip_nulls else validity & ~g("hn")

    if f in ("count", "count_all"):
        return [(a.out_name, DeviceColumn(g("c"), None, T.int64()))]
    if f in ("sum", "product"):
        return [(a.out_name, DeviceColumn(
            g("s"), counted(g("c") >= min_count), _sum_type(vtype)))]
    if f == "mean":
        validity = counted(g("c") >= min_count)
        if vtype.is_decimal:
            return [(a.out_name, DeviceColumn(decimal_mean(g("s"), g("c")),
                                              validity, vtype))]
        sums = dtypes.as_float64(g("s"), _sum_dtype(a.vname))
        means = sums / g("c").clamp(min=1).to(torch.float64)
        return [(a.out_name, DeviceColumn(means, validity, T.float64()))]
    if f in ("min", "max", "min_max"):
        validity = counted(g("c") > 0)
        outs = []
        if f in ("min", "min_max"):
            nm = a.out_name if f == "min" else f"{a.out_name}_min"
            outs.append((nm, DeviceColumn(g("mn"), validity, vtype, vdict)))
        if f in ("max", "min_max"):
            nm = a.out_name if f == "max" else f"{a.out_name}_max"
            outs.append((nm, DeviceColumn(g("mx"), validity, vtype, vdict)))
        return outs
    if f in ("any", "all"):
        validity = g("c") >= min_count if min_count > 0 else None
        value = g("t") if f == "any" else ~g("fl")
        return [(a.out_name, DeviceColumn(value, validity, T.bool_()))]
    if f in ("first", "last", "one"):
        return [(a.out_name, DeviceColumn(g("v"), g("h") & g("vv"), vtype,
                                          vdict))]
    if f in ("variance", "stddev"):
        ddof = a.opts.get("ddof", 0)
        c = g("c").to(torch.float64)
        mean = g("s") / c.clamp(min=1.0)
        m2 = g("ss") - c * mean * mean
        var = m2.clamp(min=0.0) / (c - ddof).clamp(min=1.0)
        validity = counted((g("c") > ddof) & (g("c") >= min_count))
        out = torch.sqrt(var) if f == "stddev" else var
        return [(a.out_name, DeviceColumn(out, validity, T.float64()))]
    raise AssertionError(f)


def _fit_arr(arr: torch.Tensor, cap: int) -> torch.Tensor:
    """Pad with zeros or truncate to ``cap`` rows."""
    n = arr.shape[0]
    if n >= cap:
        return arr[:cap]
    return torch.cat([arr, arr.new_zeros((cap - n,) + tuple(arr.shape[1:]))])


def _ftype(t: torch.Tensor):
    """Field type of a raw partial array (internal bookkeeping only)."""
    return dtypes.type_of_dtype(dtypes.dtype_of_values(t))


def _concat(a: DeviceColumn, b: DeviceColumn) -> DeviceColumn:
    """``a``'s rows, then ``b``'s; a validity where either has one; two
    dictionaries that differ in value recoded into their union."""
    if a.dictionary is not b.dictionary and a.dictionary != b.dictionary:
        a, b = _unify_dictionaries([a, b])
    validity = None
    if a.validity is not None or b.validity is not None:
        validity = torch.cat([a.valid_mask(), b.valid_mask()])
    return DeviceColumn(torch.cat([a.values, b.values]), validity, b.type,
                        b.dictionary)


def _overflow_column(flag: torch.Tensor, cap: int) -> DeviceColumn:
    col = torch.zeros(cap, dtype=torch.bool, device=flag.device)
    col[0] = flag
    return DeviceColumn(col, None, T.bool_())


class _ChunkedGroupBy:
    """Carry state on the card for a grouped (or keyless) aggregation: a
    DeviceBatch at ``state_cap`` rows of the group keys, every partial
    array (``__p{j}_{suffix}``) and an ``__overflow__`` flag in row 0."""

    def __init__(self, options: AggregateNodeOptions, aggs: List[_AggState],
                 state_cap: int):
        self.keys = list(options.keys or [])
        self.scalar = not self.keys
        self.key_names = self.keys or ["__dummy__"]
        self.aggs = aggs
        self.state_cap = state_cap
        self.state: Optional[DeviceBatch] = None
        self._vmeta: Dict[int, Tuple] = {}

    def _key_cols(self, batch: DeviceBatch) -> List[DeviceColumn]:
        if self.scalar:
            return [DeviceColumn(torch.zeros(
                batch.capacity, dtype=torch.bool,
                device=batch.row_count.device), None, T.bool_())]
        return [batch.column(k) for k in self.keys]

    def _consume_chunk(self, chunk: DeviceBatch):
        """(group-representative keys, live mask, partials, bound B,
        overflow flag) of one chunk, at bound B."""
        ctx = ExecContext(chunk.capacity, chunk.row_count)
        key_cols = self._key_cols(chunk)
        g = group_ids(ctx, key_cols)
        B = min(group_capacity_bound(key_cols, chunk.capacity),
                chunk.capacity)
        chunk_p: Dict[str, torch.Tensor] = {}
        for a in self.aggs:
            chunk_p.update(_consume_partials(
                a, ctx, _prep_value_col(a, chunk), g.group_ids, B))
        ids = torch.arange(B, dtype=torch.int64, device=g.group_ids.device)
        chunk_live = ids < g.num_groups
        chunk_keys = gather_columns(
            key_cols, torch.where(chunk_live, g.rep_indices[:B], 0))
        return (chunk_keys, chunk_live, chunk_p, B,
                g.num_groups > self.state_cap)

    def _state_batch(self, keys, partials, overflow, row_count):
        S = self.state_cap
        cols = list(keys) + [DeviceColumn(arr, None, _ftype(arr))
                             for arr in partials.values()] \
            + [_overflow_column(overflow, S)]
        names = self.key_names + list(partials) + ["__overflow__"]
        return DeviceBatch(Schema([Field(n, c.type)
                                   for n, c in zip(names, cols)]), cols,
                           row_count.to(torch.int32))

    def _make_state(self, chunk_keys, chunk_live, chunk_p, overflow):
        """A fresh state batch of one chunk's partial side."""
        S = self.state_cap
        n_live = chunk_live.sum().clamp(max=S)
        return self._state_batch(
            [_fit(kc, S) for kc in chunk_keys],
            {n: _fit_arr(arr, S) for n, arr in chunk_p.items()}, overflow,
            n_live)

    def _merge_into(self, state, chunk_keys, chunk_live, chunk_p, B,
                    b_overflow):
        """Merge a partial side (keys/live/partials at bound B) into the
        state; the state's rows come first, keeping appearance order."""
        S = self.state_cap
        dev = chunk_live.device
        state_live = torch.arange(S, dtype=torch.int64,
                                  device=dev) < state.row_count
        comb_keys = [_concat(state.column(k), cc)
                     for k, cc in zip(self.key_names, chunk_keys)]
        comb_live = torch.cat([state_live, chunk_live])
        ctx2 = ExecContext(S + B, torch.full((), S + B, dtype=torch.int32,
                                             device=dev))
        ctx2.row_mask_ = comb_live
        g2 = group_ids(ctx2, comb_keys)
        state_p = {n: state.column(n).values for n in chunk_p}
        merged: Dict[str, torch.Tensor] = {}
        for a in self.aggs:
            merged.update(_merge_partials(a, state_p, chunk_p, state_live,
                                          chunk_live, g2.group_ids, S))
        ids = torch.arange(S, dtype=torch.int64, device=dev)
        new_keys = gather_columns(
            comb_keys, torch.where(ids < g2.num_groups, g2.rep_indices[:S],
                                   0))
        overflow = (state.column("__overflow__").values[0] | b_overflow
                    | (g2.num_groups > S))
        return self._state_batch(new_keys, merged, overflow,
                                 g2.num_groups.clamp(max=S))

    def consume(self, chunk: DeviceBatch):
        if not self._vmeta:
            # each value column's type and (recoded) dictionary, once
            for a in self.aggs:
                vc = _prep_value_col(a, chunk)
                self._vmeta[a.j] = (vc.type, vc.dictionary)
                a.vname = vc.value_dtype
        keys, live, partials, B, over = self._consume_chunk(chunk)
        if self.state is None:
            self.state = self._make_state(keys, live, partials, over)
        else:
            # a chunk's own overflow shows in the merged group count
            self.state = self._merge_into(self.state, keys, live, partials,
                                          B, torch.zeros_like(over))

    def merge_states(self, sA: DeviceBatch, sB: DeviceBatch) -> DeviceBatch:
        """Merge two state batches (per-device partials of a distributed
        aggregate; reference groupby_aggregate_node.cc:255, merge into
        state 0). sA's groups come before sB's, which keeps appearance
        order when states are merged in partition order."""
        S = self.state_cap
        b_keys = [sB.column(k) for k in self.key_names]
        b_live = torch.arange(S, dtype=torch.int64,
                              device=sB.row_count.device) < sB.row_count
        b_p = {f.name: sB.column(f.name).values
               for f in sB.schema.fields if f.name.startswith("__p")}
        b_over = sB.column("__overflow__").values[0]
        return self._merge_into(sA, b_keys, b_live, b_p, S, b_over)

    def finalize(self) -> DeviceBatch:
        """The aggregate's result at the block capacity of its groups."""
        state = self.state
        if state is None:
            raise ValueError("chunked aggregate consumed no chunks")
        if bool(state.column("__overflow__").values[0]):
            raise ValueError(
                "chunked aggregate exceeded the group-state capacity "
                f"({self.state_cap}); raise ARROW_TPU_STATE_ROWS or the "
                "chunk size")
        p = {f.name: state.column(f.name).values
             for f in state.schema.fields if f.name.startswith("__p")}
        out_cols, out_fields = [], []
        if not self.scalar:
            for k in self.keys:
                out_cols.append(state.column(k))
                out_fields.append(Field(k, out_cols[-1].type))
        for a in self.aggs:
            vtype, vdict = self._vmeta[a.j]
            for name, col in _finalize_agg(a, p, vtype, vdict):
                out_cols.append(col)
                out_fields.append(Field(name, col.type))
        # a scalar aggregate of zero rows still gives its one row
        n = 1 if self.scalar else int(state.row_count)
        return DeviceBatch(Schema(out_fields),
                           [_fit(c, round_up(n)) for c in out_cols],
                           torch.full((), n, dtype=torch.int32,
                                      device=state.row_count.device))


# --- order_by: external sort -------------------------------------------------

def _sort_keys(batch: DeviceBatch, options: OrderByNodeOptions, live):
    cols = []
    for name, _ in options.sort_keys:
        c = batch.column(name)
        cols.append(_rank_col(c) if c.dictionary is not None else c)
    return sort_key_arrays(cols, [o for _, o in options.sort_keys],
                           options.null_placement, live)


def _fetch_slice(out: Table, offset: int, count: int) -> Table:
    return out.slice(offset, None if count < 0 else count)


class _ChunkedOrderBy:
    """Each chunk's live rows downloaded with their sort-key words; the
    merge is one host ``np.lexsort`` over the words: the key encoding the
    device sort uses, so the order is the device order_by's, bit for
    bit."""

    def __init__(self, options: OrderByNodeOptions):
        self.options = options
        self._rows: List[Dict] = []
        self._schema = None
        self._dicts = None

    def consume(self, chunk: DeviceBatch):
        if self._schema is None:
            self._schema = chunk.schema
            self._dicts = [c.dictionary for c in chunk.columns]
        keys = _sort_keys(chunk, self.options, chunk.row_mask())
        n = int(chunk.row_count)
        self._rows.append({
            "n": n,
            "keys": [k[:n].cpu().numpy() for k in keys],
            "cols": [(c.values[:n].cpu().numpy(),
                      None if c.validity is None
                      else c.validity[:n].cpu().numpy())
                     for c in chunk.columns]})

    def finalize(self, post_fetch: Optional[FetchNodeOptions]) -> Table:
        if not self._rows:
            raise ValueError("an external sort over no chunks")
        nk = len(self._rows[0]["keys"])
        keys = [np.concatenate([r["keys"][i] for r in self._rows])
                for i in range(nk)]
        # np.lexsort's LAST key is primary; the key list is [class0,
        # word0, class1, word1, ...] with key 0 primary
        order = np.lexsort(tuple(reversed(keys)))
        if post_fetch is not None:
            off, cnt = post_fetch.offset, post_fetch.count
            order = order[off:] if cnt < 0 else order[off:off + cnt]
        cols = []
        for ci in range(len(self._schema.fields)):
            vals = np.concatenate([r["cols"][ci][0] for r in self._rows])
            masks = [r["cols"][ci][1] for r in self._rows]
            mask = None
            if any(m is not None for m in masks):
                mask = np.concatenate(
                    [m if m is not None else np.ones(r["n"], np.bool_)
                     for m, r in zip(masks, self._rows)])[order]
            cols.append((vals[order], mask, self._dicts[ci]))
        return download_table(batch_from_arrays(self._schema, cols,
                                                int(order.shape[0])))


class _ChunkedTopK:
    """order_by + fetch(offset, count) with a small k: each chunk sorted
    together with the k rows kept so far, truncated to k, on the card
    (select_k over chunks)."""

    def __init__(self, options: OrderByNodeOptions, k: int):
        self.options = options
        self.k = k
        self.cap = round_up(k)
        self.state: Optional[DeviceBatch] = None

    def consume(self, chunk: DeviceBatch):
        if self.state is None:
            merged, live = chunk, chunk.row_mask()
        else:
            # the kept rows ahead of the chunk's: live rows are not a
            # prefix, so an explicit live mask puts the dead ones last
            state = self.state
            cols = [_concat(sc, cc)
                    for sc, cc in zip(state.columns, chunk.columns)]
            live = torch.cat([state.row_mask(), chunk.row_mask()])
            merged = DeviceBatch(chunk.schema, cols,
                                 state.row_count + chunk.row_count)
        perm = stable_sort_indices(_sort_keys(merged, self.options, live))
        keep = perm[:self.cap]
        cols = [_fit(c, self.cap) for c in gather_columns(merged.columns,
                                                          keep)]
        self.state = DeviceBatch(merged.schema, cols,
                                 live.sum().clamp(max=self.k).to(torch.int32))

    def finalize(self, post_fetch: FetchNodeOptions) -> Table:
        if self.state is None:
            raise ValueError("a top-k over no chunks")
        return _fetch_slice(download_table(self.state), post_fetch.offset,
                            post_fetch.count)


# --- entry points ------------------------------------------------------------

def _concat_tables(parts: List[Table]) -> Table:
    """The chunks' tables as one Table of one chunk."""
    return Table.from_batches([b for p in parts for b in p.to_batches()],
                              parts[0].schema).combine_chunks()


def stream_batches(decl, chunk_rows: int, device=None):
    """Incremental execution of a terminal-free linear plan: a generator
    of one ``RecordBatch`` a chunk, each as soon as its chunk is done
    (reference: DeclarationToReader, exec_plan.cc:780 family: results
    flow while the plan still runs). None where the plan needs a terminal
    (aggregate, sort) or is not linear: the caller then runs it whole."""
    lin = _linearize(decl)
    if lin is None or lin.terminal is not None or lin.post_ops:
        return None
    if lin.source.num_rows == 0:
        return None
    dev = default_device(device)
    source = _ChunkSource(lin.source, chunk_rows, dev)
    last_plan_metrics.source = source
    runner = _middle_runner(lin.middle, dev)

    def gen():
        for chunk in source:
            yield download_batch(runner(chunk))
    return gen()


def _aggregate(lin: _Linear, aggs, source: _ChunkSource, runner,
               dev: torch.device) -> DeviceBatch:
    """The aggregate terminal over the chunks, then its post ops whole."""
    gb = _ChunkedGroupBy(lin.terminal.options, aggs,
                         state_rows_env(source.capacity))
    for chunk in source:
        gb.consume(runner(chunk))
    out = gb.finalize()
    if not lin.post_ops:
        return out
    cur = Declaration("table_source", TableSourceNodeOptions(out))
    for d in lin.post_ops:
        # a post-op hashjoin keeps its own build subtree; only its probe
        # side is the aggregated result
        cur = Declaration(d.factory_name, d.options,
                          inputs=[cur] + list(d.inputs[1:]))
    return execute_declaration(_sources_on(cur, dev), _root=False)


def execute_chunked_aggregate(decl, chunk_rows: int,
                              device=None) -> Optional[DeviceBatch]:
    """A plan whose terminal is a chunkable aggregate, run in chunks of
    ``chunk_rows`` source rows as ``maybe_execute_chunked`` runs it, its
    result left on the device; None for any other shape (whose chunked
    result equals the whole run's: no float sum meets a chunk boundary)
    and where the source fits one chunk."""
    lin = _linearize(decl)
    if lin is None or lin.terminal is None \
            or lin.terminal.factory_name != "aggregate" \
            or lin.source.num_rows <= chunk_rows:
        return None
    aggs = _norm_aggs(lin.terminal.options)
    if aggs is None:
        return None
    dev = default_device(device)
    source = _ChunkSource(lin.source, chunk_rows, dev)
    last_plan_metrics.source = source
    return _aggregate(lin, aggs, source, _middle_runner(lin.middle, dev),
                      dev)


def maybe_execute_chunked(decl, chunk_rows: int,
                          device=None) -> Optional[Table]:
    """Run the Declaration chunked on ``device`` (the card by default) if
    its shape streams, giving the result Table; None to fall back to
    whole-table execution (``LAST_FALLBACK_REASON`` says why;
    ``to_table`` reports it)."""
    global LAST_FALLBACK_REASON
    LAST_FALLBACK_REASON = None
    lin = _linearize(decl)
    if lin is None:
        return None
    if lin.source.num_rows <= chunk_rows:
        # one chunk: the whole-table run is the same, and as bounded, so
        # this is not a fallback of shape
        return None
    term = lin.terminal
    aggs = None
    if term is not None and term.factory_name == "aggregate":
        aggs = _norm_aggs(term.options)
        if aggs is None:
            return _reject("aggregate function set not chunkable")
    dev = default_device(device)
    source = _ChunkSource(lin.source, chunk_rows, dev)
    last_plan_metrics.source = source
    runner = _middle_runner(lin.middle, dev)

    if term is None:
        return _concat_tables([download_table(runner(c)) for c in source])

    f = term.factory_name
    if f == "aggregate":
        return download_table(_aggregate(lin, aggs, source, runner, dev))

    if f == "order_by":
        pf = lin.post_fetch
        if pf is not None and pf.count >= 0 and \
                pf.offset + pf.count <= max(chunk_rows, BLOCK):
            topk = _ChunkedTopK(term.options, pf.offset + pf.count)
            for chunk in source:
                topk.consume(runner(chunk))
            return topk.finalize(pf)
        ob = _ChunkedOrderBy(term.options)
        for chunk in source:
            ob.consume(runner(chunk))
        return ob.finalize(pf)

    # a fetch: chunks until the count is taken
    off, cnt = term.options.offset, term.options.count
    parts = []
    taken = 0
    for chunk in source:
        out = download_table(runner(chunk))
        n = out.num_rows
        if off >= n:
            off -= n
            continue
        need = -1 if cnt < 0 else cnt - taken
        out = _fetch_slice(out, off, need)
        off = 0
        taken += out.num_rows
        parts.append(out)
        if cnt >= 0 and taken >= cnt:
            break
    if not parts:
        # the offset passed every row: the last chunk's columns, empty
        return out.slice(0, 0)
    return _concat_tables(parts)
