"""Distributed Declaration execution (counterpart of
``arrow_tpu/acero/dist_exec.py``): the same Declaration tree runs on every
rank of a ``parallel.Mesh``, each rank on its share of the rows.

* A table source is whole (each rank takes its contiguous range of
  ``ceil(n / W)`` rows) or a ``ShardBatch`` (this rank's rows already). A
  host Table source becomes a ShardBatch of that range, and each rank
  uploads only its rows (``split_host_sources``).
* The scan -> filter -> project -> aggregate spine runs on each rank's
  partition into a ``_ChunkedGroupBy`` state (the chunked engine's
  consume / merge / finalize); the states are all-gathered and merged in
  rank order, so groups keep their order of first appearance, and every
  rank finalizes the same result (``_spmd_aggregate``).
* A plan with a hash join runs its pre-join middles on each rank, then
  ``parallel.join_parts``: both sides hash-partitioned by key, local
  joins, each joined row sent back to the rank that owns its probe row
  and sorted by (probe id, build id). Each rank then holds a contiguous
  range of the single-rank join's output, and what is downstream of the
  join runs distributed from it without a gather
  (``_distributed_join_plan``). A build subtree holding an aggregation
  runs distributed, the rest whole on each rank, as in the reference.
* An order_by terminal rides the splitter-sampling range exchange with a
  hidden row-id tiebreaker (``_distributed_sort_plan``).
* Other linear shapes take the reference's partition-sequential schedule
  (``chunked_fallback``): an aggregate runs in chunks of ``ceil(n / W)``
  rows on each rank; any other shape runs whole on each rank, which gives
  the chunked schedule's result.

``EXCHANGE_COUNTS`` counts, under the reference's keys, which paths ran:
a plan that runs locally counts nothing, and the tests hold the counts to
the reference's.

Entry points: ``Declaration.to_table(distributed=True, mesh=...)`` (the
whole result on every rank, as ``download`` gives it) and
``exec.execute_distributed`` (this rank's part, on the device).

Float caveat: distributed sums reassociate float addition at partition
boundaries, as chunked execution does.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from .. import types as T
from ..device.column import DeviceBatch, DeviceColumn, capacity_class, round_up
from ..parallel.distributed import (Mesh, ShardBatch, _all_gather_ints, _drop,
                                    _with, as_part, distributed_sort_batch,
                                    fetch_part, gather_each, gather_host,
                                    join_parts, make_mesh, shard_batch,
                                    total_rows)
from .chunked import (_ALL_JOIN_TYPES, _ChunkedGroupBy, _linearize,
                      _norm_aggs, execute_chunked_aggregate, state_rows_env)
from .exec import (Declaration, _segment_fns, _sources_on, _walk,
                   execute_declaration)
from .options import TableSourceNodeOptions

# which plans exercised an exchange, which ran the partition-sequential
# schedule; a plan run locally counts nothing
EXCHANGE_COUNTS: Dict[str, int] = {
    "join_exchange": 0, "join_fused_pre": 0, "sort_exchange": 0,
    "spmd_aggregate": 0, "chunked_fallback": 0}


def reset_exchange_counts() -> None:
    for k in EXCHANGE_COUNTS:
        EXCHANGE_COUNTS[k] = 0


def _count(kind: str) -> None:
    EXCHANGE_COUNTS[kind] += 1


def run(decl: Declaration, mesh: Mesh) -> DeviceBatch:
    """``to_table(distributed=True)`` without its download: the plan pruned
    (``Declaration._plan``), run across the mesh where its shape allows,
    else whole on every rank. Returns this rank's part (a ShardBatch) or a
    whole batch that every rank holds alike."""
    plan = decl._plan()
    out = maybe_execute_distributed(plan, mesh)
    return _local(plan, mesh) if out is None else out


def maybe_execute_distributed(decl: Declaration, mesh: Optional[Mesh] = None
                              ) -> Optional[DeviceBatch]:
    """Execute the Declaration across the mesh; None for a shape that runs
    locally (reference ``maybe_execute_distributed``)."""
    if mesh is None:
        mesh = make_mesh()
    lin = _linearize(decl, join_types=_ALL_JOIN_TYPES)
    if lin is None:
        return None
    n = total_rows(lin.source.batch)
    if n == 0 or mesh.size <= 1 or n < mesh.size:
        # fewer rows than ranks (a small result re-entering): empty shards
        # buy nothing
        return None
    part_rows = -(-n // mesh.size)
    term = lin.terminal
    has_join = any(d.factory_name == "hashjoin" for d in lin.middle)
    if not has_join and term is not None \
            and term.factory_name == "aggregate":
        aggs = _norm_aggs(term.options)
        if aggs is not None:
            out = _spmd_aggregate(lin, aggs, mesh, part_rows, n)
            _count("spmd_aggregate")
            return out
    if has_join:
        out = _distributed_join_plan(lin, mesh)
        if out is not None:
            return out
    if not has_join and term is not None \
            and term.factory_name == "order_by":
        out = _distributed_sort_plan(lin, mesh)
        if out is not None:
            _count("sort_exchange")
            return out
    # the partition-sequential schedule: an aggregate in chunks of a
    # partition's rows on each rank; other shapes give the whole run's
    # result, and return None to run whole
    _count("chunked_fallback")
    return execute_chunked_aggregate(_whole_sources(decl, mesh), part_rows,
                                     mesh.device)


def split_host_sources(decl: Declaration, mesh: Mesh) -> Declaration:
    """``decl`` with every host Table source as this rank's ShardBatch:
    its ``shard_rows`` range uploaded to the mesh's device, as the
    reference stages only each device's own rows. A string column is coded
    once over the whole column (``source_cache.prepared_column``: every
    rank computes the same codes in order of first appearance and
    uploads only its range of them), so the ranks' parts share one
    dictionary; codes made a slice apart would differ from rank to rank.
    Other sources go to the device as ``to_table`` puts them."""
    from ..io.tpch_device import shard_rows
    from .exec import _SOURCES, _source_on
    memo: Dict[int, Declaration] = {}

    def walk(d: Declaration) -> Declaration:
        if id(d) in memo:
            return memo[id(d)]
        if d.factory_name in _SOURCES + ("record_batch_reader_source",):
            o = d.options
            if not isinstance(o, TableSourceNodeOptions):
                o = o.source()
            if o.is_host:
                n = o.num_rows
                rows = shard_rows(n, mesh.rank, mesh.size)
                b = o.upload(mesh.device, rows)
                out = Declaration("table_source", TableSourceNodeOptions(
                    ShardBatch(b.schema, b.columns, b.row_count, rows[0],
                               n)))
            else:
                o = _source_on(o, mesh.device, hosts_only=True)
                out = d if o is None else Declaration("table_source", o)
        else:
            ins = [walk(i) for i in d.inputs]
            out = d if all(a is b for a, b in zip(ins, d.inputs)) \
                else Declaration(d.factory_name, d.options, ins)
        memo[id(d)] = out
        return out

    return walk(decl)


# --- local runs --------------------------------------------------------------

def _whole_sources(decl: Declaration, mesh: Mesh) -> Declaration:
    """``decl`` with every ShardBatch source all-gathered whole and every
    source on the mesh's device (a shared declaration stays shared)."""
    memo: Dict[int, Declaration] = {}

    def walk(d: Declaration) -> Declaration:
        if id(d) not in memo:
            if d.factory_name == "table_source" \
                    and isinstance(d.options.batch, ShardBatch):
                memo[id(d)] = Declaration(
                    "table_source", TableSourceNodeOptions(
                        gather_host(mesh, d.options.batch)))
            else:
                ins = [walk(i) for i in d.inputs]
                memo[id(d)] = d if all(a is b for a, b in zip(ins, d.inputs)) \
                    else Declaration(d.factory_name, d.options, ins)
        return memo[id(d)]

    return _sources_on(walk(decl), mesh.device)


def _local(decl: Declaration, mesh: Mesh) -> DeviceBatch:
    """``decl`` run locally (reference: a plain ``to_table()``). A chain of
    filters and projects over a ShardBatch runs on each rank's rows (a
    filter keeps row order, so the parts stay in global order); any other
    plan runs whole on every rank, its ShardBatch sources gathered."""
    chain, cur = [], decl
    while cur.factory_name in ("filter", "project"):
        chain.append(cur)
        cur = cur.inputs[0]
    if cur.factory_name == "table_source" \
            and isinstance(cur.options.batch, ShardBatch):
        b = cur.options.batch
        for f in _segment_fns(list(reversed(chain))):
            b = f(b)
        return as_part(mesh, b)
    return execute_declaration(_whole_sources(decl, mesh), _root=False)


# --- the aggregate spine -----------------------------------------------------

def _spmd_aggregate(lin, aggs, mesh: Mesh, part_rows: int,
                    n: int) -> DeviceBatch:
    """Each rank's partition, its middles, consumed into a group state; the
    states merged in rank order on every rank; finalize, then the post ops
    distributed. The state capacity is the chunked default for a
    partition's capacity, and on overflow once more at a capacity that
    holds every row (reference ``_spmd_aggregate``'s ladder)."""
    cap = round_up(min(part_rows, max(n, 1)))
    ladder = [state_rows_env(cap)]
    full = capacity_class(n)
    if full > ladder[0]:
        ladder.append(full)
    last = None
    for S in ladder:
        try:
            return _spmd_aggregate_at(lin, aggs, mesh, S)
        except ValueError as e:
            if "group-state capacity" not in str(e):
                raise
            last = e
    raise last


def _spmd_aggregate_at(lin, aggs, mesh: Mesh, S: int) -> DeviceBatch:
    b = shard_batch(mesh, lin.source.batch)
    for f in _segment_fns(lin.middle):
        b = f(b)
    gb = _ChunkedGroupBy(lin.terminal.options, aggs, S)
    gb.consume(b)
    # the states merge at the capacity their groups need: at most the sum
    # of the ranks' groups, so no merge overflows below S
    live = sum(c[0] for c in _all_gather_ints(mesh,
                                              [int(gb.state.row_count)]))
    gb.state_cap = min(S, round_up(live))
    states = gather_each(mesh, gb.state, gb.state_cap)
    state = states[0]
    for s in states[1:]:
        state = gb.merge_states(state, s)
    gb.state = state
    out = gb.finalize()
    if not lin.post_ops:
        return out
    cur = Declaration("table_source", TableSourceNodeOptions(out))
    for d in lin.post_ops:
        # a post-op hashjoin keeps its own build subtree
        cur = Declaration(d.factory_name, d.options,
                          inputs=[cur] + list(d.inputs[1:]))
    return run(cur, mesh)


# --- joins -------------------------------------------------------------------

def _contains_aggregate(decl: Declaration) -> bool:
    return any(d.factory_name == "aggregate" for d in _walk(decl))


def _distributed_join_plan(lin, mesh: Mesh) -> Optional[DeviceBatch]:
    """A plan whose middle holds hash joins (reference
    ``_distributed_join_plan``): the first join's probe side is the
    source's partition through the pre-join middles on each rank, its build
    side the join's inputs[1] subtree, distributed where it holds an
    aggregation (so every aggregation of a plan adds its floats in one
    order: Q15 joins two aggregations of one subtree on equality), else
    whole on each rank. The join (``join_parts``) leaves each rank a
    contiguous range of the single-rank output; what is downstream runs
    distributed from there.

    The reference runs the pre-join middles inside its exchange program
    (``join_fused_pre``) unless a join key is dictionary-coded; then it
    materializes the probe side on one device (and runs nothing where
    that is empty). The port runs them on each rank in every case, and
    counts ``join_fused_pre`` where the reference fuses."""
    j = next(i for i, d in enumerate(lin.middle)
             if d.factory_name == "hashjoin")
    join_decl = lin.middle[j]
    opts = join_decl.options
    if _contains_aggregate(join_decl.inputs[1]):
        build = run(join_decl.inputs[1], mesh)
    else:
        build = _local(join_decl.inputs[1], mesh)
    if total_rows(build) == 0 or total_rows(lin.source.batch) == 0:
        return None
    mids = list(lin.middle[:j])
    probe = shard_batch(mesh, lin.source.batch)
    for f in _segment_fns(mids):
        probe = f(probe)
    probe = as_part(mesh, probe)
    dict_key = any(
        probe.column(lk).dictionary is not None
        or build.column(rk).dictionary is not None
        for lk, rk in zip(opts.left_keys, opts.right_keys))
    fused = not (mids and dict_key)
    if not fused and probe.total == 0:
        return None
    joined = join_parts(mesh, probe, shard_batch(mesh, build), opts)
    if fused and mids:
        _count("join_fused_pre")
    _count("join_exchange")

    tail: List = list(lin.middle[j + 1:])
    if lin.terminal is not None:
        tail.append(lin.terminal)
    tail += list(lin.post_ops)
    if not tail and lin.post_fetch is None:
        return joined
    cur = Declaration("table_source", TableSourceNodeOptions(joined))
    for d in tail:
        # a downstream hashjoin keeps its own build subtree; only its probe
        # side is the exchanged result
        cur = Declaration(d.factory_name, d.options,
                          inputs=[cur] + list(d.inputs[1:]))
    if lin.post_fetch is not None:
        cur = Declaration("fetch", lin.post_fetch, inputs=[cur])
    return run(cur, mesh)


# --- sort --------------------------------------------------------------------

_RID = "__dist_rid__"


def _distributed_sort_plan(lin, mesh: Mesh) -> Optional[DeviceBatch]:
    """An order_by terminal (reference ``_distributed_sort_plan``): the
    middles on each rank, a hidden global row id as the last key (the
    local stable sort's tie order), the range exchange, then the fetch
    after it over the ranks' parts."""
    t = shard_batch(mesh, lin.source.batch)
    for f in _segment_fns(lin.middle):
        t = f(t)
    t = as_part(mesh, t)
    if t.total == 0:
        return None
    rid = DeviceColumn(t.offset + torch.arange(
        t.capacity, dtype=torch.int64, device=t.row_count.device), None,
        T.int64())
    opts = lin.terminal.options
    keyed = _with(t, _RID, rid)
    out = distributed_sort_batch(
        mesh, ShardBatch(keyed.schema, keyed.columns, keyed.row_count,
                         t.offset, t.total),
        list(opts.sort_keys) + [(_RID, "ascending")],
        null_placement=opts.null_placement)
    sel = _drop(out, _RID)
    out = ShardBatch(sel.schema, sel.columns, sel.row_count, out.offset,
                     out.total)
    if lin.post_fetch is not None:
        out = fetch_part(mesh, out, lin.post_fetch.offset,
                         lin.post_fetch.count)
    return out


def whole(mesh: Mesh, batch: DeviceBatch) -> DeviceBatch:
    """A result of ``run`` whole on every rank."""
    return gather_host(mesh, batch) if isinstance(batch, ShardBatch) \
        else batch

