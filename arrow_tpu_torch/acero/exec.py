"""Plan executor (counterpart of ``arrow_tpu/acero/exec.py``).

A Declaration tree runs node by node, eagerly, with no jit:

* a maximal linear run of filter / project / aggregate / order_by / fetch
  declarations lowers to DeviceBatch -> DeviceBatch functions. A filter
  directly below an aggregate (with only projects between) folds into the
  aggregate as a row mask, so its rows never move; an order_by directly
  below a fetch of at most ``_TOPK_MAX`` rows runs as one top-k. A
  segmented aggregate ends the run: it groups by its segment keys then
  its keys, and sorts its output by the segment keys;
* a hash join runs each side's trailing filter/project chain, recodes
  dictionary-coded key pairs into one union dictionary, prefilters the
  probe side with a bloom filter of the build keys when the probe side is
  at least four times larger and the join type drops unmatched probe rows
  (inner, left semi, right semi, right outer), and plans the join. Right
  semi and anti joins filter the build batch, left semi and anti joins
  compact the probe batch, with no readback. The other types read back
  the output total, the largest per-row match count and, for right and
  full outer joins, the unmatched build count (the only host readback: it
  sizes the output and picks the unique-build path), gather the output
  rows, and append the unmatched build rows of a right or full outer join.
  A join with a residual filter expands every equi-matched pair, keeps
  the pairs that pass, and decides each join type on those
  (``_execute_hashjoin_residual``);
* ``union`` concatenates its inputs and moves the live rows to the front
  with one compaction, ``sorted_merge`` sorts that union, and
  ``asofjoin`` finds each left row's most recent right row with one
  search (``_execute_asof_join``);
* ``sink`` and ``table_sink`` pass their input through, ``order_by_sink``
  sorts it and ``select_k_sink`` keeps its first k rows in order.

A declaration with two or more parents in the tree runs once per
execution (``_Run``). An aggregate with no keys gives one row
(``_scalar_aggregate_fn``); a filter folds into it as into a grouped
one. ``Declaration.to_table()`` prunes a plan with a hash join to the
columns it reads first (``prune.py``). ``consuming_sink``,
``pivot_longer`` and the host-table sources need a host Table and raise
NotImplementedError naming their ROADMAP item.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import dtypes
from .. import types as T
from ..compute import bloom
from ..compute import join as J
from ..compute.grouper import (group_capacity_bound, group_ids,
                               group_slot_bound_exact)
from ..compute.keys import sort_key_arrays, stable_sort_indices
from ..compute.move import compact_by_mask, gather_rows, segment_count
from ..compute.elementwise import literal_column
from ..compute.registry import ExecContext, get_function
from ..compute.selection import (compact_columns, filter_batch,
                                 gather_columns, selection_mask, take_batch)
from ..device.column import (BLOCK, DeviceBatch, DeviceColumn,
                             capacity_class, download)
from ..types import HOST_BOUNDARY, Field, Schema
from .expression import Expression
from .options import (AggregateNodeOptions, FetchNodeOptions,
                      FilterNodeOptions, HashJoinNodeOptions,
                      OrderByNodeOptions, ProjectNodeOptions)
from .prune import prune_plan

# nodes that take or give a host Table
_HOST_NODES = ("consuming_sink", "pivot_longer", "named_table", "source",
               "record_batch_source", "exec_batch_source",
               "array_vector_source", "record_batch_reader_source", "scan")
_SINKS = ("sink", "table_sink", "order_by_sink", "select_k_sink")


def _node_filter(options: FilterNodeOptions, schema):
    expr = options.filter_expression

    def fn(batch: DeviceBatch) -> DeviceBatch:
        ctx = ExecContext(batch.capacity, batch.row_count)
        return filter_batch(batch, expr.evaluate(batch, ctx))

    return fn, schema


def _node_project(options: ProjectNodeOptions, schema):
    exprs = options.expressions
    names = options.names or [repr(e) if e.kind != Expression.KIND_FIELD
                              else e.name for e in exprs]

    def fn(batch: DeviceBatch) -> DeviceBatch:
        ctx = ExecContext(batch.capacity, batch.row_count)
        cols = []
        for e in exprs:
            c = e.evaluate(batch, ctx)
            if not isinstance(c, DeviceColumn):
                # broadcast literal, in numpy's dtype for it (a float is
                # f64), as the reference's jnp.full under x64
                c = literal_column(c, batch.capacity,
                                   batch.row_count.device)
            elif c.values.dim() == 0:
                # a cast literal: broadcast (the reference's plan raises
                # IndexError on a 0-d column here)
                c = DeviceColumn(c.values.expand(batch.capacity).clone(),
                                 None, c.type)
            cols.append(c)
        out_schema = Schema([Field(n, c.type) for n, c in zip(names, cols)])
        return DeviceBatch(out_schema, cols, batch.row_count)

    return fn, None


def _node_aggregate(options: AggregateNodeOptions, schema,
                    pre_mask_expr=None):
    """pre_mask_expr: a filter predicate folded into the aggregation. Its
    mask joins the aggregation's row mask instead of compacting rows."""
    aggs = options.aggregates
    keys = options.keys

    def _ctx(batch):
        ctx = ExecContext(batch.capacity, batch.row_count)
        if pre_mask_expr is None:
            return ctx
        keep, _ = selection_mask(ctx, pre_mask_expr.evaluate(batch, ctx))
        masked = ExecContext(batch.capacity, batch.row_count)
        masked.row_mask_ = keep
        return masked

    if not keys:
        return _scalar_aggregate_fn(aggs, _ctx), None

    def fn(batch: DeviceBatch) -> DeviceBatch:
        ctx = _ctx(batch)
        key_cols = [batch.column(k) for k in keys]
        g = group_ids(ctx, key_cols)
        cap = batch.capacity
        dev = batch.row_count.device
        # keys first (reference output order, groupby_aggregate_node.cc)
        nseg = group_slot_bound_exact(key_cols, cap)
        safe_rep = torch.where(
            torch.arange(nseg, dtype=torch.int64, device=dev)
            < g.num_groups, g.rep_indices[:nseg], 0)
        out_cols = gather_columns(key_cols, safe_rep)
        out_fields = [Field(k, c.type) for k, c in zip(keys, out_cols)]
        for target, fname, opts, out_name in aggs:
            dev_name = fname if fname.startswith("hash_") \
                else "hash_" + fname
            impl = get_function(dev_name).impl
            if dev_name == "hash_count_all":
                r = impl(ctx, g.group_ids, g.num_groups,
                         num_segments=nseg, **opts)
            else:
                tcol = batch.column(target if isinstance(target, str)
                                    else target[0])
                r = impl(ctx, tcol, g.group_ids, g.num_groups,
                         num_segments=nseg, **opts)
            # hash_min_max gives {"min": ..., "max": ...}: two columns
            parts = r.items() if isinstance(r, dict) else [(None, r)]
            for sub, rr in parts:
                out_cols.append(rr.column)
                out_fields.append(Field(
                    out_name if sub is None else f"{out_name}_{sub}",
                    rr.column.type))
        # pad every output to the block-multiple bound on the group count
        bound = group_capacity_bound(key_cols, cap)
        return DeviceBatch(Schema(out_fields),
                           [_fit(c, bound) for c in out_cols],
                           g.num_groups.to(torch.int32))

    return fn, None


def _scalar_aggregate_fn(aggs, make_ctx) -> Callable:
    """``keys=[]``: one row at the block capacity, each aggregate's value
    and validity at row 0 and zeros behind them (reference:
    ``exec.py`` ``_node_aggregate_inner``). A struct or list result
    (``min_max``, ``first_last``, ``quantile`` of several ``q``) gives a
    column ``{out}_{field}`` a field; a code result keeps its
    dictionary. ``count_all`` is handed the first column, as in the
    reference, and reads none."""
    def fn(batch: DeviceBatch) -> DeviceBatch:
        ctx = make_ctx(batch)
        dev = batch.row_count.device
        cols, fields = [], []
        for target, fname, opts, out_name in aggs:
            impl = get_function(fname).impl
            tcol = batch.columns[0] if fname == "count_all" else \
                batch.column(target if isinstance(target, str)
                             else target[0])
            r = impl(ctx, tcol, **opts)
            if r.fields is None:
                parts = [(out_name, r.value, r.valid, r.type)]
            else:
                # every field has the first's type (a list has one)
                parts = [(f"{out_name}_{name}", v, ok, r.type.fields[0].type)
                         for name, v, ok in zip(r.fields, r.value, r.valid)]
            for name, value, valid, t in parts:
                values = torch.zeros(BLOCK, dtype=value.dtype, device=dev)
                validity = torch.zeros(BLOCK, dtype=torch.bool, device=dev)
                values[0] = value
                validity[0] = valid
                cols.append(DeviceColumn(values, validity, t, r.dictionary))
                fields.append(Field(name, t))
        return DeviceBatch(Schema(fields), cols,
                           torch.ones((), dtype=torch.int32, device=dev))

    return fn


def _fit(c: DeviceColumn, bound: int) -> DeviceColumn:
    vals, validity = c.values[:bound], c.validity
    if validity is not None:
        validity = validity[:bound]
    pad = bound - vals.shape[0]
    if pad > 0:
        vals = torch.cat([vals, vals.new_zeros(pad)])
        if validity is not None:
            validity = torch.cat([validity, validity.new_zeros(pad)])
    return DeviceColumn(vals, validity, c.type, c.dictionary)


def _sort_permutation(batch: DeviceBatch,
                      options: OrderByNodeOptions) -> torch.Tensor:
    """The stable permutation that orders ``batch`` by the sort keys, with
    the padding rows last."""
    ctx = ExecContext(batch.capacity, batch.row_count)
    cols = []
    for name, _ in options.sort_keys:
        c = batch.column(name)
        cols.append(_rank_col(c) if c.dictionary is not None else c)
    orders = [o for _, o in options.sort_keys]
    return stable_sort_indices(sort_key_arrays(
        cols, orders, options.null_placement, ctx.row_mask()))


def _node_order_by(options: OrderByNodeOptions, schema):
    def fn(batch: DeviceBatch) -> DeviceBatch:
        return take_batch(batch, _sort_permutation(batch, options),
                          batch.row_count)

    return fn, schema


_TOPK_MAX = 1024


def _make_topk_fn(options: OrderByNodeOptions, offset: int, count: int):
    """order_by then fetch(offset, count) as one top-k: one sort of the row
    indices, then gathers of the ``count`` rows kept (reference:
    vector_select_k.cc)."""
    def fn(batch: DeviceBatch) -> DeviceBatch:
        take = _sort_permutation(batch, options)[offset:offset + count]
        new_count = (batch.row_count - offset).clamp(0, count)
        return take_batch(batch, take, new_count.to(torch.int32))

    return fn


def _rank_col(c: DeviceColumn) -> DeviceColumn:
    """Dictionary codes -> ranks of their values (host sort of the
    dictionary), so the codes sort in value order."""
    dev = c.values.device
    vals = list(c.dictionary)
    if not vals:
        return DeviceColumn(torch.zeros(c.capacity, dtype=torch.int64,
                                        device=dev), c.validity, T.int64())
    order = np.argsort(np.array(vals, dtype=object), kind="stable")
    ranks = np.empty(len(vals), dtype=np.int64)
    ranks[order] = np.arange(len(vals))
    safe = c.values.long().clamp(0, len(vals) - 1)
    return DeviceColumn(torch.from_numpy(ranks).to(dev)[safe], c.validity,
                        T.int64())


def _node_fetch(options: FetchNodeOptions, schema):
    offset, count = options.offset, options.count

    def fn(batch: DeviceBatch) -> DeviceBatch:
        remaining = (batch.row_count - offset).clamp(min=0)
        new_count = remaining if count < 0 else remaining.clamp(max=count)
        cols = []
        for c in batch.columns:
            vals = torch.roll(c.values, -offset) if offset else c.values
            validity = (torch.roll(c.validity, -offset)
                        if c.validity is not None and offset
                        else c.validity)
            cols.append(DeviceColumn(vals, validity, c.type, c.dictionary))
        return DeviceBatch(batch.schema, cols, new_count.to(torch.int32))

    return fn, schema


_CHAINABLE = {
    "filter": _node_filter,
    "project": _node_project,
    "aggregate": _node_aggregate,
    "order_by": _node_order_by,
    "fetch": _node_fetch,
}


def _segment_fns(decls: Sequence["Declaration"]) -> List[Callable]:
    """Lower a linear run of chainable declarations (execution order) to
    DeviceBatch -> DeviceBatch functions, folding a filter (followed only by
    projects) into the aggregate above it as a row mask, and an order_by
    followed by a small fetch into one top-k."""
    decls = list(decls)
    node_fns: List[Callable] = []
    i = 0
    while i < len(decls):
        d = decls[i]
        if d.factory_name == "filter":
            j = i + 1
            while j < len(decls) and decls[j].factory_name == "project":
                j += 1
            if j < len(decls) and decls[j].factory_name == "aggregate":
                proj_fns = [_node_project(p.options, None)[0]
                            for p in decls[i + 1:j]]
                agg_fn, _ = _node_aggregate(
                    decls[j].options, None,
                    pre_mask_expr=d.options.filter_expression)
                node_fns.append(_fused(proj_fns, agg_fn))
                i = j + 1
                continue
        if d.factory_name == "order_by" and i + 1 < len(decls) \
                and decls[i + 1].factory_name == "fetch":
            fo = decls[i + 1].options
            if 0 <= fo.count and 0 <= fo.offset \
                    and fo.offset + fo.count <= _TOPK_MAX:
                node_fns.append(_make_topk_fn(d.options, fo.offset,
                                              fo.count))
                i += 2
                continue
        fn, _ = _CHAINABLE[d.factory_name](d.options, None)
        node_fns.append(fn)
        i += 1
    return node_fns


def _fused(proj_fns, agg_fn):
    def fused(batch: DeviceBatch) -> DeviceBatch:
        # carry the original columns too: the mask may reference columns
        # the projects drop
        projected = batch
        for f in proj_fns:
            projected = f(projected)
        cols = list(projected.columns)
        fields = list(projected.schema.fields)
        have = set(projected.schema.names)
        for fld, c in zip(batch.schema.fields, batch.columns):
            if fld.name not in have:
                cols.append(c)
                fields.append(fld)
        return agg_fn(DeviceBatch(Schema(fields), cols, batch.row_count))
    return fused


def _apply(decls: Sequence["Declaration"], batch: DeviceBatch
           ) -> DeviceBatch:
    for f in _segment_fns(decls):
        batch = f(batch)
    return batch


def compile_chain(decls: Sequence["Declaration"]) -> Callable:
    """Compose chainable node declarations (filter / project / aggregate /
    order_by / fetch) into one DeviceBatch -> DeviceBatch function, with
    the executor's folding rules."""
    decls = list(decls)
    for d in decls:
        if d.factory_name not in _CHAINABLE:
            raise ValueError(f"{d.factory_name!r} is not chainable")
    node_fns = _segment_fns(decls)

    def run(batch: DeviceBatch) -> DeviceBatch:
        for f in node_fns:
            batch = f(batch)
        return batch

    return run


# --- the tree executor ----------------------------------------------------

def execute_declaration(decl: "Declaration") -> DeviceBatch:
    """Run a Declaration tree; the result stays on the device.

    A declaration with more than one parent in the tree (a common
    subexpression: Q2's partsupp of the region's suppliers, Q11's
    partsupp of the nation's, Q15's revenue view, Q22's customers of the
    country codes) runs once, and each parent reads its batch. Running it
    twice, as the reference does, would give two results whose float sums
    may differ in their last bits, because the card's grouped sums add
    with atomics in no fixed order: Q15's join of each supplier's revenue
    with their maximum would then drop the supplier it must keep."""
    return _Run(decl).execute(decl)


class _Run:
    """One execution of a tree: its shared declarations and their
    batches."""

    def __init__(self, root: "Declaration"):
        parents: Dict[int, int] = {}

        def walk(d):
            for x in d.inputs:
                parents[id(x)] = parents.get(id(x), 0) + 1
                if parents[id(x)] == 1:
                    walk(x)
        walk(root)
        self.shared = {k for k, n in parents.items() if n > 1}
        self.done: Dict[int, DeviceBatch] = {}

    def execute(self, decl: "Declaration") -> DeviceBatch:
        if id(decl) in self.done:
            return self.done[id(decl)]
        out = self._execute(decl)
        if id(decl) in self.shared:
            self.done[id(decl)] = out
        return out

    def _execute(self, decl: "Declaration") -> DeviceBatch:
        f = decl.factory_name
        if f == "table_source":
            return decl.options.batch
        if f == "hashjoin":
            left_pre, lsrc = self._pre_chain(decl.inputs[0])
            right_pre, rsrc = self._pre_chain(decl.inputs[1])
            return _execute_hashjoin(decl.options, self.execute(lsrc),
                                     self.execute(rsrc), left_pre,
                                     right_pre)
        if _segmented(decl):
            return _segmented_aggregate(decl.options,
                                        self.execute(decl.inputs[0]))
        if f in _CHAINABLE:
            # the maximal linear run of chainable nodes above the next
            # source, shared declaration or segmented aggregate
            seg = []
            cur = decl
            while cur.factory_name in _CHAINABLE and (cur is decl or (
                    id(cur) not in self.shared and not _segmented(cur))):
                seg.append(cur)
                cur = cur.inputs[0]
            return _apply(list(reversed(seg)), self.execute(cur))
        if f in ("union", "sorted_merge"):
            out = _execute_union([self.execute(i) for i in decl.inputs])
            if f == "union":
                return out
            return _node_order_by(OrderByNodeOptions(
                decl.options.sort_keys, decl.options.null_placement),
                None)[0](out)
        if f == "asofjoin":
            return _execute_asof_join(decl.options,
                                      self.execute(decl.inputs[0]),
                                      self.execute(decl.inputs[1]))
        if f in _SINKS:
            return _execute_sink(f, decl.options,
                                 self.execute(decl.inputs[0]))
        if f in _HOST_NODES:
            raise NotImplementedError(
                f"{f!r} nodes need a host Table, which the port does not "
                "have yet " + HOST_BOUNDARY)
        raise ValueError(f"unknown node factory {f!r}")

    def _pre_chain(self, decl: "Declaration"):
        """The trailing run of filter/project nodes above a join input, in
        execution order, and the node below them; a shared declaration
        ends the run."""
        chain = []
        cur = decl
        while cur.factory_name in ("filter", "project") \
                and id(cur) not in self.shared:
            chain.append(cur)
            cur = cur.inputs[0]
        chain.reverse()
        return tuple(chain), cur


_BLOOM_TYPES = ("inner", "left semi", "right semi", "right outer")


def _execute_hashjoin(options: HashJoinNodeOptions, left: DeviceBatch,
                      right: DeviceBatch, left_pre=(),
                      right_pre=()) -> DeviceBatch:
    """The left input probes, the right input builds (Acero builds on
    inputs[1])."""
    jt = options.join_type
    # bloom pushdown where an unmatched probe row gives no output: the
    # filter has no false negatives; capacities are static, so this is
    # decided on the host
    bloom_on = (not options.disable_bloom_filter and jt in _BLOOM_TYPES
                and left.capacity >= 4 * right.capacity)
    left = _apply(left_pre, left)
    right = _apply(right_pre, right)
    if options.filter_expression is not None:
        return _execute_hashjoin_residual(options, left, right)
    lkeys = [left.column(k) for k in options.left_keys]
    rkeys = [right.column(k) for k in options.right_keys]
    unified = _unify_dictionary_keys(lkeys, rkeys)
    if bloom_on:
        b_live = right.row_mask()
        p_live = left.row_mask()
        for c in rkeys:
            b_live = c.valid_mask(b_live)
        for c in lkeys:
            p_live = c.valid_mask(p_live)
        bf = bloom.build_bloom(rkeys, b_live,
                               bloom.log_bits_for(right.capacity))
        hit = bloom.bloom_query(bf, lkeys, p_live)
        # the remapped probe keys ride the same compaction as the batch
        n = len(left.columns)
        cols, count = compact_columns(
            left.columns + [lkeys[i] for i in unified], hit)
        left = DeviceBatch(left.schema, cols[:n], count)
        remapped = dict(zip(unified, cols[n:]))
        lkeys = [remapped.get(i, left.column(k))
                 for i, k in enumerate(options.left_keys)]
    plan = J.build_join_plan(rkeys, lkeys, right.row_count, left.row_count,
                             jt)
    if jt in ("right semi", "right anti"):
        # filters of the build batch: the whole right batch comes out
        unmatched, matched = J.unmatched_build_plan(plan, right.row_count)
        keep = matched if jt == "right semi" else unmatched
        return filter_batch(right, DeviceColumn(keep, None, T.bool_()))
    if jt in ("left semi", "left anti"):
        # the kept probe rows, in order: one stable compaction
        lnames, _, schema = _join_output_schema(options, left, right)
        cols, count = compact_columns(left.select(lnames).columns,
                                      plan.out_counts > 0)
        return DeviceBatch(schema, cols, count)
    # the one readback: the total sizes the output, a largest count of at
    # most 1 means every probe row matches at most one build row, and the
    # right and full outer joins add their unmatched build rows
    unmatched = None
    reads = [plan.total, plan.counts.max()]
    if jt in ("right outer", "full outer"):
        unmatched, _ = J.unmatched_build_plan(plan, right.row_count)
        reads.append(unmatched.sum())
    total, max_count, *n_unmatched = torch.stack(reads).tolist()
    n_unmatched = n_unmatched[0] if n_unmatched else 0
    unique_build = jt in ("inner", "left outer") and max_count <= 1
    out_cap = capacity_class(max(total + n_unmatched, 1))
    if unique_build:
        # the identity and compaction expansions work in probe-capacity
        # space
        out_cap = left.capacity if jt == "left outer" \
            else min(out_cap, left.capacity)
    return _join_materialize(options, plan, left, right, out_cap,
                             unique_build, total, unmatched, n_unmatched)


def _unify_dictionary_keys(lkeys: List[DeviceColumn],
                           rkeys: List[DeviceColumn]) -> List[int]:
    """Dictionary-coded key pairs recoded, in place in both lists, into one
    union dictionary: planned on the host, codes remapped on the device
    (reference: ``exec.py:1086-1113``, ``_plan_unify``). Returns the key
    positions recoded."""
    unified = []
    for i, (lk, rk) in enumerate(zip(lkeys, rkeys)):
        if lk.dictionary is None and rk.dictionary is None:
            continue
        if lk.dictionary is None or rk.dictionary is None:
            raise ValueError(
                "hashjoin key mixes dictionary-coded and plain columns")
        lkeys[i], rkeys[i] = _unify_dictionaries([lk, rk])
        unified.append(i)
    return unified


def _unify_dictionaries(cols: Sequence[DeviceColumn]) -> List[DeviceColumn]:
    """Dictionary-coded columns recoded into one union dictionary
    (reference: ``exec.py`` ``unify_dictionaries``): planned on the host,
    codes remapped on the device."""
    if any(c.dictionary is None for c in cols):
        raise ValueError("mixes dictionary-coded and plain columns")
    union, maps = _plan_unify([c.dictionary for c in cols])
    return [_recode(c, m, union) for c, m in zip(cols, maps)]


def _plan_unify(dicts):
    """(union dictionary, per dictionary its code -> union code); the
    union lists the first dictionary's values, then each next one's new
    ones."""
    union: List = []
    index: Dict = {}

    def add(values):
        mapping = np.zeros(max(len(values), 1), dtype=np.int32)
        for i, v in enumerate(values):
            if v not in index:
                index[v] = len(union)
                union.append(v)
            mapping[i] = index[v]
        return mapping

    maps = [add(d) for d in dicts]
    return tuple(union), maps


def _recode(c: DeviceColumn, mapping: np.ndarray, union) -> DeviceColumn:
    table = torch.from_numpy(mapping).to(c.values.device)
    (codes,) = gather_rows([table], c.values.long())
    return DeviceColumn(codes, c.validity, c.type, union)


def _join_output_schema(options: HashJoinNodeOptions, left: DeviceBatch,
                        right: DeviceBatch):
    """(left names, right names, output schema); a name on both sides
    takes its side's suffix. Left semi and anti joins output the probe
    side only, with no suffixes."""
    lnames = options.left_output if options.left_output is not None \
        else left.schema.names
    if options.join_type in ("left semi", "left anti"):
        return lnames, [], left.select(lnames).schema
    rnames = options.right_output if options.right_output is not None \
        else right.schema.names
    fields = []
    for names, batch, other, suffix in (
            (lnames, left, rnames, options.output_suffix_for_left),
            (rnames, right, lnames, options.output_suffix_for_right)):
        for n in names:
            f = batch.schema.fields[batch.schema.get_field_index(n)]
            fields.append(Field(n + suffix, f.type) if n in other else f)
    return lnames, rnames, Schema(fields)


def _join_materialize(options: HashJoinNodeOptions, plan: J.JoinPlan,
                      left: DeviceBatch, right: DeviceBatch, out_cap: int,
                      unique_build: bool, total: int,
                      unmatched: Optional[torch.Tensor],
                      n_unmatched: int) -> DeviceBatch:
    jt = options.join_type
    lnames, rnames, out_schema = _join_output_schema(options, left, right)
    probe_idx, build_idx, build_valid = J.join_gather_indices(
        plan, out_cap, jt, unique_build=unique_build)
    lsub, rsub = left.select(lnames), right.select(rnames)
    if unique_build and jt == "left outer":
        # the identity expansion: the probe columns do not move
        lcols = list(lsub.columns)
    else:
        # an empty output list emits no columns of that side (Q3's first
        # join)
        lcols = gather_columns(lsub.columns, probe_idx)
    rcols = gather_columns(rsub.columns, build_idx, build_valid)
    if unmatched is None:
        return DeviceBatch(out_schema, lcols + rcols,
                           plan.total.to(torch.int32))
    # right and full outer: the unmatched build rows, in build-row order,
    # after the probe-side rows, with a null probe side
    end = total + n_unmatched
    lcols = [DeviceColumn(c.values, _set_validity(c, total, out_cap, False),
                          c.type, c.dictionary) for c in lcols]
    if rcols:
        appended, _ = compact_columns(rsub.columns, unmatched)
        for c, a in zip(rcols, appended):
            # c.values is the gather's own tensor: write in place
            c.values[total:end] = a.values[:n_unmatched]
            c.validity = _set_validity(
                c, total, end,
                True if a.validity is None else a.validity[:n_unmatched])
    return DeviceBatch(out_schema, lcols + rcols,
                       torch.tensor(end, dtype=torch.int32,
                                    device=plan.total.device))


def _set_validity(c: DeviceColumn, start: int, stop: int,
                  value) -> torch.Tensor:
    """A copy of ``c``'s validity (all valid when it has none) with rows
    ``[start, stop)`` set to ``value``."""
    validity = (torch.ones(c.capacity, dtype=torch.bool,
                           device=c.values.device)
                if c.validity is None else c.validity.clone())
    validity[start:stop] = value
    return validity


def _execute_hashjoin_residual(options: HashJoinNodeOptions,
                               left: DeviceBatch,
                               right: DeviceBatch) -> DeviceBatch:
    """A hash join with a residual filter (reference:
    ``_execute_hashjoin_residual``, after Acero's JoinResidualFilter): every
    equi-matched pair is expanded, the filter is evaluated over the pair's
    columns (a null result rejects the pair), and the join type decides on
    the pairs that pass. Semi and anti joins filter one side by its count
    of passing pairs. The other types read back the three counts that size
    the output (the only readback after the pair total), then one
    compaction orders the rows each output row reads: the passing pairs,
    then the unmatched probe rows, then the unmatched build rows. No bloom
    filter runs, as in the reference."""
    jt = options.join_type
    lkeys = [left.column(k) for k in options.left_keys]
    rkeys = [right.column(k) for k in options.right_keys]
    for lk, rk in zip(lkeys, rkeys):
        if (lk.dictionary is None) != (rk.dictionary is None):
            raise ValueError(
                "hashjoin key mixes dictionary-coded and plain columns")
        if lk.dictionary is not None and lk.dictionary is not rk.dictionary \
                and lk.dictionary != rk.dictionary:
            raise ValueError(
                "a residual-filter join needs its dictionary-coded keys to "
                "share one dictionary; cast them to values first")
    plan = J.build_join_plan(rkeys, lkeys, right.row_count, left.row_count,
                             "inner")
    pair_cap = capacity_class(max(int(plan.total), 1))
    probe_idx, build_idx, _ = J.join_gather_indices(plan, pair_cap, "inner")
    passed = _residual_mask(options.filter_expression, left, right,
                            probe_idx, build_idx, plan.total, pair_cap)
    probe_hits = segment_count(passed, probe_idx, left.capacity)
    build_hits = segment_count(passed, torch.where(passed, build_idx, 0),
                               right.capacity)
    probe_unmatched = left.row_mask() & (probe_hits == 0)
    build_unmatched = right.row_mask() & (build_hits == 0)
    if jt in ("left semi", "left anti"):
        keep = probe_unmatched if jt == "left anti" \
            else left.row_mask() & (probe_hits > 0)
        lnames, _, schema = _join_output_schema(options, left, right)
        cols, count = compact_columns(left.select(lnames).columns, keep)
        return DeviceBatch(schema, cols, count)
    if jt in ("right semi", "right anti"):
        keep = build_unmatched if jt == "right anti" \
            else right.row_mask() & (build_hits > 0)
        return filter_batch(right, DeviceColumn(keep, None, T.bool_()))
    with_probe = jt in ("left outer", "full outer")
    with_build = jt in ("right outer", "full outer")
    n_pass, n_probe, n_build = torch.stack(
        [passed.sum(), probe_unmatched.sum(), build_unmatched.sum()]).tolist()
    out_cap = capacity_class(max(n_pass + n_probe * with_probe
                                 + n_build * with_build, 1))
    # each output row's probe and build row, -1 where that side is null
    dev = passed.device
    keep, lrows, rrows = [passed], [probe_idx], [build_idx]
    for on, unmatched, cap, own in ((with_probe, probe_unmatched,
                                     left.capacity, lrows),
                                    (with_build, build_unmatched,
                                     right.capacity, rrows)):
        if on:
            keep.append(unmatched)
            for rows in (lrows, rrows):
                rows.append(torch.arange(cap, device=dev) if rows is own
                            else torch.full((cap,), -1, device=dev))
    (li, ri), count = compact_by_mask(torch.cat(keep),
                                      [torch.cat(lrows), torch.cat(rrows)])
    li, ri = _fit_rows(li, out_cap), _fit_rows(ri, out_cap)
    lnames, rnames, schema = _join_output_schema(options, left, right)
    cols = gather_columns(left.select(lnames).columns, li, li >= 0) \
        + gather_columns(right.select(rnames).columns, ri, ri >= 0)
    return DeviceBatch(schema, cols, count)


def _residual_mask(expr: Expression, left: DeviceBatch, right: DeviceBatch,
                   probe_idx, build_idx, total, pair_cap) -> torch.Tensor:
    """bool[pair_cap]: the live pairs for which the filter is true. The
    filter reads the pair's columns by their unsuffixed names, the left
    side's where both sides have one; only those columns are gathered."""
    names = set(expr.field_names())
    fields, cols = [], []
    for batch, idx in ((left, probe_idx), (right, build_idx)):
        for f, c in zip(batch.schema.fields, batch.columns):
            if f.name in names:
                names.discard(f.name)
                fields.append(f)
                cols += gather_columns([c], idx)
    pairs = DeviceBatch(Schema(fields), cols,
                        total.clamp(max=pair_cap).to(torch.int32))
    ctx = ExecContext(pair_cap, pairs.row_count)
    passed, _ = selection_mask(ctx, expr.evaluate(pairs, ctx))
    return passed


def _fit_rows(rows: torch.Tensor, cap: int) -> torch.Tensor:
    if rows.shape[0] >= cap:
        return rows[:cap]
    return torch.cat([rows, rows.new_full((cap - rows.shape[0],), -1)])


def _segmented(decl: "Declaration") -> bool:
    return decl.factory_name == "aggregate" and bool(
        decl.options.segment_keys)


def _segmented_aggregate(options: AggregateNodeOptions,
                         batch: DeviceBatch) -> DeviceBatch:
    """The segment keys group in front of the keys; the output is then
    sorted by the segment keys, stably (reference: ``_execute_node``'s
    segmented aggregate)."""
    folded = AggregateNodeOptions(
        options.aggregates, keys=options.segment_keys + options.keys)
    out = _node_aggregate(folded, None)[0](batch)
    by = OrderByNodeOptions([(k, "ascending") for k in options.segment_keys])
    return _node_order_by(by, None)[0](out)


def _execute_sink(name: str, options, batch: DeviceBatch) -> DeviceBatch:
    if name == "order_by_sink":
        return _node_order_by(OrderByNodeOptions(
            options.sort_keys, options.null_placement), None)[0](batch)
    if name == "select_k_sink":
        # order_by then fetch(0, k), fused into a top-k as in a chain
        return _apply([Declaration("order_by",
                                   OrderByNodeOptions(options.sort_keys)),
                       Declaration("fetch", FetchNodeOptions(0, options.k))],
                      batch)
    return batch


def _execute_union(batches: List[DeviceBatch]) -> DeviceBatch:
    """The inputs' columns, by position, concatenated at the sum of their
    capacities (a dictionary column recoded into the union of its
    dictionaries), then the live rows moved to the front in input order
    by one compaction (reference: ``_execute_union``)."""
    schema = batches[0].schema
    if any(len(b.columns) != len(schema.fields) for b in batches):
        raise ValueError("union inputs have different numbers of columns")
    cols = []
    for i in range(len(schema.fields)):
        parts = [b.columns[i] for b in batches]
        if any(c.dictionary is not None for c in parts):
            parts = _unify_dictionaries(parts)
        validity = None
        if any(c.validity is not None for c in parts):
            validity = torch.cat([c.valid_mask() for c in parts])
        cols.append(DeviceColumn(torch.cat([c.values for c in parts]),
                                 validity, parts[0].type,
                                 parts[0].dictionary))
    cols, count = compact_columns(
        cols, torch.cat([b.row_mask() for b in batches]))
    return DeviceBatch(schema, cols, count)


_INT64_MAX = (1 << 63) - 1


def _execute_asof_join(options, left: DeviceBatch,
                       right: DeviceBatch) -> DeviceBatch:
    """Each left row with the right payload columns (all but ``on`` and
    the by-keys) of its most recent right row, null where there is none
    (reference: ``_execute_asof_join``). By-keys map to shared dense ids
    (``join._side_gids``); the right ``on`` values are ranked, and each
    row's (id, rank) packs into one int64: id << 32 | rank, with ids below
    2**31 and ranks at most the right capacity, below 2**32, so the sign
    bit stays clear and the packed order is the (id, rank) order. Dead
    right rows pack to INT64_MAX, above every live word. One stable sort
    of the right words and one ``searchsorted`` find each left row's
    match: among right rows with equal by-keys and ``on``, the last in
    the right input's order. The tolerance then applies as the reference
    applies it."""
    lon, ron = left.column(options.left_on), right.column(options.right_on)
    lby = [left.column(k) for k in options.left_by]
    rby = [right.column(k) for k in options.right_by]
    for i, (lk, rk) in enumerate(zip(lby, rby)):
        if lk.dictionary is not None or rk.dictionary is not None:
            lby[i], rby[i] = _unify_dictionaries([lk, rk])
    dev = left.row_count.device
    l_cap, r_cap = left.capacity, right.capacity
    if r_cap >= 1 << 32:
        raise ValueError("as-of join: the right side holds 2**32 rows or "
                         "more")
    lmask, rmask = left.row_mask(), right.row_mask()
    if rby:
        gb, gp = J._side_gids(rby, lby, rmask, lmask)
    else:
        gb = torch.where(rmask, 0, -(torch.arange(r_cap, device=dev) + 2))
        gp = torch.where(lmask, 0, -1)
    # unsigned values widened (uint16/uint32) before they widen to int64
    lv, rv = (dtypes.load(c.values, c.value_dtype).long()
              for c in (lon, ron))
    # the live right values sorted, padding above every real value
    rv_sorted = torch.sort(torch.where(rmask, rv, 1 << 62)).values
    # rank: the right values at or below it (a tolerance <= 0 looks back)
    lrank = torch.searchsorted(rv_sorted, lv, right=True)
    rrank = torch.searchsorted(rv_sorted, rv, right=True)
    rkey = torch.where(rmask & (gb >= 0), gb.clamp(min=0) << 32 | rrank,
                       _INT64_MAX)
    order = stable_sort_indices([rkey])
    lkey = gp.clamp(min=0) << 32 | lrank
    pos = torch.searchsorted(rkey[order], lkey, right=True) - 1
    (cand,) = gather_rows([order], pos)
    cand_g, cand_v = gather_rows([gb, rv], cand)
    ok = (pos >= 0) & (cand_g == gp) & (gp >= 0) & lmask
    tol = options.tolerance
    if tol <= 0:
        ok &= (cand_v >= lv + tol) & (cand_v <= lv)
    else:
        ok &= cand_v <= lv + tol
    rnames = [n for n in right.schema.names
              if n not in (options.right_on, *options.right_by)]
    rcols = gather_columns([right.column(n) for n in rnames],
                           torch.where(ok, cand, 0), ok)
    fields = list(left.schema.fields) + [
        right.schema.fields[right.schema.get_field_index(n)] for n in rnames]
    return DeviceBatch(Schema(fields), list(left.columns) + rcols,
                       left.row_count)


class Declaration:
    """Declarative plan node (reference: acero/exec_plan.h:400)."""

    def __init__(self, factory_name: str, options=None, inputs=()):
        self.factory_name = factory_name
        self.options = options
        self.inputs = list(inputs)
        self._pruned: Optional["Declaration"] = None

    @staticmethod
    def from_sequence(decls: Sequence["Declaration"]) -> "Declaration":
        it = iter(decls)
        current = next(it)
        for d in it:
            current = Declaration(d.factory_name, d.options,
                                  d.inputs + [current] if d.inputs
                                  else [current])
        return current

    def to_table(self) -> Dict[str, list]:
        """Run the plan and download the result
        (``device.column.download``). A plan with a hash join runs pruned
        to the columns it reads (``prune.prune_plan``, as the reference's
        ``to_table`` does); the pruned tree is cached on the root."""
        plan = self
        if any(d.factory_name == "hashjoin" for d in _walk(self)):
            if self._pruned is None:
                self._pruned = prune_plan(self)
            plan = self._pruned
        return download(execute_declaration(plan))

    def __repr__(self):
        return f"Declaration({self.factory_name})"


def _walk(decl: Declaration):
    yield decl
    for i in decl.inputs:
        yield from _walk(i)
