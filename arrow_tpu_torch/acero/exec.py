"""Plan executor for linear chains (counterpart of ``arrow_tpu/acero/exec.py``).

A chain of filter / project / aggregate / order_by declarations over a table
source lowers to DeviceBatch -> DeviceBatch functions that run eagerly,
one after the other; there is no jit. A filter directly below an aggregate
(with only projects between) folds into the aggregate as a row mask, so
its rows never move. Other node kinds, a standalone filter and fetch are
not ported yet and raise NotImplementedError.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from .. import types as T
from ..compute.grouper import (group_capacity_bound, group_ids,
                               group_slot_bound_exact)
from ..compute.keys import sort_key_arrays, stable_sort_indices
from ..compute.registry import ExecContext, get_function
from ..compute.selection import filter_batch, gather_columns, selection_mask
from ..device.column import DeviceBatch, DeviceColumn, download
from ..types import Field, Schema, from_torch_dtype
from .expression import Expression
from .options import (AggregateNodeOptions, FilterNodeOptions,
                      OrderByNodeOptions, ProjectNodeOptions)


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
            if not isinstance(c, DeviceColumn):  # broadcast literal
                v = torch.full((batch.capacity,), c,
                               device=batch.row_count.device)
                c = DeviceColumn(v, None, from_torch_dtype(v.dtype))
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
    if not keys:
        raise NotImplementedError(
            "scalar aggregates are not ported yet (ROADMAP.md, queue 1, "
            "item 9: the long tail)")

    def _ctx(batch):
        ctx = ExecContext(batch.capacity, batch.row_count)
        if pre_mask_expr is None:
            return ctx
        keep, _ = selection_mask(ctx, pre_mask_expr.evaluate(batch, ctx))
        masked = ExecContext(batch.capacity, batch.row_count)
        masked.row_mask_ = keep
        return masked

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
            out_cols.append(r.column)
            out_fields.append(Field(out_name, r.column.type))
        # pad every output to the block-multiple bound on the group count
        bound = group_capacity_bound(key_cols, cap)
        return DeviceBatch(Schema(out_fields),
                           [_fit(c, bound) for c in out_cols],
                           g.num_groups.to(torch.int32))

    return fn, None


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


def _node_order_by(options: OrderByNodeOptions, schema):
    names = [k for k, _ in options.sort_keys]
    orders = [o for _, o in options.sort_keys]
    placement = options.null_placement

    def fn(batch: DeviceBatch) -> DeviceBatch:
        ctx = ExecContext(batch.capacity, batch.row_count)
        cols = []
        for n in names:
            c = batch.column(n)
            cols.append(_rank_col(c) if c.dictionary is not None else c)
        perm = stable_sort_indices(
            sort_key_arrays(cols, orders, placement, ctx.row_mask()))
        out_cols = [DeviceColumn(c.values[perm],
                                 c.validity[perm] if c.validity is not None
                                 else None, c.type, c.dictionary)
                    for c in batch.columns]
        return DeviceBatch(batch.schema, out_cols, batch.row_count)

    return fn, schema


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


def _node_fetch(options, schema):
    raise NotImplementedError(
        "fetch and the fused top-k are not ported yet (ROADMAP.md, queue 1, "
        "item 6: sort keys, the general grouper and sort)")


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
    projects) into the aggregate above it as a row mask."""
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


def compile_chain(decls: Sequence["Declaration"]) -> Callable:
    """Compose chainable node declarations (filter / project / aggregate /
    order_by) into one DeviceBatch -> DeviceBatch function, with the same
    filter-into-aggregate folding as the plan executor."""
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


class Declaration:
    """Declarative plan node (reference: acero/exec_plan.h:400)."""

    def __init__(self, factory_name: str, options=None, inputs=()):
        self.factory_name = factory_name
        self.options = options
        self.inputs = list(inputs)

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
        """Run a linear chain over its table source and download the
        result (``device.column.download``)."""
        chain = []
        cur = self
        while cur.factory_name != "table_source":
            if cur.factory_name not in _CHAINABLE or len(cur.inputs) != 1:
                raise NotImplementedError(
                    f"{cur.factory_name!r} nodes are not ported yet "
                    "(ROADMAP.md, queue 1, item 7: joins, then Q3 end to "
                    "end)")
            chain.append(cur)
            cur = cur.inputs[0]
        batch = cur.options.batch
        if chain:
            batch = compile_chain(list(reversed(chain)))(batch)
        return download(batch)

    def __repr__(self):
        return f"Declaration({self.factory_name})"
