"""Column pruning (counterpart of ``arrow_tpu/acero/prune.py``).

The rewrite works out, for each declaration, the columns that the plan
above reads of its output, then

* narrows a hash join's ``left_output``/``right_output`` to them, so its
  gathers and compactions move only those columns;
* narrows a table source to them (``TableSourceNodeOptions.select``: no
  data moves; a host Table is narrowed before it is uploaded), and a
  dataset's scan likewise (``ScanNodeOptions.select``);
* drops the project expressions whose outputs nothing reads.

The root's own output is never narrowed. ``Declaration.to_table()`` runs
the rewrite on every plan that has a hash join and caches the pruned tree
on the root. Unlike the reference's, which clones a declaration each time
a parent reaches it, the rewrite keeps a declaration with two parents
shared: it narrows it to the union of what its parents read and clones it
once, so the executor still runs it once (``exec._Run``).
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Set

from .options import ProjectNodeOptions

_PROBE_ONLY = ("left semi", "left anti")
_BUILD_ONLY = ("right semi", "right anti")


def output_names(decl) -> Optional[List[str]]:
    """Names of the columns ``decl`` produces, or None where they depend
    on the data or the node is not analysed (the analysis stops there)."""
    f = decl.factory_name
    o = decl.options
    if f in ("table_source", "scan"):
        return list(o.names)
    if f in ("filter", "fetch", "order_by"):
        return output_names(decl.inputs[0])
    if f == "project":
        if o.names is not None:
            return list(o.names)
        return [e.name if e.kind == e.KIND_FIELD else repr(e)
                for e in o.expressions]
    if f == "aggregate":
        return list(o.segment_keys) + list(o.keys) + [
            out for (_t, _f, _o, out) in o.aggregates]
    if f == "hashjoin":
        if o.join_type in _PROBE_ONLY:
            ln = o.left_output if o.left_output is not None \
                else output_names(decl.inputs[0])
            return None if ln is None else list(ln)
        if o.join_type in _BUILD_ONLY:
            return output_names(decl.inputs[1])
        ln = o.left_output if o.left_output is not None \
            else output_names(decl.inputs[0])
        rn = o.right_output if o.right_output is not None \
            else output_names(decl.inputs[1])
        if ln is None or rn is None:
            return None
        return ([n + o.output_suffix_for_left if n in rn else n
                 for n in ln]
                + [n + o.output_suffix_for_right if n in ln else n
                   for n in rn])
    return None


def prune_plan(root):
    """An equivalent Declaration tree with narrowed join outputs, sources
    and projects; a declaration shared by several parents stays one
    object."""
    order = _parents_first(root)
    required: Dict[int, Optional[Set[str]]] = {id(root): None}
    rewritten = {}
    for d in order:
        options, needs = _rewrite(d, required[id(d)])
        rewritten[id(d)] = options
        for child, need in zip(d.inputs, needs):
            key = id(child)
            if key not in required:
                required[key] = need
            elif required[key] is not None:
                required[key] = None if need is None \
                    else required[key] | need
    clones: Dict[int, object] = {}

    def clone(d):
        key = id(d)
        if key not in clones:
            options = rewritten[key]
            if d.factory_name == "table_source" and options is d.options:
                clones[key] = d
            else:
                from .exec import Declaration
                clones[key] = Declaration(d.factory_name, options,
                                          [clone(i) for i in d.inputs])
        return clones[key]

    return clone(root)


def _parents_first(root) -> list:
    """Every declaration of the tree once, each after all its parents
    (a reversed post-order of the DAG)."""
    seen, post = set(), []

    def walk(d):
        seen.add(id(d))
        for i in d.inputs:
            if id(i) not in seen:
                walk(i)
        post.append(d)

    walk(root)
    return post[::-1]


def _rewrite(decl, required: Optional[Set[str]]):
    """(the declaration's options after narrowing, what it reads of each
    input: a set of names, or None for every column)."""
    f = decl.factory_name
    o = decl.options
    if f in ("table_source", "scan"):
        names = o.names
        if required is None:
            return o, []
        keep = [n for n in names if n in required]
        # a source that none of its columns is asked of keeps them all
        if len(keep) == len(names) or not keep:
            return o, []
        # a host source is narrowed before its upload
        return o.select(keep), []
    if f == "filter":
        need = None if required is None \
            else set(required) | set(o.filter_expression.field_names())
        return o, [need]
    if f == "fetch":
        return o, [required]
    if f == "order_by":
        need = None if required is None \
            else set(required) | {k for k, _ in o.sort_keys}
        return o, [need]
    if f == "project":
        names = output_names(decl)
        exprs = o.expressions
        if required is not None:
            keep = [i for i, n in enumerate(names) if n in required]
            if keep and len(keep) < len(names):
                exprs = [exprs[i] for i in keep]
                o = ProjectNodeOptions(exprs, [names[i] for i in keep])
        need = set()
        for e in exprs:
            need.update(e.field_names())
        return o, [need]
    if f == "aggregate":
        need = set(o.segment_keys) | set(o.keys)
        for target, _fn, _opts, _out in o.aggregates:
            if isinstance(target, str):
                need.add(target)
            elif target:
                need.update(t for t in target if isinstance(t, str))
        return o, [need]
    if f == "hashjoin":
        return _rewrite_join(decl, required)
    # union, asofjoin, sorted_merge, the sinks: every input keeps every
    # column
    return o, [None] * len(decl.inputs)


def _rewrite_join(decl, required):
    o = decl.options
    ln_all = o.left_output if o.left_output is not None \
        else output_names(decl.inputs[0])
    rn_all = o.right_output if o.right_output is not None \
        else output_names(decl.inputs[1])
    new_o = o
    probe_only = o.join_type in _PROBE_ONLY
    build_only = o.join_type in _BUILD_ONLY
    if (required is not None and not build_only and ln_all is not None
            and (probe_only or rn_all is not None)):
        rn_all = rn_all or []
        both = set(ln_all) & set(rn_all)
        lkeep = [n for n in ln_all if n in required or (
            n in both and n + o.output_suffix_for_left in required)]
        rkeep = [] if probe_only else [
            n for n in rn_all if n in required or (
                n in both and n + o.output_suffix_for_right in required)]
        # keep collision partners, so that the suffixes stay as they were
        lkeep2 = lkeep + [n for n in ln_all if n in both and n in rkeep
                          and n not in lkeep]
        rkeep2 = rkeep + [n for n in rn_all if n in both and n in lkeep
                          and n not in rkeep]
        lkeep = [n for n in ln_all if n in lkeep2]
        rkeep = [n for n in rn_all if n in rkeep2]
        if not lkeep and not rkeep:
            # a batch carries its capacity in its columns: keep one
            lkeep = [o.left_keys[0]] if o.left_keys[0] in ln_all \
                else ln_all[:1]
        if len(lkeep) < len(ln_all) or (not probe_only
                                        and len(rkeep) < len(rn_all)):
            new_o = copy.copy(o)
            new_o.left_output = lkeep
            if not probe_only:
                new_o.right_output = rkeep
    # the residual filter reads fields of either side
    res = set() if o.filter_expression is None \
        else set(o.filter_expression.field_names())
    l_need = r_need = None
    if ln_all is not None:
        sel = new_o.left_output if new_o.left_output is not None else ln_all
        l_need = set(sel) | set(o.left_keys) | res
    if build_only:
        r_need = None
    elif rn_all is not None:
        sel = new_o.right_output if new_o.right_output is not None \
            else rn_all
        r_need = set(sel) | set(o.right_keys) | res
    elif probe_only:
        r_need = set(o.right_keys) | res
    return new_o, [l_need, r_need]
