"""Dremel shredding and record assembly of nested Parquet columns
(counterpart of ``arrow_tpu/io/parquet/nested.py``; reference:
cpp/src/parquet/arrow/path_internal.cc for writes, and
level_conversion.cc for reads). Host work by design, as the reference's:
a nested column becomes flat leaves.

A nested Arrow field maps to a tree of Parquet schema nodes. A list takes
the standard 3-level form

    optional group <name> (LIST) { repeated group list {
        optional <leaf> element } }

with two definition levels (the list is not null, the slot exists) and one
repetition level; an optional struct or leaf adds one definition level. A
non-nullable field's root is REQUIRED and adds none (the writer's schema
makes only the root required; its children stay optional).
``shred`` turns Python rows into (definition, repetition, value) streams a
leaf, and ``assemble`` turns them back into rows; the reader builds the
column's Array from those rows, as the reference does.
"""

from __future__ import annotations

from typing import Any, List, Sequence

import numpy as np

from ...types import DataType, TypeId

_LIST_IDS = (TypeId.LIST, TypeId.LARGE_LIST)


class _Null:
    """Null marker carrying its definition level (needed to distinguish a
    null struct from a struct of nulls during merge)."""

    __slots__ = ("d",)

    def __init__(self, d: int):
        self.d = d


class LeafSpec:
    """One Parquet leaf column under a nested field."""

    __slots__ = ("path", "type", "max_def", "max_rep", "nodes")

    def __init__(self, path, type, max_def, max_rep, nodes):
        self.path = path          # names from the field root, inclusive
        self.type = type          # arrow leaf type
        self.max_def = max_def
        self.max_rep = max_rep
        # nodes: ("list", d_list, r) | ("opt", d) — the leaf's own
        # presence is the last ("opt", max_def) node
        self.nodes = nodes


def is_nested(t: DataType) -> bool:
    return t.id in _LIST_IDS or t.id == TypeId.STRUCT


def leaf_specs(name: str, t: DataType,
               nullable: bool = True) -> List[LeafSpec]:
    """Depth-first leaves of a nested (or flat) field; the root adds no
    definition level where it is not ``nullable``."""
    out: List[LeafSpec] = []

    def walk(t: DataType, path, d, r, nodes, o=1):
        if t.id in _LIST_IDS:
            walk(t.value_type, path + ["list", "element"], d + o + 1, r + 1,
                 nodes + [("list", d + o, r + 1)])
        elif t.id == TypeId.STRUCT:
            inner = nodes + [("opt", d + 1)] if o else nodes
            for f in t.fields:
                walk(f.type, path + [f.name], d + o, r, inner)
        else:
            out.append(LeafSpec(path, t, d + o, r,
                                nodes + [("opt", d + o)]))

    walk(t, [name], 0, 0, [], int(nullable))
    return out


# --- shredding -------------------------------------------------------------


def shred(name: str, t: DataType, rows: Sequence[Any],
          nullable: bool = True):
    """rows -> [(leaf_spec, defs int64[], reps int64[], values list)]; a
    field that is not ``nullable`` has a REQUIRED root and holds no null
    row."""
    specs = leaf_specs(name, t, nullable)
    streams = [([], [], []) for _ in specs]

    def emit_nulls(si_lo, si_hi, d, r):
        for si in range(si_lo, si_hi):
            streams[si][0].append(d)
            streams[si][1].append(r)

    def leaf_range(t: DataType, si: int) -> int:
        """# of leaves under t starting at leaf index si."""
        if t.id in _LIST_IDS:
            return leaf_range(t.value_type, si)
        if t.id == TypeId.STRUCT:
            for f in t.fields:
                si = leaf_range(f.type, si)
            return si
        return si + 1

    def walk(v, t: DataType, d, r, si, rdepth, o=1) -> int:
        """Returns next leaf index after t's subtree. `r` is the rep value
        for this subtree's FIRST entry; `rdepth` counts repeated
        ancestors; `o` is the definition level this node adds (0 for a
        REQUIRED root)."""
        if v is None and not o:
            raise ValueError(f"column {name!r} is declared non-nullable "
                             "but holds nulls")
        if t.id in _LIST_IDS:
            si_end = leaf_range(t, si)
            if v is None:
                emit_nulls(si, si_end, d, r)
            elif len(v) == 0:
                emit_nulls(si, si_end, d + o, r)
            else:
                for i, item in enumerate(v):
                    walk(item, t.value_type, d + o + 1,
                         r if i == 0 else rdepth + 1, si, rdepth + 1)
            return si_end
        if t.id == TypeId.STRUCT:
            if v is None:
                si_end = leaf_range(t, si)
                emit_nulls(si, si_end, d, r)
                return si_end
            for f in t.fields:
                fv = (v.get(f.name) if isinstance(v, dict) else
                      getattr(v, f.name))
                si = walk(fv, f.type, d + o, r, si, rdepth)
            return si
        # leaf
        defs, reps, vals = streams[si]
        if v is None:
            defs.append(d)
            reps.append(r)
        else:
            defs.append(d + o)
            reps.append(r)
            vals.append(v)
        return si + 1

    for row in rows:
        walk(row, t, 0, 0, 0, 0, int(nullable))

    return [(spec, np.asarray(s[0], np.int64), np.asarray(s[1], np.int64),
             s[2]) for spec, s in zip(specs, streams)]


# --- assembly --------------------------------------------------------------


def _assemble_leaf(spec: LeafSpec, defs, reps, values) -> List[Any]:
    """Per-leaf skeleton rows: lists -> python lists, nulls -> _Null(def),
    values -> value."""
    vi = 0
    n = len(defs)
    rows: List[Any] = []
    i = 0

    def parse(lo, hi, ni, d_attained):
        """Assemble entries [lo,hi) at node index ni."""
        nonlocal vi
        kind = spec.nodes[ni][0]
        if kind == "list":
            _, d_list, r = spec.nodes[ni]
            d0 = defs[lo]
            if hi - lo == 1 and d0 < d_list:
                return _Null(int(d0))
            if hi - lo == 1 and d0 == d_list:
                # list present, no elements — but if deeper defs exist
                # this entry IS an element; d_list means empty only when
                # the def stops exactly here
                return []
            # split elements at entries with rep == r
            out = []
            start = lo
            for j in range(lo + 1, hi):
                if reps[j] == r:
                    out.append(parse(start, j, ni + 1, d_list + 1))
                    start = j
            out.append(parse(start, hi, ni + 1, d_list + 1))
            return out
        # opt node (struct presence or leaf)
        _, d_here = spec.nodes[ni]
        d0 = defs[lo]
        if d0 < d_here:
            return _Null(int(d0))
        if ni + 1 < len(spec.nodes):
            return parse(lo, hi, ni + 1, d_here)
        v = values[vi]
        vi += 1
        return v

    while i < n:
        j = i + 1
        while j < n and reps[j] != 0:
            j += 1
        rows.append(parse(i, j, 0, 0))
        i = j
    return rows


def _merge(t: DataType, skels: List[Any], d: int, o: int = 1):
    """Merge per-leaf skeletons of a subtree into final python values.
    skels has one entry per leaf of t (parallel structure); `o` is the
    definition level the subtree's root adds (0 where it is REQUIRED)."""
    if t.id in _LIST_IDS:
        s0 = skels[0]
        if isinstance(s0, _Null):
            return None
        if isinstance(s0, list) and len(s0) == 0:
            return []
        items = []
        for k in range(len(s0)):
            items.append(_merge(t.value_type, [s[k] for s in skels],
                                d + o + 1))
        return items
    if t.id == TypeId.STRUCT:
        d_struct = d + o
        if o and all(isinstance(s, _Null) for s in skels) and \
                all(s.d < d_struct for s in skels):
            return None
        out = {}
        si = 0
        for f in t.fields:
            cnt = _leaf_count(f.type)
            out[f.name] = _merge(f.type, skels[si:si + cnt], d_struct)
            si += cnt
        return out
    s = skels[0]
    return None if isinstance(s, _Null) else s


def _leaf_count(t: DataType) -> int:
    if t.id in _LIST_IDS:
        return _leaf_count(t.value_type)
    if t.id == TypeId.STRUCT:
        return sum(_leaf_count(f.type) for f in t.fields)
    return 1


def assemble(t: DataType, leaf_results, nullable: bool = True) -> List[Any]:
    """leaf_results: [(spec, defs, reps, values)] in leaf_specs order ->
    python rows for the nested field (REQUIRED at its root where it is not
    ``nullable``)."""
    skel_rows = [_assemble_leaf(spec, defs, reps, vals)
                 for spec, defs, reps, vals in leaf_results]
    n = len(skel_rows[0]) if skel_rows else 0
    o = int(nullable)
    return [_merge(t, [sr[i] for sr in skel_rows], 0, o) for i in range(n)]
