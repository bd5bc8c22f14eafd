"""Host-tier grouped aggregations: ``list``, ``distinct`` and
``pivot_wider`` (counterpart of ``arrow_tpu/acero/host_agg.py``; reference:
compute/kernels/hash_aggregate.cc GroupedListImpl, GroupedDistinctImpl,
GroupedPivotImpl). Their outputs are lists and structs, which have no
fixed-width device representation, so they run on the host, vectorized
with numpy: one stable sort of the rows by group, a gather of the values.

Groups come in order of first appearance, as the device grouper gives
them, so an aggregate that mixes host and device functions zips the two
by position: its device functions still run on the card, through a table
source of the same input. The exact host fallback (``_GENERIC_HOST``)
computes the aggregates whose target column exists on the device only as
codes: decimals wider than 18 digits and nested columns.
"""

from __future__ import annotations

import decimal as _d
from typing import List, Optional, Tuple

import numpy as np

from .. import types as T
from ..array.array import Array, array as make_array
from ..array.data import ArrayData
from ..buffer import Buffer
from ..device.column import (_first_appearance, download_table,
                             host_column_repr, host_take)
from ..table import Table

HOST_AGGS = {"list", "distinct", "pivot_wider"}

# the aggregations with exact host implementations, for target columns
# that exist on the device only as codes (wide decimals, nested columns)
_GENERIC_HOST = {"sum", "mean", "product", "min", "max", "min_max",
                 "count", "count_distinct", "first", "last", "one",
                 "variance", "stddev"}


def _base(fn: str) -> str:
    return fn[5:] if fn.startswith("hash_") else fn


def _value_type(t):
    return t.value_type if t.id == T.TypeId.DICTIONARY else t


def _target(agg) -> str:
    target = agg[0]
    return target if isinstance(target, str) else target[0]


def _target_needs_host(tbl: Table, agg) -> bool:
    """Whether the aggregate's target column exists on the device only as
    codes that a numeric reduction cannot use."""
    if _base(agg[1]) not in _GENERIC_HOST:
        return False
    try:
        t = tbl.column(_target(agg)).type
    except KeyError:
        return False
    if t.is_decimal:
        return t.precision > 18
    return t.is_nested


def wants_host_tier(decl) -> bool:
    """Whether ``decl`` is an aggregate with a host-tier function."""
    return decl.factory_name == "aggregate" and any(
        _base(a[1]) in HOST_AGGS for a in decl.options.aggregates)


def maybe_host_aggregate(decl, force: bool = False,
                         device=None) -> Optional[Table]:
    """The result Table of an aggregate root whose functions include a
    host-tier one (or, with ``force``, whose target columns exist only as
    codes), else None. The input runs on ``device`` (the card by default)
    unless it is a host table source; the device aggregates run on
    ``device`` through a table source of the input."""
    if decl.factory_name != "aggregate":
        return None
    from .exec import Declaration, _sources_on, execute_declaration
    from .options import AggregateNodeOptions, TableSourceNodeOptions
    from .. import default_device
    options = decl.options
    aggs = options.aggregates
    if not force and not any(_base(a[1]) in HOST_AGGS for a in aggs):
        return None
    seg_keys = list(options.segment_keys)
    keys = seg_keys + list(options.keys)
    src = decl.inputs[0]
    if src.factory_name == "table_source" and src.options.is_host:
        tbl = src.options.table
    else:
        dev = default_device(device)
        tbl = download_table(execute_declaration(_sources_on(src, dev),
                                                 _root=False))
    host = [a for a in aggs if _base(a[1]) in HOST_AGGS
            or _target_needs_host(tbl, a)]
    dev_aggs = [a for a in aggs if a not in host]
    named, key_arrays = _host_group_aggs(tbl, keys, host)
    if dev_aggs:
        # the device aggregates over the columns they read, through a
        # table source of the input
        need = [n for n in tbl.column_names if n in set(keys) | {
            t for a in dev_aggs for t in ([a[0]] if isinstance(a[0], str)
                                         else a[0])}]
        dev_src = src.options.select(need) if src.factory_name == \
            "table_source" and src.options.is_host \
            else TableSourceNodeOptions(tbl.select(need))
        dev_tbl = Declaration("aggregate", AggregateNodeOptions(
            dev_aggs, keys=keys), [Declaration(
                "table_source", dev_src)]).to_table(device=device)
        key_arrays = [dev_tbl.column(i).combine() for i in range(len(keys))]
        for i in range(len(keys), dev_tbl.num_columns):
            named[dev_tbl.column_names[i]] = dev_tbl.column(i).combine()
    arrays = list(key_arrays) + [named[a[3]] for a in aggs]
    out = Table.from_arrays(arrays, keys + [a[3] for a in aggs])
    if seg_keys:
        out = out.sort_by([(k, "ascending") for k in seg_keys],
                          device=device)
    return out


def _value_codes(arr: Array, hc=None) -> Tuple[np.ndarray, int]:
    """(int64 codes of a host Array's values, their count): equal values
    equal codes, a null the last code. ``hc`` is its prepared device
    representation where made already. Integers of a small range (and
    dictionary codes) are their own codes, less the least; other values
    are coded in order of first appearance."""
    hc = host_column_repr(arr) if hc is None else hc
    vals = hc.values
    d = hc.dictionary
    if d is not None and not isinstance(d, Array) and len(set(d)) < len(d):
        # a dictionary that holds a value twice: one code a value
        first = {}
        vals = np.array([first.setdefault(v, i) for i, v in enumerate(d)],
                        np.int64)[vals.astype(np.int64)]
    codes = None
    if vals.dtype.kind in "iub" and len(vals):
        lo, hi = int(vals.min()), int(vals.max())
        if hi - lo <= max(len(vals), 1 << 16):
            codes, card = vals.astype(np.int64) - lo, hi - lo + 1
    if codes is None:
        if vals.dtype.kind == "f":
            # -0.0 groups with 0.0, and every NaN with every other
            vals = np.where(vals == 0, 0, vals)
        codes, first = _first_appearance(vals)
        codes, card = codes.astype(np.int64), len(first)
    if hc.mask is not None:
        codes = np.where(hc.mask, codes, card)
        card += 1
    return codes, card


def group_ids(tbl: Table, keys: List[str]) -> Tuple[np.ndarray, int,
                                                    List[Array]]:
    """(group id a row in order of first appearance, the group count, the
    key values a group as Arrays of the keys' value types)."""
    from .source_cache import prepared_column
    n = tbl.num_rows
    if not keys:
        return np.zeros(n, np.int64), 1, []
    cols = [tbl.column(k).combine() for k in keys]
    codes, card = None, 1
    for k, c in zip(keys, cols):
        cc, cn = _value_codes(c, prepared_column(tbl.column(k)))
        if codes is None:
            codes, card = cc, cn
            continue
        if card * cn >= 1 << 62:
            # the product would overflow: the codes so far made dense
            codes, first = _first_appearance(codes)
            codes, card = codes.astype(np.int64), len(first)
        codes, card = codes * cn + cc, card * cn
    gids, first = _first_appearance(codes)
    return gids.astype(np.int64), len(first), [host_take(c, first)
                                               for c in cols]


def _list_array(child: Array, counts: np.ndarray) -> Array:
    offsets = np.zeros(len(counts) + 1, dtype=np.int32)
    np.cumsum(counts, out=offsets[1:])
    return Array(ArrayData(T.list_(child.type), len(counts),
                           [None, Buffer(offsets)], [child.data],
                           null_count=0))


def _host_group_aggs(tbl: Table, keys: List[str], aggs):
    """({output name: Array}, the key Arrays) of the host-tier
    aggregates, groups in order of first appearance."""
    from ..compute.registry import ArrowInvalid
    gids, ngroups, key_arrays = group_ids(tbl, keys)
    # a stable sort of narrow integers is a radix sort
    order = np.argsort(gids.astype(np.int16) if ngroups < 1 << 15
                       else gids, kind="stable")
    counts = np.bincount(gids, minlength=ngroups)[:ngroups]
    out: dict = {}
    for agg in aggs:
        target, fn, opts, out_name = agg
        base = _base(fn)
        opts = dict(opts or {})
        if base == "list":
            col = tbl.column(_target(agg)).combine()
            out[out_name] = _list_array(host_take(col, order), counts)
        elif base == "distinct":
            col = tbl.column(_target(agg)).combine()
            vcodes, vcard = _value_codes(col)
            _, first = _first_appearance(gids * vcard + vcodes)
            if opts.get("mode", "only_valid") != "all":
                first = first[col.is_valid_mask()[first]]
            first = first[np.lexsort((first, gids[first]))]
            out[out_name] = _list_array(
                host_take(col, first),
                np.bincount(gids[first], minlength=ngroups)[:ngroups])
        elif base == "pivot_wider":
            out[out_name] = _pivot_wider(tbl, agg, gids, ngroups, opts)
        elif base in _GENERIC_HOST:
            col = tbl.column(_target(agg)).combine()
            out[out_name] = _generic_group_agg(base, col, gids, ngroups,
                                               opts, order, counts)
        else:
            raise ArrowInvalid(f"not a host aggregation: {fn}")
    return out, key_arrays


def _pivot_wider(tbl: Table, agg, gids, ngroups: int, opts) -> Array:
    """One struct a group, a field a key name: the group's value under
    that key (null where none; two non-null values raise)."""
    from ..compute.registry import ArrowInvalid
    target = agg[0]
    if isinstance(target, str) or len(target) != 2:
        raise ArrowInvalid("pivot_wider requires [key, value] target columns")
    key_names = list(opts.get("key_names") or ())
    kcol = tbl.column(target[0]).combine()
    vcol = tbl.column(target[1]).combine()
    hk = host_column_repr(kcol)
    if hk.dictionary is not None:
        lookup = {k: j for j, k in enumerate(key_names)}
        kidx = np.array([lookup.get(v, -1) for v in hk.dictionary] or [-1],
                        np.int64)[hk.values.astype(np.int64)]
    else:
        vals = kcol.to_numpy() if kcol.null_count == 0 else hk.values
        kidx = np.full(len(kcol), -1, np.int64)
        for j, k in enumerate(key_names):
            kidx[vals == k] = j
    kvalid = kcol.is_valid_mask()
    if opts.get("unexpected_key_behavior", "ignore") == "raise":
        bad = (kidx < 0) & kvalid
        if bad.any():
            raise ArrowInvalid(
                f"Unexpected pivot key: {kcol[int(np.argmax(bad))]}")
    use = (kidx >= 0) & kvalid & vcol.is_valid_mask()
    rows = np.nonzero(use)[0]
    slot = gids[rows] * max(len(key_names), 1) + kidx[rows]
    if len(slot) and np.bincount(slot).max() > 1:
        raise ArrowInvalid("Encountered more than one non-null value for "
                           "the same grouped pivot key")
    vt = _value_type(vcol.type)
    children = []
    for j in range(len(key_names)):
        at = np.zeros(ngroups, np.int64)
        has = np.zeros(ngroups, np.bool_)
        pick = rows[kidx[rows] == j]
        at[gids[pick]] = pick
        has[gids[pick]] = True
        children.append(host_take(vcol, at, has).data)
    st = T.struct([(k, vt) for k in key_names])
    return Array(ArrayData(st, ngroups, [None], children, null_count=0))


def _generic_group_agg(base: str, col: Array, gids, ngroups: int, opts,
                       order, counts) -> Array:
    """The exact host aggregate over Python values (the fallback for a
    target that exists only as codes), with the device kernels' null
    rules (``ScalarAggregateOptions``)."""
    from ..compute.registry import ArrowInvalid
    vals = col.to_pylist()
    bounds = np.concatenate([[0], np.cumsum(counts)]).tolist()
    ordered = [vals[i] for i in order.tolist()]
    raw = [ordered[bounds[g]:bounds[g + 1]] for g in range(ngroups)]
    skip_nulls = opts.get("skip_nulls", True)
    min_count = opts.get("min_count",
                         0 if base in ("first", "last", "one") else 1)
    buckets = [[v for v in b if v is not None] for b in raw]
    has_null = [len(b) != len(r) for b, r in zip(buckets, raw)]
    t = _value_type(col.type)

    def ok(g):
        return len(buckets[g]) >= min_count and (skip_nulls
                                                  or not has_null[g])

    try:
        if base == "count":
            mode = opts.get("mode", "only_valid")
            rows = ([len(b) for b in buckets] if mode == "only_valid"
                    else [len(r) - len(b) for b, r in zip(buckets, raw)]
                    if mode == "only_null" else [len(r) for r in raw])
            return make_array(rows, T.int64())
        if base == "count_distinct":
            return make_array([len(set(b)) for b in buckets], T.int64())
        if base in ("min", "max"):
            f = min if base == "min" else max
            return make_array([f(b) if b and ok(g) else None
                               for g, b in enumerate(buckets)], t)
        if base == "min_max":
            st = T.struct([("min", t), ("max", t)])
            return make_array([{"min": min(b), "max": max(b)}
                               if b and ok(g) else {"min": None, "max": None}
                               for g, b in enumerate(buckets)], st)
        if base in ("first", "last", "one"):
            return make_array([(b[-1] if base == "last" else b[0])
                               if b else None for b in buckets], t)
        if base in ("variance", "stddev"):
            ddof = opts.get("ddof", 0)
            rows = []
            for g, b in enumerate(buckets):
                fv = [float(x) for x in b]
                if len(fv) - ddof <= 0 or not ok(g):
                    rows.append(None)
                    continue
                mu = sum(fv) / len(fv)
                var = sum((x - mu) ** 2 for x in fv) / (len(fv) - ddof)
                rows.append(var if base == "variance" else var ** 0.5)
            return make_array(rows, T.float64())
        if base in ("sum", "mean", "product"):
            if not t.is_decimal:
                raise ArrowInvalid(f"{base} has no host kernel for {t!r}")
            wide = t.id == T.TypeId.DECIMAL256
            out_t = (T.decimal256(76, t.scale) if wide
                     else T.decimal128(38, t.scale))
            quant = _d.Decimal(1).scaleb(-t.scale)
            rows = []
            for g, b in enumerate(buckets):
                if not ok(g) or (base == "mean" and not b):
                    rows.append(None)
                elif base == "sum":
                    rows.append(sum(b, _d.Decimal(0)).quantize(quant))
                elif base == "product":
                    p = _d.Decimal(1)
                    for v in b:
                        p *= v
                    rows.append(p.quantize(quant, rounding=_d.ROUND_HALF_UP))
                else:
                    with _d.localcontext() as cctx:
                        cctx.prec = 80
                        m = sum(b, _d.Decimal(0)) / len(b)
                    rows.append(m.quantize(quant, rounding=_d.ROUND_HALF_UP))
            return make_array(rows, out_t)
    except TypeError as e:
        raise ArrowInvalid(f"{base} has no host kernel for {t!r}: {e}") \
            from None
    raise ArrowInvalid(f"not a host aggregation: {base}")

