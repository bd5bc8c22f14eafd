"""Set lookup (``is_in``, ``index_in``), the null-filling scans,
``replace_with_mask``, ``run_end_encode`` and ``case_when`` (counterpart
of ``arrow_tpu/compute/vector_misc.py``).

A dictionary-coded column looks its codes up in one table of the
dictionary's slots (every slot whose value is in the set matches, as
derived dictionaries may hold a value twice); a numeric column compares
with each value of the set in turn, the value converted to the column's
dtype. A null in the value set matches nothing by value. A row's index is
that of the first value of the set it equals.

The null-filling scans take each row's nearest valid live row before
(after) it by a blocked max (min) scan of row positions
(``vector_sort._scan``). ``run_end_encode`` starts a run where the stored
value or the validity changes (so two null rows over different stored
values are two runs, and NaN starts a run at every row) and finds the
runs' starts by one compaction.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from .. import dtypes
from .. import types as T
from ..device.column import DeviceColumn
from .elementwise import one_dictionary
from .move import compact_by_mask
from .registry import register
from .selection import Compacted
from .strings import slot_lookup
from .vector_sort import _scan


def value_set_lookup(col: DeviceColumn, value_set: Sequence
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(found bool[capacity], index int64[capacity]): whether the row's
    value (null rows included, by their stored value) is in
    ``value_set``, and the index of its first occurrence there (-1 where
    it is not)."""
    if col.dictionary is not None:
        first = {}
        for i, v in enumerate(value_set):
            if v is not None and v not in first:
                first[v] = i
        idx = slot_lookup(col, np.array([first.get(v, -1)
                                         for v in col.dictionary],
                                        dtype=np.int64))
        return idx >= 0, idx
    dev = col.values.device
    name = col.value_dtype
    values = dtypes.load(col.values, name)
    found = torch.zeros(col.capacity, dtype=torch.bool, device=dev)
    idx = torch.full((col.capacity,), -1, dtype=torch.int64, device=dev)
    for i, v in enumerate(value_set):
        if v is None:
            continue
        hit = values == _set_value(v, name, dev)
        idx = torch.where(hit & ~found, i, idx)
        found |= hit
    return found, idx


def _set_value(v, name: str, device) -> torch.Tensor:
    """A value of the set in the column's dtype, as ``jnp.asarray(v,
    dtype)`` gives it (a uint64 at or above 2**63 as its bits)."""
    if name == "uint64" and isinstance(v, int) and v >= 1 << 63:
        return torch.tensor(v - (1 << 64), dtype=torch.int64, device=device)
    return dtypes.literal(v, name, device)


@register("is_in", "elementwise")
def is_in(ctx, col: DeviceColumn, value_set: Sequence = (),
          skip_nulls: bool = False) -> DeviceColumn:
    """The reference's null rules: the result has no nulls; a null row is
    true when the set holds a null and ``skip_nulls`` is False, else
    false."""
    found, _ = value_set_lookup(col, value_set)
    if col.validity is None:
        return DeviceColumn(found, None, T.bool_())
    if any(v is None for v in value_set) and not skip_nulls:
        return DeviceColumn(torch.where(col.validity, found, True), None,
                            T.bool_())
    return DeviceColumn(found & col.validity, None, T.bool_())


@register("index_in", "elementwise")
def index_in(ctx, col: DeviceColumn, value_set: Sequence = (),
             skip_nulls: bool = False) -> DeviceColumn:
    """int32 index of the row's value in ``value_set``, null where it is
    not there. A null row takes the index of the set's first null where
    there is one and ``skip_nulls`` is False, else is null. Null rows hold
    0, as in the reference."""
    found, idx = value_set_lookup(col, value_set)
    null_idx = next((i for i, v in enumerate(value_set) if v is None), -1)
    validity = found
    if col.validity is not None:
        if null_idx >= 0 and not skip_nulls:
            idx = torch.where(col.validity, idx, null_idx)
            validity = torch.where(col.validity, found, True)
        else:
            validity = found & col.validity
    return DeviceColumn(torch.where(validity, idx, 0).to(torch.int32),
                        validity, T.int32())


@register("fill_null_forward", "elementwise")
def fill_null_forward(ctx, col: DeviceColumn) -> DeviceColumn:
    """Each row's value, or the last valid live row's before it; null
    (over row 0's value) where there is none, and on padding rows."""
    live = col.valid_mask(ctx.row_mask())
    idx = torch.arange(ctx.capacity, dtype=torch.int64,
                       device=live.device)
    last = _scan(torch.where(live, idx, -1), "max", -1)
    has = last >= 0
    return DeviceColumn(col.values[torch.where(has, last, 0)],
                        has & ctx.row_mask(), col.type, col.dictionary)


@register("fill_null_backward", "elementwise")
def fill_null_backward(ctx, col: DeviceColumn) -> DeviceColumn:
    """Each row's value, or the next valid live row's after it; null
    (over row 0's value) where there is none."""
    cap = ctx.capacity
    live = col.valid_mask(ctx.row_mask())
    idx = torch.arange(cap, dtype=torch.int64, device=live.device)
    nxt = _scan(torch.where(live, idx, 2 * cap).flip(0), "min",
                2 * cap).flip(0)
    has = nxt < cap
    return DeviceColumn(col.values[torch.where(has, nxt, 0)],
                        has & ctx.row_mask(), col.type, col.dictionary)


@register("replace_with_mask", "vector")
def replace_with_mask(ctx, col: DeviceColumn, mask: DeviceColumn,
                      replacements: DeviceColumn) -> Compacted:
    """The k-th true, valid, live mask row takes ``replacements[k]``
    (converted to the column's dtype, with its validity); a null mask
    row gives null. A dictionary column and dictionary replacements over
    different dictionaries are first re-encoded against their union
    (``elementwise.one_dictionary``), where the reference mixes the codes."""
    col, replacements = one_dictionary([col, replacements])
    dev = col.values.device
    mv = mask.values.to(torch.bool) & ctx.row_mask()
    if mask.validity is not None:
        mv = mv & mask.validity
    k = torch.cumsum(mv, 0) - 1
    safe = k.clamp(0, replacements.capacity - 1)
    name = col.value_dtype
    rname = replacements.value_dtype
    rep = dtypes.store(dtypes.convert(
        dtypes.load(replacements.values[safe], rname), rname, name), name)
    out = torch.where(mv, rep, col.values)
    ones = torch.ones(ctx.capacity, dtype=torch.bool, device=dev)
    base = col.validity if col.validity is not None else ones
    rep_valid = replacements.validity[safe] \
        if replacements.validity is not None else ones
    validity = torch.where(mv, rep_valid, base)
    if mask.validity is not None:
        validity = validity & mask.validity
    return Compacted(DeviceColumn(out, validity, col.type, col.dictionary),
                     ctx.row_count)


@register("run_end_encode", "vector")
def run_end_encode(ctx, col: DeviceColumn) -> dict:
    """``{"run_ends", "values"}``, each a ``Compacted`` of the run count:
    int32 run ends (one past each run's last row) and each run's first
    value with its validity."""
    live = ctx.row_mask()
    valid = col.valid_mask()
    v = col.values
    new = torch.ones_like(live)
    new[1:] = (v[1:] != v[:-1]) | (valid[1:] != valid[:-1])
    idx = torch.arange(ctx.capacity, dtype=torch.int32, device=v.device)
    (starts,), n = compact_by_mask(new & live, [idx])
    # a run ends where the next starts, the last at the live rows' end;
    # past the runs, 0 and the last row's value, as in the reference
    ends = torch.cat([starts[1:], starts[:1]])
    ends = torch.where(idx == n - 1, ctx.row_count.to(torch.int32), ends)
    ends = torch.where(idx < n, ends, 0)
    first = torch.where(idx < n, starts, ctx.capacity - 1).long()
    return {"run_ends": Compacted(DeviceColumn(ends, None, T.int32()), n),
            "values": Compacted(DeviceColumn(v[first], valid[first],
                                             col.type, col.dictionary), n)}


@register("case_when", "elementwise")
def case_when(ctx, cond_struct, *cases) -> DeviceColumn:
    """``case_when([c1, c2, ...], v1, v2, ...[, else_value])``: the value
    of the first condition that is true (a null condition is not), else
    ``else_value``, else null. Values promote as ``jnp.where`` promotes
    them; the result takes the first value column's type (f64 when every
    value is a literal), as in the reference."""
    from . import elementwise as E
    conds = list(cond_struct) if isinstance(cond_struct, (list, tuple)) \
        else [cond_struct]
    vals = list(cases)
    has_else = len(vals) == len(conds) + 1
    dev = E._device_of(*conds, *vals)
    taken = torch.zeros(ctx.capacity, dtype=torch.bool, device=dev)
    kind = out_v = out_valid = None
    for c, v in zip(conds, vals):
        cv = E._load(c, "bool", dev)
        if isinstance(c, DeviceColumn) and c.validity is not None:
            cv = cv & c.validity
        fire = cv & ~taken
        vk = E._kind(v)
        vvd = E._validity_of(v)
        vvalid = vvd if vvd is not None else torch.ones_like(fire)
        if out_v is None:
            name = dtypes.promote(vk)
            kind = vk
            zero = torch.zeros((), dtype=dtypes.COMPUTE[name], device=dev)
            out_v = torch.where(fire, E._load(v, name, dev), zero)
            out_valid = fire & vvalid
        else:
            kind, out_v = E._select(fire, v, (kind, out_v), dev)
            out_valid = torch.where(fire, vvalid, out_valid)
        taken = taken | fire
    if has_else:
        ev = vals[-1]
        kind, out_v = E._select(taken, (kind, out_v), ev, dev)
        evd = E._validity_of(ev)
        out_valid = torch.where(taken, out_valid,
                                evd if evd is not None
                                else torch.ones_like(taken))
    t = next((v.type for v in vals if isinstance(v, DeviceColumn)), None)
    name = dtypes.promote(kind)
    return DeviceColumn(dtypes.store(out_v.expand(ctx.capacity), name),
                        out_valid, t if t is not None else T.float64())
