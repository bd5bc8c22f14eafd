"""Set lookup, ``is_in``, and ``case_when`` (counterpart of
``arrow_tpu/compute/vector_misc.py``).

A dictionary-coded column looks its codes up in one table of the
dictionary's slots (every slot whose value is in the set matches, as
derived dictionaries may hold a value twice); a numeric column compares
with each value of the set in turn, the value converted to the column's
dtype. A null in the value set matches nothing by value.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .. import dtypes
from .. import types as T
from ..device.column import DeviceColumn
from .registry import register
from .strings import slot_lookup


def value_set_lookup(col: DeviceColumn, value_set: Sequence) -> torch.Tensor:
    """bool[capacity]: the row's value (null rows included, by their
    stored value) is in ``value_set``."""
    wanted = [v for v in value_set if v is not None]
    if col.dictionary is not None:
        return slot_lookup(col, np.array([v in wanted for v in col.dictionary],
                                         dtype=np.bool_))
    dev = col.values.device
    name = col.value_dtype
    values = dtypes.load(col.values, name)
    found = torch.zeros(col.capacity, dtype=torch.bool, device=dev)
    for v in wanted:
        found |= values == _set_value(v, name, dev)
    return found


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
    found = value_set_lookup(col, value_set)
    if col.validity is None:
        return DeviceColumn(found, None, T.bool_())
    if any(v is None for v in value_set) and not skip_nulls:
        return DeviceColumn(torch.where(col.validity, found, True), None,
                            T.bool_())
    return DeviceColumn(found & col.validity, None, T.bool_())


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
