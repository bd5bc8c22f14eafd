"""Set lookup: ``is_in`` (counterpart of ``arrow_tpu/compute/vector_misc.py``).

A dictionary-coded column looks its codes up in one table of the
dictionary's slots (every slot whose value is in the set matches, as
derived dictionaries may hold a value twice); a numeric column compares
with each value of the set in turn. A null in the value set matches
nothing by value.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

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
    found = torch.zeros(col.capacity, dtype=torch.bool,
                        device=col.values.device)
    for v in wanted:
        found |= col.values == torch.tensor(v, dtype=col.values.dtype,
                                            device=col.values.device)
    return found


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
