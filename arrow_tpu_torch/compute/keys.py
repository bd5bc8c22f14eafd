"""Order-preserving sort keys (counterpart of ``arrow_tpu/compute/keys.py``).

Each key column becomes a (class, word) pair of int64 tensors. The class
orders values, NaN, null and padding rows; the word's signed int64 order
is the value order. (The reference keeps uint64 words with the sign bit
flipped; torch has no unsigned 64-bit shifts or comparisons, and signed
order needs no flip.) Multi-key sorts are successive stable sorts, last
key first.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..device.column import DeviceColumn

_LOW63 = (1 << 63) - 1


def order_word(col: DeviceColumn) -> torch.Tensor:
    """int64 word whose order equals the value order (nulls and NaN are
    left to the class)."""
    v = col.values
    if v.dtype == torch.bool or not v.dtype.is_floating_point:
        return v.to(torch.int64)
    bits = v.to(torch.float64).view(torch.int64)
    # negative floats: flip all but the sign bit, reversing their order
    return torch.where(bits < 0, bits ^ _LOW63, bits)


def sort_class(col: DeviceColumn, row_mask: torch.Tensor, ascending: bool,
               null_placement: str) -> torch.Tensor:
    """Values, NaN and null in Arrow's order for ``null_placement``;
    padding rows always last (class 3)."""
    cap = col.capacity
    dev = col.values.device
    is_null = (~col.validity if col.validity is not None
               else torch.zeros(cap, dtype=torch.bool, device=dev))
    is_nan = (torch.isnan(col.values) if col.values.dtype.is_floating_point
              else torch.zeros(cap, dtype=torch.bool, device=dev))
    if null_placement == "at_end":   # values, nan, null
        cls_val, cls_nan, cls_null = 0, 1, 2
    else:                            # null, nan, values
        cls_val, cls_nan, cls_null = 2, 1, 0
    cls = torch.full((cap,), cls_val, dtype=torch.int64, device=dev)
    cls = torch.where(is_nan, cls_nan, cls)
    cls = torch.where(is_null, cls_null, cls)
    return torch.where(row_mask, cls, 3)


def sort_key_arrays(cols: Sequence[DeviceColumn], orders: Sequence[str],
                    null_placement: str,
                    row_mask: torch.Tensor) -> List[torch.Tensor]:
    """Flattened [class0, word0, class1, word1, ...], most significant
    first."""
    keys = []
    for col, order in zip(cols, orders):
        asc = order == "ascending"
        word = order_word(col)
        keys.append(sort_class(col, row_mask, asc, null_placement))
        keys.append(word if asc else ~word)
    return keys


def stable_sort_indices(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Permutation that sorts rows by ``keys`` lexicographically, stable:
    one stable sort per key, least significant first."""
    perm = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k in reversed(keys):
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm
