"""Order- and equality-preserving keys (counterpart of
``arrow_tpu/compute/keys.py``).

Each sort key column becomes a (class, word) pair of int64 tensors. The
class orders values, NaN, null and padding rows; the word's signed int64
order is the value order. The reference keeps uint64 words in unsigned
order; torch has no unsigned 64-bit comparisons, so the port's words are
the reference's with the sign bit flipped: a signed integer's word is its
value, an unsigned integer's its value with the sign bit flipped (so
uint64 values of 2**63 and above order last), a float's its f64 bits
with the negative ones reversed (f16 and f32 through f64). Temporal
types and decimals order by their integer storage. Multi-key sorts are
successive stable sorts, last key first.

Equality words for grouping and joins are the reference's uint64 words
with the same bits, held as int64: a signed value sign-extended, an
unsigned one zero-extended, a float's f64 bits with one NaN word. So
equal values have equal words, an int64 -1 and a uint64 2**64 - 1 share
one (as in the reference), and the all-ones word (``GROUP_KEY_DEAD``)
reads -1.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from .. import dtypes
from ..device.column import DeviceColumn
from ..dtypes import INT64_MIN

_LOW63 = (1 << 63) - 1
_QNAN_BITS = 0x7FF8000000000000
# packed class word of padding rows: uint64 all-ones, -1 as int64
GROUP_KEY_DEAD = -1


def f64_bits(f: torch.Tensor) -> torch.Tensor:
    """The IEEE-754 bits of f64 values as int64, every NaN as one quiet
    NaN word; -0.0 keeps its own word."""
    f = f.to(torch.float64)
    return torch.where(torch.isnan(f), _QNAN_BITS, f.view(torch.int64))


def equality_word(col: DeviceColumn) -> torch.Tensor:
    """int64 word with value equality == word equality (bit level, like the
    reference's memcmp-able row encoding)."""
    name = col.value_dtype
    v = dtypes.load(col.values, name)
    if dtypes.is_float(name):
        return f64_bits(v)
    return v.to(torch.int64)


def group_key_arrays(cols: Sequence[DeviceColumn],
                     row_mask: torch.Tensor) -> List[torch.Tensor]:
    """Equality keys for grouping: one packed class word (bit i set where
    column i is null; ``GROUP_KEY_DEAD`` on rows outside ``row_mask``),
    then one word per column, 0 on its null rows."""
    if len(cols) > 63:
        # the bitmask would overflow: one class word per 63 columns
        parts: List[torch.Tensor] = []
        for start in range(0, len(cols), 63):
            parts.extend(group_key_arrays(cols[start:start + 63], row_mask))
        return parts
    cls_bits = torch.zeros(row_mask.shape[0], dtype=torch.int64,
                           device=row_mask.device)
    words = []
    for i, col in enumerate(cols):
        if col.validity is None:
            words.append(equality_word(col))
            continue
        is_null = ~col.validity
        cls_bits = cls_bits | (is_null.to(torch.int64) << i)
        words.append(torch.where(is_null, 0, equality_word(col)))
    cls_bits = torch.where(row_mask, cls_bits, GROUP_KEY_DEAD)
    return [cls_bits] + words


def order_word(col: DeviceColumn) -> torch.Tensor:
    """int64 word whose order equals the value order (nulls and NaN are
    left to the class)."""
    name = col.value_dtype
    v = dtypes.load(col.values, name)
    if dtypes.is_unsigned(name):
        return v.to(torch.int64) ^ INT64_MIN
    if not dtypes.is_float(name):
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
