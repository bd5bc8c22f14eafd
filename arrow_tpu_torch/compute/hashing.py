"""Vectorized 32-bit key hashing (counterpart of
``arrow_tpu/compute/hashing.py``).

The reference's Hashing32 (``compute/key_hash_internal.h``): xxhash32
primes, the avalanche finalizer and the multi-column combiner
``prev ^ (hash + 0x9e3779b9 + (prev << 6) + (prev >> 2))``. The hash of a
row's words is ``kernels.hash32.hash32``, the hash kernel on a CUDA tensor;
its plain version is built from the steps here.

``column_words`` splits a column's stored values into the uint32 words the
reference hashes (``arrow_tpu/compute/hashing.py``), following each
type's value: a value of up to 32 bits is one word, sign-extended for the
signed integers and zero-extended for the unsigned ones (uint16 and
uint32 are stored as signed bits here), f16 through f32, an f32 by its
raw bits; a 64-bit value is its low word then its high word, an f64 by
its bits with every NaN one quiet NaN (-0.0 keeps its own bits). A
dictionary column hashes its int32 codes. A null row hashes the value
stored under it, as in the reference.

torch has no uint32 arithmetic: the steps carry each uint32 in an int64 and
mask with ``& 0xFFFFFFFF`` after every multiply and shift, so ``h >> s`` on
the non-negative int64 is the logical shift. Words are int32 tensors
holding uint32 bit patterns.
"""

from __future__ import annotations

from typing import List

import torch

from .. import dtypes
from .. import types as T
from ..device.column import DeviceColumn
from .keys import f64_bits
from .registry import register

MASK32 = 0xFFFFFFFF

PRIME32_2 = 2246822519
PRIME32_3 = 3266489917
PRIME32_4 = 668265263
PRIME32_5 = 374761393
GOLDEN = 0x9E3779B9


def as_u32(bits: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> their uint32 values in int64."""
    return bits.to(torch.int64) & MASK32


def as_bits(u: torch.Tensor) -> torch.Tensor:
    """uint32 values in int64 -> int32 bit patterns."""
    return torch.where(u >= 1 << 31, u - (1 << 32), u).to(torch.int32)


def avalanche(h: torch.Tensor) -> torch.Tensor:
    """xxhash32's finalizer on uint32 values carried in int64."""
    h = h ^ (h >> 15)
    h = (h * PRIME32_2) & MASK32
    h = h ^ (h >> 13)
    h = (h * PRIME32_3) & MASK32
    return h ^ (h >> 16)


def hash_u32_word(w: torch.Tensor) -> torch.Tensor:
    h = (PRIME32_5 + 4 + w * PRIME32_3) & MASK32
    h = ((((h << 17) & MASK32) | (h >> 15)) * PRIME32_4) & MASK32
    return avalanche(h)


def combine(prev: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """The Hashing32 combiner (key_hash_internal.h CombineHashesImp)."""
    return prev ^ ((h + GOLDEN + ((prev << 6) & MASK32) + (prev >> 2))
                   & MASK32)


def int64_halves(w: torch.Tensor) -> List[torch.Tensor]:
    """The low and high uint32 words of int64 values, as strided int32
    views (no copy)."""
    bits = w.contiguous().view(torch.int32)
    return [bits[0::2], bits[1::2]]


def column_words(col: DeviceColumn) -> List[torch.Tensor]:
    """A column's values as int32 planes of uint32 words: one for a value
    of up to 32 bits, the (low, high) halves of a 64-bit one as strided
    views of its storage."""
    name = col.value_dtype
    v = col.values
    if name == "float64":
        return int64_halves(f64_bits(v))
    if v.element_size() == 8:
        return int64_halves(v)
    if dtypes.is_float(name):
        return [v.to(torch.float32).view(torch.int32)]
    if name == "uint32":
        return [v]
    # bool 0 or 1, uint8 and uint16 zero-extended, the rest sign-extended
    return [dtypes.load(v, name).to(torch.int32)]


def hash_columns(cols) -> torch.Tensor:
    """The hash of each row's words over ``cols`` (at most
    ``kernels.hash32.MAX_WORDS`` words), as int32 bits of the uint32
    hash: the hash kernel on a CUDA tensor."""
    from ..kernels.hash32 import hash32
    words: List[torch.Tensor] = []
    for c in cols:
        words.extend(column_words(c))
    return hash32(words)


@register("hash32", "elementwise")
def hash32_function(ctx, col: DeviceColumn) -> DeviceColumn:
    """xxhash32 of one column (the reference's Hashing32): uint32, stored
    as int32 bits, with the column's validity."""
    return DeviceColumn(hash_columns([col]), col.validity, T.uint32())
