"""Validity bitmaps (counterpart of ``arrow_tpu/utils/bits.py``; reference:
cpp/src/arrow/util/bit_util.h). Arrow packs validity LSB first (bit i of
byte i // 8); the device holds a bool tensor, and the boundary converts
with numpy's packbits/unpackbits, with no loop over the rows."""

from __future__ import annotations

import numpy as np


def pack_bits(mask: np.ndarray) -> np.ndarray:
    """bool[n] -> uint8[ceil(n / 8)], LSB first."""
    return np.packbits(np.asarray(mask, dtype=np.bool_), bitorder="little")


def unpack_bits(bitmap: np.ndarray, length: int, offset: int = 0) -> np.ndarray:
    """uint8[] -> bool[length], from bit ``offset``. Only the bytes that
    hold those bits are unpacked."""
    start = offset // 8
    stop = (offset + length + 7) // 8
    bits = np.unpackbits(np.asarray(bitmap, dtype=np.uint8)[start:stop],
                         bitorder="little")
    first = offset - start * 8
    return bits[first:first + length].view(np.bool_)


def count_set_bits(bitmap: np.ndarray, length: int, offset: int = 0) -> int:
    if length == 0:
        return 0
    return int(np.count_nonzero(unpack_bits(bitmap, length, offset)))


def bytes_for_bits(n: int) -> int:
    return (n + 7) // 8
