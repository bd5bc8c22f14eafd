"""Physical array representation (counterpart of ``arrow_tpu/array/data.py``;
reference: cpp/src/arrow/array/data.h:85 ``ArrayData``): a type, a length,
a null count, an offset, a list of buffers, child ArrayData and an optional
dictionary. Buffer positions by type follow the Arrow columnar format, as
the reference's do:

  NA                      []
  BOOL                    [validity_bitmap, data_bitmap]
  fixed-width primitives  [validity_bitmap, data]
  STRING/BINARY           [validity_bitmap, offsets_i32, data]
  LARGE_STRING/BINARY     [validity_bitmap, offsets_i64, data]
  FIXED_SIZE_BINARY/DEC   [validity_bitmap, data]
  LIST / MAP              [validity_bitmap, offsets_i32] + child
  LARGE_LIST              [validity_bitmap, offsets_i64] + child
  FIXED_SIZE_LIST         [validity_bitmap] + child
  STRUCT                  [validity_bitmap] + children
  SPARSE_UNION            [type_ids_i8] + children
  DENSE_UNION             [type_ids_i8, offsets_i32] + children
  STRING_VIEW/BINARY_VIEW [validity_bitmap, views_16B, data...]
  LIST_VIEW               [validity_bitmap, offsets_i32, sizes_i32] + child
  LARGE_LIST_VIEW         [validity_bitmap, offsets_i64, sizes_i64] + child
  DICTIONARY              [validity_bitmap, indices_data] (+ .dictionary)
  INTERVAL_DAY_TIME       [validity_bitmap, (days i32, ms i32) pairs]
  INTERVAL_MONTH_DAY_NANO [validity_bitmap, (months i32, days i32, ns i64)]
  RUN_END_ENCODED         [] + children [run_ends, values]

An ArrayData can be held weakly (``compute/device_nested.py`` keeps a list
column's device form by it).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..buffer import Buffer
from ..types import DataType, TypeId
from ..utils import bits as bitutil

UNKNOWN_NULL_COUNT = -1

_FIXED_BYTES = (TypeId.FIXED_SIZE_BINARY, TypeId.DECIMAL128,
                TypeId.DECIMAL256, TypeId.DECIMAL32, TypeId.DECIMAL64)
# the layouts without a validity bitmap: a union's nulls are its
# children's, a run-end encoded array's its values'
_NO_VALIDITY = (TypeId.SPARSE_UNION, TypeId.DENSE_UNION,
                TypeId.RUN_END_ENCODED)


class ArrayData:
    __slots__ = ("type", "length", "_null_count", "offset", "buffers",
                 "children", "dictionary", "__weakref__")

    def __init__(self, type: DataType, length: int,
                 buffers: Sequence[Optional[Buffer]],
                 children: Sequence["ArrayData"] = (),
                 null_count: int = UNKNOWN_NULL_COUNT,
                 offset: int = 0,
                 dictionary: Optional["ArrayData"] = None):
        self.type = type
        self.length = int(length)
        self._null_count = int(null_count)
        self.offset = int(offset)
        self.buffers: List[Optional[Buffer]] = list(buffers)
        self.children: List[ArrayData] = list(children)
        self.dictionary = dictionary

    @property
    def null_count(self) -> int:
        if self._null_count == UNKNOWN_NULL_COUNT:
            if self.type.id == TypeId.NA:
                self._null_count = self.length
            elif self.buffers and self.buffers[0] is not None \
                    and self.type.id not in _NO_VALIDITY:
                valid = bitutil.count_set_bits(
                    self.buffers[0].to_numpy(), self.length, self.offset)
                self._null_count = self.length - valid
            else:
                self._null_count = 0
        return self._null_count

    def validity_mask(self) -> Optional[np.ndarray]:
        """bool[length] (True = valid), or None when every row is valid."""
        if self.type.id == TypeId.NA:
            return np.zeros(self.length, dtype=np.bool_)
        if not self.buffers or self.buffers[0] is None \
                or self.type.id in _NO_VALIDITY:
            return None
        return bitutil.unpack_bits(self.buffers[0].to_numpy(),
                                   self.length, self.offset)

    def values(self) -> np.ndarray:
        """The typed view of the data buffer, offset applied: fixed-width
        types (dictionary indices included); (length, byte_width) uint8
        rows for fixed-size binary and decimals."""
        t = self.type
        if len(self.buffers) < 2 or self.buffers[1] is None:
            if t.id == TypeId.BOOL:
                return np.zeros(self.length, dtype=np.bool_)
            if t.id in _FIXED_BYTES:
                return np.zeros((self.length, t.byte_width), dtype=np.uint8)
            dt = (t.index_type.to_numpy_dtype() if t.id == TypeId.DICTIONARY
                  else t.to_numpy_dtype())
            return np.zeros(self.length, dtype=dt)
        if t.id == TypeId.BOOL:
            return bitutil.unpack_bits(self.buffers[1].to_numpy(),
                                       self.length, self.offset)
        if t.id in _FIXED_BYTES:
            w = t.byte_width
            raw = self.buffers[1].to_numpy()
            start = self.offset * w
            return raw[start:start + self.length * w].reshape(self.length, w)
        dt = (t.index_type.to_numpy_dtype() if t.id == TypeId.DICTIONARY
              else t.to_numpy_dtype())
        return self.buffers[1].view(dt)[self.offset:self.offset + self.length]

    def offsets(self) -> np.ndarray:
        """The offsets of a variable-size binary or list type."""
        t = self.type
        if t.id in (TypeId.STRING, TypeId.BINARY, TypeId.LIST, TypeId.MAP):
            dt = np.int32
        elif t.id in (TypeId.LARGE_STRING, TypeId.LARGE_BINARY,
                      TypeId.LARGE_LIST):
            dt = np.int64
        else:
            raise ValueError(f"{t!r} has no offsets")
        if self.buffers[1] is None:
            return np.zeros(self.length + 1, dtype=dt)
        return self.buffers[1].view(dt)[self.offset:
                                        self.offset + self.length + 1]

    def data_bytes(self) -> np.ndarray:
        """The whole value buffer of a variable-size binary type."""
        if self.buffers[2] is None:
            return np.zeros(0, dtype=np.uint8)
        return self.buffers[2].to_numpy()

    def type_ids(self) -> np.ndarray:
        """A union's type codes a row, offset applied."""
        return self.buffers[0].view(np.int8)[self.offset:
                                             self.offset + self.length]

    def slice(self, offset: int, length: Optional[int] = None) -> "ArrayData":
        offset = min(offset, self.length)
        if length is None:
            length = self.length - offset
        length = min(length, self.length - offset)
        out = ArrayData(self.type, length, self.buffers, self.children,
                        UNKNOWN_NULL_COUNT, self.offset + offset,
                        self.dictionary)
        if self._null_count == 0:
            out._null_count = 0
        return out

    def copy(self) -> "ArrayData":
        return ArrayData(self.type, self.length, list(self.buffers),
                         list(self.children), self._null_count, self.offset,
                         self.dictionary)

    def __repr__(self):
        return (f"ArrayData({self.type!r}, length={self.length}, "
                f"nulls={self.null_count}, offset={self.offset})")
