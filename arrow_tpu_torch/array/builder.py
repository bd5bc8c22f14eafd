"""Incremental array builders (counterpart of ``arrow_tpu/array/builder.py``;
reference: cpp/src/arrow/array/builder_base.h:97, builder_primitive.h,
builder_binary.h, builder_dict.h, builder_adaptive.h, builder_nested.h).
A builder keeps the Python values appended and makes its Array at
``finish()`` through ``array()``, so the bulk path builds the buffers."""

from __future__ import annotations

from typing import Any, Iterable, List, Optional

from .. import types as T
from ..types import DataType
from .array import Array, array as make_array


class ArrayBuilder:
    """Base incremental builder (reference: builder_base.h:97)."""

    def __init__(self, type: Optional[DataType] = None):
        self._type = type
        self._values: List[Any] = []

    @property
    def type(self) -> Optional[DataType]:
        return self._type

    def __len__(self) -> int:
        return len(self._values)

    @property
    def null_count(self) -> int:
        return sum(1 for v in self._values if v is None)

    def append(self, value) -> "ArrayBuilder":
        self._values.append(self._convert(value))
        return self

    def append_null(self) -> "ArrayBuilder":
        self._values.append(None)
        return self

    def append_nulls(self, n: int) -> "ArrayBuilder":
        self._values.extend([None] * n)
        return self

    def extend(self, values: Iterable) -> "ArrayBuilder":
        for v in values:
            if v is None:
                self.append_null()
            else:
                self.append(v)
        return self

    def reset(self) -> None:
        self._values = []

    def finish(self) -> Array:
        arr = make_array(self._values, self._resolved_type())
        self.reset()
        return arr

    # hooks -----------------------------------------------------------
    def _convert(self, v):
        return v

    def _resolved_type(self) -> Optional[DataType]:
        return self._type


class BooleanBuilder(ArrayBuilder):
    def __init__(self):
        super().__init__(T.bool_())

    def _convert(self, v):
        return None if v is None else bool(v)


class _FixedTypeBuilder(ArrayBuilder):
    _TYPE = None

    def __init__(self):
        super().__init__(self._TYPE)


def _primitive_builder(name, t):
    cls = type(name, (_FixedTypeBuilder,), {"_TYPE": t})
    return cls


Int8Builder = _primitive_builder("Int8Builder", T.int8())
Int16Builder = _primitive_builder("Int16Builder", T.int16())
Int32Builder = _primitive_builder("Int32Builder", T.int32())
Int64Builder = _primitive_builder("Int64Builder", T.int64())
UInt8Builder = _primitive_builder("UInt8Builder", T.uint8())
UInt16Builder = _primitive_builder("UInt16Builder", T.uint16())
UInt32Builder = _primitive_builder("UInt32Builder", T.uint32())
UInt64Builder = _primitive_builder("UInt64Builder", T.uint64())
FloatBuilder = _primitive_builder("FloatBuilder", T.float32())
DoubleBuilder = _primitive_builder("DoubleBuilder", T.float64())
Date32Builder = _primitive_builder("Date32Builder", T.date32())


class StringBuilder(ArrayBuilder):
    def __init__(self):
        super().__init__(T.string())

    def _convert(self, v):
        return v if isinstance(v, str) else (
            v.decode() if isinstance(v, bytes) else str(v))


class BinaryBuilder(ArrayBuilder):
    def __init__(self):
        super().__init__(T.binary())

    def _convert(self, v):
        return bytes(v)


class AdaptiveIntBuilder(ArrayBuilder):
    """Smallest signed int type that fits the appended values
    (reference: builder_adaptive.h AdaptiveIntBuilder)."""

    def __init__(self):
        super().__init__(None)

    def _convert(self, v):
        return int(v)

    def _resolved_type(self) -> DataType:
        lo = min((v for v in self._values if v is not None), default=0)
        hi = max((v for v in self._values if v is not None), default=0)
        for t, tlo, thi in ((T.int8(), -128, 127),
                            (T.int16(), -1 << 15, (1 << 15) - 1),
                            (T.int32(), -1 << 31, (1 << 31) - 1)):
            if lo >= tlo and hi <= thi:
                return t
        return T.int64()


class DictionaryBuilder(ArrayBuilder):
    """Dictionary-encoding builder (reference: builder_dict.h):
    accumulates values, emits a dictionary array with first-appearance
    value order."""

    def __init__(self, value_type: Optional[DataType] = None):
        super().__init__(None)
        self._value_type = value_type or T.string()

    def _resolved_type(self) -> DataType:
        return T.dictionary(T.int32(), self._value_type)


class ListBuilder(ArrayBuilder):
    """List builder driven by a child builder (builder_nested.h). Call
    `child.append(...)` then `append()` to close each list (or pass a
    whole list to `append`)."""

    def __init__(self, value_builder_or_type):
        if isinstance(value_builder_or_type, ArrayBuilder):
            self._child = value_builder_or_type
            vt = self._child.type or T.int64()
        else:
            self._child = None
            vt = value_builder_or_type
        super().__init__(T.list_(vt))
        self._pending: List[Any] = []

    @property
    def value_builder(self) -> Optional[ArrayBuilder]:
        return self._child

    def append(self, value=None) -> "ListBuilder":
        if value is not None:
            self._values.append(list(value))
            return self
        if self._child is not None:
            self._values.append(list(self._child._values))
            self._child.reset()
        else:
            self._values.append([])
        return self


class StructBuilder(ArrayBuilder):
    def __init__(self, fields):
        self._fields = [(n, t) for n, t in fields]
        super().__init__(T.struct(self._fields))

    def _convert(self, v):
        return dict(v)


def builder_for(t: DataType) -> ArrayBuilder:
    """Factory analogue of MakeBuilder (builder_base.h)."""
    from ..types import TypeId
    m = {TypeId.BOOL: BooleanBuilder, TypeId.INT8: Int8Builder,
         TypeId.INT16: Int16Builder, TypeId.INT32: Int32Builder,
         TypeId.INT64: Int64Builder, TypeId.UINT8: UInt8Builder,
         TypeId.UINT16: UInt16Builder, TypeId.UINT32: UInt32Builder,
         TypeId.UINT64: UInt64Builder, TypeId.FLOAT: FloatBuilder,
         TypeId.DOUBLE: DoubleBuilder, TypeId.STRING: StringBuilder,
         TypeId.BINARY: BinaryBuilder}
    if t.id in m:
        return m[t.id]()
    if t.id == TypeId.LIST:
        return ListBuilder(t.value_type)
    if t.id == TypeId.STRUCT:
        return StructBuilder([(f.name, f.type) for f in t.fields])
    b = ArrayBuilder(t)
    return b
