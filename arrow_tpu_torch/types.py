"""Logical types, fields and schemas: the reference's type set from
``arrow_tpu/types.py``, as far as a host Array or a device column holds it.
Type ids keep the reference's numbering.

The device holds bool, the eight integer widths, the three floats, date32
and date64, timestamps, time32 and time64, durations, month intervals, the
all-null type, decimals of up to 18 digits (as unscaled int64), strings
and binaries of both offset widths (as dictionary codes) and dictionaries.
Decimals wider than 18 digits and fixed-size binary ride as codes over a
value-sorted dictionary, and lists, large lists, fixed-size lists, structs
and maps as row ids over the host Array they came from
(``device.column.host_column_repr``). Day-time and month-day-nano
intervals and run-end encoded arrays are host types only, as in the
reference. The view types (``string_view``, ``binary_view``, ``list_view``,
``large_list_view``) and the unions are host types only, with the
reference's layouts (``array/data.py``); an extension type
(``extension.py``) is a host type over its storage type."""

from __future__ import annotations

import enum
from typing import List, Optional, Sequence

import numpy as np

class TypeId(enum.IntEnum):
    NA = 0
    BOOL = 1
    UINT8 = 2
    INT8 = 3
    UINT16 = 4
    INT16 = 5
    UINT32 = 6
    INT32 = 7
    UINT64 = 8
    INT64 = 9
    HALF_FLOAT = 10
    FLOAT = 11
    DOUBLE = 12
    STRING = 13
    BINARY = 14
    FIXED_SIZE_BINARY = 15
    DATE32 = 16
    DATE64 = 17
    TIMESTAMP = 18
    TIME32 = 19
    TIME64 = 20
    INTERVAL_MONTHS = 21
    INTERVAL_DAY_TIME = 22
    DECIMAL128 = 23
    LIST = 25
    STRUCT = 26
    DECIMAL256 = 24
    SPARSE_UNION = 27
    DENSE_UNION = 28
    DICTIONARY = 29
    MAP = 30
    EXTENSION = 31
    FIXED_SIZE_LIST = 32
    DURATION = 33
    LARGE_STRING = 34
    LARGE_BINARY = 35
    LARGE_LIST = 36
    INTERVAL_MONTH_DAY_NANO = 37
    RUN_END_ENCODED = 38
    STRING_VIEW = 39
    BINARY_VIEW = 40
    LIST_VIEW = 41
    LARGE_LIST_VIEW = 42
    DECIMAL32 = 43
    DECIMAL64 = 44


_SIGNED = (TypeId.INT8, TypeId.INT16, TypeId.INT32, TypeId.INT64)
_UNSIGNED = (TypeId.UINT8, TypeId.UINT16, TypeId.UINT32, TypeId.UINT64)
_FLOATS = (TypeId.HALF_FLOAT, TypeId.FLOAT, TypeId.DOUBLE)
_DECIMALS = (TypeId.DECIMAL32, TypeId.DECIMAL64, TypeId.DECIMAL128,
             TypeId.DECIMAL256)
_TEMPORAL = (TypeId.DATE32, TypeId.DATE64, TypeId.TIMESTAMP, TypeId.TIME32,
             TypeId.TIME64, TypeId.DURATION)

_NESTED = (TypeId.LIST, TypeId.LARGE_LIST, TypeId.FIXED_SIZE_LIST,
           TypeId.STRUCT, TypeId.MAP)

_NUMPY_DTYPES = {
    TypeId.BOOL: "bool", TypeId.INT8: "int8", TypeId.INT16: "int16",
    TypeId.INT32: "int32", TypeId.INT64: "int64", TypeId.UINT8: "uint8",
    TypeId.UINT16: "uint16", TypeId.UINT32: "uint32",
    TypeId.UINT64: "uint64", TypeId.HALF_FLOAT: "float16",
    TypeId.FLOAT: "float32", TypeId.DOUBLE: "float64",
    TypeId.DATE32: "int32", TypeId.DATE64: "int64",
    TypeId.TIMESTAMP: "int64", TypeId.TIME32: "int32",
    TypeId.TIME64: "int64", TypeId.DURATION: "int64",
    TypeId.INTERVAL_MONTHS: "int32"}

_BIT_WIDTHS = {
    TypeId.BOOL: 1, TypeId.INT8: 8, TypeId.UINT8: 8, TypeId.INT16: 16,
    TypeId.UINT16: 16, TypeId.INT32: 32, TypeId.UINT32: 32, TypeId.INT64: 64,
    TypeId.UINT64: 64, TypeId.HALF_FLOAT: 16, TypeId.FLOAT: 32,
    TypeId.DOUBLE: 64, TypeId.DATE32: 32, TypeId.DATE64: 64,
    TypeId.TIMESTAMP: 64, TypeId.TIME32: 32, TypeId.TIME64: 64,
    TypeId.DURATION: 64, TypeId.INTERVAL_MONTHS: 32,
    TypeId.INTERVAL_DAY_TIME: 64, TypeId.INTERVAL_MONTH_DAY_NANO: 128,
    TypeId.DECIMAL32: 32,
    TypeId.DECIMAL64: 64, TypeId.DECIMAL128: 128, TypeId.DECIMAL256: 256,
}


# Arrow's names of the type ids (DataType.name)
_ID_NAMES = {
    TypeId.NA: "null", TypeId.BOOL: "bool",
    TypeId.INT8: "int8", TypeId.INT16: "int16", TypeId.INT32: "int32",
    TypeId.INT64: "int64", TypeId.UINT8: "uint8", TypeId.UINT16: "uint16",
    TypeId.UINT32: "uint32", TypeId.UINT64: "uint64",
    TypeId.HALF_FLOAT: "halffloat", TypeId.FLOAT: "float",
    TypeId.DOUBLE: "double", TypeId.STRING: "string",
    TypeId.BINARY: "binary", TypeId.LARGE_STRING: "large_string",
    TypeId.LARGE_BINARY: "large_binary", TypeId.DATE32: "date32[day]",
    TypeId.DATE64: "date64[ms]", TypeId.INTERVAL_MONTHS: "month_interval",
    TypeId.INTERVAL_DAY_TIME: "day_time_interval",
    TypeId.INTERVAL_MONTH_DAY_NANO: "month_day_nano_interval",
    TypeId.STRING_VIEW: "string_view", TypeId.BINARY_VIEW: "binary_view",
}


class DataType:
    __slots__ = ("id", "index_type", "value_type")

    def __init__(self, id: TypeId, index_type: Optional["DataType"] = None,
                 value_type: Optional["DataType"] = None):
        self.id = id
        self.index_type = index_type
        self.value_type = value_type

    def _key(self):
        return (self.id, self.index_type, self.value_type)

    def __eq__(self, other):
        return isinstance(other, DataType) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    @property
    def is_integer(self) -> bool:
        return self.id in _SIGNED or self.id in _UNSIGNED

    @property
    def is_signed_integer(self) -> bool:
        return self.id in _SIGNED

    @property
    def is_unsigned_integer(self) -> bool:
        return self.id in _UNSIGNED

    @property
    def is_floating(self) -> bool:
        return self.id in _FLOATS

    @property
    def is_numeric(self) -> bool:
        """Integers and floats; decimals are not numeric, as in the
        reference."""
        return self.is_integer or self.is_floating

    @property
    def is_decimal(self) -> bool:
        return self.id in _DECIMALS

    @property
    def is_temporal(self) -> bool:
        """Dates, timestamps, times and durations (not intervals)."""
        return self.id in _TEMPORAL

    @property
    def is_nested(self) -> bool:
        return self.id in _NESTED

    @property
    def bit_width(self) -> int:
        if self.id in _BIT_WIDTHS:
            return _BIT_WIDTHS[self.id]
        if self.id == TypeId.DICTIONARY:
            return self.index_type.bit_width
        raise ValueError(f"{self!r} is not fixed-width")

    @property
    def byte_width(self) -> int:
        return self.bit_width // 8

    def to_numpy_dtype(self) -> np.dtype:
        """The numpy dtype of a host Array's value buffer."""
        if self.id in _NUMPY_DTYPES:
            return np.dtype(_NUMPY_DTYPES[self.id])
        raise ValueError(f"no 1:1 numpy dtype for {self!r}")

    def equals(self, other: "DataType") -> bool:
        return self == other

    def to_pandas_dtype(self):
        """The numpy scalar type pandas holds the type in (pyarrow
        to_pandas_dtype): datetime64/timedelta64 of the unit for
        timestamps and durations, object where there is no numpy type."""
        if self.id == TypeId.TIMESTAMP:
            return np.dtype(f"datetime64[{self.unit}]").type
        if self.id == TypeId.DURATION:
            return np.dtype(f"timedelta64[{self.unit}]").type
        if self.id in _NUMPY_DTYPES:
            return np.dtype(_NUMPY_DTYPES[self.id]).type
        return np.object_

    @property
    def fields(self):
        return ()

    @property
    def num_fields(self) -> int:
        return len(self.fields)

    def field(self, i: int) -> "Field":
        """The ``i``-th child field (pyarrow DataType.field)."""
        return self.fields[i]

    @property
    def num_buffers(self) -> int:
        """The buffers of the type's layout in the columnar format."""
        tid = self.id
        if tid == TypeId.NA:
            return 0
        if tid in (TypeId.STRUCT, TypeId.SPARSE_UNION,
                   TypeId.RUN_END_ENCODED, TypeId.FIXED_SIZE_LIST):
            return 1
        if tid in (TypeId.STRING, TypeId.BINARY, TypeId.LARGE_STRING,
                   TypeId.LARGE_BINARY, TypeId.LIST_VIEW,
                   TypeId.LARGE_LIST_VIEW):
            return 3
        return 2

    @property
    def has_variadic_buffers(self) -> bool:
        return self.id in (TypeId.STRING_VIEW, TypeId.BINARY_VIEW)

    @property
    def name(self) -> str:
        """Arrow's name of the type id (``double``, ``halffloat``: the
        reference's, where the port's ``repr`` writes ``float64``)."""
        return _ID_NAMES.get(self.id, self.id.name.lower())

    @property
    def is_primitive(self) -> bool:
        """A fixed-width value buffer and no child arrays."""
        return self.id in _BIT_WIDTHS or self.id == TypeId.FIXED_SIZE_BINARY

    @property
    def is_binary_like(self) -> bool:
        return self.id in (TypeId.STRING, TypeId.BINARY)

    @property
    def is_binary_view_like(self) -> bool:
        return self.id in (TypeId.STRING_VIEW, TypeId.BINARY_VIEW)

    @property
    def is_large_binary_like(self) -> bool:
        return self.id in (TypeId.LARGE_STRING, TypeId.LARGE_BINARY)

    def __repr__(self):
        if self.id == TypeId.DICTIONARY:
            return f"dictionary<{self.index_type!r}, {self.value_type!r}>"
        return _NAMES[self.id]


class DecimalType(DataType):
    """A decimal of ``precision`` digits, ``scale`` of them after the
    point; on the device its unscaled value as int64 (precision <= 18)."""
    __slots__ = ("precision", "scale")

    def __init__(self, precision: int, scale: int, type_id: TypeId):
        super().__init__(type_id)
        self.precision = int(precision)
        self.scale = int(scale)

    def _key(self):
        return (self.id, self.precision, self.scale)

    @property
    def byte_width(self) -> int:
        return _BIT_WIDTHS[self.id] // 8

    def __repr__(self):
        bits = {TypeId.DECIMAL32: 32, TypeId.DECIMAL64: 64,
                TypeId.DECIMAL128: 128, TypeId.DECIMAL256: 256}[self.id]
        return f"decimal{bits}({self.precision}, {self.scale})"


_UNITS = ("s", "ms", "us", "ns")


class TimestampType(DataType):
    __slots__ = ("unit", "tz")

    def __init__(self, unit: str = "us", tz: Optional[str] = None):
        if unit not in _UNITS:
            raise ValueError(f"bad unit {unit!r}")
        super().__init__(TypeId.TIMESTAMP)
        self.unit = unit
        self.tz = tz

    def _key(self):
        return (self.id, self.unit, self.tz)

    def __repr__(self):
        return f"timestamp[{self.unit}]" + (f", tz={self.tz}" if self.tz
                                            else "")


class TimeType(DataType):
    """time32 (``s`` or ``ms``) or time64 (``us`` or ``ns``)."""
    __slots__ = ("unit",)

    def __init__(self, type_id: TypeId, unit: str):
        valid = ("s", "ms") if type_id == TypeId.TIME32 else ("us", "ns")
        if unit not in valid:
            raise ValueError(f"bad unit {unit!r} for {type_id.name}")
        super().__init__(type_id)
        self.unit = unit

    def _key(self):
        return (self.id, self.unit)

    def __repr__(self):
        return f"time{32 if self.id == TypeId.TIME32 else 64}[{self.unit}]"


class DurationType(DataType):
    __slots__ = ("unit",)

    def __init__(self, unit: str = "us"):
        if unit not in _UNITS:
            raise ValueError(f"bad unit {unit!r}")
        super().__init__(TypeId.DURATION)
        self.unit = unit

    def _key(self):
        return (self.id, self.unit)

    def __repr__(self):
        return f"duration[{self.unit}]"


class FixedSizeBinaryType(DataType):
    __slots__ = ("byte_width_",)

    def __init__(self, byte_width: int):
        super().__init__(TypeId.FIXED_SIZE_BINARY)
        self.byte_width_ = int(byte_width)

    @property
    def bit_width(self) -> int:
        return self.byte_width_ * 8

    @property
    def byte_width(self) -> int:
        return self.byte_width_

    def _key(self):
        return (self.id, self.byte_width_)

    def __repr__(self):
        return f"fixed_size_binary[{self.byte_width_}]"


class StructType(DataType):
    """A struct of named fields (also the type of an aggregate result with
    one value a field)."""
    __slots__ = ("fields_",)

    def __init__(self, fields: Sequence["Field"]):
        super().__init__(TypeId.STRUCT)
        self.fields_ = tuple(fields)

    @property
    def fields(self):
        return self.fields_

    def get_field_index(self, name: str) -> int:
        for i, f in enumerate(self.fields_):
            if f.name == name:
                return i
        return -1

    def _key(self):
        return (self.id, tuple((f.name, f.type, f.nullable)
                               for f in self.fields_))

    def __repr__(self):
        return "struct<" + ", ".join(f"{f.name}: {f.type!r}"
                                     for f in self.fields_) + ">"


class ListType(DataType):
    """A list (or large list, or map) of one value type; ``value_type`` is
    its items' type."""
    __slots__ = ("value_field",)

    def __init__(self, value_type, type_id: TypeId = TypeId.LIST):
        vf = value_type if isinstance(value_type, Field) \
            else Field("item", value_type)
        super().__init__(type_id, None, vf.type)
        self.value_field = vf

    @property
    def fields(self):
        return (self.value_field,)

    def _key(self):
        return (self.id, self.value_field.name, self.value_field.type)

    def __repr__(self):
        base = {TypeId.LIST: "list", TypeId.LARGE_LIST: "large_list",
                TypeId.LIST_VIEW: "list_view",
                TypeId.LARGE_LIST_VIEW: "large_list_view"}[self.id]
        return f"{base}<{self.value_field.type!r}>"


class MapType(ListType):
    """A list of ``entries`` structs of a non-null key and a value."""
    __slots__ = ()

    def __init__(self, key_type: DataType, item_type: DataType):
        super().__init__(Field("entries", StructType([
            Field("key", key_type, nullable=False),
            Field("value", item_type)]), nullable=False), TypeId.MAP)

    @property
    def key_type(self) -> DataType:
        return self.value_type.fields[0].type

    @property
    def item_type(self) -> DataType:
        return self.value_type.fields[1].type

    def __repr__(self):
        return f"map<{self.key_type!r}, {self.item_type!r}>"


class FixedSizeListType(DataType):
    __slots__ = ("value_field", "list_size")

    def __init__(self, value_type, list_size: int):
        vf = value_type if isinstance(value_type, Field) \
            else Field("item", value_type)
        super().__init__(TypeId.FIXED_SIZE_LIST, None, vf.type)
        self.value_field = vf
        self.list_size = int(list_size)

    @property
    def fields(self):
        return (self.value_field,)

    def _key(self):
        return (self.id, self.value_field.name, self.value_field.type,
                self.list_size)

    def __repr__(self):
        return f"fixed_size_list<{self.value_type!r}>[{self.list_size}]"


class RunEndEncodedType(DataType):
    """Run-end encoding: int16/32/64 run ends (one past each run's last
    logical row) over a child of values, one a run."""
    __slots__ = ("run_end_type",)

    def __init__(self, run_end_type: DataType, value_type: DataType):
        if run_end_type.id not in (TypeId.INT16, TypeId.INT32, TypeId.INT64):
            raise ValueError("run ends must be int16/int32/int64")
        super().__init__(TypeId.RUN_END_ENCODED, None, value_type)
        self.run_end_type = run_end_type

    @property
    def fields(self):
        return (Field("run_ends", self.run_end_type, nullable=False),
                Field("values", self.value_type))

    def _key(self):
        return (self.id, self.run_end_type, self.value_type)

    def __repr__(self):
        return (f"run_end_encoded<{self.run_end_type!r}, "
                f"{self.value_type!r}>")


class DictionaryType(DataType):
    """Codes into a dictionary of values; ``ordered`` says the values'
    order is meaningful. An unordered one keys as the plain type."""
    __slots__ = ("ordered",)

    def __init__(self, index_type: DataType, value_type: DataType,
                 ordered: bool = False):
        if not index_type.is_integer:
            raise ValueError("dictionary indices must be integer")
        super().__init__(TypeId.DICTIONARY, index_type, value_type)
        self.ordered = bool(ordered)

    def _key(self):
        return super()._key() + ((True,) if self.ordered else ())


class UnionType(DataType):
    """A sparse or dense union of child fields, one type code each."""
    __slots__ = ("fields_", "type_codes")

    def __init__(self, fields: Sequence["Field"], type_codes: Sequence[int],
                 mode: str):
        super().__init__(TypeId.SPARSE_UNION if mode == "sparse"
                         else TypeId.DENSE_UNION)
        self.fields_ = tuple(fields)
        self.type_codes = tuple(int(c) for c in type_codes)

    @property
    def mode(self) -> str:
        return "sparse" if self.id == TypeId.SPARSE_UNION else "dense"

    @property
    def fields(self):
        return self.fields_

    def _key(self):
        return (self.id, tuple((f.name, f.type, f.nullable)
                               for f in self.fields_), self.type_codes)

    def __repr__(self):
        return f"{self.mode}_union<" + ", ".join(
            f"{f.name}: {f.type!r}" for f in self.fields_) + ">"


_NAMES = {TypeId.NA: "null", TypeId.BOOL: "bool", TypeId.INT8: "int8",
          TypeId.INT16: "int16", TypeId.INT32: "int32", TypeId.INT64: "int64",
          TypeId.UINT8: "uint8", TypeId.UINT16: "uint16",
          TypeId.UINT32: "uint32", TypeId.UINT64: "uint64",
          TypeId.HALF_FLOAT: "float16", TypeId.FLOAT: "float32",
          TypeId.DOUBLE: "float64", TypeId.STRING: "string",
          TypeId.BINARY: "binary", TypeId.LARGE_STRING: "large_string",
          TypeId.LARGE_BINARY: "large_binary",
          TypeId.DATE32: "date32", TypeId.DATE64: "date64",
          TypeId.INTERVAL_MONTHS: "month_interval",
          TypeId.INTERVAL_DAY_TIME: "day_time_interval",
          TypeId.INTERVAL_MONTH_DAY_NANO: "month_day_nano_interval",
          TypeId.STRING_VIEW: "string_view", TypeId.BINARY_VIEW: "binary_view"}


def null() -> DataType:
    return DataType(TypeId.NA)


def bool_() -> DataType:
    return DataType(TypeId.BOOL)


def int8() -> DataType:
    return DataType(TypeId.INT8)


def int16() -> DataType:
    return DataType(TypeId.INT16)


def int32() -> DataType:
    return DataType(TypeId.INT32)


def int64() -> DataType:
    return DataType(TypeId.INT64)


def uint8() -> DataType:
    return DataType(TypeId.UINT8)


def uint16() -> DataType:
    return DataType(TypeId.UINT16)


def uint32() -> DataType:
    return DataType(TypeId.UINT32)


def uint64() -> DataType:
    return DataType(TypeId.UINT64)


def float16() -> DataType:
    return DataType(TypeId.HALF_FLOAT)


def float32() -> DataType:
    return DataType(TypeId.FLOAT)


def float64() -> DataType:
    return DataType(TypeId.DOUBLE)


def string() -> DataType:
    return DataType(TypeId.STRING)


def binary() -> DataType:
    return DataType(TypeId.BINARY)


def large_string() -> DataType:
    return DataType(TypeId.LARGE_STRING)


def large_binary() -> DataType:
    return DataType(TypeId.LARGE_BINARY)


def fixed_size_binary(byte_width: int) -> FixedSizeBinaryType:
    return FixedSizeBinaryType(byte_width)


def date32() -> DataType:
    return DataType(TypeId.DATE32)


def date64() -> DataType:
    return DataType(TypeId.DATE64)


def month_interval() -> DataType:
    return DataType(TypeId.INTERVAL_MONTHS)


def day_time_interval() -> DataType:
    """(days, milliseconds) pairs of int32."""
    return DataType(TypeId.INTERVAL_DAY_TIME)


def month_day_nano_interval() -> DataType:
    """(months int32, days int32, nanoseconds int64) records."""
    return DataType(TypeId.INTERVAL_MONTH_DAY_NANO)


def run_end_encoded(run_end_type: DataType,
                    value_type: DataType) -> RunEndEncodedType:
    return RunEndEncodedType(run_end_type, value_type)


def timestamp(unit: str = "us", tz: Optional[str] = None) -> TimestampType:
    return TimestampType(unit, tz)


def time32(unit: str = "ms") -> TimeType:
    return TimeType(TypeId.TIME32, unit)


def time64(unit: str = "us") -> TimeType:
    return TimeType(TypeId.TIME64, unit)


def duration(unit: str = "us") -> DurationType:
    return DurationType(unit)


def decimal32(precision: int, scale: int = 0) -> DecimalType:
    return DecimalType(precision, scale, TypeId.DECIMAL32)


def decimal64(precision: int, scale: int = 0) -> DecimalType:
    return DecimalType(precision, scale, TypeId.DECIMAL64)


def decimal128(precision: int, scale: int = 0) -> DecimalType:
    return DecimalType(precision, scale, TypeId.DECIMAL128)


def decimal256(precision: int, scale: int = 0) -> DecimalType:
    return DecimalType(precision, scale, TypeId.DECIMAL256)


def dictionary(index_type: DataType, value_type: DataType,
               ordered: bool = False) -> DictionaryType:
    return DictionaryType(index_type, value_type, ordered)


def _fields(fields) -> List["Field"]:
    """``Field``s from Fields, (name, type) pairs or a name -> type
    mapping."""
    if isinstance(fields, dict):
        return [Field(k, v) for k, v in fields.items()]
    return [f if isinstance(f, Field) else Field(f[0], f[1])
            for f in fields]


def struct(fields) -> StructType:
    """From ``Field``s, (name, type) pairs or a name -> type mapping."""
    return StructType(_fields(fields))


def list_(value_type) -> ListType:
    return ListType(value_type)


def large_list(value_type) -> ListType:
    return ListType(value_type, TypeId.LARGE_LIST)


def fixed_size_list(value_type, list_size: int) -> FixedSizeListType:
    return FixedSizeListType(value_type, list_size)


def map_(key_type: DataType, item_type: DataType) -> MapType:
    return MapType(key_type, item_type)


def string_view() -> DataType:
    return DataType(TypeId.STRING_VIEW)


def binary_view() -> DataType:
    return DataType(TypeId.BINARY_VIEW)


def list_view(value_type) -> ListType:
    return ListType(value_type, TypeId.LIST_VIEW)


def large_list_view(value_type) -> ListType:
    return ListType(value_type, TypeId.LARGE_LIST_VIEW)


def sparse_union(fields: Sequence["Field"],
                 type_codes: Optional[Sequence[int]] = None) -> UnionType:
    return UnionType(fields, range(len(fields)) if type_codes is None
                     else type_codes, "sparse")


def dense_union(fields: Sequence["Field"],
                type_codes: Optional[Sequence[int]] = None) -> UnionType:
    return UnionType(fields, range(len(fields)) if type_codes is None
                     else type_codes, "dense")


utf8 = string
large_utf8 = large_string


def from_numpy_dtype(dtype) -> DataType:
    """The type of a numpy dtype (the reference's ``from_numpy_dtype``):
    datetime64/timedelta64 as timestamps/durations of their unit, str as
    string and bytes as binary."""
    dtype = np.dtype(dtype)
    if dtype.kind == "M":
        return timestamp(np.datetime_data(dtype)[0])
    if dtype.kind == "m":
        return duration(np.datetime_data(dtype)[0])
    if dtype.kind in "UO":
        return string()
    if dtype.kind == "S":
        return binary()
    return type_for_name(dtype.name)


_ALIASES = {"boolean": "bool", "i1": "int8", "i2": "int16", "i4": "int32",
            "i8": "int64", "u1": "uint8", "u2": "uint16", "u4": "uint32",
            "u8": "uint64", "f2": "float16", "halffloat": "float16",
            "f4": "float32", "float": "float32", "f8": "float64",
            "double": "float64", "str": "string", "utf8": "string",
            "date32[day]": "date32", "date64[ms]": "date64"}


def type_for_name(name: str) -> DataType:
    """A type by its name or pyarrow alias: ``"int8"`` ... ``"uint64"``,
    ``"float16"``/``"float32"``/``"float64"``, ``"bool"``, ``"null"``,
    ``"date32"``, ``"date64"``, ``"timestamp[s]"`` (``[ms]``, ``[us]``,
    ``[ns]``), ``"time32[s]"``/``"time32[ms]"``,
    ``"time64[us]"``/``"time64[ns]"``, ``"duration[ms]"`` and the like,
    ``"month_interval"``, ``"decimal128(12, 2)"`` (also ``decimal32``,
    ``decimal64``, ``decimal256``), ``"string"`` or ``"dictionary"`` (int32
    codes of strings)."""
    name = _ALIASES.get(name, name)
    if name == "dictionary":
        return dictionary(int32(), string())
    for tid, n in _NAMES.items():
        if n == name:
            return DataType(tid)
    for prefix, make in (("timestamp[", timestamp), ("time32[", time32),
                         ("time64[", time64), ("duration[", duration)):
        if name.startswith(prefix) and name.endswith("]"):
            return make(name[len(prefix):-1])
    for prefix, make in (("decimal32(", decimal32),
                         ("decimal64(", decimal64),
                         ("decimal128(", decimal128),
                         ("decimal256(", decimal256)):
        if name.startswith(prefix) and name.endswith(")"):
            p, _, s = name[len(prefix):-1].partition(",")
            return make(int(p), int(s or 0))
    if name.startswith("fixed_size_binary[") and name.endswith("]"):
        return fixed_size_binary(int(name[len("fixed_size_binary["):-1]))
    raise NotImplementedError(f"no port type named {name!r}")


def _norm_metadata(md) -> Optional[dict]:
    """Key-value metadata as bytes to bytes (the reference's form)."""
    if md is None:
        return None
    return {(k.encode() if isinstance(k, str) else bytes(k)):
            (v.encode() if isinstance(v, str) else bytes(v))
            for k, v in md.items()}


class Field:
    __slots__ = ("name", "type", "nullable", "metadata")

    def __init__(self, name: str, type: DataType, nullable: bool = True,
                 metadata=None):
        self.name = name
        self.type = type
        self.nullable = bool(nullable)
        self.metadata = _norm_metadata(metadata)

    def _key(self):
        return (self.name, self.type, self.nullable,
                tuple(sorted(self.metadata.items())) if self.metadata
                else ())

    def __eq__(self, other):
        return isinstance(other, Field) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def equals(self, other: "Field") -> bool:
        return self == other

    def with_name(self, name: str) -> "Field":
        return Field(name, self.type, self.nullable, self.metadata)

    def with_type(self, type: DataType) -> "Field":
        return Field(self.name, type, self.nullable, self.metadata)

    def with_nullable(self, nullable: bool) -> "Field":
        return Field(self.name, self.type, nullable, self.metadata)

    def with_metadata(self, metadata) -> "Field":
        return Field(self.name, self.type, self.nullable, metadata)

    def remove_metadata(self) -> "Field":
        return Field(self.name, self.type, self.nullable)

    def flatten(self) -> List["Field"]:
        """A struct field's children, named ``parent.child``; else this
        field."""
        if self.type.id == TypeId.STRUCT:
            return [Field(f"{self.name}.{c.name}", c.type, True, c.metadata)
                    for c in self.type.fields]
        return [self]

    def __repr__(self):
        return f"Field({self.name}: {self.type!r})"


class Schema:
    __slots__ = ("fields", "metadata")

    def __init__(self, fields: Sequence[Field], metadata=None):
        self.fields = list(fields)
        self.metadata = _norm_metadata(metadata)

    @property
    def names(self) -> List[str]:
        return [f.name for f in self.fields]

    @property
    def types(self) -> List[DataType]:
        return [f.type for f in self.fields]

    def get_field_index(self, name: str) -> int:
        names = self.names
        return names.index(name) if name in names else -1

    def field(self, i) -> Field:
        return self.fields[self.get_field_index(i) if isinstance(i, str)
                           else i]

    def __len__(self) -> int:
        return len(self.fields)

    def __getitem__(self, i) -> Field:
        return self.field(i)

    def __iter__(self):
        return iter(self.fields)

    def append(self, f: Field) -> "Schema":
        """This schema with ``f`` after its fields."""
        return Schema(self.fields + [f], self.metadata)

    def insert(self, i: int, f: Field) -> "Schema":
        fields = list(self.fields)
        fields.insert(i, f)
        return Schema(fields, self.metadata)

    def remove(self, i: int) -> "Schema":
        return Schema(self.fields[:i] + self.fields[i + 1:], self.metadata)

    def set(self, i: int, f: Field) -> "Schema":
        return Schema(self.fields[:i] + [f] + self.fields[i + 1:],
                      self.metadata)

    def with_metadata(self, metadata) -> "Schema":
        return Schema(self.fields, metadata)

    def remove_metadata(self) -> "Schema":
        return Schema(self.fields)

    def field_by_name(self, name: str) -> Optional[Field]:
        i = self.get_field_index(name)
        return self.fields[i] if i >= 0 else None

    def get_all_field_indices(self, name: str) -> List[int]:
        return [i for i, f in enumerate(self.fields) if f.name == name]

    def empty_table(self):
        from .table import Table
        return Table.from_batches([], self)

    def equals(self, other: "Schema") -> bool:
        """Names, types and nullability alike (the metadata is not
        compared, as in the reference's default)."""
        return isinstance(other, Schema) and self.fields == other.fields

    def __eq__(self, other):
        return self.equals(other)

    __hash__ = None

    add_metadata = with_metadata  # pyarrow's older name

    def to_string(self, truncate_metadata: bool = True,
                  show_field_metadata: bool = True,
                  show_schema_metadata: bool = True) -> str:
        return repr(self)

    @property
    def pandas_metadata(self):
        """The ``pandas`` metadata key read as JSON, or None."""
        import json
        raw = (self.metadata or {}).get(b"pandas")
        return json.loads(raw) if raw else None

    @classmethod
    def from_pandas(cls, df, preserve_index: bool = True) -> "Schema":
        """The schema ``Table.from_pandas(df)`` gives (needs pandas)."""
        from .table import Table
        return Table.from_pandas(df).schema

    def serialize(self, memory_pool=None):
        """The schema as an IPC stream of no batches (ipc/writer.h
        SerializeSchema), in a Buffer."""
        import io
        from . import ipc
        from .buffer import Buffer
        sink = io.BytesIO()
        ipc.new_stream(sink, self).close()
        return Buffer(sink.getvalue())

    def __repr__(self):
        inner = "\n".join(f"{f.name}: {f.type!r}" for f in self.fields)
        return f"Schema:\n{inner}"


def field(name: str, type: DataType, nullable: bool = True,
          metadata=None) -> Field:
    return Field(name, type, nullable, metadata)


def schema(fields, metadata=None) -> Schema:
    """From a Schema, ``Field``s, (name, type) pairs or a name -> type
    mapping."""
    if isinstance(fields, Schema):
        return fields
    return Schema(_fields(fields), metadata)


# --- type predicates (pyarrow.types.is_*) ------------------------------------

def _id_pred(*ids):
    idset = frozenset(ids)

    def pred(t) -> bool:
        return getattr(t, "id", None) in idset
    return pred


is_null = _id_pred(TypeId.NA)
is_boolean = _id_pred(TypeId.BOOL)
is_int8 = _id_pred(TypeId.INT8)
is_int16 = _id_pred(TypeId.INT16)
is_int32 = _id_pred(TypeId.INT32)
is_int64 = _id_pred(TypeId.INT64)
is_uint8 = _id_pred(TypeId.UINT8)
is_uint16 = _id_pred(TypeId.UINT16)
is_uint32 = _id_pred(TypeId.UINT32)
is_uint64 = _id_pred(TypeId.UINT64)
is_float16 = _id_pred(TypeId.HALF_FLOAT)
is_float32 = _id_pred(TypeId.FLOAT)
is_float64 = _id_pred(TypeId.DOUBLE)
is_signed_integer = _id_pred(*_SIGNED)
is_unsigned_integer = _id_pred(*_UNSIGNED)
is_integer = _id_pred(*_SIGNED, *_UNSIGNED)
is_floating = _id_pred(*_FLOATS)
is_decimal32 = _id_pred(TypeId.DECIMAL32)
is_decimal64 = _id_pred(TypeId.DECIMAL64)
is_decimal128 = _id_pred(TypeId.DECIMAL128)
is_decimal256 = _id_pred(TypeId.DECIMAL256)
is_decimal = _id_pred(*_DECIMALS)
is_list = _id_pred(TypeId.LIST)
is_large_list = _id_pred(TypeId.LARGE_LIST)
is_fixed_size_list = _id_pred(TypeId.FIXED_SIZE_LIST)
is_list_view = _id_pred(TypeId.LIST_VIEW)
is_large_list_view = _id_pred(TypeId.LARGE_LIST_VIEW)
is_struct = _id_pred(TypeId.STRUCT)
is_union = _id_pred(TypeId.SPARSE_UNION, TypeId.DENSE_UNION)
is_map = _id_pred(TypeId.MAP)
is_nested = _id_pred(TypeId.LIST, TypeId.LARGE_LIST, TypeId.FIXED_SIZE_LIST,
                     TypeId.LIST_VIEW, TypeId.LARGE_LIST_VIEW, TypeId.STRUCT,
                     TypeId.SPARSE_UNION, TypeId.DENSE_UNION, TypeId.MAP)
is_run_end_encoded = _id_pred(TypeId.RUN_END_ENCODED)
is_timestamp = _id_pred(TypeId.TIMESTAMP)
is_duration = _id_pred(TypeId.DURATION)
is_time32 = _id_pred(TypeId.TIME32)
is_time64 = _id_pred(TypeId.TIME64)
is_time = _id_pred(TypeId.TIME32, TypeId.TIME64)
is_date32 = _id_pred(TypeId.DATE32)
is_date64 = _id_pred(TypeId.DATE64)
is_date = _id_pred(TypeId.DATE32, TypeId.DATE64)
is_interval = _id_pred(TypeId.INTERVAL_MONTHS, TypeId.INTERVAL_DAY_TIME,
                       TypeId.INTERVAL_MONTH_DAY_NANO)
# intervals count as temporal here, as in pyarrow (DataType.is_temporal
# leaves them out, as the reference's does)
is_temporal = _id_pred(*_TEMPORAL, TypeId.INTERVAL_MONTHS,
                       TypeId.INTERVAL_DAY_TIME,
                       TypeId.INTERVAL_MONTH_DAY_NANO)
is_string = is_unicode = _id_pred(TypeId.STRING)
is_large_string = is_large_unicode = _id_pred(TypeId.LARGE_STRING)
is_string_view = _id_pred(TypeId.STRING_VIEW)
is_binary = _id_pred(TypeId.BINARY)
is_large_binary = _id_pred(TypeId.LARGE_BINARY)
is_binary_view = _id_pred(TypeId.BINARY_VIEW)
is_fixed_size_binary = _id_pred(TypeId.FIXED_SIZE_BINARY)
is_dictionary = _id_pred(TypeId.DICTIONARY)
is_primitive = _id_pred(TypeId.BOOL, *_SIGNED, *_UNSIGNED, *_FLOATS,
                        *_TEMPORAL, TypeId.INTERVAL_MONTHS,
                        TypeId.INTERVAL_DAY_TIME,
                        TypeId.INTERVAL_MONTH_DAY_NANO,
                        TypeId.FIXED_SIZE_BINARY)


def is_boolean_value(v) -> bool:
    return isinstance(v, (bool, np.bool_))


def is_integer_value(v) -> bool:
    return isinstance(v, (int, np.integer)) and not isinstance(v, bool)


def is_float_value(v) -> bool:
    return isinstance(v, (float, np.floating))
