"""Logical types, fields and schemas: the reference device's type set from
``arrow_tpu/types.py``. Type ids keep the reference's numbering.

The device holds bool, the eight integer widths, the three floats, date32
and date64, timestamps, time32 and time64, durations, month intervals, the
all-null type, decimals of up to 18 digits (as unscaled int64), strings
(as dictionary codes) and dictionaries. Decimals wider than 18 digits and
fixed-size binary reach the reference's device as dictionary codes of a
host Array; the port raises on them (ROADMAP.md, queue 1, item 11: the host
boundary)."""

from __future__ import annotations

import enum
from typing import List, Optional, Sequence

HOST_BOUNDARY = "(ROADMAP.md, queue 1, item 11: the host boundary)"


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
    FIXED_SIZE_BINARY = 15
    DATE32 = 16
    DATE64 = 17
    TIMESTAMP = 18
    TIME32 = 19
    TIME64 = 20
    INTERVAL_MONTHS = 21
    DECIMAL128 = 23
    DECIMAL256 = 24
    DICTIONARY = 29
    DURATION = 33
    DECIMAL32 = 43
    DECIMAL64 = 44


_SIGNED = (TypeId.INT8, TypeId.INT16, TypeId.INT32, TypeId.INT64)
_UNSIGNED = (TypeId.UINT8, TypeId.UINT16, TypeId.UINT32, TypeId.UINT64)
_FLOATS = (TypeId.HALF_FLOAT, TypeId.FLOAT, TypeId.DOUBLE)
_DECIMALS = (TypeId.DECIMAL32, TypeId.DECIMAL64, TypeId.DECIMAL128,
             TypeId.DECIMAL256)
_TEMPORAL = (TypeId.DATE32, TypeId.DATE64, TypeId.TIMESTAMP, TypeId.TIME32,
             TypeId.TIME64, TypeId.DURATION)

_BIT_WIDTHS = {
    TypeId.BOOL: 1, TypeId.INT8: 8, TypeId.UINT8: 8, TypeId.INT16: 16,
    TypeId.UINT16: 16, TypeId.INT32: 32, TypeId.UINT32: 32, TypeId.INT64: 64,
    TypeId.UINT64: 64, TypeId.HALF_FLOAT: 16, TypeId.FLOAT: 32,
    TypeId.DOUBLE: 64, TypeId.DATE32: 32, TypeId.DATE64: 64,
    TypeId.TIMESTAMP: 64, TypeId.TIME32: 32, TypeId.TIME64: 64,
    TypeId.DURATION: 64, TypeId.INTERVAL_MONTHS: 32, TypeId.DECIMAL32: 32,
    TypeId.DECIMAL64: 64, TypeId.DECIMAL128: 128, TypeId.DECIMAL256: 256,
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
    def bit_width(self) -> int:
        if self.id in _BIT_WIDTHS:
            return _BIT_WIDTHS[self.id]
        raise ValueError(f"{self!r} is not fixed-width")

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


_NAMES = {TypeId.NA: "null", TypeId.BOOL: "bool", TypeId.INT8: "int8",
          TypeId.INT16: "int16", TypeId.INT32: "int32", TypeId.INT64: "int64",
          TypeId.UINT8: "uint8", TypeId.UINT16: "uint16",
          TypeId.UINT32: "uint32", TypeId.UINT64: "uint64",
          TypeId.HALF_FLOAT: "float16", TypeId.FLOAT: "float32",
          TypeId.DOUBLE: "float64", TypeId.STRING: "string",
          TypeId.DATE32: "date32", TypeId.DATE64: "date64",
          TypeId.INTERVAL_MONTHS: "month_interval"}


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


def date32() -> DataType:
    return DataType(TypeId.DATE32)


def date64() -> DataType:
    return DataType(TypeId.DATE64)


def month_interval() -> DataType:
    return DataType(TypeId.INTERVAL_MONTHS)


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


def dictionary(index_type: DataType, value_type: DataType) -> DataType:
    return DataType(TypeId.DICTIONARY, index_type, value_type)


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
    if name.startswith("fixed_size_binary") or name in ("binary",
                                                         "large_string",
                                                         "large_binary"):
        raise NotImplementedError(
            f"{name!r} columns ride the reference's device as dictionary "
            "codes of a host Array; not ported yet " + HOST_BOUNDARY)
    raise NotImplementedError(f"no port type named {name!r}")


class Field:
    __slots__ = ("name", "type")

    def __init__(self, name: str, type: DataType):
        self.name = name
        self.type = type

    def __repr__(self):
        return f"Field({self.name}: {self.type!r})"


class Schema:
    __slots__ = ("fields",)

    def __init__(self, fields: Sequence[Field]):
        self.fields = list(fields)

    @property
    def names(self) -> List[str]:
        return [f.name for f in self.fields]

    def get_field_index(self, name: str) -> int:
        names = self.names
        return names.index(name) if name in names else -1

    def __repr__(self):
        return f"Schema({self.fields!r})"
