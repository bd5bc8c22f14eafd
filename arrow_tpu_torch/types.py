"""Logical types, fields and schemas: the part of ``arrow_tpu/types.py`` that
the port's plans use. Type ids keep the reference's numbering."""

from __future__ import annotations

import enum
from typing import List, Optional, Sequence

import torch


class TypeId(enum.IntEnum):
    BOOL = 1
    INT32 = 7
    INT64 = 9
    FLOAT = 11
    DOUBLE = 12
    STRING = 13
    DATE32 = 16
    DICTIONARY = 29


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
    def is_temporal(self) -> bool:
        return self.id == TypeId.DATE32

    def __repr__(self):
        if self.id == TypeId.DICTIONARY:
            return f"dictionary<{self.index_type!r}, {self.value_type!r}>"
        return _NAMES[self.id]


_NAMES = {TypeId.BOOL: "bool", TypeId.INT32: "int32", TypeId.INT64: "int64",
          TypeId.FLOAT: "float32", TypeId.DOUBLE: "float64",
          TypeId.STRING: "string", TypeId.DATE32: "date32"}


def bool_() -> DataType:
    return DataType(TypeId.BOOL)


def int32() -> DataType:
    return DataType(TypeId.INT32)


def int64() -> DataType:
    return DataType(TypeId.INT64)


def float32() -> DataType:
    return DataType(TypeId.FLOAT)


def float64() -> DataType:
    return DataType(TypeId.DOUBLE)


def string() -> DataType:
    return DataType(TypeId.STRING)


def date32() -> DataType:
    return DataType(TypeId.DATE32)


def dictionary(index_type: DataType, value_type: DataType) -> DataType:
    return DataType(TypeId.DICTIONARY, index_type, value_type)


def type_for_name(name: str) -> DataType:
    """``"bool"``, ``"int32"``, ``"int64"``, ``"float32"``, ``"float64"``,
    ``"date32"``, ``"string"`` or ``"dictionary"`` (int32 codes of
    strings)."""
    if name == "dictionary":
        return dictionary(int32(), string())
    for tid, n in _NAMES.items():
        if n == name:
            return DataType(tid)
    raise NotImplementedError(f"no port type named {name!r}")


_FROM_TORCH = {torch.bool: TypeId.BOOL, torch.int32: TypeId.INT32,
               torch.int64: TypeId.INT64, torch.float32: TypeId.FLOAT,
               torch.float64: TypeId.DOUBLE}


def from_torch_dtype(dtype: torch.dtype) -> DataType:
    try:
        return DataType(_FROM_TORCH[dtype])
    except KeyError:
        raise NotImplementedError(f"no port type for {dtype}") from None


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
