"""pyarrow's module-level names (counterpart of
``arrow_tpu/compat_names.py``; pyarrow's array.pxi, scalar.pxi and
types.pxi class surfaces).

pyarrow has a class a type (Int32Array, StringScalar, Decimal128Type,
...); the port has one Array, one Scalar and a few DataType classes.
These names import, and ``isinstance`` with them tests the value's type
id (or extension name) at run time. Where the reference answers for a
TPU or a JAX library (``jemalloc_set_decay_ms``, ``get_include``), the
port answers for itself.
"""

from __future__ import annotations

import os

from . import types as _T
from .array.array import Array
from .compute.registry import Scalar
from .extension import ExtensionType
from .io.caching import CacheOptions
from .types import DataType, TypeId

_INTS = (TypeId.INT8, TypeId.INT16, TypeId.INT32, TypeId.INT64,
         TypeId.UINT8, TypeId.UINT16, TypeId.UINT32, TypeId.UINT64)
_FLOATS = (TypeId.HALF_FLOAT, TypeId.FLOAT, TypeId.DOUBLE)
_GROUPS = {
    "Null": (TypeId.NA,),
    "Boolean": (TypeId.BOOL,),
    "Int8": (TypeId.INT8,), "Int16": (TypeId.INT16,),
    "Int32": (TypeId.INT32,), "Int64": (TypeId.INT64,),
    "UInt8": (TypeId.UINT8,), "UInt16": (TypeId.UINT16,),
    "UInt32": (TypeId.UINT32,), "UInt64": (TypeId.UINT64,),
    "HalfFloat": (TypeId.HALF_FLOAT,), "Float": (TypeId.FLOAT,),
    "Double": (TypeId.DOUBLE,),
    "Integer": _INTS, "FloatingPoint": _FLOATS, "Numeric": _INTS + _FLOATS,
    "String": (TypeId.STRING,), "LargeString": (TypeId.LARGE_STRING,),
    "StringView": (TypeId.STRING_VIEW,),
    "Binary": (TypeId.BINARY,), "LargeBinary": (TypeId.LARGE_BINARY,),
    "BinaryView": (TypeId.BINARY_VIEW,),
    "FixedSizeBinary": (TypeId.FIXED_SIZE_BINARY,),
    "Date32": (TypeId.DATE32,), "Date64": (TypeId.DATE64,),
    "Time32": (TypeId.TIME32,), "Time64": (TypeId.TIME64,),
    "Timestamp": (TypeId.TIMESTAMP,), "Duration": (TypeId.DURATION,),
    "MonthDayNanoInterval": (TypeId.INTERVAL_MONTH_DAY_NANO,),
    "Decimal32": (TypeId.DECIMAL32,), "Decimal64": (TypeId.DECIMAL64,),
    "Decimal128": (TypeId.DECIMAL128,),
    "Decimal256": (TypeId.DECIMAL256,),
    "List": (TypeId.LIST,), "LargeList": (TypeId.LARGE_LIST,),
    "ListView": (TypeId.LIST_VIEW,),
    "LargeListView": (TypeId.LARGE_LIST_VIEW,),
    "FixedSizeList": (TypeId.FIXED_SIZE_LIST,),
    "Struct": (TypeId.STRUCT,), "Map": (TypeId.MAP,),
    "Union": (TypeId.SPARSE_UNION, TypeId.DENSE_UNION),
    "SparseUnion": (TypeId.SPARSE_UNION,),
    "DenseUnion": (TypeId.DENSE_UNION,),
    "Dictionary": (TypeId.DICTIONARY,),
    "RunEndEncoded": (TypeId.RUN_END_ENCODED,),
}
# by extension name (Bool8Array, UuidScalar, ...)
_EXT_GROUPS = {
    "Bool8": "arrow.bool8", "Uuid": "arrow.uuid", "Json": "arrow.json",
    "Opaque": "arrow.opaque",
    "FixedShapeTensor": "arrow.fixed_shape_tensor",
}
# the type classes the port's types.py has no class for
_TYPE_CLASSES = {
    "Decimal32Type": TypeId.DECIMAL32, "Decimal64Type": TypeId.DECIMAL64,
    "Decimal128Type": TypeId.DECIMAL128,
    "Decimal256Type": TypeId.DECIMAL256,
    "SparseUnionType": TypeId.SPARSE_UNION,
    "DenseUnionType": TypeId.DENSE_UNION,
    "ListViewType": TypeId.LIST_VIEW, "LargeListType": TypeId.LARGE_LIST,
    "LargeListViewType": TypeId.LARGE_LIST_VIEW,
    "Time32Type": TypeId.TIME32, "Time64Type": TypeId.TIME64,
}


class _TypedMeta(type):
    """``isinstance(obj, cls)``: ``obj`` is of the class's base and its
    type (the object itself, for a DataType class) has one of the class's
    type ids or its extension name."""

    def __instancecheck__(cls, obj):
        base = cls.__compat_base__
        if not isinstance(obj, base):
            return False
        t = obj if base is DataType else getattr(obj, "type", None)
        if not isinstance(t, DataType):
            return False
        if cls.__ext_name__ is not None:
            return (isinstance(t, ExtensionType)
                    and t.extension_name == cls.__ext_name__)
        return t.id in cls.__type_ids__

    def __subclasscheck__(cls, sub):
        return cls is sub or sub in getattr(cls, "__mro__", ())


def _make(name, base, ids=(), ext=None):
    return _TypedMeta(name, (base,), {
        "__type_ids__": tuple(ids), "__ext_name__": ext,
        "__compat_base__": base,
        "__doc__": f"pyarrow's {name} (isinstance tests the type id)."})


_EXPORTS = {}
for _g, _ids in _GROUPS.items():
    _EXPORTS[f"{_g}Array"] = _make(f"{_g}Array", Array, _ids)
    _EXPORTS[f"{_g}Scalar"] = _make(f"{_g}Scalar", Scalar, _ids)
for _g, _ext in _EXT_GROUPS.items():
    if _g != "FixedShapeTensor":  # extension.FixedShapeTensorArray is real
        _EXPORTS[f"{_g}Array"] = _make(f"{_g}Array", Array, ext=_ext)
    _EXPORTS[f"{_g}Scalar"] = _make(f"{_g}Scalar", Scalar, ext=_ext)
_EXPORTS["ExtensionScalar"] = _make("ExtensionScalar", Scalar,
                                    [TypeId.EXTENSION])
for _name, _tid in _TYPE_CLASSES.items():
    _EXPORTS[_name] = _make(_name, DataType, [_tid])

BaseExtensionType = ExtensionType


class UnknownExtensionType(ExtensionType):
    """An extension type of a name not registered
    (extension_type.h UnregisteredExtensionType)."""

    def __init__(self, storage_type, serialized: bytes = b""):
        super().__init__(storage_type, "arrow.unknown")
        self.serialized = serialized

    def extension_metadata(self) -> bytes:
        return self.serialized


def union(child_fields, mode: str = "sparse", type_codes=None):
    """pyarrow.union."""
    if mode in ("sparse", 0):
        return _T.sparse_union(child_fields, type_codes)
    return _T.dense_union(child_fields, type_codes)


def arange(start, stop=None, step=1, *, type=None):
    """pyarrow.arange."""
    from .array.array import array
    if stop is None:
        start, stop = 0, start
    return array(list(range(start, stop, step)), type or _T.int64())


globals().update(_EXPORTS)


class MonthDayNano:
    """An interval value (pyarrow.MonthDayNano)."""

    __slots__ = ("months", "days", "nanoseconds")

    def __init__(self, value):
        self.months, self.days, self.nanoseconds = value

    def __iter__(self):
        return iter((self.months, self.days, self.nanoseconds))

    def __eq__(self, other):
        other = other if isinstance(other, MonthDayNano) \
            else MonthDayNano(other)
        return tuple(self) == tuple(other)

    def __repr__(self):
        return (f"MonthDayNano(months={self.months}, days={self.days}, "
                f"nanoseconds={self.nanoseconds})")


class KeyValueMetadata(dict):
    """A map of binary keys to binary values
    (util/key_value_metadata.h)."""

    def __init__(self, mapping=None, **kwargs):
        items = {}
        for src in (mapping or {}), kwargs:
            for k, v in dict(src).items():
                items[k.encode() if isinstance(k, str) else bytes(k)] = \
                    v.encode() if isinstance(v, str) else bytes(v)
        super().__init__(items)

    def key(self, i):
        return list(self.keys())[i]

    def value(self, i):
        return list(self.values())[i]

    def to_dict(self):
        return dict(self)


class DictionaryMemo:
    """The dictionaries of an IPC stream by id (ipc/dictionary.h), opaque
    as in pyarrow."""

    def __init__(self):
        self._dicts = {}


def have_libhdfs() -> bool:
    """False: the port reaches HDFS over WebHDFS (``fs.HadoopFileSystem``),
    not libhdfs."""
    return False


def is_opentelemetry_enabled() -> bool:
    return False


def enable_signal_handlers(enable: bool) -> None:
    return None


def create_library_symlinks() -> None:
    return None


def get_include() -> str:
    """The port's C++ and CUDA sources (``csrc``)."""
    return os.path.join(os.path.dirname(__file__), "csrc")


def get_libraries():
    return []


def get_library_dirs():
    return []


def set_timezone_db_path(path) -> None:
    return None


def jemalloc_set_decay_ms(decay_ms: int) -> None:
    raise NotImplementedError("jemalloc backend not available (host memory "
                              "is numpy's, device memory PyTorch's caching "
                              "allocator)")


__all__ = list(_EXPORTS) + [
    "BaseExtensionType", "UnknownExtensionType", "union", "arange",
    "MonthDayNano", "KeyValueMetadata", "DictionaryMemo", "CacheOptions",
    "have_libhdfs", "is_opentelemetry_enabled", "enable_signal_handlers",
    "create_library_symlinks", "get_include", "get_libraries",
    "get_library_dirs", "set_timezone_db_path", "jemalloc_set_decay_ms"]
