"""Extension types: logical types over a storage type (counterpart of
``arrow_tpu/extension.py``; reference: cpp/src/arrow/extension_type.h:39,
the registry at :131 and the built-ins under cpp/src/arrow/extension/).

On the wire an extension field is its storage type with the field
metadata keys ``ARROW:extension:name`` and ``ARROW:extension:metadata``
(``ipc/schema_fb.py``); a reader rebuilds a registered name with
``reconstruct`` and reads any other as its storage type. An Array of an
extension type holds the storage's buffers under the extension type, and
its values are the storage's.
"""

from __future__ import annotations

import json
import math
from typing import Dict, Optional

import numpy as np

from . import types as T
from .types import DataType, TypeId


class ExtensionType(DataType):
    __slots__ = ("storage_type", "extension_name_")

    def __init__(self, storage_type: DataType, extension_name: str):
        super().__init__(TypeId.EXTENSION)
        self.storage_type = storage_type
        self.extension_name_ = extension_name

    @property
    def extension_name(self) -> str:
        return self.extension_name_

    def extension_metadata(self) -> bytes:
        """The serialized parameters (a subclass's)."""
        return b""

    @classmethod
    def deserialize(cls, storage_type: DataType,
                    metadata: bytes) -> "ExtensionType":
        raise NotImplementedError

    @property
    def fields(self):
        return self.storage_type.fields

    @property
    def bit_width(self):
        return self.storage_type.bit_width

    @property
    def byte_width(self):
        return self.storage_type.byte_width

    def _key(self):
        return (int(self.id), self.extension_name_,
                self.storage_type._key(), self.extension_metadata())

    def __repr__(self):
        return (f"extension<{self.extension_name_}, "
                f"storage={self.storage_type!r}>")


_REGISTRY: Dict[str, type] = {}


def register_extension_type(ext_type_cls, name: Optional[str] = None):
    """Register a class by its extension name, for the IPC and C data
    readers to rebuild it."""
    if name is None:
        name = getattr(ext_type_cls, "EXTENSION_NAME", None)
        if name is None:
            raise ValueError("pass name= or set EXTENSION_NAME")
    _REGISTRY[name] = ext_type_cls


def unregister_extension_type(name: str):
    _REGISTRY.pop(name, None)


def lookup_extension_type(name: str) -> Optional[type]:
    return _REGISTRY.get(name)


def reconstruct(storage_type: DataType, name: str,
                metadata: bytes) -> DataType:
    """The registered type of ``name`` over ``storage_type``; the storage
    type itself where the name is not registered."""
    cls = _REGISTRY.get(name)
    if cls is None:
        return storage_type
    return cls.deserialize(storage_type, metadata)


# --- the built-ins (reference: cpp/src/arrow/extension/) --------------------

class UuidType(ExtensionType):
    EXTENSION_NAME = "arrow.uuid"

    def __init__(self):
        super().__init__(T.fixed_size_binary(16), self.EXTENSION_NAME)

    @classmethod
    def deserialize(cls, storage_type, metadata):
        return cls()


class JsonType(ExtensionType):
    EXTENSION_NAME = "arrow.json"

    def __init__(self, storage_type=None):
        super().__init__(storage_type or T.string(), self.EXTENSION_NAME)

    @classmethod
    def deserialize(cls, storage_type, metadata):
        return cls(storage_type)


class Bool8Type(ExtensionType):
    EXTENSION_NAME = "arrow.bool8"

    def __init__(self):
        super().__init__(T.int8(), self.EXTENSION_NAME)

    @classmethod
    def deserialize(cls, storage_type, metadata):
        return cls()


class OpaqueType(ExtensionType):
    EXTENSION_NAME = "arrow.opaque"

    def __init__(self, storage_type, type_name: str = "",
                 vendor_name: str = ""):
        super().__init__(storage_type, self.EXTENSION_NAME)
        self.type_name = type_name
        self.vendor_name = vendor_name

    def extension_metadata(self) -> bytes:
        return json.dumps({"type_name": self.type_name,
                           "vendor_name": self.vendor_name}).encode()

    @classmethod
    def deserialize(cls, storage_type, metadata):
        d = json.loads(metadata or b"{}")
        return cls(storage_type, d.get("type_name", ""),
                   d.get("vendor_name", ""))


class FixedShapeTensorType(ExtensionType):
    """The canonical fixed-shape tensor (extension/fixed_shape_tensor.h):
    storage fixed_size_list(value_type, prod(shape)); metadata JSON of
    shape, permutation and dim_names."""

    EXTENSION_NAME = "arrow.fixed_shape_tensor"

    def __init__(self, value_type: DataType, shape,
                 dim_names=None, permutation=None):
        shape = [int(s) for s in shape]
        size = math.prod(shape) if shape else 1
        super().__init__(T.fixed_size_list(value_type, size),
                         self.EXTENSION_NAME)
        self.value_type = value_type
        self.shape = shape
        self.dim_names = list(dim_names) if dim_names else None
        self.permutation = list(permutation) if permutation else None

    def extension_metadata(self) -> bytes:
        d = {"shape": self.shape}
        if self.permutation:
            d["permutation"] = self.permutation
        if self.dim_names:
            d["dim_names"] = self.dim_names
        return json.dumps(d).encode()

    @classmethod
    def deserialize(cls, storage_type, metadata):
        d = json.loads(metadata or b"{}")
        return cls(storage_type.value_type, d.get("shape", []),
                   d.get("dim_names"), d.get("permutation"))


class VariableShapeTensorType(ExtensionType):
    """The canonical variable-shape tensor
    (extension/variable_shape_tensor.h): storage struct<data:
    list(value_type), shape: fixed_size_list(int32, ndim)>."""

    EXTENSION_NAME = "arrow.variable_shape_tensor"

    def __init__(self, value_type: DataType, ndim: int,
                 dim_names=None, permutation=None,
                 uniform_shape=None):
        storage = T.struct([
            ("data", T.list_(value_type)),
            ("shape", T.fixed_size_list(T.int32(), int(ndim)))])
        super().__init__(storage, self.EXTENSION_NAME)
        self.value_type = value_type
        self.ndim = int(ndim)
        self.dim_names = list(dim_names) if dim_names else None
        self.permutation = list(permutation) if permutation else None
        self.uniform_shape = list(uniform_shape) if uniform_shape else None

    def extension_metadata(self) -> bytes:
        d: Dict = {}
        if self.permutation:
            d["permutation"] = self.permutation
        if self.dim_names:
            d["dim_names"] = self.dim_names
        if self.uniform_shape:
            d["uniform_shape"] = self.uniform_shape
        return json.dumps(d).encode()

    @classmethod
    def deserialize(cls, storage_type, metadata):
        d = json.loads(metadata or b"{}")
        shape_f = storage_type.fields[1].type
        return cls(storage_type.fields[0].type.value_type,
                   shape_f.list_size, d.get("dim_names"),
                   d.get("permutation"), d.get("uniform_shape"))


def uuid() -> UuidType:
    return UuidType()


def json_(storage_type=None) -> JsonType:
    return JsonType(storage_type)


def bool8() -> Bool8Type:
    return Bool8Type()


def opaque(storage_type, type_name: str = "",
           vendor_name: str = "") -> OpaqueType:
    return OpaqueType(storage_type, type_name, vendor_name)


def fixed_shape_tensor(value_type, shape, dim_names=None,
                       permutation=None) -> FixedShapeTensorType:
    return FixedShapeTensorType(value_type, shape, dim_names, permutation)


def variable_shape_tensor(value_type, ndim, dim_names=None,
                          permutation=None,
                          uniform_shape=None) -> VariableShapeTensorType:
    return VariableShapeTensorType(value_type, ndim, dim_names,
                                   permutation, uniform_shape)


class ExtensionArray:
    """An array of an extension type over its storage Array (reference:
    extension_type.h ExtensionArray); its values are the storage's."""

    def __init__(self, type: ExtensionType, storage):
        self.type = type
        self.storage = storage

    @classmethod
    def from_storage(cls, typ: ExtensionType, storage) -> "ExtensionArray":
        if storage.type != typ.storage_type:
            raise TypeError(f"storage type {storage.type!r} does not match "
                            f"{typ.storage_type!r}")
        if isinstance(typ, FixedShapeTensorType):
            return FixedShapeTensorArray(typ, storage)
        return cls(typ, storage)

    def __len__(self):
        return len(self.storage)

    @property
    def null_count(self):
        return self.storage.null_count

    def to_pylist(self):
        return self.storage.to_pylist()

    def __repr__(self):
        return (f"<arrow_tpu_torch.ExtensionArray {self.type!r}>"
                f"\n{self.to_pylist()!r}")


_TENSOR_VALUE_TYPES = {"float32": T.float32, "float64": T.float64,
                       "int8": T.int8, "int16": T.int16, "int32": T.int32,
                       "int64": T.int64, "uint8": T.uint8,
                       "uint16": T.uint16, "uint32": T.uint32,
                       "uint64": T.uint64, "float16": T.float16}


class FixedShapeTensorArray(ExtensionArray):
    """Tensors a row (extension/fixed_shape_tensor.h
    FixedShapeTensorArray), converted to and from numpy without a loop
    over the rows; ``to_numpy_ndarray`` gives float64 or int64, as the
    reference's does."""

    def to_numpy_ndarray(self) -> np.ndarray:
        n = len(self.storage)
        d = self.storage.data
        if d.null_count or d.children[0].null_count:
            # a null tensor or element: as the reference, through Python
            flat = np.asarray([v for row in self.storage.to_pylist()
                               for v in row])
            return flat.reshape([n] + list(self.type.shape))
        size = self.type.storage_type.list_size
        values = d.children[0].slice(d.offset * size, n * size).values()
        # the dtype numpy gives the values as Python numbers, as the
        # reference's conversion through Python lists has it
        wide = {"f": np.float64, "i": np.int64, "u": np.int64}.get(
            values.dtype.kind, values.dtype)
        return values.astype(wide).reshape([n] + list(self.type.shape))

    @classmethod
    def from_numpy_ndarray(cls, arr) -> "FixedShapeTensorArray":
        from .array.array import Array
        from .array.data import ArrayData
        from .buffer import Buffer
        arr = np.asarray(arr)
        if arr.ndim < 2:
            raise ValueError("need at least 2 dimensions "
                             "(batch + tensor dims)")
        vt = _TENSOR_VALUE_TYPES[str(arr.dtype)]()
        shape = list(arr.shape[1:])
        size = math.prod(shape)
        typ = FixedShapeTensorType(vt, shape)
        flat = np.ascontiguousarray(arr).reshape(-1)
        child = ArrayData(vt, flat.size, [None, Buffer(flat)], null_count=0)
        storage = Array(ArrayData(T.fixed_size_list(vt, size), arr.shape[0],
                                  [None], [child], null_count=0))
        return cls(typ, storage)


for _cls in (UuidType, JsonType, Bool8Type, OpaqueType,
             FixedShapeTensorType, VariableShapeTensorType):
    register_extension_type(_cls, _cls.EXTENSION_NAME)
