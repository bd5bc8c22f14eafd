"""The Arrow C data interface and its PyCapsule protocol (counterpart of
``arrow_tpu/c_data.py``; reference: cpp/src/arrow/c/abi.h:50,66 and
c/bridge.cc): ArrowSchema, ArrowArray and ArrowArrayStream through
``ctypes``, so host Arrays move between the port and any Arrow library in
one process.

Export is zero-copy: a struct points at the Array's own buffers and keeps
them alive until its release callback runs. Import copies the buffers and
releases the producer's structs at once, as the reference's does.

Ownership, where the reference leaks (ROADMAP.md §3):

* Every exported struct, children and dictionary included, holds its own
  entry of ``_EXPORTS`` (its format and name bytes, its pointer arrays,
  its buffers); its release callback releases its children that are not
  released yet (a consumer may have moved one out), then drops its entry.
* A capsule that no consumer moved releases its struct in the capsule's
  destructor, as the PyCapsule protocol says; ``_CAPSULES`` keeps the
  struct's memory until then.
* An imported stream is moved out of its capsule and released once its
  reader is exhausted or closed (or dropped).
* No callback lets a Python error out: each catches, answers with an
  error code where the interface has one, and keeps the message for
  ``get_last_error``.

Nothing here leans on the cyclic garbage collector: no export makes a
reference cycle, so dropping an entry frees what it kept.

Departure: the view types have C formats here (``vu``, ``vz``, ``+vl``,
``+vL`` with the spec's variadic buffer sizes); the reference has none and
raises. A type that neither has (an extension type) raises
NotImplementedError, as the reference's ``format_for_type`` does.
"""

from __future__ import annotations

import ctypes
import itertools
from typing import List, Optional

import numpy as np

from . import types as T
from .array.array import Array
from .array.data import ArrayData
from .buffer import Buffer
from .types import DataType, Field, TypeId

ARROW_FLAG_DICTIONARY_ORDERED = 1
ARROW_FLAG_NULLABLE = 2
ARROW_FLAG_MAP_KEYS_SORTED = 4

_EIO = 5
_EINVAL = 22


class ArrowSchemaStruct(ctypes.Structure):
    pass


_SchemaPtr = ctypes.POINTER(ArrowSchemaStruct)
_ReleaseSchema = ctypes.CFUNCTYPE(None, _SchemaPtr)
ArrowSchemaStruct._fields_ = [
    ("format", ctypes.c_char_p),
    ("name", ctypes.c_char_p),
    ("metadata", ctypes.c_void_p),
    ("flags", ctypes.c_int64),
    ("n_children", ctypes.c_int64),
    ("children", ctypes.POINTER(_SchemaPtr)),
    ("dictionary", _SchemaPtr),
    ("release", _ReleaseSchema),
    ("private_data", ctypes.c_void_p),
]


class ArrowArrayStruct(ctypes.Structure):
    pass


_ArrayPtr = ctypes.POINTER(ArrowArrayStruct)
_ReleaseArray = ctypes.CFUNCTYPE(None, _ArrayPtr)
ArrowArrayStruct._fields_ = [
    ("length", ctypes.c_int64),
    ("null_count", ctypes.c_int64),
    ("offset", ctypes.c_int64),
    ("n_buffers", ctypes.c_int64),
    ("n_children", ctypes.c_int64),
    ("buffers", ctypes.POINTER(ctypes.c_void_p)),
    ("children", ctypes.POINTER(_ArrayPtr)),
    ("dictionary", _ArrayPtr),
    ("release", _ReleaseArray),
    ("private_data", ctypes.c_void_p),
]


class ArrowArrayStreamStruct(ctypes.Structure):
    pass


_StreamPtr = ctypes.POINTER(ArrowArrayStreamStruct)
_GetSchema = ctypes.CFUNCTYPE(ctypes.c_int, _StreamPtr, _SchemaPtr)
_GetNext = ctypes.CFUNCTYPE(ctypes.c_int, _StreamPtr, _ArrayPtr)
_GetLastError = ctypes.CFUNCTYPE(ctypes.c_void_p, _StreamPtr)
_ReleaseStream = ctypes.CFUNCTYPE(None, _StreamPtr)
ArrowArrayStreamStruct._fields_ = [
    ("get_schema", _GetSchema),
    ("get_next", _GetNext),
    ("get_last_error", _GetLastError),
    ("release", _ReleaseStream),
    ("private_data", ctypes.c_void_p),
]


# --- formats -----------------------------------------------------------------

_FORMAT_FOR = {
    TypeId.NA: "n", TypeId.BOOL: "b",
    TypeId.INT8: "c", TypeId.UINT8: "C",
    TypeId.INT16: "s", TypeId.UINT16: "S",
    TypeId.INT32: "i", TypeId.UINT32: "I",
    TypeId.INT64: "l", TypeId.UINT64: "L",
    TypeId.HALF_FLOAT: "e", TypeId.FLOAT: "f", TypeId.DOUBLE: "g",
    TypeId.STRING: "u", TypeId.BINARY: "z",
    TypeId.LARGE_STRING: "U", TypeId.LARGE_BINARY: "Z",
    TypeId.DATE32: "tdD", TypeId.DATE64: "tdm",
    TypeId.INTERVAL_MONTHS: "tiM",
    TypeId.INTERVAL_DAY_TIME: "tiD",
    TypeId.INTERVAL_MONTH_DAY_NANO: "tin",
    TypeId.LIST: "+l", TypeId.LARGE_LIST: "+L", TypeId.STRUCT: "+s",
    TypeId.MAP: "+m", TypeId.RUN_END_ENCODED: "+r",
    TypeId.STRING_VIEW: "vu", TypeId.BINARY_VIEW: "vz",
    TypeId.LIST_VIEW: "+vl", TypeId.LARGE_LIST_VIEW: "+vL",
}
_TYPE_FOR = {v: k for k, v in _FORMAT_FOR.items()}
_UNIT_CODE = {"s": "s", "ms": "m", "us": "u", "ns": "n"}
_CODE_UNIT = {v: k for k, v in _UNIT_CODE.items()}
_DECIMALS = (TypeId.DECIMAL32, TypeId.DECIMAL64, TypeId.DECIMAL128,
             TypeId.DECIMAL256)


def format_for_type(t: DataType) -> str:
    tid = t.id
    if tid in _FORMAT_FOR:
        return _FORMAT_FOR[tid]
    if tid == TypeId.TIMESTAMP:
        return f"ts{_UNIT_CODE[t.unit]}:{t.tz or ''}"
    if tid in (TypeId.TIME32, TypeId.TIME64):
        return f"tt{_UNIT_CODE[t.unit]}"
    if tid == TypeId.DURATION:
        return f"tD{_UNIT_CODE[t.unit]}"
    if tid == TypeId.FIXED_SIZE_BINARY:
        return f"w:{t.byte_width}"
    if tid in _DECIMALS:
        bits = "" if tid == TypeId.DECIMAL128 else f",{t.bit_width}"
        return f"d:{t.precision},{t.scale}{bits}"
    if tid == TypeId.FIXED_SIZE_LIST:
        return f"+w:{t.list_size}"
    if tid == TypeId.SPARSE_UNION:
        return "+us:" + ",".join(map(str, t.type_codes))
    if tid == TypeId.DENSE_UNION:
        return "+ud:" + ",".join(map(str, t.type_codes))
    if tid == TypeId.DICTIONARY:
        return format_for_type(t.index_type)
    raise NotImplementedError(f"C ABI format for {t!r}")


def type_for_format(fmt: str, children: List[Field]) -> DataType:
    if fmt in _TYPE_FOR:
        tid = _TYPE_FOR[fmt]
        if tid in (TypeId.LIST, TypeId.LARGE_LIST, TypeId.LIST_VIEW,
                   TypeId.LARGE_LIST_VIEW):
            return T.ListType(children[0], tid)
        if tid == TypeId.STRUCT:
            return T.StructType(children)
        if tid == TypeId.MAP:
            entries = children[0].type
            return T.map_(entries.fields[0].type, entries.fields[1].type)
        if tid == TypeId.RUN_END_ENCODED:
            return T.RunEndEncodedType(children[0].type, children[1].type)
        return T.DataType(tid)
    if fmt.startswith("ts"):
        return T.timestamp(_CODE_UNIT[fmt[2]], fmt[4:] or None)
    if fmt.startswith("tt"):
        unit = _CODE_UNIT[fmt[2]]
        return T.time32(unit) if unit in ("s", "ms") else T.time64(unit)
    if fmt.startswith("tD"):
        return T.duration(_CODE_UNIT[fmt[2]])
    if fmt.startswith("w:"):
        return T.fixed_size_binary(int(fmt[2:]))
    if fmt.startswith("d:"):
        parts = fmt[2:].split(",")
        mk = T.decimal128 if len(parts) < 3 else {
            "32": T.decimal32, "64": T.decimal64, "128": T.decimal128,
            "256": T.decimal256}[parts[2]]
        return mk(int(parts[0]), int(parts[1]))
    if fmt.startswith("+w:"):
        return T.FixedSizeListType(children[0], int(fmt[3:]))
    if fmt.startswith(("+us:", "+ud:")):
        codes = [int(c) for c in fmt[4:].split(",") if c]
        return T.UnionType(children, codes,
                           "sparse" if fmt[2] == "s" else "dense")
    raise NotImplementedError(f"C ABI format {fmt!r}")


# --- export --------------------------------------------------------------------

# an exported struct's private_data -> what it keeps alive (its format and
# name bytes, pointer arrays, child structs and buffers)
_EXPORTS: dict = {}
# a live capsule's struct address -> the struct (its memory)
_CAPSULES: dict = {}
# an exported stream's private_data -> its state
_STREAMS: dict = {}
_ids = itertools.count(1)


def export_state() -> dict:
    """How many exported structs, capsules and streams are alive (none
    once every consumer has released what it took)."""
    return {"structs": len(_EXPORTS), "capsules": len(_CAPSULES),
            "streams": len(_STREAMS)}


def _release_children(s) -> None:
    for i in range(s.n_children):
        child = s.children[i]
        if child and child.contents.release:
            child.contents.release(child)
    if s.dictionary and s.dictionary.contents.release:
        s.dictionary.contents.release(s.dictionary)


def _release_schema_impl(ptr):
    try:
        s = ptr.contents
        _release_children(s)
        _EXPORTS.pop(s.private_data, None)
        s.release = _ReleaseSchema()
    except BaseException:  # noqa: BLE001 - nothing may cross the callback
        pass


def _release_array_impl(ptr):
    try:
        a = ptr.contents
        _release_children(a)
        _EXPORTS.pop(a.private_data, None)
        a.release = _ReleaseArray()
    except BaseException:  # noqa: BLE001 - nothing may cross the callback
        pass


_release_schema = _ReleaseSchema(_release_schema_impl)
_release_array = _ReleaseArray(_release_array_impl)


def _keep(objs: list) -> int:
    key = next(_ids)
    _EXPORTS[key] = objs
    return key


def _export_schema_into(field: Field, out: ArrowSchemaStruct) -> None:
    """Fill ``out`` (allocated by the caller) for ``field``; every child
    struct gets its own entry and release callback."""
    t = field.type
    fmt = format_for_type(t).encode()
    name = field.name.encode()
    keep: list = [fmt, name]
    out.format = fmt
    out.name = name
    out.metadata = None
    out.flags = ARROW_FLAG_NULLABLE if field.nullable else 0
    child_fields = t.value_type.fields if t.id == TypeId.DICTIONARY \
        else t.fields
    out.n_children = len(child_fields)
    out.children = None
    if child_fields:
        ptrs = (_SchemaPtr * len(child_fields))()
        for i, cf in enumerate(child_fields):
            child = ArrowSchemaStruct()
            _export_schema_into(cf, child)
            keep.append(child)
            ptrs[i] = ctypes.pointer(child)
        keep.append(ptrs)
        out.children = ctypes.cast(ptrs, ctypes.POINTER(_SchemaPtr))
    out.dictionary = None
    if t.id == TypeId.DICTIONARY:
        d = ArrowSchemaStruct()
        _export_schema_into(Field("", t.value_type), d)
        keep.append(d)
        out.dictionary = ctypes.pointer(d)
        if t.ordered:
            out.flags |= ARROW_FLAG_DICTIONARY_ORDERED
    out.private_data = _keep(keep)
    out.release = _release_schema


def _c_buffers(data: ArrayData) -> list:
    """The buffers in the C interface's order: a view type's variadic
    data buffers then an int64 buffer of their sizes; an all-null array
    one (null) buffer, as the reference exports it."""
    tid = data.type.id
    if tid == TypeId.NA:
        return [None]
    bufs = [None if b is None else b.to_numpy() for b in data.buffers]
    if tid in (TypeId.STRING_VIEW, TypeId.BINARY_VIEW):
        bufs.append(np.array([0 if b is None else b.size
                              for b in bufs[2:]], dtype=np.int64))
    return bufs


def _export_array_into(data: ArrayData, out: ArrowArrayStruct) -> None:
    """Fill ``out`` for ``data``: pointers to its own buffers, kept alive
    by the struct's entry until its release."""
    if data.type.id == TypeId.EXTENSION:
        format_for_type(data.type)  # raises, as the schema's export does
    out.length = data.length
    out.null_count = data.null_count
    out.offset = data.offset
    bufs = _c_buffers(data)
    keep: list = []
    out.n_buffers = len(bufs)
    ptrs = (ctypes.c_void_p * len(bufs))()
    for i, b in enumerate(bufs):
        if b is not None and b.size:
            keep.append(b)
            ptrs[i] = b.ctypes.data
    keep.append(ptrs)
    out.buffers = ctypes.cast(ptrs, ctypes.POINTER(ctypes.c_void_p))
    out.n_children = len(data.children)
    out.children = None
    if data.children:
        cptrs = (_ArrayPtr * len(data.children))()
        for i, c in enumerate(data.children):
            child = ArrowArrayStruct()
            _export_array_into(c, child)
            keep.append(child)
            cptrs[i] = ctypes.pointer(child)
        keep.append(cptrs)
        out.children = ctypes.cast(cptrs, ctypes.POINTER(_ArrayPtr))
    out.dictionary = None
    if data.dictionary is not None:
        d = ArrowArrayStruct()
        _export_array_into(data.dictionary, d)
        keep.append(d)
        out.dictionary = ctypes.pointer(d)
    out.private_data = _keep(keep)
    out.release = _release_array


def export_array(arr: Array, array_ptr: int, schema_ptr: int) -> None:
    """Export to ArrowArray and ArrowSchema structs the caller allocated,
    given by address (pyarrow's ``_export_to_c`` convention). The two
    release apart: a consumer may release the schema while it still reads
    the array's buffers."""
    schema = ctypes.cast(schema_ptr, _SchemaPtr).contents
    array = ctypes.cast(array_ptr, _ArrayPtr).contents
    _export_schema_into(Field("", arr.type, nullable=True), schema)
    try:
        _export_array_into(arr.data, array)
    except BaseException:
        _release_schema(ctypes.pointer(schema))
        raise


# --- import ----------------------------------------------------------------------

def _import_field(s: ArrowSchemaStruct) -> Field:
    children = [_import_field(s.children[i].contents)
                for i in range(s.n_children)]
    t = type_for_format(s.format.decode(), children)
    if s.dictionary:
        vt = _import_field(s.dictionary.contents).type
        t = T.dictionary(t, vt, bool(s.flags & ARROW_FLAG_DICTIONARY_ORDERED))
    name = s.name.decode() if s.name else ""
    return Field(name, t, bool(s.flags & ARROW_FLAG_NULLABLE))


def _copy(ptr, nbytes: int) -> Optional[Buffer]:
    if not ptr or nbytes <= 0:
        return None
    raw = (ctypes.c_uint8 * nbytes).from_address(ptr)
    return Buffer(np.frombuffer(raw, dtype=np.uint8).copy())


_OFFSET_BYTES = {TypeId.STRING: 4, TypeId.BINARY: 4, TypeId.LIST: 4,
                 TypeId.MAP: 4, TypeId.LARGE_STRING: 8,
                 TypeId.LARGE_BINARY: 8, TypeId.LARGE_LIST: 8}


def _buffer_sizes(t: DataType, a: ArrowArrayStruct) -> List[int]:
    """The bytes each buffer holds for ``a``'s offset and length; -1: a
    variable-size data buffer, as long as its last offset says."""
    n = a.length + a.offset
    tid = t.id
    validity = (n + 7) // 8
    if tid in (TypeId.NA, TypeId.RUN_END_ENCODED):
        return []
    if tid == TypeId.BOOL:
        return [validity, (n + 7) // 8]
    if tid == TypeId.DICTIONARY:
        return [validity, n * t.index_type.byte_width]
    if t.is_primitive:
        return [validity, n * max(t.bit_width // 8, 1)]
    if tid in (TypeId.STRING, TypeId.BINARY, TypeId.LARGE_STRING,
               TypeId.LARGE_BINARY):
        return [validity, (n + 1) * _OFFSET_BYTES[tid], -1]
    if tid in (TypeId.LIST, TypeId.MAP, TypeId.LARGE_LIST):
        return [validity, (n + 1) * _OFFSET_BYTES[tid]]
    if tid in (TypeId.LIST_VIEW, TypeId.LARGE_LIST_VIEW):
        w = 8 if tid == TypeId.LARGE_LIST_VIEW else 4
        return [validity, n * w, n * w]
    if tid in (TypeId.STRUCT, TypeId.FIXED_SIZE_LIST):
        return [validity]
    if tid == TypeId.SPARSE_UNION:
        return [n]
    if tid == TypeId.DENSE_UNION:
        return [n, n * 4]
    raise NotImplementedError(f"C ABI import of {t!r}")


def _import_views(a: ArrowArrayStruct) -> List[Optional[Buffer]]:
    """A view array's buffers: validity, views, then each variadic data
    buffer as long as the last buffer's sizes say."""
    n = a.length + a.offset
    nvar = a.n_buffers - 3
    sizes = [0] * nvar
    if nvar > 0 and a.buffers[a.n_buffers - 1]:
        sizes = np.frombuffer((ctypes.c_int64 * nvar).from_address(
            a.buffers[a.n_buffers - 1]), dtype=np.int64).tolist()
    return ([_copy(a.buffers[0], (n + 7) // 8), _copy(a.buffers[1], n * 16)]
            + [_copy(a.buffers[2 + i], sizes[i]) or Buffer(b"")
               for i in range(nvar)])


def _import_array_data(a: ArrowArrayStruct, t: DataType) -> ArrayData:
    if t.id in (TypeId.STRING_VIEW, TypeId.BINARY_VIEW):
        bufs = _import_views(a)
    else:
        bufs: List[Optional[Buffer]] = []
        for i, size in enumerate(_buffer_sizes(t, a)):
            ptr = a.buffers[i] if a.buffers else None
            if size == -1:  # a variable-size binary's data: to its end
                offsets = bufs[-1]
                if offsets is None:
                    bufs.append(None)
                    continue
                dt = np.int32 if _OFFSET_BYTES[t.id] == 4 else np.int64
                size = int(offsets.view(dt)[a.offset + a.length])
            bufs.append(_copy(ptr, size))
    children = [_import_array_data(a.children[i].contents, _child_type(t, i))
                for i in range(a.n_children)]
    dictionary = None
    if a.dictionary and t.id == TypeId.DICTIONARY:
        dictionary = _import_array_data(a.dictionary.contents, t.value_type)
    return ArrayData(t, a.length, bufs, children, null_count=a.null_count,
                     offset=a.offset, dictionary=dictionary)


def _child_type(t: DataType, i: int) -> DataType:
    if t.id in (TypeId.LIST, TypeId.LARGE_LIST, TypeId.MAP,
                TypeId.FIXED_SIZE_LIST, TypeId.LIST_VIEW,
                TypeId.LARGE_LIST_VIEW):
        return t.value_type
    return t.fields[i].type


_PyCapsule_GetPointer = ctypes.pythonapi.PyCapsule_GetPointer
_PyCapsule_GetPointer.restype = ctypes.c_void_p
_PyCapsule_GetPointer.argtypes = [ctypes.py_object, ctypes.c_char_p]


def _address(obj, name: bytes) -> int:
    """A struct's address: an int as it is, a capsule's pointer."""
    if isinstance(obj, int):
        return obj
    return _PyCapsule_GetPointer(obj, name)


def import_array(array, schema) -> Array:
    """An Array from an ArrowArray and an ArrowSchema, given by address or
    as capsules (``__arrow_c_array__``'s pair, array first). The buffers
    are copied and both producer structs released at once."""
    a_ptr = ctypes.cast(_address(array, b"arrow_array"), _ArrayPtr)
    s_ptr = ctypes.cast(_address(schema, b"arrow_schema"), _SchemaPtr)
    try:
        field = _import_field(s_ptr.contents)
        return Array(_import_array_data(a_ptr.contents, field.type))
    finally:
        if a_ptr.contents.release:
            a_ptr.contents.release(a_ptr)
        if s_ptr.contents.release:
            s_ptr.contents.release(s_ptr)


# --- the PyCapsule protocol -------------------------------------------------------

_PyCapsule_New = ctypes.pythonapi.PyCapsule_New
_PyCapsule_New.restype = ctypes.py_object
_PyCapsule_New.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p]
# the destructor's view of the capsule: a bare pointer (the capsule is
# being freed; it must not be made an object again)
_GetName = ctypes.PYFUNCTYPE(ctypes.c_void_p, ctypes.c_void_p)(
    ("PyCapsule_GetName", ctypes.pythonapi))
_GetPointer = ctypes.PYFUNCTYPE(ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_void_p)(
    ("PyCapsule_GetPointer", ctypes.pythonapi))
_SCHEMA_NAME = ctypes.c_char_p(b"arrow_schema")
_ARRAY_NAME = ctypes.c_char_p(b"arrow_array")
_STREAM_NAME = ctypes.c_char_p(b"arrow_array_stream")


def _capsule_destructor_impl(capsule):
    """Release the struct of a capsule that no consumer moved, then let
    its memory go."""
    try:
        ptr = _GetPointer(capsule, _GetName(capsule))
        struct_obj = _CAPSULES.pop(ptr, None)
        if struct_obj is not None and struct_obj.release:
            struct_obj.release(ctypes.pointer(struct_obj))
    except BaseException:  # noqa: BLE001 - nothing may cross the callback
        pass


_capsule_destructor = ctypes.CFUNCTYPE(None, ctypes.c_void_p)(
    _capsule_destructor_impl)


def _capsule(struct_obj, name: ctypes.c_char_p):
    addr = ctypes.addressof(struct_obj)
    _CAPSULES[addr] = struct_obj
    return _PyCapsule_New(addr, name,
                          ctypes.cast(_capsule_destructor, ctypes.c_void_p))


def array_capsules(arr: Array):
    """(schema capsule, array capsule) of the Arrow PyCapsule interface
    (``__arrow_c_array__``)."""
    sch, a = ArrowSchemaStruct(), ArrowArrayStruct()
    export_array(arr, ctypes.addressof(a), ctypes.addressof(sch))
    return _capsule(sch, _SCHEMA_NAME), _capsule(a, _ARRAY_NAME)


def _stream_state(stream_ptr):
    return _STREAMS.get(stream_ptr.contents.private_data)


def _fail(state, exc) -> int:
    if state is not None:
        state["error"] = ctypes.create_string_buffer(
            f"{type(exc).__name__}: {exc}".encode())
    return _EIO


def _stream_get_schema_impl(stream_ptr, schema_out):
    state = None
    try:
        state = _stream_state(stream_ptr)
        if state is None:
            return _EINVAL
        _export_schema_into(state["schema_field"], schema_out.contents)
        return 0
    except BaseException as exc:  # noqa: BLE001 - nothing may cross
        return _fail(state, exc)


def _stream_get_next_impl(stream_ptr, array_out):
    state = None
    try:
        state = _stream_state(stream_ptr)
        if state is None:
            return _EINVAL
        out = array_out.contents
        if not state["batches"]:
            out.release = _ReleaseArray()  # the end of the stream
            return 0
        _export_array_into(state["batches"].pop(0), out)
        return 0
    except BaseException as exc:  # noqa: BLE001 - nothing may cross
        return _fail(state, exc)


def _stream_get_last_error_impl(stream_ptr):
    try:
        state = _stream_state(stream_ptr)
        err = None if state is None else state.get("error")
        return None if err is None else ctypes.addressof(err)
    except BaseException:  # noqa: BLE001 - nothing may cross
        return None


def _stream_release_impl(stream_ptr):
    try:
        s = stream_ptr.contents
        _STREAMS.pop(s.private_data, None)
        s.release = _ReleaseStream()
    except BaseException:  # noqa: BLE001 - nothing may cross
        pass


_stream_get_schema = _GetSchema(_stream_get_schema_impl)
_stream_get_next = _GetNext(_stream_get_next_impl)
_stream_get_last_error = _GetLastError(_stream_get_last_error_impl)
_stream_release = _ReleaseStream(_stream_release_impl)


def stream_capsule(batches, schema_field: Field):
    """An ``arrow_array_stream`` capsule over ``batches``: struct-typed
    ArrayData, one a RecordBatch (``batch_to_struct_data``). A batch is
    let go once the consumer has taken it."""
    _check_exportable(schema_field.type)  # an unexportable type raises here
    stream = ArrowArrayStreamStruct()
    stream.get_schema = _stream_get_schema
    stream.get_next = _stream_get_next
    stream.get_last_error = _stream_get_last_error
    key = next(_ids)
    _STREAMS[key] = {"schema_field": schema_field, "batches": list(batches)}
    stream.private_data = key
    stream.release = _stream_release
    return _capsule(stream, _STREAM_NAME)


def _check_exportable(t: DataType) -> None:
    format_for_type(t)
    for f in (t.value_type.fields if t.id == TypeId.DICTIONARY
              else t.fields):
        _check_exportable(f.type)


def batch_to_struct_data(rb) -> ArrayData:
    """A RecordBatch as the struct-typed ArrayData a C stream carries."""
    return ArrayData(T.StructType(list(rb.schema.fields)), rb.num_rows,
                     [None], [c.data for c in rb.columns], null_count=0)


class _ImportedStream:
    """A stream moved out of its capsule into memory of ours; released
    once, at the end of its reader's batches, at ``close`` or when
    dropped."""

    def __init__(self, capsule):
        src = ctypes.cast(_PyCapsule_GetPointer(capsule, b"arrow_array_stream"),
                          _StreamPtr)
        if not src.contents.release:
            raise ValueError("the stream was released or moved")
        self.stream = ArrowArrayStreamStruct()
        ctypes.memmove(ctypes.addressof(self.stream),
                       ctypes.addressof(src.contents),
                       ctypes.sizeof(ArrowArrayStreamStruct))
        src.contents.release = _ReleaseStream()  # moved
        self.ptr = ctypes.pointer(self.stream)

    def error(self, what: str, rc: int) -> OSError:
        msg = self.stream.get_last_error(self.ptr)
        detail = ctypes.string_at(msg).decode("utf-8", "replace") \
            if msg else ""
        return OSError(f"ArrowArrayStream.{what} failed ({rc}): {detail}")

    def release(self) -> None:
        if self.stream.release:
            self.stream.release(self.ptr)

    def __del__(self):
        try:
            self.release()
        except BaseException:  # noqa: BLE001 - at interpreter exit
            pass


def import_stream_capsule(capsule):
    """A RecordBatchReader over an ``arrow_array_stream`` capsule of any
    producer (c/bridge.cc ImportRecordBatchReader): the stream is moved
    out of the capsule, each batch copied and released as it is read,
    the stream released when the batches end or the reader closes."""
    from .table import RecordBatch, RecordBatchReader
    owner = _ImportedStream(capsule)
    try:
        sch = ArrowSchemaStruct()
        rc = owner.stream.get_schema(owner.ptr, ctypes.pointer(sch))
        if rc != 0:
            raise owner.error("get_schema", rc)
        try:
            root = _import_field(sch)
        finally:
            if sch.release:
                sch.release(ctypes.pointer(sch))
    except BaseException:
        owner.release()
        raise
    schema = T.Schema(list(root.type.fields))

    def batches():
        try:
            while True:
                a = ArrowArrayStruct()
                rc = owner.stream.get_next(owner.ptr, ctypes.pointer(a))
                if rc != 0:
                    raise owner.error("get_next", rc)
                if not a.release:
                    return
                try:
                    data = _import_array_data(a, root.type)
                finally:
                    a.release(ctypes.pointer(a))
                yield RecordBatch(schema, [
                    Array(c if c.offset == 0 and data.offset == 0
                          and c.length == data.length
                          else c.slice(data.offset, data.length))
                    for c in data.children])
        finally:
            owner.release()

    return RecordBatchReader(schema, batches())
