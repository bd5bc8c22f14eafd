"""DataType, Field and Schema to and from the IPC flatbuffers (counterpart of
``arrow_tpu/ipc/schema_fb.py``; reference: format/Schema.fbs).

Every type of the port's ``types.py`` round-trips. An extension type is
written as its storage type with the ``ARROW:extension:name`` and
``ARROW:extension:metadata`` field keys; a reader rebuilds a registered
name (``extension.reconstruct``) and reads any other as its storage type,
the keys dropped either way, as the reference does.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .. import types as T
from ..types import DataType, Field, Schema, TypeId
from . import fb
from .fb import Builder, Reader, _kv_vector, _offset_vector, _table, read_kv

_TIMEUNIT_TO_CODE = {"s": 0, "ms": 1, "us": 2, "ns": 3}
_EXTENSION = b"ARROW:extension:"


class DictionaryFieldMapper:
    """Dictionary ids of the dictionary-typed fields, by their pre-order
    position in the schema (reference: cpp/src/arrow/ipc/dictionary.h)."""

    def __init__(self):
        self.id_to_type: Dict[int, DataType] = {}
        # the ids in schema pre-order; batch readers and writers walk the
        # columns in the same order to pair fields with dictionaries
        self.ordered_ids: List[int] = []
        self._next = 0

    def next_id(self, type: DataType) -> int:
        i = self._next
        self._next += 1
        self.id_to_type[i] = type
        self.ordered_ids.append(i)
        return i


def _int_table(b: Builder, t: DataType) -> int:
    return _table(b, 2, [(1, "bool", t.is_signed_integer, False),
                         (0, "i32", t.bit_width, 0)])


_EMPTY = {TypeId.NA: fb.TYPE_NULL, TypeId.BOOL: fb.TYPE_BOOL,
          TypeId.STRING: fb.TYPE_UTF8, TypeId.BINARY: fb.TYPE_BINARY,
          TypeId.LARGE_STRING: fb.TYPE_LARGEUTF8,
          TypeId.LARGE_BINARY: fb.TYPE_LARGEBINARY,
          TypeId.LIST: fb.TYPE_LIST, TypeId.LARGE_LIST: fb.TYPE_LARGELIST,
          TypeId.STRUCT: fb.TYPE_STRUCT,
          TypeId.RUN_END_ENCODED: fb.TYPE_RUNENDENCODED}
_VIEWS = {TypeId.STRING_VIEW: fb.TYPE_UTF8VIEW,
          TypeId.BINARY_VIEW: fb.TYPE_BINARYVIEW,
          TypeId.LIST_VIEW: fb.TYPE_LISTVIEW,
          TypeId.LARGE_LIST_VIEW: fb.TYPE_LARGELISTVIEW}
_INTERVALS = {TypeId.INTERVAL_MONTHS: 0, TypeId.INTERVAL_DAY_TIME: 1,
              TypeId.INTERVAL_MONTH_DAY_NANO: 2}


def _write_type(b: Builder, t: DataType) -> Tuple[int, int]:
    """(the type's discriminant, its table's offset)."""
    tid = t.id
    if tid == TypeId.DICTIONARY:
        # the wire type is the value type; the encoding is the Field's
        return _write_type(b, t.value_type)
    if tid in _EMPTY:
        return _EMPTY[tid], _table(b, 0, [])
    if t.is_integer:
        return fb.TYPE_INT, _int_table(b, t)
    if t.is_floating:
        prec = {TypeId.HALF_FLOAT: 0, TypeId.FLOAT: 1, TypeId.DOUBLE: 2}[tid]
        return fb.TYPE_FLOATINGPOINT, _table(b, 1, [(0, "i16", prec, 0)])
    if t.is_decimal:
        return fb.TYPE_DECIMAL, _table(b, 3, [
            (2, "i32", t.bit_width, 128), (1, "i32", t.scale, 0),
            (0, "i32", t.precision, 0)])
    if tid == TypeId.FIXED_SIZE_BINARY:
        return fb.TYPE_FIXEDSIZEBINARY, _table(b, 1, [
            (0, "i32", t.byte_width, 0)])
    if tid in (TypeId.DATE32, TypeId.DATE64):
        return fb.TYPE_DATE, _table(b, 1, [
            (0, "i16", int(tid == TypeId.DATE64), 1)])
    if tid in (TypeId.TIME32, TypeId.TIME64):
        return fb.TYPE_TIME, _table(b, 2, [
            (1, "i32", t.bit_width, 32),
            (0, "i16", _TIMEUNIT_TO_CODE[t.unit], 1)])
    if tid == TypeId.TIMESTAMP:
        tz = b.create_string(t.tz) if t.tz else 0
        return fb.TYPE_TIMESTAMP, _table(b, 2, [
            (1, "off", tz, 0), (0, "i16", _TIMEUNIT_TO_CODE[t.unit], 0)])
    if tid == TypeId.DURATION:
        return fb.TYPE_DURATION, _table(b, 1, [
            (0, "i16", _TIMEUNIT_TO_CODE[t.unit], 1)])
    if tid in _INTERVALS:
        return fb.TYPE_INTERVAL, _table(b, 1, [
            (0, "i16", _INTERVALS[tid], 0)])
    if tid == TypeId.FIXED_SIZE_LIST:
        return fb.TYPE_FIXEDSIZELIST, _table(b, 1, [
            (0, "i32", t.list_size, 0)])
    if tid == TypeId.MAP:
        # the port's maps are unsorted (keys_sorted false)
        return fb.TYPE_MAP, _table(b, 1, [(0, "bool", False, False)])
    if tid in (TypeId.SPARSE_UNION, TypeId.DENSE_UNION):
        b.start_vector(4, len(t.type_codes), 4)
        for c in reversed(t.type_codes):
            b.prepend_int32(c)
        codes = b.end_vector()
        return fb.TYPE_UNION, _table(b, 2, [
            (1, "off", codes, 0),
            (0, "i16", int(tid == TypeId.DENSE_UNION), 0)])
    if tid in _VIEWS:
        return _VIEWS[tid], _table(b, 0, [])
    raise NotImplementedError(f"IPC write for {t!r}")


def write_field(b: Builder, f: Field, mapper: DictionaryFieldMapper) -> int:
    t = f.type
    if t.id == TypeId.EXTENSION:
        md = dict(f.metadata or {})
        md[_EXTENSION + b"name"] = t.extension_name.encode()
        md[_EXTENSION + b"metadata"] = t.extension_metadata()
        f = Field(f.name, t.storage_type, f.nullable, md)
        t = f.type
    dict_off = 0
    if t.id == TypeId.DICTIONARY:
        did = mapper.next_id(t)
        int_off = _int_table(b, t.index_type)
        dict_off = _table(b, 4, [
            (3, "i16", 0, 0), (2, "bool", False, False),
            (1, "off", int_off, 0), (0, "i64", did, 0)])
        child_source = t.value_type
    else:
        child_source = t
    children = [write_field(b, cf, mapper) for cf in child_source.fields]
    children_vec = _offset_vector(b, children) if children else 0
    type_disc, type_off = _write_type(b, t)
    name_off = b.create_string(f.name) if f.name is not None else 0
    md_off = _kv_vector(b, f.metadata)
    return _table(b, 7, [
        (6, "off", md_off, 0),
        (5, "off", children_vec, 0),
        (4, "off", dict_off, 0),
        (3, "off", type_off, 0),
        (2, "u8", type_disc, 0),
        (1, "bool", f.nullable, False),
        (0, "off", name_off, 0),
    ])


def write_schema(b: Builder, schema: Schema,
                 mapper: DictionaryFieldMapper) -> int:
    fields = [write_field(b, f, mapper) for f in schema.fields]
    fields_vec = _offset_vector(b, fields)
    md_off = _kv_vector(b, schema.metadata)
    return _table(b, 4, [
        (2, "off", md_off, 0),
        (1, "off", fields_vec, 0),
        (0, "i16", 0, 0),  # endianness = Little
    ])


# --- reading -----------------------------------------------------------------

_INTS = {(8, True): T.int8, (16, True): T.int16, (32, True): T.int32,
         (64, True): T.int64, (8, False): T.uint8, (16, False): T.uint16,
         (32, False): T.uint32, (64, False): T.uint64}
_SIMPLE = {fb.TYPE_NULL: T.null, fb.TYPE_BOOL: T.bool_,
           fb.TYPE_UTF8: T.string, fb.TYPE_BINARY: T.binary,
           fb.TYPE_LARGEUTF8: T.large_string,
           fb.TYPE_LARGEBINARY: T.large_binary}


def _read_type(disc: int, r: Optional[Reader],
               children: List[Field]) -> DataType:
    if disc in _SIMPLE:
        return _SIMPLE[disc]()
    if disc == fb.TYPE_INT:
        return _INTS[(r.i32(0), r.bool_(1))]()
    if disc == fb.TYPE_FLOATINGPOINT:
        return [T.float16, T.float32, T.float64][r.i16(0)]()
    if disc == fb.TYPE_DECIMAL:
        mk = {32: T.decimal32, 64: T.decimal64, 128: T.decimal128,
              256: T.decimal256}[r.i32(2, 128)]
        return mk(r.i32(0), r.i32(1))
    if disc == fb.TYPE_FIXEDSIZEBINARY:
        return T.fixed_size_binary(r.i32(0))
    if disc == fb.TYPE_DATE:
        return T.date32() if r.i16(0, 1) == 0 else T.date64()
    if disc == fb.TYPE_TIME:
        unit = fb.TIMEUNIT[r.i16(0, 1)]
        return T.time32(unit) if r.i32(1, 32) == 32 else T.time64(unit)
    if disc == fb.TYPE_TIMESTAMP:
        tz = r.string(1)
        return T.timestamp(fb.TIMEUNIT[r.i16(0)], tz.decode() if tz else None)
    if disc == fb.TYPE_DURATION:
        return T.duration(fb.TIMEUNIT[r.i16(0, 1)])
    if disc == fb.TYPE_INTERVAL:
        return [T.month_interval, T.day_time_interval,
                T.month_day_nano_interval][r.i16(0)]()
    if disc == fb.TYPE_LIST:
        return T.ListType(children[0])
    if disc == fb.TYPE_LARGELIST:
        return T.ListType(children[0], TypeId.LARGE_LIST)
    if disc == fb.TYPE_FIXEDSIZELIST:
        return T.FixedSizeListType(children[0], r.i32(0))
    if disc == fb.TYPE_MAP:
        entries = children[0].type
        return T.map_(entries.fields[0].type, entries.fields[1].type)
    if disc == fb.TYPE_STRUCT:
        return T.StructType(children)
    if disc == fb.TYPE_RUNENDENCODED:
        return T.RunEndEncodedType(children[0].type, children[1].type)
    if disc == fb.TYPE_UNION:
        codes = r.vector_i32(1) or list(range(len(children)))
        return T.UnionType(children, codes,
                           "sparse" if r.i16(0) == 0 else "dense")
    if disc == fb.TYPE_UTF8VIEW:
        return T.string_view()
    if disc == fb.TYPE_BINARYVIEW:
        return T.binary_view()
    if disc == fb.TYPE_LISTVIEW:
        return T.ListType(children[0], TypeId.LIST_VIEW)
    if disc == fb.TYPE_LARGELISTVIEW:
        return T.ListType(children[0], TypeId.LARGE_LIST_VIEW)
    raise NotImplementedError(f"IPC read for type discriminant {disc}")


def read_field(r: Reader, mapper: DictionaryFieldMapper) -> Field:
    name = r.string(0)
    nullable = r.bool_(1)
    disc = r.u8(2)
    children = [read_field(r.vector_table(5, i), mapper)
                for i in range(r.vector_len(5))]
    t = _read_type(disc, r.table(3), children)
    enc = r.table(4)
    if enc is not None:
        did = enc.i64(0)
        idx_r = enc.table(1)
        index_type = T.int32() if idx_r is None else \
            _read_type(fb.TYPE_INT, idx_r, [])
        t = T.dictionary(index_type, t)
        mapper.id_to_type[did] = t
        mapper.ordered_ids.append(did)
    md = read_kv(r, 6)
    if md and _EXTENSION + b"name" in md:
        from ..extension import reconstruct
        t = reconstruct(t, md[_EXTENSION + b"name"].decode(),
                        md.get(_EXTENSION + b"metadata", b""))
        md = {k: v for k, v in md.items()
              if not k.startswith(_EXTENSION)} or None
    return Field(name.decode() if name else "", t, nullable, md)


def read_schema(r: Reader, mapper: DictionaryFieldMapper) -> Schema:
    fields = [read_field(r.vector_table(1, i), mapper)
              for i in range(r.vector_len(1))]
    return Schema(fields, read_kv(r, 2))
