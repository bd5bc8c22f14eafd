"""Feather V1, the legacy pre-IPC format (counterpart of
``arrow_tpu/io/feather_v1.py``; reference: cpp/src/arrow/ipc/feather.cc,
the V1 reader and writer, and its vendored fbs/feather.fbs), over the
port's own flatbuffer runtime (``ipc/fb.py``).

Layout: "FEA1" + 4 pad | one 8-aligned block a column | CTable flatbuffer
| uint32 metadata length | "FEA1".

CTable {0: description str, 1: num_rows i64, 2: columns [Column],
3: version i32, 4: metadata str}; Column {0: name str, 1: values
PrimitiveArray}; PrimitiveArray {0: type i8, 1: encoding i8, 2: offset
i64, 3: length i64, 4: null_count i64, 5: total_bytes i64}. A column's
block: [null bitmap, LSB first, padded to 8] [values: int32 offsets then
the data for UTF8/BINARY, packed bits for BOOL], each part 8-aligned.

The writer gives the reference's bytes. The reader takes the bytes of a
file, or a ``MemoryMappedFile``, and its Buffers are slices of them, not
copies (a departure for speed, with the same results).
"""

from __future__ import annotations

import struct
from typing import List

import numpy as np

from .. import types as T
from ..array.array import Array
from ..array.data import ArrayData
from ..buffer import Buffer
from ..ipc.fb import Builder, Reader, _table
from ..table import RecordBatch, Table
from ..types import Field, Schema, TypeId
from ..utils import bits as bitutil

MAGIC = b"FEA1"

_TYPE_TO_V1 = {
    TypeId.BOOL: 0, TypeId.INT8: 1, TypeId.INT16: 2, TypeId.INT32: 3,
    TypeId.INT64: 4, TypeId.UINT8: 5, TypeId.UINT16: 6, TypeId.UINT32: 7,
    TypeId.UINT64: 8, TypeId.FLOAT: 9, TypeId.DOUBLE: 10,
    TypeId.STRING: 11, TypeId.BINARY: 12,
}
_V1_TO_TYPE = {
    0: T.bool_, 1: T.int8, 2: T.int16, 3: T.int32, 4: T.int64,
    5: T.uint8, 6: T.uint16, 7: T.uint32, 8: T.uint64,
    9: T.float32, 10: T.float64, 11: T.string, 12: T.binary,
}


def _pad8(n: int) -> int:
    return (n + 7) & ~7


def _as_bytes(a: np.ndarray) -> memoryview:
    return memoryview(np.ascontiguousarray(a).view(np.uint8).reshape(-1))


def write_feather_v1(table: Table, sink) -> None:
    close = isinstance(sink, str)
    if close:
        sink = open(sink, "wb")
    sink.write(MAGIC + bytes(4))
    pos = 8
    cols_meta = []
    for f, col in zip(table.schema, table.columns):
        arr = col.combine()
        v1t = _TYPE_TO_V1.get(f.type.id)
        if v1t is None:
            raise NotImplementedError(f"feather v1 cannot store {f.type!r}")
        d = arr.data
        nulls = arr.null_count
        parts = []
        if nulls > 0:
            parts.append(bitutil.pack_bits(d.validity_mask()))
        if f.type.id in (TypeId.STRING, TypeId.BINARY):
            parts += [d.offsets().astype(np.int32), d.data_bytes()]
        elif f.type.id == TypeId.BOOL:
            parts.append(bitutil.pack_bits(d.values()))
        else:
            parts.append(d.values())
        size = 0
        for p in parts:
            raw = _as_bytes(p)
            sink.write(raw)
            sink.write(bytes(_pad8(len(raw)) - len(raw)))
            size += _pad8(len(raw))
        cols_meta.append((f.name, v1t, pos, len(arr), nulls, size))
        pos += size

    b = Builder(512)
    col_offs = []
    for name, v1t, off, n, nulls, nbytes in cols_meta:
        arr_off = _table(b, 6, [
            (5, "i64", nbytes, 0), (4, "i64", nulls, 0),
            (3, "i64", n, 0), (2, "i64", off, 0),
            (1, "i8", 0, 0), (0, "i8", v1t, 0)])
        name_off = b.create_string(name)
        col_offs.append(_table(b, 2, [(1, "off", arr_off, 0),
                                      (0, "off", name_off, 0)]))
    b.start_vector(4, len(col_offs), 4)
    for off in reversed(col_offs):
        b.prepend_uoffset(off)
    cols_vec = b.end_vector()
    meta = b.finish(_table(b, 5, [
        (3, "i32", 2, 0),                 # version
        (2, "off", cols_vec, 0),
        (1, "i64", table.num_rows, 0)]))
    sink.write(meta)
    sink.write(struct.pack("<I", len(meta)))
    sink.write(MAGIC)
    if close:
        sink.close()


def _raw(source) -> np.ndarray:
    from ..io_streams import MemoryMappedFile
    if isinstance(source, MemoryMappedFile):
        return source.mapped()
    if isinstance(source, np.ndarray):
        return source.view(np.uint8).reshape(-1)
    return np.frombuffer(source, dtype=np.uint8)


def is_feather_v1(raw) -> bool:
    raw = _raw(raw)
    return raw.size > 12 and raw[:4].tobytes() == MAGIC \
        and raw[-4:].tobytes() == MAGIC


def read_feather_v1(source) -> Table:
    raw = _raw(source)
    if not is_feather_v1(raw):
        raise ValueError("not a feather v1 file")
    (meta_len,) = struct.unpack("<I", raw[-8:-4].tobytes())
    ct = Reader.root(raw[raw.size - 8 - meta_len:raw.size - 8].tobytes())
    num_rows = ct.i64(1)
    fields: List[Field] = []
    arrays: List[Array] = []
    for i in range(ct.vector_len(2)):
        col = ct.vector_table(2, i)
        name = (col.string(0) or b"").decode()
        pa_ = col.table(1)
        v1t, pos, n, nulls = pa_.i8(0), pa_.i64(2), pa_.i64(3), pa_.i64(4)
        if v1t not in _V1_TO_TYPE:
            raise NotImplementedError(f"feather v1 type {v1t}")
        t = _V1_TO_TYPE[v1t]()
        vbuf = None
        if nulls > 0:
            bm_len = (n + 7) // 8
            vbuf = Buffer(raw[pos:pos + bm_len])
            pos += _pad8(bm_len)
        if t.id in (TypeId.STRING, TypeId.BINARY):
            ob_len = 4 * (n + 1)
            offs = raw[pos:pos + ob_len]
            pos += _pad8(ob_len)
            nbytes = int(offs.view(np.int32)[-1])
            bufs = [vbuf, Buffer(offs), Buffer(raw[pos:pos + nbytes])]
        elif t.id == TypeId.BOOL:
            bufs = [vbuf, Buffer(raw[pos:pos + (n + 7) // 8])]
        else:
            bufs = [vbuf, Buffer(raw[pos:pos + n * (t.bit_width // 8)])]
        fields.append(Field(name, t, nullable=True))
        arrays.append(Array(ArrayData(t, n, bufs, null_count=nulls)))
    tbl = Table.from_batches([RecordBatch(Schema(fields), arrays)])
    if tbl.num_rows != num_rows:
        raise ValueError("feather v1: the columns' rows differ from the "
                         "table's")
    return tbl
