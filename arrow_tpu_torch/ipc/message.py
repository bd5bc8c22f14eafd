"""IPC messages: record batches serialized and framed, and loaded back
(counterpart of ``arrow_tpu/ipc/message.py``; reference:
cpp/src/arrow/ipc/message.h:577, writer.cc:146, reader.cc:173).

Framing: <0xFFFFFFFF continuation><int32 metadata size><flatbuffer
metadata padded to 8><body, each buffer padded to 8>; the end of a stream
is the continuation and a zero length.

A body keeps zero-copy views of the columns' buffers until the sink copies
each once. With a codec, each buffer is compressed alone (its uncompressed
length as an int64 first, -1 where it is stored as it is). One departure
for speed, with the same results: a loader over a mapped body gives
Buffers that are slices of the map, not copies, and ``skip`` passes over a
column without touching its buffers, so a reader loads only the columns it
is asked for.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..array.data import ArrayData
from ..buffer import Buffer
from ..types import DataType, TypeId
from ..utils import bits as bitutil
from ..utils import lz4frame
from . import fb
from .fb import Builder, Reader, _table

CONTINUATION = 0xFFFFFFFF
ALIGNMENT = 8

try:
    import zstandard as _zstd
except ImportError:  # the card's machine has none
    _zstd = None

_INTERVAL_PAIRS = (TypeId.INTERVAL_DAY_TIME, TypeId.INTERVAL_MONTH_DAY_NANO)
_VAR_BINARY = (TypeId.STRING, TypeId.BINARY, TypeId.LARGE_STRING,
               TypeId.LARGE_BINARY)
_LISTS = (TypeId.LIST, TypeId.MAP, TypeId.LARGE_LIST)
_UNIONS = (TypeId.SPARSE_UNION, TypeId.DENSE_UNION)
_BINARY_VIEWS = (TypeId.STRING_VIEW, TypeId.BINARY_VIEW)
_LIST_VIEWS = (TypeId.LIST_VIEW, TypeId.LARGE_LIST_VIEW)
_PAIR = np.dtype([("a", "<i8"), ("b", "<i8")])


def _pad_to(n: int, align: int = ALIGNMENT) -> int:
    return (n + align - 1) // align * align


def _as_bytes(data) -> memoryview:
    """bytes, a memoryview or a numpy array as a flat byte view, without a
    copy where it is contiguous."""
    if isinstance(data, np.ndarray):
        return memoryview(np.ascontiguousarray(data).view(np.uint8)
                          .reshape(-1))
    return memoryview(data).cast("B")


class BufferedBody:
    """The body buffers of a message, each given its padded offset."""

    def __init__(self, codec: Optional[str] = None):
        self.parts: List[memoryview] = []
        self.layout: List[Tuple[int, int]] = []  # (offset, length)
        self.pos = 0
        self.codec = codec
        # a view column's count of data buffers (the RecordBatch's
        # variadicBufferCounts)
        self.variadic_counts: List[int] = []
        if codec == "zstd" and _zstd is None:
            raise ValueError("zstandard not available")

    def add(self, data):
        if data is None or len(data) == 0:
            self.layout.append((self.pos, 0))  # a zero-length placeholder
            return
        pieces = [_as_bytes(data)]
        if self.codec is not None:
            raw = pieces[0]
            comp = (_zstd.ZstdCompressor().compress(raw)
                    if self.codec == "zstd" else lz4frame.compress_array(raw))
            pieces = [struct.pack("<q", len(raw)), comp] \
                if len(comp) < len(raw) else [struct.pack("<q", -1), raw]
            pieces = [_as_bytes(p) for p in pieces]
        ln = sum(len(p) for p in pieces)
        self.layout.append((self.pos, ln))
        self.parts.extend(pieces)
        padded = _pad_to(ln)
        if padded > ln:
            self.parts.append(memoryview(bytes(padded - ln)))
        self.pos += padded

    def body(self) -> bytes:
        return b"".join(self.parts)


def _validity_bytes(d: ArrayData) -> Optional[np.ndarray]:
    if d.null_count == 0:
        return None
    return bitutil.pack_bits(d.validity_mask())


def serialize_array(d: ArrayData, nodes: List[Tuple[int, int]],
                    body: BufferedBody):
    """Append the field nodes and body buffers of ``d`` in pre-order
    (RecordBatchSerializer::VisitArray, ipc/writer.cc:146)."""
    t = d.type
    if t.id == TypeId.EXTENSION:
        storage = d.copy()
        storage.type = t.storage_type
        serialize_array(storage, nodes, body)
        return
    tid = t.id
    nodes.append((d.length, d.null_count))
    if tid == TypeId.NA:
        return
    if tid in _UNIONS:
        body.add(d.type_ids())
        if tid == TypeId.DENSE_UNION:
            body.add(d.buffers[1].view(np.int32)[d.offset:
                                                 d.offset + d.length])
            for c in d.children:
                serialize_array(c, nodes, body)
        else:
            for c in d.children:
                serialize_array(c.slice(d.offset, d.length), nodes, body)
        return
    if tid == TypeId.RUN_END_ENCODED:
        for c in d.children:
            serialize_array(c, nodes, body)
        return
    body.add(_validity_bytes(d))
    if tid in _BINARY_VIEWS:
        views = d.buffers[1].to_numpy().reshape(-1, 16)
        body.add(views[d.offset:d.offset + d.length])
        data_bufs = d.buffers[2:]
        body.variadic_counts.append(len(data_bufs))
        for db in data_bufs:
            body.add(None if db is None else db.to_numpy())
    elif tid in _LIST_VIEWS:
        dt = np.int64 if tid == TypeId.LARGE_LIST_VIEW else np.int32
        body.add(d.buffers[1].view(dt)[d.offset:d.offset + d.length])
        body.add(d.buffers[2].view(dt)[d.offset:d.offset + d.length])
        serialize_array(d.children[0], nodes, body)
    elif tid == TypeId.BOOL:
        body.add(bitutil.pack_bits(d.values()))
    elif tid in _INTERVAL_PAIRS:
        w = t.bit_width // 8
        raw = d.buffers[1].to_numpy()
        body.add(raw[d.offset * w:(d.offset + d.length) * w])
    elif tid in _VAR_BINARY:
        offs = d.offsets()
        start, end = int(offs[0]), int(offs[-1])
        body.add((offs - start) if start else offs)
        body.add(d.data_bytes()[start:end])
    elif tid in _LISTS:
        offs = d.offsets()
        start, end = int(offs[0]), int(offs[-1])
        body.add((offs - start) if start else offs)
        serialize_array(d.children[0].slice(start, end - start), nodes, body)
    elif tid == TypeId.FIXED_SIZE_LIST:
        sz = t.list_size
        serialize_array(d.children[0].slice(d.offset * sz, d.length * sz),
                        nodes, body)
    elif tid == TypeId.STRUCT:
        for c in d.children:
            serialize_array(c.slice(d.offset, d.length), nodes, body)
    else:  # the fixed-width types and a dictionary's indices
        body.add(d.values())


def _struct_vector(b: Builder, pairs: Sequence[Tuple[int, int]]) -> int:
    """A vector of 16-byte structs of two int64s (FieldNode: length,
    null count; Buffer: offset, length)."""
    b.start_vector(16, len(pairs), 8)
    for first, second in reversed(pairs):
        b.prep(8, 16)
        b.prepend_int64(second)
        b.prepend_int64(first)
    return b.end_vector()


def _write_record_batch_fb(b: Builder, length: int,
                           nodes: Sequence[Tuple[int, int]],
                           layout: Sequence[Tuple[int, int]],
                           codec: Optional[str],
                           variadic_counts: Sequence[int] = ()) -> int:
    """A RecordBatch table; ``variadic_counts``: the view columns' data
    buffers, one count a column."""
    nodes_vec = _struct_vector(b, nodes)
    buffers_vec = _struct_vector(b, layout)
    comp_off = 0
    if codec is not None:
        method = fb.COMPRESSION_ZSTD if codec == "zstd" else \
            fb.COMPRESSION_LZ4_FRAME
        comp_off = _table(b, 2, [(1, "i8", 0, 0), (0, "i8", method, 0)])
    var_vec = 0
    if variadic_counts:
        b.start_vector(8, len(variadic_counts), 8)
        for c in reversed(variadic_counts):
            b.prepend_int64(c)
        var_vec = b.end_vector()
    return _table(b, 5, [
        (4, "off", var_vec, 0),
        (3, "off", comp_off, 0),
        (2, "off", buffers_vec, 0),
        (1, "off", nodes_vec, 0),
        (0, "i64", length, 0),
    ])


def _finish_message(b: Builder, header_type: int, header_off: int,
                    body_length: int) -> bytes:
    msg = _table(b, 5, [
        (3, "i64", body_length, 0),
        (2, "off", header_off, 0),
        (1, "u8", header_type, 0),
        (0, "i16", fb.METADATA_V5, 0),
    ])
    return b.finish(msg)


def encapsulate(metadata: bytes) -> bytes:
    """Flatbuffer metadata in the stream's framing."""
    padded_len = _pad_to(8 + len(metadata)) - 8
    return (struct.pack("<II", CONTINUATION, padded_len) + metadata
            + bytes(padded_len - len(metadata)))


EOS = struct.pack("<II", CONTINUATION, 0)


def serialize_schema_message(schema, mapper) -> bytes:
    from .schema_fb import write_schema
    b = Builder(1024)
    off = write_schema(b, schema, mapper)
    return encapsulate(_finish_message(b, fb.MSG_SCHEMA, off, 0))


def serialize_record_batch_parts(columns: Sequence[ArrayData], num_rows: int,
                                 codec: Optional[str] = None
                                 ) -> Tuple[bytes, List[memoryview]]:
    """(the framed metadata, the body's parts): the parts are views of the
    columns' buffers (or their compressed forms), for a sink to copy each
    once (WriteIpcPayload, ipc/writer.cc:773)."""
    nodes: List[Tuple[int, int]] = []
    body = BufferedBody(codec)
    for col in columns:
        serialize_array(col, nodes, body)
    b = Builder(1024)
    rb_off = _write_record_batch_fb(b, num_rows, nodes, body.layout, codec,
                                    body.variadic_counts)
    meta = _finish_message(b, fb.MSG_RECORD_BATCH, rb_off, body.pos)
    return encapsulate(meta), body.parts


def serialize_record_batch(columns: Sequence[ArrayData], num_rows: int,
                           codec: Optional[str] = None) -> Tuple[bytes, bytes]:
    """(the framed metadata, the body's bytes)."""
    meta, parts = serialize_record_batch_parts(columns, num_rows, codec)
    return meta, b"".join(parts)


def serialize_dictionary_batch(dict_id: int, dictionary: ArrayData,
                               codec: Optional[str] = None,
                               is_delta: bool = False) -> Tuple[bytes, bytes]:
    nodes: List[Tuple[int, int]] = []
    body = BufferedBody(codec)
    serialize_array(dictionary, nodes, body)
    body_bytes = body.body()
    b = Builder(1024)
    rb_off = _write_record_batch_fb(b, dictionary.length, nodes, body.layout,
                                    codec, body.variadic_counts)
    db_off = _table(b, 3, [
        (2, "bool", is_delta, False),
        (1, "off", rb_off, 0),
        (0, "i64", dict_id, 0),
    ])
    meta = _finish_message(b, fb.MSG_DICTIONARY_BATCH, db_off,
                           len(body_bytes))
    return encapsulate(meta), body_bytes


# --- parsing -----------------------------------------------------------------

class Message:
    __slots__ = ("header_type", "header", "body_length", "body")

    def __init__(self, header_type, header, body_length, body):
        self.header_type = header_type
        self.header = header
        self.body_length = body_length
        self.body = body


def parse_message_meta(meta) -> Tuple[int, Reader, int]:
    """(header type, the header's reader, body length)."""
    r = Reader.root(meta)
    return r.u8(1), r.union(2), r.i64(3)


class RecordBatchMeta:
    __slots__ = ("length", "nodes", "buffers", "codec", "variadic_counts")

    def __init__(self, r: Reader):
        self.length = r.i64(0)
        self.nodes = r.vector_structs(1, _PAIR).tolist()
        self.buffers = r.vector_structs(2, _PAIR).tolist()
        self.variadic_counts = r.vector_i64(4)
        comp = r.table(3)
        self.codec = None
        if comp is not None:
            self.codec = {0: "lz4", 1: "zstd"}[comp.i8(0)]


def _body_bytes(body) -> np.ndarray:
    if isinstance(body, np.ndarray):
        return body
    return np.frombuffer(body, dtype=np.uint8)


class ArrayLoader:
    """Walks a schema's type tree, handing out a record batch body's field
    nodes and buffers in order (ipc/reader.cc:173 ``ArrayLoader``). Over a
    mapped body its Buffers are slices of the map."""

    def __init__(self, meta: RecordBatchMeta, body):
        self.meta = meta
        self.body = _body_bytes(body)
        self.node_i = 0
        self.buf_i = 0
        self.variadic_i = 0

    def _next_variadic(self) -> int:
        counts = self.meta.variadic_counts
        n = counts[self.variadic_i] if self.variadic_i < len(counts) else 0
        self.variadic_i += 1
        return n

    def _next_node(self) -> Tuple[int, int]:
        n = self.meta.nodes[self.node_i]
        self.node_i += 1
        return n

    def _next_buffer(self) -> Optional[Buffer]:
        off, ln = self.meta.buffers[self.buf_i]
        self.buf_i += 1
        if ln == 0:
            return None
        raw = self.body[off:off + ln]
        if self.meta.codec is not None:
            (uncomp_len,) = struct.unpack_from("<q", raw[:8].tobytes())
            payload = raw[8:]
            if uncomp_len == -1:
                raw = payload
            elif self.meta.codec == "zstd":
                if _zstd is None:
                    raise ValueError("zstandard not available")
                raw = _zstd.ZstdDecompressor().decompress(
                    payload, max_output_size=uncomp_len)
            else:
                raw = lz4frame.decompress_array(payload, uncomp_len)
        return Buffer(raw)

    def skip(self, t: DataType) -> None:
        """Pass over a column of type ``t``: its nodes and buffers, unread
        and undecompressed (``load``'s walk without the loads)."""
        if t.id == TypeId.EXTENSION:
            self.skip(t.storage_type)
            return
        tid = t.id
        self.node_i += 1
        if tid == TypeId.NA:
            return
        if tid in _UNIONS:
            self.buf_i += 1 + (tid == TypeId.DENSE_UNION)
            for f in t.fields:
                self.skip(f.type)
            return
        if tid == TypeId.RUN_END_ENCODED:
            for f in t.fields:
                self.skip(f.type)
            return
        self.buf_i += 1  # validity
        if tid in _BINARY_VIEWS:
            self.buf_i += 1 + self._next_variadic()
        elif tid in _LIST_VIEWS:
            self.buf_i += 2
            self.skip(t.value_type)
        elif tid in _VAR_BINARY:
            self.buf_i += 2
        elif tid in _LISTS:
            self.buf_i += 1
            self.skip(t.value_type)
        elif tid == TypeId.FIXED_SIZE_LIST:
            self.skip(t.value_type)
        elif tid == TypeId.STRUCT:
            for f in t.fields:
                self.skip(f.type)
        else:
            self.buf_i += 1

    def load(self, t: DataType) -> ArrayData:
        tid = t.id
        if tid == TypeId.EXTENSION:
            out = self.load(t.storage_type)
            out.type = t
            return out
        length, null_count = self._next_node()
        if tid == TypeId.NA:
            return ArrayData(t, length, [], null_count=length)
        if tid in _UNIONS:
            bufs = [self._next_buffer()]
            if tid == TypeId.DENSE_UNION:
                bufs.append(self._next_buffer())
            children = [self.load(f.type) for f in t.fields]
            return ArrayData(t, length, bufs, children, null_count=0)
        if tid == TypeId.RUN_END_ENCODED:
            children = [self.load(f.type) for f in t.fields]
            return ArrayData(t, length, [], children, null_count=null_count)
        validity = self._next_buffer()
        if tid in _BINARY_VIEWS:
            views = self._next_buffer()
            data = [self._next_buffer() or Buffer(b"")
                    for _ in range(self._next_variadic())]
            return ArrayData(t, length, [validity, views] + data,
                             null_count=null_count)
        if tid in _LIST_VIEWS:
            offsets = self._next_buffer()
            sizes = self._next_buffer()
            child = self.load(t.value_type)
            return ArrayData(t, length, [validity, offsets, sizes], [child],
                             null_count=null_count)
        if tid in _VAR_BINARY:
            offsets = self._next_buffer()
            data = self._next_buffer()
            return ArrayData(t, length, [validity, offsets, data],
                             null_count=null_count)
        if tid in _LISTS:
            offsets = self._next_buffer()
            child = self.load(t.value_type)
            return ArrayData(t, length, [validity, offsets], [child],
                             null_count=null_count)
        if tid == TypeId.FIXED_SIZE_LIST:
            child = self.load(t.value_type)
            return ArrayData(t, length, [validity], [child],
                             null_count=null_count)
        if tid == TypeId.STRUCT:
            children = [self.load(f.type) for f in t.fields]
            return ArrayData(t, length, [validity], children,
                             null_count=null_count)
        # the fixed-width types and a dictionary's indices
        data = self._next_buffer()
        return ArrayData(t, length, [validity, data], null_count=null_count)
