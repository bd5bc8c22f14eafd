"""IPC stream and file readers and writers (counterpart of
``arrow_tpu/ipc/reader_writer.py``; reference: ipc/writer.h:143,167,
ipc/reader.h:74,109). The bytes follow the Arrow columnar format, so the
files interoperate with any Arrow implementation, and they equal the
reference's.

Departures for speed, with the same results: an in-memory source (bytes, a
Buffer, numpy, a ``BytesIO``) or a ``MemoryMappedFile`` is read without a
copy, its bodies' Buffers slices of it; a file reader reads the footer and
then only the batches, and with ``columns`` only the columns, it is asked
for.
"""

from __future__ import annotations

import io
import struct
from typing import BinaryIO, Dict, List, Optional, Sequence

import numpy as np

from ..array.array import Array
from ..array.data import ArrayData
from ..buffer import Buffer
from ..table import RecordBatch, Table
from ..types import DataType, Schema, TypeId
from . import fb
from .fb import Builder, Reader, _table
from .message import (CONTINUATION, EOS, ArrayLoader, RecordBatchMeta,
                      parse_message_meta, serialize_dictionary_batch,
                      serialize_record_batch_parts, serialize_schema_message)
from .schema_fb import DictionaryFieldMapper, read_schema, write_schema

MAGIC = b"ARROW1"
_BLOCK = np.dtype([("offset", "<i8"), ("meta", "<i4"), ("pad", "<i4"),
                   ("body", "<i8")])


def _collect_dictionaries(d: ArrayData, out: List[ArrayData]):
    """The dictionaries of ``d`` in pre-order: the order in which
    ``schema_fb.write_field`` gives their ids."""
    if d.type.id == TypeId.DICTIONARY:
        out.append(d.dictionary)
        if d.dictionary is not None:
            for c in d.dictionary.children:
                _collect_dictionaries(c, out)
    else:
        for c in d.children:
            _collect_dictionaries(c, out)


def _attach_dictionaries(d: ArrayData, ids: List[int],
                         memo: Dict[int, ArrayData], pos: List[int]):
    if d.type.id == TypeId.DICTIONARY:
        did = ids[pos[0]]
        pos[0] += 1
        d.dictionary = memo.get(did)
        if d.dictionary is not None:
            for c in d.dictionary.children:
                _attach_dictionaries(c, ids, memo, pos)
    else:
        for c in d.children:
            _attach_dictionaries(c, ids, memo, pos)


def _dictionary_count(t: DataType) -> int:
    """The dictionary ids a column of type ``t`` takes."""
    if t.id == TypeId.DICTIONARY:
        return 1 + sum(_dictionary_count(f.type)
                       for f in t.value_type.fields)
    return sum(_dictionary_count(f.type) for f in t.fields)


def _same_dict(a: ArrayData, b: ArrayData) -> bool:
    if a is b:
        return True
    if a.length != b.length or a.type != b.type:
        return False
    return Array(a).to_pylist() == Array(b).to_pylist()


class RecordBatchStreamWriter:
    def __init__(self, sink: BinaryIO, schema: Schema,
                 codec: Optional[str] = None):
        self.sink = sink
        self.schema = schema
        self.codec = codec
        self.mapper = DictionaryFieldMapper()
        self._dicts_written: Dict[int, ArrayData] = {}
        self._closed = False
        self.sink.write(serialize_schema_message(schema, self.mapper))

    def _batch_dictionaries(self, batch: RecordBatch):
        dicts: List[ArrayData] = []
        for col in batch.columns:
            _collect_dictionaries(col.data, dicts)
        return dicts

    def _write_dictionaries(self, batch: RecordBatch):
        dicts = self._batch_dictionaries(batch)
        ids = self.mapper.ordered_ids
        if len(dicts) != len(ids):
            raise ValueError("dictionary count mismatch vs schema")
        for did, dd in zip(ids, dicts):
            prev = self._dicts_written.get(did)
            if prev is not None and _same_dict(prev, dd):
                continue
            meta, body = serialize_dictionary_batch(did, dd, self.codec)
            self.sink.write(meta)
            self.sink.write(body)
            self._dicts_written[did] = dd

    def _check_schema(self, batch: RecordBatch, what: str):
        if not batch.schema.equals(self.schema):
            raise ValueError(
                f"batch schema {batch.schema.names} does not match {what} "
                f"schema {self.schema.names}")

    def _write_record_batch(self, batch: RecordBatch):
        """Write the batch's message; (metadata bytes, body bytes)."""
        meta, parts = serialize_record_batch_parts(
            [c.data for c in batch.columns], batch.num_rows, self.codec)
        self.sink.write(meta)
        for part in parts:
            self.sink.write(part)
        return len(meta), sum(len(p) for p in parts)

    def write_batch(self, batch: RecordBatch):
        self._check_schema(batch, "stream")
        self._write_dictionaries(batch)
        self._write_record_batch(batch)

    write = write_batch

    def write_table(self, tbl: Table, max_chunksize: Optional[int] = None):
        for b in tbl.to_batches(max_chunksize):
            self.write_batch(b)

    def close(self):
        if not self._closed:
            self.sink.write(EOS)
            self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class RecordBatchFileWriter(RecordBatchStreamWriter):
    def __init__(self, sink: BinaryIO, schema: Schema,
                 codec: Optional[str] = None):
        self._start = sink.tell()
        sink.write(MAGIC + b"\x00\x00")
        self._dict_blocks: List[tuple] = []
        self._batch_blocks: List[tuple] = []
        super().__init__(sink, schema, codec)

    def _write_dictionaries(self, batch: RecordBatch):
        dicts = self._batch_dictionaries(batch)
        for did, dd in zip(self.mapper.ordered_ids, dicts):
            prev = self._dicts_written.get(did)
            if prev is not None:
                if not _same_dict(prev, dd):
                    raise ValueError(
                        "IPC file format does not support dictionary "
                        "replacement; re-encode with a unified dictionary")
                continue
            offset = self.sink.tell() - self._start
            meta, body = serialize_dictionary_batch(did, dd, self.codec)
            self.sink.write(meta)
            self.sink.write(body)
            self._dict_blocks.append((offset, len(meta), len(body)))
            self._dicts_written[did] = dd

    def write_batch(self, batch: RecordBatch):
        self._check_schema(batch, "file")
        self._write_dictionaries(batch)
        offset = self.sink.tell() - self._start
        self._batch_blocks.append((offset,
                                   *self._write_record_batch(batch)))

    write = write_batch

    def close(self):
        if self._closed:
            return
        self.sink.write(EOS)
        b = Builder(1024)
        schema_off = write_schema(b, self.schema, DictionaryFieldMapper())

        def block_vector(blocks):
            b.start_vector(24, len(blocks), 8)
            for off, metalen, bodylen in reversed(blocks):
                b.prep(8, 24)
                b.prepend_int64(bodylen)
                b.pad(4)
                b.prepend_int32(metalen)
                b.prepend_int64(off)
            return b.end_vector()

        rb_vec = block_vector(self._batch_blocks)
        dict_vec = block_vector(self._dict_blocks)
        footer = b.finish(_table(b, 5, [
            (3, "off", rb_vec, 0),
            (2, "off", dict_vec, 0),
            (1, "off", schema_off, 0),
            (0, "i16", fb.METADATA_V5, 0),
        ]))
        self.sink.write(footer)
        self.sink.write(struct.pack("<i", len(footer)))
        self.sink.write(MAGIC)
        self._closed = True


class _BufferSource:
    """A file-like over bytes in memory, read without a copy: ``read``
    gives memoryviews, ``read_array`` numpy slices (the reference's
    BufferReader, io/memory.h:145)."""

    def __init__(self, data: np.ndarray, pos: int = 0):
        self._a = data
        self._pos = pos

    def read_array(self, n=-1) -> np.ndarray:
        if n is None or n < 0:
            n = self._a.size - self._pos
        out = self._a[self._pos:self._pos + n]
        self._pos += out.size
        return out

    def read(self, n=-1) -> memoryview:
        return memoryview(self.read_array(n))

    def seek(self, off, whence=0):
        if whence == 0:
            self._pos = off
        elif whence == 1:
            self._pos += off
        else:
            self._pos = self._a.size + off
        return self._pos

    def tell(self):
        return self._pos


def _source(source):
    """``source`` as the readers read it: memory and memory maps as a
    ``_BufferSource`` over their bytes, a file object as it is."""
    from ..io_streams import MemoryMappedFile
    if isinstance(source, (bytes, bytearray, memoryview)):
        return _BufferSource(np.frombuffer(source, dtype=np.uint8))
    if isinstance(source, Buffer):
        return _BufferSource(source.to_numpy())
    if isinstance(source, np.ndarray):
        return _BufferSource(source.view(np.uint8).reshape(-1))
    if isinstance(source, MemoryMappedFile):
        return _BufferSource(source.mapped(), source.tell())
    if isinstance(source, io.BytesIO):
        return _BufferSource(np.frombuffer(source.getvalue(), np.uint8),
                             source.tell())
    return source


class MessageStream:
    """An incremental message parser (reference: ipc/message.h:239);
    bodies from memory are slices of it, not copies (ArrayLoader assigns
    buffer slices zero copy where it can, ipc/reader.cc:173)."""

    def __init__(self, source):
        self.src = _source(source)

    def next_message(self):
        """(header type, the header's reader, the body) or None at the
        end of the stream."""
        first = self.src.read(4)
        if len(first) < 4:
            return None
        (word,) = struct.unpack("<I", first)
        if word == CONTINUATION:
            ln_bytes = self.src.read(4)
            if len(ln_bytes) < 4:
                return None
            (meta_len,) = struct.unpack("<I", ln_bytes)
        else:
            meta_len = word  # the legacy pre-0.15 framing
        if meta_len == 0:
            return None
        meta = self.src.read(meta_len)
        if len(meta) < meta_len:
            raise ValueError("truncated IPC message metadata")
        htype, header, body_len = parse_message_meta(meta)
        if not body_len:
            body = b""
        elif hasattr(self.src, "read_array"):
            body = self.src.read_array(body_len)
        else:
            body = self.src.read(body_len)
        if len(body) < body_len:
            raise ValueError(
                f"truncated IPC message body: expected {body_len} bytes, "
                f"got {len(body)}")
        return htype, header, body


class _Loads:
    """The batch and dictionary loading a stream's and a file's readers
    share."""

    def _load_columns(self, header: Reader, body,
                      columns: Optional[Sequence[int]] = None
                      ) -> RecordBatch:
        """The batch of ``header``/``body``; with ``columns`` (field
        indices), only those columns, the rest passed over unread."""
        fields = self.schema.fields
        loader = ArrayLoader(RecordBatchMeta(header), body)
        want = range(len(fields)) if columns is None else set(columns)
        cols, pos = {}, 0
        ids = self.mapper.ordered_ids
        for i, f in enumerate(fields):
            if i in want:
                cols[i] = loader.load(f.type)
                _attach_dictionaries(cols[i], ids, self.memo, [pos])
            else:
                loader.skip(f.type)
            pos += _dictionary_count(f.type)
        order = range(len(fields)) if columns is None else columns
        schema = self.schema if columns is None else \
            Schema([fields[i] for i in order], self.schema.metadata)
        return RecordBatch(schema, [Array(cols[i]) for i in order])

    def _load_dictionary(self, header: Reader, body):
        did = header.i64(0)
        is_delta = header.bool_(2)
        loader = ArrayLoader(RecordBatchMeta(header.table(1)), body)
        vtype = self.mapper.id_to_type[did].value_type
        dd = loader.load(vtype)
        if is_delta and did in self.memo:
            from ..compute.host_concat import concat_arrays
            dd = concat_arrays([Array(self.memo[did]), Array(dd)], vtype).data
        self.memo[did] = dd


class RecordBatchStreamReader(_Loads):
    def __init__(self, source):
        self.stream = MessageStream(source)
        self.mapper = DictionaryFieldMapper()
        self.memo: Dict[int, ArrayData] = {}
        msg = self.stream.next_message()
        if msg is None or msg[0] != fb.MSG_SCHEMA:
            raise ValueError("expected schema message")
        self.schema = read_schema(msg[1], self.mapper)

    def __iter__(self):
        return self

    def __next__(self) -> RecordBatch:
        while True:
            msg = self.stream.next_message()
            if msg is None:
                raise StopIteration
            htype, header, body = msg
            if htype == fb.MSG_DICTIONARY_BATCH:
                self._load_dictionary(header, body)
                continue
            if htype == fb.MSG_RECORD_BATCH:
                return self._load_columns(header, body)
            raise ValueError(f"unexpected message type {htype}")

    def read_all(self) -> Table:
        return Table.from_batches(list(self), self.schema)


class RecordBatchFileReader(_Loads):
    def __init__(self, source):
        self.src = src = _source(source)
        src.seek(0, 2)
        size = src.tell()
        src.seek(size - len(MAGIC) - 4)
        tail = bytes(src.read(len(MAGIC) + 4))
        if tail[4:] != MAGIC:
            raise ValueError("not an Arrow file")
        (footer_len,) = struct.unpack("<i", tail[:4])
        src.seek(size - len(MAGIC) - 4 - footer_len)
        fr = Reader.root(bytes(src.read(footer_len)))
        self.mapper = DictionaryFieldMapper()
        self.schema = read_schema(fr.table(1), self.mapper)
        self._dict_blocks = fr.vector_structs(2, _BLOCK)[
            ["offset", "meta", "body"]].tolist()
        self._batch_blocks = fr.vector_structs(3, _BLOCK)[
            ["offset", "meta", "body"]].tolist()
        self.memo: Dict[int, ArrayData] = {}
        self._dicts_loaded = False

    @property
    def num_record_batches(self) -> int:
        return len(self._batch_blocks)

    def _read_message_at(self, offset: int):
        self.src.seek(offset)
        return MessageStream(self.src).next_message()

    def _ensure_dictionaries(self):
        if self._dicts_loaded:
            return
        for off, _, _ in self._dict_blocks:
            htype, header, body = self._read_message_at(off)
            if htype != fb.MSG_DICTIONARY_BATCH:
                raise ValueError("a dictionary block holds no dictionary")
            self._load_dictionary(header, body)
        self._dicts_loaded = True

    def _column_indices(self, columns) -> Optional[List[int]]:
        if columns is None:
            return None
        idx = [self.schema.get_field_index(c) if isinstance(c, str) else c
               for c in columns]
        missing = [c for c, i in zip(columns, idx) if i < 0]
        if missing:
            raise KeyError(f"no columns named {missing}")
        return idx

    def get_batch(self, i: int, columns=None) -> RecordBatch:
        """Batch ``i``; with ``columns`` (names or indices), only those,
        in that order."""
        self._ensure_dictionaries()
        htype, header, body = self._read_message_at(self._batch_blocks[i][0])
        if htype != fb.MSG_RECORD_BATCH:
            raise ValueError("a record batch block holds no record batch")
        return self._load_columns(header, body, self._column_indices(columns))

    get_record_batch = get_batch

    def read_all(self, columns=None) -> Table:
        batches = [self.get_batch(i, columns)
                   for i in range(self.num_record_batches)]
        idx = self._column_indices(columns)
        schema = self.schema if idx is None else Schema(
            [self.schema.fields[i] for i in idx], self.schema.metadata)
        return Table.from_batches(batches, schema)


# --- convenience -------------------------------------------------------------

def new_stream(sink, schema, codec=None) -> RecordBatchStreamWriter:
    return RecordBatchStreamWriter(sink, schema, codec)


def new_file(sink, schema, codec=None) -> RecordBatchFileWriter:
    return RecordBatchFileWriter(sink, schema, codec)


def open_stream(source) -> RecordBatchStreamReader:
    return RecordBatchStreamReader(source)


def open_file(source) -> RecordBatchFileReader:
    return RecordBatchFileReader(source)


def serialize_table(tbl: Table, codec=None) -> bytes:
    buf = io.BytesIO()
    with new_stream(buf, tbl.schema, codec) as w:
        w.write_table(tbl)
    return buf.getvalue()


def deserialize_table(data) -> Table:
    return open_stream(data).read_all()
