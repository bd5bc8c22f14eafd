"""pyarrow.ipc's helpers over the stream and file machinery (counterpart
of ``arrow_tpu/ipc/compat.py``; reference: ipc/options.h IpcWriteOptions
and IpcReadOptions, ipc/message.h Message and MessageReader, ipc/reader.h
ReadStats, ipc/writer.h WriteStats)."""

from __future__ import annotations

import io as _io
from typing import Optional

from ..array.array import Array
from ..table import RecordBatch, Table
from .message import ArrayLoader, Message, RecordBatchMeta
from .reader_writer import MessageStream, new_stream, open_stream, \
    serialize_table

_HEADER_NAMES = {1: "schema", 2: "dictionary batch", 3: "record batch",
                 4: "tensor", 5: "sparse tensor"}


class MetadataVersion:
    """format/Schema.fbs MetadataVersion: this engine writes V5."""
    V1, V2, V3, V4, V5 = 1, 2, 3, 4, 5


class IpcWriteOptions:
    """ipc/options.h:54 IpcWriteOptions. ``compression`` is a codec name
    ('zstd'/'lz4') or None; the alignment is the format's 8 bytes."""

    def __init__(self, metadata_version: int = MetadataVersion.V5,
                 allow_64bit: bool = True, use_legacy_format: bool = False,
                 compression: Optional[str] = None,
                 use_threads: bool = True,
                 emit_dictionary_deltas: bool = False,
                 unify_dictionaries: bool = False):
        if use_legacy_format:
            raise NotImplementedError("legacy (pre-0.15) IPC framing")
        self.metadata_version = metadata_version
        self.allow_64bit = allow_64bit
        self.compression = compression
        self.use_threads = use_threads
        self.emit_dictionary_deltas = emit_dictionary_deltas
        self.unify_dictionaries = unify_dictionaries


class IpcReadOptions:
    """ipc/options.h IpcReadOptions."""

    def __init__(self, ensure_native_endian: bool = True,
                 use_threads: bool = True, included_fields=None):
        self.ensure_native_endian = ensure_native_endian
        self.use_threads = use_threads
        self.included_fields = included_fields


class _Counters:
    def __init__(self):
        self.num_messages = 0
        self.num_record_batches = 0
        self.num_dictionary_batches = 0
        self.num_dictionary_deltas = 0
        self.num_replaced_dictionaries = 0


class ReadStats(_Counters):
    """ipc/reader.h ReadStats counters."""


class WriteStats(_Counters):
    """ipc/writer.h WriteStats counters."""


class MessageReader:
    """ipc/message.h MessageReader: the raw IPC messages of a stream."""

    def __init__(self, source):
        self._stream = MessageStream(source)

    @classmethod
    def open_stream(cls, source) -> "MessageReader":
        return cls(source)

    def read_next_message(self) -> Optional[Message]:
        nxt = self._stream.next_message()
        if nxt is None:
            return None
        htype, header, body = nxt
        return Message(htype, header, len(body), body)

    def __iter__(self):
        while True:
            m = self.read_next_message()
            if m is None:
                return
            yield m


def read_message(source) -> Optional[Message]:
    """One encapsulated IPC message (pyarrow.ipc.read_message)."""
    return MessageReader(source).read_next_message()


def read_schema(source):
    """The schema of an IPC stream or buffer (pyarrow.ipc.read_schema)."""
    return open_stream(source).schema


def read_record_batch(obj, schema) -> RecordBatch:
    """One record batch from a standalone message or buffer, given its
    schema (pyarrow.ipc.read_record_batch)."""
    m = obj if isinstance(obj, Message) else read_message(bytes(obj))
    if m is None:
        raise ValueError("no IPC message in buffer")
    if m.header_type != 3:
        raise ValueError(
            "expected a record batch message, got "
            f"{_HEADER_NAMES.get(m.header_type, m.header_type)}")
    loader = ArrayLoader(RecordBatchMeta(m.header), m.body)
    return RecordBatch(schema, [Array(loader.load(f.type)) for f in schema])


def get_record_batch_size(batch: RecordBatch) -> int:
    """The bytes of the batch's messages, without the schema message and
    the end-of-stream marker (pyarrow.ipc's)."""
    raw = serialize_table(Table.from_batches([batch], batch.schema))
    sink = _io.BytesIO()
    with new_stream(sink, batch.schema):
        pass
    return len(raw) - len(sink.getvalue())
