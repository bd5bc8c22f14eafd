"""Host I/O streams and codecs (counterpart of ``arrow_tpu/io_streams.py``;
reference: cpp/src/arrow/io/interfaces.h, io/memory.h:145 BufferReader,
io/file.h:148 MemoryMappedFile, util/compression.h Codec).

Python file objects are the streams of this engine (the readers take any
binary file object), so these classes are thin pyarrow-shaped adapters over
``io``/``mmap``, with the codec registry of the IPC and Feather files.

One departure for speed, with the same results: ``MemoryMappedFile``'s
``read_buffer`` gives a read-only Buffer over the mapped bytes, not a copy
of them, and the IPC readers load a mapped file's columns the same way. The
map stays open while any Buffer over it lives: ``close()`` closes the file
and leaves the map to the last of them.

The codecs: zstd (where ``zstandard`` is importable, as in the reference),
gzip, bz2, and LZ4 frames by the port's own library
(``utils/lz4frame.py``). snappy and brotli, Parquet's, come with it
(ROADMAP.md, queue 1, item 13).
"""

from __future__ import annotations

import io as _io
import mmap as _mmap
import os
from typing import Optional

import numpy as np

from .buffer import Buffer, as_buffer
from .errors import ArrowInvalid

_LATER = "ROADMAP.md, queue 1, item 13: the file readers and writers"


class BufferReader(_io.BytesIO):
    """A reader over a Buffer or bytes (io/memory.h:145)."""

    def __init__(self, obj):
        if isinstance(obj, Buffer):
            data = obj.to_numpy().tobytes()
        else:
            data = bytes(obj)
        super().__init__(data)
        self._size = len(data)

    def size(self) -> int:
        return self._size

    def read_buffer(self, nbytes: Optional[int] = None) -> Buffer:
        return Buffer(self.read(nbytes if nbytes is not None else -1))


class BufferOutputStream(_io.BytesIO):
    """A writable in-memory stream; ``getvalue()``/``finish()`` give its
    bytes (io/memory.h BufferOutputStream)."""

    def finish(self) -> Buffer:
        return Buffer(super().getvalue())


class MockOutputStream:
    """Counts the bytes written without keeping them (io/memory.h
    MockOutputStream): a serialized size without the serialization's
    memory."""

    def __init__(self):
        self._n = 0

    def write(self, b) -> int:
        n = memoryview(b).nbytes
        self._n += n
        return n

    def size(self) -> int:
        return self._n

    def tell(self) -> int:
        return self._n


def OSFile(path: str, mode: str = "rb"):
    """An operating-system file (pyarrow.OSFile)."""
    if "b" not in mode:
        mode += "b"
    return open(path, mode)


class MemoryMappedFile:
    """A memory-mapped file (io/file.h:148): ``read`` copies, as a file's
    does; ``read_buffer`` gives a read-only Buffer over the map."""

    def __init__(self, path: str, mode: str = "r"):
        writable = mode != "r"
        self.path = path
        self._f = open(path, "r+b" if writable else "rb")
        self._mm = _mmap.mmap(self._f.fileno(), 0, access=(
            _mmap.ACCESS_WRITE if writable else _mmap.ACCESS_READ))
        self._bytes = np.frombuffer(self._mm, dtype=np.uint8)

    @classmethod
    def create(cls, path: str, size: int) -> "MemoryMappedFile":
        with open(path, "wb") as f:
            f.truncate(size)
        return cls(path, "r+")

    @property
    def closed(self) -> bool:
        return self._bytes is None

    def mapped(self) -> np.ndarray:
        """The whole map as uint8 numpy, without a copy."""
        if self._bytes is None:
            raise ValueError("I/O operation on a closed memory map")
        return self._bytes

    def read(self, n: int = -1) -> bytes:
        return self._mm.read(n)

    def read_buffer(self, nbytes: Optional[int] = None) -> Buffer:
        start = self._mm.tell()
        end = self.size() if nbytes is None or nbytes < 0 else \
            min(self.size(), start + nbytes)
        self._mm.seek(end)
        return Buffer(self.mapped()[start:end])

    def seek(self, pos: int, whence: int = 0) -> int:
        self._mm.seek(pos, whence)
        return self._mm.tell()

    def tell(self) -> int:
        return self._mm.tell()

    def write(self, data) -> int:
        return self._mm.write(memoryview(data).cast("B"))

    def size(self) -> int:
        return len(self._mm)

    def close(self) -> None:
        if self._bytes is None:
            return
        self._bytes = None
        try:
            self._mm.close()
        except BufferError:
            pass  # Buffers over the map remain; it closes with the last
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def memory_map(path: str, mode: str = "r") -> MemoryMappedFile:
    return MemoryMappedFile(path, mode)


def create_memory_map(path: str, size: int) -> MemoryMappedFile:
    return MemoryMappedFile.create(path, size)


def py_buffer(obj) -> Buffer:
    """A Buffer over a Python buffer-protocol object (pyarrow.py_buffer)."""
    return as_buffer(obj)


class _Owned(Buffer):
    """A Buffer that keeps the owner of its memory alive."""
    __slots__ = ("_base",)


def foreign_buffer(address: int, size: int, base=None) -> Buffer:
    """A Buffer over memory at a raw address (pyarrow.foreign_buffer);
    ``base`` is kept alive with it."""
    import ctypes
    raw = (ctypes.c_ubyte * size).from_address(address)
    buf = _Owned(np.frombuffer(raw, np.uint8))
    buf._base = base
    return buf


def input_stream(source, compression: Optional[str] = None):
    """pyarrow.input_stream: a path, bytes, a Buffer or a file object as a
    reader, decompressed where ``compression`` names a codec (a path
    ending in .gz is gzip)."""
    if isinstance(source, (bytes, bytearray, memoryview, Buffer)):
        stream = BufferReader(source)
    elif isinstance(source, (str, os.PathLike)):
        path = os.fspath(source)
        if compression is None and path.endswith(".gz"):
            compression = "gzip"
        stream = open(path, "rb")
    else:
        stream = source
    if compression in (None, "none"):
        return stream
    return _io.BytesIO(Codec(compression).decompress(stream.read()))


def output_stream(where, compression: Optional[str] = None):
    """pyarrow.output_stream: a path or a file object as a writer,
    compressing on close where ``compression`` names a codec."""
    if isinstance(where, (str, os.PathLike)):
        raw = open(os.fspath(where), "wb")
    else:
        raw = where
    if compression in (None, "none"):
        return raw
    return _CompressSink(raw, compression)


class _CompressSink:
    def __init__(self, raw, compression: str):
        self._raw = raw
        self._codec = Codec(compression)
        self._buf = bytearray()

    def write(self, b) -> int:
        self._buf += b
        return len(b)

    def close(self) -> None:
        self._raw.write(self._codec.compress(bytes(self._buf)))
        self._raw.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


CompressedInputStream = input_stream
CompressedOutputStream = output_stream

_CODECS = ("zstd", "gzip", "snappy", "lz4", "lz4_frame", "bz2", "brotli")


class Codec:
    """The compression codecs (util/compression.h) by name."""

    def __init__(self, compression: str, compression_level=None):
        self.name = compression.lower()
        self.compression_level = compression_level
        if self.name not in _CODECS:
            raise ArrowInvalid(
                f"unsupported codec {compression!r} "
                "(zstd/gzip/snappy/lz4/bz2/brotli available)")
        if self.name in ("snappy", "brotli"):
            raise NotImplementedError(
                f"the {self.name} codec is not ported yet ({_LATER}: "
                "Parquet's codecs)")

    @staticmethod
    def is_available(compression: str) -> bool:
        try:
            Codec(compression)
        except (ArrowInvalid, NotImplementedError):
            return False
        if compression.lower() == "zstd":
            try:
                import zstandard  # noqa: F401
            except ImportError:
                return False
        return True

    def compress(self, data) -> bytes:
        if self.name.startswith("lz4"):
            from .utils import lz4frame
            return lz4frame.compress(data)
        data = bytes(data)
        if self.name == "zstd":
            import zstandard
            lvl = self.compression_level or 3
            return zstandard.ZstdCompressor(level=lvl).compress(data)
        if self.name == "gzip":
            import gzip
            return gzip.compress(data,
                                 compresslevel=self.compression_level or 9)
        import bz2
        return bz2.compress(data, self.compression_level or 9)

    def decompress(self, data, decompressed_size=None) -> bytes:
        if self.name.startswith("lz4"):
            from .utils import lz4frame
            return lz4frame.decompress(data, decompressed_size)
        data = bytes(data)
        if self.name == "zstd":
            import zstandard
            return zstandard.ZstdDecompressor().decompress(
                data, max_output_size=decompressed_size or (1 << 30))
        if self.name == "gzip":
            import gzip
            return gzip.decompress(data)
        import bz2
        return bz2.decompress(data)


def _raw(buf):
    return buf.to_numpy() if isinstance(buf, Buffer) else buf


def compress(buf, codec: str = "lz4", asbytes: bool = False,
             memory_pool=None):
    out = Codec(codec).compress(_raw(buf))
    return out if asbytes else Buffer(out)


def decompress(buf, decompressed_size=None, codec: str = "lz4",
               asbytes: bool = False, memory_pool=None):
    out = Codec(codec).decompress(_raw(buf), decompressed_size)
    return out if asbytes else Buffer(out)


class NativeFile:
    """The base file-object marker (pyarrow.NativeFile): the streams are
    Python file objects; this serves isinstance checks."""


class PythonFile(NativeFile):
    """A Python file object (pyarrow.PythonFile)."""

    def __init__(self, handle, mode=None):
        self._h = handle
        self.mode = mode or getattr(handle, "mode", "rb")

    def __getattr__(self, name):
        return getattr(self._h, name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._h.close()


def _unwrapped(stream):
    return stream._h if isinstance(stream, PythonFile) else stream


class BufferedInputStream(PythonFile):
    """A read-buffered stream (io/buffered.h BufferedInputStream)."""

    def __init__(self, stream, buffer_size: int = 65536, memory_pool=None):
        raw = _unwrapped(stream)
        try:
            buffered = _io.BufferedReader(raw, buffer_size)
        except (TypeError, AttributeError):
            buffered = raw
        super().__init__(buffered, "rb")


class BufferedOutputStream(PythonFile):
    """A write-buffered stream (io/buffered.h BufferedOutputStream)."""

    def __init__(self, stream, buffer_size: int = 65536, memory_pool=None):
        raw = _unwrapped(stream)
        try:
            buffered = _io.BufferedWriter(raw, buffer_size)
        except (TypeError, AttributeError):
            buffered = raw
        super().__init__(buffered, "wb")


class FixedSizeBufferWriter(PythonFile):
    """Writes into a preallocated, writable buffer (io/memory.h
    FixedSizeBufferWriter)."""

    def __init__(self, buffer):
        self.buffer = buffer
        super().__init__(_io.BytesIO(), "wb")
        self._written = 0

    def write(self, data):
        src = np.frombuffer(bytes(data), dtype=np.uint8)
        arr = self.buffer.to_numpy()
        if self._written + src.size > arr.size:
            raise ArrowInvalid("write past end of fixed-size buffer")
        arr[self._written:self._written + src.size] = src
        self._written += src.size
        return src.size


class ResizableBuffer(Buffer):
    """A growable buffer (buffer.h:494 ResizableBuffer)."""
    __slots__ = ()

    def __init__(self, data=b""):
        super().__init__(np.frombuffer(bytes(data), np.uint8).copy())

    def resize(self, new_size: int, shrink_to_fit: bool = True):
        cur = self._data
        out = np.zeros(new_size, dtype=np.uint8)
        out[:min(len(cur), new_size)] = cur[:new_size]
        self._data = out


class TransformInputStream(PythonFile):
    """A stream read whole through a transform function
    (io/transform.h TransformInputStream)."""

    def __init__(self, stream, transform):
        data = _unwrapped(stream).read()
        super().__init__(_io.BytesIO(transform(data)), "rb")


def transcoding_input_stream(stream, src_encoding: str, dest_encoding: str):
    """Bytes decoded from one charset and encoded in another (pyarrow
    transcoding_input_stream)."""
    return TransformInputStream(
        stream, lambda b: b.decode(src_encoding).encode(dest_encoding))
