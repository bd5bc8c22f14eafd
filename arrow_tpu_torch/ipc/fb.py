"""The flatbuffers of Arrow's IPC metadata (counterpart of
``arrow_tpu/ipc/fb.py``; reference: format/Schema.fbs, Message.fbs,
File.fbs), read and built by the port's own runtime.

The reference builds on the ``flatbuffers`` package, which the card's
machine lacks. ``Reader`` walks a table's vtable; ``Builder`` follows the
``flatbuffers`` Python runtime's algorithm step for step: the buffer is
built back to front, a scalar equal to its default is left out, equal
vtables are shared, and every scalar, offset, vector and string is aligned
as the runtime aligns it. So the port's metadata bytes equal the
reference's. Field slot numbers are the declaration indices in the .fbs
files (the wire contract).
"""

from __future__ import annotations

import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

# --- Type union discriminants (format/Schema.fbs ``union Type``) -------------
TYPE_NULL = 1
TYPE_INT = 2
TYPE_FLOATINGPOINT = 3
TYPE_BINARY = 4
TYPE_UTF8 = 5
TYPE_BOOL = 6
TYPE_DECIMAL = 7
TYPE_DATE = 8
TYPE_TIME = 9
TYPE_TIMESTAMP = 10
TYPE_INTERVAL = 11
TYPE_LIST = 12
TYPE_STRUCT = 13
TYPE_UNION = 14
TYPE_FIXEDSIZEBINARY = 15
TYPE_FIXEDSIZELIST = 16
TYPE_MAP = 17
TYPE_DURATION = 18
TYPE_LARGEBINARY = 19
TYPE_LARGEUTF8 = 20
TYPE_LARGELIST = 21
TYPE_RUNENDENCODED = 22
TYPE_BINARYVIEW = 23
TYPE_UTF8VIEW = 24
TYPE_LISTVIEW = 25
TYPE_LARGELISTVIEW = 26

# MessageHeader union (format/Message.fbs)
MSG_SCHEMA = 1
MSG_DICTIONARY_BATCH = 2
MSG_RECORD_BATCH = 3

METADATA_V5 = 4  # MetadataVersion.V5

COMPRESSION_LZ4_FRAME = 0
COMPRESSION_ZSTD = 1

TIMEUNIT = ["s", "ms", "us", "ns"]  # SECOND, MILLISECOND, MICROSECOND, NANOSECOND

_U32 = struct.Struct("<I")
_I32 = struct.Struct("<i")
_U16 = struct.Struct("<H")
_SCALARS = {"i8": "<b", "u8": "<B", "bool": "<B", "i16": "<h", "i32": "<i",
            "i64": "<q"}


class Reader:
    """A vtable-walking reader over one flatbuffer table of ``buf`` (bytes,
    a memoryview or uint8 numpy) at ``pos``."""

    __slots__ = ("buf", "pos", "_vt", "_vt_size")

    def __init__(self, buf, pos: int):
        self.buf = buf
        self.pos = pos
        self._vt = pos - _I32.unpack_from(buf, pos)[0]
        self._vt_size = _U16.unpack_from(buf, self._vt)[0]

    @classmethod
    def root(cls, buf, offset: int = 0) -> "Reader":
        if isinstance(buf, np.ndarray):
            buf = memoryview(buf)
        return cls(buf, offset + _U32.unpack_from(buf, offset)[0])

    def _off(self, slot: int) -> int:
        at = 4 + 2 * slot
        if at >= self._vt_size:
            return 0
        return _U16.unpack_from(self.buf, self._vt + at)[0]

    def _indirect(self, at: int) -> int:
        return at + _U32.unpack_from(self.buf, at)[0]

    def scalar(self, slot: int, fmt: str, default):
        o = self._off(slot)
        if o == 0:
            return default
        return struct.unpack_from(fmt, self.buf, self.pos + o)[0]

    def i8(self, slot, default=0):
        return int(self.scalar(slot, "<b", default))

    def u8(self, slot, default=0):
        return int(self.scalar(slot, "<B", default))

    def i16(self, slot, default=0):
        return int(self.scalar(slot, "<h", default))

    def i32(self, slot, default=0):
        return int(self.scalar(slot, "<i", default))

    def i64(self, slot, default=0):
        return int(self.scalar(slot, "<q", default))

    def bool_(self, slot, default=False):
        return bool(self.scalar(slot, "<B", default))

    def string(self, slot) -> Optional[bytes]:
        o = self._off(slot)
        if o == 0:
            return None
        at = self._indirect(self.pos + o)
        n = _U32.unpack_from(self.buf, at)[0]
        return bytes(self.buf[at + 4:at + 4 + n])

    def table(self, slot) -> Optional["Reader"]:
        o = self._off(slot)
        if o == 0:
            return None
        return Reader(self.buf, self._indirect(self.pos + o))

    def union(self, slot) -> Optional["Reader"]:
        """The payload of a union field (``slot`` is the value's, not the
        ``_type``'s)."""
        return self.table(slot)

    def _vector(self, slot) -> Tuple[int, int]:
        """(the first element's position, the length), or (0, 0)."""
        o = self._off(slot)
        if o == 0:
            return 0, 0
        at = self._indirect(self.pos + o)
        return at + 4, _U32.unpack_from(self.buf, at)[0]

    def vector_len(self, slot) -> int:
        return self._vector(slot)[1]

    def vector_table(self, slot, i: int) -> "Reader":
        base, _ = self._vector(slot)
        return Reader(self.buf, self._indirect(base + 4 * i))

    def vector_structs(self, slot, dtype) -> np.ndarray:
        """A vector of fixed structs as a numpy structured array
        (``dtype``: the struct's layout, its itemsize the stride)."""
        base, n = self._vector(slot)
        if n == 0:
            return np.zeros(0, dtype=dtype)
        return np.frombuffer(self.buf, dtype=dtype, count=n, offset=base)

    def vector_i64(self, slot) -> List[int]:
        return self.vector_structs(slot, np.dtype("<i8")).tolist()


class Builder:
    """The ``flatbuffers`` Python runtime's Builder, as far as the IPC
    metadata uses it, with the same bytes: built back to front, offsets
    from the buffer's end."""

    def __init__(self, initial_size: int = 1024):
        self.bytes = bytearray(initial_size)
        self.head = initial_size
        self.minalign = 1
        self.vtable: Optional[List[int]] = None
        self.object_end = 0
        self.vtables = {}
        self.nested = False
        self.vector_len = 0

    def offset(self) -> int:
        return len(self.bytes) - self.head

    def pad(self, n: int) -> None:
        if n > 0:
            self.head -= n
            self.bytes[self.head:self.head + n] = bytes(n)

    def prep(self, size: int, additional: int) -> None:
        """Align the head so that a ``size``-byte value written after
        ``additional`` more bytes lands at a multiple of ``size``."""
        if size > self.minalign:
            self.minalign = size
        align = (~(len(self.bytes) - self.head + additional) + 1) \
            & (size - 1)
        while self.head < align + size + additional:
            old = len(self.bytes)
            grown = bytearray(max(1, 2 * old))
            grown[len(grown) - old:] = self.bytes
            self.bytes = grown
            self.head += len(grown) - old
        self.pad(align)

    def place(self, fmt: str, x) -> None:
        n = struct.calcsize(fmt)
        self.head -= n
        struct.pack_into(fmt, self.bytes, self.head, x)

    def prepend(self, fmt: str, x) -> None:
        self.prep(struct.calcsize(fmt), 0)
        self.place(fmt, x)

    def prepend_int32(self, x: int) -> None:
        self.prepend("<i", x)

    def prepend_int64(self, x: int) -> None:
        self.prepend("<q", x)

    def prepend_uoffset(self, off: int) -> None:
        """An offset to ``off``, relative to where it is written."""
        self.prep(4, 0)
        if off > self.offset():
            raise ValueError("flatbuffers: offset arithmetic error")
        self.place("<I", self.offset() - off + 4)

    def start_object(self, nslots: int) -> None:
        if self.nested:
            raise ValueError("flatbuffers: an object is being built")
        self.vtable = [0] * nslots
        self.object_end = self.offset()
        self.nested = True

    def slot(self, i: int) -> None:
        self.vtable[i] = self.offset()

    def prepend_slot(self, kind: str, i: int, x, default) -> None:
        if x != default:
            self.prepend(_SCALARS[kind], int(x))
            self.slot(i)

    def prepend_uoffset_slot(self, i: int, x: int) -> None:
        if x != 0:
            self.prepend_uoffset(x)
            self.slot(i)

    def end_object(self) -> int:
        """Write the object's vtable, or point it at an equal one written
        before. Returns the object's offset."""
        self.nested = False
        self.prep(4, 0)
        self.place("<i", self.offset() + 4)  # the vtable's, set below
        object_offset = self.offset()
        vt = self.vtable
        key, trim = [], True
        for elem in reversed(vt):
            if elem == 0:
                if trim:
                    continue
            else:
                elem = object_offset - elem
                trim = False
            key.append(elem)
        object_size = object_offset - self.object_end
        key.append(object_size)
        key = tuple(key)
        existing = self.vtables.get(key)
        if existing is None:
            trailing, trim = 0, True
            for elem in reversed(vt):
                if elem == 0 and trim:
                    trailing += 1
                    continue
                trim = False
                self.prepend("<H", object_offset - elem if elem else 0)
            self.prepend("<H", object_size)
            self.prepend("<H", (len(vt) - trailing + 2) * 2)
            # the buffer may have grown: the object's start from its end
            struct.pack_into("<i", self.bytes,
                             len(self.bytes) - object_offset,
                             self.offset() - object_offset)
            self.vtables[key] = self.offset()
        else:
            self.head = len(self.bytes) - object_offset
            struct.pack_into("<i", self.bytes, self.head,
                             existing - object_offset)
        self.vtable = None
        return object_offset

    def start_vector(self, elem_size: int, n: int, alignment: int) -> int:
        if self.nested:
            raise ValueError("flatbuffers: an object is being built")
        self.nested = True
        self.vector_len = n
        self.prep(4, elem_size * n)
        self.prep(alignment, elem_size * n)
        return self.offset()

    def end_vector(self) -> int:
        self.nested = False
        self.place("<I", self.vector_len)
        return self.offset()

    def create_string(self, s) -> int:
        if self.nested:
            raise ValueError("flatbuffers: an object is being built")
        x = s.encode() if isinstance(s, str) else bytes(s)
        self.nested = True
        self.prep(4, len(x) + 1)
        self.place("<B", 0)
        self.head -= len(x)
        self.bytes[self.head:self.head + len(x)] = x
        self.vector_len = len(x)
        return self.end_vector()

    def finish(self, root: int) -> bytes:
        self.prep(self.minalign, 4)
        self.prepend_uoffset(root)
        return bytes(self.bytes[self.head:])


# --- the reference's table helpers -------------------------------------------

def _table(b: Builder, nslots: int, writes) -> int:
    """An object of ``nslots`` slots; ``writes`` = [(slot, kind, value,
    default), ...] in reverse slot order (the buffer is built back to
    front)."""
    b.start_object(nslots)
    for slot, kind, value, default in writes:
        if kind == "off":
            if value:
                b.prepend_uoffset_slot(slot, value)
        else:
            b.prepend_slot(kind, slot, value, default)
    return b.end_object()


def _offset_vector(b: Builder, offsets: Sequence[int]) -> int:
    b.start_vector(4, len(offsets), 4)
    for off in reversed(offsets):
        b.prepend_uoffset(off)
    return b.end_vector()


def _kv_vector(b: Builder, metadata) -> int:
    """custom_metadata: [KeyValue] (slots: key=0, value=1)."""
    if not metadata:
        return 0
    offs = []
    for k, v in metadata.items():
        ko = b.create_string(k)
        vo = b.create_string(v)
        offs.append(_table(b, 2, [(1, "off", vo, 0), (0, "off", ko, 0)]))
    return _offset_vector(b, offs)


def read_kv(r: Reader, slot: int) -> Optional[dict]:
    n = r.vector_len(slot)
    if n == 0:
        return None
    out = {}
    for i in range(n):
        kv = r.vector_table(slot, i)
        k = kv.string(0)
        v = kv.string(1)
        out[k if k is not None else b""] = v if v is not None else b""
    return out
