"""The thrift compact protocol, Parquet's metadata wire format (counterpart
of ``arrow_tpu/io/parquet/thrift.py``; reference: the Apache Thrift
structures of cpp/src/parquet/parquet.thrift).

The compact protocol describes itself, so the reader parses any struct into
a ``{field id: value}`` dict; the writer is told each field's type.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List

# compact type codes
CT_BOOL_TRUE = 1
CT_BOOL_FALSE = 2
CT_BYTE = 3
CT_I16 = 4
CT_I32 = 5
CT_I64 = 6
CT_DOUBLE = 7
CT_BINARY = 8
CT_LIST = 9
CT_SET = 10
CT_MAP = 11
CT_STRUCT = 12


def _zigzag(n: int) -> int:
    return (n << 1) ^ (n >> 63)


def _unzigzag(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


class CompactWriter:
    def __init__(self):
        self.buf = bytearray()
        self._last_fid: List[int] = [0]

    def _varint(self, n: int):
        while True:
            b = n & 0x7F
            n >>= 7
            if n:
                self.buf.append(b | 0x80)
            else:
                self.buf.append(b)
                return

    def _field_header(self, fid: int, ctype: int):
        delta = fid - self._last_fid[-1]
        if 0 < delta <= 15:
            self.buf.append((delta << 4) | ctype)
        else:
            self.buf.append(ctype)
            self._varint(_zigzag(fid) & 0xFFFF)
        self._last_fid[-1] = fid

    def field_i16(self, fid: int, v: int):
        self._field_header(fid, CT_I16)
        self._varint(_zigzag(v) & 0xFFFFFFFFFFFFFFFF)

    def field_i32(self, fid: int, v: int):
        self._field_header(fid, CT_I32)
        self._varint(_zigzag(v) & 0xFFFFFFFFFFFFFFFF)

    def field_i64(self, fid: int, v: int):
        self._field_header(fid, CT_I64)
        self._varint(_zigzag(v) & 0xFFFFFFFFFFFFFFFF)

    def field_bool(self, fid: int, v: bool):
        self._field_header(fid, CT_BOOL_TRUE if v else CT_BOOL_FALSE)

    def field_binary(self, fid: int, v: bytes):
        if isinstance(v, str):
            v = v.encode()
        self._field_header(fid, CT_BINARY)
        self._varint(len(v))
        self.buf.extend(v)

    def field_struct_begin(self, fid: int):
        self._field_header(fid, CT_STRUCT)
        self._last_fid.append(0)

    def struct_end(self):
        self.buf.append(0)
        self._last_fid.pop()

    def field_list_begin(self, fid: int, elem_ctype: int, size: int):
        self._field_header(fid, CT_LIST)
        if size < 15:
            self.buf.append((size << 4) | elem_ctype)
        else:
            self.buf.append(0xF0 | elem_ctype)
            self._varint(size)

    # list element writers (no field headers)
    def elem_i32(self, v: int):
        self._varint(_zigzag(v) & 0xFFFFFFFFFFFFFFFF)

    def elem_i64(self, v: int):
        self._varint(_zigzag(v) & 0xFFFFFFFFFFFFFFFF)

    def elem_binary(self, v):
        if isinstance(v, str):
            v = v.encode()
        self._varint(len(v))
        self.buf.extend(v)

    def elem_struct_begin(self):
        self._last_fid.append(0)

    def bytes(self) -> bytes:
        return bytes(self.buf)


class CompactReader:
    """Generic parse: structs -> {field_id: value}; lists -> [value];
    bools -> bool; ints -> int; binary -> bytes."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def _u8(self) -> int:
        b = self.data[self.pos]
        self.pos += 1
        return b

    def _varint(self) -> int:
        out = 0
        shift = 0
        while True:
            b = self._u8()
            out |= (b & 0x7F) << shift
            if not (b & 0x80):
                return out
            shift += 7

    def _value(self, ctype: int):
        if ctype == CT_BOOL_TRUE:
            return True
        if ctype == CT_BOOL_FALSE:
            return False
        if ctype == CT_BYTE:
            return self._byte()
        if ctype in (CT_I16, CT_I32, CT_I64):
            return _unzigzag(self._varint())
        if ctype == CT_DOUBLE:
            (v,) = struct.unpack_from("<d", self.data, self.pos)
            self.pos += 8
            return v
        if ctype == CT_BINARY:
            n = self._varint()
            v = self.data[self.pos:self.pos + n]
            self.pos += n
            return bytes(v)
        if ctype in (CT_LIST, CT_SET):
            return self._list()
        if ctype == CT_STRUCT:
            return self.read_struct()
        raise ValueError(f"unsupported compact type {ctype}")

    def _byte(self):
        v = self.data[self.pos]
        self.pos += 1
        return v - 256 if v > 127 else v

    def _list(self):
        head = self._u8()
        size = head >> 4
        etype = head & 0x0F
        if size == 15:
            size = self._varint()
        if etype in (CT_BOOL_TRUE, CT_BOOL_FALSE):
            return [self._u8() == CT_BOOL_TRUE for _ in range(size)]
        return [self._value(etype) for _ in range(size)]

    def read_struct(self) -> Dict[int, Any]:
        out: Dict[int, Any] = {}
        last_fid = 0
        while True:
            head = self._u8()
            if head == 0:
                return out
            delta = head >> 4
            ctype = head & 0x0F
            if delta == 0:
                fid = _unzigzag(self._varint())
            else:
                fid = last_fid + delta
            last_fid = fid
            out[fid] = self._value(ctype)
