"""ORC files (counterpart of ``arrow_tpu/io/orc.py``; reference:
cpp/src/arrow/adapters/orc/, an adapter over liborc).

Neither machine has liborc, so the format is the reference's own: the
protobuf tail (PostScript -> Footer -> a StripeFooter a stripe) by the
port's protobuf runtime (``substrait.PB``), ORC's RLEv1 and RLEv2 integer
encodings (RLEv2 by the port's host library, ``csrc/orc_host.cpp``:
SHORT_REPEAT, DIRECT, PATCHED_BASE with its patches at the closest fixed
bit width, DELTA), byte RLE and boolean streams, DIRECT_V2 and
DICTIONARY_V2 strings, and the compression framing: the reader takes none,
zlib, snappy (``utils/snappy.py``) and, where ``zstandard`` imports, zstd;
the writer none and zlib.

Column types: boolean, byte, short, int, long, float, double, string,
binary, date, timestamp, decimal (precision <= 18), under a struct root;
nulls by PRESENT streams. The writer emits DIRECT_V2 streams (RLEv2
SHORT_REPEAT and DIRECT runs, byte-RLE booleans, raw IEEE floats, bytes
and RLEv2 lengths for strings), the reference's bytes stripe for stripe.
The host library is required: where it cannot be built a read or write of
integers raises NotImplementedError.
"""

from __future__ import annotations

import ctypes
import functools
import struct
import zlib
from typing import List, Optional

import numpy as np

from .. import types as T
from ..api import concat_tables
from ..array.array import Array, array as make_array
from ..array.data import ArrayData
from ..buffer import Buffer
from ..substrait import PB, _tag as _pb_tag, _varint as _pb_varint, \
    fm as _fm, fs as _fs, fv as _fv
from ..table import RecordBatch, Table
from ..types import Field, Schema
from ..utils import bits as bitutil
from .parquet.host import gather_var_bytes


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The RLEv2 coder, or NotImplementedError where it cannot be built."""
    from ..kernels._build import BuildError, host_library
    try:
        lib = host_library("orc_host")
    except BuildError as exc:
        raise NotImplementedError(
            f"ORC needs its host library, which failed to build: {exc}"
        ) from None
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
    lib.orc_rlev2_encode.restype = i64
    lib.orc_rlev2_encode.argtypes = [p, i64, i32, p]
    lib.orc_rlev2_decode.restype = i64
    lib.orc_rlev2_decode.argtypes = [p, i64, i64, i32, p]
    return lib


MAGIC = b"ORC"

# Type.Kind
_K_BOOL, _K_BYTE, _K_SHORT, _K_INT, _K_LONG = 0, 1, 2, 3, 4
_K_FLOAT, _K_DOUBLE, _K_STRING, _K_BINARY, _K_TIMESTAMP = 5, 6, 7, 8, 9
_K_LIST, _K_MAP, _K_STRUCT, _K_UNION, _K_DECIMAL = 10, 11, 12, 13, 14
_K_DATE, _K_VARCHAR, _K_CHAR = 15, 16, 17

_KIND_TO_ARROW = {
    _K_BOOL: T.bool_(), _K_BYTE: T.int8(), _K_SHORT: T.int16(),
    _K_INT: T.int32(), _K_LONG: T.int64(), _K_FLOAT: T.float32(),
    _K_DOUBLE: T.float64(), _K_STRING: T.string(),
    _K_BINARY: T.binary(), _K_DATE: T.date32(),
    _K_TIMESTAMP: T.timestamp("ns"), _K_VARCHAR: T.string(),
    _K_CHAR: T.string(),
}

# Stream.Kind
_S_PRESENT, _S_DATA, _S_LENGTH, _S_DICT = 0, 1, 2, 3
_S_SECONDARY = 5


def _decompress_blocks(block: bytes, kind: int) -> bytes:
    """ORC compression framing: 3-byte little-endian header per chunk,
    low bit = is-original."""
    if kind == 0:
        return block
    out = bytearray()
    i = 0
    while i + 3 <= len(block):
        h = int.from_bytes(block[i:i + 3], "little")
        i += 3
        ln = h >> 1
        chunk = block[i:i + ln]
        i += ln
        if h & 1:
            out += chunk
        elif kind == 1:        # ZLIB (raw deflate)
            out += zlib.decompress(chunk, -15)
        elif kind == 2:        # SNAPPY
            from ..utils import snappy
            out += snappy.decompress(chunk, 1 << 24)
        elif kind == 5:        # ZSTD
            import zstandard
            out += zstandard.ZstdDecompressor().decompress(
                chunk, max_output_size=1 << 26)
        else:
            raise NotImplementedError(f"ORC compression kind {kind}")
    return bytes(out)


# --- low-level decoders ----------------------------------------------------


class _Bytes:
    __slots__ = ("b", "i")

    def __init__(self, b: bytes):
        self.b = b
        self.i = 0

    def u8(self) -> int:
        v = self.b[self.i]
        self.i += 1
        return v

    def take(self, n: int) -> bytes:
        out = self.b[self.i:self.i + n]
        self.i += n
        return out

    def varint(self) -> int:
        v = s = 0
        while True:
            byte = self.b[self.i]
            self.i += 1
            v |= (byte & 0x7F) << s
            if not byte & 0x80:
                return v
            s += 7

    def done(self) -> bool:
        return self.i >= len(self.b)


def _rlev2_decode(data: bytes, n: int, signed: bool) -> np.ndarray:
    """ORC RLEv2 (SHORT_REPEAT / DIRECT / PATCHED_BASE / DELTA) by the host
    library (liborc's RleDecoderV2); ValueError where the stream ends early
    or is corrupt."""
    buf = np.frombuffer(data, np.uint8)
    out = np.empty(n, np.int64)
    consumed = _library().orc_rlev2_decode(buf.ctypes.data, len(buf), n,
                                           1 if signed else 0,
                                           out.ctypes.data)
    if consumed < 0:
        raise ValueError("ORC RLEv2 stream truncated/corrupt")
    return out


def _byte_rle_decode(data: bytes, n: int) -> np.ndarray:
    """ORC byte RLE (used for PRESENT/boolean byte streams)."""
    s = _Bytes(data)
    out = np.empty(n, np.uint8)
    filled = 0
    while filled < n and not s.done():
        h = s.u8()
        if h < 128:             # run
            count = h + 3
            v = s.u8()
            out[filled:filled + min(count, n - filled)] = v
            filled += min(count, n - filled)
        else:                   # literals
            count = 256 - h
            take = min(count, n - filled)
            raw = s.take(count)
            out[filled:filled + take] = np.frombuffer(raw[:take], np.uint8)
            filled += take
    return out[:n]


def _bool_decode(data: bytes, n: int) -> np.ndarray:
    nbytes = (n + 7) // 8
    bytes_ = _byte_rle_decode(data, nbytes)
    bits = np.unpackbits(bytes_)  # MSB-first
    return bits[:n].astype(bool)


# --- file reader -----------------------------------------------------------


class ORCFile:
    def __init__(self, source):
        if isinstance(source, (bytes, bytearray, memoryview)):
            self.raw = bytes(source)
        elif isinstance(source, str):
            with open(source, "rb") as f:
                self.raw = f.read()
        else:
            self.raw = source.read()
        if not self.raw.startswith(MAGIC):
            raise ValueError("not an ORC file")
        self._parse_tail()

    def _parse_tail(self):
        raw = self.raw
        ps_len = raw[-1]
        ps = PB(raw[len(raw) - 1 - ps_len:-1])
        self.compression = ps.u(2)
        flen = ps.u(1)
        foot_raw = raw[len(raw) - 1 - ps_len - flen:
                       len(raw) - 1 - ps_len]
        self.footer = PB(_decompress_blocks(foot_raw, self.compression))
        self.num_rows = self.footer.u(6)
        self.types = self.footer.msgs(4)
        root = self.types[0]
        if root.u(1) != _K_STRUCT:
            raise NotImplementedError("ORC root must be a struct")
        self.col_names = root.strs(3)
        sub = root.raw(2)
        # packed repeated uint32 (or one varint per entry)
        self.col_type_ids = list(sub) if sub is not None and \
            all(b < 0x80 for b in sub) else self._unpack_u32s(root)
        self.stripes = self.footer.msgs(3)

    @staticmethod
    def _unpack_u32s(msg: PB) -> List[int]:
        out = []
        for raw in msg.fields.get(2, []):
            if isinstance(raw, bytes):
                b = _Bytes(raw)
                while not b.done():
                    out.append(b.varint())
            else:
                out.append(raw)
        return out

    @property
    def schema(self) -> Schema:
        fields = []
        for name, tid in zip(self.col_names, self.col_type_ids):
            t = self.types[tid]
            kind = t.u(1)
            at = _KIND_TO_ARROW.get(kind)
            if at is None and kind == _K_DECIMAL:
                # Type proto: precision=5, scale=6
                at = T.decimal128(t.u(5, 38) or 38, t.u(6, 0))
            if at is None:
                raise NotImplementedError(f"ORC type kind {kind}")
            fields.append(Field(name, at, nullable=True))
        return Schema(fields)

    def read(self, columns: Optional[List[str]] = None) -> Table:
        schema = self.schema
        if columns is not None:
            keep = [f.name for f in schema if f.name in columns]
            schema = Schema([f for f in schema if f.name in columns])
        else:
            keep = [f.name for f in schema]
        if len(self.stripes) > 1:
            # stripes decode on threads (zlib, numpy and the host library
            # release Python's lock), in order
            import os
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(max_workers=min(
                    8, os.cpu_count() or 1)) as ex:
                batches = list(ex.map(
                    lambda st: self._read_stripe(st, keep, schema),
                    self.stripes))
        else:
            batches = [self._read_stripe(st, keep, schema)
                       for st in self.stripes]
        if not batches:
            return Table.from_batches(
                [RecordBatch(schema, [make_array([], f.type)
                                      for f in schema])], schema)
        return Table.from_batches(batches, schema)

    def _read_stripe(self, st: PB, keep: List[str],
                     schema: Schema) -> RecordBatch:
        offset = st.u(1)
        ilen = st.u(2)
        dlen = st.u(3)
        flen = st.u(4)
        nrows = st.u(5)
        sf = PB(_decompress_blocks(
            self.raw[offset + ilen + dlen:offset + ilen + dlen + flen],
            self.compression))
        streams = []
        cursor = offset
        for s in sf.msgs(1):
            kind, col, ln = s.u(1), s.u(2), s.u(3)
            streams.append((kind, col, cursor, ln))
            cursor += ln
        encodings = [(ce.u(1), ce.u(2)) for ce in sf.msgs(2)]

        def stream(col_id, kind) -> Optional[bytes]:
            for k, c, off, ln in streams:
                if c == col_id and k == kind:
                    return _decompress_blocks(self.raw[off:off + ln],
                                              self.compression)
            return None

        arrays = []
        for name in keep:
            idx = self.col_names.index(name)
            col_id = self.col_type_ids[idx]
            kind = self.types[col_id].u(1)
            enc = encodings[col_id][0] if col_id < len(encodings) else 2
            dict_size = encodings[col_id][1] if col_id < len(encodings) \
                else 0
            arrays.append(self._decode_column(
                kind, enc, dict_size, nrows, col_id, stream,
                schema.field(name).type))
        return RecordBatch(schema, arrays)

    def _decode_column(self, kind, enc, dict_size, nrows, col_id, stream,
                       arrow_type) -> Array:
        present_raw = stream(col_id, _S_PRESENT)
        if present_raw is not None:
            present = _bool_decode(present_raw, nrows)
        else:
            present = np.ones(nrows, bool)
        n_present = int(present.sum())
        data = stream(col_id, _S_DATA)
        v2 = enc in (2, 3)  # DIRECT_V2 / DICTIONARY_V2

        def spread(vals):
            out = [None] * nrows
            j = 0
            for i in range(nrows):
                if present[i]:
                    out[i] = vals[j]
                    j += 1
            return out

        # the fixed-width paths' spread by the present mask and validity,
        # in numpy (liborc's decoders are byte loops)
        null_count = int(nrows - n_present)
        vbuf = None if null_count == 0 else \
            Buffer(bitutil.pack_bits(present))

        def prim(vals_np, np_dt):
            if null_count == 0:
                full = np.ascontiguousarray(
                    np.asarray(vals_np).astype(np_dt, copy=False))
            else:
                full = np.zeros(nrows, np_dt)
                full[present] = np.asarray(vals_np).astype(np_dt,
                                                           copy=False)
            return Array(ArrayData(arrow_type, nrows,
                                   [vbuf, Buffer(full)],
                                   null_count=null_count))

        if kind == _K_BOOL:
            bits = _bool_decode(data, n_present)
            if null_count == 0:
                full = np.asarray(bits, np.bool_)[:nrows]
            else:
                full = np.zeros(nrows, np.bool_)
                full[present] = np.asarray(bits, np.bool_)
            return Array(ArrayData(
                arrow_type, nrows,
                [vbuf, Buffer(bitutil.pack_bits(full))],
                null_count=null_count))
        if kind == _K_BYTE:
            return prim(_byte_rle_decode(data, n_present).astype(np.int8),
                        arrow_type.to_numpy_dtype())
        if kind in (_K_SHORT, _K_INT, _K_LONG, _K_DATE):
            vals = (_rlev2_decode(data, n_present, True) if v2
                    else _rlev1_decode(data, n_present, True))
            return prim(vals, arrow_type.to_numpy_dtype())
        if kind == _K_FLOAT:
            return prim(np.frombuffer(data, "<f4", count=n_present),
                        np.float32)
        if kind == _K_DOUBLE:
            return prim(np.frombuffer(data, "<f8", count=n_present),
                        np.float64)
        if kind in (_K_STRING, _K_BINARY, _K_VARCHAR, _K_CHAR):
            if enc in (1, 3):   # DICTIONARY(_V2)
                dlens = np.asarray(_rlev2_decode(
                    stream(col_id, _S_LENGTH), dict_size, False),
                    np.int64)
                dict_data = stream(col_id, _S_DICT) or b""
                doffs = np.zeros(dict_size + 1, np.int64)
                np.cumsum(dlens, out=doffs[1:])
                idxs = np.asarray(_rlev2_decode(data, n_present, False),
                                  np.int64)
                lens_present = dlens[idxs]
                total = int(lens_present.sum())
                # gather dictionary word bytes with one fancy index
                src = np.frombuffer(dict_data, np.uint8)
                starts = doffs[:-1][idxs]
                gather = np.repeat(starts, lens_present) + (
                    np.arange(total, dtype=np.int64) -
                    np.repeat(np.cumsum(lens_present) - lens_present,
                              lens_present))
                data_bytes = src[gather].tobytes() if total else b""
            else:
                lens_present = np.asarray(
                    _rlev2_decode(stream(col_id, _S_LENGTH), n_present,
                                  False) if v2 else _rlev1_decode(
                        stream(col_id, _S_LENGTH), n_present, False),
                    np.int64)
                total = int(lens_present.sum())
                data_bytes = bytes(data[:total])
            if null_count == 0:
                lens_full = lens_present
            else:
                lens_full = np.zeros(nrows, np.int64)
                lens_full[present] = lens_present
            offsets = np.zeros(nrows + 1, np.int64)
            np.cumsum(lens_full, out=offsets[1:])
            return Array(ArrayData(
                arrow_type, nrows,
                [vbuf, Buffer(offsets.astype(np.int32)),
                 Buffer(np.frombuffer(data_bytes, np.uint8))],
                null_count=null_count))
        if kind == _K_TIMESTAMP:
            secs = _rlev2_decode(data, n_present, True)
            nano_raw = stream(col_id, _S_SECONDARY)
            nanos = _rlev2_decode(nano_raw, n_present, False) \
                if nano_raw else np.zeros(n_present, np.int64)
            # nanos low 3 bits encode trailing-zero count
            dec = []
            # ORC epoch is 2015-01-01 UTC
            epoch_shift = 1420070400
            for s_, nz in zip(secs, nanos):
                z = int(nz) & 0x7
                v = int(nz) >> 3
                if z:
                    v *= 10 ** (z + 1)
                dec.append((int(s_) + epoch_shift) * 10 ** 9 + v)
            return make_array(spread(dec), arrow_type)
        if kind == _K_DECIMAL:
            # DATA = zigzag varint unscaled; SECONDARY = per-value scale
            b = _Bytes(data)
            vals = []
            for _ in range(n_present):
                v = b.varint()
                vals.append((v >> 1) ^ -(v & 1))
            sraw = stream(col_id, _S_SECONDARY)
            scales = _rlev2_decode(sraw, n_present, True) if sraw else \
                np.full(n_present, arrow_type.scale, np.int64)
            import decimal as _d
            target = arrow_type.scale
            out_vals = []
            for v, sc in zip(vals, scales):
                d_ = _d.Decimal(v).scaleb(-int(sc))
                out_vals.append(d_.quantize(_d.Decimal(1).scaleb(-target)))
            return make_array(spread(out_vals), arrow_type)
        raise NotImplementedError(f"ORC column kind {kind}")


def _rlev1_decode(data: bytes, n: int, signed: bool) -> np.ndarray:
    """ORC RLEv1 (DIRECT encoding version 1)."""
    s = _Bytes(data)
    out = np.empty(n, np.int64)
    filled = 0
    while filled < n and not s.done():
        h = s.u8()
        if h < 128:            # run: count = h + 3, delta i8, base varint
            count = h + 3
            delta = struct.unpack("b", s.take(1))[0]
            base = s.varint()
            if signed:
                base = (base >> 1) ^ -(base & 1)
            take = min(count, n - filled)
            out[filled:filled + take] = base + delta * np.arange(take)
            filled += take
        else:                  # literals
            count = 256 - h
            for _ in range(min(count, n - filled)):
                v = s.varint()
                if signed:
                    v = (v >> 1) ^ -(v & 1)
                out[filled] = v
                filled += 1
    return out


def read_table(source, columns: Optional[List[str]] = None) -> Table:
    return ORCFile(source).read(columns)


# --- file writer ------------------------------------------------------------
# Encoders are the inverses of the decoders above; stream/encoding choices
# mirror what modern liborc writers emit (DIRECT_V2 everywhere RLEv2
# applies) so both liborc and this module's reader consume the output.


def _rlev2_encode(vals: np.ndarray, signed: bool) -> bytes:
    """RLEv2 with SHORT_REPEAT for runs and DIRECT otherwise (the
    reference writer's always-decodable subset, its bytes) by the host
    library."""
    vals = np.ascontiguousarray(vals, np.int64)
    n = len(vals)
    if n == 0:
        return b""
    out = np.empty(9 * n + 2 * (n // 512 + 2) + 16, np.uint8)
    written = _library().orc_rlev2_encode(vals.ctypes.data, n,
                                          1 if signed else 0,
                                          out.ctypes.data)
    return out[:written].tobytes()


def _byte_rle_encode(data: np.ndarray) -> bytes:
    """ORC byte-RLE: runs of 3..130 equal bytes, else literals of <=128."""
    b = np.asarray(data, np.uint8)
    n = len(b)
    out = bytearray()
    i = 0
    lit_start = i
    while i < n:
        run = 1
        while i + run < n and run < 130 and b[i + run] == b[i]:
            run += 1
        if run >= 3:
            while lit_start < i:
                take = min(128, i - lit_start)
                out.append(256 - take)
                out += b[lit_start:lit_start + take].tobytes()
                lit_start += take
            out.append(run - 3)
            out.append(int(b[i]))
            i += run
            lit_start = i
        else:
            i += run
    while lit_start < i:
        take = min(128, i - lit_start)
        out.append(256 - take)
        out += b[lit_start:lit_start + take].tobytes()
        lit_start += take
    return bytes(out)


def _bool_encode(mask: np.ndarray) -> bytes:
    return _byte_rle_encode(np.packbits(np.asarray(mask, np.uint8)))


_ARROW_TO_KIND = {
    T.TypeId.BOOL: _K_BOOL, T.TypeId.INT8: _K_BYTE,
    T.TypeId.INT16: _K_SHORT, T.TypeId.INT32: _K_INT,
    T.TypeId.INT64: _K_LONG, T.TypeId.FLOAT: _K_FLOAT,
    T.TypeId.DOUBLE: _K_DOUBLE, T.TypeId.STRING: _K_STRING,
    T.TypeId.LARGE_STRING: _K_STRING, T.TypeId.BINARY: _K_BINARY,
    T.TypeId.LARGE_BINARY: _K_BINARY, T.TypeId.DATE32: _K_DATE,
    T.TypeId.TIMESTAMP: _K_TIMESTAMP, T.TypeId.DECIMAL128: _K_DECIMAL,
}

_TS_UNIT_NS = {"s": 10**9, "ms": 10**6, "us": 10**3, "ns": 1}
_ORC_EPOCH_S = 1420070400  # 2015-01-01 UTC


def _encode_column(arr: Array, kind: int):
    """-> (streams [(stream_kind, bytes)], encoding_kind, dict_size)."""
    n = len(arr)
    mask = arr.is_valid_mask()
    has_nulls = arr.null_count > 0
    streams = []
    if has_nulls:
        streams.append((_S_PRESENT, _bool_encode(mask)))
    t = arr.type

    if kind == _K_BOOL:
        vals = arr.data.values()[mask]
        streams.append((_S_DATA, _bool_encode(vals)))
        return streams, 0, 0
    if kind == _K_BYTE:
        vals = arr.data.values()[mask].astype(np.int8).view(np.uint8)
        streams.append((_S_DATA, _byte_rle_encode(vals)))
        return streams, 0, 0
    if kind in (_K_SHORT, _K_INT, _K_LONG, _K_DATE):
        vals = arr.data.values()[mask].astype(np.int64)
        streams.append((_S_DATA, _rlev2_encode(vals, True)))
        return streams, 2, 0
    if kind == _K_FLOAT:
        vals = arr.data.values()[mask].astype("<f4")
        streams.append((_S_DATA, vals.tobytes()))
        return streams, 0, 0
    if kind == _K_DOUBLE:
        vals = arr.data.values()[mask].astype("<f8")
        streams.append((_S_DATA, vals.tobytes()))
        return streams, 0, 0
    if kind in (_K_STRING, _K_BINARY):
        # stay on the (offsets, pool) buffers — no python string
        # materialization (the to_pylist round trip was ~500 ms of a
        # 1M-row table write)
        offs = np.asarray(arr.data.offsets(), dtype=np.int64)
        pool = np.asarray(arr.data.data_bytes())
        lens_all = np.diff(offs)
        if has_nulls:
            lens = lens_all[mask]
            ids = np.flatnonzero(mask).astype(np.int64)
            data = gather_var_bytes(pool, offs, ids)[1].tobytes() \
                if len(ids) else b""
        else:
            lens = lens_all
            data = pool[offs[0]:offs[-1]].tobytes()
        streams.append((_S_DATA, data))
        streams.append((_S_LENGTH, _rlev2_encode(lens, False)))
        return streams, 2, 0
    if kind == _K_TIMESTAMP:
        ns_per = _TS_UNIT_NS[t.unit]
        raw = arr.data.values()[mask].astype(np.int64) * ns_per
        secs = raw // 10**9 - _ORC_EPOCH_S
        nanos = (raw % 10**9).astype(np.int64)
        enc_nanos = np.empty(len(nanos), np.int64)
        for i, nv in enumerate(nanos):
            nv = int(nv)
            z = 0
            if nv:
                while nv % 10 == 0 and z < 8:
                    nv //= 10
                    z += 1
            if z >= 2:
                enc_nanos[i] = (nv << 3) | (z - 1)
            else:
                enc_nanos[i] = int(nanos[i]) << 3
        streams.append((_S_DATA, _rlev2_encode(secs, True)))
        streams.append((_S_SECONDARY, _rlev2_encode(enc_nanos, False)))
        return streams, 2, 0
    if kind == _K_DECIMAL:
        scale = t.scale
        body = bytearray()
        for v, ok in zip(arr.to_pylist(), mask):
            if not ok:
                continue
            unscaled = int(v.scaleb(scale).to_integral_value())
            body += _pb_varint((unscaled << 1) ^ (unscaled >> 127))
        scales = np.full(n - (n - int(mask.sum())), scale, np.int64)
        streams.append((_S_DATA, bytes(body)))
        streams.append((_S_SECONDARY, _rlev2_encode(scales, True)))
        return streams, 2, 0
    raise NotImplementedError(f"ORC writer: column kind {kind}")


def _compress_stream(data: bytes, kind: int,
                     block: int = 256 * 1024) -> bytes:
    if kind == 0:
        return data
    out = bytearray()
    for i in range(0, len(data), block) or [0]:
        chunk = data[i:i + block]
        if kind == 1:
            comp = zlib.compress(chunk, 6)[2:-4]  # raw deflate
        else:
            raise NotImplementedError(f"ORC writer compression {kind}")
        if len(comp) < len(chunk):
            out += (len(comp) << 1).to_bytes(3, "little") + comp
        else:
            out += ((len(chunk) << 1) | 1).to_bytes(3, "little") + chunk
    if not data:
        return b""
    return bytes(out)


def write_table(table, where, stripe_rows: int = 64 * 1024,
                compression: str = "uncompressed") -> None:
    """Write a Table/RecordBatch as an ORC file: the reference's bytes.

    ``where`` is a path or binary file object. Flat schemas of the types
    listed in the module docstring; ZLIB or no compression."""
    comp_kind = {"uncompressed": 0, "zlib": 1}.get(compression)
    if comp_kind is None:
        raise NotImplementedError(f"ORC writer compression {compression}")
    if isinstance(table, RecordBatch):
        table = Table.from_batches([table], table.schema)
    schema = table.schema
    kinds = []
    for f in schema:
        k = _ARROW_TO_KIND.get(f.type.id)
        if k is None:
            raise NotImplementedError(
                f"ORC writer: unsupported type {f.type!r}")
        kinds.append(k)

    ncols = len(schema)
    total_rows = table.num_rows

    def stripe(start):
        """A stripe's rows, its (stream kind, column id, framed bytes) and
        its column encodings."""
        nrows = min(stripe_rows, total_rows - start)
        streams, encodings = [], [(0, 0)]  # root struct: DIRECT
        for ci in range(ncols):
            arr = table.column(ci).slice(start, nrows).combine()
            col_streams, enc, dict_size = _encode_column(arr, kinds[ci])
            streams.extend((skind, ci + 1, _compress_stream(payload,
                                                            comp_kind))
                           for skind, payload in col_streams)
            encodings.append((enc, dict_size))
        return nrows, streams, encodings

    # stripes encode and compress on threads (numpy, the host library and
    # zlib release Python's lock), and are laid out in order
    starts = range(0, max(total_rows, 1), stripe_rows)
    if len(starts) > 1:
        import os
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) \
                as ex:
            stripes = list(ex.map(stripe, starts))
    else:
        stripes = [stripe(0)]
    out = bytearray(MAGIC)
    stripe_infos = []
    for nrows, streams, encodings in stripes:
        stripe_offset = len(out)
        sf = bytearray()
        for skind, cid, framed in streams:
            sf += _fm(1, _fv(1, skind) + _fv(2, cid) + _fv(3, len(framed)))
        for enc, dsz in encodings:
            body = _fv(1, enc)
            if dsz:
                body += _fv(2, dsz)
            sf += _fm(2, body)
        sf += _fs(3, "GMT")  # writerTimezone
        sf_framed = _compress_stream(bytes(sf), comp_kind)
        data_len = sum(len(framed) for _, _, framed in streams)
        for _, _, framed in streams:
            out += framed
        out += sf_framed
        stripe_infos.append((stripe_offset, 0, data_len, len(sf_framed),
                             nrows))

    content_len = len(out) - len(MAGIC)
    # Footer
    foot = bytearray()
    foot += _fv(1, len(MAGIC))            # headerLength
    foot += _fv(2, content_len)           # contentLength
    for off, ilen, dlen, flen, nr in stripe_infos:
        foot += _fm(3, _fv(1, off) + _fv(2, ilen) + _fv(3, dlen) +
                    _fv(4, flen) + _fv(5, nr))
    # types: root struct + one per column
    root = _fv(1, _K_STRUCT)
    root += _fm(2, b"".join(_pb_varint(i + 1) for i in range(ncols)))
    for f in schema:
        root += _fs(3, f.name)
    foot += _fm(4, root)
    for f, k in zip(schema, kinds):
        tb = _fv(1, k)
        if k == _K_DECIMAL:
            tb += _fv(5, f.type.precision) + _fv(6, f.type.scale)
        foot += _fm(4, tb)
    foot += _fv(6, total_rows)            # numberOfRows
    foot += _fv(8, 0)                     # rowIndexStride (no row index)
    foot_framed = _compress_stream(bytes(foot), comp_kind)
    out += foot_framed

    # PostScript (never compressed)
    ps = _fv(1, len(foot_framed))         # footerLength
    ps += _fv(2, comp_kind)               # compression
    if comp_kind:
        ps += _fv(3, 256 * 1024)          # compressionBlockSize
    ps += _fm(4, _pb_varint(0) + _pb_varint(12))   # version [0,12] packed
    ps += _fv(5, 0)                       # metadataLength
    ps += _fv(6, 1)                       # writerVersion
    ps += _pb_tag(8000, 2) + _pb_varint(3) + MAGIC   # magic
    out += ps
    out.append(len(ps))

    if isinstance(where, str):
        with open(where, "wb") as fobj:
            fobj.write(bytes(out))
    else:
        where.write(bytes(out))


class ORCWriter:
    """Incremental ORC writer (pyarrow.orc.ORCWriter over
    adapters/orc/adapter.h)."""

    def __init__(self, where, **kwargs):
        self._where = where
        self._tables = []
        self._closed = False

    def write(self, table):
        self._tables.append(table)

    def close(self):
        if self._closed:
            return
        self._closed = True
        if not self._tables:
            raise ValueError("no data written")
        write_table(concat_tables(self._tables), self._where)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
