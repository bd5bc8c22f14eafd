"""The Parquet file writer (counterpart of ``arrow_tpu/io/parquet/writer.py``;
reference: cpp/src/parquet/file_writer.h and the Arrow bridge
parquet/arrow/writer.h). v1 data pages of about ``data_page_size`` bytes
(1 MiB), PLAIN values, a dictionary page and RLE_DICTIONARY indices for a
binary column (its values in order of first appearance, a null as the
empty value), BYTE_STREAM_SPLIT or DELTA_BINARY_PACKED where a column asks
for them; no compression, snappy, gzip (level 9), brotli or zstd;
statistics, the page index, bloom filters and AES encryption; a row group a
batch. A file is the reference's bytes for the same Table and options
(an encrypted one but for its random nonces and file id); the writer
names itself ``arrow_tpu parquet writer`` as the reference does, and
writes no ``ARROW:schema``, so a dictionary column reads back as its
value type.
"""

from __future__ import annotations

import struct
from typing import BinaryIO, Dict, List, Optional, Tuple, Union

import numpy as np

from ...array.array import Array
from ...array.data import ArrayData
from ...buffer import Buffer
from ...table import RecordBatch, Table
from ... import types as T
from ...types import DataType, Schema, TypeId
from ...utils import bits as bitutil
from . import host
from .reader import (BOOLEAN, BYTE_ARRAY, CODEC_BROTLI, CODEC_GZIP,
                     CODEC_SNAPPY, CODEC_UNCOMPRESSED, CODEC_ZSTD,
                     DOUBLE, ENC_BYTE_STREAM_SPLIT, ENC_DELTA_BINARY_PACKED,
                     ENC_PLAIN, ENC_RLE, ENC_RLE_DICTIONARY, FLBA,
                     FLOAT, INT32, INT64, MAGIC, PAGE_DATA, PAGE_DICT)
from .rle import bit_width_for, encode_rle
from .thrift import (CT_BINARY, CT_BOOL_TRUE, CT_I32, CT_I64,
                     CT_STRUCT, CompactWriter)

try:
    import zstandard as _zstd
except ImportError:  # pragma: no cover
    _zstd = None


def _physical_for(t: DataType) -> Tuple[int, int]:
    """arrow type -> (physical, type_length)."""
    tid = t.id
    if tid == TypeId.BOOL:
        return BOOLEAN, 0
    if tid in (TypeId.INT8, TypeId.INT16, TypeId.INT32, TypeId.UINT8,
               TypeId.UINT16, TypeId.DATE32, TypeId.TIME32):
        return INT32, 0
    if tid in (TypeId.INT64, TypeId.UINT32, TypeId.UINT64,
               TypeId.TIMESTAMP, TypeId.TIME64, TypeId.DURATION,
               TypeId.DATE64):
        return INT64, 0
    if tid == TypeId.HALF_FLOAT or tid == TypeId.FLOAT:
        return FLOAT, 0
    if tid == TypeId.DOUBLE:
        return DOUBLE, 0
    if tid in (TypeId.STRING, TypeId.BINARY, TypeId.LARGE_STRING,
               TypeId.LARGE_BINARY, TypeId.DICTIONARY):
        return BYTE_ARRAY, 0
    if tid == TypeId.DECIMAL128:
        return FLBA, 16
    if tid == TypeId.FIXED_SIZE_BINARY:
        return FLBA, t.byte_width
    raise NotImplementedError(f"parquet write for {t!r}")


def _write_logical(w: CompactWriter, t: DataType):
    """SchemaElement converted_type (6) + logicalType (10) fields."""
    tid = t.id

    def logical(union_fid, builder=None):
        w.field_struct_begin(10)
        w.field_struct_begin(union_fid)
        if builder:
            builder()
        w.struct_end()
        w.struct_end()

    if tid in (TypeId.STRING, TypeId.LARGE_STRING) or (
            tid == TypeId.DICTIONARY and
            t.value_type.id in (TypeId.STRING, TypeId.LARGE_STRING)):
        w.field_i32(6, 0)  # UTF8
        logical(1)
    elif tid == TypeId.DATE32:
        w.field_i32(6, 6)  # DATE
        logical(6)
    elif tid == TypeId.TIMESTAMP:
        conv = {"ms": 9, "us": 10}.get(t.unit)
        if conv is not None and t.tz:
            w.field_i32(6, conv)

        def ts_body():
            w.field_bool(1, t.tz is not None)
            w.field_struct_begin(2)
            unit_fid = {"ms": 1, "us": 2, "ns": 3}.get(t.unit, 2)
            w.field_struct_begin(unit_fid)
            w.struct_end()
            w.struct_end()
        logical(8, ts_body)
    elif tid == TypeId.DECIMAL128:
        w.field_i32(6, 5)
        w.field_i32(7, t.scale)
        w.field_i32(8, t.precision)

        def dec_body():
            w.field_i32(1, t.scale)
            w.field_i32(2, t.precision)
        logical(5, dec_body)
    elif t.is_integer and tid not in (TypeId.INT32, TypeId.INT64):
        conv = {TypeId.INT8: 15, TypeId.INT16: 16, TypeId.UINT8: 11,
                TypeId.UINT16: 12, TypeId.UINT32: 13,
                TypeId.UINT64: 14}.get(tid)
        if conv is not None:
            w.field_i32(6, conv)
        # logicalType INTEGER {1: byte bitWidth, 2: bool isSigned}
        w.field_struct_begin(10)
        w.field_struct_begin(10)
        w.buf.append((1 << 4) | 3)  # field 1, type BYTE
        w.buf.append(t.bit_width & 0xFF)
        w._last_fid[-1] = 1
        w.field_bool(2, t.is_signed_integer)
        w.struct_end()
        w.struct_end()


def _plain_encode(t: DataType, arr: Array, present: np.ndarray) -> bytes:
    tid = t.id
    d = arr.data
    if tid == TypeId.BOOL:
        vals = d.values()[present]
        return bitutil.pack_bits(vals).tobytes()
    if tid in (TypeId.STRING, TypeId.BINARY, TypeId.LARGE_STRING,
               TypeId.LARGE_BINARY):
        return host.plain_encode_byte_array(
            d.data_bytes(), d.offsets().astype(np.int64), present)
    if tid in (TypeId.DECIMAL128, TypeId.FIXED_SIZE_BINARY):
        w = t.byte_width
        vals = d.values()[present]
        if tid == TypeId.DECIMAL128:
            # parquet stores decimals big-endian
            return vals[:, ::-1].tobytes()
        return vals.tobytes()
    vals = d.values()[present]
    physical, _ = _physical_for(t)
    np_dt = {INT32: np.int32, INT64: np.int64, FLOAT: np.float32,
             DOUBLE: np.float64}[physical]
    return vals.astype(np_dt).tobytes()


def _stat_bytes(t: DataType, v) -> bytes:
    """Encode one min/max value as Parquet plain statistics bytes."""
    tid = t.id
    if tid == TypeId.BOOL:
        return b"\x01" if v else b"\x00"
    if tid in (TypeId.STRING, TypeId.LARGE_STRING):
        return v.encode() if isinstance(v, str) else bytes(v)
    if tid in (TypeId.BINARY, TypeId.LARGE_BINARY):
        return bytes(v)
    physical, _ = _physical_for(t)
    np_dt = {INT32: "<i4", INT64: "<i8", FLOAT: "<f4",
             DOUBLE: "<f8"}.get(physical)
    if np_dt is None:
        return b""
    return np.asarray(v).astype(np.dtype(np_dt)).tobytes()


def _column_stats(t: DataType, col: Array):
    """(min, max, null_count) for flat columns; Nones when stats do not
    apply (reference: parquet/statistics.h typed statistics)."""
    try:
        present = col.is_valid_mask()
        nulls = int(len(col) - present.sum())
        if t.id == TypeId.BOOL:
            vals = col.data.values()[present]
            if len(vals) == 0:
                return None, None, nulls
            return bool(vals.min()), bool(vals.max()), nulls
        if t.id in (TypeId.STRING, TypeId.LARGE_STRING,
                    TypeId.BINARY, TypeId.LARGE_BINARY):
            d = col.data
            mn_i, mx_i, count = host.minmax_binary(
                d.data_bytes(), d.offsets().astype(np.int64), present)
            if count == 0:
                return None, None, nulls
            offs = d.offsets()
            raw = d.data_bytes()
            lo = raw[offs[mn_i]:offs[mn_i + 1]].tobytes()
            hi = raw[offs[mx_i]:offs[mx_i + 1]].tobytes()
            if t.id in (TypeId.STRING, TypeId.LARGE_STRING):
                lo, hi = lo.decode(), hi.decode()
            return lo, hi, nulls
        vals = col.data.values()
        if nulls:
            vals = vals[present]
        if len(vals) == 0 or not np.issubdtype(vals.dtype, np.number):
            return None, None, nulls
        if np.issubdtype(vals.dtype, np.floating):
            finite = np.isfinite(vals)
            if not finite.all():
                vals = vals[finite]
            if len(vals) == 0:
                return None, None, nulls
        return vals.min(), vals.max(), nulls
    except Exception:
        return None, None, None


def _compress(codec: int, data: bytes) -> bytes:
    if codec == CODEC_UNCOMPRESSED:
        return data
    if codec == CODEC_ZSTD:
        if _zstd is None:
            raise NotImplementedError("zstandard not available")
        return _zstd.ZstdCompressor().compress(data)
    if codec == CODEC_SNAPPY:
        from ...utils import snappy
        return snappy.compress(data)
    if codec == CODEC_GZIP:
        import zlib
        co = zlib.compressobj(9, zlib.DEFLATED, 31)
        return co.compress(data) + co.flush()
    if codec == CODEC_BROTLI:
        from ...utils import brotli_ctypes
        return brotli_ctypes.compress(data)
    raise NotImplementedError(f"codec {codec}")


def _dictionary_encode(col: Array):
    """(codes int32, the dictionary Array) of a variable-size binary
    column, in order of first appearance, a null coded as the empty
    value: the reference's dictionary page (device/column.py
    ``_dictionary_encode_host``)."""
    d = col.data
    mask = d.validity_mask()
    codes, uoffs, ubytes = host.dict_encode_binary(
        d.data_bytes(), d.offsets().astype(np.int64),
        None if mask is None else mask.astype(np.uint8))
    dict_type = T.string() if col.type.id in (
        TypeId.STRING, TypeId.LARGE_STRING) else T.binary()
    return codes, Array(ArrayData(dict_type, len(uoffs) - 1, [
        None, Buffer(uoffs), Buffer(ubytes)], null_count=0))


def _dictionary_value_bytes(col: Array) -> int:
    """The bytes of a dictionary column's valid values, row by row, as
    the reference sums them over ``to_pylist()`` (UTF-8 bytes of a
    string): from the dictionary's offsets, without a Python value a
    row."""
    d = col.data
    dd = d.dictionary
    if dd.type.id not in (TypeId.STRING, TypeId.BINARY, TypeId.LARGE_STRING,
                          TypeId.LARGE_BINARY):
        return sum(len(v.encode() if isinstance(v, str) else v)
                   for v in col.to_pylist() if v is not None)
    lens = np.diff(dd.offsets().astype(np.int64))
    dvalid = dd.validity_mask()
    if dvalid is not None:
        lens = np.where(dvalid, lens, 0)
    codes = d.values().astype(np.int64)
    valid = d.validity_mask()
    if valid is not None:
        codes = codes[valid]
    return int(lens[codes].sum())


def _compress_pages(codec: int, payloads: List[bytes]) -> List[bytes]:
    """Each page compressed, in order; several pages on threads (the
    codecs release Python's lock), which changes no byte."""
    if codec == CODEC_UNCOMPRESSED or len(payloads) < 2:
        return [_compress(codec, p) for p in payloads]
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=min(8, len(payloads))) as ex:
        return list(ex.map(lambda p: _compress(codec, p), payloads))


def _page_header(ptype: int, uncomp: int, comp: int,
                 data_hdr: Optional[Dict] = None,
                 dict_hdr: Optional[Dict] = None) -> bytes:
    w = CompactWriter()
    w.field_i32(1, ptype)
    w.field_i32(2, uncomp)
    w.field_i32(3, comp)
    if data_hdr is not None:
        w.field_struct_begin(5)
        w.field_i32(1, data_hdr["num_values"])
        w.field_i32(2, data_hdr["encoding"])
        w.field_i32(3, ENC_RLE)
        w.field_i32(4, ENC_RLE)
        w.struct_end()
    if dict_hdr is not None:
        w.field_struct_begin(7)
        w.field_i32(1, dict_hdr["num_values"])
        w.field_i32(2, ENC_PLAIN)
        w.struct_end()
    w.struct_end()
    return w.bytes()


class ParquetWriter:
    def __init__(self, sink: Union[str, BinaryIO], schema: Schema,
                 compression: Optional[str] = None,
                 use_dictionary: bool = True,
                 write_bloom_filters: bool = False,
                 column_encoding=None,
                 encryption_properties=None,
                 data_page_size: Optional[int] = 1024 * 1024):
        self._close = False
        if isinstance(sink, str):
            sink = open(sink, "wb")
            self._close = True
        self.sink = sink
        self.schema = schema
        self.codec = {None: CODEC_UNCOMPRESSED, "none": CODEC_UNCOMPRESSED,
                      "zstd": CODEC_ZSTD, "snappy": CODEC_SNAPPY,
                      "gzip": CODEC_GZIP, "brotli": CODEC_BROTLI}[
            compression.lower() if isinstance(compression, str)
            else compression]
        self.use_dictionary = use_dictionary
        self.write_bloom_filters = write_bloom_filters
        # per-column encoding overrides, pyarrow-style:
        # {"col": "BYTE_STREAM_SPLIT" | "DELTA_BINARY_PACKED"}
        self.column_encoding = dict(column_encoding or {})
        self.encryption = encryption_properties
        # byte budget per data page (parquet/properties.h
        # kDefaultDataPageSize = 1 MiB); None = one page per chunk
        self.data_page_size = data_page_size
        self.row_groups: List[Dict] = []
        self.num_rows = 0
        if self.encryption is not None and \
                not self.encryption.plaintext_footer:
            from .encryption import MAGIC_ENCRYPTED
            self.sink.write(MAGIC_ENCRYPTED)
        else:
            self.sink.write(MAGIC)
        self.pos = 4

    def _crypto_for(self, path_name: str):
        """FileColumnCryptoState for the column, or None (plaintext).
        Returns (state, is_footer_key, key_metadata)."""
        if self.encryption is None:
            return None, False, b""
        from .encryption import ALG_AES_GCM_CTR_V1, FileColumnCryptoState
        p = self.encryption
        ctr = p.algorithm == ALG_AES_GCM_CTR_V1
        if path_name in p.column_keys:
            return (FileColumnCryptoState(p.column_keys[path_name],
                                          p.file_aad, ctr), False,
                    p.column_key_metadata.get(path_name, b""))
        if p.uniform:
            return (FileColumnCryptoState(p.footer_key, p.file_aad, ctr),
                    True, b"")
        return None, False, b""

    def _w(self, data: bytes) -> int:
        off = self.pos
        self.sink.write(data)
        self.pos += len(data)
        return off

    def write_table(self, tbl: Table, row_group_size: Optional[int] = None):
        for rb in tbl.to_batches(row_group_size):
            self.write_batch(rb)

    def write(self, table_or_batch, row_group_size: Optional[int] = None):
        """pyarrow ParquetWriter.write: accepts Table or RecordBatch."""
        if isinstance(table_or_batch, RecordBatch):
            self.write_batch(table_or_batch)
        else:
            self.write_table(table_or_batch, row_group_size)

    def add_key_value_metadata(self, key_value_metadata) -> None:
        """Extra footer key/value metadata
        (pyarrow ParquetWriter.add_key_value_metadata)."""
        kv = getattr(self, "_extra_kv", {})
        for k, v in dict(key_value_metadata).items():
            kv[k if isinstance(k, str) else k.decode()] = \
                v if isinstance(v, str) else v.decode()
        self._extra_kv = kv

    def write_batch(self, rb: RecordBatch):
        from .nested import is_nested, shred
        chunks = []
        rg_ord = len(self.row_groups)
        for f, col in zip(self.schema.fields, rb.columns):
            if is_nested(f.type):
                rows = col.to_pylist()
                for spec, defs, reps, vals in shred(f.name, f.type, rows,
                                                    f.nullable):
                    chunks.append(self._write_leaf_chunk(
                        spec, defs, reps, vals, rg_ord, len(chunks)))
            else:
                c = self._write_column(f.type, col, name=f.name,
                                       rg_ord=rg_ord,
                                       col_ord=len(chunks),
                                       nullable=f.nullable)
                c["path"] = [f.name]
                chunks.append(c)
        self.row_groups.append({
            "columns": chunks, "num_rows": rb.num_rows,
            "total_byte_size": sum(c["total_uncompressed_size"]
                                   for c in chunks)})
        self.num_rows += rb.num_rows

    def _rows_per_page(self, t: DataType, col: Array, physical,
                       type_length: int, n: int) -> int:
        """Rows per data page targeting ``data_page_size`` bytes
        (parquet/properties.h kDefaultDataPageSize analogue)."""
        if self.data_page_size is None or n == 0:
            return max(n, 1)
        if physical == BYTE_ARRAY:
            if col.type.id in (TypeId.STRING, TypeId.BINARY,
                               TypeId.LARGE_STRING, TypeId.LARGE_BINARY):
                offs = col.data.offsets()
                total = int(offs[-1] - offs[0])
            else:
                total = _dictionary_value_bytes(col)
            bpr = total / max(n, 1) + 4
        elif physical == FLBA:
            bpr = max(type_length, 1)
        elif physical in (INT32, FLOAT):
            bpr = 4
        elif physical == BOOLEAN:
            bpr = 0.125
        else:
            bpr = 8
        return max(1, min(n, int(self.data_page_size / max(bpr, 0.125))))

    def _write_data_page(self, payload: bytes, comp_payload: bytes,
                         n_vals: int, enc: int, crypto, rg_ord: int,
                         col_ord: int, page_ord: int) -> Dict:
        """Write one data page, ``comp_payload`` the compressed
        ``payload``; returns {offset, comp, uncomp}."""
        if crypto is not None:
            from .encryption import MOD_DATA_PAGE, MOD_DATA_PAGE_HEADER
            comp_payload = crypto.encrypt(MOD_DATA_PAGE, comp_payload,
                                          rg_ord, col_ord, page=page_ord)
            hdr = _page_header(PAGE_DATA, len(payload), len(comp_payload),
                               data_hdr={"num_values": n_vals,
                                         "encoding": enc})
            hdr = crypto.encrypt(MOD_DATA_PAGE_HEADER, hdr,
                                 rg_ord, col_ord, page=page_ord)
        else:
            hdr = _page_header(PAGE_DATA, len(payload), len(comp_payload),
                               data_hdr={"num_values": n_vals,
                                         "encoding": enc})
        off = self._w(hdr + comp_payload)
        return {"offset": off, "comp": len(hdr) + len(comp_payload),
                "uncomp": len(hdr) + len(payload)}

    def _write_column(self, t: DataType, col: Array,
                      name: Optional[str] = None,
                      rg_ord: int = 0, col_ord: int = 0,
                      nullable: bool = True) -> Dict:
        """One flat column chunk. A non-nullable column is a REQUIRED leaf
        (``_footer``'s schema): its pages carry no definition levels."""
        n = len(col)
        present = col.is_valid_mask()
        if not nullable and not present.all():
            raise ValueError(f"column {name!r} is declared non-nullable "
                             "but holds nulls")
        physical, type_length = _physical_for(t)
        crypto, uses_footer_key, key_md = self._crypto_for(name or "")

        override = self.column_encoding.get(name)
        use_dict = (self.use_dictionary and physical == BYTE_ARRAY
                    and override is None)
        encodings = [ENC_RLE, ENC_PLAIN]
        dict_page_offset = None
        total_comp = 0
        total_uncomp = 0

        codes = dict_arr = None
        if use_dict:
            if t.id == TypeId.DICTIONARY:
                codes = col.data.values().astype(np.int64)
                dict_arr = Array(col.data.dictionary)
            else:
                codes, dict_arr = _dictionary_encode(col)
                codes = codes.astype(np.int64)
            dict_present = np.ones(len(dict_arr), dtype=bool)
            dict_payload = _plain_encode(
                dict_arr.type, dict_arr, dict_present)
            comp_dict = _compress(self.codec, dict_payload)
            if crypto is not None:
                from .encryption import (MOD_DICT_PAGE,
                                         MOD_DICT_PAGE_HEADER)
                comp_dict = crypto.encrypt(MOD_DICT_PAGE, comp_dict,
                                           rg_ord, col_ord)
                hdr = _page_header(PAGE_DICT, len(dict_payload),
                                   len(comp_dict),
                                   dict_hdr={"num_values": len(dict_arr)})
                hdr = crypto.encrypt(MOD_DICT_PAGE_HEADER, hdr,
                                     rg_ord, col_ord)
            else:
                hdr = _page_header(PAGE_DICT, len(dict_payload),
                                   len(comp_dict),
                                   dict_hdr={"num_values": len(dict_arr)})
            dict_page_offset = self._w(hdr + comp_dict)
            total_comp += len(hdr) + len(comp_dict)
            total_uncomp += len(hdr) + len(dict_payload)
            enc = ENC_RLE_DICTIONARY
            encodings.append(ENC_RLE_DICTIONARY)
        elif override == "BYTE_STREAM_SPLIT":
            if physical not in (INT32, INT64, FLOAT, DOUBLE, FLBA):
                raise ValueError(
                    f"BYTE_STREAM_SPLIT unsupported for {t!r}")
            enc = ENC_BYTE_STREAM_SPLIT
            encodings.append(ENC_BYTE_STREAM_SPLIT)
        elif override == "DELTA_BINARY_PACKED":
            if physical not in (INT32, INT64):
                raise ValueError(
                    f"DELTA_BINARY_PACKED unsupported for {t!r}")
            enc = ENC_DELTA_BINARY_PACKED
            encodings.append(ENC_DELTA_BINARY_PACKED)
        elif override is not None:
            raise ValueError(f"unknown column_encoding {override!r}")
        else:
            enc = ENC_PLAIN

        def page_payload(s: int, e: int) -> bytes:
            """def-levels + encoded body for rows [s, e)."""
            pres = present[s:e]
            def_block = b""
            if nullable:
                defs = encode_rle(pres.astype(np.int64), 1)
                def_block = struct.pack("<i", len(defs)) + defs
            if use_dict:
                bw = bit_width_for(max(len(dict_arr) - 1, 1))
                idx = codes[s:e][pres]
                body = bytes([bw]) + encode_rle(idx, bw)
            elif enc == ENC_BYTE_STREAM_SPLIT:
                from .delta import encode_byte_stream_split
                vals = col.slice(s, e - s).data.values()[pres]
                np_dt = {INT32: np.int32, INT64: np.int64,
                         FLOAT: np.float32,
                         DOUBLE: np.float64}.get(physical)
                if np_dt is not None:
                    vals = vals.astype(np_dt)
                body = encode_byte_stream_split(vals)
            elif enc == ENC_DELTA_BINARY_PACKED:
                from .delta import encode_delta_binary_packed
                vals = np.asarray(
                    col.slice(s, e - s).data.values()[pres], np.int64)
                body = encode_delta_binary_packed(vals)
            else:
                body = _plain_encode(t, col.slice(s, e - s), pres)
            return def_block + body

        rows_per_page = self._rows_per_page(t, col, physical,
                                            type_length, n)
        pages: List[Dict] = []
        starts = list(range(0, n, rows_per_page)) or [0]
        ends = [min(s + rows_per_page, n) for s in starts]
        payloads = [page_payload(s, e) for s, e in zip(starts, ends)]
        compressed = _compress_pages(self.codec, payloads)
        for page_ord, (s, e) in enumerate(zip(starts, ends)):
            info = self._write_data_page(
                payloads[page_ord], compressed[page_ord], e - s, enc,
                crypto, rg_ord, col_ord, page_ord)
            total_comp += info["comp"]
            total_uncomp += info["uncomp"]
            pmn, pmx, pnulls = _column_stats(t, col.slice(s, e - s)) \
                if len(starts) > 1 else (None, None, None)
            pages.append({"offset": info["offset"],
                          "size": info["comp"],
                          "first_row": s, "min": pmn, "max": pmx,
                          "nulls": pnulls})
        data_page_offset = pages[0]["offset"]

        mn, mx, nulls = _column_stats(t, col)
        bloom = self._build_bloom(t, col, physical)
        return {
            "crypto": crypto, "uses_footer_key": uses_footer_key,
            "key_metadata": key_md,
            "rg_ord": rg_ord, "col_ord": col_ord,
            "bloom": bloom,
            "physical": physical, "type_length": type_length,
            "encodings": encodings, "codec": self.codec,
            "num_values": n,
            "total_uncompressed_size": total_uncomp,
            "total_compressed_size": total_comp,
            "data_page_offset": data_page_offset,
            "dictionary_page_offset": dict_page_offset,
            "stats": (None if mn is None else _stat_bytes(t, mn),
                      None if mx is None else _stat_bytes(t, mx),
                      nulls),
            "pages": [dict(
                p, min=(None if p["min"] is None
                        else _stat_bytes(t, p["min"])),
                max=(None if p["max"] is None
                     else _stat_bytes(t, p["max"]))) for p in pages],
            "page_size": pages[0]["size"],
        }

    def _build_bloom(self, t, col, physical):
        """SBBF over the chunk's distinct values (parquet
        bloom_filter.h BlockSplitBloomFilter)."""
        if not self.write_bloom_filters:
            return None
        from .bloom import (SplitBlockBloomFilter, hash_value,
                            xxhash64_u32, xxhash64_u64)
        try:
            # vectorized distinct for plain fixed-width numeric columns
            if (t.is_integer and physical in (INT32, INT64)) or \
                    (t.is_floating and physical in (FLOAT, DOUBLE)):
                present = col.is_valid_mask()
                vals = col.data.values()[present]
                # cheap sample gate: bloom filters only apply up to
                # 64Ki distinct values; a 128Ki-row sample with more
                # than 64Ki distinct values PROVES the full column
                # exceeds the cap (the sample's distinct count is a
                # lower bound on the column's) without paying a
                # full-column sort (measured: 125 ms full unique vs
                # ~2 ms sample on 2M f64 rows)
                if len(vals) > 1 << 17:
                    sample = np.unique(vals[: 1 << 17])
                    if len(sample) > 65536:
                        return None
                uniq = np.unique(vals)
                if len(uniq) == 0 or len(uniq) > 65536:
                    return None
                bf = SplitBlockBloomFilter.for_ndv(len(uniq))
                if physical == INT64:
                    hashes = xxhash64_u64(
                        uniq.astype(np.int64).view(np.uint64))
                elif physical == INT32:
                    hashes = xxhash64_u32(
                        uniq.astype(np.int32).view(np.uint32))
                elif physical == DOUBLE:
                    # hash of the value's plain encoding (IEEE bytes)
                    hashes = xxhash64_u64(
                        uniq.astype(np.float64).view(np.uint64))
                else:
                    hashes = xxhash64_u32(
                        uniq.astype(np.float32).view(np.uint32))
                for h in hashes:
                    bf.insert_hash(int(h))
                return bf
            if physical == BYTE_ARRAY and t.id in (
                    TypeId.STRING, TypeId.BINARY, TypeId.LARGE_STRING,
                    TypeId.LARGE_BINARY):
                d = col.data
                valid = col.is_valid_mask().astype(np.uint8)
                _, uoffs, ubytes = host.dict_encode_binary(
                    d.data_bytes(), d.offsets().astype(np.int64),
                    valid if not valid.all() else None)
                raw = ubytes.tobytes()
                distinct = {raw[uoffs[i]:uoffs[i + 1]]
                            for i in range(len(uoffs) - 1)}
                if not valid.all():
                    # a null is coded as the empty value: drop it unless
                    # a valid row is empty
                    empties = ((d.offsets()[1:] - d.offsets()[:-1])
                               == 0) & (valid != 0)
                    if not empties.any():
                        distinct.discard(b"")
                if not distinct or len(distinct) > 65536:
                    return None
                bf = SplitBlockBloomFilter.for_ndv(len(distinct))
                for v in distinct:
                    bf.insert_hash(hash_value(v, physical))
                return bf
            vals = col.to_pylist()
            distinct = {v for v in vals if v is not None}
            if not distinct or len(distinct) > 65536:
                return None
            bf = SplitBlockBloomFilter.for_ndv(len(distinct))
            if physical == INT64 and t.id not in (TypeId.DECIMAL128,):
                arr = np.array(sorted(int(v) for v in distinct),
                               dtype=np.int64).view(np.uint64)
                for h in xxhash64_u64(arr):
                    bf.insert_hash(int(h))
            elif physical == INT32:
                arr = np.array(sorted(int(v) for v in distinct),
                               dtype=np.int32).view(np.uint32)
                for h in xxhash64_u32(arr):
                    bf.insert_hash(int(h))
            else:
                for v in distinct:
                    bf.insert_hash(hash_value(v, physical))
            return bf
        except (NotImplementedError, TypeError):
            return None

    def _write_leaf_chunk(self, spec, defs, reps, vals,
                          rg_ord: int = 0, col_ord: int = 0) -> Dict:
        """One Parquet leaf under a nested field: rep + def RLE blocks,
        PLAIN-encoded present values (parquet/arrow/path_internal.cc
        analogue)."""
        from ...array.array import array as make_array
        n = len(defs)
        physical, type_length = _physical_for(spec.type)
        crypto, uses_footer_key, key_md = self._crypto_for(
            ".".join(spec.path))
        blocks = b""
        if spec.max_rep > 0:
            rb = encode_rle(reps.astype(np.int64),
                            bit_width_for(spec.max_rep))
            blocks += struct.pack("<i", len(rb)) + rb
        db = encode_rle(defs.astype(np.int64), bit_width_for(spec.max_def))
        blocks += struct.pack("<i", len(db)) + db
        leaf_arr = make_array(vals, spec.type)
        body = _plain_encode(spec.type, leaf_arr,
                             np.ones(len(vals), dtype=bool))
        payload = blocks + body
        comp_payload = _compress(self.codec, payload)
        if crypto is not None:
            from .encryption import MOD_DATA_PAGE, MOD_DATA_PAGE_HEADER
            comp_payload = crypto.encrypt(MOD_DATA_PAGE, comp_payload,
                                          rg_ord, col_ord, page=0)
            hdr = _page_header(PAGE_DATA, len(payload), len(comp_payload),
                               data_hdr={"num_values": n,
                                         "encoding": ENC_PLAIN})
            hdr = crypto.encrypt(MOD_DATA_PAGE_HEADER, hdr,
                                 rg_ord, col_ord, page=0)
        else:
            hdr = _page_header(PAGE_DATA, len(payload), len(comp_payload),
                               data_hdr={"num_values": n,
                                         "encoding": ENC_PLAIN})
        data_page_offset = self._w(hdr + comp_payload)
        return {
            "crypto": crypto, "uses_footer_key": uses_footer_key,
            "key_metadata": key_md,
            "rg_ord": rg_ord, "col_ord": col_ord,
            "physical": physical, "type_length": type_length,
            "encodings": [ENC_RLE, ENC_PLAIN], "codec": self.codec,
            "num_values": n,
            "total_uncompressed_size": len(hdr) + len(payload),
            "total_compressed_size": len(hdr) + len(comp_payload),
            "data_page_offset": data_page_offset,
            "dictionary_page_offset": None,
            "path": list(spec.path),
        }

    def _write_blooms(self):
        """BloomFilterHeader + bitset per chunk; referenced from
        ColumnMetaData fields 14/15."""
        for rg in self.row_groups:
            for c in rg["columns"]:
                bf = c.get("bloom")
                if bf is None:
                    continue
                hw = CompactWriter()
                hw.field_i32(1, bf.num_bytes)
                hw.field_struct_begin(2)    # algorithm = BLOCK
                hw.field_struct_begin(1)
                hw.struct_end()
                hw.struct_end()
                hw.field_struct_begin(3)    # hash = XXHASH
                hw.field_struct_begin(1)
                hw.struct_end()
                hw.struct_end()
                hw.field_struct_begin(4)    # compression = UNCOMPRESSED
                hw.field_struct_begin(1)
                hw.struct_end()
                hw.struct_end()
                hw.struct_end()
                hdr_blob, bitset_blob = hw.bytes(), bf.bitset()
                crypto = c.get("crypto")
                if crypto is not None:
                    from .encryption import (MOD_BLOOM_BITSET,
                                             MOD_BLOOM_HEADER)
                    hdr_blob = crypto.encrypt(
                        MOD_BLOOM_HEADER, hdr_blob,
                        c["rg_ord"], c["col_ord"])
                    bitset_blob = crypto.encrypt(
                        MOD_BLOOM_BITSET, bitset_blob,
                        c["rg_ord"], c["col_ord"])
                blob = hdr_blob + bitset_blob
                c["bloom_offset"] = self._w(blob)
                c["bloom_length"] = len(blob)

    def _write_page_indexes(self):
        """ColumnIndex/OffsetIndex (parquet page_index.h), one entry per
        data page."""
        for rg in self.row_groups:
            for c in rg["columns"]:
                pages = c.get("pages") or [
                    {"offset": c["data_page_offset"],
                     "size": c.get("page_size",
                                   c["total_compressed_size"]),
                     "first_row": 0, "min": None, "max": None,
                     "nulls": None}]
                st = c.get("stats") or (None, None, None)
                if len(pages) == 1:
                    # single page: reuse the chunk-level statistics
                    pages = [dict(pages[0], min=st[0], max=st[1],
                                  nulls=st[2])]
                w = CompactWriter()
                w.field_list_begin(1, CT_BOOL_TRUE, len(pages))
                for p in pages:
                    w.buf.append(1 if (p["min"] is None and
                                       p["max"] is None) else 2)
                w.field_list_begin(2, CT_BINARY, len(pages))
                for p in pages:
                    w.elem_binary(p["min"] if p["min"] is not None
                                  else b"")
                w.field_list_begin(3, CT_BINARY, len(pages))
                for p in pages:
                    w.elem_binary(p["max"] if p["max"] is not None
                                  else b"")
                w.field_i32(4, 0)      # boundary_order UNORDERED
                if all(p["nulls"] is not None for p in pages):
                    w.field_list_begin(5, CT_I64, len(pages))
                    for p in pages:
                        w.elem_i64(p["nulls"])
                w.struct_end()
                blob = w.bytes()
                if c.get("crypto") is not None:
                    from .encryption import MOD_COLUMN_INDEX
                    blob = c["crypto"].encrypt(
                        MOD_COLUMN_INDEX, blob, c["rg_ord"], c["col_ord"])
                c["column_index_offset"] = self._w(blob)
                c["column_index_length"] = len(blob)
                c["_pages_for_offset_index"] = pages
            for c in rg["columns"]:
                pages = c["_pages_for_offset_index"]
                w = CompactWriter()
                w.field_list_begin(1, CT_STRUCT, len(pages))
                for p in pages:
                    w.elem_struct_begin()
                    w.field_i64(1, p["offset"])
                    w.field_i32(2, p["size"])
                    w.field_i64(3, p["first_row"])
                    w.struct_end()
                w.struct_end()
                blob = w.bytes()
                if c.get("crypto") is not None:
                    from .encryption import MOD_OFFSET_INDEX
                    blob = c["crypto"].encrypt(
                        MOD_OFFSET_INDEX, blob, c["rg_ord"], c["col_ord"])
                c["offset_index_offset"] = self._w(blob)
                c["offset_index_length"] = len(blob)

    def close(self):
        self._write_blooms()
        self._write_page_indexes()
        footer = self._footer()
        if self.encryption is not None and \
                self.encryption.plaintext_footer:
            # plaintext-footer mode (file_writer.cc:483-488): plaintext
            # FileMetaData (with encryption_algorithm + signing key
            # metadata fields) || nonce+tag signature || i32 len || PAR1
            from .encryption import sign_footer
            p = self.encryption
            sig = sign_footer(p.footer_key, p.file_aad, footer)
            self._w(footer)
            self._w(sig)
            self.sink.write(struct.pack("<i", len(footer) + len(sig)))
            self.sink.write(MAGIC)
            if self._close:
                self.sink.close()
            return
        if self.encryption is not None:
            # encrypted-footer layout (parquet/file_writer.cc
            # WriteEncryptedFileMetadata): FileCryptoMetaData (plain
            # thrift) || encrypted FileMetaData module || i32 combined
            # length || "PARE"
            from .encryption import (ALG_AES_GCM_CTR_V1, MAGIC_ENCRYPTED,
                                     MOD_FOOTER, FileColumnCryptoState)
            p = self.encryption
            crypto = FileColumnCryptoState(p.footer_key, p.file_aad,
                                           False)
            enc_footer = crypto.encrypt(MOD_FOOTER, footer)
            cw = CompactWriter()
            alg_field = 2 if p.algorithm == ALG_AES_GCM_CTR_V1 else 1
            cw.field_struct_begin(1)          # EncryptionAlgorithm union
            cw.field_struct_begin(alg_field)  # AesGcm[Ctr]V1
            if p.aad_prefix and not p.supply_aad_prefix:
                cw.field_binary(1, p.aad_prefix)
            cw.field_binary(2, p.aad_file_unique)
            if p.aad_prefix:
                if p.supply_aad_prefix:
                    cw.field_bool(3, True)
            cw.struct_end()
            cw.struct_end()
            if p.footer_key_metadata:
                cw.field_binary(2, p.footer_key_metadata)
            cw.buf.append(0)  # top-level struct stop
            crypto_md = cw.bytes()
            self._w(crypto_md)
            self._w(enc_footer)
            self.sink.write(struct.pack(
                "<i", len(crypto_md) + len(enc_footer)))
            self.sink.write(MAGIC_ENCRYPTED)
        else:
            self._w(footer)
            self.sink.write(struct.pack("<i", len(footer)))
            self.sink.write(MAGIC)
        if self._close:
            self.sink.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _column_meta(self, w: CompactWriter, c: Dict, path,
                     redact: bool = False) -> None:
        """ColumnMetaData fields (parquet.thrift struct; emitted either
        inline as ColumnChunk field 3 or as an encrypted module).
        ``redact`` drops statistics (plaintext-footer legacy copy)."""
        w.field_i32(1, c["physical"])
        w.field_list_begin(2, CT_I32, len(c["encodings"]))
        for e in c["encodings"]:
            w.elem_i32(e)
        w.field_list_begin(3, CT_BINARY, len(path))
        for pc in path:
            w.elem_binary(pc.encode())
        w.field_i32(4, c["codec"])
        w.field_i64(5, c["num_values"])
        w.field_i64(6, c["total_uncompressed_size"])
        w.field_i64(7, c["total_compressed_size"])
        w.field_i64(9, c["data_page_offset"])
        if c.get("dictionary_page_offset") is not None:
            w.field_i64(11, c["dictionary_page_offset"])
        if "bloom_offset" in c:
            w.field_i64(14, c["bloom_offset"])
            w.field_i32(15, c["bloom_length"])
        st = None if redact else c.get("stats")
        if st is not None and (st[0] is not None or st[2] is not None):
            mn, mx, nulls = st
            w.field_struct_begin(12)  # Statistics
            if nulls is not None:
                w.field_i64(3, nulls)
            if mx is not None:
                w.field_binary(5, mx)   # max_value
            if mn is not None:
                w.field_binary(6, mn)   # min_value
            w.struct_end()

    def _footer(self) -> bytes:
        w = CompactWriter()
        w.field_i32(1, 2)  # version
        # schema elements (depth-first tree; lists in 3-level form)
        elems = []
        from ...types import TypeId as _Tid

        def emit_elem(name, t, repetition, num_children=None,
                      converted=None):
            elems.append((name, t, repetition, num_children, converted))

        def walk(name, t, repetition=1):
            if t.id in (_Tid.LIST, _Tid.LARGE_LIST):
                emit_elem(name, None, repetition, 1, 3)  # LIST
                emit_elem("list", None, 2, 1, None)      # repeated group
                walk("element", t.value_type)
            elif t.id == _Tid.STRUCT:
                emit_elem(name, None, repetition, len(t.fields), None)
                for f2 in t.fields:
                    walk(f2.name, f2.type)
            else:
                emit_elem(name, t, repetition, None, None)

        for f in self.schema.fields:
            walk(f.name, f.type, 1 if f.nullable else 0)

        w.field_list_begin(2, CT_STRUCT, len(elems) + 1)
        w.elem_struct_begin()
        w.field_binary(4, b"schema")
        w.field_i32(5, len(self.schema))
        w.struct_end()
        for name, t, repetition, num_children, converted in elems:
            w.elem_struct_begin()
            if t is not None:
                physical, type_length = _physical_for(t)
                w.field_i32(1, physical)
                if type_length:
                    w.field_i32(2, type_length)
            w.field_i32(3, repetition)
            w.field_binary(4, name.encode())
            if num_children:
                w.field_i32(5, num_children)
            if converted is not None:
                w.field_i32(6, converted)
            if t is not None:
                _write_logical(w, t)
            w.struct_end()
        w.field_i64(3, self.num_rows)
        # row groups
        w.field_list_begin(4, CT_STRUCT, len(self.row_groups))
        for rg_idx, rg in enumerate(self.row_groups):
            w.elem_struct_begin()
            w.field_list_begin(1, CT_STRUCT, len(rg["columns"]))
            for c in rg["columns"]:
                path = c.get("path", ["?"])
                w.elem_struct_begin()  # ColumnChunk
                w.field_i64(2, c["data_page_offset"])
                if "offset_index_offset" in c:
                    w.field_i64(4, c["offset_index_offset"])
                    w.field_i32(5, c["offset_index_length"])
                    w.field_i64(6, c["column_index_offset"])
                    w.field_i32(7, c["column_index_length"])
                crypto = c.get("crypto")
                plaintext_footer = (self.encryption is not None and
                                    self.encryption.plaintext_footer)

                def enc_column_meta():
                    cm = CompactWriter()
                    self._column_meta(cm, c, path)
                    cm.buf.append(0)  # struct stop
                    from .encryption import MOD_COLUMN_METADATA
                    return crypto.encrypt(
                        MOD_COLUMN_METADATA, cm.bytes(),
                        c["rg_ord"], c["col_ord"])

                if crypto is not None and not c["uses_footer_key"]:
                    # column-key encryption: full ColumnMetaData moves
                    # into field 9 as an encrypted module; field 8
                    # records the key metadata (union 2). In plaintext-
                    # footer mode a REDACTED copy (no statistics) stays
                    # in field 3 for legacy readers (metadata.cc:1790+)
                    if plaintext_footer:
                        w.field_struct_begin(3)
                        self._column_meta(w, c, path, redact=True)
                        w.struct_end()
                    enc_meta = enc_column_meta()
                    w.field_struct_begin(8)
                    w.field_struct_begin(2)  # ENCRYPTION_WITH_COLUMN_KEY
                    w.field_list_begin(1, CT_BINARY, len(path))
                    for pc in path:
                        w.elem_binary(pc.encode())
                    if c["key_metadata"]:
                        w.field_binary(2, c["key_metadata"])
                    w.struct_end()
                    w.struct_end()
                    w.field_binary(9, enc_meta)
                elif crypto is not None and plaintext_footer:
                    # footer-key column in plaintext-footer mode: the
                    # footer is readable by anyone, so the real
                    # ColumnMetaData is encrypted into field 9 too
                    w.field_struct_begin(3)
                    self._column_meta(w, c, path, redact=True)
                    w.struct_end()
                    enc_meta = enc_column_meta()
                    w.field_struct_begin(8)
                    w.field_struct_begin(1)  # WITH_FOOTER_KEY
                    w.struct_end()
                    w.struct_end()
                    w.field_binary(9, enc_meta)
                else:
                    w.field_struct_begin(3)  # ColumnMetaData
                    self._column_meta(w, c, path)
                    w.struct_end()
                    if crypto is not None:
                        w.field_struct_begin(8)
                        w.field_struct_begin(1)  # WITH_FOOTER_KEY
                        w.struct_end()
                        w.struct_end()
                w.struct_end()
            w.field_i64(2, rg["total_byte_size"])
            w.field_i64(3, rg["num_rows"])
            # ordinal (i16, field 7): readers of encrypted files use it
            # as the row-group ordinal in module AADs and fall back to
            # -1 when unset (metadata.cc:649)
            w.field_i16(7, rg_idx)
            w.struct_end()
        extra_kv = getattr(self, "_extra_kv", None)
        if extra_kv:
            w.field_list_begin(5, CT_STRUCT, len(extra_kv))
            for k, v in extra_kv.items():
                w.elem_struct_begin()
                w.field_binary(1, k.encode())
                w.field_binary(2, v.encode())
                w.struct_end()
        w.field_binary(6, b"arrow_tpu parquet writer")
        # column_orders: readers only trust min_value/max_value when the
        # order is declared (ColumnOrder.TYPE_ORDER per leaf)
        n_leaves = len(self.row_groups[0]["columns"]) \
            if self.row_groups else 0
        if n_leaves:
            w.field_list_begin(7, CT_STRUCT, n_leaves)
            for _ in range(n_leaves):
                w.elem_struct_begin()
                w.field_struct_begin(1)   # TYPE_ORDER
                w.struct_end()
                w.struct_end()
        if self.encryption is not None and \
                self.encryption.plaintext_footer:
            # FileMetaData fields 8/9: encryption_algorithm +
            # footer_signing_key_metadata (parquet.thrift)
            from .encryption import ALG_AES_GCM_CTR_V1
            p = self.encryption
            alg_field = 2 if p.algorithm == ALG_AES_GCM_CTR_V1 else 1
            w.field_struct_begin(8)
            w.field_struct_begin(alg_field)
            if p.aad_prefix and not p.supply_aad_prefix:
                w.field_binary(1, p.aad_prefix)
            w.field_binary(2, p.aad_file_unique)
            if p.aad_prefix and p.supply_aad_prefix:
                w.field_bool(3, True)
            w.struct_end()
            w.struct_end()
            if p.footer_key_metadata:
                w.field_binary(9, p.footer_key_metadata)
        w.struct_end()
        return w.bytes()


def write_table(tbl: Table, sink, compression: Optional[str] = None,
                use_dictionary: bool = True,
                row_group_size: Optional[int] = None,
                column_encoding=None, encryption_properties=None):
    with ParquetWriter(sink, tbl.schema, compression,
                       use_dictionary,
                       column_encoding=column_encoding,
                       encryption_properties=encryption_properties) as w:
        w.write_table(tbl, row_group_size)
