"""The Parquet file reader (counterpart of ``arrow_tpu/io/parquet/reader.py``;
reference: cpp/src/parquet/file_reader.h and the Arrow bridge
parquet/arrow/reader.h). Flat and nested schemas (Dremel levels, through
``nested.py``), the PLAIN, dictionary, RLE, DELTA_* and BYTE_STREAM_SPLIT
encodings, v1 and v2 data pages, bloom filters, the page index, AES
encryption, and the codecs of ``writer.py``.

A column chunk is read by one of the reference's two routes, in the same
roles. A flat fixed-width column whose pages are uncompressed or snappy,
with PLAIN or dictionary values, is decoded whole by two calls of the host
library (``_read_chunk_fast``: ``pq_scan_pages`` parses every page header,
``pq_decode_flat`` decodes every page). Everything else (nested columns,
booleans and byte arrays, v2 pages with repetition levels, the delta
encodings, the other codecs, encrypted chunks) takes the page loop
(``_read_chunk_raw``), whose levels, byte arrays and snappy pages are
decoded by the same library. The library is required: where it cannot be
built, a read raises NotImplementedError and takes no other path. The flat
columns of a row group are decoded on up to 8 threads.

``read_table(..., filters=)`` skips the row groups whose statistics (and
bloom filters) rule the filter out, then runs the filter as a plan on
``device``: the card unless ``device="cpu"``.
"""

from __future__ import annotations

import io
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from ... import types as T
from ...array.array import Array
from ...array.data import ArrayData
from ...buffer import Buffer
from ...table import RecordBatch, Table
from ...types import DataType, Field, Schema, TypeId
from ...utils import bits as bitutil
from . import host
from .rle import decode_rle
from .thrift import CompactReader

try:
    import zstandard as _zstd
except ImportError:  # pragma: no cover
    _zstd = None

MAGIC = b"PAR1"

# physical types
BOOLEAN, INT32, INT64, INT96, FLOAT, DOUBLE, BYTE_ARRAY, FLBA = range(8)

# encodings
ENC_PLAIN = 0
ENC_PLAIN_DICTIONARY = 2
ENC_RLE = 3
ENC_DELTA_BINARY_PACKED = 5
ENC_DELTA_LENGTH_BYTE_ARRAY = 6
ENC_DELTA_BYTE_ARRAY = 7
ENC_RLE_DICTIONARY = 8
ENC_BYTE_STREAM_SPLIT = 9

# codecs
CODEC_UNCOMPRESSED = 0
CODEC_SNAPPY = 1
CODEC_GZIP = 2
CODEC_BROTLI = 4
CODEC_ZSTD = 6

PAGE_DATA = 0
PAGE_INDEX = 1
PAGE_DICT = 2
PAGE_DATA_V2 = 3


def _decompress(codec: int, data: bytes, uncompressed_size: int) -> bytes:
    if codec == CODEC_UNCOMPRESSED:
        return data
    if codec == CODEC_ZSTD:
        if _zstd is None:
            raise NotImplementedError("zstandard not available")
        return _zstd.ZstdDecompressor().decompress(
            data, max_output_size=uncompressed_size)
    if codec == CODEC_GZIP:
        import zlib
        return zlib.decompress(data, wbits=31)
    if codec == CODEC_SNAPPY:
        from ...utils import snappy
        return snappy.decompress(data, uncompressed_size)
    if codec == CODEC_BROTLI:
        from ...utils import brotli_ctypes
        if brotli_ctypes.available():
            return brotli_ctypes.decompress(data, uncompressed_size)
        raise NotImplementedError("brotli: libbrotli not available")
    raise NotImplementedError(f"parquet codec {codec} not supported")


class ColumnSchema:
    __slots__ = ("name", "physical", "type_length", "arrow_type",
                 "nullable", "max_def", "max_rep", "nodes")

    def __init__(self, name, physical, type_length, arrow_type, nullable,
                 max_def=None, max_rep=0, nodes=None):
        self.name = name
        self.physical = physical
        self.type_length = type_length
        self.arrow_type = arrow_type
        self.nullable = nullable
        # nested-leaf level structure (nested.py conventions); flat
        # columns get max_def 1/0 by nullability
        self.max_def = max_def if max_def is not None else \
            (1 if nullable else 0)
        self.max_rep = max_rep
        self.nodes = nodes


class FieldDesc:
    """Top-level field: arrow type + its leaf column chunks in order."""

    __slots__ = ("name", "arrow_type", "nullable", "leaves")

    def __init__(self, name, arrow_type, nullable, leaves):
        self.name = name
        self.arrow_type = arrow_type
        self.nullable = nullable
        self.leaves = leaves  # list[ColumnSchema]; len>1 or nested type
                              # => assembled via nested.py


def _logical_to_arrow(elem: Dict, physical: int,
                      type_length: int) -> DataType:
    logical = elem.get(10)
    if logical is not None:
        if 1 in logical:
            return T.string()
        if 5 in logical:   # DECIMAL {1: scale, 2: precision}
            d = logical[5]
            return T.decimal128(d.get(2, 38), d.get(1, 0))
        if 6 in logical:
            return T.date32()
        if 7 in logical:   # TIME {1: utc, 2: unit}
            unit = _time_unit(logical[7].get(2, {}))
            return T.time32(unit) if unit in ("s", "ms") else T.time64(unit)
        if 8 in logical:   # TIMESTAMP
            ts = logical[8]
            unit = _time_unit(ts.get(2, {}))
            tz = "UTC" if ts.get(1) else None
            return T.timestamp(unit, tz)
        if 10 in logical:  # INTEGER {1: bitWidth, 2: isSigned}
            it = logical[10]
            bw, signed = it.get(1, 32), it.get(2, True)
            m = {(8, True): T.int8(), (16, True): T.int16(),
                 (32, True): T.int32(), (64, True): T.int64(),
                 (8, False): T.uint8(), (16, False): T.uint16(),
                 (32, False): T.uint32(), (64, False): T.uint64()}
            return m[(bw, signed)]
    conv = elem.get(6)
    if conv is not None:
        m = {0: T.string(), 6: T.date32(), 7: T.time32("ms"),
             8: T.time64("us"), 9: T.timestamp("ms", "UTC"),
             10: T.timestamp("us", "UTC"),
             15: T.int8(), 16: T.int16(), 17: T.int32(), 18: T.int64(),
             11: T.uint8(), 12: T.uint16(), 13: T.uint32(),
             14: T.uint64()}
        if conv in m:
            return m[conv]
        if conv == 5:  # DECIMAL
            return T.decimal128(elem.get(8, 38), elem.get(7, 0))
    m = {BOOLEAN: T.bool_(), INT32: T.int32(), INT64: T.int64(),
         FLOAT: T.float32(), DOUBLE: T.float64(),
         BYTE_ARRAY: T.binary()}
    if physical in m:
        return m[physical]
    if physical == FLBA:
        return T.fixed_size_binary(type_length)
    if physical == INT96:
        return T.timestamp("ns")
    raise NotImplementedError(f"parquet physical type {physical}")


def _time_unit(unit_union: Dict) -> str:
    if 1 in unit_union:
        return "ms"
    if 2 in unit_union:
        return "us"
    if 3 in unit_union:
        return "ns"
    return "ms"


class ParquetFile:
    def __init__(self, source, decryption_properties=None):
        from ...buffer import Buffer as _Buffer
        if isinstance(source, _Buffer):
            source = source.to_numpy().tobytes()
        if isinstance(source, (bytes, bytearray, memoryview)):
            source = io.BytesIO(source)
        elif isinstance(source, str):
            source = open(source, "rb")
        self.src = source
        import threading
        self._src_lock = threading.Lock()
        self.decryption = decryption_properties
        self._file_crypto = None  # (footer_key, file_aad, ctr_pages)
        self._parse_footer()

    def _parse_footer(self):
        src = self.src
        src.seek(0, 2)
        size = src.tell()
        src.seek(size - 8)
        tail = src.read(8)
        if tail[4:] == b"PARE":
            footer = self._read_encrypted_footer(size, tail)
        elif tail[4:] == MAGIC:
            (flen,) = struct.unpack("<i", tail[:4])
            src.seek(size - 8 - flen)
            footer = src.read(flen)
        else:
            raise ValueError("not a parquet file")
        md = CompactReader(footer).read_struct()
        if 8 in md and self._file_crypto is None:
            # plaintext footer of an encrypted file: FileMetaData
            # fields 8/9 carry the algorithm + signing key metadata;
            # the last 28 bytes of the footer blob are nonce||tag
            self._init_plaintext_footer_crypto(md, footer)
        self.version = md.get(1, 1)
        self.num_rows = md.get(3, 0)
        self.created_by = (md.get(6) or b"").decode("utf8", "replace")
        self.key_value_metadata = {
            kv.get(1, b"").decode(): (kv.get(2) or b"").decode()
            for kv in md.get(5, [])}

        schema_elems = md.get(2, [])
        root = schema_elems[0]
        n_children = root.get(5, 0)
        self.fields: List[FieldDesc] = []
        self._idx = 1

        def parse_node(d, r, nodes):
            """Returns (name, arrow_type, leaves) for the element at
            self._idx (consumes its whole subtree)."""
            elem = schema_elems[self._idx]
            self._idx += 1
            repetition = elem.get(3, 0)
            name = elem.get(4, b"").decode()
            nch = elem.get(5, 0)
            conv = elem.get(6)
            if repetition == 1:
                d += 1
            elif repetition == 2:
                d += 1
                r += 1
            if nch:
                mid = schema_elems[self._idx]
                is_list = conv == 3 and nch == 1 and mid.get(3) == 2
                if is_list:
                    # 3-level LIST: consume the repeated "list" group
                    self._idx += 1
                    d += 1
                    r += 1
                    if mid.get(5, 0) != 1:
                        raise NotImplementedError(
                            "legacy 2-level parquet lists")
                    _, et, leaves = parse_node(
                        d, r, nodes + [("list", d - 1, r)])
                    return name, T.list_(et), leaves
                # struct group
                children = []
                leaves = []
                child_nodes = nodes + ([("opt", d)] if repetition == 1
                                       else nodes[len(nodes):])
                for _ in range(nch):
                    cn, ct, cl = parse_node(d, r, child_nodes)
                    children.append((cn, ct))
                    leaves.extend(cl)
                return name, T.struct(children), leaves
            at = _logical_to_arrow(elem, elem.get(1), elem.get(2, 0))
            cs = ColumnSchema(name, elem.get(1), elem.get(2, 0), at,
                              repetition != 0, d, r,
                              nodes + [("opt", d)])
            return name, at, [cs]

        for _ in range(n_children):
            fi = self._idx
            frep = schema_elems[fi].get(3, 0)
            fname, at, leaves = parse_node(0, 0, [])
            self.fields.append(FieldDesc(fname, at, frep == 1, leaves))

        # flat alias kept for the existing flat-column paths
        self.columns = [fd.leaves[0] for fd in self.fields]

        self.row_groups = md.get(4, [])
        if self._file_crypto is not None:
            self._attach_column_crypto()

    def _read_encrypted_footer(self, size: int, tail: bytes) -> bytes:
        """Encrypted-footer mode (magic PARE): FileCryptoMetaData (plain
        thrift) || encrypted FileMetaData module, combined length in the
        tail (parquet/file_reader.cc ParseMetaDataOfEncryptedFile
        analogue)."""
        from ...compute.registry import ArrowInvalid
        from .encryption import MOD_FOOTER, decrypt_module_gcm, module_aad
        if self.decryption is None:
            raise ArrowInvalid(
                "parquet file has an encrypted footer; pass "
                "decryption_properties")
        (flen,) = struct.unpack("<i", tail[:4])
        self.src.seek(size - 8 - flen)
        blob = self.src.read(flen)
        r = CompactReader(blob)
        fcm = r.read_struct()
        alg = fcm.get(1, {})
        if 1 in alg:
            alg_struct, ctr = alg[1], False
        elif 2 in alg:
            alg_struct, ctr = alg[2], True
        else:
            raise ArrowInvalid("unknown parquet encryption algorithm")
        aad_prefix = alg_struct.get(1, b"")
        aad_file_unique = alg_struct.get(2, b"")
        if alg_struct.get(3):  # supply_aad_prefix
            aad_prefix = self.decryption.aad_prefix
            if not aad_prefix:
                raise ArrowInvalid(
                    "file requires an externally-supplied AAD prefix")
        file_aad = aad_prefix + aad_file_unique
        footer_key = self.decryption.resolve_footer_key(fcm.get(2, b""))
        footer, _ = decrypt_module_gcm(
            footer_key, module_aad(file_aad, MOD_FOOTER), blob, r.pos)
        self._file_crypto = (footer_key, file_aad, ctr)
        return footer

    def _init_plaintext_footer_crypto(self, md, footer: bytes):
        """Plaintext-footer encrypted file (file_reader.cc:695-716):
        resolve the footer key from FileMetaData field 9, verify the
        GCM signature trailing the footer when a key is available."""
        from ...compute.registry import ArrowInvalid
        from .encryption import (NONCE_LEN, TAG_LEN,
                                 verify_footer_signature)
        alg = md.get(8, {})
        if 1 in alg:
            alg_struct, ctr = alg[1], False
        elif 2 in alg:
            alg_struct, ctr = alg[2], True
        else:
            raise ArrowInvalid("unknown parquet encryption algorithm")
        aad_prefix = alg_struct.get(1, b"")
        aad_file_unique = alg_struct.get(2, b"")
        if alg_struct.get(3):  # supply_aad_prefix
            if self.decryption is None or not self.decryption.aad_prefix:
                raise ArrowInvalid(
                    "file requires an externally-supplied AAD prefix")
            aad_prefix = self.decryption.aad_prefix
        file_aad = aad_prefix + aad_file_unique
        if self.decryption is None:
            # legacy read: plaintext columns remain readable; encrypted
            # chunks will fail on key resolution
            return
        footer_key = self.decryption.resolve_footer_key(md.get(9, b""))
        sig_len = NONCE_LEN + TAG_LEN
        body, sig = footer[:-sig_len], footer[-sig_len:]
        if not verify_footer_signature(footer_key, file_aad, body, sig):
            raise ArrowInvalid(
                "parquet crypto signature verification failed")
        self._file_crypto = (footer_key, file_aad, ctr)

    def _attach_column_crypto(self):
        """Resolve a FileColumnCryptoState per encrypted chunk; decrypt
        column-key ColumnMetaData modules into chunk slot 3."""
        from .encryption import MOD_COLUMN_METADATA, FileColumnCryptoState
        footer_key, file_aad, ctr = self._file_crypto
        for rg_idx, rg in enumerate(self.row_groups):
            # module AADs use RowGroup.ordinal, falling back to -1
            # (0xFFFF) when unset, mirroring metadata.cc:649
            rg_ord = rg.get(7, -1) & 0xFFFF
            for col_ord, chunk in enumerate(rg.get(1, [])):
                ccm = chunk.get(8)
                if ccm is None:
                    continue  # plaintext chunk (no crypto_metadata)
                if 1 in ccm:   # ENCRYPTION_WITH_FOOTER_KEY
                    state = FileColumnCryptoState(footer_key, file_aad,
                                                  ctr)
                else:          # ENCRYPTION_WITH_COLUMN_KEY
                    ck = ccm[2]
                    path = b".".join(ck.get(1, [])).decode()
                    key = self.decryption.resolve_column_key(
                        path, ck.get(2, b""))
                    state = FileColumnCryptoState(key, file_aad, ctr)
                # encrypted_column_metadata (field 9) carries the real
                # ColumnMetaData; field 3 is absent (encrypted footer)
                # or a redacted legacy copy (plaintext footer) —
                # prefer the decrypted version
                enc_meta = chunk.get(9)
                if enc_meta is not None:
                    pt, _ = state.decrypt(MOD_COLUMN_METADATA,
                                          enc_meta, 0, rg_ord,
                                          col_ord)
                    chunk[3] = CompactReader(pt).read_struct()
                chunk["_crypto"] = (state, rg_ord, col_ord)

    @property
    def schema_arrow(self) -> Schema:
        return Schema([Field(c.name, c.arrow_type, c.nullable)
                       for c in self.columns])

    @property
    def schema(self):
        """Parquet schema view (pyarrow ParquetFile.schema); use
        schema_arrow for the Arrow schema."""
        from .metadata import ParquetSchema
        return ParquetSchema(self)

    def close(self, force: bool = False):
        self._closed = True
        if hasattr(self.src, "close"):
            try:
                self.src.close()
            except Exception:
                pass

    @property
    def closed(self) -> bool:
        return getattr(self, "_closed", False)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def iter_batches(self, batch_size: int = 65536, row_groups=None,
                     columns: Optional[List[str]] = None,
                     use_threads: bool = True, **kwargs):
        """Stream record batches of ≤batch_size rows
        (pyarrow ParquetFile.iter_batches)."""
        groups = row_groups if row_groups is not None else \
            range(self.num_row_groups)
        for i in groups:
            rb = self.read_row_group(i, columns)
            n = rb.num_rows
            for start in range(0, n, batch_size):
                yield rb.slice(start, min(batch_size, n - start))

    def read_row_groups(self, row_groups, columns=None,
                        use_threads: bool = True, **kwargs) -> Table:
        batches = [self.read_row_group(i, columns) for i in row_groups]
        schema = (batches[0].schema if batches else
                  self._selected_schema(columns))
        return Table.from_batches(batches, schema)

    def scan_contents(self, columns=None, batch_size: int = 65536) -> int:
        """Read the selected columns, returning the row count
        (pyarrow ParquetFile.scan_contents)."""
        return sum(b.num_rows
                   for b in self.iter_batches(batch_size,
                                              columns=columns))

    @property
    def num_row_groups(self) -> int:
        return len(self.row_groups)

    @property
    def metadata(self):
        return self

    def _chunk_ranges(self, row_groups=None, columns=None):
        """(offset, length) of each selected column chunk's page bytes."""
        sel = set(columns) if columns is not None else None
        out = []
        ci_names = [fd.name for fd in self.fields
                    for _ in fd.leaves]
        for i, rg in enumerate(self.row_groups):
            if row_groups is not None and i not in row_groups:
                continue
            for chunk, name in zip(rg.get(1, []), ci_names):
                if sel is not None and name not in sel:
                    continue
                meta = chunk.get(3) or {}
                start = meta.get(11) or meta.get(9)
                if start is None:
                    continue
                out.append((start, meta.get(7, 0) + (1 << 16)))
        return out

    def pre_buffer(self, row_groups=None, columns=None,
                   cache_options=None) -> None:
        """Coalesce + bulk-read the selected chunks' byte ranges up
        front; subsequent reads are served from memory (io/caching.h
        ReadRangeCache; parquet ArrowReaderProperties::pre_buffer)."""
        from ..caching import CacheOptions, ReadRangeCache, _CachedSource
        self.src.seek(0, 2)
        size = self.src.tell()
        cache = ReadRangeCache(self.src, cache_options or CacheOptions())
        cache.cache([(o, min(ln, size - o))
                     for o, ln in self._chunk_ranges(row_groups, columns)])
        self.src = _CachedSource(cache, size)

    def read(self, columns: Optional[List[str]] = None,
             filters=None, pre_buffer: bool = False, device=None) -> Table:
        """filters: pyarrow-style list of (col, op, value) tuples (AND)
        or list-of-lists (OR of ANDs). Row groups whose column
        statistics (ColumnMetaData.statistics, parquet/metadata.h) prove
        the filter false are skipped; the filter is then applied exactly
        to the surviving rows, as a plan on ``device`` (the card unless
        ``device="cpu"``)."""
        keep = [i for i in range(self.num_row_groups)
                if filters is None or
                self._row_group_may_match(i, filters)]
        if pre_buffer:
            self.pre_buffer(row_groups=set(keep), columns=columns)
        batches = [self.read_row_group(i, columns) for i in keep]
        schema = (batches[0].schema if batches else
                  self._selected_schema(columns))
        tbl = Table.from_batches(batches, schema)
        if filters is not None and tbl.num_rows:
            tbl = _apply_filters(tbl, filters, device)
        return tbl

    def bloom_filter(self, rg: int, col: int):
        """SplitBlockBloomFilter for the chunk, or None (parquet
        bloom_filter.h)."""
        chunk = self.row_groups[rg].get(1, [])[col]
        meta = chunk.get(3, {})
        off = meta.get(14)
        if off is None:
            off = chunk.get(14)
        if off is None:
            return None
        self.src.seek(off)
        blob = self.src.read(meta.get(15, chunk.get(15, 1 << 20)))
        from .bloom import SplitBlockBloomFilter as SplitBlockBloomFilter_
        crypto_info = chunk.get("_crypto")
        if crypto_info is not None:
            from .encryption import MOD_BLOOM_BITSET, MOD_BLOOM_HEADER
            state, rg_o, col_o = crypto_info
            hdr_pt, p = state.decrypt(MOD_BLOOM_HEADER, blob, 0,
                                      rg_o, col_o)
            hdr = CompactReader(hdr_pt).read_struct()
            bitset, _ = state.decrypt(MOD_BLOOM_BITSET, blob, p,
                                      rg_o, col_o)
            return SplitBlockBloomFilter_(hdr.get(1, 32), bitset)
        hdr_reader = CompactReader(blob)
        hdr = hdr_reader.read_struct()
        nbytes = hdr.get(1, 32)
        bitset = blob[hdr_reader.pos:hdr_reader.pos + nbytes]
        return SplitBlockBloomFilter_(nbytes, bitset)

    def column_index(self, rg: int, col: int):
        """Decoded ColumnIndex (page_index.h): (null_pages, mins, maxs,
        null_counts) or None."""
        chunk = self.row_groups[rg].get(1, [])[col]
        off = chunk.get(6)
        ln = chunk.get(7)
        if off is None:
            return None
        self.src.seek(off)
        blob = self.src.read(ln)
        crypto_info = chunk.get("_crypto")
        if crypto_info is not None:
            from .encryption import MOD_COLUMN_INDEX
            state, rg_o, col_o = crypto_info
            blob, _ = state.decrypt(MOD_COLUMN_INDEX, blob, 0,
                                    rg_o, col_o)
        ci = CompactReader(blob).read_struct()
        cs = None
        k = 0
        for fd in self.fields:
            for leaf in fd.leaves:
                if k == col:
                    cs = leaf
                k += 1
        mins = [None if np_ else _decode_stats(
            cs, {6: raw})[0] for np_, raw in zip(ci.get(1, []),
                                                 ci.get(2, []))]
        maxs = [None if np_ else _decode_stats(
            cs, {5: raw})[1] for np_, raw in zip(ci.get(1, []),
                                                 ci.get(3, []))]
        return (ci.get(1, []), mins, maxs, ci.get(5))

    def offset_index(self, rg: int, col: int):
        """[(offset, compressed_size, first_row_index)] or None."""
        chunk = self.row_groups[rg].get(1, [])[col]
        off = chunk.get(4)
        ln = chunk.get(5)
        if off is None:
            return None
        self.src.seek(off)
        blob = self.src.read(ln)
        crypto_info = chunk.get("_crypto")
        if crypto_info is not None:
            from .encryption import MOD_OFFSET_INDEX
            state, rg_o, col_o = crypto_info
            blob, _ = state.decrypt(MOD_OFFSET_INDEX, blob, 0,
                                    rg_o, col_o)
        oi = CompactReader(blob).read_struct()
        return [(p.get(1), p.get(2), p.get(3, 0))
                for p in oi.get(1, [])]

    def statistics(self, rg: int) -> dict:
        """{column name: (min, max, null_count)} for row group rg."""
        out = {}
        chunks = self.row_groups[rg].get(1, [])
        ci = 0
        for fd in self.fields:
            if len(fd.leaves) == 1:
                cs = fd.leaves[0]
                st = chunks[ci].get(3, {}).get(12)
                if st is not None:
                    out[fd.name] = _decode_stats(cs, st)
            ci += len(fd.leaves)
        return out

    def _bloom_may_contain(self, rg: int, col_name: str, val) -> bool:
        """True unless the chunk's bloom filter proves absence."""
        k = 0
        for fd in self.fields:
            for leaf in fd.leaves:
                if fd.name == col_name and len(fd.leaves) == 1:
                    try:
                        bf = self.bloom_filter(rg, k)
                        if bf is None:
                            return True
                        from .bloom import hash_value
                        return bf.check_hash(hash_value(
                            val, leaf.physical))
                    except Exception:
                        return True
                k += 1
        return True

    def _row_group_may_match(self, rg: int, filters) -> bool:
        dnf = filters if filters and isinstance(filters[0], list) \
            else [filters]
        stats = self.statistics(rg)
        for group in dnf:           # OR of AND-groups
            ok = True
            for col, op, val in group:
                st = stats.get(col)
                if st is None:
                    continue        # no stats -> cannot prune
                mn, mx, _ = st
                if mn is None or mx is None:
                    continue
                if op in ("=", "=="):
                    if val < mn or val > mx:
                        ok = False
                    elif ok:
                        ok = self._bloom_may_contain(rg, col, val)
                elif op == "<":
                    if mn >= val:
                        ok = False
                elif op == "<=":
                    if mn > val:
                        ok = False
                elif op == ">":
                    if mx <= val:
                        ok = False
                elif op == ">=":
                    if mx < val:
                        ok = False
                elif op == "in":
                    if all(v < mn or v > mx for v in val):
                        ok = False
                    elif ok:
                        ok = any(self._bloom_may_contain(rg, col, v)
                                 for v in val)
                if not ok:
                    break
            if ok:
                return True
        return False

    def _selected_schema(self, columns):
        cols = self.columns if columns is None else \
            [c for c in self.columns if c.name in columns]
        return Schema([Field(c.name, c.arrow_type, c.nullable)
                       for c in cols])

    def read_row_group(self, i: int,
                       columns: Optional[List[str]] = None,
                       use_threads: bool = True) -> RecordBatch:
        rg = self.row_groups[i]
        chunks = rg.get(1, [])
        num_rows = rg.get(3, 0)
        arrays, fields = [], []
        ci = 0
        from ...array.array import array as make_array
        from .nested import LeafSpec, assemble, is_nested

        # flat columns decode in parallel (file reads serialized by
        # _src_lock; the decode work is the host library's and releases
        # the GIL); reference: parquet/arrow/reader.cc use_threads
        # column-level parallelism
        flat_jobs = []
        for fd in self.fields:
            if columns is not None and fd.name not in columns:
                continue
            if not is_nested(fd.arrow_type) and len(fd.leaves) == 1:
                flat_jobs.append(fd)
        flat_results = {}
        if use_threads and len(flat_jobs) > 1:
            from concurrent.futures import ThreadPoolExecutor
            ci2 = 0
            jobs = []
            for fd in self.fields:
                fchunks = chunks[ci2:ci2 + len(fd.leaves)]
                ci2 += len(fd.leaves)
                if fd in flat_jobs:
                    jobs.append((fd, fd.leaves[0], fchunks[0]))
            with ThreadPoolExecutor(max_workers=min(8, len(jobs))) as ex:
                for (fd, _, _), arr in zip(jobs, ex.map(
                        lambda j: self._read_chunk(j[1], j[2], num_rows),
                        jobs)):
                    flat_results[id(fd)] = arr

        for fd in self.fields:
            fchunks = chunks[ci:ci + len(fd.leaves)]
            ci += len(fd.leaves)
            if columns is not None and fd.name not in columns:
                continue
            if not is_nested(fd.arrow_type) and len(fd.leaves) == 1:
                cs = fd.leaves[0]
                arr = flat_results.get(id(fd))
                if arr is None:
                    arr = self._read_chunk(cs, fchunks[0], num_rows)
                arrays.append(arr)
                fields.append(Field(fd.name, cs.arrow_type, fd.nullable))
                continue
            leaf_results = []
            for cs, chunk in zip(fd.leaves, fchunks):
                defs, reps, values_parts, bin_parts, dictionary = \
                    self._read_chunk_raw(cs, chunk)
                n_present = int((defs == cs.max_def).sum())
                flat = _assemble(cs, np.ones(n_present, dtype=np.int64),
                                 values_parts, bin_parts, dictionary)
                spec = LeafSpec([], cs.arrow_type, cs.max_def, cs.max_rep,
                                cs.nodes)
                leaf_results.append((spec, defs, reps, flat.to_pylist()))
            rows = assemble(fd.arrow_type, leaf_results, fd.nullable)
            arrays.append(make_array(rows, fd.arrow_type))
            fields.append(Field(fd.name, fd.arrow_type, fd.nullable))
        return RecordBatch(Schema(fields), arrays)

    def _read_chunk(self, cs: ColumnSchema, chunk: Dict,
                    num_rows: int) -> Array:
        fast = self._read_chunk_fast(cs, chunk)
        if fast is not None:
            defs, reps, values_parts, bin_parts, dictionary = fast
        else:
            defs, reps, values_parts, bin_parts, dictionary = \
                self._read_chunk_raw(cs, chunk)
        return _assemble(cs, defs, values_parts, bin_parts, dictionary)

    def _read_chunk_fast(self, cs: ColumnSchema, chunk: Dict):
        """Whole-chunk decode of a flat fixed-width column by the host
        library: ONE pq_scan_pages call parses every page header and ONE
        pq_decode_flat call decompresses pages, decodes definition
        levels and PLAIN/dictionary-index values (the batch analogue of
        parquet/column_reader.cc's page loop — the per-page Python round
        trips were ~80% of a 1M-row numeric read). Returns the
        _read_chunk_raw tuple, or None where the chunk is the page loop's
        (another codec, encoding or nesting, encryption)."""
        if chunk.get("_crypto") is not None or cs.max_rep > 0 or \
                cs.max_def > 1:
            return None
        meta = chunk.get(3)
        codec = meta.get(4, 0)
        if codec not in (CODEC_UNCOMPRESSED, CODEC_SNAPPY):
            return None
        width = {INT32: 4, INT64: 8, FLOAT: 4, DOUBLE: 8}.get(
            cs.physical)
        if width is None:
            if cs.physical == FLBA and cs.type_length > 0:
                width = cs.type_length
            else:
                return None
        num_values = meta.get(5, 0)
        if num_values <= 0:
            return None
        data_off = meta.get(9)
        dict_off = meta.get(11)
        start = dict_off if dict_off is not None else data_off
        total = meta.get(7, 0) + (1 << 16)
        with self._src_lock:
            self.src.seek(start)
            blob = self.src.read(total)
        tab = host.pq_scan_pages(blob, num_values)
        if tab is None or not len(tab):
            return None
        is_data = (tab[:, 0] == PAGE_DATA) | (tab[:, 0] == PAGE_DATA_V2)
        encs = set(tab[is_data, 5].tolist())
        if not encs <= {ENC_PLAIN, ENC_PLAIN_DICTIONARY,
                        ENC_RLE_DICTIONARY}:
            return None
        dict_rows = tab[tab[:, 0] == PAGE_DICT]
        if len(dict_rows) > 1 or \
                (len(dict_rows) and
                 int(dict_rows[0, 5]) not in (ENC_PLAIN,
                                              ENC_PLAIN_DICTIONARY)):
            return None
        if bool((tab[tab[:, 0] == PAGE_DATA_V2][:, 8] > 0).any()):
            return None  # repetition levels on a flat column
        from .rle import bit_width_for
        def_bw = bit_width_for(max(cs.max_def, 1))
        res = host.pq_decode_flat(blob, tab,
                             1 if codec == CODEC_SNAPPY else 0,
                             cs.max_def, def_bw, width, num_values)
        if res is None:
            return None
        validity, plain, idx, page_kind, page_np, dict_bytes = res
        if len(validity) != num_values:
            return None
        dictionary = None
        if len(dict_rows) and dict_bytes:
            dictionary = _decode_plain(cs, dict_bytes,
                                       int(dict_rows[0, 4]))
        np_dtype = {INT32: np.int32, INT64: np.int64,
                    FLOAT: np.float32, DOUBLE: np.float64}.get(
            cs.physical)

        def plain_arr(buf, nb, npres):
            return buf[:nb].view(np_dtype) if np_dtype is not None \
                else buf[:nb].reshape(npres, width)

        kinds = set(page_kind.tolist()) - {0}
        n_present_all = int(page_np.sum())
        if kinds <= {1}:
            # uniform plain pages: the decode buffer IS the dense value
            # array — one zero-copy view, no per-page slicing
            values_parts: List = [("plain", plain_arr(
                plain, n_present_all * width, n_present_all))]
        elif kinds == {2}:
            if dictionary is None:
                return None
            values_parts = [("dict", idx[:n_present_all])]
        else:
            if dictionary is None:
                return None
            values_parts = []
            p_off = i_off = 0
            for k, npres in zip(page_kind.tolist(), page_np.tolist()):
                if k == 1:
                    nb = npres * width
                    values_parts.append(
                        ("plain", plain_arr(plain[p_off:], nb, npres)))
                    p_off += nb
                elif k == 2:
                    values_parts.append(
                        ("dict", idx[i_off:i_off + npres]))
                    i_off += npres
        reps = np.zeros(0, dtype=np.int64)  # flat: unused downstream
        return validity, reps, values_parts, [], dictionary

    def _read_chunk_raw(self, cs: ColumnSchema, chunk: Dict):
        meta = chunk.get(3)
        codec = meta.get(4, 0)
        num_values = meta.get(5, 0)
        data_off = meta.get(9)
        dict_off = meta.get(11)
        start = dict_off if dict_off is not None else data_off
        # read generously: total compressed size + headroom for headers
        total = meta.get(7, 0) + (1 << 16)
        with self._src_lock:
            self.src.seek(start)
            blob = self.src.read(total)

        pos = 0
        dictionary = None
        values_parts: List[np.ndarray] = []
        bin_parts: List[Tuple] = []
        def_parts: List[np.ndarray] = []
        rep_parts: List[np.ndarray] = []
        from .rle import bit_width_for
        def_bw = bit_width_for(max(cs.max_def, 1))
        rep_bw = bit_width_for(max(cs.max_rep, 1))
        consumed = 0
        crypto_info = chunk.get("_crypto")
        data_page_ord = 0
        expect_dict = dict_off is not None
        while consumed < num_values:
            if crypto_info is not None:
                from .encryption import (MOD_DATA_PAGE,
                                         MOD_DATA_PAGE_HEADER,
                                         MOD_DICT_PAGE,
                                         MOD_DICT_PAGE_HEADER)
                state, rg_o, col_o = crypto_info
                if expect_dict:
                    hdr_pt, pos = state.decrypt(
                        MOD_DICT_PAGE_HEADER, blob, pos, rg_o, col_o)
                    ph = CompactReader(hdr_pt).read_struct()
                    payload, pos = state.decrypt(
                        MOD_DICT_PAGE, blob, pos, rg_o, col_o)
                    expect_dict = False
                else:
                    hdr_pt, pos = state.decrypt(
                        MOD_DATA_PAGE_HEADER, blob, pos, rg_o, col_o,
                        data_page_ord)
                    ph = CompactReader(hdr_pt).read_struct()
                    payload, pos = state.decrypt(
                        MOD_DATA_PAGE, blob, pos, rg_o, col_o,
                        data_page_ord)
                    data_page_ord += 1
                ptype = ph.get(1)
                uncomp = ph.get(2, 0)
            else:
                if pos >= len(blob):
                    raise OSError(f"Parquet column {cs.name!r}: the chunk "
                                  "ends before its values")
                header = CompactReader(blob, pos)
                ph = header.read_struct()
                pos = header.pos
                ptype = ph.get(1)
                uncomp = ph.get(2, 0)
                comp = ph.get(3, 0)
                if comp < 0 or comp > len(blob) - pos:
                    raise OSError(f"Parquet column {cs.name!r}: a page's "
                                  f"compressed size {comp} is out of range")
                payload = blob[pos:pos + comp]
                pos += comp
            _check_page(cs, ph, len(payload))
            if ptype == PAGE_DICT:
                dph = ph.get(7, {})
                payload = _decompress(codec, payload, uncomp)
                dictionary = _decode_plain(cs, payload, dph.get(1, 0))
            elif ptype == PAGE_DATA:
                dph = ph.get(5, {})
                nvals = dph.get(1, 0)
                enc = dph.get(2, 0)
                payload = _decompress(codec, payload, uncomp)
                p = 0
                if cs.max_rep > 0:
                    (rl_len,) = struct.unpack_from("<i", payload, p)
                    reps = decode_rle(payload, p + 4, nvals, rep_bw)
                    p += 4 + rl_len
                    rep_parts.append(reps)
                if cs.max_def > 0:
                    (lvl_len,) = struct.unpack_from("<i", payload, p)
                    if lvl_len < 0 or p + 4 + lvl_len > len(payload):
                        raise OSError(f"Parquet column {cs.name!r}: "
                                      f"levels of {lvl_len} bytes overrun "
                                      "their page")
                    defs = decode_rle(payload, p + 4, nvals, def_bw)
                    p += 4 + lvl_len
                else:
                    defs = np.full(nvals, cs.max_def, dtype=np.int64)
                def_parts.append(defs)
                n_present = int((defs == cs.max_def).sum())
                _decode_values(cs, enc, payload, p, n_present, dictionary,
                               values_parts, bin_parts)
                consumed += nvals
            elif ptype == PAGE_DATA_V2:
                d2 = ph.get(8, {})
                nvals = d2.get(1, 0)
                nnulls = d2.get(2, 0)
                enc = d2.get(4, 0)
                dl_len = d2.get(5, 0)
                rl_len = d2.get(6, 0)
                lvl = payload[:dl_len + rl_len]
                body = payload[dl_len + rl_len:]
                if d2.get(7, True):
                    body = _decompress(codec, body,
                                       uncomp - dl_len - rl_len)
                if cs.max_rep > 0 and rl_len:
                    rep_parts.append(decode_rle(lvl, 0, nvals, rep_bw))
                if cs.max_def > 0 and dl_len:
                    defs = decode_rle(lvl, rl_len, nvals, def_bw)
                else:
                    defs = np.full(nvals, cs.max_def, dtype=np.int64)
                def_parts.append(defs)
                n_present = int((defs == cs.max_def).sum())
                _decode_values(cs, enc, body, 0, n_present, dictionary,
                               values_parts, bin_parts)
                consumed += nvals
            else:
                continue  # index pages etc.

        defs = np.concatenate(def_parts) if def_parts else \
            np.ones(0, dtype=np.int64)
        reps = np.concatenate(rep_parts) if rep_parts else \
            np.zeros(len(defs), dtype=np.int64)
        return defs, reps, values_parts, bin_parts, dictionary


def _check_page(cs, ph: Dict, payload_len: int) -> None:
    """OSError (pyarrow's class for a malformed file) where a page
    header's sizes cannot be those of a page: negative sizes, value or
    null counts, or levels longer than the page."""
    sub = ph.get(5) or ph.get(7) or ph.get(8) or {}
    v2 = ph.get(8) or {}
    sizes = {"uncompressed size": ph.get(2, 0), "values": sub.get(1, 0),
             "nulls": v2.get(2, 0), "definition levels": v2.get(5, 0),
             "repetition levels": v2.get(6, 0)}
    for what, v in sizes.items():
        if not isinstance(v, int) or v < 0:
            raise OSError(f"Parquet column {cs.name!r}: a page header "
                          f"gives {what} {v}")
    if v2.get(5, 0) + v2.get(6, 0) > payload_len:
        raise OSError(f"Parquet column {cs.name!r}: a page's levels "
                      "overrun the page")


def _decode_values(cs, enc, payload, p, n_present, dictionary,
                   values_parts, bin_parts):
    if enc in (ENC_RLE_DICTIONARY, ENC_PLAIN_DICTIONARY):
        bw = payload[p]
        idx = decode_rle(payload, p + 1, n_present, bw)
        values_parts.append(("dict", idx))
    elif enc == ENC_PLAIN:
        values_parts.append(("plain",
                             _decode_plain(cs, payload[p:], n_present)))
    elif enc == ENC_DELTA_BINARY_PACKED:
        from .delta import decode_delta_binary_packed
        vals, _ = decode_delta_binary_packed(payload, p)
        vals = vals[:n_present]
        if cs.physical == INT32:
            vals = vals.astype(np.int32)
        values_parts.append(("plain", vals))
    elif enc == ENC_DELTA_LENGTH_BYTE_ARRAY:
        from .delta import decode_delta_length_byte_array
        offs, body, _ = decode_delta_length_byte_array(
            payload, p, n_present)
        values_parts.append(("plain", (offs, body)))
    elif enc == ENC_DELTA_BYTE_ARRAY:
        from .delta import decode_delta_byte_array
        offs, body = decode_delta_byte_array(payload, p, n_present)
        if cs.physical == FLBA:
            w = cs.type_length
            values_parts.append(("plain", np.frombuffer(
                body, dtype=np.uint8, count=n_present * w
            ).reshape(n_present, w)))
        else:
            values_parts.append(("plain", (offs, body)))
    elif enc == ENC_BYTE_STREAM_SPLIT:
        from .delta import decode_byte_stream_split
        width = {FLOAT: 4, DOUBLE: 8, INT32: 4, INT64: 8}.get(
            cs.physical, cs.type_length)
        raw = decode_byte_stream_split(payload[p:], n_present, width)
        if cs.physical == FLBA:
            values_parts.append(("plain", raw))
        else:
            dt = {FLOAT: np.float32, DOUBLE: np.float64,
                  INT32: np.int32, INT64: np.int64}[cs.physical]
            values_parts.append(("plain", raw.reshape(-1).view(dt)))
    else:
        raise NotImplementedError(f"parquet encoding {enc}")


def _decode_plain(cs: ColumnSchema, data: bytes, n: int):
    ph = cs.physical
    if ph == BOOLEAN:
        bits = np.unpackbits(np.frombuffer(data, dtype=np.uint8),
                             bitorder="little")
        return bits[:n].astype(np.bool_)
    if ph == INT32:
        return np.frombuffer(data, dtype=np.int32, count=n)
    if ph == INT64:
        return np.frombuffer(data, dtype=np.int64, count=n)
    if ph == FLOAT:
        return np.frombuffer(data, dtype=np.float32, count=n)
    if ph == DOUBLE:
        return np.frombuffer(data, dtype=np.float64, count=n)
    if ph == FLBA:
        w = cs.type_length
        return np.frombuffer(data, dtype=np.uint8,
                             count=n * w).reshape(n, w)
    if ph == BYTE_ARRAY:
        offsets, pool = host.plain_decode_byte_array(data, n)
        return offsets, pool.tobytes()
    raise NotImplementedError(f"plain decode for physical {ph}")


def _assemble(cs: ColumnSchema, defs: np.ndarray, values_parts,
              bin_parts, dictionary) -> Array:
    n = len(defs)
    # a REQUIRED column's levels are all 0 (it has none): every row present
    present = defs.astype(np.bool_) if cs.max_def else np.ones(n, np.bool_)
    null_count = int(n - present.sum())
    validity = None if null_count == 0 else \
        Buffer(bitutil.pack_bits(present))
    t = cs.arrow_type

    # merge parts into one dense value array (present values only)
    plain_vals = []
    for kind, v in values_parts:
        if kind == "dict":
            plain_vals.append(("dict", v))
        else:
            plain_vals.append(("plain", v))

    if cs.physical == BYTE_ARRAY:
        # build offsets+data over PRESENT values, then spread. Byte
        # chunks stay numpy views end to end — ONE concatenate, no
        # intermediate bytes copies (the old tobytes + b"".join pair
        # was ~35% of the 1M-row string-column read)
        all_offs, all_chunks = [], []
        for kind, v in plain_vals:
            if kind == "dict":
                doffs, dbytes = dictionary
                lens = (doffs[1:] - doffs[:-1])[v]
                chunk = host.gather_var_bytes(
                    np.frombuffer(dbytes, np.uint8), doffs, v)[1] \
                    if len(v) else np.zeros(0, np.uint8)
                all_offs.append(lens)
                all_chunks.append(chunk)
            else:
                offs, bs = v
                all_offs.append(np.diff(offs))
                all_chunks.append(np.frombuffer(bs, np.uint8))
        lens_present = (np.concatenate(all_offs) if all_offs
                        else np.zeros(0, dtype=np.int64))
        data_bytes = (all_chunks[0] if len(all_chunks) == 1
                      else np.concatenate(all_chunks) if all_chunks
                      else b"")
        if null_count == 0:
            lens_full = lens_present  # no masked spread needed
        else:
            lens_full = np.zeros(n, dtype=np.int64)
            lens_full[present] = lens_present
        offsets = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(lens_full, out=offsets[1:])
        off_dt = np.int32 if t.id in (TypeId.STRING, TypeId.BINARY) \
            else np.int64
        data = ArrayData(
            t if t.id in (TypeId.STRING, TypeId.BINARY,
                          TypeId.LARGE_STRING, TypeId.LARGE_BINARY)
            else T.binary(), n,
            [validity, Buffer(offsets.astype(off_dt)),
             Buffer(data_bytes)], null_count=null_count)
        if plain_vals and all(kind == "dict" for kind, _ in plain_vals):
            _know_dictionary_codes(data, dictionary,
                                   [v for _, v in plain_vals], present)
        return Array(data)

    dense_parts = []
    for kind, v in plain_vals:
        if kind == "dict":
            dense_parts.append(np.asarray(dictionary)[v])
        else:
            dense_parts.append(v)
    dense = (np.concatenate(dense_parts) if dense_parts
             else np.zeros(0, dtype=np.int64))

    if cs.physical == FLBA:
        w = cs.type_length
        full = np.zeros((n, w), dtype=np.uint8)
        vals = dense.reshape(-1, w)
        if t.id in (TypeId.DECIMAL128, TypeId.DECIMAL256, TypeId.DECIMAL32, TypeId.DECIMAL64):
            vals = vals[:, ::-1]  # parquet decimals are big-endian
        full[present] = vals
        return Array(ArrayData(t, n, [validity, Buffer(full.reshape(-1))],
                               null_count=null_count))

    if t.id == TypeId.BOOL:
        if null_count == 0:
            full = dense.astype(np.bool_)
        else:
            full = np.zeros(n, dtype=np.bool_)
            full[present] = dense.astype(np.bool_)
        return Array(ArrayData(t, n,
                               [validity,
                                Buffer(bitutil.pack_bits(full))],
                               null_count=null_count))

    np_dt = t.to_numpy_dtype()
    if null_count == 0:
        # no-null fast path: a masked full[present] = x assignment is a
        # scatter even when the mask is all-True; a straight astype is
        # one C memcpy/convert (measured 2x on dense numeric columns)
        full = np.ascontiguousarray(dense.astype(np_dt, copy=False))
        if full.shape[0] != n:
            full = np.resize(full, n)
    else:
        full = np.zeros(n, dtype=np_dt)
        full[present] = dense.astype(np_dt)
    return Array(ArrayData(t, n, [validity, Buffer(full)],
                           null_count=null_count))


def _know_dictionary_codes(data: ArrayData, dictionary, idx_parts,
                           present: np.ndarray) -> None:
    """Hand the upload (``device.column.know_codes``) the codes of a string
    or binary column whose every page held dictionary indices: the
    dictionary's values coded by value, a row its value's code and a null
    the empty value's, then renumbered in order of first appearance over
    the rows. Exactly the codes the upload would find from the bytes, in
    O(rows) without reading them (a port addition; the Table is the
    reference's)."""
    from ...device.column import _first_appearance, know_codes, value_codes
    doffs, dbytes = dictionary
    dlens = np.diff(doffs)
    dcodes = value_codes(np.frombuffer(dbytes, np.uint8), doffs[:-1],
                         dlens)[0].astype(np.int64)
    empties = np.flatnonzero(dlens == 0)
    empty = int(dcodes[empties[0]]) if len(empties) else len(dcodes)
    idx = np.concatenate(idx_parts) if len(idx_parts) > 1 else idx_parts[0]
    if len(idx) == len(present):
        rows = dcodes[idx]
    else:
        rows = np.full(len(present), empty, dtype=np.int64)
        rows[present] = dcodes[idx]
    know_codes(data, *_first_appearance(rows))


def read_table(source, columns: Optional[List[str]] = None,
               filters=None, decryption_properties=None,
               device=None) -> Table:
    """The Table of ``source`` (a path, bytes, a Buffer or a file object),
    its ``columns`` (all where None); ``filters`` run on ``device``."""
    return ParquetFile(
        source, decryption_properties=decryption_properties
    ).read(columns, filters=filters, device=device)


def _decode_stats(cs: ColumnSchema, st: Dict):
    """Statistics struct -> (min, max, null_count) python values."""
    nulls = st.get(3)
    mn_raw = st.get(6, st.get(2))
    mx_raw = st.get(5, st.get(1))

    def dec(raw):
        if raw is None:
            return None
        ph = cs.physical
        if ph == BOOLEAN:
            return bool(raw[0])
        if ph == INT32:
            return int(np.frombuffer(raw, np.int32)[0])
        if ph == INT64:
            return int(np.frombuffer(raw, np.int64)[0])
        if ph == FLOAT:
            return float(np.frombuffer(raw, np.float32)[0])
        if ph == DOUBLE:
            return float(np.frombuffer(raw, np.float64)[0])
        if cs.arrow_type.id in (T.TypeId.STRING, T.TypeId.LARGE_STRING):
            return raw.decode("utf8", "replace")
        return bytes(raw)
    return dec(mn_raw), dec(mx_raw), nulls


def _apply_filters(tbl: Table, filters, device=None) -> Table:
    """Exact residual filtering with the engine's own compute: a filter
    plan over the Table, run on ``device``."""
    from ...acero import (Declaration, FilterNodeOptions,
                           TableSourceNodeOptions)
    from ...acero.expression import Expression, field as _field

    def pred(col, op, val):
        f = _field(col)
        if op in ("=", "=="):
            return f == val
        if op == "!=":
            return f != val
        if op == "<":
            return f < val
        if op == "<=":
            return f <= val
        if op == ">":
            return f > val
        if op == ">=":
            return f >= val
        if op == "in":
            return Expression.call("is_in", f, value_set=list(val))
        raise ValueError(f"unsupported filter op {op!r}")

    dnf = filters if filters and isinstance(filters[0], list) \
        else [filters]
    or_expr = None
    for group in dnf:
        g = None
        for col, op, val in group:
            p = pred(col, op, val)
            g = p if g is None else Expression.call("and_kleene", g, p)
        or_expr = g if or_expr is None else \
            Expression.call("or_kleene", or_expr, g)
    d = Declaration("filter", FilterNodeOptions(or_expr), inputs=[
        Declaration("table_source", TableSourceNodeOptions(tbl))])
    return d.to_table(device=device)
