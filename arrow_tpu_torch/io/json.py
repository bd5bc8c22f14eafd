"""Newline-delimited JSON reader (counterpart of ``arrow_tpu/io/json.py``;
reference: cpp/src/arrow/json/, the chunked rapidjson pipeline of
json/reader.h).

The host does the work, as in the reference. A read takes one of the
reference's three routes in its role: flat records with the same keys in
the same order go through the port's host tokenizer (``csrc/csv_host.cpp``,
``json_parse_flat``) and bulk typed conversion, as one block or, from 4 MB
on several cores, as blocks split at newlines on threads whose Tables
unify (``_unify_chunk_tables``); any other input (nested or ragged records,
an explicit schema, text) goes through Python's ``json``, the schema the
union of the records' keys, nested objects and lists as struct and list
types. The host library is required: where it cannot be built a read
raises NotImplementedError.
"""

from __future__ import annotations

import json as _json
from typing import Dict, List, Optional

import numpy as np

from .. import types as T
from ..api import concat_tables, nulls
from ..array.array import Array, array as make_array
from ..array.construct import _make_validity, infer_type
from ..array.data import ArrayData
from ..buffer import Buffer
from ..table import Table
from ..types import Schema
from ..utils import bits as bitutil
from . import csv_host as nat
from .host_arrays import widened


class _OptionsBase:
    """The equals/validate surface of the options classes (pyarrow
    _json.pyx)."""

    def equals(self, other) -> bool:
        return (type(self) is type(other) and
                self.__dict__ == other.__dict__)

    def validate(self) -> None:
        return None


class ReadOptions(_OptionsBase):
    def __init__(self, use_threads: bool = True,
                 block_size: int = 1 << 20):
        self.use_threads = use_threads
        self.block_size = block_size


class ParseOptions(_OptionsBase):
    def __init__(self, explicit_schema: Optional[Schema] = None,
                 newlines_in_values: bool = False,
                 unexpected_field_behavior: str = "infer"):
        self.explicit_schema = explicit_schema
        self.newlines_in_values = newlines_in_values
        self.unexpected_field_behavior = unexpected_field_behavior


def _parse_records(data: str) -> List[Dict]:
    """The records of newline-delimited JSON: one parse of the whole input
    as an array where every record is an object (a raw newline cannot sit
    inside a JSON string, so newlines only separate records:
    json/chunker.cc's invariant), else one parse a line."""
    stripped = data.strip()
    if not stripped:
        return []
    import re
    try:
        records = _json.loads("[" + re.sub(r"[\r\n]+", ",", stripped) + "]")
        if all(isinstance(r, dict) for r in records):
            return records
    except ValueError:
        pass
    records = []
    for line in data.splitlines():
        line = line.strip()
        if line:
            records.append(_json.loads(line))
    return records


def _fast_array(col: List):
    """A column of one scalar kind and no null, converted in bulk; None
    where the column needs inference."""
    kinds = set(map(type, col))
    if kinds == {int}:
        try:
            return make_array(np.array(col, dtype=np.int64))
        except (ValueError, TypeError, OverflowError):
            return None
    if kinds == {float} or kinds == {int, float}:
        return make_array(np.array(col, dtype=np.float64))
    if kinds == {bool}:
        return make_array(np.array(col, dtype=np.bool_))
    if kinds == {str}:
        joined = "".join(col)
        b = joined.encode()
        if len(b) != len(joined):
            return None  # not ASCII: the byte lengths differ
        offsets = np.zeros(len(col) + 1, dtype=np.int32)
        np.cumsum(np.fromiter(map(len, col), np.int32, len(col)),
                  out=offsets[1:])
        if offsets[-1] != len(b):
            return None
        return Array(ArrayData(T.string(), len(col),
                               [None, Buffer(offsets), Buffer(b)],
                               null_count=0))
    return None


def _native_json_table(data: bytes, ro: ReadOptions) -> Optional[Table]:
    """Flat ndjson by the host tokenizer and bulk typed conversion
    (json/parser.cc); None where the input needs the Python route."""
    block = nat.json_parse_flat(data)
    if block is None:
        return None
    n, ncols = block.n_rows, block.ncols
    kinds = block.kinds.reshape(n, ncols) if n else \
        block.kinds.reshape(0, max(ncols, 1))

    def convert(j):
        col_kinds = kinds[:, j]
        null = col_kinds == 0
        valid = ~null
        ids = np.arange(n, dtype=np.int64) * ncols + j
        kindset = set(np.unique(col_kinds[valid]).tolist())
        if not kindset:
            return make_array([None] * n, T.null())
        if kindset == {3}:  # numbers: int64 if all integral, else float64
            for parse, t in ((nat.csv_parse_int64, T.int64()),
                             (nat.csv_parse_float64, T.float64())):
                r = parse(block, ids, null)
                if r is not None:
                    return Array(ArrayData(t, n, [_make_validity(valid),
                                                  Buffer(r[0])]))
        elif kindset <= {1, 2}:  # booleans
            return Array(ArrayData(
                T.bool_(), n, [_make_validity(valid),
                               Buffer(bitutil.pack_bits(col_kinds == 2))]))
        elif kindset == {4}:  # strings, unescaped in the pool
            offs, bs = nat.csv_gather_bytes(block, ids, skip=null)
            if offs[-1] <= np.iinfo(np.int32).max:
                return Array(ArrayData(
                    T.string(), n, [_make_validity(valid),
                                    Buffer(offs.astype(np.int32)),
                                    Buffer(bs)]))
        raw = block.pool.tobytes()
        offs = block.offsets
        if kindset == {5}:
            # objects and lists (and nulls): the pool holds their JSON
            # text, parsed at once as one array
            parts = [raw[offs[i * ncols + j]:offs[i * ncols + j + 1]]
                     for i in range(n) if col_kinds[i] == 5]
            parsed = _json.loads(b"[" + b",".join(parts) + b"]")
            if null.any():
                it = iter(parsed)
                return make_array([next(it) if col_kinds[i] == 5 else None
                                   for i in range(n)])
            return make_array(parsed)
        # mixed kinds, or numbers past int64 and float64: Python values
        vals = []
        for i in range(n):
            k = int(col_kinds[i])
            fid = i * ncols + j
            if k == 0:
                vals.append(None)
            elif k in (1, 2):
                vals.append(k == 2)
            else:
                text = raw[offs[fid]:offs[fid + 1]].decode("utf8")
                if k == 4:
                    vals.append(text)
                elif k == 3:
                    try:
                        vals.append(int(text))
                    except ValueError:
                        vals.append(float(text))
                else:
                    vals.append(_json.loads(text))
        return make_array(vals)

    arrays = [convert(j) for j in range(len(block.keys))]
    schema = Schema([T.Field(nm, a.type) for nm, a in zip(block.keys,
                                                          arrays)])
    return Table.from_pydict(dict(zip(block.keys, arrays)), schema)


def _split_newline_blocks(data: bytes, n_blocks: int):
    """Block bounds at newlines (json/chunker.cc: an ndjson record holds no
    raw newline)."""
    n = len(data)
    bounds = [0]
    for k in range(1, n_blocks):
        cut = data.find(b"\n", max(n * k // n_blocks, bounds[-1]))
        bounds.append(n if cut < 0 else cut + 1)
    bounds.append(n)
    return [(bounds[k], bounds[k + 1]) for k in range(n_blocks)
            if bounds[k + 1] > bounds[k]]


def _reindexed(part: Table, names, types) -> Table:
    """``part``'s columns ``names`` of ``types``: a missing one all null,
    one of another type widened."""
    cols = []
    for nm in names:
        idx = part.schema.get_field_index(nm)
        if idx < 0:
            cols.append(nulls(part.num_rows, types[nm]))
            continue
        c = part.column(idx).combine()
        if not c.type.equals(types[nm]):
            c = widened(c, types[nm])
        cols.append(c)
    return Table.from_arrays(cols, names)


def _unify_chunk_tables(parts):
    """The blocks' Tables end to end: their columns' union in order of
    first appearance, a missing column null, int64 and float64 to float64.
    None where types disagree beyond that (the caller parses whole)."""
    names: List[str] = []
    types = {}
    for p in parts:
        for f in p.schema.fields:
            if f.name not in types:
                names.append(f.name)
                types[f.name] = f.type
                continue
            cur = types[f.name]
            if cur.equals(f.type) or f.type.id == T.TypeId.NA:
                continue
            if cur.id == T.TypeId.NA:
                types[f.name] = f.type
            elif {cur.id, f.type.id} == {T.TypeId.INT64, T.TypeId.DOUBLE}:
                types[f.name] = T.float64()
            else:
                return None
    return concat_tables([_reindexed(p, names, types)
                          for p in parts]).combine_chunks()


def _read_json_parallel(data: bytes, ro: ReadOptions) -> Optional[Table]:
    """Blocks split at newlines, tokenized on threads (the host calls
    release Python's lock), their Tables unified (json/reader.h
    TableReader); None below 4 MB, on one core or without threads."""
    import os
    ncpu = os.cpu_count() or 1
    if not getattr(ro, "use_threads", True) or ncpu < 2 \
            or len(data) < (1 << 22):
        return None
    spans = _split_newline_blocks(data, min(ncpu, max(2, len(data) >> 21)))
    if len(spans) <= 1:
        return None
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=len(spans)) as ex:
        parts = list(ex.map(
            lambda s: _native_json_table(data[s[0]:s[1]], ro), spans))
    if any(p is None for p in parts):
        return None
    return _unify_chunk_tables(parts)


def _read_source(source):
    if isinstance(source, str):
        with open(source, "rb") as f:
            return f.read()
    if isinstance(source, (bytes, bytearray)):
        return bytes(source)
    return source.read()


def read_json(source, read_options: Optional[ReadOptions] = None,
              parse_options: Optional[ParseOptions] = None) -> Table:
    po = parse_options or ParseOptions()
    ro = read_options or ReadOptions()
    nat.library()   # required: raises where it cannot be built
    data = _read_source(source)

    if isinstance(data, bytes) and po.explicit_schema is None:
        out = _read_json_parallel(data, ro)
        if out is not None:
            return out
        out = _native_json_table(data, ro)
        if out is not None:
            return out
    if isinstance(data, bytes):
        data = data.decode("utf8")

    records = _parse_records(data)
    names: List[str] = []
    seen = set()
    for r in records:
        for k in r:
            if k not in seen:
                seen.add(k)
                names.append(k)

    schema = po.explicit_schema
    if schema is not None:
        if po.unexpected_field_behavior == "error":
            extra = [n for n in names if schema.get_field_index(n) < 0]
            if extra:
                raise ValueError(f"unexpected JSON fields: {extra}")
        elif po.unexpected_field_behavior == "infer":
            for n in names:
                if schema.get_field_index(n) < 0:
                    schema = schema.append(T.Field(
                        n, infer_type([r.get(n) for r in records])))
        names = schema.names

    cols = {}
    for n in names:
        col = [r.get(n) for r in records]
        t = schema.field(n).type if schema is not None else None
        arr = _fast_array(col) if t is None else None
        cols[n] = arr if arr is not None else make_array(col, t)
    return Table.from_pydict(cols, schema or Schema(
        [T.Field(n, cols[n].type) for n in names]))


def open_json(source, read_options=None, parse_options=None):
    """A streaming ndjson reader (pyarrow.json.open_json): one block of
    ``block_size`` bytes, cut at a newline, read a step (json/reader.h
    StreamingReader); a later block's columns follow the first block's
    schema (a missing one null, a type widened)."""
    po = parse_options or ParseOptions()
    ro = read_options or ReadOptions()
    block = getattr(ro, "block_size", 1 << 20) or (1 << 20)
    data = _read_source(source)
    if not isinstance(data, bytes) or po.explicit_schema is not None:
        tbl = read_json(data, read_options, parse_options)
        return iter(tbl.to_batches(max_chunksize=max(1, block // 64)))

    spans = _split_newline_blocks(data, max(1, -(-len(data) // block)))

    def gen():
        schema = None
        for s in spans:
            part = read_json(data[s[0]:s[1]], read_options, parse_options)
            if schema is None:
                schema = part.schema
            elif not part.schema.equals(schema):
                part = _reindexed(part, schema.names,
                                  {f.name: f.type for f in schema.fields})
            yield from part.to_batches()

    return gen()
