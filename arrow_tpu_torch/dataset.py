"""Datasets: partitioning, pruned scans, files and partitioned writes
(counterpart of ``arrow_tpu/dataset.py``; reference: cpp/src/arrow/dataset/,
Dataset and Fragment dataset.h:361,156, Scanner scanner.h:418, the hive and
directory Partitioning partition.h:67 with pruning by
SimplifyWithGuarantee, the partitioned writes of dataset_writer.cc).

A dataset is a list of fragments with an optional partition guarantee
each: host Tables (``InMemoryDataset``, ``dataset(tables)``) or files
(``FileSystemDataset``, ``dataset(path or paths, format=)``; IPC and
Feather V2, ``IpcFileFormat``/``FeatherFileFormat``). A scan prunes the
fragments whose guarantee makes the filter false
(``simplify_with_guarantee``), and runs the rest as the plan source
``scan`` (``acero.ScanNodeOptions``): each fragment gives a host Table of
the columns the scan needs (a file's mapped, only those columns loaded,
with its partition columns), whose columns are uploaded once a column
(``acero/source_cache.py``, so a repeated scan of the same Tables uploads
nothing); its filter, simplified by its guarantee, is evaluated on the
card, and the kept rows of all fragments become one device table in one
compaction (K2); a scan without a filter concatenates its fragments'
rows. ``Dataset.to_table`` and the ``Scanner`` run that source on
``device``, the card unless ``device="cpu"``; a filter may read columns
that ``columns`` leaves out. ``write_dataset`` writes a Table as one file
or one file a partition directory, the reference's bytes.

Not ported yet (ROADMAP.md, queue 1, item 13): the Parquet, CSV, JSON and
ORC formats, ``parquet_dataset``, and ``Dataset.join``/``join_asof``
(``Table.join``); each raises NotImplementedError. ``fragment_readahead``
is accepted and reads nothing ahead: a mapped file is read as the scan
uploads it.
"""
from __future__ import annotations

import posixpath
import re
from typing import Dict, List, Optional

import numpy as np

from .acero import Declaration, field
from .acero.expression import Expression, simplify_with_guarantee
from .acero.options import ScanNodeOptions
from .array.array import Array
from .array.data import ArrayData
from .buffer import Buffer
from .table import ChunkedArray, RecordBatch, Table
from .types import Field, Schema, TypeId
from .utils import bits as bitutil
from . import types as _T

_FILES = "ROADMAP.md, queue 1, item 13: the file readers and writers"


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not ported yet ({_FILES})")


# --- partitioning ------------------------------------------------------------

class Partitioning:
    def parse(self, rel_path: str):
        """A directory path -> ({name: value}, its guarantee Expression or
        None)."""
        raise NotImplementedError

    def format(self, values: Dict[str, object]) -> str:
        raise NotImplementedError


class HivePartitioning(Partitioning):
    """The key=value directory scheme (partition.h HivePartitioning)."""

    def __init__(self, schema: Optional[Schema] = None):
        self.schema = schema

    def _coerce(self, name: str, raw: str):
        if self.schema is not None:
            idx = self.schema.get_field_index(name)
            if idx >= 0:
                t = self.schema.fields[idx].type
                if t.is_integer:
                    return int(raw)
                if t.is_floating:
                    return float(raw)
                return raw
        if re.fullmatch(r"-?\d+", raw):
            return int(raw)
        return raw

    def parse(self, rel_path: str):
        values: Dict[str, object] = {}
        guarantee = None
        for part in rel_path.split("/"):
            if "=" not in part:
                continue
            k, v = part.split("=", 1)
            val = self._coerce(k, v)
            values[k] = val
            term = field(k) == val
            guarantee = term if guarantee is None else \
                Expression.call("and_kleene", guarantee, term)
        return values, guarantee

    def format(self, values: Dict[str, object]) -> str:
        return "/".join(f"{k}={v}" for k, v in values.items())


class DirectoryPartitioning(Partitioning):
    """The positional directory scheme: /<v1>/<v2>/ mapped to the
    schema's fields."""

    def __init__(self, schema: Schema):
        self.schema = schema

    def parse(self, rel_path: str):
        parts = [p for p in rel_path.split("/") if p]
        values: Dict[str, object] = {}
        guarantee = None
        for f, raw in zip(self.schema.fields, parts):
            val = int(raw) if f.type.is_integer else raw
            values[f.name] = val
            term = field(f.name) == val
            guarantee = term if guarantee is None else \
                Expression.call("and_kleene", guarantee, term)
        return values, guarantee

    def format(self, values: Dict[str, object]) -> str:
        return "/".join(str(values[f.name]) for f in self.schema.fields)


class FilenamePartitioning(Partitioning):
    """Partition keys in file names: name_key1_key2.ext
    (partition.h FilenamePartitioning)."""

    def __init__(self, schema: Schema):
        self.schema = schema

    def parse(self, path: str) -> dict:
        import os
        stem = os.path.basename(path).split(".")[0]
        parts = stem.split("_")[1:]
        out = {}
        for f, raw in zip(self.schema.fields, parts):
            if f.type.is_integer:
                out[f.name] = int(raw)
            elif f.type.is_floating:
                out[f.name] = float(raw)
            else:
                out[f.name] = raw
        return out

    def format_path(self, values: dict) -> str:
        return "_".join(str(values[f.name]) for f in self.schema.fields)


class PartitioningFactory:
    """Deferred partitioning discovery (partition.h PartitioningFactory):
    the key schema, strings unless given."""

    def __init__(self, flavor: str, field_names):
        self.flavor = flavor
        self.field_names = list(field_names or [])

    def finish(self, schema: Optional[Schema] = None) -> Partitioning:
        sch = schema or Schema([Field(n, _T.string(), True)
                                for n in self.field_names])
        if self.flavor == "hive":
            return HivePartitioning(sch)
        if self.flavor == "filename":
            return FilenamePartitioning(sch)
        return DirectoryPartitioning(sch)


def partitioning(schema: Optional[Schema] = None,
                 flavor: Optional[str] = None) -> Partitioning:
    if flavor == "hive":
        return HivePartitioning(schema)
    if schema is None:
        raise ValueError("directory partitioning needs a schema")
    return DirectoryPartitioning(schema)


# --- datasets and fragments --------------------------------------------------

def _indices(indices):
    """Row indices as an Array (a list of ints becomes an int64 one)."""
    from .array.array import Array, array
    from .table import ChunkedArray
    if isinstance(indices, (Array, ChunkedArray)):
        return indices
    return array(list(indices), _T.int64())


class _TableFragment:
    """A fragment over a host Table, with an optional partition
    guarantee."""

    def __init__(self, tbl: Table, partition_expression=None):
        self._tbl = tbl
        self.partition_expression = partition_expression
        self.path = "<memory>"

    def to_table(self, columns=None) -> Table:
        return self._tbl.select(columns) if columns else self._tbl

    def __repr__(self):
        return f"_TableFragment({self._tbl.num_rows} rows)"


class Dataset:
    def __init__(self, fragments: List, schema: Schema):
        self.fragments = fragments
        self._schema = schema

    @property
    def schema(self) -> Schema:
        return self._schema

    @schema.setter
    def schema(self, value: Schema):
        self._schema = value

    def get_fragments(self, filter: Optional[Expression] = None):
        """The fragments a scan under ``filter`` reads: those whose
        partition guarantee does not make it false."""
        for frag in self.fragments:
            if filter is not None and frag.partition_expression is not None:
                simplified = simplify_with_guarantee(
                    filter, frag.partition_expression)
                if simplified.kind == Expression.KIND_LITERAL and \
                        simplified.value is False:
                    continue
            yield frag

    def _scan(self, columns=None, filter=None) -> Declaration:
        return Declaration("scan", ScanNodeOptions(self, columns, filter))

    def to_table(self, columns: Optional[List[str]] = None,
                 filter: Optional[Expression] = None,
                 fragment_readahead: Optional[int] = None,
                 use_threads: bool = True, device=None) -> Table:
        """The rows under ``filter`` of ``columns`` (all where None) of
        every fragment, in fragment order, scanned on ``device``.
        ``fragment_readahead`` and ``use_threads`` are accepted for the
        reference's signature and read nothing ahead."""
        return self._scan(columns, filter).to_table(device=device)

    def scanner(self, columns=None, filter=None, device=None):
        return Scanner(self, columns, filter, device)

    def head(self, num_rows: int, columns=None, filter=None,
             device=None) -> Table:
        return self.to_table(columns=columns, filter=filter,
                             device=device).slice(0, num_rows)

    def count_rows(self, filter=None, device=None) -> int:
        """The rows under ``filter``, counted on ``device``: nothing is
        downloaded but the count."""
        from .acero.exec import _sources_on, execute_declaration
        from . import default_device
        names = self.schema.names[:1]
        plan = _sources_on(self._scan(names, filter), default_device(device))
        return int(execute_declaration(plan).row_count)

    def to_batches(self, columns=None, filter=None, device=None, **kwargs):
        return self.to_table(columns=columns, filter=filter,
                             device=device).to_batches()

    def take(self, indices, columns=None, filter=None, device=None) -> Table:
        return self.to_table(columns=columns, filter=filter,
                             device=device).take(_indices(indices),
                                                 device=device)

    def filter(self, expression) -> "Dataset":
        """A view of this dataset with ``expression`` applied to every
        scan (Dataset::filter)."""
        return _FilteredDataset(self.fragments, self.schema, expression)

    def sort_by(self, sorting, device=None, **kwargs) -> "Dataset":
        return InMemoryDataset(self.to_table(device=device).sort_by(
            sorting, device=device, **kwargs))

    def join(self, right_dataset, keys, right_keys=None,
             join_type="left outer", left_suffix=None, right_suffix=None,
             coalesce_keys=True, use_threads=True) -> Table:
        _not_ported("Dataset.join (Table.join)")

    def join_asof(self, right_dataset, on, by, tolerance, right_on=None,
                  right_by=None) -> Table:
        _not_ported("Dataset.join_asof (Table.join_asof)")

    def replace_schema(self, schema: Schema) -> "Dataset":
        return Dataset(self.fragments, schema)

    @property
    def partition_expression(self):
        return scalar(True)


class _FilteredDataset(Dataset):
    def __init__(self, fragments, schema, expression):
        super().__init__(fragments, schema)
        self._filter = expression

    def _scan(self, columns=None, filter=None) -> Declaration:
        combined = self._filter if filter is None else Expression.call(
            "and_kleene", self._filter, filter)
        return super()._scan(columns, combined)


class InMemoryDataset(Dataset):
    """A dataset over host Tables or RecordBatches, one fragment each
    (dataset.h InMemoryDataset)."""

    def __init__(self, source, schema: Optional[Schema] = None):
        if isinstance(source, (Table, RecordBatch)):
            tables = [source if isinstance(source, Table)
                      else Table.from_batches([source])]
        else:
            tables = [t if isinstance(t, Table)
                      else Table.from_batches([t]) for t in source]
        if not tables:
            raise ValueError("an in-memory dataset needs a Table")
        self._tables = tables
        Dataset.__init__(self, [_TableFragment(t) for t in tables],
                         schema or tables[0].schema)


class UnionDataset(Dataset):
    """The union of child datasets (dataset.h UnionDataset)."""

    def __init__(self, schema: Optional[Schema], children):
        frags = [f for c in children for f in c.fragments]
        Dataset.__init__(self, frags, schema or children[0].schema)
        self.children = list(children)


class TaggedRecordBatch:
    """A batch tagged with the fragment it came from (scanner.h
    TaggedRecordBatch)."""

    def __init__(self, record_batch, fragment):
        self.record_batch = record_batch
        self.fragment = fragment


class Scanner:
    """A scan of ``dataset``'s ``columns`` under ``filter``; its
    methods run it on ``device``, the card unless ``device="cpu"``."""

    def __init__(self, dataset: Dataset, columns=None, filter=None,
                 device=None):
        self.dataset = dataset
        self.columns = columns
        self.filter = filter
        self.device = device

    def to_table(self) -> Table:
        return self.dataset.to_table(self.columns, self.filter,
                                     device=self.device)

    def to_batches(self):
        return self.to_table().to_batches()

    def head(self, n: int) -> Table:
        return self.to_table().slice(0, n)

    def count_rows(self) -> int:
        return self.dataset.count_rows(self.filter, device=self.device)

    @classmethod
    def from_dataset(cls, dataset, columns=None, filter=None,
                     device=None, **kwargs) -> "Scanner":
        return cls(dataset, columns, filter, device)

    @classmethod
    def from_fragment(cls, fragment, schema=None, columns=None,
                      filter=None, device=None, **kwargs) -> "Scanner":
        return cls(Dataset([fragment], schema or Schema([])), columns,
                   filter, device)

    @classmethod
    def from_batches(cls, source, schema=None, columns=None, filter=None,
                     device=None, **kwargs) -> "Scanner":
        tbl = Table.from_batches(list(source), schema)
        return cls(InMemoryDataset(tbl), columns, filter, device)

    @property
    def dataset_schema(self) -> Schema:
        return self.dataset.schema

    @property
    def projected_schema(self) -> Schema:
        if self.columns is None:
            return self.dataset.schema
        return Schema([f for f in self.dataset.schema.fields
                       if f.name in set(self.columns)])

    def scan_batches(self):
        """Each kept fragment's rows of ``columns`` (unfiltered, as the
        reference's), tagged with it."""
        for frag in self.dataset.get_fragments(self.filter):
            for rb in frag.to_table(self.columns).to_batches():
                yield TaggedRecordBatch(rb, frag)

    def take(self, indices) -> Table:
        return self.to_table().take(_indices(indices), device=self.device)

    def to_reader(self):
        return self.to_table().to_reader()


# --- datasets of files ---------------------------------------------------------

class FileFormat:
    """A format of file fragments: a file's Table (only ``columns`` where
    given), its schema, and a Table written as one file."""
    name = "?"
    default_extname = "?"

    def read(self, fs, path: str, columns: Optional[List[str]] = None
             ) -> Table:
        raise NotImplementedError

    def inspect(self, fs, path: str) -> Schema:
        return self.read(fs, path).schema

    def write(self, tbl: Table, fs, path: str):
        raise NotImplementedError


class IpcFileFormat(FileFormat):
    """Arrow IPC files (dataset/file_ipc.h)."""
    name = "ipc"
    default_extname = "arrow"

    def _reader(self, fs, path: str):
        from . import ipc
        from .io_streams import memory_map
        local = fs.local_path(path)
        if local is None:
            with fs.open_input_stream(path) as f:
                return ipc.open_file(f.read())
        f = memory_map(local)
        try:
            return ipc.open_file(f)
        finally:
            f.close()  # the map itself stays while a Buffer over it lives

    def read(self, fs, path, columns=None) -> Table:
        """The file's Table, or its ``columns`` (all where empty). A local
        file is mapped and only those columns are loaded, their Buffers
        slices of the map, where the reference reads the whole file into
        bytes and then selects: the same Table."""
        return self._reader(fs, path).read_all(columns or None)

    def inspect(self, fs, path) -> Schema:
        """The file's schema, from its footer alone (the reference reads
        the whole file)."""
        return self._reader(fs, path).schema

    def write(self, tbl, fs, path):
        from . import ipc
        with fs.open_output_stream(path) as f:
            with ipc.new_file(f, tbl.schema) as w:
                w.write_table(tbl)


class FeatherFileFormat(IpcFileFormat):
    """Feather V2, the IPC file format (ipc/feather.h)."""
    name = "feather"
    default_extname = "feather"


def _later_format(name: str):
    def __init__(self, *args, **kwargs):
        _not_ported(f"the {name}")
    return type(name, (FileFormat,), {
        "__init__": __init__, "__doc__": f"Not ported yet ({_FILES})."})


ParquetFileFormat = _later_format("ParquetFileFormat")
CsvFileFormat = _later_format("CsvFileFormat")
JsonFileFormat = _later_format("JsonFileFormat")
OrcFileFormat = _later_format("OrcFileFormat")

_FORMATS = {"parquet": ParquetFileFormat, "ipc": IpcFileFormat,
            "arrow": IpcFileFormat, "feather": FeatherFileFormat,
            "csv": CsvFileFormat, "json": JsonFileFormat,
            "orc": OrcFileFormat}


def _format(format) -> FileFormat:
    return format if isinstance(format, FileFormat) else _FORMATS[format]()


def _repeated(value, n: int) -> Array:
    """``array([value] * n)``, without the list: the type the reference
    infers from ``value``, every row valid."""
    from .array.array import array
    one = array([value])
    t = one.type
    d = one.data
    if n == 0 or t.id == TypeId.NA:
        return array([value] * n)
    if t.id in (TypeId.STRING, TypeId.BINARY):
        raw = d.data_bytes().tobytes()
        if len(raw) * n >= 1 << 31:
            return array([value] * n)
        offs = np.arange(n + 1, dtype=np.int32) * np.int32(len(raw))
        return Array(ArrayData(t, n, [None, Buffer(offs),
                                      Buffer(raw * n)], null_count=0))
    if t.id == TypeId.BOOL:
        bits = bitutil.pack_bits(np.full(n, bool(value)))
        return Array(ArrayData(t, n, [None, Buffer(bits)], null_count=0))
    return Array(ArrayData(t, n, [None, Buffer(np.full(n, d.values()[0]))],
                           null_count=0))


class FileFragment:
    """One file and its partition guarantee (dataset.h:156)."""

    def __init__(self, fs, path: str, format: FileFormat,
                 partition_values: Dict[str, object],
                 partition_expression: Optional[Expression]):
        self.fs = fs
        self.path = path
        self.format = format
        self.partition_values = partition_values
        self.partition_expression = partition_expression

    def to_table(self, columns: Optional[List[str]] = None) -> Table:
        """The file's ``columns`` (all where None) with its partition
        columns, each value repeated over the rows, in ``columns``'
        order."""
        file_cols = None if columns is None else [
            c for c in columns if c not in self.partition_values]
        tbl = self.format.read(self.fs, self.path, file_cols)
        part = self.partition_values if columns is None else {
            k: v for k, v in self.partition_values.items() if k in columns}
        if part:
            n = tbl.num_rows
            tbl = Table.from_arrays(
                [c.combine() for c in tbl.columns]
                + [_repeated(v, n) for v in part.values()],
                list(tbl.column_names) + list(part))
        if columns is not None:
            tbl = tbl.select([c for c in columns if c in tbl.column_names])
        return tbl

    def schema(self) -> Schema:
        """``to_table()``'s schema, from the file's footer and the
        partition values (the reference reads the whole fragment)."""
        from .array.array import array
        file_schema = self.format.inspect(self.fs, self.path)
        if not self.partition_values:
            return file_schema
        return Schema([Field(f.name, f.type) for f in file_schema]
                      + [Field(k, array([v]).type)
                         for k, v in self.partition_values.items()])

    def __repr__(self):
        return f"FileFragment({self.path!r})"


Fragment = FileFragment


class FileSystemDataset(Dataset):
    """A dataset of file fragments (dataset.h:361)."""

    @classmethod
    def from_paths(cls, paths, schema=None, format="parquet",
                   filesystem=None) -> "FileSystemDataset":
        from .fs import LocalFileSystem
        fmt = _format(format)
        fs = filesystem or LocalFileSystem()
        frags = [FileFragment(fs, p, fmt, {}, None) for p in paths]
        return cls(frags, schema or frags[0].schema())

    @property
    def files(self) -> List[str]:
        return [f.path for f in self.fragments]


def dataset(source, format="parquet",
            partitioning: Optional[Partitioning] = None, filesystem=None,
            schema: Optional[Schema] = None) -> Dataset:
    """A dataset of a host Table or RecordBatch, or a list of them (an
    ``InMemoryDataset``); of a list of datasets (a ``UnionDataset``); or
    of files in ``format``: a list of paths, or every file under a
    directory, each with the partition values ``partitioning`` parses
    from its directory (a ``FileSystemDataset``)."""
    from .fs import FileSelector, LocalFileSystem
    if isinstance(source, (Table, RecordBatch)):
        return InMemoryDataset(source, schema)
    if isinstance(source, (list, tuple)) and source:
        if all(isinstance(s, (Table, RecordBatch)) for s in source):
            return InMemoryDataset(source, schema)
        if all(isinstance(s, Dataset) for s in source):
            return UnionDataset(schema, source)
    fmt = _format(format)
    fs = filesystem or LocalFileSystem()
    if isinstance(source, (list, tuple)):
        frags = [FileFragment(fs, p, fmt, {}, None) for p in source]
    else:
        frags = []
        for info in fs.get_file_info(FileSelector(source, recursive=True)):
            if not info.is_file:
                continue
            rel_dir = posixpath.dirname(posixpath.relpath(info.path, source))
            values, guarantee = ({}, None)
            if partitioning is not None and rel_dir:
                values, guarantee = partitioning.parse(rel_dir)
            frags.append(FileFragment(fs, info.path, fmt, values, guarantee))
    if not frags:
        raise ValueError(f"no files found in {source!r}")
    return FileSystemDataset(frags, schema or frags[0].schema())


# --- write_dataset -------------------------------------------------------------

def _row_codes(arr: Array) -> np.ndarray:
    """An int64 code a row: equal for equal values, -1 for a null."""
    d = arr.data
    tid = arr.type.id
    if tid == TypeId.DICTIONARY:
        codes = _canonical(d)[d.values().astype(np.int64)]
    elif arr.type.is_numeric or arr.type.is_temporal or tid == TypeId.BOOL:
        codes = np.unique(d.values(), return_inverse=True)[1].reshape(-1)
    else:
        seen: Dict[object, int] = {}
        codes = np.array([seen.setdefault(v, len(seen))
                          for v in arr.to_pylist()], dtype=np.int64)
    codes = codes.astype(np.int64)
    if arr.null_count:
        codes[~arr.is_valid_mask()] = -1
    return codes


def _canonical(d: ArrayData) -> np.ndarray:
    """Each dictionary code's first code of an equal value (a dictionary
    may repeat a value; the reference keys by value)."""
    seen: Dict[object, int] = {}
    return np.array([seen.setdefault(v, i) for i, v in
                     enumerate(Array(d.dictionary).to_pylist())],
                    dtype=np.int64)


def _first_rows(codes: np.ndarray, n_codes: int) -> np.ndarray:
    """Each code's first row in ``codes`` (``len(codes)`` where absent)."""
    first = np.full(n_codes, len(codes), dtype=np.int64)
    np.minimum.at(first, codes, np.arange(len(codes)))
    return first


def _partition_groups(arrays: List[Array]):
    """(the key tuple, its rows ascending) of each distinct key of the
    partition columns, in the reference's order: by ``str`` of the key,
    ties in order of first appearance."""
    n = len(arrays[0])
    combined = np.zeros(n, dtype=np.int64)
    for a in arrays:
        codes = _row_codes(a) + 1
        combined = combined * (int(codes.max(initial=0)) + 1) + codes
    if int(combined.max(initial=0)) < 1 << 24:
        counts = np.bincount(combined)
        remap = np.cumsum(counts > 0) - 1
        gid, ngroups = remap[combined], int(remap[-1]) + 1
    else:
        _, gid = np.unique(combined, return_inverse=True)
        gid = gid.reshape(-1)
        ngroups = int(gid.max()) + 1
    first = _first_rows(gid, ngroups)
    # a stable sort of narrow ids is numpy's radix sort
    order = np.argsort(gid.astype(np.uint16) if ngroups < 1 << 16 else gid,
                       kind="stable")
    ends = np.cumsum(np.bincount(gid, minlength=ngroups))
    starts = ends - np.bincount(gid, minlength=ngroups)
    keys = [tuple(a.slice(int(r), 1).to_pylist()[0] for a in arrays)
            for r in first]
    for g in sorted(range(ngroups), key=lambda g: (str(keys[g]), first[g])):
        yield keys[g], order[starts[g]:ends[g]]


def _gather_bytes(d: ArrayData, rows: np.ndarray, valid) -> tuple:
    """(offsets, bytes) of a variable-size binary column's ``rows``, a null
    row empty."""
    offs = d.offsets().astype(np.int64)
    starts = offs[rows]
    lens = offs[rows + 1] - starts
    if valid is not None:
        lens[~valid] = 0
    new = np.zeros(len(rows) + 1, dtype=np.int64)
    np.cumsum(lens, out=new[1:])
    at = np.repeat(starts - new[:-1], lens) + np.arange(new[-1])
    return new, d.data_bytes()[at]


def _rebuilt(arr: Array, rows: np.ndarray) -> Array:
    """``array([arr.to_pylist()[i] for i in rows], arr.type)`` in numpy:
    the reference's Array, byte for byte (zeros under nulls, no validity
    where every row is valid, a dictionary of the values present in order
    of first appearance)."""
    from .array.array import array
    t = arr.type
    tid = t.id
    d = arr.data
    n = len(rows)
    valid = arr.is_valid_mask()[rows] if arr.null_count else None
    validity = None if valid is None or valid.all() else \
        Buffer(bitutil.pack_bits(valid))
    if tid == TypeId.BOOL:
        bits = d.values()[rows] if valid is None else \
            d.values()[rows] & valid
        return Array(ArrayData(t, n, [validity,
                                      Buffer(bitutil.pack_bits(bits))]))
    if tid in (TypeId.STRING, TypeId.BINARY, TypeId.LARGE_STRING,
               TypeId.LARGE_BINARY):
        offs, data = _gather_bytes(d, rows, valid)
        wide = tid in (TypeId.LARGE_STRING, TypeId.LARGE_BINARY)
        return Array(ArrayData(t, n, [validity, Buffer(
            offs if wide else offs.astype(np.int32)), Buffer(data)]))
    if tid == TypeId.DICTIONARY:
        codes = _canonical(d)[d.values()[rows].astype(np.int64)]
        live = codes if valid is None else codes[valid]
        first = _first_rows(live, d.dictionary.length)
        present = np.flatnonzero(first < len(live))
        kept = present[np.argsort(first[present], kind="stable")]
        remap = np.zeros(max(d.dictionary.length, 1), dtype=np.int64)
        remap[kept] = np.arange(len(kept))
        idx = remap[codes]
        if valid is not None:
            idx[~valid] = 0
        return Array(ArrayData(t, n, [validity, Buffer(
            idx.astype(t.index_type.to_numpy_dtype()))],
            dictionary=_rebuilt(Array(d.dictionary), kept).data))
    if t.is_numeric or t.is_temporal or tid == TypeId.INTERVAL_MONTHS:
        vals = d.values()[rows]
        if valid is not None:
            vals[~valid] = 0
        return Array(ArrayData(t, n, [validity, Buffer(vals)]))
    values = arr.to_pylist()
    return array([values[i] for i in rows], t)


def write_dataset(data, base_dir: str, format="parquet",
                  partitioning=None, partitioning_flavor: Optional[str] = None,
                  filesystem=None, basename_template: str = "part-{i}.{ext}",
                  existing_data_behavior: str = "overwrite_or_ignore"):
    """Write ``data`` (a Table or a RecordBatch) under ``base_dir`` in
    ``format``: one file, or with ``partitioning`` (a Partitioning, or
    column names with ``partitioning_flavor`` "hive" or None for
    directories) one file a directory of each distinct key, its other
    columns' rows in order (dataset_writer.cc). The reference groups the
    rows in Python a row; the port groups them in numpy and writes the
    same directories, file names and bytes."""
    from .fs import LocalFileSystem
    fmt = _format(format)
    fs = filesystem or LocalFileSystem()
    if isinstance(data, RecordBatch):
        data = Table.from_batches([data])
    if isinstance(partitioning, (list, tuple)):
        part_schema = Schema([data.schema.field(n) for n in partitioning])
        partitioning = (HivePartitioning(part_schema)
                        if partitioning_flavor == "hive"
                        else DirectoryPartitioning(part_schema))
    fs.create_dir(base_dir)
    name = basename_template.format(i=0, ext=fmt.default_extname)
    if partitioning is None:
        fmt.write(data, fs, posixpath.join(base_dir, name))
        return
    part_names = [f.name for f in partitioning.schema.fields]
    rest = Schema([f for f in data.schema.fields if f.name not in part_names])
    if data.num_rows == 0:
        return
    rest_cols = [data.column(f.name).combine() for f in rest]
    for key, rows in _partition_groups([data.column(n).combine()
                                        for n in part_names]):
        sub = Table(rest, [ChunkedArray([_rebuilt(c, rows)], f.type)
                           for c, f in zip(rest_cols, rest)])
        d = posixpath.join(base_dir,
                           partitioning.format(dict(zip(part_names, key))))
        fs.create_dir(d)
        fmt.write(sub, fs, posixpath.join(d, name))


# --- the write options, the written files, the factories ----------------------

class FileWriteOptions:
    """A format's write options (dataset/file_base.h FileWriteOptions)."""

    def __init__(self, **kwargs):
        self.options = kwargs


class IpcFileWriteOptions(FileWriteOptions):
    pass


class WrittenFile:
    """What a write hands its file_visitor."""

    def __init__(self, path, metadata=None, size=0):
        self.path = path
        self.metadata = metadata
        self.size = size


class FileSystemFactoryOptions:
    def __init__(self, partition_base_dir="", partitioning=None,
                 exclude_invalid_files=True, selector_ignore_prefixes=None):
        self.partition_base_dir = partition_base_dir
        self.partitioning = partitioning
        self.exclude_invalid_files = exclude_invalid_files
        self.selector_ignore_prefixes = list(selector_ignore_prefixes
                                             or (".", "_"))


class DatasetFactory:
    """Deferred dataset construction (dataset/discovery.h)."""

    def __init__(self, source, format="parquet", partitioning=None,
                 filesystem=None):
        self._source = source
        self._format = format
        self._partitioning = partitioning
        self._filesystem = filesystem

    def inspect(self) -> Schema:
        return self.finish().schema

    def finish(self, schema: Optional[Schema] = None) -> Dataset:
        return dataset(self._source, format=self._format,
                       partitioning=self._partitioning,
                       filesystem=self._filesystem)


class FileSystemDatasetFactory(DatasetFactory):
    pass


class UnionDatasetFactory(DatasetFactory):
    def __init__(self, factories):
        self._factories = list(factories)

    def finish(self, schema: Optional[Schema] = None) -> Dataset:
        return UnionDataset(None, [f.finish() for f in self._factories])


def parquet_dataset(metadata_path, schema=None, filesystem=None,
                    format=None, partitioning=None, partition_base_dir=None):
    _not_ported("parquet_dataset")

def get_partition_keys(partition_expression) -> dict:
    """The key == value pairs of a partition guarantee
    (pyarrow.dataset.get_partition_keys)."""
    out: dict = {}
    if partition_expression is None:
        return out

    def walk(e):
        if e.kind != Expression.KIND_CALL:
            return
        if e.fn == "equal":
            lhs, rhs = e.args
            if lhs.kind == Expression.KIND_FIELD and \
                    rhs.kind == Expression.KIND_LITERAL:
                out[lhs.name] = rhs.value
        elif e.fn in ("and_kleene", "and"):
            for a in e.args:
                walk(a)

    walk(partition_expression)
    return out


def scalar(value):
    """An Expression literal (pyarrow.dataset.scalar)."""
    from .acero.expression import scalar as _scalar
    return _scalar(value)
