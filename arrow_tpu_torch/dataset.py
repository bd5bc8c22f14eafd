"""Datasets in memory: partitioning, pruned scans (counterpart of
``arrow_tpu/dataset.py``; reference: cpp/src/arrow/dataset/, Dataset and
Fragment dataset.h:361,156, Scanner scanner.h:418, the hive and directory
Partitioning partition.h:67 with pruning by SimplifyWithGuarantee).

A dataset is a list of fragments, each a host Table (``InMemoryDataset``,
``dataset(tables)``) with an optional partition guarantee. A scan prunes
the fragments whose guarantee makes the filter false
(``simplify_with_guarantee``), and runs the rest as the plan source
``scan`` (``acero.ScanNodeOptions``): each fragment's columns are uploaded
once a column (``acero/source_cache.py``, so a repeated scan of the same
Tables uploads nothing), its filter, simplified by its guarantee, is
evaluated on the card, and the kept rows of all fragments become one
device table in one compaction (K2); a scan without a filter
concatenates its fragments' rows. ``Dataset.to_table`` and the
``Scanner`` run that source on ``device``, the card unless
``device="cpu"``; a filter may read columns that ``columns`` leaves out.

Not ported yet (ROADMAP.md, queue 1, item 13): a dataset of files
(``dataset(path)``), ``write_dataset``, the file formats and their
fragments, and ``Dataset.join``/``join_asof`` (``Table.join``); each
raises NotImplementedError. ``fragment_readahead`` is accepted and, as the
fragments are in memory, has nothing to read ahead.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

from .acero import Declaration, field
from .acero.expression import Expression, simplify_with_guarantee
from .acero.options import ScanNodeOptions
from .table import RecordBatch, Table
from .types import Field, Schema
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
        reference's signature; in-memory fragments have nothing to read
        ahead."""
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


def dataset(source, format=None, partitioning: Optional[Partitioning] = None,
            filesystem=None, schema: Optional[Schema] = None) -> Dataset:
    """A dataset of a host Table or RecordBatch, or a list of them (an
    ``InMemoryDataset``), or of a list of datasets (a ``UnionDataset``).
    A path or a list of paths is a dataset of files, not ported yet."""
    if isinstance(source, (Table, RecordBatch)):
        return InMemoryDataset(source, schema)
    if isinstance(source, (list, tuple)) and source:
        if all(isinstance(s, (Table, RecordBatch)) for s in source):
            return InMemoryDataset(source, schema)
        if all(isinstance(s, Dataset) for s in source):
            return UnionDataset(schema, source)
    _not_ported("a dataset of files (dataset(path))")


def write_dataset(data, base_dir, *args, **kwargs):
    _not_ported("write_dataset")


class FileFormat:
    """A file format of fragments: not ported yet."""

    def __init__(self, *args, **kwargs):
        _not_ported(f"the {type(self).__name__}")


class ParquetFileFormat(FileFormat):
    pass


class IpcFileFormat(FileFormat):
    pass


class FeatherFileFormat(FileFormat):
    pass


class CsvFileFormat(FileFormat):
    pass


class JsonFileFormat(FileFormat):
    pass


class OrcFileFormat(FileFormat):
    pass


class FileSystemDataset(Dataset):
    """A dataset of files: not ported yet."""

    def __init__(self, *args, **kwargs):
        _not_ported("FileSystemDataset")

    @classmethod
    def from_paths(cls, *args, **kwargs):
        _not_ported("FileSystemDataset")


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
