"""Host chunked containers (counterpart of ``arrow_tpu/table.py``;
reference: cpp/src/arrow/chunked_array.h:74, record_batch.h:41,
table.h:43): ChunkedArray, RecordBatch, Table, TableGroupBy and
RecordBatchReader. ``filter``, ``take``, ``drop_null``, ``sort_by`` and
``group_by`` run through the port's plans and eager API, on the card
unless ``device="cpu"`` is given."""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Union

from .array.array import Array, array, pylist_equal
from .types import DataType, Field, Schema


class ChunkedArray:
    """Arrays of one type end to end. A table source keeps its device
    state a column, weakly (``acero.source_cache``)."""
    __slots__ = ("chunks", "type", "__weakref__")

    def __init__(self, chunks: Sequence[Array],
                 type: Optional[DataType] = None):
        chunks = [c if isinstance(c, Array) else array(c) for c in chunks]
        if type is None:
            if not chunks:
                raise ValueError("need type for empty ChunkedArray")
            type = chunks[0].type
        for c in chunks:
            if c.type != type:
                raise TypeError(f"chunk type {c.type!r} != {type!r}")
        self.chunks = list(chunks)
        self.type = type

    @property
    def num_chunks(self) -> int:
        return len(self.chunks)

    def __len__(self) -> int:
        return sum(len(c) for c in self.chunks)

    length = property(__len__)

    @property
    def null_count(self) -> int:
        return sum(c.null_count for c in self.chunks)

    def chunk(self, i: int) -> Array:
        return self.chunks[i]

    def combine(self) -> Array:
        """The chunks as one Array."""
        from .compute.host_concat import concat_arrays
        if len(self.chunks) == 1:
            return self.chunks[0]
        return concat_arrays(self.chunks, self.type)

    combine_chunks = combine

    def to_pylist(self) -> List[Any]:
        out = []
        for c in self.chunks:
            out.extend(c.to_pylist())
        return out

    def to_numpy(self):
        return self.combine().to_numpy()

    def slice(self, offset: int,
              length: Optional[int] = None) -> "ChunkedArray":
        total = len(self)
        if length is None:
            length = total - offset
        out = []
        for c in self.chunks:
            if length <= 0:
                break
            if offset >= len(c):
                offset -= len(c)
                continue
            take = min(len(c) - offset, length)
            out.append(c.slice(offset, take))
            offset = 0
            length -= take
        return ChunkedArray(out, self.type)

    def equals(self, other: "ChunkedArray") -> bool:
        return (self.type == other.type
                and pylist_equal(self.to_pylist(), other.to_pylist()))

    def iterchunks(self):
        return iter(self.chunks)

    def __repr__(self):
        return (f"<ChunkedArray {self.type!r} chunks={self.num_chunks} "
                f"len={len(self)}>")


def chunked_array(chunks, type: Optional[DataType] = None) -> ChunkedArray:
    if chunks and not isinstance(chunks[0], (Array, ChunkedArray, list,
                                             tuple)):
        chunks = [chunks]
    return ChunkedArray([c if isinstance(c, Array) else array(c, type)
                         for c in chunks], type)


def _columns(data: Mapping[str, Any], schema: Optional[Schema]):
    if schema is None:
        cols = [v if isinstance(v, Array) else array(v)
                for v in data.values()]
        return Schema([Field(k, c.type) for k, c in zip(data, cols)]), cols
    return schema, [v if isinstance(v, Array) else array(v, schema[i].type)
                    for i, v in enumerate(data.values())]


class RecordBatch:
    """Equal-length Arrays under a schema. A table source over it keeps
    its one-batch Table, weakly (``acero.source_cache.table_of``)."""
    __slots__ = ("schema", "columns", "__weakref__")

    def __init__(self, schema: Schema, columns: Sequence[Array]):
        if len(schema) != len(columns):
            raise ValueError("schema/column count mismatch")
        n = len(columns[0]) if columns else 0
        if any(len(c) != n for c in columns):
            raise ValueError("column length mismatch")
        self.schema = schema
        self.columns = list(columns)

    @classmethod
    def from_pydict(cls, data: Mapping[str, Any],
                    schema: Optional[Schema] = None) -> "RecordBatch":
        return cls(*_columns(data, schema))

    @classmethod
    def from_arrays(cls, arrays: Sequence, names: Sequence[str],
                    schema: Optional[Schema] = None) -> "RecordBatch":
        cols = [a if isinstance(a, Array) else array(a) for a in arrays]
        if schema is None:
            schema = Schema([Field(n, c.type) for n, c in zip(names, cols)])
        return cls(schema, cols)

    @property
    def num_rows(self) -> int:
        return len(self.columns[0]) if self.columns else 0

    @property
    def num_columns(self) -> int:
        return len(self.columns)

    def __len__(self) -> int:
        return self.num_rows

    def column(self, i: Union[int, str]) -> Array:
        if isinstance(i, str):
            idx = self.schema.get_field_index(i)
            if idx < 0:
                raise KeyError(f"no column named {i!r}")
            i = idx
        return self.columns[i]

    __getitem__ = column

    @property
    def column_names(self) -> List[str]:
        return self.schema.names

    def slice(self, offset: int,
              length: Optional[int] = None) -> "RecordBatch":
        return RecordBatch(self.schema,
                           [c.slice(offset, length) for c in self.columns])

    def select(self, names: Sequence[Union[str, int]]) -> "RecordBatch":
        idxs = [self.schema.get_field_index(n) if isinstance(n, str) else n
                for n in names]
        return RecordBatch(Schema([self.schema.fields[i] for i in idxs]),
                           [self.columns[i] for i in idxs])

    def to_pydict(self) -> Dict[str, List[Any]]:
        return {f.name: c.to_pylist()
                for f, c in zip(self.schema.fields, self.columns)}

    def to_pylist(self) -> List[Dict[str, Any]]:
        cols = self.to_pydict()
        return [dict(zip(cols, row)) for row in zip(*cols.values())]

    def equals(self, other: "RecordBatch") -> bool:
        return (self.schema.equals(other.schema)
                and all(a.equals(b) for a, b in
                        zip(self.columns, other.columns)))

    def rename_columns(self, names) -> "RecordBatch":
        if len(names) != len(self.schema):
            raise ValueError("name count mismatch")
        return RecordBatch(_renamed(self.schema, names), self.columns)

    def _via_table(self, op, *args, **kwargs) -> "RecordBatch":
        out = getattr(Table.from_batches([self]), op)(*args, **kwargs)
        return RecordBatch(out.schema, [c.combine() for c in out.columns])

    def filter(self, mask, null_selection_behavior: str = "drop",
               device=None):
        return self._via_table("filter", mask, null_selection_behavior,
                               device=device)

    def take(self, indices, device=None):
        return self._via_table("take", indices, device=device)

    def sort_by(self, sorting, device=None, **kwargs):
        return self._via_table("sort_by", sorting, device=device, **kwargs)

    def __repr__(self):
        return (f"<RecordBatch rows={self.num_rows} "
                f"cols={self.schema.names}>")


def _renamed(schema: Schema, names) -> Schema:
    return Schema([Field(n, f.type, f.nullable)
                   for f, n in zip(schema.fields, names)],
                  schema.metadata)


def record_batch(data, schema: Optional[Schema] = None,
                 names: Optional[Sequence[str]] = None) -> RecordBatch:
    if isinstance(data, Mapping):
        return RecordBatch.from_pydict(data, schema)
    if names is not None:
        return RecordBatch.from_arrays(data, names, schema)
    raise TypeError("record_batch needs a dict or (arrays, names)")


def _source(tbl):
    from .acero import Declaration, TableSourceNodeOptions
    return Declaration("table_source", TableSourceNodeOptions(tbl))


class Table:
    __slots__ = ("schema", "columns")

    def __init__(self, schema: Schema, columns: Sequence[ChunkedArray]):
        self.schema = schema
        self.columns = list(columns)

    @classmethod
    def from_pydict(cls, data: Mapping[str, Any],
                    schema: Optional[Schema] = None) -> "Table":
        return cls.from_batches([RecordBatch.from_pydict(data, schema)])

    @classmethod
    def from_arrays(cls, arrays, names) -> "Table":
        return cls.from_batches([RecordBatch.from_arrays(arrays, names)])

    @classmethod
    def from_batches(cls, batches: Sequence[RecordBatch],
                     schema: Optional[Schema] = None) -> "Table":
        if not batches:
            if schema is None:
                raise ValueError("need schema for empty table")
            return cls(schema, [ChunkedArray([], f.type) for f in schema])
        schema = schema or batches[0].schema
        return cls(schema, [ChunkedArray([b.columns[i] for b in batches],
                                         schema[i].type)
                            for i in range(len(schema))])

    @property
    def num_rows(self) -> int:
        return len(self.columns[0]) if self.columns else 0

    @property
    def num_columns(self) -> int:
        return len(self.columns)

    def __len__(self) -> int:
        return self.num_rows

    @property
    def column_names(self) -> List[str]:
        return self.schema.names

    @property
    def shape(self):
        return (self.num_rows, self.num_columns)

    @property
    def nbytes(self) -> int:
        return sum(c.nbytes for col in self.columns for c in col.chunks)

    def column(self, i: Union[int, str]) -> ChunkedArray:
        if isinstance(i, str):
            idx = self.schema.get_field_index(i)
            if idx < 0:
                raise KeyError(f"no column named {i!r}")
            i = idx
        return self.columns[i]

    __getitem__ = column

    def select(self, names) -> "Table":
        idxs = [self.schema.get_field_index(n) if isinstance(n, str) else n
                for n in names]
        return Table(Schema([self.schema.fields[i] for i in idxs]),
                     [self.columns[i] for i in idxs])

    def to_batches(self,
                   max_chunksize: Optional[int] = None) -> List[RecordBatch]:
        combined = [c.combine() for c in self.columns]
        n = self.num_rows
        if max_chunksize is None or max_chunksize >= n:
            return [RecordBatch(self.schema, combined)]
        return [RecordBatch(self.schema, [c.slice(s, max_chunksize)
                                          for c in combined])
                for s in range(0, n, max_chunksize)]

    def to_reader(self, max_chunksize: Optional[int] = None):
        return RecordBatchReader(self.schema,
                                 self.to_batches(max_chunksize))

    def combine_chunks(self) -> "Table":
        return Table(self.schema, [ChunkedArray([c.combine()], c.type)
                                   for c in self.columns])

    def to_pydict(self) -> Dict[str, List[Any]]:
        """Column name -> Python values: the one place that builds a
        Python value a row."""
        return {f.name: c.to_pylist()
                for f, c in zip(self.schema.fields, self.columns)}

    def to_pylist(self) -> List[Dict[str, Any]]:
        cols = self.to_pydict()
        return [dict(zip(cols, row)) for row in zip(*cols.values())]

    def slice(self, offset: int, length: Optional[int] = None) -> "Table":
        return Table(self.schema,
                     [c.slice(offset, length) for c in self.columns])

    def rename_columns(self, names) -> "Table":
        if len(names) != len(self.schema):
            raise ValueError("name count mismatch")
        return Table(_renamed(self.schema, names), self.columns)

    def equals(self, other: "Table") -> bool:
        return (self.schema.equals(other.schema)
                and all(a.equals(b)
                        for a, b in zip(self.columns, other.columns)))

    def __repr__(self):
        return f"<Table rows={self.num_rows} cols={self.schema.names}>"

    # compute through the plans and the eager API
    def filter(self, mask, null_selection_behavior: str = "drop",
               device=None) -> "Table":
        """Rows where ``mask`` (a bool Array or ChunkedArray, or an
        Expression run as a filter node) is true."""
        if not isinstance(mask, (Array, ChunkedArray)):
            from .acero import Declaration, FilterNodeOptions
            return Declaration.from_sequence([
                _source(self), Declaration("filter", FilterNodeOptions(mask)),
            ]).to_table(device=device)
        from .compute import filter as _filter
        return _filter(self, mask, null_selection_behavior, device=device)

    def take(self, indices, device=None) -> "Table":
        from .compute import take as _take
        return _take(self, indices, device=device)

    def drop_null(self, device=None) -> "Table":
        from .compute import drop_null as _dn
        return _dn(self, device=device)

    def sort_by(self, sorting, null_placement: str = "at_end",
                device=None) -> "Table":
        from .acero import Declaration, OrderByNodeOptions
        if isinstance(sorting, str):
            sorting = [(sorting, "ascending")]
        return Declaration.from_sequence([
            _source(self),
            Declaration("order_by", OrderByNodeOptions(sorting,
                                                       null_placement)),
        ]).to_table(device=device)

    def group_by(self, keys) -> "TableGroupBy":
        return TableGroupBy(self, keys)


class TableGroupBy:
    """``Table.group_by(keys).aggregate([(target, fn[, options]), ...])``:
    an aggregate node over the table, each output named
    ``<target>_<fn>``."""

    def __init__(self, table: Table, keys):
        self.table = table
        self.keys = [keys] if isinstance(keys, str) else list(keys)

    def aggregate(self, aggregations, device=None) -> Table:
        from .acero import AggregateNodeOptions, Declaration
        aggs = []
        for spec in aggregations:
            target, fn = spec[0], spec[1]
            opts = spec[2] if len(spec) == 3 else None
            base = fn[5:] if fn.startswith("hash_") else fn
            label = target if isinstance(target, str) else \
                "_".join(target) if target else ""
            aggs.append((target, base, opts,
                         f"{label}_{base}" if label else base))
        return Declaration.from_sequence([
            _source(self.table),
            Declaration("aggregate", AggregateNodeOptions(aggs, self.keys)),
        ]).to_table(device=device)


def table(data, schema: Optional[Schema] = None, names=None) -> Table:
    if isinstance(data, Mapping):
        return Table.from_pydict(data, schema)
    if isinstance(data, Sequence) and data and isinstance(data[0],
                                                          RecordBatch):
        return Table.from_batches(data, schema)
    if names is not None:
        return Table.from_arrays(data, names)
    raise TypeError("table needs dict, batches, or (arrays, names)")


class RecordBatchReader:
    """An iterator of RecordBatches of one schema (reference:
    record_batch.h:334)."""

    def __init__(self, schema: Schema, batches_iter):
        self.schema = schema
        self._it = iter(batches_iter)

    @classmethod
    def from_batches(cls, schema: Schema, batches) -> "RecordBatchReader":
        return cls(schema, batches)

    def __iter__(self):
        return self

    def __next__(self) -> RecordBatch:
        return next(self._it)

    read_next_batch = __next__

    def read_all(self) -> Table:
        return Table.from_batches(list(self._it), self.schema)
