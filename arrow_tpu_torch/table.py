"""Host chunked containers (counterpart of ``arrow_tpu/table.py``;
reference: cpp/src/arrow/chunked_array.h:74, record_batch.h:41,
table.h:43): ChunkedArray, RecordBatch, Table, TableGroupBy,
RecordBatchReader, ChunkResolver and Datum. The methods that compute
(``filter``, ``take``, ``drop_null``, ``sort``/``sort_by``, ``unique``,
``value_counts``, ``cast``, ``fill_null``, ``index``, ``group_by``,
``join`` and ``join_asof``) run through the port's plans and eager API,
on the card unless ``device="cpu"`` is given; the column edits, struct
round trips, ``to_string`` and ``validate`` are host work, as are the
interop methods: the C stream (``__arrow_c_stream__``, and
``RecordBatchReader.from_stream`` of any producer's capsule), the
dataframe interchange protocol, ``to_tensor``, ``serialize`` and the
pandas methods (which need pandas)."""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Mapping, Optional, Sequence, Union

import numpy as np

from . import types as T
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

    @property
    def data(self) -> "ChunkedArray":
        return self

    @property
    def nbytes(self) -> int:
        return sum(c.nbytes for c in self.chunks)

    def get_total_buffer_size(self) -> int:
        return self.nbytes

    @property
    def is_cpu(self) -> bool:
        return True

    # the methods that compute run on the chunks as one Array
    def _wrap(self, arr: Array) -> "ChunkedArray":
        return ChunkedArray([arr], arr.type)

    def cast(self, target, device=None) -> "ChunkedArray":
        return self._wrap(self.combine().cast(target, device=device))

    def dictionary_encode(self, device=None) -> "ChunkedArray":
        return self._wrap(self.combine().dictionary_encode(device=device))

    def filter(self, mask, null_selection_behavior: str = "drop",
               device=None) -> "ChunkedArray":
        if isinstance(mask, ChunkedArray):
            mask = mask.combine()
        return self._wrap(self.combine().filter(
            mask, null_selection_behavior, device=device))

    def take(self, indices, device=None) -> "ChunkedArray":
        if isinstance(indices, ChunkedArray):
            indices = indices.combine()
        return self._wrap(self.combine().take(indices, device=device))

    def drop_null(self, device=None) -> "ChunkedArray":
        return self._wrap(self.combine().drop_null(device=device))

    def fill_null(self, fill_value, device=None) -> "ChunkedArray":
        return self._wrap(self.combine().fill_null(fill_value,
                                                   device=device))

    def sort(self, order: str = "ascending", device=None,
             **kwargs) -> "ChunkedArray":
        return self._wrap(self.combine().sort(order, device=device,
                                              **kwargs))

    def unique(self, device=None) -> Array:
        return self.combine().unique(device=device)

    def value_counts(self, device=None) -> Array:
        return self.combine().value_counts(device=device)

    def is_null(self, nan_is_null: bool = False,
                device=None) -> "ChunkedArray":
        return self._wrap(self.combine().is_null(nan_is_null, device=device))

    def is_valid(self, device=None) -> "ChunkedArray":
        return self._wrap(self.combine().is_valid(device=device))

    def is_nan(self, device=None) -> "ChunkedArray":
        return self._wrap(self.combine().is_nan(device=device))

    def index(self, value, start=None, end=None, device=None) -> int:
        return self.combine().index(value, start, end, device=device)

    def flatten(self, device=None) -> List["ChunkedArray"]:
        """A list column's values, one ChunkedArray (``list_flatten``);
        any other column as it is."""
        if not self.type.is_nested:
            return [self]
        from .compute.registry import call_function
        return [self._wrap(call_function("list_flatten", [self.combine()],
                                         device=device))]

    def unify_dictionaries(self) -> "ChunkedArray":
        """A dictionary column of several chunks as one chunk over one
        dictionary."""
        if self.type.id != T.TypeId.DICTIONARY or len(self.chunks) <= 1:
            return self
        return self._wrap(self.combine())

    def to_string(self, **kwargs) -> str:
        return repr(self)

    format = to_string

    def validate(self, *, full: bool = False) -> None:
        for c in self.chunks:
            c.validate(full=full)

    def to_pandas(self):
        return self.combine().to_pandas()


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
        return RecordBatch(Schema([self.schema.fields[i] for i in idxs],
                                  self.schema.metadata),
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

    def drop_null(self, device=None) -> "RecordBatch":
        return self._via_table("drop_null", device=device)

    def cast(self, target_schema: Schema, device=None) -> "RecordBatch":
        return self._via_table("cast", target_schema, device=device)

    def add_column(self, i: int, field_, column) -> "RecordBatch":
        return self._via_table("add_column", i, field_, column)

    def append_column(self, field_, column) -> "RecordBatch":
        return self._via_table("append_column", field_, column)

    def set_column(self, i: int, field_, column) -> "RecordBatch":
        return self._via_table("set_column", i, field_, column)

    def remove_column(self, i: int) -> "RecordBatch":
        return self._via_table("remove_column", i)

    def drop_columns(self, columns) -> "RecordBatch":
        return self._via_table("drop_columns", columns)

    def field(self, i: Union[int, str]) -> Field:
        return self.schema[i]

    def itercolumns(self):
        return iter(self.columns)

    @property
    def shape(self):
        return (self.num_rows, self.num_columns)

    @property
    def nbytes(self) -> int:
        return sum(c.nbytes for c in self.columns)

    def get_total_buffer_size(self) -> int:
        return self.nbytes

    @property
    def is_cpu(self) -> bool:
        return True

    @property
    def device_type(self):
        from .device import DeviceAllocationType
        return DeviceAllocationType.CPU

    def copy_to(self, destination) -> "RecordBatch":
        return self

    def replace_schema_metadata(self, metadata=None) -> "RecordBatch":
        return RecordBatch(Schema(list(self.schema.fields), metadata),
                           list(self.columns))

    @classmethod
    def from_pylist(cls, rows, schema: Optional[Schema] = None):
        keys = list(schema.names) if schema is not None else \
            list(rows[0].keys()) if rows else []
        return cls.from_pydict({k: [r.get(k) for r in rows] for k in keys},
                               schema)

    @classmethod
    def from_struct_array(cls, struct_array) -> "RecordBatch":
        fields = list(struct_array.type.fields)
        rows = struct_array.to_pylist()
        return cls(Schema(fields), [
            array([None if r is None else r.get(f.name) for r in rows],
                  f.type) for f in fields])

    def to_struct_array(self) -> Array:
        return array(self.to_pylist(), T.struct(
            [(f.name, f.type) for f in self.schema.fields]))

    def to_string(self, **kwargs) -> str:
        return repr(self)

    def validate(self, *, full: bool = False) -> None:
        for c in self.columns:
            c.validate(full=full)

    def __arrow_c_stream__(self, requested_schema=None):
        from .c_data import batch_to_struct_data, stream_capsule
        return stream_capsule([batch_to_struct_data(self)],
                              Field("", T.struct(list(self.schema.fields))))

    def __dataframe__(self, nan_as_null: bool = False,
                      allow_copy: bool = True):
        """The dataframe interchange protocol (``interchange.py``)."""
        from .interchange import _ATDataFrame
        return _ATDataFrame(self, nan_as_null, allow_copy)

    def serialize(self, options=None):
        """The batch as an IPC stream, in a Buffer (ipc/writer.h
        SerializeRecordBatch)."""
        import io
        from . import ipc
        from .buffer import Buffer
        sink = io.BytesIO()
        with ipc.new_stream(sink, self.schema) as w:
            w.write_batch(self)
        return Buffer(sink.getvalue())

    def to_pandas(self):
        return Table.from_batches([self]).to_pandas()

    @classmethod
    def from_pandas(cls, df, schema: Optional[Schema] = None, device=None):
        """A batch of a pandas DataFrame (needs pandas), cast to
        ``schema`` where given (on the card unless ``device="cpu"``)."""
        t = Table.from_pandas(df)
        if schema is not None:
            t = t.cast(schema, device=device)
        return RecordBatch(t.schema, [c.combine() for c in t.columns])

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
        return sum(col.nbytes for col in self.columns)

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
        return Table(Schema([self.schema.fields[i] for i in idxs],
                            self.schema.metadata),
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

    def group_by(self, keys, use_threads: bool = True) -> "TableGroupBy":
        return TableGroupBy(self, keys)

    def join(self, right_table: "Table", keys, right_keys=None,
             join_type: str = "left outer", left_suffix: str = "",
             right_suffix: str = "", coalesce_keys: bool = True,
             device=None) -> "Table":
        """A hash join of two Tables, this one probing (a ``hashjoin``
        over two table sources). With ``coalesce_keys`` the right keys
        are not emitted (but for the right semi and anti joins), as in
        the reference, so a row only the right side has keeps no key."""
        from .acero import Declaration, HashJoinNodeOptions
        keys = [keys] if isinstance(keys, str) else list(keys)
        right_keys = keys if right_keys is None else \
            [right_keys] if isinstance(right_keys, str) else list(right_keys)
        right_output = None
        if coalesce_keys and join_type not in ("right semi", "right anti"):
            right_output = [n for n in right_table.schema.names
                            if n not in right_keys]
        return Declaration("hashjoin", HashJoinNodeOptions(
            join_type, left_keys=keys, right_keys=right_keys,
            right_output=right_output, output_suffix_for_left=left_suffix,
            output_suffix_for_right=right_suffix),
            inputs=[_source(self), _source(right_table)]).to_table(
                device=device)

    def join_asof(self, right_table: "Table", on: str, by, tolerance: int,
                  right_on=None, right_by=None, device=None) -> "Table":
        """For each row, the latest right row of the same ``by`` keys
        within ``tolerance`` of ``on`` (an ``asofjoin`` over two table
        sources)."""
        from .acero import AsofJoinNodeOptions, Declaration
        by = [by] if isinstance(by, str) else list(by)
        right_by = list(by) if right_by is None else \
            [right_by] if isinstance(right_by, str) else list(right_by)
        return Declaration("asofjoin", AsofJoinNodeOptions(
            left_on=on, left_by=by, right_on=right_on or on,
            right_by=right_by, tolerance=tolerance),
            inputs=[_source(self), _source(right_table)]).to_table(
                device=device)

    def cast(self, target_schema: Schema, device=None) -> "Table":
        """Each column cast to ``target_schema``'s type of it."""
        cols = []
        for f, c in zip(target_schema.fields, self.columns):
            combined = c.combine()
            cols.append(combined if combined.type == f.type
                        else combined.cast(f.type, device=device))
        return Table.from_arrays(cols, target_schema.names)

    # column edits
    def add_column(self, i: int, field_, column) -> "Table":
        if isinstance(column, ChunkedArray):
            col = column
        else:
            col = ChunkedArray([column if isinstance(column, Array) else
                                array(column, None if isinstance(field_, str)
                                      else field_.type)])
        if isinstance(field_, str):
            field_ = Field(field_, col.type)
        fields, cols = list(self.schema.fields), list(self.columns)
        fields.insert(i, field_)
        cols.insert(i, col)
        return Table(Schema(fields, self.schema.metadata), cols)

    def append_column(self, field_, column) -> "Table":
        return self.add_column(self.num_columns, field_, column)

    def remove_column(self, i: int) -> "Table":
        return Table(self.schema.remove(i),
                     self.columns[:i] + self.columns[i + 1:])

    def set_column(self, i: int, field_, column) -> "Table":
        return self.remove_column(i).add_column(i, field_, column)

    def drop_columns(self, names) -> "Table":
        if isinstance(names, str):
            names = [names]
        return self.select([n for n in self.schema.names if n not in names])

    drop = drop_columns

    def field(self, i: Union[int, str]) -> Field:
        return self.schema[i]

    def itercolumns(self):
        return iter(self.columns)

    def get_total_buffer_size(self) -> int:
        return self.nbytes

    @property
    def is_cpu(self) -> bool:
        return True

    def flatten(self) -> "Table":
        """Each struct column as a column a field, named
        ``struct.field`` (table.h Flatten)."""
        fields, cols = [], []
        for f, c in zip(self.schema.fields, self.columns):
            if f.type.id != T.TypeId.STRUCT:
                fields.append(f)
                cols.append(c)
                continue
            rows = c.to_pylist()
            for sub in f.type.fields:
                fields.append(Field(f"{f.name}.{sub.name}", sub.type, True))
                cols.append(ChunkedArray([array(
                    [None if r is None else r.get(sub.name) for r in rows],
                    sub.type)]))
        return Table(Schema(fields, self.schema.metadata), cols)

    def replace_schema_metadata(self, metadata=None) -> "Table":
        return Table(Schema(list(self.schema.fields), metadata),
                     list(self.columns))

    def unify_dictionaries(self) -> "Table":
        return Table(self.schema,
                     [c.unify_dictionaries() for c in self.columns])

    def to_string(self, **kwargs) -> str:
        return repr(self)

    def to_struct_array(self, max_chunksize: Optional[int] = None):
        st = T.struct([(f.name, f.type) for f in self.schema.fields])
        return ChunkedArray([array(b.to_pylist(), st)
                             for b in self.to_batches(max_chunksize)], st)

    @classmethod
    def from_struct_array(cls, struct_array,
                          schema: Optional[Schema] = None) -> "Table":
        chunks = struct_array.chunks if isinstance(
            struct_array, ChunkedArray) else [struct_array]
        return cls.from_batches([RecordBatch.from_struct_array(c)
                                 for c in chunks], schema)

    @classmethod
    def from_pylist(cls, rows, schema: Optional[Schema] = None) -> "Table":
        return cls.from_batches([RecordBatch.from_pylist(rows, schema)])

    def validate(self, *, full: bool = False) -> None:
        for c in self.columns:
            c.validate(full=full)

    def __arrow_c_stream__(self, requested_schema=None):
        """An ``arrow_array_stream`` capsule of the Table's batches; the
        batches point at the Table's buffers."""
        from .c_data import batch_to_struct_data, stream_capsule
        return stream_capsule(
            [batch_to_struct_data(rb) for rb in self.to_batches()],
            Field("", T.struct(list(self.schema.fields))))

    def __dataframe__(self, nan_as_null: bool = False,
                      allow_copy: bool = True):
        """The dataframe interchange protocol (``interchange.py``)."""
        from .interchange import _ATDataFrame
        return _ATDataFrame(self, nan_as_null, allow_copy)

    def to_tensor(self, null_to_nan: bool = False, row_major: bool = True):
        """A 2-D Tensor of a numeric Table, a column a column of the
        matrix (pyarrow Table.to_tensor); a null raises unless
        ``null_to_nan``."""
        from .tensor import Tensor
        cols = []
        for c in self.columns:
            a = c.combine()
            if a.null_count:
                if not null_to_nan:
                    raise ValueError(
                        "table has nulls; pass null_to_nan=True")
                v = a.data.values().astype(np.float64)
                v[~a.is_valid_mask()] = np.nan
            else:
                v = a.data.values()
            cols.append(np.asarray(v))
        m = np.column_stack(cols) if cols else np.empty((0, 0))
        if not row_major:
            m = np.asfortranarray(m)
        return Tensor.from_numpy(m)

    def to_pandas(self):
        """A pandas DataFrame, a column a Series (needs pandas)."""
        import pandas as pd
        return pd.DataFrame({f.name: self.column(f.name).combine().to_pandas()
                             for f in self.schema.fields})

    @classmethod
    def from_pandas(cls, df, schema: Optional[Schema] = None) -> "Table":
        """A Table of a pandas DataFrame (needs pandas): object columns
        with NaN and None as nulls, the others from their numpy arrays."""
        cols = {}
        for name in df.columns:
            s = df[name]
            if s.dtype == object:
                cols[name] = [None if v is None or (isinstance(v, float)
                                                    and v != v) else v
                              for v in s.tolist()]
            else:
                cols[name] = array(s.to_numpy())
        return cls.from_pydict(cols, schema)


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


class ChunkResolver:
    """A logical row to its (chunk, row in the chunk), by binary search
    over the chunks' offsets (reference: chunk_resolver.h:65)."""

    def __init__(self, chunks):
        self.offsets = np.concatenate([[0], np.cumsum([len(c)
                                                       for c in chunks])])

    def resolve(self, index: int):
        i = int(np.searchsorted(self.offsets, index, side="right") - 1)
        return i, int(index - self.offsets[i])

    def resolve_many(self, indices):
        idx = np.asarray(indices, dtype=np.int64)
        chunk = np.searchsorted(self.offsets, idx, side="right") - 1
        return chunk, idx - self.offsets[chunk]


class Datum:
    """A Scalar, Array, ChunkedArray, RecordBatch or Table with its kind
    (reference: datum.h:46); any other value is boxed as an untyped
    Scalar."""

    SCALAR, ARRAY, CHUNKED_ARRAY, RECORD_BATCH, TABLE = (
        "scalar", "array", "chunked_array", "record_batch", "table")

    def __init__(self, value):
        from .compute.registry import Scalar
        kinds = ((Scalar, self.SCALAR), (Array, self.ARRAY),
                 (ChunkedArray, self.CHUNKED_ARRAY),
                 (RecordBatch, self.RECORD_BATCH), (Table, self.TABLE))
        for cls, kind in kinds:
            if isinstance(value, cls):
                self.kind = kind
                break
        else:
            value, self.kind = Scalar(value, None), self.SCALAR
        self.value = value

    def is_scalar(self):
        return self.kind == self.SCALAR

    def is_array(self):
        return self.kind == self.ARRAY

    def __repr__(self):
        return f"Datum({self.kind}, {self.value!r})"


class RecordBatchReader:
    """An iterator of RecordBatches of one schema (reference:
    record_batch.h:334)."""

    def __init__(self, schema: Schema, batches_iter):
        self.schema = schema
        self._it = iter(batches_iter)

    @classmethod
    def from_batches(cls, schema: Schema, batches) -> "RecordBatchReader":
        return cls(schema, batches)

    @classmethod
    def from_stream(cls, data, schema: Optional[Schema] = None):
        """A reader over a reader, a Table, a RecordBatch, an
        ``arrow_array_stream`` capsule or another object that exports
        ``__arrow_c_stream__`` (imported through the C data interface,
        its batches copied), or an iterable of RecordBatches (of
        ``schema``, else of the first batch's)."""
        if isinstance(data, cls):
            return data
        if isinstance(data, Table):
            return cls(data.schema, data.to_batches())
        if isinstance(data, RecordBatch):
            return cls(data.schema, [data])
        if type(data).__name__ == "PyCapsule":
            from .c_data import import_stream_capsule
            return import_stream_capsule(data)
        if hasattr(data, "__arrow_c_stream__"):
            from .c_data import import_stream_capsule
            return import_stream_capsule(data.__arrow_c_stream__())
        batches = iter(data)
        if schema is None:
            first = next(batches)
            schema = first.schema
            batches = itertools.chain([first], batches)
        return cls(schema, batches)

    def close(self) -> None:
        self._it = iter(())

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __iter__(self):
        return self

    def __next__(self) -> RecordBatch:
        return next(self._it)

    read_next_batch = __next__

    def read_all(self) -> Table:
        return Table.from_batches(list(self._it), self.schema)

    def read_pandas(self):
        return self.read_all().to_pandas()

    def __arrow_c_stream__(self, requested_schema=None):
        """The reader's remaining batches as an ``arrow_array_stream``
        capsule (read now)."""
        from .c_data import batch_to_struct_data, stream_capsule
        return stream_capsule([batch_to_struct_data(b) for b in self._it],
                              Field("", T.struct(list(self.schema.fields))))
