"""Top-level helpers (counterpart of ``arrow_tpu/api.py``; pyarrow's
module-level functions): ``scalar``, ``nulls``, ``repeat``,
``infer_type``, ``concat_arrays``, ``concat_batches``, ``concat_tables``
(with ``promote_options``), ``unify_schemas``, ``type_for_alias``,
``show_versions``, ``array_data_from_sequence`` and the pandas pair
``serialize_pandas``/``deserialize_pandas`` (which need pandas). All of
them are host work."""

from __future__ import annotations

from typing import List, Optional, Sequence

from . import types as _T
from .array.array import Array, array as _make_array
from .array.construct import array_data_from_sequence  # noqa: F401
from .compute.registry import Scalar
from .errors import ArrowInvalid
from .table import ChunkedArray, RecordBatch, Table
from .types import DataType, Field, Schema, TypeId


def scalar(value, type: Optional[DataType] = None) -> Scalar:
    """A typed Scalar of a Python value (pyarrow.scalar); the value goes
    through an Array of ``type`` so that it is checked and converted."""
    if type is None:
        type = infer_type([value])
    if value is not None:
        value = _make_array([value], type).to_pylist()[0]
    return Scalar(value, type)


def nulls(size: int, type: Optional[DataType] = None) -> Array:
    """An Array of ``size`` nulls (pyarrow.nulls), of the null type
    unless ``type`` is given."""
    return _make_array([None] * size, type or _T.null())


def repeat(value, size: int) -> Array:
    """An Array of one value ``size`` times (pyarrow.repeat)."""
    if isinstance(value, Scalar):
        return _make_array([value.value] * size, value.type)
    return _make_array([value] * size, infer_type([value]))


def infer_type(values: Sequence) -> DataType:
    """The type ``array()`` gives a Python sequence (pyarrow.infer_type)."""
    return _make_array(list(values)).type


def concat_arrays(arrays: Sequence[Array]) -> Array:
    """Arrays of one type end to end (pyarrow.concat_arrays; reference:
    array/concatenate.cc)."""
    arrays = list(arrays)
    if not arrays:
        raise ArrowInvalid("concat_arrays needs at least one array")
    if len(arrays) == 1:
        return arrays[0]
    from .compute.host_concat import concat_arrays as _concat
    return _concat(arrays, arrays[0].type)


def concat_batches(batches: Sequence[RecordBatch]) -> RecordBatch:
    """RecordBatches of one schema end to end."""
    batches = list(batches)
    if not batches:
        raise ArrowInvalid("concat_batches needs at least one batch")
    return RecordBatch(batches[0].schema, [
        concat_arrays([b.column(i) for b in batches])
        for i in range(batches[0].num_columns)])


def concat_tables(tables: Sequence[Table],
                  promote_options: str = "none") -> Table:
    """Tables end to end, their chunks kept (pyarrow.concat_tables). With
    ``promote_options="none"`` their column names must agree; with
    ``"default"`` or ``"permissive"`` the schemas are unified
    (``unify_schemas``) and a Table's missing columns are nulls."""
    tables = list(tables)
    if not tables:
        raise ArrowInvalid("concat_tables needs at least one table")
    if promote_options == "none":
        names = tables[0].schema.names
        if any(t.schema.names != names for t in tables[1:]):
            raise ArrowInvalid("concat_tables: schemas differ (pass "
                               "promote_options='default' to unify)")
    else:
        schema = unify_schemas([t.schema for t in tables])
        tables = [Table(schema, [ChunkedArray([
            t.column(f.name).combine() if f.name in t.column_names
            else nulls(t.num_rows, f.type)], f.type) for f in schema])
            for t in tables]
    batches = [b for t in tables for b in t.to_batches()]
    return Table.from_batches(batches, tables[0].schema)


def unify_schemas(schemas: Sequence[Schema],
                  promote_options: str = "default") -> Schema:
    """Fields merged by name in order of first appearance
    (pyarrow.unify_schemas; reference: type.cc UnifySchemas): a null-typed
    field takes the other's type, a nullable one makes the field
    nullable, and any other type conflict raises ArrowInvalid."""
    fields: List[Field] = []
    index = {}
    for s in schemas:
        for f in s:
            if f.name not in index:
                index[f.name] = len(fields)
                fields.append(f)
                continue
            cur = fields[index[f.name]]
            if cur.type != f.type:
                if cur.type.id == TypeId.NA:
                    fields[index[f.name]] = f
                elif f.type.id != TypeId.NA:
                    raise ArrowInvalid(
                        f"unify_schemas: field {f.name!r} has "
                        f"conflicting types {cur.type!r} vs {f.type!r}")
            elif f.nullable and not cur.nullable:
                fields[index[f.name]] = Field(cur.name, cur.type, True)
    return Schema(fields)


def type_for_alias(name: str) -> DataType:
    """Resolve a type alias string (pyarrow.type_for_alias)."""
    aliases = {
        "null": _T.null(), "bool": _T.bool_(), "boolean": _T.bool_(),
        "i1": _T.int8(), "int8": _T.int8(),
        "i2": _T.int16(), "int16": _T.int16(),
        "i4": _T.int32(), "int32": _T.int32(),
        "i8": _T.int64(), "int64": _T.int64(),
        "u1": _T.uint8(), "uint8": _T.uint8(),
        "u2": _T.uint16(), "uint16": _T.uint16(),
        "u4": _T.uint32(), "uint32": _T.uint32(),
        "u8": _T.uint64(), "uint64": _T.uint64(),
        "f2": _T.float16(), "halffloat": _T.float16(),
        "float16": _T.float16(),
        "f4": _T.float32(), "float": _T.float32(),
        "float32": _T.float32(),
        "f8": _T.float64(), "double": _T.float64(),
        "float64": _T.float64(),
        "string": _T.string(), "str": _T.string(), "utf8": _T.string(),
        "binary": _T.binary(),
        "large_string": _T.large_string(),
        "large_str": _T.large_string(),
        "large_utf8": _T.large_string(),
        "large_binary": _T.large_binary(),
        "date32": _T.date32(), "date32[day]": _T.date32(),
        "date64": _T.date64(), "date64[ms]": _T.date64(),
        "time32[s]": _T.time32("s"), "time32[ms]": _T.time32("ms"),
        "time64[us]": _T.time64("us"), "time64[ns]": _T.time64("ns"),
        "timestamp[s]": _T.timestamp("s"),
        "timestamp[ms]": _T.timestamp("ms"),
        "timestamp[us]": _T.timestamp("us"),
        "timestamp[ns]": _T.timestamp("ns"),
        "duration[s]": _T.duration("s"), "duration[ms]": _T.duration("ms"),
        "duration[us]": _T.duration("us"),
        "duration[ns]": _T.duration("ns"),
        "month_day_nano_interval": _T.month_day_nano_interval(),
    }
    t = aliases.get(name)
    if t is None:
        raise ValueError(f"no type alias {name!r}")
    return t


def serialize_pandas(df, preserve_index: bool = True) -> bytes:
    """A pandas DataFrame as IPC stream bytes (pyarrow.serialize_pandas;
    needs pandas)."""
    from . import ipc
    from .table import Table
    return ipc.serialize_table(Table.from_pandas(df))


def deserialize_pandas(buf):
    """IPC stream bytes as a pandas DataFrame (needs pandas)."""
    import io
    from . import ipc
    return ipc.open_stream(io.BytesIO(bytes(buf))).read_all().to_pandas()


def show_versions() -> None:
    """Prints the build and runtime facts (pyarrow.show_versions)."""
    from .config import build_info, runtime_info
    bi = build_info()
    ri = runtime_info()
    print("arrow_tpu_torch build info:")
    for k in ("version", "compiler_id", "build_type"):
        if hasattr(bi, k):
            print(f"  {k}: {getattr(bi, k)}")
    print("runtime info:")
    for k in dir(ri):
        if not k.startswith("_"):
            print(f"  {k}: {getattr(ri, k)}")


show_info = show_versions
