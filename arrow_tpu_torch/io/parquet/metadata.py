"""Parquet's metadata views and its dataset helpers (counterpart of
``arrow_tpu/io/parquet/metadata.py``; reference: cpp/src/parquet/metadata.h,
FileMetaData :106, RowGroupMetaData, ColumnChunkMetaData, Statistics: the
pyarrow.parquet.FileMetaData family).

The views read the thrift structs the reader parsed; field ids follow
parquet.thrift. ``filters_to_expression``, ``write_to_dataset`` and
``ParquetDataset`` join Parquet to ``dataset.py``; ``read_pandas`` reads a
Table and converts it (needs pandas). One departure, where the reference
raises: ``write_to_dataset`` takes pyarrow's ``metadata_collector`` (a
list that receives each written file's FileMetaData, its ``file_path``
relative to the root).
"""

from __future__ import annotations

from typing import List, Optional

from .reader import ParquetFile, _decode_stats

_PHYSICAL = {0: "BOOLEAN", 1: "INT32", 2: "INT64", 3: "INT96",
             4: "FLOAT", 5: "DOUBLE", 6: "BYTE_ARRAY",
             7: "FIXED_LEN_BYTE_ARRAY"}
_CODEC = {0: "UNCOMPRESSED", 1: "SNAPPY", 2: "GZIP", 3: "LZO",
          4: "BROTLI", 5: "LZ4", 6: "ZSTD", 7: "LZ4_RAW"}
_ENCODING = {0: "PLAIN", 2: "PLAIN_DICTIONARY", 3: "RLE", 4: "BIT_PACKED",
             5: "DELTA_BINARY_PACKED", 6: "DELTA_LENGTH_BYTE_ARRAY",
             7: "DELTA_BYTE_ARRAY", 8: "RLE_DICTIONARY",
             9: "BYTE_STREAM_SPLIT"}


class Statistics:
    """Column-chunk statistics (parquet/metadata.h Statistics)."""

    def __init__(self, pf: ParquetFile, col_idx: int, st: dict):
        cs = pf.columns[col_idx]
        self.physical_type = _PHYSICAL.get(cs.physical, "?")
        mn, mx, nulls = _decode_stats(cs, st)
        self.min = mn
        self.max = mx
        self.null_count = nulls
        self.distinct_count = st.get(4)
        self.has_min_max = mn is not None or mx is not None
        self.has_null_count = nulls is not None
        self.has_distinct_count = self.distinct_count is not None

    def to_dict(self) -> dict:
        return {"min": self.min, "max": self.max,
                "null_count": self.null_count,
                "distinct_count": self.distinct_count,
                "physical_type": self.physical_type}

    def __repr__(self):
        return (f"<Statistics min={self.min!r} max={self.max!r} "
                f"null_count={self.null_count}>")


class SortingColumn:
    """RowGroup sorting column (parquet.thrift SortingColumn)."""

    def __init__(self, column_index: int, descending: bool = False,
                 nulls_first: bool = False):
        self.column_index = column_index
        self.descending = descending
        self.nulls_first = nulls_first

    def __repr__(self):
        return (f"SortingColumn({self.column_index}, "
                f"descending={self.descending}, "
                f"nulls_first={self.nulls_first})")

    def __eq__(self, other):
        return (isinstance(other, SortingColumn)
                and (self.column_index, self.descending,
                     self.nulls_first) ==
                (other.column_index, other.descending, other.nulls_first))


class ColumnChunkMetaData:
    """parquet/metadata.h ColumnChunkMetaData view."""

    def __init__(self, pf: ParquetFile, chunk: dict, col_idx: int):
        self._pf = pf
        meta = chunk.get(3, {})
        self._meta = meta
        self._col_idx = col_idx
        self.file_offset = chunk.get(2, 0)
        self.file_path = (chunk.get(1) or b"").decode() or None
        self.physical_type = _PHYSICAL.get(meta.get(1), "?")
        self.num_values = meta.get(5, 0)
        self.path_in_schema = b".".join(meta.get(3, [])).decode()
        self.compression = _CODEC.get(meta.get(4), "?")
        self.encodings = tuple(_ENCODING.get(e, str(e))
                               for e in meta.get(2, []))
        self.total_uncompressed_size = meta.get(6, 0)
        self.total_compressed_size = meta.get(7, 0)
        self.data_page_offset = meta.get(9, 0)
        self.dictionary_page_offset = meta.get(11)
        self.is_stats_set = 12 in meta

    @property
    def statistics(self) -> Optional[Statistics]:
        st = self._meta.get(12)
        if st is None:
            return None
        return Statistics(self._pf, self._col_idx, st)

    def to_dict(self) -> dict:
        st = self.statistics
        return {"path_in_schema": self.path_in_schema,
                "physical_type": self.physical_type,
                "num_values": self.num_values,
                "compression": self.compression,
                "encodings": self.encodings,
                "total_compressed_size": self.total_compressed_size,
                "total_uncompressed_size": self.total_uncompressed_size,
                "statistics": st.to_dict() if st else None}

    def __repr__(self):
        return (f"<ColumnChunkMetaData path={self.path_in_schema!r} "
                f"type={self.physical_type} "
                f"compression={self.compression}>")


class RowGroupMetaData:
    """parquet/metadata.h RowGroupMetaData view."""

    def __init__(self, pf: ParquetFile, idx: int):
        self._pf = pf
        self._rg = pf.row_groups[idx]
        self.index = idx
        self.num_rows = self._rg.get(3, 0)
        self.total_byte_size = self._rg.get(2, 0)
        self.num_columns = len(self._rg.get(1, []))

    def column(self, i: int) -> ColumnChunkMetaData:
        return ColumnChunkMetaData(self._pf, self._rg.get(1, [])[i], i)

    @property
    def sorting_columns(self) -> List[SortingColumn]:
        return [SortingColumn(sc.get(1, 0), bool(sc.get(2, False)),
                              bool(sc.get(3, False)))
                for sc in self._rg.get(4, [])]

    def to_dict(self) -> dict:
        return {"num_rows": self.num_rows,
                "total_byte_size": self.total_byte_size,
                "columns": [self.column(i).to_dict()
                            for i in range(self.num_columns)]}

    def __repr__(self):
        return (f"<RowGroupMetaData num_rows={self.num_rows} "
                f"num_columns={self.num_columns}>")


class ParquetSchema:
    """Column-name view of the file schema (pyarrow ParquetSchema)."""

    def __init__(self, pf: ParquetFile):
        self._pf = pf
        self.names = [c.name for c in pf.columns]

    def column(self, i: int):
        return self._pf.columns[i]

    def to_arrow_schema(self):
        return self._pf.schema_arrow

    def __len__(self):
        return len(self.names)

    def __repr__(self):
        return "<ParquetSchema " + " ".join(self.names) + ">"


class FileMetaData:
    """parquet/metadata.h:106 FileMetaData view."""

    def __init__(self, pf: ParquetFile):
        self._pf = pf
        self.num_rows = pf.num_rows
        self.num_row_groups = pf.num_row_groups
        self.num_columns = len(pf.columns)
        self.created_by = pf.created_by
        self.format_version = {1: "1.0", 2: "2.6"}.get(pf.version,
                                                       str(pf.version))
        self.metadata = {k.encode(): v.encode()
                         for k, v in pf.key_value_metadata.items()} or None
        self.file_path = None

    def set_file_path(self, path: str) -> None:
        """The path, relative to a dataset's root, that a dataset's
        ``_metadata`` would give this file (pyarrow's
        FileMetaData.set_file_path)."""
        self.file_path = path

    @property
    def schema(self) -> ParquetSchema:
        return ParquetSchema(self._pf)

    def row_group(self, i: int) -> RowGroupMetaData:
        return RowGroupMetaData(self._pf, i)

    def to_dict(self) -> dict:
        return {"num_rows": self.num_rows,
                "num_row_groups": self.num_row_groups,
                "num_columns": self.num_columns,
                "created_by": self.created_by,
                "format_version": self.format_version,
                "row_groups": [self.row_group(i).to_dict()
                               for i in range(self.num_row_groups)]}

    def __repr__(self):
        return (f"<FileMetaData num_rows={self.num_rows} "
                f"row_groups={self.num_row_groups} "
                f"columns={self.num_columns} "
                f"created_by={self.created_by!r}>")


def read_metadata(source) -> FileMetaData:
    """pyarrow.parquet.read_metadata."""
    return FileMetaData(ParquetFile(source))


def read_schema(source):
    """pyarrow.parquet.read_schema -> arrow Schema."""
    return ParquetFile(source).schema_arrow


def read_pandas(source, columns=None, **kw):
    """pyarrow.parquet.read_pandas: ``read_table`` as a pandas DataFrame
    (needs pandas)."""
    from .reader import read_table
    return read_table(source, columns=columns, **kw).to_pandas()


def filters_to_expression(filters):
    """DNF filters -> acero Expression
    (pyarrow.parquet.filters_to_expression)."""
    from ...acero.expression import Expression, field

    def conj(andlist):
        expr = None
        for col, op, val in andlist:
            f = field(col)
            term = {"=": f.__eq__, "==": f.__eq__, "!=": f.__ne__,
                    "<": f.__lt__, "<=": f.__le__, ">": f.__gt__,
                    ">=": f.__ge__}.get(op)
            if term is not None:
                e = term(val)
            elif op == "in":
                e = Expression.call("is_in", f, value_set=list(val))
            elif op == "not in":
                e = Expression.call(
                    "invert",
                    Expression.call("is_in", f, value_set=list(val)))
            else:
                raise ValueError(f"unsupported filter op {op!r}")
            expr = e if expr is None else expr & e
        return expr

    if filters and isinstance(filters[0], tuple):
        return conj(filters)
    out = None
    for andlist in filters:
        e = conj(andlist)
        out = e if out is None else out | e
    return out


def write_to_dataset(table, root_path, partition_cols=None,
                     filesystem=None, metadata_collector=None,
                     **write_kwargs):
    """Partitioned parquet write (pyarrow.parquet.write_to_dataset);
    delegates to the dataset writer (dataset/dataset_writer.cc
    analogue). ``metadata_collector``, a list, receives each written
    file's FileMetaData with its path relative to ``root_path``."""
    import posixpath
    from ...dataset import write_dataset
    visitor = None
    if metadata_collector is not None:
        def visitor(written):
            written.metadata.set_file_path(
                posixpath.relpath(written.path, str(root_path)))
            metadata_collector.append(written.metadata)
    write_dataset(table, root_path, format="parquet",
                  partitioning=partition_cols,
                  partitioning_flavor="hive", filesystem=filesystem,
                  file_visitor=visitor, **write_kwargs)


class ParquetDataset:
    """Multi-file parquet dataset view (pyarrow.parquet.ParquetDataset)."""

    def __init__(self, path_or_paths, filesystem=None, filters=None,
                 partitioning="hive"):
        from ...dataset import HivePartitioning, dataset as _ds
        if partitioning == "hive":
            partitioning = HivePartitioning()
        self._dataset = _ds(path_or_paths, format="parquet",
                            filesystem=filesystem,
                            partitioning=partitioning)
        self._filters = filters

    @property
    def schema(self):
        return self._dataset.schema

    @property
    def files(self):
        return getattr(self._dataset, "files", None)

    def read(self, columns=None, device=None):
        """The dataset's rows under the filters, scanned on ``device``
        (the card unless ``device="cpu"``)."""
        expr = (filters_to_expression(self._filters)
                if self._filters else None)
        return self._dataset.to_table(columns=columns, filter=expr,
                                      device=device)

    def read_pandas(self, columns=None, device=None):
        return self.read(columns, device=device).to_pandas()
