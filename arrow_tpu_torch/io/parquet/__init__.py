"""Parquet (counterpart of ``arrow_tpu/io/parquet/``; reference:
cpp/src/parquet/): ``read_table``/``ParquetFile``, ``write_table``/
``ParquetWriter``, the metadata views, ``write_to_dataset``,
``ParquetDataset``, ``write_metadata`` and modular encryption. Importing it
needs neither libcrypto nor a compiler: the host library builds at the
first read or write, and libcrypto loads at the first encrypted one."""

from .reader import ParquetFile, read_table  # noqa: F401
from .writer import ParquetWriter, write_table  # noqa: F401
from .metadata import (  # noqa: F401
    ColumnChunkMetaData, FileMetaData, ParquetDataset, ParquetSchema,
    RowGroupMetaData, SortingColumn, Statistics, filters_to_expression,
    read_metadata, read_pandas, read_schema, write_to_dataset,
)
from .encryption import (  # noqa: F401
    FileDecryptionProperties, FileEncryptionProperties,
)
from .reader import ColumnSchema  # noqa: F401

# low-level reader alias (pyarrow.parquet.ParquetReader is the cython
# backing class of ParquetFile)
ParquetReader = ParquetFile


class ParquetLogicalType:
    """Logical type view (parquet/types.h LogicalType). Carries the
    string form used in metadata introspection."""

    def __init__(self, type_name: str = "NONE"):
        self.type = type_name

    def __repr__(self):
        return f"ParquetLogicalType({self.type})"

    def to_json(self):
        import json as _json
        return _json.dumps({"Type": self.type})


def write_metadata(schema, where, metadata_collector=None,
                   filesystem=None, **kwargs):
    """Write a metadata-only parquet file (_metadata/_common_metadata
    sidecars for write_to_dataset); parquet/arrow/writer.h
    WriteMetaDataFile analogue."""
    from ...table import Table
    empty = Table.from_batches([], schema)
    if filesystem is not None:
        with filesystem.open_output_stream(where) as f:
            write_table(empty, f, **kwargs)
    else:
        write_table(empty, where, **kwargs)
