"""The Feather formats (counterpart of ``arrow_tpu/feather.py``;
reference: ipc/feather.h). V2 is the Arrow IPC file format; V1 is the
legacy pre-IPC layout (``io/feather_v1.py``), found by its magic on read
and written with ``version=1``.

A path is read through a memory map, its Buffers slices of the map (a
departure for speed, with the same results), and ``read_table`` with
``columns`` loads only those columns.
"""

from __future__ import annotations

import os
from typing import Optional

from . import ipc
from .errors import ArrowInvalid as FeatherError
from .io_streams import Codec, memory_map  # noqa: F401
from .table import ChunkedArray, Table


def write_feather(table: Table, dest, compression: Optional[str] = None,
                  version: int = 2, chunksize: Optional[int] = None):
    """Write ``table`` as Feather V2 (an IPC file: ``compression`` 'lz4' or
    'zstd', batches of ``chunksize`` rows, one batch where None) or V1."""
    if version == 1:
        from .io.feather_v1 import write_feather_v1
        if compression is not None:
            raise ValueError("feather v1 does not support compression")
        write_feather_v1(table, dest)
        return
    close = isinstance(dest, (str, os.PathLike))
    if close:
        dest = open(dest, "wb")
    try:
        with ipc.new_file(dest, table.schema, codec=compression) as w:
            w.write_table(table, chunksize)
    finally:
        if close:
            dest.close()


def _source(source):
    if isinstance(source, (str, os.PathLike)):
        return memory_map(os.fspath(source))
    if isinstance(source, (bytes, bytearray, memoryview)) or \
            hasattr(source, "mapped"):
        return source
    return source.read()


def read_feather(source, columns=None) -> Table:
    from .io.feather_v1 import is_feather_v1, read_feather_v1
    src = _source(source)
    if is_feather_v1(src):
        t = read_feather_v1(src)
        return t.select(columns) if columns is not None else t
    return ipc.open_file(src).read_all(columns)


def read_table(source, columns=None, memory_map=False,
               use_threads=True) -> Table:
    return read_feather(source, columns)


class FeatherDataset:
    """Several Feather files read as one Table, their chunks end to end
    (python/pyarrow/feather.py FeatherDataset)."""

    def __init__(self, path_or_paths, validate_schema: bool = True):
        self.paths = list(path_or_paths)
        self.validate_schema = validate_schema

    def read_table(self, columns=None):
        tables = [read_table(p, columns=columns) for p in self.paths]
        if self.validate_schema:
            for t in tables[1:]:
                if not t.schema.equals(tables[0].schema):
                    raise FeatherError("schemas do not match")
        first = tables[0]
        return Table(first.schema, [ChunkedArray(
            [c for t in tables for c in t.columns[i].chunks], f.type)
            for i, f in enumerate(first.schema)])


def check_chunked_overflow(name, col):
    """Feather V1 cannot store a binary column over 2 GB (feather.py)."""
    if col.nbytes > (1 << 31) - 1:
        raise ValueError(f"Column '{name}' exceeds 2GB maximum capacity "
                         "of a Feather binary column")
