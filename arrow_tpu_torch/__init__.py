"""arrow_tpu_torch: the columnar query engine of ``arrow_tpu`` on PyTorch and
an NVIDIA H100.

Columns live as padded tensors on the card with byte validity masks, plans
run eagerly as PyTorch operations, and the kernels that the TPU engine
wrote in Pallas are hand-written CUDA for Hopper (``csrc/``, bound with
``ctypes``). The package imports ``torch`` and ``numpy`` only.

Entry points run on the card: ``device=None`` means ``"cuda"``, and where
CUDA is absent they raise instead of running on the CPU. Pass
``device="cpu"`` to run the plain PyTorch versions of the kernels on the
CPU.

The host data model is Arrow's: ``array()`` and ``Array``, ``table()``,
``record_batch()``, ``Table``, ``RecordBatch`` and ``ChunkedArray`` hold
columns in host memory; a ``Table`` goes into a plan through
``acero.TableSourceNodeOptions`` or into ``compute``'s functions, and
results come back as host Tables and Arrays.

The top level holds the reference's names where the port has their
module: the type factories and classes, ``Buffer``, ``ArrayData``, the
builders, the memory pools, ``config``'s facts, ``api.py``'s helpers
(``concat_tables``, ``scalar``, ``nulls``, ...), ``Scalar``/``NA``,
``TableGroupBy``, ``ChunkResolver``, ``Datum`` and ``CacheOptions``.
``Table.join`` and ``join_asof`` are plans, on the card unless
``device="cpu"`` is given.

Files: ``ipc`` (the Arrow IPC stream and file formats), ``feather`` (V1
and V2), the streams and codecs of ``io_streams`` (``memory_map``,
``Codec``, LZ4 by the port's own host library), ``fs`` (the local, mock,
subtree and fsspec file systems, and REST clients of S3, GCS, Azure Blob
Storage and WebHDFS), ``io.parquet``, ``io.csv``, ``io.json`` and
``orc``, and ``dataset``'s datasets of these files, with
``write_dataset``.

Interop: the C data interface (``c_data``; ``Array.__arrow_c_array__``,
``__arrow_c_stream__`` of the containers, ``RecordBatchReader.from_stream``
of any producer's capsule), dlpack (``Array.__dlpack__``), the dataframe
interchange protocol (``interchange``, ``__dataframe__``), tensors
(``tensor``, ``Table.to_tensor``, ``ipc.write_tensor``), the extension
types (``extension``), pyarrow's per-type class names (``compat_names``),
``Device`` and the pandas methods (which need pandas; the card's machine
has none). Not yet ported (ROADMAP.md item 13.2, part 4): Flight.
"""

from __future__ import annotations

import torch


def default_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another. Raises RuntimeError for a CUDA device when CUDA is absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "run on the CPU")
    return dev


from .types import (  # noqa: E402,F401
    DataType, DictionaryType, DurationType, Field, FixedSizeBinaryType,
    FixedSizeListType, ListType, MapType, RunEndEncodedType, Schema,
    StructType, TimestampType, TypeId, UnionType,
    binary, binary_view, bool_, date32, date64, day_time_interval,
    decimal32, decimal64, decimal128, decimal256, dense_union, dictionary,
    duration, field, fixed_size_binary, fixed_size_list, float16, float32,
    float64, from_numpy_dtype, int8, int16, int32, int64, large_binary,
    large_list, large_list_view, large_string, large_utf8, list_, list_view,
    map_, month_day_nano_interval, month_interval, null, run_end_encoded,
    schema, sparse_union, string, string_view, struct, time32, time64,
    timestamp, uint8, uint16, uint32, uint64, utf8,
)
from .buffer import Buffer, allocate_buffer, as_buffer  # noqa: E402,F401
from .array.data import ArrayData  # noqa: E402,F401
from .array.array import Array, array  # noqa: E402,F401
from .array.builder import (  # noqa: E402,F401
    AdaptiveIntBuilder, ArrayBuilder, BinaryBuilder, BooleanBuilder,
    DictionaryBuilder, DoubleBuilder, FloatBuilder, Int8Builder,
    Int16Builder, Int32Builder, Int64Builder, ListBuilder, StringBuilder,
    StructBuilder, UInt8Builder, UInt16Builder, UInt32Builder,
    UInt64Builder, builder_for)
from .table import (  # noqa: E402,F401
    ChunkedArray, ChunkResolver, Datum, RecordBatch, RecordBatchReader,
    Table, TableGroupBy, chunked_array, record_batch, table,
)
from .memory import (  # noqa: E402,F401
    CappedMemoryPool, LoggingMemoryPool, MemoryPool, ProxyMemoryPool,
    default_memory_pool, device_memory_stats, log_memory_allocations,
    supported_memory_backends, system_memory_pool, total_allocated_bytes,
)
from .api import (  # noqa: E402,F401
    concat_arrays, concat_batches, concat_tables, deserialize_pandas,
    infer_type, nulls, repeat, scalar, serialize_pandas, show_info,
    show_versions, type_for_alias, unify_schemas,
)
from .errors import (  # noqa: E402,F401
    ArrowCancelled, ArrowCapacityError, ArrowException, ArrowIOError,
    ArrowIndexError, ArrowInvalid, ArrowKeyError, ArrowMemoryError,
    ArrowNotImplementedError, ArrowSerializationError, ArrowTypeError,
)
from .io_streams import (  # noqa: E402,F401
    BufferedInputStream, BufferedOutputStream, BufferOutputStream,
    BufferReader, Codec, CompressedInputStream, CompressedOutputStream,
    FixedSizeBufferWriter, MemoryMappedFile, MockOutputStream, NativeFile,
    OSFile, PythonFile, ResizableBuffer, TransformInputStream, compress,
    create_memory_map, decompress, foreign_buffer, input_stream,
    memory_map, output_stream, py_buffer, transcoding_input_stream,
)
from .compute.registry import Scalar  # noqa: E402,F401
from .config import (  # noqa: E402,F401
    BuildInfo, RuntimeInfo, build_info, runtime_info,
)
from .device import (  # noqa: E402,F401
    Device, DeviceAllocationType, MemoryManager, default_cpu_memory_manager,
)
from .extension import (  # noqa: E402,F401
    Bool8Type, ExtensionArray, ExtensionType, FixedShapeTensorArray,
    FixedShapeTensorType, JsonType, OpaqueType, UuidType,
    VariableShapeTensorType, bool8, fixed_shape_tensor, json_, opaque,
    register_extension_type, unregister_extension_type, uuid,
    variable_shape_tensor,
)
from .io.caching import CacheOptions  # noqa: E402,F401
from . import compute, config, ipc, memory  # noqa: E402,F401
from .tensor import (  # noqa: E402,F401
    SparseCOOTensor, SparseCSCMatrix, SparseCSFTensor, SparseCSRMatrix,
    Tensor,
)
from . import utils as util  # noqa: E402,F401
from .compat_names import *  # noqa: E402,F401,F403
from .ipc import (  # noqa: E402,F401
    Message, MessageReader, MetadataVersion, RecordBatchFileReader,
    RecordBatchFileWriter, RecordBatchStreamReader,
    RecordBatchStreamWriter,
)

NA = Scalar(None, null())
NULL = NA
lib = __import__("sys").modules[__name__]
CppBuildInfo = BuildInfo
VersionInfo = tuple
__version__ = "0.1.0"


def cpp_build_info() -> BuildInfo:
    return build_info()


def cpp_version() -> str:
    return build_info().version


def cpp_version_info():
    return tuple(int(x) for x in build_info().version.split(".")[:3])


def set_memory_pool(pool) -> None:
    memory._default_pool = pool


def logging_memory_pool(parent) -> LoggingMemoryPool:
    return LoggingMemoryPool(parent)


def proxy_memory_pool(parent) -> ProxyMemoryPool:
    return ProxyMemoryPool(parent)


def jemalloc_memory_pool():
    raise NotImplementedError("jemalloc backend not available (host memory "
                              "is numpy's, device memory PyTorch's caching "
                              "allocator; use system_memory_pool)")


def mimalloc_memory_pool():
    raise NotImplementedError("mimalloc backend not available (host memory "
                              "is numpy's, device memory PyTorch's caching "
                              "allocator; use system_memory_pool)")


# the sizes of the host thread pools (util/cpu_info.h, io/interfaces.h)
_cpu_count = [None]
_io_thread_count = [8]


def cpu_count() -> int:
    if _cpu_count[0] is None:
        _cpu_count[0] = __import__("os").cpu_count() or 1
    return _cpu_count[0]


def set_cpu_count(count: int) -> None:
    if count < 1:
        raise ValueError("cpu_count must be strictly positive")
    _cpu_count[0] = int(count)


def io_thread_count() -> int:
    return _io_thread_count[0]


def set_io_thread_count(count: int) -> None:
    if count < 1:
        raise ValueError("io_thread_count must be strictly positive")
    _io_thread_count[0] = int(count)


def __getattr__(name):
    """The frontends and the subpackages, imported when first named
    (reference: ``arrow_tpu/__init__.py`` ``__getattr__``)."""
    import importlib
    lazy = {"acero": ".acero", "c_data": ".c_data",
            "compare": ".compare", "compat_names": ".compat_names",
            "dataset": ".dataset", "device": ".device",
            "extension": ".extension", "feather": ".feather",
            "flight": ".flight", "fs": ".fs", "gandiva": ".gandiva",
            "interchange": ".interchange", "io": ".io", "orc": ".io.orc",
            "parallel": ".parallel", "pretty": ".pretty", "sql": ".sql",
            "substrait": ".substrait", "tensor": ".tensor"}
    if name in lazy:
        return importlib.import_module(lazy[name], __name__)
    raise AttributeError(name)
