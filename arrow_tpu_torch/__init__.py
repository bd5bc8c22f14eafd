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

Files: ``ipc`` (the Arrow IPC stream and file formats), ``feather`` (V1
and V2), the streams and codecs of ``io_streams`` (``memory_map``,
``Codec``, LZ4 by the port's own host library), ``fs`` (the local, mock
and subtree file systems), ``io.parquet``, ``io.csv``, ``io.json`` and
``orc``, and ``dataset``'s datasets of these files, with
``write_dataset``.
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


from .array.array import Array, array  # noqa: E402,F401
from .table import (ChunkedArray, RecordBatch, RecordBatchReader,  # noqa
                    Table, chunked_array, record_batch, table)
from .api import type_for_alias  # noqa: E402,F401
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
from . import ipc  # noqa: E402,F401
from .ipc import (  # noqa: E402,F401
    Message, MessageReader, MetadataVersion, RecordBatchFileReader,
    RecordBatchFileWriter, RecordBatchStreamReader,
    RecordBatchStreamWriter,
)


def __getattr__(name):
    """The frontends and the subpackages, imported when first named
    (reference: ``arrow_tpu/__init__.py`` ``__getattr__``)."""
    import importlib
    lazy = {"acero": ".acero", "compute": ".compute", "dataset": ".dataset",
            "feather": ".feather", "fs": ".fs", "gandiva": ".gandiva",
            "orc": ".io.orc", "sql": ".sql", "substrait": ".substrait"}
    if name in lazy:
        return importlib.import_module(lazy[name], __name__)
    raise AttributeError(name)
