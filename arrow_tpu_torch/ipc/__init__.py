"""Arrow IPC, the stream and file formats (counterpart of
``arrow_tpu/ipc/``), with the tensor messages (``tensor.py``) and the
pandas pair (which needs pandas)."""

from .reader_writer import (  # noqa: F401
    RecordBatchFileReader, RecordBatchFileWriter, RecordBatchStreamReader,
    RecordBatchStreamWriter, deserialize_table, new_file, new_stream,
    open_file, open_stream, serialize_table,
)
from .compat import (  # noqa: F401
    IpcReadOptions, IpcWriteOptions, Message, MessageReader,
    MetadataVersion, ReadStats, WriteStats, get_record_batch_size,
    read_message, read_record_batch, read_schema,
)
from ..table import RecordBatchReader  # noqa: F401,E402
from ..tensor import (  # noqa: F401,E402
    get_tensor_size, read_sparse_tensor, read_tensor, write_sparse_tensor,
    write_tensor,
)
from ..api import deserialize_pandas, serialize_pandas  # noqa: F401,E402


class Alignment:
    """The IPC buffer alignments (ipc/options.h: 8 by default, 64
    recommended)."""
    Any = 0
    At8Byte = 8
    At64Byte = 64
