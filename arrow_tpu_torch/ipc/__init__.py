"""Arrow IPC, the stream and file formats (counterpart of
``arrow_tpu/ipc/``). ``read_tensor``/``write_tensor`` and
``serialize_pandas``/``deserialize_pandas`` are not ported yet (ROADMAP.md
item 13.2, part 2: interop) and raise NotImplementedError."""

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

_LATER = "ROADMAP.md item 13.2, part 2: interop"


def _not_ported(name):
    def call(*args, **kwargs):
        raise NotImplementedError(f"{name} is not ported yet ({_LATER})")
    call.__name__ = call.__qualname__ = name
    call.__doc__ = f"Not ported yet ({_LATER})."
    return call


read_tensor = _not_ported("read_tensor")
write_tensor = _not_ported("write_tensor")
get_tensor_size = _not_ported("get_tensor_size")
serialize_pandas = _not_ported("serialize_pandas")
deserialize_pandas = _not_ported("deserialize_pandas")


class Alignment:
    """The IPC buffer alignments (ipc/options.h: 8 by default, 64
    recommended)."""
    Any = 0
    At8Byte = 8
    At64Byte = 64
