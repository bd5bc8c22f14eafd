"""Top-level helpers (counterpart of ``arrow_tpu/api.py``): the type alias
resolver the frontends need. The rest of the reference's ``api.py`` is not
ported (ROADMAP.md, queue 1, item 13.2); the file readers keep their own
``concat_tables`` and ``nulls`` (``io/host_arrays.py``)."""

from __future__ import annotations

from . import types as _T
from .types import DataType


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
