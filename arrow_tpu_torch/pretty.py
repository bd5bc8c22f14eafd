"""Text renderings of Arrays and Tables (counterpart of ``arrow_tpu/pretty.py``;
reference: cpp/src/arrow/pretty_print.h), the reference's text."""

from __future__ import annotations

from typing import Union

from .array.array import Array
from .table import ChunkedArray, RecordBatch, Table


def _fmt(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, str):
        return f'"{v}"'
    if isinstance(v, float):
        return repr(v)
    return str(v)


def array_to_string(arr: Array, window: int = 10) -> str:
    vals = arr.to_pylist()
    if len(vals) > 2 * window:
        shown = ([_fmt(v) for v in vals[:window]] + ["..."]
                 + [_fmt(v) for v in vals[-window:]])
    else:
        shown = [_fmt(v) for v in vals]
    body = ",\n  ".join(shown)
    return f"[\n  {body}\n]"


def table_to_string(tbl: Union[Table, RecordBatch],
                    max_rows: int = 20) -> str:
    names = tbl.column_names
    pyd = tbl.to_pydict()
    n = tbl.num_rows
    rows_shown = min(n, max_rows)
    widths = {}
    cells = {}
    for nm in names:
        col = [_fmt(v) for v in pyd[nm][:rows_shown]]
        cells[nm] = col
        widths[nm] = max([len(nm)] + [len(c) for c in col])
    header = " | ".join(nm.ljust(widths[nm]) for nm in names)
    sep = "-+-".join("-" * widths[nm] for nm in names)
    lines = [header, sep]
    for i in range(rows_shown):
        lines.append(" | ".join(cells[nm][i].ljust(widths[nm])
                                for nm in names))
    if n > rows_shown:
        lines.append(f"... {n - rows_shown} more rows")
    return "\n".join(lines)


def pretty_print(obj, **kwargs) -> None:
    if isinstance(obj, (Table, RecordBatch)):
        print(table_to_string(obj, **kwargs))
    elif isinstance(obj, (Array,)):
        print(array_to_string(obj, **kwargs))
    elif isinstance(obj, ChunkedArray):
        print(array_to_string(obj.combine(), **kwargs))
    else:
        raise TypeError(f"cannot pretty-print {type(obj)}")
