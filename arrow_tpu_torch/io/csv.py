"""CSV reader and writer (counterpart of ``arrow_tpu/io/csv.py``; reference:
cpp/src/arrow/csv/, the chunked reader csv/reader.h:40: chunker -> parser
-> converters; the writer csv/writer.cc).

The host does the work, as in the reference: the port's own host library
(``csrc/csv_host.cpp``, bound in ``csv_host.py``) tokenizes and parses the
fields in bulk, numpy lays out the columns, and type inference follows the
reference's resolution order (csv/inference_internal.h): null, int64,
float64, bool, date32, timestamp, string.

A read takes one of the reference's three routes, chosen by the same tests
of its input and options: blocks split at newlines and converted on
threads (``_read_csv_parallel``: a threaded read of at least two blocks'
bytes without values holding newlines), one native pass over the whole
input (``_read_csv_native``), or Python's ``csv`` module (options the
tokenizer does not take: a delimiter, quote or escape that is not one
ASCII byte, a ``decimal_point`` other than "."). The host library is
required: where it cannot be built a read or a write raises
NotImplementedError, and no route is taken in its place.

A write gives the reference's bytes. The reference writes a Table of
int64, float64 and string columns by the native formatters, a Table of
other primitive columns by per-column Python strings, and any other row by
row through ``csv.writer``; the port takes the same routes, and writes the
last one's rows by column (dates in numpy, numbers by the native
formatters, the rest by ``_format_value``), byte for byte what
``csv.writer`` writes.
"""

from __future__ import annotations

import csv as _csv
import datetime
import io
from typing import Dict, List, Optional, Union

import numpy as np

from .. import types as T
from ..api import concat_tables
from ..array.array import Array, array as make_array
from ..array.construct import _make_validity
from ..array.data import ArrayData
from ..buffer import Buffer
from ..table import RecordBatch, Table
from ..types import DataType
from ..utils import bits as bitutil
from . import csv_host as nat
from .host_arrays import decoded, dictionary_encode, widened

DEFAULT_NULL_VALUES = ["", "#N/A", "#N/A N/A", "#NA", "-1.#IND",
                       "-1.#QNAN", "-NaN", "-nan", "1.#IND", "1.#QNAN",
                       "N/A", "NA", "NULL", "NaN", "n/a", "nan", "null"]
DEFAULT_TRUE = ["1", "True", "TRUE", "true"]
DEFAULT_FALSE = ["0", "False", "FALSE", "false"]
ISO8601 = "ISO8601"


class _OptionsBase:
    """The equals/validate surface of the options classes (pyarrow
    _csv.pyx)."""

    def equals(self, other) -> bool:
        return (type(self) is type(other) and
                self.__dict__ == other.__dict__)

    def validate(self) -> None:
        return None


class ReadOptions(_OptionsBase):
    def __init__(self, use_threads: bool = True, block_size: int = 1 << 20,
                 skip_rows: int = 0, column_names: Optional[List[str]] = None,
                 autogenerate_column_names: bool = False,
                 encoding: str = "utf8", skip_rows_after_names: int = 0):
        self.use_threads = use_threads
        self.block_size = block_size
        self.skip_rows = skip_rows
        self.column_names = column_names
        self.autogenerate_column_names = autogenerate_column_names
        self.encoding = encoding
        self.skip_rows_after_names = skip_rows_after_names


class ParseOptions(_OptionsBase):
    def __init__(self, delimiter: str = ",", quote_char: str = '"',
                 double_quote: bool = True, escape_char=False,
                 newlines_in_values: bool = False,
                 ignore_empty_lines: bool = True,
                 invalid_row_handler=None):
        self.delimiter = delimiter
        self.quote_char = quote_char
        self.double_quote = double_quote
        self.escape_char = escape_char
        self.newlines_in_values = newlines_in_values
        self.ignore_empty_lines = ignore_empty_lines
        self.invalid_row_handler = invalid_row_handler


class ConvertOptions(_OptionsBase):
    def __init__(self, check_utf8: bool = True,
                 column_types: Optional[Dict[str, DataType]] = None,
                 null_values: Optional[List[str]] = None,
                 true_values: Optional[List[str]] = None,
                 false_values: Optional[List[str]] = None,
                 strings_can_be_null: bool = False,
                 include_columns: Optional[List[str]] = None,
                 include_missing_columns: bool = False,
                 auto_dict_encode: bool = False,
                 auto_dict_max_cardinality: int = 50,
                 decimal_point: str = ".",
                 default_column_type=None,
                 quoted_strings_can_be_null: bool = True,
                 timestamp_parsers=None):
        self.check_utf8 = check_utf8
        self.column_types = column_types or {}
        self.null_values = (null_values if null_values is not None
                            else list(DEFAULT_NULL_VALUES))
        self.true_values = true_values or list(DEFAULT_TRUE)
        self.false_values = false_values or list(DEFAULT_FALSE)
        self.strings_can_be_null = strings_can_be_null
        self.include_columns = include_columns
        self.include_missing_columns = include_missing_columns
        self.auto_dict_encode = auto_dict_encode
        self.auto_dict_max_cardinality = auto_dict_max_cardinality
        self.decimal_point = decimal_point
        self.default_column_type = default_column_type
        self.quoted_strings_can_be_null = quoted_strings_can_be_null
        self.timestamp_parsers = timestamp_parsers


class WriteOptions(_OptionsBase):
    def __init__(self, include_header: bool = True,
                 batch_size: int = 1024, delimiter: str = ",",
                 quoting_style: str = "needed",
                 quoting_header: str = "needed"):
        self.include_header = include_header
        self.batch_size = batch_size
        self.delimiter = delimiter
        self.quoting_style = quoting_style
        self.quoting_header = quoting_header


class InvalidRow:
    """What ParseOptions.invalid_row_handler is given (csv/options.h
    InvalidRow): a row whose column count is not the header's."""

    __slots__ = ("expected_columns", "actual_columns", "number", "text")

    def __init__(self, expected_columns, actual_columns, number, text):
        self.expected_columns = expected_columns
        self.actual_columns = actual_columns
        self.number = number
        self.text = text

    def __repr__(self):
        return (f"InvalidRow(expected={self.expected_columns}, "
                f"actual={self.actual_columns}, number={self.number})")


def _open_text(source, encoding):
    if isinstance(source, str):
        return open(source, "r", encoding=encoding, newline="")
    if isinstance(source, bytes):
        return io.StringIO(source.decode(encoding))
    if hasattr(source, "read"):
        data = source.read()
        if isinstance(data, bytes):
            data = data.decode(encoding)
        return io.StringIO(data)
    raise TypeError(f"cannot read CSV from {type(source)}")


# --- the Python route's conversions ------------------------------------------

def _try_parse(vals: np.ndarray, nulls: np.ndarray, dtype):
    try:
        return np.where(nulls, "0", vals).astype(dtype)
    except ValueError:
        return None


def _convert_column(strs: List[Optional[str]], opts: ConvertOptions,
                    explicit: Optional[DataType]) -> Array:
    """One column of Python strings (None: a missing field) as an Array."""
    n = len(strs)
    null_set = set(opts.null_values)
    raw = np.array([s if s is not None else "" for s in strs], dtype=object)
    nulls = np.array([(s is None) or (s in null_set) for s in strs],
                     dtype=np.bool_)

    def with_nulls(values, t):
        return make_array([None if m else v
                           for m, v in zip(nulls, values)], t)

    def strings(t):
        can_null = opts.strings_can_be_null
        return make_array([None if (s is None or (can_null and
                                                  s in null_set))
                           else s for s in strs], t)

    if explicit is not None:
        t = explicit
        if t.id == T.TypeId.STRING:
            return strings(t)
        if t.id == T.TypeId.BOOL:
            tv = set(opts.true_values)
            return with_nulls([v in tv for v in raw], t)
        if t.is_integer or t.is_floating:
            sv = raw.astype(str)
            if t.is_floating and opts.decimal_point != ".":
                sv = np.char.replace(sv, opts.decimal_point, ".")
            vals = np.where(nulls, "0", sv).astype(t.to_numpy_dtype())
            return with_nulls(vals.tolist(), t)
        if t.id == T.TypeId.DATE32:
            return with_nulls([_parse_date(v) if not m else None
                               for v, m in zip(raw, nulls)], t)
        if t.id == T.TypeId.TIMESTAMP:
            return with_nulls([_parse_ts(v, opts.timestamp_parsers)
                               if not m else None
                               for v, m in zip(raw, nulls)], t)
        raise NotImplementedError(f"CSV conversion to {t!r}")

    if opts.default_column_type is not None:
        return _convert_column(strs, _replace_default(opts),
                               opts.default_column_type)

    # inference, in the reference's order
    if nulls.all():
        return make_array([None] * n, T.null())
    svals = raw.astype(str)
    if opts.decimal_point != ".":
        svals = np.char.replace(svals, opts.decimal_point, ".")
    out = _try_parse(svals, nulls, np.int64)
    if out is not None:
        return with_nulls(out.tolist(), T.int64())
    out = _try_parse(svals, nulls, np.float64)
    if out is not None:
        return with_nulls(out.tolist(), T.float64())
    tv, fv = set(DEFAULT_TRUE), set(DEFAULT_FALSE)
    if all(nulls[i] or svals[i] in tv or svals[i] in fv for i in range(n)):
        return with_nulls([v in tv for v in svals], T.bool_())
    for parse, t in ((_parse_date, T.date32()), (_parse_ts, T.timestamp("s"))):
        try:
            return with_nulls([parse(v) if not m else None
                               for v, m in zip(svals, nulls)], t)
        except Exception:  # noqa: BLE001 - not this type: the next
            pass
    out = strings(T.string())
    if opts.auto_dict_encode:
        distinct = {s for s in strs if s is not None}
        if len(distinct) <= opts.auto_dict_max_cardinality:
            return dictionary_encode(out)
    return out


def _replace_default(opts: ConvertOptions) -> ConvertOptions:
    import copy
    o = copy.copy(opts)
    o.default_column_type = None
    return o


def _micros_to_unit(us: np.ndarray, unit: str) -> np.ndarray:
    """Epoch microseconds in a timestamp unit, by floor division; an
    int64 nanosecond past ~2262 raises OverflowError, as the Python
    parse does."""
    if unit == "ns":
        lim = np.iinfo(np.int64).max // 1000
        if us.size and (us.max() > lim or us.min() < -lim):
            raise OverflowError(
                "timestamp out of range for nanosecond unit")
        return us * 1000
    scale = {"s": 1_000_000, "ms": 1000, "us": 1}[unit]
    return us // scale if scale != 1 else us


def _parse_date(v):
    return datetime.date.fromisoformat(v)


def _parse_ts(v, parsers=None):
    if parsers:
        for fmt in parsers:
            if fmt == ISO8601:
                try:
                    return datetime.datetime.fromisoformat(v)
                except ValueError:
                    continue
            try:
                return datetime.datetime.strptime(v, fmt)
            except ValueError:
                continue
        raise ValueError(f"no timestamp parser matched {v!r}")
    return datetime.datetime.fromisoformat(v)


# --- the native routes --------------------------------------------------------

def _read_source_bytes(source, encoding) -> Optional[bytes]:
    """The whole input as UTF-8 bytes for the tokenizer; None where it can
    only be read as text."""
    enc = encoding.lower().replace("-", "").replace("_", "")
    data = None
    if isinstance(source, str):
        with open(source, "rb") as f:
            data = f.read()
    elif isinstance(source, bytes):
        data = source
    elif hasattr(source, "read"):
        data = source.read()
        if isinstance(data, str):
            data = data.encode("utf8")
            enc = "utf8"
    if data is None:
        return None
    if enc in ("utf8", "ascii", "usascii"):
        return data
    try:
        return data.decode(encoding).encode("utf8")
    except (UnicodeDecodeError, LookupError):
        return None


def _single_ascii(c) -> bool:
    return isinstance(c, str) and len(c) == 1 and ord(c) < 128


def _row_field_strings(block, row_start: int, count: int) -> List[str]:
    return [block.field_bytes(row_start + j).decode("utf8")
            for j in range(count)]


def _gathered_str_list(block, ids, nulls) -> List[Optional[str]]:
    """Python strings of the fields (None at nulls), for the conversions
    the bulk parsers leave to Python."""
    offs, data = nat.csv_gather_bytes(block, ids, skip=nulls)
    raw = bytes(data)
    return [None if nulls[i] else raw[offs[i]:offs[i + 1]].decode("utf8")
            for i in range(len(ids))]


def _native_convert_column(block, ids, missing, co: ConvertOptions,
                           explicit: Optional[DataType]):
    """One tokenized column as an Array (csv/converter.cc): ``ids`` the
    field of each row, ``missing`` the rows too short to hold the column.
    None where a string column's bytes pass int32 offsets (the caller
    takes the Python route, as the reference does)."""
    n = len(ids)

    def match_nulls(sub_ids):
        """The null tokens among fields ``sub_ids`` (converter.cc
        IsNull)."""
        m = nat.csv_match_tokens(block, sub_ids, co.null_values).astype(
            np.bool_)
        if not co.quoted_strings_can_be_null:
            m &= block.quoted[sub_ids] == 0
        return m

    valid = None   # set before prim/boolean run

    def prim(t, values, validity=None):
        dt = t.to_numpy_dtype()
        if values.dtype != dt:
            values = values.astype(dt)
        v = valid if validity is None else validity
        return Array(ArrayData(t, n, [_make_validity(v), Buffer(values)]))

    def boolean(values):
        return Array(ArrayData(
            T.bool_(), n, [_make_validity(valid),
                           Buffer(bitutil.pack_bits(values & valid))]))

    def string(t, str_nulls):
        offs, data = nat.csv_gather_bytes(block, ids, skip=str_nulls)
        if offs[-1] > np.iinfo(np.int32).max:
            return None
        return Array(ArrayData(
            t, n, [_make_validity(~str_nulls), Buffer(offs.astype(np.int32)),
                   Buffer(data)]))

    if explicit is not None:
        nulls = match_nulls(ids) | missing
        valid = ~nulls
        t = explicit
        if t.id == T.TypeId.NA:
            if not nulls.all():
                raise ValueError("CSV conversion to null: non-null value")
            return make_array([None] * n, T.null())
        if t.id == T.TypeId.STRING:
            return string(t, nulls if co.strings_can_be_null
                          else missing.copy())
        if t.id == T.TypeId.BOOL:
            tv = nat.csv_match_tokens(block, ids, co.true_values)
            return boolean(tv.astype(np.bool_))
        if t.is_integer or t.is_floating:
            parse = nat.csv_parse_int64 if t.is_integer else \
                nat.csv_parse_float64
            r = parse(block, ids, nulls)
            if r is None:
                raise ValueError(f"CSV conversion to {t!r} failed")
            return prim(t, r[0])
        if t.id == T.TypeId.DATE32:
            d = nat.csv_parse_date32(block, ids, nulls)
            if d is not None:
                return prim(t, d)
            return _convert_column(_gathered_str_list(block, ids, nulls),
                                   co, t)
        if t.id == T.TypeId.TIMESTAMP and not co.timestamp_parsers:
            us = nat.csv_parse_ts_micros(block, ids, nulls)
            if us is not None:
                return prim(t, _micros_to_unit(us, t.unit))
            return _convert_column(_gathered_str_list(block, ids, nulls),
                                   co, t)
        if t.id == T.TypeId.TIMESTAMP:
            return _convert_column(_gathered_str_list(block, ids, nulls),
                                   co, t)
        if t.id == T.TypeId.DICTIONARY and \
                t.value_type.id == T.TypeId.STRING:
            s = string(t.value_type, nulls if co.strings_can_be_null
                       else missing.copy())
            return None if s is None else dictionary_encode(s)
        raise NotImplementedError(f"CSV conversion to {t!r}")

    if co.default_column_type is not None:
        return _native_convert_column(block, ids, missing,
                                      _replace_default(co),
                                      co.default_column_type)

    # inference in the reference's order (csv/inference_internal.h),
    # parse first: a numeric type is probed on 64 fields, then parsed with
    # no null prescan, its failures held against the null tokens after
    live = np.flatnonzero(~missing)
    if len(live) == 0:
        return make_array([None] * n, T.null())
    pb_ids = ids[live[:64]]
    pb_m = match_nulls(pb_ids)
    pb_skip = pb_m.astype(np.uint8)
    nulls = valid = None
    if pb_m.all():
        nm = match_nulls(ids)
        nulls, valid = nm | missing, ~(nm | missing)
        if nulls.all():
            return make_array([None] * n, T.null())
    miss8 = missing.astype(np.uint8)

    def parse_first(parse, t):
        if parse(block, pb_ids, pb_skip) is None:
            return None
        vals, ok, fails = parse(block, ids, miss8, strict=False)
        okb = ok.astype(np.bool_)
        if fails:
            bad = np.flatnonzero(~okb & ~missing)
            if not match_nulls(ids[bad]).all():
                return None          # a real failure: not this type
        validity = okb & ~missing
        if t.id == T.TypeId.DOUBLE:
            # a null token that parses ("nan", "NaN") stays null
            nan_idx = np.flatnonzero(np.isnan(vals) & validity)
            if len(nan_idx):
                nanm = match_nulls(ids[nan_idx])
                if nanm.any():
                    validity[nan_idx[nanm]] = False
        return prim(t, vals, validity)

    out = parse_first(nat.csv_parse_int64, T.int64())
    if out is not None:
        return out
    out = parse_first(nat.csv_parse_float64, T.float64())
    if out is not None:
        return out
    # the other types need the whole null mask
    if nulls is None:
        nm = match_nulls(ids)
        nulls, valid = nm | missing, ~(nm | missing)
        if nulls.all():
            return make_array([None] * n, T.null())
    pb_live = pb_ids[~pb_m]
    pb_zeros = np.zeros(len(pb_live), dtype=np.uint8)

    def full_if(parse, *tokens):
        return (parse(block, ids, nulls, *tokens)
                if parse(block, pb_live, pb_zeros, *tokens) is not None
                else None)

    bv = full_if(nat.csv_parse_bool, DEFAULT_TRUE, DEFAULT_FALSE)
    if bv is not None:
        return boolean(bv.astype(np.bool_))
    # dates and timestamps by the bulk ISO parse (value_parsing.h); an
    # abort goes on to the Python probe, so other valid ISO forms still
    # infer
    d = full_if(nat.csv_parse_date32)
    if d is not None:
        return prim(T.date32(), d)
    us = full_if(nat.csv_parse_ts_micros)
    if us is not None:
        return prim(T.timestamp("s"), _micros_to_unit(us, "s"))
    # probe the first non-null value before the Python conversion
    first = int(np.argmax(valid))
    probe = block.field_bytes(int(ids[first])).decode("utf8", "replace")
    for parser, t in ((_parse_date, T.date32()),
                      (_parse_ts, T.timestamp("s"))):
        try:
            parser(probe)
        except Exception:  # noqa: BLE001 - not this type
            continue
        try:
            return _convert_column(_gathered_str_list(block, ids, nulls),
                                   co, t)
        except Exception:  # noqa: BLE001 - not this type
            continue
    out = string(T.string(), nulls if co.strings_can_be_null
                 else missing.copy())
    if out is not None and co.auto_dict_encode:
        enc = dictionary_encode(out)
        if len(enc.dictionary) <= co.auto_dict_max_cardinality:
            return enc
    return out


def _tokenize_and_layout(source, ro: ReadOptions, po: ParseOptions,
                         co: ConvertOptions):
    """Tokenize the whole input and settle the header and the rows: (block,
    names, field counts and first field ids of the data rows), or None
    where the options need the Python route."""
    nat.library()   # required: raises where it cannot be built
    if not _single_ascii(po.delimiter):
        return None
    qc = po.quote_char if po.quote_char not in (False, None) else None
    if qc is not None and not _single_ascii(qc):
        return None
    esc = po.escape_char if isinstance(po.escape_char, str) else None
    if esc is not None and not _single_ascii(esc):
        return None
    if co.decimal_point != ".":
        return None
    data = _read_source_bytes(source, ro.encoding)
    if data is None:
        return None
    if ro.use_threads and not po.newlines_in_values:
        block = nat.csv_parse_parallel(data, po.delimiter, qc,
                                       po.double_quote, esc)
    else:
        block = nat.csv_parse(data, po.delimiter, qc, po.double_quote, esc)

    rc = block.row_counts
    row_starts = np.zeros(len(rc), np.int64)
    if len(rc) > 1:
        np.cumsum(rc[:-1], out=row_starts[1:])
    pos = ro.skip_rows
    if ro.column_names is not None:
        names = list(ro.column_names)
    elif ro.autogenerate_column_names:
        if pos >= len(rc):
            return block, [], rc[:0], row_starts[:0]
        names = [f"f{i}" for i in range(int(rc[pos]))]
    else:
        if pos >= len(rc):
            return block, [], rc[:0], row_starts[:0]
        names = _row_field_strings(block, int(row_starts[pos]),
                                   int(rc[pos]))
        pos += 1
    pos = min(pos + ro.skip_rows_after_names, len(rc))

    rc_d = rc[pos:]
    starts_d = row_starts[pos:]
    sel = np.ones(len(rc_d), np.bool_)
    if po.ignore_empty_lines:
        sel &= rc_d != 0
    ncols = len(names)
    if po.invalid_row_handler is not None:
        for i in np.nonzero(sel & (rc_d != ncols))[0]:
            row_text = ",".join(_row_field_strings(
                block, int(starts_d[i]), int(rc_d[i])))
            decision = po.invalid_row_handler(InvalidRow(
                ncols, int(rc_d[i]), int(i), row_text))
            if decision == "skip":
                sel[i] = False
            elif decision == "error":
                from ..errors import ArrowInvalid
                raise ArrowInvalid(
                    f"CSV row {int(i)}: expected {ncols} columns, "
                    f"got {int(rc_d[i])}")
    return block, names, rc_d[sel], starts_d[sel]


def _ordered(arrays, out_names, co):
    if co.include_columns:
        order = [nm for nm in co.include_columns if nm in out_names]
        arrays = [arrays[out_names.index(nm)] for nm in order]
        out_names = order
    return Table.from_arrays(arrays, out_names)


def _convert_rows_native(block, names, rc_d, starts_d, ro, co,
                         column_types) -> Optional[Table]:
    """A range of tokenized rows as a Table; None where a column needs the
    Python route."""
    # one sequential transpose into per-column spans, identity ids after
    col_blocks = nat.csv_transpose_columns(block, starts_d, rc_d, len(names))
    ids_all = np.arange(len(rc_d), dtype=np.int64)
    jobs = []
    for j, name in enumerate(names):
        if co.include_columns is not None and \
                name not in co.include_columns:
            continue
        jobs.append((name, col_blocks[j], rc_d <= j))

    def convert(job):
        name, blk, missing = job
        return _native_convert_column(blk, ids_all, missing, co,
                                      column_types.get(name))

    # the bulk work releases Python's lock, so threads a column pay once
    # the numpy glue is small beside it (the reference measured a 400k-row
    # file 25% faster on one thread)
    if ro.use_threads and len(jobs) > 1 and len(rc_d) > 2_000_000:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=min(8, len(jobs))) as ex:
            results = list(ex.map(convert, jobs))
    else:
        results = [convert(job) for job in jobs]
    if any(arr is None for arr in results):
        return None
    return _ordered(results, [job[0] for job in jobs], co)


def _read_csv_native(source, ro: ReadOptions, po: ParseOptions,
                     co: ConvertOptions) -> Optional[Table]:
    """The one-pass native route; None where the Python route reads."""
    layout = _tokenize_and_layout(source, ro, po, co)
    if layout is None:
        return None
    block, names, rc_d, starts_d = layout
    if not names:
        return Table.from_arrays([], [])
    return _convert_rows_native(block, names, rc_d, starts_d, ro, co,
                                co.column_types)


class _NativeStreamer:
    """Blocks of one tokenized input: the first infers the types, the
    later ones convert to them (csv/reader.h:65 StreamingReader)."""

    def __init__(self, block, names, rc_d, starts_d, ro, co):
        self._block = block
        self._names = names
        self._rc = rc_d
        self._starts = starts_d
        self._ro = ro
        self._co = co
        n = len(rc_d)
        # a row's bytes as the Python route counts them: its fields'
        # bytes and a separator a field
        sc = block.id_scale
        first_off = starts_d * sc
        last_off = np.maximum((starts_d + rc_d) * sc - (sc - 1), first_off)
        sizes = np.maximum(
            block.offsets[last_off] - block.offsets[first_off], 0) + rc_d
        cum = np.cumsum(sizes)
        cuts = [0]
        target = max(int(ro.block_size), 1)
        while cuts[-1] < n:
            base = int(cum[cuts[-1] - 1]) if cuts[-1] else 0
            nxt = int(np.searchsorted(cum, base + target, side="left")) + 1
            cuts.append(min(max(nxt, cuts[-1] + 1), n))
        self._cuts = cuts
        self._next = 1
        self._types = dict(co.column_types)
        self._first = self._convert(0) if n else None
        self.schema = (self._first.schema if self._first is not None
                       else T.Schema([]))
        if self._first is not None:
            self._types = {f.name: f.type for f in self._first.schema}

    def _convert(self, k):
        a, b = self._cuts[k], self._cuts[k + 1]
        table = _convert_rows_native(
            self._block, self._names, self._rc[a:b], self._starts[a:b],
            self._ro, self._co, self._types)
        if table is None:
            raise ValueError("CSV native block conversion failed")
        batches = table.to_batches()
        return batches[0] if batches else None

    def read_next_batch(self):
        if self._first is not None:
            out, self._first = self._first, None
            return out
        if self._next >= len(self._cuts) - 1:
            raise StopIteration
        k = self._next
        self._next += 1
        out = self._convert(k)
        if out is None:
            raise StopIteration
        return out


def _open_csv_native(source, ro, po, co) -> Optional[_NativeStreamer]:
    layout = _tokenize_and_layout(source, ro, po, co)
    if layout is None:
        return None
    block, names, rc_d, starts_d = layout
    if not names:
        return None
    try:
        return _NativeStreamer(block, names, rc_d, starts_d, ro, co)
    except ValueError:
        return None


def _parallel_block_bytes() -> int:
    """The parallel route's block size: ``ARROW_TPU_CSV_BLOCK_BYTES``, 1 MB
    by default (csv/options.h block_size's default too)."""
    import os
    try:
        return int(os.environ.get("ARROW_TPU_CSV_BLOCK_BYTES",
                                  str(1 << 20)))
    except ValueError:
        return 1 << 20


def _read_csv_parallel(source, ro: ReadOptions, po: ParseOptions,
                       co: ConvertOptions) -> Optional[Table]:
    """Blocks split at newlines, each tokenized and converted on a thread
    (the native calls release Python's lock), as ONE chunked Table, a
    chunk a block (csv/reader.h:65 with the parallel chunker). The blocks'
    inferred types unify by null -> any and int64 -> float64; any other
    disagreement gives None, and the whole-input route infers. None where
    the route does not apply."""
    if not ro.use_threads or po.newlines_in_values or \
            po.invalid_row_handler is not None:
        return None
    if not _single_ascii(po.delimiter):
        return None
    qc = po.quote_char if po.quote_char not in (False, None) else None
    if (qc is not None and not _single_ascii(qc)) or \
            co.decimal_point != ".":
        return None
    esc = po.escape_char if isinstance(po.escape_char, str) else None
    if esc is not None and not _single_ascii(esc):
        return None
    data = _read_source_bytes(source, ro.encoding)
    blk = _parallel_block_bytes()
    if data is None or len(data) < 2 * blk:
        return None

    # the header rows, on the raw bytes
    def next_line(p):
        i = data.find(b"\n", p)
        return len(data) if i < 0 else i + 1

    pos = 0
    for _ in range(ro.skip_rows):
        pos = next_line(pos)

    def parse_one_line(p):
        eol = data.find(b"\n", p)
        line = data[p:(eol if eol >= 0 else len(data))]
        if line.endswith(b"\r"):
            line = line[:-1]
        r = _csv.reader(io.StringIO(line.decode("utf-8", "replace")),
                        delimiter=po.delimiter, quotechar=(qc or '"'),
                        doublequote=po.double_quote, escapechar=esc)
        return next(r, [])

    if ro.column_names is not None:
        names = list(ro.column_names)
    elif ro.autogenerate_column_names:
        names = [f"f{i}" for i in range(len(parse_one_line(pos)))]
    else:
        names = [str(v) for v in parse_one_line(pos)]
        pos = next_line(pos)
    for _ in range(ro.skip_rows_after_names):
        pos = next_line(pos)
    if pos >= len(data) or not names:
        return None

    # the body's blocks, cut at newlines
    n = len(data)
    nchunks = max(1, min(32, (n - pos) // blk))
    if nchunks <= 1:
        return None
    bounds = [pos]
    for k in range(1, nchunks):
        target = pos + (n - pos) * k // nchunks
        cut = data.find(b"\n", max(target, bounds[-1]))
        if cut < 0:
            break
        if cut + 1 > bounds[-1]:
            bounds.append(cut + 1)
    bounds.append(n)
    views = [memoryview(data)[a:b] for a, b in zip(bounds, bounds[1:])
             if b > a]
    if len(views) <= 1:
        return None

    ro_blk = ReadOptions(use_threads=False, encoding=ro.encoding)

    def work(view):
        block = nat.csv_parse(view, po.delimiter, qc, po.double_quote, esc)
        rc = block.row_counts
        starts = np.zeros(len(rc), np.int64)
        if len(rc) > 1:
            np.cumsum(rc[:-1], out=starts[1:])
        sel = np.ones(len(rc), np.bool_)
        if po.ignore_empty_lines:
            sel &= rc != 0
        return _convert_rows_native(block, names, rc[sel], starts[sel],
                                    ro_blk, co, co.column_types)

    import os
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=min(len(views),
                                            os.cpu_count() or 4)) as ex:
        tables = list(ex.map(work, views))
    if any(t is None for t in tables):
        return None

    # the blocks' types unified
    out_names = tables[0].schema.names
    want = []
    for ci in range(len(out_names)):
        ts = [t.schema.fields[ci].type for t in tables]
        if len({repr(t) for t in ts}) == 1:
            want.append(ts[0])
            continue
        non_null = [t for t in ts if t.id != T.TypeId.NA]
        nn_set = {repr(t) for t in non_null}
        if len(nn_set) == 1:
            want.append(non_null[0])
        elif nn_set <= {repr(T.int64()), repr(T.float64())}:
            want.append(T.float64())
        else:
            return None  # the types disagree: the whole-input route infers
    casted = []
    for t in tables:
        cols, changed = [], False
        for ci in range(len(out_names)):
            col = t.column(ci)
            if repr(t.schema.fields[ci].type) != repr(want[ci]):
                col = widened(col.combine(), want[ci])
                changed = True
            cols.append(col)
        casted.append(Table.from_arrays([c if isinstance(c, Array)
                                         else c.combine() for c in cols],
                                        out_names) if changed else t)
    return concat_tables(casted)


def _chain_one(first, rest):
    yield first
    yield from rest


def _python_rows(f, ro, po):
    """(the column names, the data rows) of text ``f`` by Python's csv
    module."""
    rows = iter(_csv.reader(
        f, delimiter=po.delimiter, quotechar=po.quote_char,
        doublequote=po.double_quote,
        escapechar=(po.escape_char if isinstance(po.escape_char, str)
                    else None)))
    for _ in range(ro.skip_rows):
        next(rows, None)
    if ro.column_names is not None:
        names = list(ro.column_names)
    elif ro.autogenerate_column_names:
        first = next(rows)
        names = [f"f{i}" for i in range(len(first))]
        rows = _chain_one(first, rows)
    else:
        names = next(rows)
    for _ in range(ro.skip_rows_after_names):
        next(rows, None)
    return names, rows


def read_csv(source, read_options: Optional[ReadOptions] = None,
             parse_options: Optional[ParseOptions] = None,
             convert_options: Optional[ConvertOptions] = None) -> Table:
    ro = read_options or ReadOptions()
    po = parse_options or ParseOptions()
    co = convert_options or ConvertOptions()
    nat.library()   # required: raises where it cannot be built

    # a byte stream is read once, so a route that declines after looking
    # leaves the next route the whole input (a text stream is read once,
    # by the route that takes it)
    if hasattr(source, "read") and not isinstance(source, (str, bytes)):
        peek = source.read(0)
        if isinstance(peek, bytes):
            source = source.read()

    try:
        out = _read_csv_parallel(source, ro, po, co)
    except (NotImplementedError, MemoryError):
        raise
    except Exception:  # noqa: BLE001 - the next route decides, as the
        out = None     # reference's does
    if out is not None:
        return out

    out = _read_csv_native(source, ro, po, co)
    if out is not None:
        return out

    names, rows = _python_rows(_open_text(source, ro.encoding), ro, po)
    cols: List[List[Optional[str]]] = [[] for _ in names]
    for rownum, row in enumerate(rows):
        if not row and po.ignore_empty_lines:
            continue
        if len(row) != len(names) and po.invalid_row_handler is not None:
            decision = po.invalid_row_handler(InvalidRow(
                len(names), len(row), rownum, ",".join(row)))
            if decision == "skip":
                continue
            if decision == "error":
                from ..errors import ArrowInvalid
                raise ArrowInvalid(
                    f"CSV row {rownum}: expected {len(names)} columns, "
                    f"got {len(row)}")
        for i in range(len(names)):
            cols[i].append(row[i] if i < len(row) else None)

    arrays, out_names = [], []
    for name, col in zip(names, cols):
        if co.include_columns is not None and \
                name not in co.include_columns:
            continue
        arrays.append(_convert_column(col, co, co.column_types.get(name)))
        out_names.append(name)
    return _ordered(arrays, out_names, co)


class CSVStreamingReader:
    """Reads a CSV input block by block (csv/reader.h:65 StreamingReader):
    the first block infers the schema, the later ones convert to its
    types. Blocks end at row boundaries."""

    def __init__(self, source, read_options=None, parse_options=None,
                 convert_options=None):
        self._ro = read_options or ReadOptions()
        self._po = parse_options or ParseOptions()
        self._co = convert_options or ConvertOptions()
        self._native = _open_csv_native(source, self._ro, self._po,
                                        self._co)
        if self._native is not None:
            self.schema = self._native.schema
            return
        self._names, self._rows = _python_rows(
            _open_text(source, self._ro.encoding), self._ro, self._po)
        self._first = self._read_block(first=True)
        self.schema = (self._first.schema if self._first is not None
                       else T.Schema([]))

    def _read_block(self, first=False):
        target = self._ro.block_size
        cols = [[] for _ in self._names]
        nbytes = nrows = 0
        for row in self._rows:
            if not row and self._po.ignore_empty_lines:
                continue
            for i in range(len(self._names)):
                cols[i].append(row[i] if i < len(row) else None)
            nbytes += sum(len(v) for v in row) + len(row)
            nrows += 1
            if nbytes >= target:
                break
        if nrows == 0:
            return None
        arrays, out_names = [], []
        for name, col in zip(self._names, cols):
            if self._co.include_columns is not None and \
                    name not in self._co.include_columns:
                continue
            t = self._co.column_types.get(name) if first else \
                self._types.get(name)
            arrays.append(_convert_column(col, self._co, t))
            out_names.append(name)
        batch = Table.from_arrays(arrays, out_names).to_batches()[0]
        if first:
            self._types = {f.name: f.type for f in batch.schema}
        return batch

    def read_next_batch(self):
        if self._native is not None:
            return self._native.read_next_batch()
        if self._first is not None:
            out, self._first = self._first, None
            return out
        b = self._read_block()
        if b is None:
            raise StopIteration
        return b

    def __iter__(self):
        while True:
            try:
                yield self.read_next_batch()
            except StopIteration:
                return

    def read_all(self) -> Table:
        batches = list(self)
        if not batches:
            return Table.from_arrays([], [])
        return Table.from_batches(batches, batches[0].schema)


def open_csv(source, read_options=None, parse_options=None,
             convert_options=None) -> CSVStreamingReader:
    """A streaming CSV reader (csv/reader.h:65 StreamingReader)."""
    return CSVStreamingReader(source, read_options, parse_options,
                              convert_options)


# --- the writer ---------------------------------------------------------------

def _format_value(v) -> str:
    if v is None:
        return ""
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float):
        return repr(v)
    if isinstance(v, bytes):
        return v.decode("utf8", "replace")
    return str(v)


def _native_type(col) -> bool:
    """Whether ``_raw_format_column`` formats column ``col`` (a whole
    column's test, so each block of its rows passes it too)."""
    t = col.type
    if t.id == T.TypeId.DICTIONARY:
        return t.value_type.id in (T.TypeId.STRING, T.TypeId.LARGE_STRING)
    if t.id == T.TypeId.UINT64:
        arr = col.combine() if hasattr(col, "combine") else col
        a = arr.data.values()
        return not (len(a) and a.max() > np.iinfo(np.int64).max)
    if t.id == T.TypeId.LARGE_STRING:
        arr = col.combine() if hasattr(col, "combine") else col
        offs = arr.data.offsets()
        return not (len(offs) and offs[-1] > np.iinfo(np.int32).max)
    return t.is_integer or t.id in (T.TypeId.DOUBLE, T.TypeId.STRING)


def _raw_format_column(col, delim: str):
    """(offsets int64[n+1], bytes) of the cells of a column that
    ``_native_type`` takes, by the native formatters."""
    arr = col.combine() if hasattr(col, "combine") else col
    if arr.type.id == T.TypeId.DICTIONARY:
        arr = decoded(arr)
    t = arr.type
    valid = arr.is_valid_mask() if arr.null_count else None
    if t.is_integer:
        return nat.csv_format_i64(arr.data.values().astype(np.int64,
                                                           copy=False),
                                  valid, raw=True)
    if t.id == T.TypeId.DOUBLE:
        return nat.csv_format_f64(arr.data.values(), valid, raw=True)
    return nat.csv_quote_cells(arr.data.data_bytes(),
                               arr.data.offsets().astype(np.int32), valid,
                               delim)


def _fast_type(t) -> bool:
    """Whether ``_fast_format_column`` formats a column of type ``t``."""
    if t.id == T.TypeId.DICTIONARY:
        t = t.value_type
    return t.is_integer or t.is_floating or t.id in (
        T.TypeId.BOOL, T.TypeId.STRING, T.TypeId.LARGE_STRING)


def _fast_format_column(col, delim: str):
    """A list of the cell strings of a column that ``_fast_type`` takes:
    int64 and float64 by the native formatters (a float cell with an
    exponent by ``repr``), the other numbers by numpy's text, strings
    quoted where needed."""
    arr = col.combine() if hasattr(col, "combine") else col
    t = arr.type
    if t.id == T.TypeId.DICTIONARY:
        arr = decoded(arr)
        t = arr.type
    if t.is_integer or t.is_floating:
        a = np.asarray(arr.data.values(), dtype=t.to_numpy_dtype())
        valid = arr.is_valid_mask() if arr.null_count else None
        if t.id == T.TypeId.DOUBLE:
            out = nat.csv_format_f64(a, valid)
            return [repr(float(x)) if "e" in x else x for x in out]
        if t.id == T.TypeId.INT64:
            return nat.csv_format_i64(a, valid)
        out = a.astype("U32").tolist()
        if arr.null_count:
            m = arr.is_valid_mask().tolist()
            out = [o if ok else "" for o, ok in zip(out, m)]
        return out
    if t.id == T.TypeId.BOOL:
        return ["" if v is None else ("true" if v else "false")
                for v in arr.to_pylist()]

    def cell(v, d=delim):
        if v is None:
            return ""
        if '"' in v or d in v or "\n" in v or "\r" in v:
            return '"' + v.replace('"', '""') + '"'
        return v
    return [cell(v) for v in arr.to_pylist()]


_DATE_MIN, _DATE_MAX = -719_162, 2_932_896   # 0001-01-01, 9999-12-31


def _civil_text(days: np.ndarray) -> np.ndarray:
    """(n, 10) uint8: each day number as YYYY-MM-DD, by the inverse of
    days_from_civil."""
    z = np.asarray(days, np.int64) + 719_468
    era = z // 146_097
    doe = z - era * 146_097
    yoe = (doe - doe // 1_460 + doe // 36_524 - doe // 146_096) // 365
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = np.where(mp < 10, mp + 3, mp - 9)
    y = yoe + era * 400 + (m <= 2)
    text = np.empty((len(z), 10), np.uint8)
    for k, p in enumerate((1000, 100, 10, 1)):
        text[:, k] = 48 + (y // p) % 10
    text[:, 4] = text[:, 7] = ord("-")
    text[:, 5], text[:, 6] = 48 + m // 10, 48 + m % 10
    text[:, 8], text[:, 9] = 48 + d // 10, 48 + d % 10
    return text


def _date_cells(days: np.ndarray, valid):
    """(offsets, bytes) of date32 cells as ``str(datetime.date)`` writes
    them, or None where a day lies outside Python's dates. The span of
    the days is formatted once and gathered."""
    live = days if valid is None else days[valid]
    if live.size and (live.min() < _DATE_MIN or live.max() > _DATE_MAX):
        return None
    lo = int(live.min()) if live.size else 0
    span = _civil_text(np.arange(lo, int(live.max(initial=lo)) + 1))
    text = span[np.asarray(live, np.int64) - lo]
    lens = np.full(len(days), 10, np.int64)
    if valid is not None:
        lens[~valid] = 0
    offs = np.zeros(len(days) + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    return offs, text.reshape(-1)


def _quoted_python_cells(texts: List[str], delim: str):
    """(offsets, bytes) of Python cell strings quoted as ``csv.writer``'s
    QUOTE_MINIMAL quotes them."""
    out = [('"' + v.replace('"', '""') + '"')
           if ('"' in v or delim in v or "\n" in v or "\r" in v) else v
           for v in texts]
    raw = [v.encode("utf8") for v in out]
    offs = np.zeros(len(raw) + 1, np.int64)
    np.cumsum([len(b) for b in raw], out=offs[1:])
    return offs, np.frombuffer(b"".join(raw), np.uint8)


def _row_cells(col, delim: str):
    """(offsets, bytes) of one column's cells as ``csv.writer`` writes
    ``_format_value`` of each value under QUOTE_MINIMAL."""
    arr = col.combine() if hasattr(col, "combine") else col
    if arr.type.id == T.TypeId.DICTIONARY:
        arr = decoded(arr)    # the reference casts to the value type
    t = arr.type
    valid = arr.is_valid_mask() if arr.null_count else None
    if t.id == T.TypeId.DATE32:
        cells = _date_cells(arr.data.values(), valid)
        if cells is not None and delim not in "0123456789-":
            return cells
    elif t.id == T.TypeId.BOOL:
        vals = arr.data.values()
        return _quoted_python_cells(
            ["" if valid is not None and not valid[i] else
             ("true" if v else "false")
             for i, v in enumerate(vals.tolist())], delim)
    elif t.is_integer and t.id != T.TypeId.UINT64 or t.is_floating:
        if delim not in "0123456789+-.einfa":
            vals = arr.data.values()
            if t.is_integer:
                return nat.csv_format_i64(vals.astype(np.int64), valid,
                                          raw=True)
            return nat.csv_format_f64(vals.astype(np.float64), valid,
                                      raw=True)
    elif t.id in (T.TypeId.STRING, T.TypeId.LARGE_STRING):
        offs = arr.data.offsets()
        if offs[-1] <= np.iinfo(np.int32).max:
            return nat.csv_quote_cells(arr.data.data_bytes(),
                                       offs.astype(np.int32), valid, delim)
    return _quoted_python_cells([_format_value(v) for v in arr.to_pylist()],
                                delim)


def _rows_body(data, names, delim: str) -> bytes:
    """The rows ``csv.writer(QUOTE_MINIMAL, lineterminator="\\r\\n")``
    writes of ``_format_value`` of each cell, made column by column: a row
    of one empty cell is ``""``, as ``csv.writer`` writes it."""
    if not names:
        return b"\r\n" * data.num_rows
    cols = [_row_cells(data.column(nm), delim) for nm in names]
    if len(cols) == 1:
        offs, pool = cols[0]
        lens = np.diff(offs)
        empty = lens == 0
        if empty.any():
            new_offs = np.zeros(len(lens) + 1, np.int64)
            np.cumsum(np.where(empty, 2, lens), out=new_offs[1:])
            out = np.full(int(new_offs[-1]), ord('"'), np.uint8)
            row = np.repeat(np.arange(len(lens)), lens)
            out[new_offs[row] + np.arange(len(pool)) - offs[row]] = pool
            cols = [(new_offs, out)]
    return nat.csv_interleave(cols, data.num_rows, delim).tobytes()


class _TextSink:
    """A text view of a ``write_csv``/``CSVWriter`` sink: a path opened
    for text, a text stream as it is, a binary stream wrapped."""

    def __init__(self, sink):
        self.close_it = False
        self.wrapped = False
        if isinstance(sink, str):
            sink = open(sink, "w", newline="")
            self.close_it = True
        self.text = sink
        if hasattr(sink, "write"):
            try:
                sink.write("")
            except TypeError:
                self.text = io.TextIOWrapper(sink, encoding="utf8",
                                             newline="")
                self.wrapped = True

    def write_bytes(self, body: bytes):
        raw = getattr(self.text, "buffer", None)
        if raw is not None:
            self.text.flush()
            raw.write(body)
        else:
            self.text.write(body.decode("utf8"))

    def close(self):
        if self.wrapped:
            self.text.flush()
            self.text.detach()
        elif self.close_it:
            self.text.close()


_WRITE_BLOCK_ROWS = 1 << 20


def _by_blocks(data, make) -> bytes:
    """``make(rows)`` of each block of 2**20 of ``data``'s rows, on
    threads (the formatters release Python's lock), end to end: the
    bytes ``make(data)`` gives."""
    n = data.num_rows
    if n <= _WRITE_BLOCK_ROWS:
        return make(data)
    import os
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        return b"".join(ex.map(
            lambda s: make(data.slice(s, _WRITE_BLOCK_ROWS)),
            range(0, n, _WRITE_BLOCK_ROWS)))


def _write_rows(sink: _TextSink, writer, data, names, delim):
    """``data``'s rows as ``csv.writer`` writes them: by column where the
    delimiter is one ASCII byte, else row by row."""
    if _single_ascii(delim):
        if data.num_rows:
            sink.write_bytes(_by_blocks(
                data, lambda rows: _rows_body(rows, names, delim)))
        return
    pyd = data.to_pydict()
    cols = [pyd[nm] for nm in names]
    for i in range(data.num_rows):
        writer.writerow([_format_value(c[i]) for c in cols])


def write_csv(data: Union[Table, RecordBatch], sink,
              write_options: Optional[WriteOptions] = None):
    wo = write_options or WriteOptions()
    nat.library()   # required: raises where it cannot be built
    out = _TextSink(sink)
    w = _csv.writer(out.text, delimiter=wo.delimiter,
                    quoting=_csv.QUOTE_MINIMAL, lineterminator="\r\n")
    names = data.column_names
    if wo.include_header:
        w.writerow(names)
    try:
        # int64, float64 and string columns: native cells end to end, one
        # native row interleave
        delim = wo.delimiter
        if wo.quoting_style == "needed" and _single_ascii(delim) \
                and data.num_rows and all(_native_type(data.column(nm))
                                          for nm in names):
            out.write_bytes(_by_blocks(data, lambda rows: nat.csv_interleave(
                [_raw_format_column(rows.column(nm), delim) for nm in names],
                rows.num_rows, delim).tobytes()))
            return
        # other primitive columns: a list of cell strings a column (a
        # Table with another type goes straight to the rows, where the
        # reference formats its columns up to that one first)
        if wo.quoting_style == "needed" and all(
                _fast_type(data.column(nm).type) for nm in names):
            colstrs = [_fast_format_column(data.column(nm), delim)
                       for nm in names]
            if colstrs and colstrs[0]:
                out.text.write("\r\n".join(map(delim.join, zip(*colstrs))))
                out.text.write("\r\n")
            return
        _write_rows(out, w, data, names, delim)
    finally:
        out.close()


class CSVWriter:
    """An incremental CSV writer (pyarrow.csv.CSVWriter): the header once,
    then each Table or RecordBatch's rows as ``csv.writer`` writes
    them."""

    def __init__(self, sink, schema, write_options=None):
        self._wo = write_options or WriteOptions()
        nat.library()   # required: raises where it cannot be built
        self._schema = schema
        self._out = _TextSink(sink)
        self._w = _csv.writer(self._out.text, delimiter=self._wo.delimiter,
                              quoting=_csv.QUOTE_MINIMAL,
                              lineterminator="\r\n")
        if self._wo.include_header:
            self._w.writerow([f.name for f in schema])

    def write(self, data):
        if isinstance(data, Table):
            for b in data.to_batches():
                self.write(b)
            return
        _write_rows(self._out, self._w, data, data.column_names,
                    self._wo.delimiter)

    write_table = write
    write_batch = write

    def close(self):
        self._out.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
