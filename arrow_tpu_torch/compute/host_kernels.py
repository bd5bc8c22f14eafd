"""The host-tier functions (counterpart of ``arrow_tpu/compute/host_kernels.py``):
those whose outputs have variable length or are host values by nature (list
and struct construction, formatting and parsing timestamps, splitting
strings). They run on host Arrays, as the reference's do (scalar_nested.cc,
strftime/strptime of scalar_temporal_unary.cc, the splits of
scalar_string_ascii.cc, memory-bound CPU loops there too), but for

* ``list_value_length``, ``list_parent_indices``, ``list_flatten``,
  ``list_element`` and ``run_end_decode``, which run their device tier
  (``device_nested.py``) on the call's ``device`` first and take the host
  tier only where the reference does: a child with no device form, an
  empty child for ``list_element``;
* ``random``, threefry2x32 in integer tensor operations on the call's
  ``device``, the bits of the reference's ``jax.random.uniform``.

Host rows are gathered by ``device.column.host_take`` (one gather on the
CPU), where the reference calls ``Array.take``. ``strptime`` parses a
fixed-width format in numpy (the reference calls pandas, which the card's
machine lacks) and takes Python's ``datetime.strptime`` a row otherwise.
"""

from __future__ import annotations

import datetime
from itertools import chain
from typing import Optional

import numpy as np
import torch

from .. import default_device
from .. import types as T
from ..array.array import Array, array as make_array
from ..array.data import ArrayData
from ..buffer import Buffer
from ..device.column import host_take
from ..utils import bits as bitutil
from . import device_nested as DN
from .registry import ArrowInvalid, register_host

# --- strftime / strptime -----------------------------------------------------

_MONTH_ABBR = ["Jan", "Feb", "Mar", "Apr", "May", "Jun", "Jul", "Aug", "Sep",
               "Oct", "Nov", "Dec"]
_DAY_ABBR = ["Mon", "Tue", "Wed", "Thu", "Fri", "Sat", "Sun"]
_NUM_WIDTH = {"Y": 4, "y": 2, "m": 2, "d": 2, "H": 2, "M": 2, "S": 2,
              "I": 2, "j": 3, "f": 6}


def _format_entries(format: str):
    """A format as fixed-width entries: ("lit", bytes), ("num", key,
    width) or ("name", key); None where a directive has no fixed width
    (%A, %B, ...) or a literal is not ASCII."""
    entries, i, lit = [], 0, ""
    while i < len(format):
        ch = format[i]
        if ch != "%":
            lit += ch
            i += 1
            continue
        if i + 1 >= len(format):
            return None
        d = format[i + 1]
        i += 2
        if d == "%":
            lit += "%"
            continue
        if lit:
            if not lit.isascii():
                return None
            entries.append(("lit", lit.encode("ascii")))
            lit = ""
        if d in _NUM_WIDTH:
            entries.append(("num", d, _NUM_WIDTH[d]))
        elif d in "pab":
            entries.append(("name", d))
        else:
            return None
    if lit:
        if not lit.isascii():
            return None
        entries.append(("lit", lit.encode("ascii")))
    return entries


def _entry_width(p) -> int:
    if p[0] == "lit":
        return len(p[1])
    if p[0] == "num":
        return p[2]
    return 2 if p[1] == "p" else 3


def _civil(days: np.ndarray):
    """(year, month, day) of int64 days since 1970-01-01, by
    ``temporal.civil_from_days`` over CPU tensors."""
    from .temporal import civil_from_days
    y, m, d, _ = civil_from_days(torch.from_numpy(days))
    return y.numpy(), m.numpy(), d.numpy()


def _days_from_civil(y, m, d) -> np.ndarray:
    from .temporal import days_from_civil
    return days_from_civil(torch.from_numpy(y), torch.from_numpy(m),
                           torch.from_numpy(np.broadcast_to(
                               np.asarray(d, np.int64), y.shape).copy())
                           ).numpy()


def _strftime_vectorized(arr: Array, format: str):
    """(n, L) uint8 rows of the formatted timestamps (reference
    ``_strftime_vectorized``: datetime64 fields, ASCII digit planes), or
    None where the format or a year outside 0000-9999 needs the per-row
    path."""
    t = arr.type
    if getattr(t, "tz", None):
        return None
    entries = _format_entries(format)
    if entries is None:
        return None
    vals = np.asarray(arr.data.values(), np.int64)
    n = len(vals)
    us = vals // 1000 if t.unit == "ns" else vals * {
        "s": 1_000_000, "ms": 1000, "us": 1}[t.unit]
    days = us // 86_400_000_000
    rem = us - days * 86_400_000_000
    Y, M, D = _civil(days)
    if n and ((Y < 0).any() or (Y > 9999).any()):
        return None
    fields = {
        "Y": lambda: Y, "y": lambda: Y % 100, "m": lambda: M,
        "d": lambda: D,
        "j": lambda: days - _days_from_civil(Y, np.ones_like(Y), 1) + 1,
        "H": lambda: rem // 3_600_000_000,
        "M": lambda: rem // 60_000_000 % 60,
        "S": lambda: rem // 1_000_000 % 60,
        "I": lambda: (rem // 3_600_000_000 + 11) % 12 + 1,
        "f": lambda: rem % 1_000_000}
    L = sum(_entry_width(p) for p in entries)
    buf = np.empty((n, L), np.uint8)
    pos = 0
    for p in entries:
        w = _entry_width(p)
        if p[0] == "lit":
            buf[:, pos:pos + w] = np.frombuffer(p[1], np.uint8)
        elif p[0] == "num":
            v = fields[p[1]]()
            for k in range(w):
                buf[:, pos + w - 1 - k] = (v // 10 ** k) % 10 + 48
        else:
            if p[1] == "p":
                tbl, idx = b"AMPM", (rem >= 43_200_000_000).astype(np.int64)
            elif p[1] == "a":
                # the epoch was a Thursday
                tbl = "".join(_DAY_ABBR).encode()
                idx = (days + 3) % 7
            else:
                tbl = "".join(_MONTH_ABBR).encode()
                idx = M - 1
            buf[:, pos:pos + w] = np.frombuffer(tbl, np.uint8).reshape(
                -1, w)[idx]
        pos += w
    return buf


def _fixed_width_strings(rows: np.ndarray, mask) -> Array:
    """A string Array of (n, L) uint8 rows, null (and empty) where ``mask``
    is False."""
    n, L = rows.shape
    lens = np.full(n, L, np.int64)
    if mask is not None:
        lens[~mask] = 0
        rows = rows[mask]
    offsets = np.zeros(n + 1, np.int32)
    np.cumsum(lens, out=offsets[1:])
    validity = None if mask is None else Buffer(bitutil.pack_bits(mask))
    return Array(ArrayData(T.string(), n, [validity, Buffer(offsets),
                                           Buffer(rows.reshape(-1))],
                           null_count=0 if mask is None
                           else int(n - mask.sum())))


@register_host("strftime")
def _strftime(arr: Array, format: str = "%Y-%m-%dT%H:%M:%S",
              locale: Optional[str] = None) -> Array:
    rows = None
    if locale in (None, "C") and arr.type.id == T.TypeId.TIMESTAMP:
        rows = _strftime_vectorized(arr, format)
    if rows is not None:
        return _fixed_width_strings(rows, arr.data.validity_mask())
    return make_array([None if v is None else v.strftime(format)
                       for v in arr.to_pylist()], T.string())


def _strptime_vectorized(arr: Array, format: str, unit: str):
    """The parse of ASCII strings of one fixed width in a format of
    ``%Y %m %d %H %M %S`` and literals, as epoch counts of ``unit``
    (in numpy); None where a row needs the per-row path (another width,
    another directive, a literal or a digit out of place, a field out of
    range)."""
    entries = _format_entries(format)
    if entries is None or arr.type.id not in (T.TypeId.STRING,
                                              T.TypeId.LARGE_STRING) \
            or any(p[0] == "name" or (p[0] == "num" and p[1] not in "YmdHMS")
                   for p in entries):
        return None
    n = len(arr)
    L = sum(_entry_width(p) for p in entries)
    mask = arr.data.validity_mask()
    offs = np.asarray(arr.data.offsets(), np.int64)
    lens = np.diff(offs)
    live = np.ones(n, bool) if mask is None else mask
    if (lens[live] != L).any():
        return None
    raw = arr.data.data_bytes()
    if mask is None and n and offs[-1] - offs[0] == n * L:
        # every row L bytes, back to back: the bytes themselves
        rows = raw[offs[0]:offs[-1]].reshape(n, L)
    elif L and len(raw) < L:
        return None
    else:
        starts = np.where(live, offs[:-1], 0)
        rows = raw[np.minimum(starts[:, None] + np.arange(L),
                              max(len(raw) - 1, 0))][live] \
            if L else np.zeros((int(live.sum()), 0), np.uint8)
    got, pos = {}, 0
    for p in entries:
        w = _entry_width(p)
        part = rows[:, pos:pos + w]
        if p[0] == "lit":
            if (part != np.frombuffer(p[1], np.uint8)).any():
                return None
        else:
            if ((part < 48) | (part > 57)).any():
                return None
            v = np.zeros(len(part), np.int64)
            for k in range(w):
                v = v * 10 + (part[:, k] - 48)
            got[p[1]] = v
        pos += w
    one = np.ones(len(rows), np.int64)
    Y, m, d = got.get("Y", 1900 * one), got.get("m", one), got.get("d", one)
    H, M, S = (got.get(k, 0 * one) for k in "HMS")
    if ((m < 1) | (m > 12) | (d < 1) | (H > 23) | (M > 59) | (S > 59)
            | (Y < 1)).any():
        return None
    days = _days_from_civil(Y, m, d)
    if (_civil(days)[2] != d).any():
        return None  # a day past its month's end
    sec = days * 86_400 + H * 3600 + M * 60 + S
    per = {"s": 1, "ms": 1000, "us": 1_000_000, "ns": 1_000_000_000}[unit]
    out = np.zeros(n, np.int64)
    out[live] = sec * per
    return Array(ArrayData(T.timestamp(unit), n, [
        None if mask is None else Buffer(bitutil.pack_bits(mask)),
        Buffer(out)], null_count=0 if mask is None else int(n - mask.sum())))


@register_host("strptime")
def _strptime(arr: Array, format: str = "%Y-%m-%dT%H:%M:%S",
              unit: str = "us", error_is_null: bool = False) -> Array:
    fast = _strptime_vectorized(arr, format, unit)
    if fast is not None:
        return fast
    out = []
    for v in arr.to_pylist():
        if v is None:
            out.append(None)
            continue
        try:
            out.append(datetime.datetime.strptime(v, format))
        except ValueError:
            if not error_is_null:
                raise ArrowInvalid(f"cannot parse {v!r} with {format!r}")
            out.append(None)
    return make_array(out, T.timestamp(unit))


# --- splits and joins ----------------------------------------------------------

def _build_string_list(rows, n: int) -> Array:
    """A list<string> Array of per-row lists (None a null row): offsets
    and one flat child."""
    lens = np.fromiter((0 if r is None else len(r) for r in rows),
                       np.int64, n)
    offsets = np.zeros(n + 1, np.int32)
    offsets[1:] = np.cumsum(lens)
    child = make_array(list(chain.from_iterable(r for r in rows
                                                if r is not None)),
                       T.string())
    nulls = np.fromiter((r is None for r in rows), np.bool_, n)
    null_count = int(nulls.sum())
    return Array(ArrayData(T.list_(T.string()), n, [
        Buffer(bitutil.pack_bits(~nulls)) if null_count else None,
        Buffer(offsets)], children=[child.data], null_count=null_count))


def _split_bytes(arr: Array, is_sep, drop_empty: bool) -> Optional[Array]:
    """A list<string> Array of each row's pieces between the bytes where
    ``is_sep`` (a function of the uint8 data) is true, over the data
    buffer in numpy: ``str.split(sep)`` for one ASCII separator byte, or,
    ``drop_empty``, ``str.split()`` for ASCII whitespace. None where a
    row is not ASCII (or the type is not a string)."""
    if arr.type.id not in (T.TypeId.STRING, T.TypeId.LARGE_STRING):
        return None
    d = arr.data
    n = len(arr)
    offs = np.asarray(d.offsets(), np.int64)
    raw = d.data_bytes()[offs[0]:offs[-1]] if n else np.zeros(0, np.uint8)
    if (raw >= 128).any():
        return None
    mask = d.validity_mask()
    live = np.ones(n, bool) if mask is None else mask
    rows = offs - offs[0]
    sep = is_sep(raw)
    # each byte's row; the bytes of null rows take no part
    row_of = np.repeat(np.arange(n), np.diff(rows))
    keep_byte = live[row_of]
    if drop_empty:
        word = ~sep & keep_byte
        prev = np.concatenate([[False], word[:-1]])
        nxt = np.concatenate([word[1:], [False]])
        first = np.zeros(len(raw), bool)
        first[rows[:-1][np.diff(rows) > 0]] = True
        last = np.zeros(len(raw), bool)
        last[rows[1:][np.diff(rows) > 0] - 1] = True
        starts = np.flatnonzero(word & (~prev | first))
        ends = np.flatnonzero(word & (~nxt | last)) + 1
        counts = np.bincount(row_of[starts], minlength=n)
    else:
        # a row's pieces: one more than its separators; the ranges of
        # all rows, sorted, pair up (ties are empty pieces)
        cut = np.flatnonzero(sep & keep_byte)
        starts = np.sort(np.concatenate([rows[:-1][live], cut + 1]))
        ends = np.sort(np.concatenate([rows[1:][live], cut]))
        counts = np.where(live, np.bincount(row_of[cut], minlength=n) + 1,
                          0)
    lens = ends - starts
    from ..device.column import _gather_bytes
    coffs, cdata = _gather_bytes(raw, starts, lens)
    offsets = np.zeros(n + 1, np.int32)
    np.cumsum(counts, out=offsets[1:])
    child = ArrayData(T.string(), len(starts), [
        None, Buffer(coffs.astype(np.int32)), Buffer(cdata)], null_count=0)
    null_count = int(n - live.sum())
    return Array(ArrayData(T.list_(T.string()), n, [
        Buffer(bitutil.pack_bits(live)) if null_count else None,
        Buffer(offsets)], children=[child], null_count=null_count))


_ASCII_WS = np.zeros(256, bool)
_ASCII_WS[[9, 10, 11, 12, 13, 28, 29, 30, 31, 32]] = True


@register_host("split_pattern")
def _split_pattern(arr: Array, pattern: str = " ",
                   max_splits: Optional[int] = None,
                   reverse: bool = False) -> Array:
    k = -1 if max_splits is None else max_splits
    if k < 0 and len(pattern) == 1 and pattern.isascii():
        b = ord(pattern)
        fast = _split_bytes(arr, lambda raw: raw == b, False)
        if fast is not None:
            return fast
    vals = arr.to_pylist()
    if reverse and k > 0:
        rows = [None if v is None else v.rsplit(pattern, k) for v in vals]
    else:
        rows = [None if v is None else v.split(pattern, k) for v in vals]
    return _build_string_list(rows, len(vals))


@register_host("utf8_split_whitespace")
def _split_ws(arr: Array, max_splits: Optional[int] = None) -> Array:
    k = -1 if max_splits is None else max_splits
    if k < 0:
        fast = _split_bytes(arr, lambda raw: _ASCII_WS[raw], True)
        if fast is not None:
            return fast
    vals = arr.to_pylist()
    return _build_string_list([None if v is None else v.split(None, k)
                               for v in vals], len(vals))


def _join_bytes(lists: Array, separator: str) -> Optional[Array]:
    """binary_join over the child's bytes in numpy: each valid list's
    strings and the separator between them laid end to end by one
    gather; None where the child is not a string column."""
    lay = DN.list_layout(lists)
    if lay is None or lay[1].type.id not in (T.TypeId.STRING,
                                             T.TypeId.LARGE_STRING):
        return None
    from ..device.column import _gather_bytes
    offs, child = lay
    n = len(lists)
    cd = child.data
    coffs = np.asarray(cd.offsets(), np.int64)
    cvalid = child.is_valid_mask()
    null_pref = np.zeros(len(child) + 1, np.int64)
    np.cumsum(~cvalid, out=null_pref[1:])
    ok = (null_pref[offs[1:]] - null_pref[offs[:-1]]) == 0
    mask = lists.data.validity_mask()
    if mask is not None:
        ok &= mask
    counts = np.where(ok, np.diff(offs), 0)
    elems = np.repeat(offs[:-1], counts) + np.arange(counts.sum()) - \
        np.repeat(np.cumsum(counts) - counts, counts)
    sep = separator.encode()
    raw = np.concatenate([cd.data_bytes(), np.frombuffer(sep, np.uint8)])
    last = np.zeros(len(elems), bool)
    ends = np.cumsum(counts)
    last[ends[counts > 0] - 1] = True
    starts = np.empty(2 * len(elems), np.int64)
    lens = np.empty(2 * len(elems), np.int64)
    starts[0::2] = coffs[elems]
    lens[0::2] = coffs[elems + 1] - coffs[elems]
    starts[1::2] = len(raw) - len(sep)
    lens[1::2] = np.where(last, 0, len(sep))
    _, data = _gather_bytes(raw, starts, lens)
    row_len = np.zeros(n, np.int64)
    if len(elems):
        seg = lens[0::2] + lens[1::2]
        row_len[ok & (counts > 0)] = np.add.reduceat(
            seg, (ends - counts)[ok & (counts > 0)])
    offsets = np.zeros(n + 1, np.int32)
    np.cumsum(row_len, out=offsets[1:])
    null_count = int(n - ok.sum())
    return Array(ArrayData(T.string(), n, [
        Buffer(bitutil.pack_bits(ok)) if null_count else None,
        Buffer(offsets), Buffer(data)], null_count=null_count))


@register_host("binary_join")
def _binary_join(lists: Array, separator) -> Array:
    """Each list's strings joined by ``separator``; null where the list or
    one of its strings is null."""
    if isinstance(separator, str):
        fast = _join_bytes(lists, separator)
        if fast is not None:
            return fast
    lay = DN.list_layout(lists)
    if lay is not None and isinstance(separator, str):
        offs, child = lay
        flat = child.to_pylist()
        null_pref = np.zeros(len(flat) + 1, np.int64)
        np.cumsum(np.fromiter((v is None for v in flat), np.bool_,
                              len(flat)), out=null_pref[1:])
        bad = (null_pref[offs[1:]] - null_pref[offs[:-1]]) > 0
        mask = lists.data.validity_mask()
        if mask is not None:
            bad |= ~mask
        return make_array([None if b else separator.join(flat[s:e])
                           for b, s, e in zip(bad.tolist(),
                                              offs[:-1].tolist(),
                                              offs[1:].tolist())],
                          T.string())
    return make_array([None if v is None or any(x is None for x in v)
                       else separator.join(v) for v in lists.to_pylist()],
                      T.string())


# --- lists -------------------------------------------------------------------

def _masked_lens(arr: Array, offs):
    """Each row's element count, 0 for a null row, and the mask."""
    lens = np.diff(offs)
    mask = arr.data.validity_mask()
    if mask is not None:
        lens = np.where(mask, lens, 0)
    return lens, mask


def _with_validity(arr: Array, keep) -> Array:
    """``arr`` with its validity and-ed with ``keep`` (bool numpy)."""
    d = arr.data
    m = d.validity_mask()
    new = keep if m is None else m & keep
    if bool(new.all()):
        return arr
    if d.offset:
        arr = Array(host_take(arr, np.arange(len(arr)), decode=False).data)
        d = arr.data
    return Array(ArrayData(d.type, d.length,
                           [Buffer(bitutil.pack_bits(new))]
                           + list(d.buffers[1:]),
                           children=list(d.children),
                           null_count=int(len(new) - new.sum()),
                           dictionary=d.dictionary))


@register_host("list_value_length", takes_device=True)
def _list_value_length(arr: Array, device=None) -> Array:
    """diff(offsets), null where the list is (scalar_nested.cc
    ListValueLength); the device tier first."""
    hit = DN.list_value_length(arr, device)
    if hit is not None:
        return hit
    lay = DN.list_layout(arr)
    if lay is None:
        return make_array([None if v is None else len(v)
                           for v in arr.to_pylist()], T.int32())
    out = make_array(np.diff(lay[0]).astype(np.int32), T.int32())
    mask = arr.data.validity_mask()
    return out if mask is None else _with_validity(out, mask)


@register_host("list_flatten", takes_device=True)
def _list_flatten(arr: Array, device=None) -> Array:
    """The child's slots of the valid lists, in order (vector_nested.cc
    ListFlatten); the device tier first."""
    hit = DN.list_flatten(arr, device)
    if hit is not None:
        return hit
    lay = DN.list_layout(arr)
    if lay is None:
        return make_array([x for v in arr.to_pylist() if v is not None
                           for x in v], arr.type.value_type)
    offs, values = lay
    lens, mask = _masked_lens(arr, offs)
    total = int(lens.sum())
    if mask is None and total == offs[-1] - offs[0]:
        return values.slice(int(offs[0]), total)
    starts = np.repeat(offs[:-1], lens)
    within = np.arange(total, dtype=np.int64) - \
        np.repeat(np.cumsum(lens) - lens, lens)
    return host_take(values, starts + within, decode=False)


@register_host("list_parent_indices", takes_device=True)
def _list_parent_indices(arr: Array, device=None) -> Array:
    """The row of each child slot of a valid list (null lists' slots left
    out); the device tier first."""
    hit = DN.list_parent_indices(arr, device)
    if hit is not None:
        return hit
    lay = DN.list_layout(arr)
    if lay is None:
        return make_array([i for i, v in enumerate(arr.to_pylist())
                           if v is not None for _ in v], T.int64())
    lens, _ = _masked_lens(arr, lay[0])
    return make_array(np.repeat(np.arange(len(lens), dtype=np.int64), lens),
                      T.int64())


@register_host("list_element", takes_device=True)
def _list_element(arr: Array, index: int = 0, device=None) -> Array:
    """Each list's element ``index``, null where the list is null or
    shorter; the device tier first. A negative ``index`` raises, as
    Arrow's does, before either tier runs (an offset plus a negative
    index would read the list before)."""
    if index < 0:
        raise ArrowInvalid(f"list_element: index {index} is negative "
                           "(take: index out of bounds)")
    hit = DN.list_element(arr, index, device)
    if hit is not None:
        return hit
    lay = DN.list_layout(arr)
    if lay is None:
        return make_array([None if v is None or index >= len(v) else v[index]
                           for v in arr.to_pylist()], arr.type.value_type)
    offs, values = lay
    lens, _ = _masked_lens(arr, offs)
    ok = lens > index
    if len(values) == 0:
        return make_array([None] * len(arr), values.type)
    taken = host_take(values, np.where(ok, offs[:-1] + index, offs[0]),
                      decode=False)
    return _with_validity(taken, ok)


# --- structs and maps ----------------------------------------------------------

@register_host("make_struct")
def _make_struct(*arrays, field_names=None) -> Array:
    """The arrays as the struct's children, every row valid
    (scalar_nested.cc MakeStruct)."""
    arrays = [a if isinstance(a, Array) else make_array(a) for a in arrays]
    names = list(field_names) if field_names else \
        [str(i) for i in range(len(arrays))]
    n = len(arrays[0])
    if any(len(a) != n for a in arrays[1:]):
        raise ArrowInvalid("make_struct arrays must share length")
    st = T.struct([(nm, a.type) for nm, a in zip(names, arrays)])
    children = [a.data if a.data.offset == 0 else
                make_array(a.to_pylist(), a.type).data for a in arrays]
    return Array(ArrayData(st, n, [None], children=children, null_count=0))


@register_host("struct_field")
def _struct_field(arr: Array, indices=None, field=None) -> Array:
    """A field's child, null where the struct row is."""
    sel = field if field is not None else indices
    names = [f.name for f in arr.type.fields]
    if isinstance(sel, int):
        sel = names[sel]
    idx = names.index(sel)
    d = arr.data
    if d.offset == 0 and d.children[idx].length == d.length:
        child = Array(d.children[idx])
        m = d.validity_mask()
        return child if m is None else _with_validity(child, m)
    return make_array([None if v is None else v.get(sel)
                       for v in arr.to_pylist()], arr.type.fields[idx].type)


@register_host("map_lookup")
def _map_lookup(arr: Array, query_key=None,
                occurrence: str = "first") -> Array:
    """The item of ``query_key`` in each map: its first or last occurrence
    by one key comparison over the flat entries and one gather, or all
    occurrences as a list (scalar_nested.cc MapLookup)."""
    lay = DN.list_layout(arr)
    if lay is not None and occurrence in ("first", "last"):
        offs, entries = lay
        ed = entries.data
        if len(ed.children) >= 2:
            keys = Array(ed.children[0].slice(entries.offset, len(entries)))
            items = Array(ed.children[1].slice(entries.offset,
                                               len(entries)))
            kl = keys.to_pylist()
            match = np.fromiter((k == query_key for k in kl), np.bool_,
                                len(kl))
            n = len(arr)
            row_of = np.repeat(np.arange(n, dtype=np.int64), np.diff(offs))
            m_idx = np.nonzero(match[offs[0]:offs[-1]])[0]
            rows = row_of[m_idx]
            sel = np.full(n, -1, np.int64)
            if occurrence == "first":
                sel[rows[::-1]] = m_idx[::-1]
            else:
                sel[rows] = m_idx
            got = sel >= 0
            mask = arr.data.validity_mask()
            if mask is not None:
                got &= mask
            if len(items) == 0:
                return make_array([None] * n, arr.type.item_type)
            taken = host_take(items, np.where(got, sel + offs[0], offs[0]),
                              decode=False)
            return _with_validity(taken, got)
    out = []
    for row in arr.to_pylist():
        if row is None:
            out.append(None)
            continue
        hits = [v for k, v in row if k == query_key]
        if not hits:
            out.append(None)
        elif occurrence == "first":
            out.append(hits[0])
        elif occurrence == "last":
            out.append(hits[-1])
        else:
            out.append(hits)
    if occurrence not in ("first", "last"):
        return make_array(out, T.list_(arr.type.item_type))
    return make_array(out, arr.type.item_type)


# --- run-end decode ------------------------------------------------------------

@register_host("run_end_decode", takes_device=True)
def _run_end_decode(arr: Array, device=None) -> Array:
    """Logical row i is the value of the first run whose end exceeds i
    (vector_run_end_encode.cc); the device tier first."""
    hit = DN.run_end_decode_device(arr, device)
    if hit is not None:
        return hit
    d = arr.data
    if arr.type.id != T.TypeId.RUN_END_ENCODED or len(d.children) < 2:
        return make_array(arr.to_pylist(), arr.type.value_type)
    ends = np.asarray(d.children[0].values(), np.int64)
    values = Array(d.children[1])
    idx = np.searchsorted(ends, np.arange(d.offset, d.offset + d.length),
                          side="right")
    if len(values) == 0:
        return make_array([None] * d.length, values.type)
    return host_take(values, idx, decode=False)


# --- random --------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_CHUNK = 1 << 24


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1: int, k2: int, x0: torch.Tensor, x1: torch.Tensor):
    """The Threefry-2x32 hash of 20 rounds (Salmon et al. 2011), as
    ``jax._src.prng._threefry2x32_lowering`` computes it: uint32 words held
    in int64 tensors, masked after each add and rotate."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def uniform_threefry(seed: int, n: int, device) -> torch.Tensor:
    """``jax.random.uniform(jax.random.key(seed), (n,), float64)`` with
    ``jax_threefry_partitionable``: the key (seed >> 32, seed & 0xFFFFFFFF),
    counter i hashed as the words (i >> 32, i & 0xFFFFFFFF), the two
    outputs the high and low words of 64 bits, whose top 52 become the
    mantissa of a double in [1, 2), less 1."""
    k1, k2 = (seed >> 32) & _M32, seed & _M32
    out = torch.empty(n, dtype=torch.float64, device=device)
    for s in range(0, n, _CHUNK):
        i = torch.arange(s, min(s + _CHUNK, n), dtype=torch.int64,
                         device=device)
        hi, lo = threefry2x32(k1, k2, i >> 32, i & _M32)
        bits = (hi << 20) | (lo >> 12) | 0x3FF0000000000000
        out[s:s + len(i)] = bits.view(torch.float64) - 1.0
    return out


@register_host("random", takes_device=True)
def _random(length, initializer="system", device=None) -> Array:
    """Uniform doubles in [0, 1) (reference: vector_random.cc), the
    counter-based threefry of the JAX package: a seeded call gives its
    bits exactly, on any device; ``"system"`` draws the seed as it does."""
    if int(length) < 0:
        raise ArrowInvalid("random: length must be non-negative")
    seed = int(np.random.SeedSequence().generate_state(1)[0]) \
        if initializer == "system" else int(initializer)
    vals = uniform_threefry(seed, int(length), default_device(device))
    return make_array(vals.cpu().numpy())
