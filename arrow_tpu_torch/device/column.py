"""Device-resident columnar data (counterpart of ``arrow_tpu/device/column.py``).

* values: a padded, fixed-capacity tensor on the device
* validity: an optional bool mask tensor (a byte mask, not packed bits)
* strings are dictionary codes: kernels see int32 codes, and the
  dictionary (a tuple of Python values) stays on the host
* a DeviceBatch carries its ``row_count`` as a 0-d tensor beside the static
  capacity, so a data-dependent size (the number of groups) needs no
  device-to-host copy until the result is downloaded.

Every type is stored at the reference's width (``dtypes``): uint16, uint32
and uint64 as the bits of the signed dtype of that width, decimals of up
to 18 digits as their unscaled int64, dates, timestamps, times and
durations as their integer count of the type's unit, month intervals as
int32 and the all-null type as int8 zeros under an all-false validity.

The host boundary (``upload_*``/``download_*``) follows the reference's
representation: strings and binaries become int32 codes over a dictionary
in order of first appearance (a null row is coded as the empty value, as
the reference's encoder codes it), a dictionary array its codes, a
decimal of up to 18 digits its low 8 bytes (sign-extended back at
download), a wider decimal or a fixed-size binary codes over a
value-sorted dictionary, and a nested column its row ids with the host
Array in the dictionary slot, rehydrated at download. Bitmaps unpack to
bool tensors and pack again, with no loop over the rows in Python.
"""

from __future__ import annotations

import decimal
import warnings
import weakref
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view
import torch

from .. import default_device, dtypes
from .. import types as T
from ..array.array import Array, array as make_array
from ..array.data import ArrayData
from ..buffer import Buffer
from ..types import DataType, Field, Schema, TypeId
from ..utils import bits as bitutil

# Row capacities are padded to a multiple of this.
BLOCK = 1024


def round_up(n: int, m: int = BLOCK) -> int:
    return max(m, (n + m - 1) // m * m)


def capacity_class(n: int) -> int:
    """A data-dependent output size (join matches) rounded up to its
    power-of-two capacity class, at least BLOCK."""
    return max(BLOCK, 1 << (max(n, 1) - 1).bit_length())


def torch_dtype_for(t: DataType) -> torch.dtype:
    """The storage dtype of a logical type: ``dtypes.STORAGE`` of its
    value dtype (uint16/32/64 as the signed dtype of their width)."""
    return dtypes.STORAGE[dtypes.dtype_of_type(t)]


class DeviceColumn:
    """One padded device column. ``dictionary`` holds the host values that
    int32 codes index, or None."""

    __slots__ = ("values", "validity", "type", "dictionary")

    def __init__(self, values: torch.Tensor, validity: Optional[torch.Tensor],
                 type: DataType, dictionary: Optional[Tuple] = None):
        self.values = values
        self.validity = validity
        self.type = type
        self.dictionary = dictionary

    @property
    def capacity(self) -> int:
        return self.values.shape[0]

    @property
    def value_dtype(self) -> str:
        """The dtype name of the values (``dtypes``): the type's, so an
        unsigned column reads as unsigned."""
        return dtypes.dtype_of_values(self.values, self.type)

    def valid_mask(self, row_mask: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
        """bool[capacity]: validity combined with the batch row mask."""
        m = self.validity
        if m is None:
            m = torch.ones(self.capacity, dtype=torch.bool,
                           device=self.values.device)
        if row_mask is not None:
            m = m & row_mask
        return m

    def __repr__(self):
        return (f"DeviceColumn({self.type!r}, cap={self.capacity}, "
                f"validity={'yes' if self.validity is not None else 'no'})")


class DeviceBatch:
    """Equal-capacity DeviceColumns plus the live row count (a 0-d integer
    tensor on the columns' device)."""

    __slots__ = ("schema", "columns", "row_count")

    def __init__(self, schema: Schema, columns: Sequence[DeviceColumn],
                 row_count: torch.Tensor):
        self.schema = schema
        self.columns = list(columns)
        self.row_count = row_count

    @property
    def capacity(self) -> int:
        return self.columns[0].capacity if self.columns else 0

    def column(self, i: Union[int, str]) -> DeviceColumn:
        if isinstance(i, str):
            idx = self.schema.get_field_index(i)
            if idx < 0:
                raise KeyError(f"no column named {i!r}")
            i = idx
        return self.columns[i]

    def row_mask(self) -> torch.Tensor:
        """bool[capacity]: True on the live rows."""
        return (torch.arange(self.capacity, dtype=torch.int32,
                             device=self.row_count.device) < self.row_count)

    def select(self, names: Sequence[str]) -> "DeviceBatch":
        idxs = [self.schema.get_field_index(n) for n in names]
        return DeviceBatch(Schema([self.schema.fields[i] for i in idxs]),
                           [self.columns[i] for i in idxs], self.row_count)

    def __repr__(self):
        return (f"DeviceBatch(cap={self.capacity}, "
                f"cols={self.schema.names})")


def batch_from_numpy(columns: Sequence[tuple], row_count: int,
                     device=None) -> DeviceBatch:
    """Build a DeviceBatch from plain numpy arrays.

    ``columns`` holds ``(name, type, values, validity_or_None,
    dictionary_values_or_None)`` per column; ``type`` is a DataType or a
    name for ``types.type_for_name``. ``values`` are the values of the
    type's value dtype (unsigned ones as unsigned), or
    ``datetime64``/``timedelta64`` values for a temporal type (converted
    to its unit), or ``decimal.Decimal`` values for a decimal (scaled to
    its unscaled integers exactly). Values are padded with zeros, and
    validity with False, to ``round_up`` of the longest column. A null
    column is all null. Binaries, fixed-size binary, decimals wider than
    18 digits and nested types raise ValueError: they come from a host
    Array (``upload_column``)."""
    dev = default_device(device)
    cap = round_up(max([row_count] + [len(c[2]) for c in columns]))
    fields, cols = [], []
    for name, type_, values, validity, dictionary in columns:
        t = T.type_for_name(type_) if isinstance(type_, str) else type_
        if _code_valued(t):
            raise ValueError(
                f"{t!r} rides the device as codes over a host dictionary: "
                "upload it from a host Array at the host boundary "
                "(upload_column)")
        vals = np.zeros(cap, dtype=_numpy_dtype(t))
        vals[:len(values)] = _host_values(t, values)
        mask = None
        if t.id == TypeId.NA:
            validity = np.zeros(len(values), dtype=np.bool_)
        if validity is not None:
            m = np.zeros(cap, dtype=np.bool_)
            m[:len(validity)] = validity
            mask = torch.from_numpy(m).to(dev)
        fields.append(Field(name, t))
        cols.append(DeviceColumn(
            torch.from_numpy(vals).to(dev), mask, t,
            tuple(dictionary) if dictionary is not None else None))
    return DeviceBatch(Schema(fields), cols,
                       torch.tensor(row_count, dtype=torch.int32,
                                    device=dev))


def batch_from_arrays(schema: Schema, columns: Sequence[tuple],
                      row_count: int) -> DeviceBatch:
    """A CPU DeviceBatch from numpy arrays already in their storage dtype
    (what a download of the columns gives): ``(values, validity_or_None,
    dictionary_or_None)`` a field of ``schema``, padded with zeros (and
    False) to ``round_up(row_count)``."""
    cap = round_up(row_count)
    cols = []
    for values, validity, dictionary in columns:
        vals = np.zeros(cap, dtype=values.dtype)
        vals[:row_count] = values
        mask = None
        if validity is not None:
            mask = np.zeros(cap, dtype=np.bool_)
            mask[:row_count] = validity
            mask = torch.from_numpy(mask)
        cols.append((torch.from_numpy(vals), mask, dictionary))
    return DeviceBatch(schema, [DeviceColumn(v, m, f.type, d) for (v, m, d), f
                                in zip(cols, schema.fields)],
                       torch.tensor(row_count, dtype=torch.int32))


def _code_valued(t: DataType) -> bool:
    """A type the device holds as codes over a host dictionary whose
    values ``batch_from_numpy`` cannot make: binaries, fixed-size binary,
    decimals wider than 18 digits and nested types."""
    return t.id in (TypeId.BINARY, TypeId.LARGE_STRING, TypeId.LARGE_BINARY,
                    TypeId.FIXED_SIZE_BINARY) or t.is_nested or (
        t.is_decimal and t.precision > 18)


def _map_tensors(batch: DeviceBatch, fn) -> DeviceBatch:
    return DeviceBatch(batch.schema, [
        DeviceColumn(fn(c.values), None if c.validity is None
                     else fn(c.validity), c.type, c.dictionary)
        for c in batch.columns], fn(batch.row_count))


def batch_to(batch: DeviceBatch, device) -> DeviceBatch:
    """``batch`` with every tensor on ``device`` (the same tensors where
    they are there already); dictionaries are shared."""
    dev = torch.device(device)
    return _map_tensors(batch, lambda t: t.to(dev))


def pin_batch(batch: DeviceBatch) -> DeviceBatch:
    """A CPU ``batch`` with every tensor in pinned (page-locked) memory, so
    a copy to the card can run asynchronously: a tensor already pinned is
    kept, any other is copied once."""
    return _map_tensors(
        batch, lambda t: t if t.is_pinned() else t.pin_memory())


def slice_rows(batch: DeviceBatch, start: int, length: int, capacity: int,
               row_count: torch.Tensor) -> DeviceBatch:
    """Rows ``[start, start + length)`` of ``batch`` at ``capacity`` on
    ``row_count``'s device, dictionaries shared. On the batch's own device
    a column is a view where ``capacity`` rows from ``start`` lie within
    its buffer (the rows past ``length`` are then padding the row count
    masks), else a copy padded with zeros and False. To another device
    each column is copied with ``non_blocking=True`` on the current
    stream, its tail zeroed: from pinned memory to the card the copy runs
    asynchronously."""
    dev = row_count.device
    same = batch.row_count.device == dev
    fits = start + capacity <= batch.capacity

    def part(t: torch.Tensor) -> torch.Tensor:
        if same and fits:
            return t[start:start + capacity]
        out = torch.empty(capacity, dtype=t.dtype, device=dev)
        out[:length].copy_(t[start:start + length], non_blocking=True)
        out[length:].zero_()
        return out

    return DeviceBatch(batch.schema, [
        DeviceColumn(part(c.values), None if c.validity is None
                     else part(c.validity), c.type, c.dictionary)
        for c in batch.columns], row_count)




def _host_values(t: DataType, values) -> np.ndarray:
    """Host values of type ``t`` -> its storage dtype's numpy array (the
    bits of an unsigned value, the unscaled integer of a decimal)."""
    store = _numpy_dtype(t)
    if t.is_decimal:
        vals = list(values)
        if vals and isinstance(vals[0], decimal.Decimal):
            return np.array([0 if v is None else int(v.scaleb(t.scale))
                             for v in vals], dtype=np.int64)
        return np.asarray(vals, dtype=np.int64)
    arr = np.asarray(values)
    if arr.dtype.kind in "mM":
        unit = {TypeId.DATE32: "D", TypeId.DATE64: "ms"}.get(
            t.id, getattr(t, "unit", None))
        kind = "datetime64" if arr.dtype.kind == "M" else "timedelta64"
        return arr.astype(f"{kind}[{unit}]").view(np.int64).astype(store)
    if t.id in (TypeId.STRING, TypeId.DICTIONARY) or t.id == TypeId.NA:
        return arr.astype(store)
    value_dtype = dtypes.dtype_of_type(t)
    return arr.astype(value_dtype).view(store)


def _numpy_dtype(t: DataType) -> np.dtype:
    return torch.empty(0, dtype=torch_dtype_for(t)).numpy().dtype


# --- the host boundary: upload ----------------------------------------------

_VAR_BINARY = (TypeId.STRING, TypeId.BINARY, TypeId.LARGE_STRING,
               TypeId.LARGE_BINARY)
_FIXED_BYTES = (TypeId.FIXED_SIZE_BINARY, TypeId.DECIMAL128,
                TypeId.DECIMAL256, TypeId.DECIMAL32, TypeId.DECIMAL64)
# the most bytes of one block of the string encoder's word matrices
_ENCODE_BLOCK_BYTES = 1 << 26


def _first_appearance(keys: np.ndarray):
    """(codes int32 in order of first appearance, the first row of each
    code) of a 1-d array of keys (``np.unique``'s types)."""
    n = len(keys)
    if n == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int64)
    if keys.dtype.kind in "iub":
        if keys.dtype.kind == "b":
            keys = keys.view(np.uint8)
        lo, hi = keys.min(), keys.max()
        if int(hi) - int(lo) <= max(n, 1 << 16):
            # a small range: each value's first row in O(n), no sort (the
            # last of repeated writes to one slot is kept, so writing the
            # rows in reverse leaves the first)
            # unsigned: subtract in its own dtype (no wrap: keys >= lo)
            k = (keys - lo).astype(np.int64) if keys.dtype.kind == "u" \
                else keys.astype(np.int64) - int(lo)
            lo, hi = 0, int(hi) - int(lo)
            first_of = np.full(hi - lo + 1, n, dtype=np.int64)
            first_of[k[::-1]] = np.arange(n - 1, -1, -1, dtype=np.int64)
            present = np.nonzero(first_of < n)[0]
            first = np.sort(first_of[present])
            rank = np.zeros(hi - lo + 1, dtype=np.int32)
            rank[k[first]] = np.arange(len(first), dtype=np.int32)
            return rank[k], first
    _, first, inverse = np.unique(keys, return_index=True,
                                  return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty(len(order), dtype=np.int32)
    rank[order] = np.arange(len(order), dtype=np.int32)
    return rank[inverse.reshape(-1)], first[order]


_GATHER_ROWS = 1 << 16   # the rows of one block of _gather_bytes


def _gather_bytes(raw: np.ndarray, starts: np.ndarray, lens: np.ndarray):
    """(offsets int64[k + 1], bytes) of the byte ranges ``[starts[i],
    starts[i] + lens[i])`` of ``raw`` laid end to end. The source index of
    each byte is made a block of _GATHER_ROWS rows at a time, so the
    index arrays stay small (twice as fast as one index array over
    millions of rows)."""
    out_offs = np.zeros(len(lens) + 1, dtype=np.int64)
    np.cumsum(lens, out=out_offs[1:])
    total = int(out_offs[-1])
    out = np.empty(total, np.uint8)
    for a in range(0, len(lens), _GATHER_ROWS):
        b = min(a + _GATHER_ROWS, len(lens))
        lo, hi = int(out_offs[a]), int(out_offs[b])
        if hi > lo:
            out[lo:hi] = raw[np.repeat(starts[a:b] - (out_offs[a:b] - lo),
                                       lens[a:b])
                             + np.arange(hi - lo, dtype=np.int64)]
    return out_offs, out


def _row_hash(words: np.ndarray) -> np.ndarray:
    """A 64-bit hash of each row of a (n, k) uint64 matrix (splitmix64's
    finalizer over the words in turn)."""
    h = np.full(words.shape[0], 0x9E3779B97F4A7C15, dtype=np.uint64)
    with np.errstate(over="ignore"):
        for j in range(words.shape[1]):
            h ^= words[:, j]
            h ^= h >> np.uint64(30)
            h *= np.uint64(0xBF58476D1CE4E5B9)
            h ^= h >> np.uint64(27)
            h *= np.uint64(0x94D049BB133111EB)
            h ^= h >> np.uint64(31)
    return h


def _windows(raw: np.ndarray, starts: np.ndarray, nb: int) -> np.ndarray:
    """A (len(starts), nb) byte matrix: the ``nb`` bytes of ``raw`` from
    each start, zero past its end."""
    cut = len(raw) - nb
    near = starts > cut
    if not near.any():
        return sliding_window_view(raw, nb)[starts]
    out = np.empty((len(starts), nb), dtype=np.uint8)
    if not near.all():
        out[~near] = sliding_window_view(raw, nb)[starts[~near]]
    t0 = max(cut, 0)
    tail = np.zeros(len(raw) - t0 + nb, dtype=np.uint8)
    tail[:len(raw) - t0] = raw[t0:]
    out[near] = sliding_window_view(tail, nb)[starts[near] - t0]
    return out


def _word_rows(raw: np.ndarray, starts: np.ndarray, lens: np.ndarray,
               width: int) -> np.ndarray:
    """A (k, width) uint64 matrix, a row a value: its length, then its
    bytes zero-padded."""
    w = np.empty((len(lens), width), dtype="<u8")
    w[:, 0] = lens
    nb = 8 * (width - 1)
    if nb:
        win = _windows(raw, starts, nb)
        win[np.arange(nb) >= lens[:, None]] = 0
        w[:, 1:] = win.view("<u8")
    return w


def _width_blocks(lens: np.ndarray):
    """(width, rows) a block: the rows whose ``_word_rows`` width is
    ``width``, the power of two of words at or above their own, cut into
    blocks of at most ``_ENCODE_BLOCK_BYTES`` (one row at least). So one
    long value widens only the rows of its own width, and equal values
    have one width."""
    words = (lens + 7) // 8 + 1
    bucket = np.searchsorted(1 << np.arange(62, dtype=np.int64), words)
    for b in np.unique(bucket).tolist():
        rows = np.nonzero(bucket == b)[0]
        per = max(1, _ENCODE_BLOCK_BYTES // (8 << b))
        for s in range(0, len(rows), per):
            yield 1 << b, rows[s:s + per]


# the codes that a producer of a string or binary Array already knows (the
# Parquet reader's, from a column's dictionary pages), by the Array's data:
# ``_encode_binary`` takes them in place of coding the bytes again
_KNOWN_CODES: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def know_codes(data: ArrayData, codes: np.ndarray, first: np.ndarray) -> None:
    """Record ``data``'s codes as ``_encode_binary`` gives them: int32 a row
    in order of first appearance of its value (a null coded as the empty
    value), and each code's first row. Kept as long as ``data`` lives."""
    _KNOWN_CODES[data] = (codes, first)


def value_codes(raw: np.ndarray, starts: np.ndarray, lens: np.ndarray):
    """(codes int32 a value in order of first appearance, each code's first
    value) of the values at ``starts`` of ``lens`` bytes in ``raw``: equal
    codes, equal bytes."""
    if len(lens) and int(lens.max()) <= 7:
        return _first_appearance(_short_keys(raw, starts, lens))
    return _codes_by_hash(raw, starts, lens)


def _encode_binary(arr: Array):
    """Codes and the dictionary tuple (str for a string type, bytes for a
    binary type) of a variable-size binary Array, in order of first
    appearance; a null row is coded as the empty value.

    Codes recorded by ``know_codes`` are taken as they are; otherwise
    values of 7 bytes or less are coded by their exact 64-bit keys
    (``_short_keys``), longer ones by a checked hash of their bytes
    (``_codes_by_hash``)."""
    d = arr.data
    mask = d.validity_mask()
    offs = d.offsets().astype(np.int64)
    raw = d.data_bytes()
    starts = offs[:-1]
    lens = offs[1:] - starts
    if mask is not None:
        lens = np.where(mask, lens, 0)
    known = _KNOWN_CODES.get(d)
    codes, first = known if known is not None else \
        value_codes(raw, starts, lens)
    uoffs, ubytes = _gather_bytes(raw, starts[first], lens[first])
    ub = ubytes.tobytes()
    bounds = uoffs.tolist()
    if arr.type.id in (TypeId.STRING, TypeId.LARGE_STRING):
        text = ub.decode("utf-8")
        if len(text) != len(ub):
            values = tuple(ub[bounds[i]:bounds[i + 1]].decode("utf-8")
                           for i in range(len(first)))
        else:
            values = tuple(text[bounds[i]:bounds[i + 1]]
                           for i in range(len(first)))
    else:
        values = tuple(ub[bounds[i]:bounds[i + 1]]
                       for i in range(len(first)))
    return codes, mask, values


def _short_keys(raw: np.ndarray, starts: np.ndarray,
                lens: np.ndarray) -> np.ndarray:
    """A uint64 key a value of at most 7 bytes: its bytes zero-padded,
    its length in the top byte; equal keys, equal values. A few distinct
    short values (a flag column's) then take ``_first_appearance``'s
    sort-free path."""
    keys = lens.astype(np.uint64) << np.uint64(56)
    last = len(raw) - 1
    for j in range(int(lens.max())):
        byte = raw[np.minimum(starts + j, last)].astype(np.uint64)
        keys |= np.where(lens > j, byte, 0) << np.uint64(8 * j)
    return keys


def _codes_by_hash(raw: np.ndarray, starts: np.ndarray, lens: np.ndarray):
    """(codes in order of first appearance, each code's first row) of the
    values at ``starts`` of ``lens`` bytes: each value's words
    (``_word_rows``) are hashed a block at a time (``_width_blocks``) and
    the rows coded by their hash. Every row is then compared with its
    code's first row; the rows of a hash that two values share are coded
    again by one ``np.unique`` over their words, so the codes are
    exact."""
    n = len(starts)
    h = np.empty(n, dtype=np.uint64)
    for width, blk in _width_blocks(lens):
        h[blk] = _row_hash(_word_rows(raw, starts[blk], lens[blk], width))
    codes, first = _first_appearance(h)
    rep = starts[first[codes]]
    bad = lens != lens[first[codes]]
    for width, blk in _width_blocks(lens):
        bad[blk] |= (_word_rows(raw, starts[blk], lens[blk], width) !=
                     _word_rows(raw, rep[blk], lens[blk], width)).any(1)
    if bad.any():
        shared = np.isin(codes, np.unique(codes[bad]))
        rows = np.nonzero(shared)[0]
        width = int(lens[rows].max() + 7) // 8 + 1
        w = _word_rows(raw, starts[rows], lens[rows], width)
        _, sub = np.unique(w.view(f"V{width * 8}").reshape(-1),
                           return_inverse=True)
        exact = np.zeros(n, dtype=np.int64)
        exact[rows] = sub.reshape(-1) + 1
        codes, first = _first_appearance(
            codes.astype(np.int64) * (int(exact.max()) + 1) + exact)
    return codes, first


def _decimal_of(row: bytes, scale: int) -> decimal.Decimal:
    return decimal.Decimal(int.from_bytes(row, "little", signed=True)
                           ).scaleb(-scale)


def _encode_fixed(arr: Array):
    """Codes and the value-sorted dictionary tuple (bytes for fixed-size
    binary, ``decimal.Decimal`` for a decimal) of a fixed-width byte type,
    as the reference's ``_dictionary_encode_fixed``: a null row is zeroed
    first, and code order is value order (bytes lexicographic, decimals by
    signed value)."""
    d = arr.data
    t = arr.type
    w = t.byte_width
    n = d.length
    mask = d.validity_mask()
    raw = np.ascontiguousarray(d.values()).reshape(n, w)
    if mask is not None:
        raw = raw.copy()
        raw[~mask] = 0
    if n == 0:
        return np.zeros(0, np.int32), mask, ()
    if t.is_decimal:
        # big-endian with the sign bit flipped: byte order is value order
        keys = raw[:, ::-1].copy()
        keys[:, 0] ^= 0x80
    else:
        keys = raw
    uniq, inverse = np.unique(keys, axis=0, return_inverse=True)
    codes = inverse.reshape(-1).astype(np.int32)
    if t.is_decimal:
        uniq = uniq.copy()
        uniq[:, 0] ^= 0x80
        uniq = uniq[:, ::-1]
        values = tuple(_decimal_of(r.tobytes(), t.scale) for r in uniq)
    else:
        values = tuple(r.tobytes() for r in uniq)
    return codes, mask, values


class HostColumn:
    """A column's device representation prepared on the host: unpadded
    numpy values in their storage dtype, an optional bool mask, the type
    and the dictionary. Preparing once and copying slices
    (``slice_upload``) lets a chunked run give every chunk the same
    dictionary object."""

    __slots__ = ("values", "mask", "type", "dictionary")

    def __init__(self, values: np.ndarray, mask: Optional[np.ndarray],
                 type: DataType, dictionary=None):
        self.values = values
        self.mask = mask
        self.type = type
        self.dictionary = dictionary

    def __len__(self):
        return len(self.values)

    @property
    def nbytes(self) -> int:
        return self.values.nbytes + (0 if self.mask is None
                                     else self.mask.nbytes)

    def slice_upload(self, start: int, length: int, capacity: int,
                     device=None) -> DeviceColumn:
        """Rows ``[start, start + length)`` as a DeviceColumn of
        ``capacity`` rows on ``device`` (the card by default), padded with
        zeros and False."""
        dev = default_device(device)
        return DeviceColumn(_padded(self.values[start:start + length],
                                    capacity, dev),
                            None if self.mask is None else
                            _padded(self.mask[start:start + length],
                                    capacity, dev),
                            self.type, self.dictionary)


def host_tensor(host: np.ndarray) -> torch.Tensor:
    """A CPU tensor over a numpy array's memory (a read-only buffer of a
    host Array is only ever read through it)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(np.ascontiguousarray(host))


def _padded(host: np.ndarray, capacity: int, dev) -> torch.Tensor:
    src = host_tensor(host)
    out = torch.empty(capacity, dtype=src.dtype, device=dev)
    out[:len(host)].copy_(src)
    out[len(host):].zero_()
    return out


def _mask_or_none(arr: Array) -> Optional[np.ndarray]:
    return None if arr.null_count == 0 else arr.data.validity_mask()


def host_column_repr(arr: Array) -> HostColumn:
    """A host Array's device representation, unpadded (reference:
    ``host_column_repr``)."""
    t = arr.type
    tid = t.id
    n = len(arr)
    if tid in _VAR_BINARY:
        codes, mask, values = _encode_binary(arr)
        return HostColumn(codes, None if arr.null_count == 0 else mask, t,
                          values)
    if tid == TypeId.DICTIONARY:
        d = arr.data
        return HostColumn(d.values().view(_numpy_dtype(t)),
                          _mask_or_none(arr), t,
                          tuple(Array(d.dictionary).to_pylist()))
    if tid == TypeId.NA:
        return HostColumn(np.zeros(n, dtype=np.int8),
                          np.zeros(n, dtype=np.bool_), t)
    if tid in _FIXED_BYTES:
        if t.is_decimal and t.precision <= 18:
            d = arr.data
            raw = d.buffers[1].to_numpy().reshape(-1, t.byte_width)[
                d.offset:d.offset + n]
            if t.byte_width >= 8:
                low = np.ascontiguousarray(raw[:, :8]).view(np.int64)
            else:
                low = np.ascontiguousarray(raw).view(
                    f"<i{t.byte_width}").astype(np.int64)
            return HostColumn(low.reshape(-1), _mask_or_none(arr), t)
        codes, mask, values = _encode_fixed(arr)
        return HostColumn(codes, None if arr.null_count == 0 else mask, t,
                          values)
    if t.is_nested:
        # passthrough: row ids, the host Array in the dictionary slot
        return HostColumn(np.arange(n, dtype=np.int32), _mask_or_none(arr),
                          t, arr)
    vals = arr.data.values()
    store = _numpy_dtype(t)
    vals = vals.view(store) if vals.dtype.itemsize == store.itemsize \
        else vals.astype(store)
    return HostColumn(vals, _mask_or_none(arr), t)


def upload_column(arr: Array, capacity: Optional[int] = None,
                  device=None) -> DeviceColumn:
    n = len(arr)
    return host_column_repr(arr).slice_upload(
        0, n, capacity if capacity is not None else round_up(n), device)


def upload_batch(batch, capacity: Optional[int] = None,
                 device=None) -> DeviceBatch:
    """A host RecordBatch as a DeviceBatch on ``device`` (the card by
    default)."""
    dev = default_device(device)
    cap = capacity if capacity is not None else round_up(batch.num_rows)
    cols = [upload_column(c, cap, dev) for c in batch.columns]
    return DeviceBatch(batch.schema, cols,
                       torch.tensor(batch.num_rows, dtype=torch.int32,
                                    device=dev))


def upload_table(tbl, capacity: Optional[int] = None,
                 device=None) -> DeviceBatch:
    """A host Table (or RecordBatch) as one DeviceBatch on ``device`` (the
    card unless ``device="cpu"`` is given), its chunks combined so that
    each column gets one dictionary."""
    from ..table import RecordBatch
    if isinstance(tbl, RecordBatch):
        return upload_batch(tbl, capacity, device)
    return upload_batch(RecordBatch(tbl.schema,
                                    [c.combine() for c in tbl.columns]),
                        capacity, device)


# --- the host boundary: download --------------------------------------------

def _dictionary_array(values: Sequence, t: DataType) -> Array:
    return make_array(list(values), t)


def _decode_binary(codes: np.ndarray, mask, dictionary, t: DataType,
                   null_count: int, vbuf) -> Array:
    """A string or binary Array of ``codes`` over ``dictionary``: the
    bytes gathered from the dictionary made an Array once, or, for fewer
    rows than the dictionary holds, the rows' values made an Array
    directly (the same buffers)."""
    if len(codes) < len(dictionary):
        # (a null dictionary value is a null row)
        rows = codes.tolist()
        ok = [True] * len(rows) if mask is None else mask.tolist()
        return make_array([dictionary[c] if v else None
                           for c, v in zip(rows, ok)], t)
    if None in dictionary:
        # a null dictionary value is a null row
        valid = np.array([v is not None for v in dictionary])[
            np.clip(codes, 0, len(dictionary) - 1)]
        mask = valid if mask is None else mask & valid
        null_count = int(len(codes) - np.count_nonzero(mask))
        vbuf = None if null_count == 0 else Buffer(bitutil.pack_bits(mask))
        if null_count == 0:
            mask = None
    dd = _dictionary_array(dictionary, T.string() if t.id in (
        TypeId.STRING, TypeId.LARGE_STRING) else T.binary()).data
    doffs = dd.offsets().astype(np.int64)
    codes = codes.astype(np.int64)
    if mask is not None:
        codes = np.where(mask, codes, 0)
    lens = doffs[codes + 1] - doffs[codes] if len(doffs) > 1 \
        else np.zeros(len(codes), np.int64)
    if mask is not None:
        lens = np.where(mask, lens, 0)
    out_offs, out = _gather_bytes(dd.data_bytes(),
                                  doffs[codes] if len(doffs) > 1 else lens,
                                  lens)
    off_dt = np.int64 if t.id in (TypeId.LARGE_STRING,
                                  TypeId.LARGE_BINARY) else np.int32
    return Array(ArrayData(t, len(codes),
                           [vbuf, Buffer(out_offs.astype(off_dt)),
                            Buffer(out)], null_count=null_count))


def _fixed_rows(dictionary, t: DataType) -> np.ndarray:
    """(len(dictionary), byte_width) uint8 rows of a value-sorted
    dictionary tuple."""
    w = t.byte_width
    if t.is_decimal:
        rows = [int(v.scaleb(t.scale)).to_bytes(w, "little", signed=True)
                for v in dictionary]
    else:
        rows = list(dictionary)
    return np.frombuffer(b"".join(rows), np.uint8).reshape(len(rows), w)


def download_column(col: DeviceColumn, n: int) -> Array:
    """A DeviceColumn's first ``n`` rows as a host Array (reference:
    ``download_column``)."""
    t = col.type
    if t.id == TypeId.NA:
        return Array(ArrayData(t, n, [], null_count=n))
    vals = col.values[:n].cpu().numpy()
    mask = None if col.validity is None else col.validity[:n].cpu().numpy()
    null_count = 0 if mask is None else int(n - np.count_nonzero(mask))
    vbuf = None if null_count == 0 else Buffer(bitutil.pack_bits(mask))
    if null_count == 0:
        mask = None
    if t.id in _VAR_BINARY:
        if col.dictionary is None:
            raise ValueError("string column missing dictionary")
        return _decode_binary(vals, mask, col.dictionary, t, null_count,
                              vbuf)
    if t.id == TypeId.DICTIONARY:
        return Array(ArrayData(
            t, n, [vbuf, Buffer(vals.view(t.index_type.to_numpy_dtype()))],
            null_count=null_count,
            dictionary=_dictionary_array(col.dictionary or (),
                                         t.value_type).data))
    if t.id == TypeId.BOOL:
        return Array(ArrayData(t, n, [vbuf, Buffer(bitutil.pack_bits(
            vals.astype(np.bool_)))], null_count=null_count))
    if col.dictionary is not None:
        codes = vals.astype(np.int64)
        if mask is not None:
            codes = np.where(mask, codes, 0)
        nd = len(col.dictionary)
        codes = np.clip(codes, 0, max(nd - 1, 0))
        if isinstance(col.dictionary, Array):
            # a nested column's row ids: the rows of its host Array
            rows = col.dictionary.to_pylist()
            return make_array([None if mask is not None and not ok
                               else rows[c] for c, ok in zip(
                                   codes.tolist(),
                                   [True] * n if mask is None
                                   else mask.tolist())], t)
        w = t.byte_width
        rows = _fixed_rows(col.dictionary, t)[codes] if nd \
            else np.zeros((n, w), np.uint8)
        return Array(ArrayData(t, n, [vbuf, Buffer(
            np.ascontiguousarray(rows).reshape(-1))],
            null_count=null_count))
    if t.is_decimal:
        w = t.byte_width
        low = vals.astype(np.int64)
        if w < 8:
            raw = low.astype(f"<i{w}").view(np.uint8).reshape(n, w)
        else:
            raw = np.empty((n, w), dtype=np.uint8)
            raw[:, :8] = low.view(np.uint8).reshape(n, 8)
            raw[:, 8:] = np.where(low[:, None] < 0, 0xFF, 0).astype(np.uint8)
        return Array(ArrayData(t, n, [vbuf, Buffer(raw.reshape(-1))],
                               null_count=null_count))
    target = t.to_numpy_dtype()
    if vals.dtype != target:
        vals = vals.view(target) if vals.dtype.itemsize == target.itemsize \
            and vals.dtype.kind in "iu" and target.kind in "iu" \
            else vals.astype(target)
    return Array(ArrayData(t, n, [vbuf, Buffer(vals)],
                           null_count=null_count))


def host_take(arr: Array, idx: np.ndarray,
              valid: Optional[np.ndarray] = None,
              decode: bool = True) -> Array:
    """Rows ``idx`` of a host Array (null where ``valid`` is False), by
    one gather over its device representation on the CPU: no loop over
    the rows in Python. A dictionary array is decoded to its values unless
    ``decode`` is False."""
    from ..compute.selection import gather_columns
    if arr.type.id == TypeId.DICTIONARY and decode:
        d = arr.data
        codes = d.values().astype(np.int64)[idx]
        ok = arr.is_valid_mask()[idx]
        valid = ok if valid is None else valid & ok
        arr, idx = Array(d.dictionary), codes
    col = upload_column(arr, device="cpu")
    out = gather_columns([col], torch.from_numpy(np.asarray(idx, np.int64)),
                         None if valid is None else torch.from_numpy(
                             np.asarray(valid, np.bool_)))[0]
    return download_column(out, len(idx))


def download_batch(batch: DeviceBatch):
    """The live rows of a DeviceBatch as a host RecordBatch."""
    from ..table import RecordBatch
    n = int(batch.row_count)
    cols = [download_column(c, n) for c in batch.columns]
    return RecordBatch(Schema([Field(f.name, c.type, f.nullable)
                               for f, c in zip(batch.schema.fields, cols)]),
                       cols)


def download_table(batch: DeviceBatch):
    """The live rows of a DeviceBatch as a host Table."""
    from ..table import Table
    return Table.from_batches([download_batch(batch)])


def download(batch: DeviceBatch) -> Dict[str, List]:
    """The live rows as Python lists by column name:
    ``download_table(batch).to_pydict()``."""
    return download_table(batch).to_pydict()
