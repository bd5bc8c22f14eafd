"""The device state of host table sources, kept a column.

A host column (``ChunkedArray``) that a table source reads gets, at most
once each: its device representation prepared on the host (``HostColumn``),
its upload to each device (or a rank's range of rows to its device, in a
distributed run), and its page-locked copy for a chunked run on the
card. Every source that holds the column, a narrowed one or a repeated
run's, shares these, so its dictionary and its codes stay one object and a
second run uploads nothing.

A RecordBatch that a source reads is held as one Table, made once a batch
(``table_of``), so its columns too are uploaded once however many sources
or runs read it.

The maps hold the column weakly: an entry goes with the column, when the
user's Table is dropped. ``release(table)`` drops a Table's entries sooner,
and ``release()`` every entry, freeing the card memory and the page-locked
memory they hold (an SF10 lineitem holds about 5.5 GB of each).

Plans may run on several threads at once (a Flight server's handlers):
a column's entries are made under the column's own lock, so a column is
prepared, uploaded and counted in ``UPLOAD_STATS`` once however many
threads ask for it, while threads that read other columns go on.
"""

from __future__ import annotations

import threading
import weakref
from typing import Dict

from ..device.column import DeviceColumn, HostColumn, host_column_repr, \
    host_tensor, round_up

_prepared: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_uploads: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_pinned: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_tables: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
# a column's lock, held while an entry of the column is looked up and made
_column_locks: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
# held while a column's lock, a batch's Table or UPLOAD_STATS is made or
# changed, and while release() clears the maps
_LOCK = threading.Lock()


def _column_lock(col) -> "threading.RLock":
    with _LOCK:
        lock = _column_locks.get(col)
        if lock is None:
            lock = _column_locks[col] = threading.RLock()
        return lock


def table_of(batch):
    """A RecordBatch's one-batch Table, made once a batch."""
    from ..table import Table
    with _LOCK:
        tbl = _tables.get(batch)
        if tbl is None:
            tbl = _tables[batch] = Table.from_batches([batch])
        return tbl


def prepared_column(col) -> HostColumn:
    """``col``'s device representation on the host, made once."""
    with _column_lock(col):
        hc = _prepared.get(col)
        if hc is None:
            hc = _prepared[col] = host_column_repr(col.combine())
        return hc


# the rows and padded bytes of the uploads made (``reset_upload_stats``)
UPLOAD_STATS = {"rows": 0, "bytes": 0}


def reset_upload_stats() -> None:
    for k in UPLOAD_STATS:
        UPLOAD_STATS[k] = 0


def uploaded_column(col, dev, rows=None) -> DeviceColumn:
    """``col``'s rows ``rows`` = (start, stop) (all of them where None)
    uploaded to the torch device ``dev``, padded to ``round_up`` of their
    count, made once a device and range. The values come from the column's
    one prepared form, so every range of it shares its dictionary and its
    codes."""
    start, stop = (0, len(col)) if rows is None else rows
    key = str(dev) if rows is None else f"{dev}[{start}:{stop}]"
    with _column_lock(col):
        per_device: Dict[str, DeviceColumn] = _uploads.setdefault(col, {})
        if key not in per_device:
            n = stop - start
            out = per_device[key] = prepared_column(col).slice_upload(
                start, n, round_up(n), dev)
            with _LOCK:
                UPLOAD_STATS["rows"] += n
                UPLOAD_STATS["bytes"] += out.values.numel() * \
                    out.values.element_size() + (0 if out.validity is None
                                                 else out.validity.numel())
        return per_device[key]


def host_column(col, pinned: bool) -> DeviceColumn:
    """``col``'s prepared values as an unpadded CPU DeviceColumn: over
    their numpy memory, or, ``pinned``, copied once into page-locked
    memory for copies to the card."""
    with _column_lock(col):
        if pinned and col in _pinned:
            return _pinned[col]
        hc = prepared_column(col)
        out = DeviceColumn(host_tensor(hc.values),
                           None if hc.mask is None else host_tensor(hc.mask),
                           hc.type, hc.dictionary)
        if pinned:
            out = _pinned[col] = DeviceColumn(
                out.values.pin_memory(),
                None if out.validity is None else out.validity.pin_memory(),
                out.type, out.dictionary)
        return out


def release(table=None) -> None:
    """Drop the cached state of ``table``'s columns (a Table or a
    RecordBatch), or of every column when ``table`` is None. A later run
    of a source over them prepares and uploads them anew, with new
    dictionary objects."""
    from ..table import RecordBatch
    maps = (_prepared, _uploads, _pinned)
    with _LOCK:
        if table is None:
            for m in maps + (_tables,):
                m.clear()
            return
        if isinstance(table, RecordBatch):
            table = _tables.pop(table, None)
            if table is None:
                return
        for col in table.columns:
            for m in maps:
                m.pop(col, None)
