"""The device tier of the nested functions (counterpart of
``arrow_tpu/compute/device_nested.py``; reference: scalar_nested.cc,
vector_nested.cc and vector_run_end_encode.cc, loops over offset buffers).

A list column with offsets gets a device form (``ListDev``): its offsets
rebased to 0 (int32, int64 for a large list), its lengths, and its child's
values and validity as ``device/column.py`` uploads them (a string or
dictionary child as codes over its dictionary). The form is kept weakly a
host ``ArrayData`` and a device, as ``acero/source_cache.py`` keeps a
host column's uploads, so repeated functions over one column upload it
once. Over it run

* ``list_value_length``: the lengths, under the parent's validity;
* ``list_parent_indices``: ``searchsorted`` of each child position over
  the offsets (the lengths of null parents taken as 0, so their slots are
  left out, as the reference's host tier leaves them out);
* ``list_flatten``: the child's values and validity compacted in one
  launch of the compaction kernel (K2), keeping a slot where its parent is
  valid; without null parents, the child itself and no launch;
* ``list_element``: one gather at ``offsets[:-1] + index``;
* ``run_end_decode``: ``searchsorted`` of each logical position over the
  run ends, then one gather of the values and their validity.

Each entry point takes a host Array and the call's ``device`` (the card
unless ``device="cpu"``) and gives a host Array, or None where the
reference takes its host tier (``host_kernels.py``): a child with no
device form (a list of lists, an interval), ``list_element`` of an empty
child, a run-end array of no runs. Where the device tier applies it runs
on ``device`` or raises; it does not fall back to the host. The
reference's ``ARROW_TPU_DEVICE_NESTED`` gate, which keeps its CPU backend
on the host tier, is not ported.
"""

from __future__ import annotations

import weakref
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import default_device, dtypes
from .. import types as T
from ..array.array import Array
from ..device.column import (DeviceColumn, download_column,
                             host_column_repr, round_up)
from ..types import TypeId

_CODED = (TypeId.STRING, TypeId.BINARY, TypeId.LARGE_STRING,
          TypeId.LARGE_BINARY, TypeId.DICTIONARY)


class ListDev(NamedTuple):
    offsets: torch.Tensor   # (n + 1,) int32 (int64 for a large list), from 0
    lens: torch.Tensor      # (n,) of the offsets' dtype
    child: DeviceColumn     # the child's rows [offsets[0], offsets[-1])
    n: int
    total: int              # the child's rows, offsets[-1]


# ArrayData -> {device: ListDev}
_REPRS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def list_layout(arr: Array):
    """(offsets[n + 1] int64, child Array) of a list, large list, map or
    fixed-size list, the offsets absolute child positions with the parent's
    slice applied; None for any other type."""
    tid = arr.type.id
    d = arr.data
    if tid in (TypeId.LIST, TypeId.LARGE_LIST, TypeId.MAP):
        return np.asarray(d.offsets(), dtype=np.int64), Array(d.children[0])
    if tid == TypeId.FIXED_SIZE_LIST:
        k = arr.type.list_size
        return (d.offset * k + np.arange(len(arr) + 1, dtype=np.int64) * k,
                Array(d.children[0]))
    return None


def has_device_form(child: Array) -> bool:
    """Whether a child has a device representation (not nested in nested,
    not an interval)."""
    if child.type.id in _CODED:
        return True
    try:
        dtypes.dtype_of_type(child.type)
    except NotImplementedError:
        return False
    return not child.type.is_nested


def _parent_valid(arr: Array, dev) -> Optional[torch.Tensor]:
    m = arr.data.validity_mask()
    return None if m is None else torch.from_numpy(
        np.ascontiguousarray(m)).to(dev)


def list_device(arr: Array, device=None) -> Optional[ListDev]:
    """The device form of a list column on ``device``, made once an
    ArrayData and device; None where the child has none."""
    lay = list_layout(arr)
    if lay is None:
        return None
    offs, child = lay
    if not has_device_form(child):
        return None
    dev = default_device(device)
    per = _REPRS.setdefault(arr.data, {})
    hit = per.get(str(dev))
    if hit is not None:
        return hit
    base = int(offs[0])
    wide = arr.type.id == TypeId.LARGE_LIST
    offs0 = torch.from_numpy(
        (offs - base).astype(np.int64 if wide else np.int32)).to(dev)
    total = int(offs[-1]) - base
    ld = ListDev(offs0, offs0[1:] - offs0[:-1],
                 host_column_repr(child).slice_upload(base, total,
                                                      round_up(total), dev),
                 len(arr), total)
    per[str(dev)] = ld
    return ld


def _download(ld: ListDev, values, validity, n: int) -> Array:
    return download_column(DeviceColumn(values, validity, ld.child.type,
                                        ld.child.dictionary), n)


def list_value_length(arr: Array, device=None) -> Optional[Array]:
    ld = list_device(arr, device)
    if ld is None:
        return None
    valid = _parent_valid(arr, ld.lens.device)
    return download_column(DeviceColumn(ld.lens.to(torch.int32), valid,
                                        T.int32()), ld.n)


def list_parent_indices(arr: Array, device=None) -> Optional[Array]:
    ld = list_device(arr, device)
    if ld is None:
        return None
    lens = ld.lens.to(torch.int64)
    valid = _parent_valid(arr, lens.device)
    if valid is not None:
        lens = torch.where(valid, lens, 0)
    ends = torch.cumsum(lens, 0)
    total = int(ends[-1]) if ld.n else 0
    pos = torch.arange(total, dtype=torch.int64, device=lens.device)
    parents = torch.searchsorted(ends, pos, right=True)
    return download_column(DeviceColumn(parents, None, T.int64()), total)


def list_flatten(arr: Array, device=None) -> Optional[Array]:
    """The valid parents' child slots in order: one compaction (K2) of the
    child's values and validity by the parent validity of each slot. With
    no null parent, the child's rows themselves, with no launch."""
    lay = list_layout(arr)
    if lay is None or not has_device_form(lay[1]):
        return None
    offs, child = lay
    if arr.null_count == 0:
        default_device(device)
        return child.slice(int(offs[0]), int(offs[-1] - offs[0]))
    ld = list_device(arr, device)
    from .selection import compact_columns
    c = ld.child
    pos = torch.arange(c.capacity, dtype=ld.offsets.dtype,
                       device=c.values.device)
    parents = torch.searchsorted(ld.offsets, pos, right=True) - 1
    valid = _parent_valid(arr, c.values.device)
    keep = valid[parents.clamp(0, ld.n - 1)] & (pos < ld.total)
    (out,), count = compact_columns([c], keep)
    return _download(ld, out.values, out.validity, int(count))


def list_element(arr: Array, index: int, device=None) -> Optional[Array]:
    if index < 0:
        from .registry import ArrowInvalid
        raise ArrowInvalid(f"list_element: index {index} is negative "
                           "(take: index out of bounds)")
    lay = list_layout(arr)
    if lay is None or not has_device_form(lay[1]) \
            or lay[0][-1] == lay[0][0]:
        return None  # no device form, or nothing to gather
    ld = list_device(arr, device)
    c = ld.child
    pos = ld.offsets[:-1].to(torch.int64) + index
    ok = index < ld.lens
    safe = pos.clamp(0, max(ld.total - 1, 0))
    if c.validity is not None:
        ok = ok & c.validity[safe]
    valid = _parent_valid(arr, ok.device)
    if valid is not None:
        ok = ok & valid
    return _download(ld, c.values[safe], ok, ld.n)


def run_end_decode_device(arr: Array, device=None) -> Optional[Array]:
    """The logical rows of a run-end encoded array: positions ``offset ..
    offset + length`` searched over the run ends, values and validity
    gathered by run."""
    if arr.type.id != TypeId.RUN_END_ENCODED:
        return None
    d = arr.data
    values = Array(d.children[1])
    ends = np.asarray(d.children[0].values(), np.int64)
    if len(ends) == 0 or d.length == 0 or not has_device_form(values):
        return None
    dev = default_device(device)
    hc = host_column_repr(values)
    col = hc.slice_upload(0, len(values), len(values), dev)
    pos = torch.arange(d.offset, d.offset + d.length, dtype=torch.int64,
                       device=dev)
    run = torch.searchsorted(torch.from_numpy(ends).to(dev), pos,
                             right=True).clamp(0, len(ends) - 1)
    return download_column(DeviceColumn(
        col.values[run], None if col.validity is None else col.validity[run],
        hc.type, hc.dictionary), d.length)
