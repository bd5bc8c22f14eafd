"""Device-resident columnar data (counterpart of ``arrow_tpu/device/column.py``).

* values: a padded, fixed-capacity tensor on the device
* validity: an optional bool mask tensor (a byte mask, not packed bits)
* strings are dictionary codes: kernels see int32 codes, and the
  dictionary (a tuple of Python values) stays on the host
* a DeviceBatch carries its ``row_count`` as a 0-d tensor beside the static
  capacity, so a data-dependent size (the number of groups) needs no
  device-to-host copy until the result is downloaded.
"""

from __future__ import annotations

import datetime
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import default_device
from .. import types as T
from ..types import DataType, Field, Schema, TypeId

# Row capacities are padded to a multiple of this.
BLOCK = 1024


def round_up(n: int, m: int = BLOCK) -> int:
    return max(m, (n + m - 1) // m * m)


def capacity_class(n: int) -> int:
    """A data-dependent output size (join matches) rounded up to its
    power-of-two capacity class, at least BLOCK."""
    return max(BLOCK, 1 << (max(n, 1) - 1).bit_length())


_TORCH_DTYPES = {
    TypeId.BOOL: torch.bool,
    TypeId.INT32: torch.int32, TypeId.INT64: torch.int64,
    # uint64 as its int64 bit pattern
    TypeId.UINT64: torch.int64,
    TypeId.FLOAT: torch.float32, TypeId.DOUBLE: torch.float64,
    TypeId.DATE32: torch.int32,
}


def torch_dtype_for(t: DataType) -> torch.dtype:
    if t.id == TypeId.DICTIONARY:
        return _TORCH_DTYPES[t.index_type.id]
    if t.id == TypeId.STRING:
        return torch.int32  # dictionary codes
    if t.id in _TORCH_DTYPES:
        return _TORCH_DTYPES[t.id]
    raise NotImplementedError(f"no device representation for {t!r}")


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

    ``columns`` holds ``(name, type_name, values, validity_or_None,
    dictionary_values_or_None)`` per column (type names as in
    ``types.type_for_name``). Values are padded with zeros, and validity
    with False, to ``round_up`` of the longest column."""
    dev = default_device(device)
    cap = round_up(max([row_count] + [len(c[2]) for c in columns]))
    fields, cols = [], []
    for name, type_name, values, validity, dictionary in columns:
        t = T.type_for_name(type_name)
        vals = np.zeros(cap, dtype=_numpy_dtype(t))
        vals[:len(values)] = values
        mask = None
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


def _numpy_dtype(t: DataType) -> np.dtype:
    return torch.empty(0, dtype=torch_dtype_for(t)).numpy().dtype


_EPOCH = datetime.date(1970, 1, 1)


def download(batch: DeviceBatch) -> Dict[str, List]:
    """The live rows as Python lists by column name: None for nulls,
    dictionary codes decoded, date32 as ``datetime.date``."""
    n = int(batch.row_count)
    out = {}
    for f, c in zip(batch.schema.fields, batch.columns):
        vals = c.values[:n].cpu().numpy()
        mask = (np.ones(n, dtype=np.bool_) if c.validity is None
                else c.validity[:n].cpu().numpy())
        if c.dictionary is not None:
            py = [c.dictionary[int(v)] for v in np.where(mask, vals, 0)]
        elif f.type.id == TypeId.DATE32:
            py = [_EPOCH + datetime.timedelta(days=int(v)) for v in vals]
        elif f.type.id == TypeId.UINT64:
            py = vals.view(np.uint64).tolist()
        else:
            py = vals.tolist()
        out[f.name] = [v if ok else None for v, ok in zip(py, mask)]
    return out
