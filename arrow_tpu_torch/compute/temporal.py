"""Calendar fields of date32 columns: ``year``, ``month`` and ``day``
(counterpart of ``arrow_tpu/compute/temporal.py``).

Each decomposes days since the epoch by Howard Hinnant's branch-free
``civil_from_days``, in int64 with floor division (torch's ``//`` on
integer tensors floors, as ``jnp.floor_divide`` does, so days before 1970
decompose right). The result is int64, null where the input is null.
The other temporal functions, and these over the other temporal types,
are not ported (ROADMAP.md, queue 1, item 9.8).
"""

from __future__ import annotations

import torch

from .. import types as T
from ..device.column import DeviceColumn
from ..types import TypeId
from .registry import register


def civil_from_days(days: torch.Tensor):
    """(year, month, day) of int64 days since 1970-01-01."""
    z = days + 719468
    era = z // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    return torch.where(m <= 2, y + 1, y), m, d


def _calendar_field(name: str, index: int):
    @register(name, "elementwise")
    def _fn(ctx, col: DeviceColumn) -> DeviceColumn:
        if not isinstance(col, DeviceColumn) or col.type.id != TypeId.DATE32:
            raise NotImplementedError(
                f"{name} of anything but a date32 column is not ported yet "
                "(ROADMAP.md, queue 1, item 9.8: temporal and strings)")
        out = civil_from_days(col.values.to(torch.int64))[index]
        return DeviceColumn(out, col.validity, T.int64())
    return _fn


year = _calendar_field("year", 0)
month = _calendar_field("month", 1)
day = _calendar_field("day", 2)
