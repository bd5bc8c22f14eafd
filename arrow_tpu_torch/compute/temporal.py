"""Temporal functions (counterpart of ``arrow_tpu/compute/temporal.py``):
calendar and clock fields, ISO and US weeks, the ``*_between`` of days,
hours and years, and ``assume_timezone``, over date32, date64, timestamps
(s, ms, us, ns), time32, time64 and durations.

Every value becomes (days since the epoch, microseconds within the day)
in int64 (``to_days_and_us``), ns flooring to us as in the reference;
calendar fields decompose the days by Howard Hinnant's branch-free
``civil_from_days``. torch's ``//`` and ``%`` on integer tensors floor,
as ``jnp.floor_divide`` and ``jnp`` ``%`` do (``torch.fmod`` would not),
so days before 1970 and negative durations decompose as the reference's.
Results are int64 (bool for the predicates) under the input's validity,
the values of null rows computed like any other, as the reference's are.
``strftime`` and ``strptime`` run on the host (``host_kernels.py``).
"""

from __future__ import annotations

import torch

from .. import types as T
from ..device.column import DeviceColumn
from ..types import TypeId
from .elementwise import _and_validity
from .registry import register

_US = {"s": 1_000_000, "ms": 1_000, "us": 1}
US_PER_DAY = 86_400_000_000


def to_days_and_us(col: DeviceColumn):
    """(days since the epoch, microseconds within the day), int64."""
    t = col.type
    v = col.values.to(torch.int64)
    if t.id == TypeId.DATE32:
        return v, torch.zeros_like(v)
    if t.id == TypeId.DATE64:
        us = v * 1000
    elif t.id in (TypeId.TIMESTAMP, TypeId.TIME32, TypeId.TIME64,
                  TypeId.DURATION):
        us = v // 1000 if t.unit == "ns" else v * _US[t.unit]
    else:
        raise ValueError(f"not a temporal column: {t!r}")
    days = us // US_PER_DAY
    return days, us - days * US_PER_DAY


def civil_from_days(days: torch.Tensor):
    """(year, month, day, day of the March-based year) of int64 days
    since 1970-01-01."""
    z = days + 719468
    era = z // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    return torch.where(m <= 2, y + 1, y), m, d, doy


def days_from_civil(y: torch.Tensor, m: torch.Tensor, d) -> torch.Tensor:
    """Days since 1970-01-01 of a (year, month, day)."""
    y = y - (m <= 2).to(y.dtype)
    era = y // 400
    yoe = y - era * 400
    doy = (153 * torch.where(m > 2, m - 3, m + 9) + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def iso_year_week(days: torch.Tensor):
    """(ISO year, ISO week): the Thursday of a day's week decides its
    year."""
    thursday = days - (days + 3) % 7 + 3
    iso_y = civil_from_days(thursday)[0]
    jan1 = days_from_civil(iso_y, torch.ones_like(iso_y), 1)
    return iso_y, (thursday - jan1) // 7 + 1


def _out(col, values, type_=None) -> DeviceColumn:
    return DeviceColumn(values, col.validity, type_ or T.int64())


def _field(name: str, compute):
    @register(name, "elementwise")
    def _fn(ctx, col):
        days, us = to_days_and_us(col)
        return _out(col, compute(days, us))
    return _fn


_field("year", lambda d, u: civil_from_days(d)[0])
_field("month", lambda d, u: civil_from_days(d)[1])
_field("day", lambda d, u: civil_from_days(d)[2])
_field("hour", lambda d, u: u // 3_600_000_000)
_field("minute", lambda d, u: u // 60_000_000 % 60)
_field("second", lambda d, u: u // 1_000_000 % 60)
_field("millisecond", lambda d, u: u // 1000 % 1000)
_field("microsecond", lambda d, u: u % 1000)
_field("quarter", lambda d, u: (civil_from_days(d)[1] - 1) // 3 + 1)
_field("day_of_year", lambda d, u: d - days_from_civil(
    civil_from_days(d)[0], torch.ones_like(d), 1) + 1)
_field("iso_year", lambda d, u: iso_year_week(d)[0])
_field("iso_week", lambda d, u: iso_year_week(d)[1])
# the reference's US week: the ISO computation shifted one day
_field("us_week", lambda d, u: iso_year_week(d + 1)[1])


@register("nanosecond", "elementwise")
def nanosecond(ctx, col):
    """The nanoseconds within the microsecond: 0 but for an ns unit."""
    t = col.type
    if t.id in (TypeId.TIMESTAMP, TypeId.TIME64, TypeId.DURATION) \
            and t.unit == "ns":
        return _out(col, col.values.to(torch.int64) % 1000)
    return _out(col, torch.zeros(col.capacity, dtype=torch.int64,
                                 device=col.values.device))


@register("day_of_week", "elementwise")
def day_of_week(ctx, col, count_from_zero: bool = True, week_start: int = 1):
    days, _ = to_days_and_us(col)
    # 1970-01-01 was a Thursday, 3 counted from Monday
    shifted = ((days + 3) % 7 - (week_start - 1)) % 7
    return _out(col, shifted if count_from_zero else shifted + 1)


@register("is_leap_year", "elementwise")
def is_leap_year(ctx, col):
    days, _ = to_days_and_us(col)
    y = civil_from_days(days)[0]
    return _out(col, ((y % 4 == 0) & (y % 100 != 0)) | (y % 400 == 0),
                T.bool_())


@register("is_dst", "elementwise")
def is_dst(ctx, col):
    """Always false: values are stored as UTC (the reference's rule)."""
    return _out(col, torch.zeros(col.capacity, dtype=torch.bool,
                                 device=col.values.device), T.bool_())


def between_columns(a, b, compute, out_type=None) -> DeviceColumn:
    """``compute(days_a, us_a, days_b, us_b)`` under both inputs'
    validity."""
    da, ua = to_days_and_us(a)
    db, ub = to_days_and_us(b)
    return DeviceColumn(compute(da, ua, db, ub),
                        _and_validity(a.validity, b.validity),
                        out_type or T.int64())


def between(name: str, compute, out_type=None):
    """Register ``name(a, b)`` as ``between_columns`` of ``compute``."""
    @register(name, "elementwise")
    def _fn(ctx, a, b):
        return between_columns(a, b, compute, out_type)
    return _fn


between("years_between", lambda da, ua, db, ub:
        civil_from_days(db)[0] - civil_from_days(da)[0])
between("days_between", lambda da, ua, db, ub: db - da)
between("hours_between", lambda da, ua, db, ub:
        (db - da) * 24 + (ub - ua) // 3_600_000_000)


@register("assume_timezone", "elementwise")
def assume_timezone(ctx, col, timezone: str = "UTC", **_):
    """Relabels the timestamp's zone; the stored values stay."""
    if col.type.id != TypeId.TIMESTAMP:
        raise ValueError("assume_timezone needs a timestamp")
    return DeviceColumn(col.values, col.validity,
                        T.timestamp(col.type.unit, timezone))

