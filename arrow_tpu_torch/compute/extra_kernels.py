"""The temporal and string functions of the reference's long-tail module
(counterpart of part of ``arrow_tpu/compute/extra_kernels.py``):
``subsecond``, ``local_timestamp``, ``floor_temporal``/``ceil_temporal``/
``round_temporal``, ``week``, ``us_year``, the ``*_between`` of seconds
down to nanoseconds, weeks, quarters and months; ``ascii_is_printable``,
``ascii_is_title``, ``utf8_zero_fill``, ``utf8_normalize``,
``binary_slice``, the two ``*_replace_slice`` functions, the counts and
finds of a regex, and the reference's ``ascii_*`` aliases of the trims and
of center.

The rest of the reference module (``hypot``, ``round_binary``,
``indices_nonzero``, ``winsorize``, the two ranks, ``tdigest`` and the
grouped ``tdigest``, ``first_last``, ``skew``, ``kurtosis`` and
``approximate_median``) is ROADMAP.md queue 1 item 9.9; its host-tier
functions (``iso_calendar``, ``extract_regex``, the interval
``*_between``, ...) are item 11.
"""

from __future__ import annotations

import re
import unicodedata
from typing import Optional

import numpy as np
import torch

from .. import types as T
from ..device.column import DeviceColumn
from ..types import TypeId
from .registry import register
from .strings import (_alias, _str_to_bool, _string, host_table,
                      require_string, slot_lookup, transform)
from .temporal import (US_PER_DAY, between, between_columns, civil_from_days,
                       days_from_civil, iso_year_week, to_days_and_us)

# --- temporal: subsecond, local time, rounding -------------------------------


@register("subsecond", "elementwise")
def subsecond(ctx, col):
    """The fraction of the second, f64 (to the microsecond)."""
    _, us = to_days_and_us(col)
    # the remainder in integers, and a tensor divisor: the card divides by
    # a Python float through its reciprocal, off by an ulp
    million = torch.tensor(1e6, dtype=torch.float64, device=us.device)
    return DeviceColumn((us % 1_000_000).to(torch.float64) / million,
                        col.validity, T.float64())


_PER_SECOND = {"s": 1, "ms": 10 ** 3, "us": 10 ** 6, "ns": 10 ** 9}


@register("local_timestamp", "elementwise")
def local_timestamp(ctx, col):
    """The timestamp without its zone: a fixed offset (``+05:30``) shifts
    the values, a named zone counts as UTC (the reference has no zone
    data on its device)."""
    if col.type.id != TypeId.TIMESTAMP:
        raise ValueError("local_timestamp needs a timestamp")
    tz = col.type.tz
    shift = 0
    if tz and tz[0] in "+-" and ":" in tz:
        hh, mm = tz[1:].split(":")
        shift = (1 if tz[0] == "+" else -1) * (int(hh) * 3600 + int(mm) * 60)
    unit = col.type.unit
    return DeviceColumn(col.values + shift * _PER_SECOND[unit], col.validity,
                        T.timestamp(unit))


_UNIT_US = {"microsecond": 1, "millisecond": 1_000, "second": 1_000_000,
            "minute": 60_000_000, "hour": 3_600_000_000,
            "day": US_PER_DAY, "week": 7 * US_PER_DAY}
_MONTHS = {"month": 1, "quarter": 3, "year": 12}
_ROUNDABLE = (TypeId.TIMESTAMP, TypeId.DATE32, TypeId.DATE64, TypeId.TIME32,
              TypeId.TIME64)


def _round_temporal(col, mode, multiple, unit, week_starts_monday):
    """``col`` floored, ceiled or rounded (a tie rounds up) to ``multiple``
    ``unit``s, in its own type. Sub-month units count from the epoch
    (weeks from the configured start day); months, quarters and years from
    month 0 of year 0. A ceil of a value on a month boundary moves to the
    next one, as in the reference."""
    t = col.type
    if t.id not in _ROUNDABLE:
        raise ValueError(f"cannot round {t!r}")
    days, us_in_day = to_days_and_us(col)
    total = days * US_PER_DAY + us_in_day
    if unit in _UNIT_US:
        step = _UNIT_US[unit] * int(multiple)
        # 1970-01-01 was a Thursday: weeks start 4 (Monday) or 3 (Sunday)
        # days before it
        anchor = (4 if week_starts_monday else 3) * US_PER_DAY \
            if unit == "week" else 0
        total = total + anchor
        lo = total // step * step
        if mode == "floor":
            out = lo
        elif mode == "ceil":
            out = torch.where(total == lo, lo, lo + step)
        else:
            out = torch.where(total - lo < lo + step - total, lo, lo + step)
        out = out - anchor
    elif unit in _MONTHS:
        y, m, _, _ = civil_from_days(days)
        per = _MONTHS[unit] * int(multiple)
        lo_idx = (y * 12 + m - 1) // per * per
        hi_idx = lo_idx + per
        lo = days_from_civil(lo_idx // 12, lo_idx % 12 + 1, 1) * US_PER_DAY
        hi = days_from_civil(hi_idx // 12, hi_idx % 12 + 1, 1) * US_PER_DAY
        if mode == "floor":
            out = lo
        elif mode == "ceil":
            out = hi
        else:
            out = torch.where(total - lo < hi - total, lo, hi)
    else:
        raise ValueError(f"bad round unit {unit!r}")
    if t.id == TypeId.DATE32:
        out = out // US_PER_DAY
    elif t.id == TypeId.DATE64:
        out = out // 1000
    elif t.unit == "ns":
        out = out * 1000
    else:
        out = out // {"s": 1_000_000, "ms": 1000, "us": 1}[t.unit]
    return DeviceColumn(out.to(col.values.dtype), col.validity, t)


def _rounding(name: str, mode: str):
    @register(name, "elementwise")
    def _fn(ctx, col, multiple: int = 1, unit: str = "day",
            week_starts_monday: bool = True,
            ceil_is_strictly_greater: bool = False,
            calendar_based_origin: bool = False):
        """The last two options are taken and ignored, as in the
        reference."""
        return _round_temporal(col, mode, multiple, unit, week_starts_monday)
    return _fn


_rounding("floor_temporal", "floor")
_rounding("ceil_temporal", "ceil")
_rounding("round_temporal", "round")


@register("week", "elementwise")
def week(ctx, col, week_starts_monday: bool = True,
         count_from_zero: bool = False,
         first_week_is_fully_in_year: bool = False):
    """The ISO week of the day (one day later where weeks start on
    Sunday); with ``first_week_is_fully_in_year`` one less where January
    1st does not start a week, as the reference shifts it."""
    days, _ = to_days_and_us(col)
    shift = 0 if week_starts_monday else 1
    wk = iso_year_week(days + shift)[1]
    if first_week_is_fully_in_year:
        y = civil_from_days(days)[0]
        jan1 = days_from_civil(y, torch.ones_like(y), 1)
        wk = torch.where((jan1 + 3 + shift) % 7 != 0, wk - 1, wk)
    if count_from_zero:
        wk = wk - 1
    return DeviceColumn(wk, col.validity, T.int64())


@register("us_year", "elementwise")
def us_year(ctx, col):
    """The reference's US week-numbering year: the ISO year of the next
    day."""
    days, _ = to_days_and_us(col)
    return DeviceColumn(iso_year_week(days + 1)[0], col.validity, T.int64())


# --- temporal: *_between -----------------------------------------------------

def _span_us(da, ua, db, ub):
    return (db - da) * US_PER_DAY + ub - ua


between("seconds_between",
        lambda da, ua, db, ub: _span_us(da, ua, db, ub) // 1_000_000)
between("minutes_between",
        lambda da, ua, db, ub: _span_us(da, ua, db, ub) // 60_000_000)
between("milliseconds_between",
        lambda da, ua, db, ub: _span_us(da, ua, db, ub) // 1000)
between("microseconds_between", _span_us)
# the span in microseconds times 1000: the nanoseconds are lost
between("nanoseconds_between",
        lambda da, ua, db, ub: _span_us(da, ua, db, ub) * 1000)


def _quarter_index(days):
    y, m, _, _ = civil_from_days(days)
    return y * 4 + (m - 1) // 3


def _month_index(days):
    y, m, _, _ = civil_from_days(days)
    return y * 12 + m


between("quarters_between",
        lambda da, ua, db, ub: _quarter_index(db) - _quarter_index(da))
between("month_interval_between",
        lambda da, ua, db, ub: (_month_index(db)
                                - _month_index(da)).to(torch.int32),
        T.month_interval())


@register("weeks_between", "elementwise")
def weeks_between(ctx, a, b, count_from_zero: bool = True,
                  week_start: int = 1):
    """Week starts crossed from a to b (weeks starting on ``week_start``,
    1 = Monday); ``count_from_zero`` is taken and ignored, as in the
    reference."""
    ws = week_start - 1
    return between_columns(
        a, b, lambda da, ua, db, ub: (db + 3 - ws) // 7 - (da + 3 - ws) // 7)


# --- strings -----------------------------------------------------------------

for _alias_name, _name in (
        ("ascii_ltrim", "utf8_ltrim"), ("ascii_rtrim", "utf8_rtrim"),
        ("ascii_trim", "utf8_trim"),
        ("ascii_ltrim_whitespace", "utf8_ltrim_whitespace"),
        ("ascii_rtrim_whitespace", "utf8_rtrim_whitespace"),
        ("ascii_trim_whitespace", "utf8_trim_whitespace"),
        ("ascii_center", "utf8_center")):
    _alias(_alias_name, _name)
_str_to_bool("ascii_is_printable", str.isprintable)
_str_to_bool("ascii_is_title", str.istitle)


def _zero_fill(v: str, width: int = 0, padding: str = "0") -> str:
    """``v`` right-justified with ``padding`` after its sign."""
    if v and v[0] not in "+-":
        return v.rjust(width, padding)
    return v[0] + v[1:].rjust(width - 1, padding) if v else v


@_string("utf8_zero_fill")
def utf8_zero_fill(ctx, col, width: int = 0, padding: str = "0"):
    return transform("utf8_zero_fill", col,
                     lambda v: _zero_fill(v, width, padding),
                     null_as_empty=True)


@_string("utf8_normalize")
def utf8_normalize(ctx, col, form: str = "NFC"):
    return transform("utf8_normalize", col,
                     lambda v: unicodedata.normalize(form, v))


@_string("binary_slice")
def binary_slice(ctx, col, start: int = 0, stop: Optional[int] = None,
                 step: int = 1):
    return transform("binary_slice", col, lambda v: v[start:stop:step])


def _replace_slice(v, start, stop, replacement):
    return v[:start] + replacement + (v[stop:] if stop is not None
                                      else type(v)())


@_string("utf8_replace_slice")
def utf8_replace_slice(ctx, col, start: int = 0, stop: Optional[int] = None,
                       replacement: str = ""):
    return transform("utf8_replace_slice", col,
                     lambda v: _replace_slice(v, start, stop, replacement))


@_string("binary_replace_slice")
def binary_replace_slice(ctx, col, start: int = 0,
                         stop: Optional[int] = None, replacement=b""):
    """A bytes replacement of a str value is decoded first."""
    rep = replacement.decode() if isinstance(replacement, bytes) \
        else replacement
    return transform("binary_replace_slice", col,
                     lambda v: _replace_slice(v, start, stop, rep))


def _regex_lookup(name, col, pattern, ignore_case, fn, null):
    require_string(name, col)
    rx = re.compile(pattern, re.IGNORECASE if ignore_case else 0)
    return DeviceColumn(slot_lookup(col, host_table(
        col, lambda v: fn(rx, v), np.int32, null)), col.validity, T.int32())


@_string("count_substring_regex")
def count_substring_regex(ctx, col, pattern: str = "",
                          ignore_case: bool = False):
    return _regex_lookup("count_substring_regex", col, pattern, ignore_case,
                         lambda rx, v: len(rx.findall(v)), 0)


def _regex_find(rx, v):
    m = rx.search(v)
    return m.start() if m else -1


@_string("find_substring_regex")
def find_substring_regex(ctx, col, pattern: str = "",
                         ignore_case: bool = False):
    return _regex_lookup("find_substring_regex", col, pattern, ignore_case,
                         _regex_find, -1)
