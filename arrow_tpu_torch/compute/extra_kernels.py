"""The long-tail functions of the reference's ``extra_kernels.py``
(counterpart of ``arrow_tpu/compute/extra_kernels.py``): the
``is_in_meta_binary``/``index_in_meta_binary`` aliases, ``hypot``,
``round_binary``, ``indices_nonzero``, ``winsorize``, ``rank_quantile``,
``rank_normal`` and ``tdigest``; ``subsecond``, ``local_timestamp``,
``floor_temporal``/``ceil_temporal``/``round_temporal``, ``week``,
``us_year``, the ``*_between`` of seconds down to nanoseconds, weeks,
quarters and months; ``ascii_is_printable``, ``ascii_is_title``,
``utf8_zero_fill``, ``utf8_normalize``, ``binary_slice``, the two
``*_replace_slice`` functions, the counts and finds of a regex, and the
reference's ``ascii_*`` aliases of the trims and of center. Its grouped
aggregates (``hash_first_last``, ``hash_skew``, ``hash_kurtosis``,
``hash_approximate_median``, ``hash_tdigest``) are in ``hash_agg.py``.

Its host-tier functions run on host Arrays, a row at a time in Python, as
the reference's do: ``day_time_interval_between``,
``month_day_nano_interval_between``, ``iso_calendar``, ``year_month_day``,
``extract_regex``, ``extract_regex_span``, ``split_pattern_regex``,
``list_slice``, ``dictionary_decode`` and the scalar ``pivot_wider``, with
the ``ascii_split_whitespace`` alias of ``host_kernels``'
``utf8_split_whitespace``.
"""

from __future__ import annotations

import datetime
import re
import unicodedata
from typing import Optional

import numpy as np
import torch

from .. import dtypes
from .. import types as T
from ..device.column import DeviceColumn
from ..types import TypeId
from . import elementwise as E
from . import vector_misc  # noqa: F401 - registers is_in and index_in
from .aggregate import _dec_factor, scalar_quantile
from .move import compact_by_mask
from . import host_kernels  # noqa: F401 - registers utf8_split_whitespace
from ..array.array import Array, array as make_array
from .registry import ArrowInvalid, register, register_alias, register_host
from .selection import Compacted
from .strings import (_alias, _str_to_bool, _string, host_table,
                      require_string, slot_lookup, transform)
from .temporal import (US_PER_DAY, between, between_columns, civil_from_days,
                       days_from_civil, iso_year_week, to_days_and_us)

register_alias("is_in_meta_binary", "is_in")
register_alias("index_in_meta_binary", "index_in")


# --- math --------------------------------------------------------------------

@register("hypot", "elementwise")
def hypot(ctx, a, b):
    """``sqrt(a**2 + b**2)``: ``a``'s integers as f64 (``b``'s as they
    are), in the dtype ``jnp.hypot`` promotes them to; f16 and f32
    computed in f64 and rounded once."""
    k = E._kind(a)
    if dtypes.is_integer(k) or k == dtypes.WEAK_INT:
        k = "float64"
    dt = E._inexact(k, E._kind(b))
    dev = E._device_of(a, b)
    out = E._wide(torch.hypot, E._load(a, dt, dev), E._load(b, dt, dev))
    return E._col(out, E._validity_of(a, b), name=dt)


@register("round_binary", "elementwise")
def round_binary(ctx, a, b, round_mode: str = "half_to_even"):
    """``a`` rounded to ``b`` decimal digits a row, in f64: ``a * 10**b``
    rounded by ``round_mode`` (``half_to_even``, ``down``, ``up``,
    ``towards_zero``; every other mode half away from zero, as in the
    reference), divided by ``10**b``."""
    dev = E._device_of(a, b)
    scale = torch.pow(10.0, E._load(b, "float64", dev))
    x = E._load(a, "float64", dev) * scale
    if round_mode == "half_to_even":
        r = torch.round(x)
    elif round_mode == "down":
        r = torch.floor(x)
    elif round_mode == "up":
        r = torch.ceil(x)
    elif round_mode == "towards_zero":
        r = torch.trunc(x)
    else:
        r = torch.trunc(x + torch.sign(x) * 0.5)
    return E._col(r / scale, E._validity_of(a, b), T.float64())


# --- statistics and ranks ----------------------------------------------------

@register("indices_nonzero", "vector")
def indices_nonzero(ctx, col: DeviceColumn) -> Compacted:
    """The positions of the valid, live, non-zero rows (a NaN counts, -0.0
    does not), uint64, through one compaction."""
    nz = col.valid_mask(ctx.row_mask()) & (col.values != 0)
    idx = torch.arange(ctx.capacity, dtype=torch.int64, device=nz.device)
    (out,), count = compact_by_mask(nz, [idx])
    return Compacted(DeviceColumn(out, None, T.uint64()), count)


def _live_quantile(v: torch.Tensor, live: torch.Tensor, q: float,
                   higher: bool) -> torch.Tensor:
    """The value at ``q * (n - 1)`` among the live lanes, rounded up
    (``higher``) or down, as the reference reads it: the lanes sorted
    with the rest at +inf (a NaN sorts after them and counts in ``n``)."""
    sv = torch.sort(torch.where(live, v, float("inf"))).values
    nf = live.sum(dtype=torch.int64).clamp(min=1).to(torch.float64)
    pos = q * (nf - 1.0)
    pos = torch.ceil(pos) if higher else torch.floor(pos)
    return sv[pos.long().clamp(0, v.shape[0] - 1)]


@register("winsorize", "vector")
def winsorize(ctx, col: DeviceColumn, lower_limit: float = 0.0,
              upper_limit: float = 1.0) -> DeviceColumn:
    """Values clipped to the ``lower_limit`` quantile (rounded up) and the
    ``upper_limit`` one (rounded down) of the live values, in f64: a
    float column keeps its dtype and type, a decimal its unscaled values
    and type, every other column comes out f64."""
    name = col.value_dtype
    live = col.valid_mask(ctx.row_mask())
    v = dtypes.as_float64(col.values, name)
    lo = _live_quantile(v, live, float(lower_limit), True)
    hi = _live_quantile(v, live, float(upper_limit), False)
    out = torch.minimum(torch.maximum(v, lo), hi)
    if _dec_factor(col.type) is not None or dtypes.is_float(name):
        return DeviceColumn(out.to(col.values.dtype), col.validity,
                            col.type)
    return DeviceColumn(out, col.validity, T.float64())


def _rank_fraction(ctx, col, null_placement) -> torch.Tensor:
    """``(mean of the min and max ranks - 0.5) / n``, f64, where ``n``
    counts every live row, nulls included; ranked ascending whatever
    ``sort_keys`` says, as in the reference."""
    from .vector_sort import rank
    r = [rank(ctx, col, "ascending", null_placement, tb).column.values
         .to(torch.float64) for tb in ("min", "max")]
    n = ctx.row_mask().sum(dtype=torch.int64).to(torch.float64)
    return ((r[0] + r[1]) * 0.5 - 0.5) / n.clamp(min=1.0)


@register("rank_quantile", "vector")
def rank_quantile(ctx, col, sort_keys="ascending",
                  null_placement: str = "at_end") -> Compacted:
    return Compacted(DeviceColumn(_rank_fraction(ctx, col, null_placement),
                                  None, T.float64()), ctx.row_count)


@register("rank_normal", "vector")
def rank_normal(ctx, col, sort_keys="ascending",
                null_placement: str = "at_end") -> Compacted:
    """The probit (``torch.special.ndtri``) of ``rank_quantile``."""
    q = _rank_fraction(ctx, col, null_placement)
    return Compacted(DeviceColumn(torch.special.ndtri(q), None,
                                  T.float64()), ctx.row_count)


@register("tdigest", "aggregate")
def tdigest(ctx, a: DeviceColumn, q=0.5, delta: int = 100,
            buffer_size: int = 500, skip_nulls: bool = True,
            min_count: int = 0):
    """The exact linear quantile (``quantile``), as the reference gives
    it; NaN is left out, as the port's ``quantile`` leaves it out."""
    return scalar_quantile(ctx, a, q, "linear", skip_nulls, min_count)


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


# --- the host tier -------------------------------------------------------------

def _as_datetime(v):
    if isinstance(v, datetime.date) and not isinstance(v, datetime.datetime):
        return datetime.datetime(v.year, v.month, v.day)
    return v


@register_host("day_time_interval_between")
def day_time_interval_between(a: Array, b: Array) -> Array:
    out = []
    for x, y in zip(a.to_pylist(), b.to_pylist()):
        if x is None or y is None:
            out.append(None)
            continue
        delta = _as_datetime(y) - _as_datetime(x)
        out.append((delta.days,
                    delta.seconds * 1000 + delta.microseconds // 1000))
    return make_array(out, T.day_time_interval())


@register_host("month_day_nano_interval_between")
def month_day_nano_interval_between(a: Array, b: Array) -> Array:
    out = []
    midnight = datetime.time()
    for x, y in zip(a.to_pylist(), b.to_pylist()):
        if x is None or y is None:
            out.append(None)
            continue
        dx = x.date() if isinstance(x, datetime.datetime) else x
        dy = y.date() if isinstance(y, datetime.datetime) else y
        tx = x.time() if isinstance(x, datetime.datetime) else midnight
        ty = y.time() if isinstance(y, datetime.datetime) else midnight
        nanos = ((ty.hour - tx.hour) * 3600 + (ty.minute - tx.minute) * 60
                 + (ty.second - tx.second)) * 10**9 \
            + (ty.microsecond - tx.microsecond) * 1000
        out.append(((dy.year - dx.year) * 12 + (dy.month - dx.month),
                    dy.day - dx.day, nanos))
    return make_array(out, T.month_day_nano_interval())


@register_host("iso_calendar")
def iso_calendar(arr: Array) -> Array:
    out = []
    for v in arr.to_pylist():
        if v is None:
            out.append(None)
        else:
            iso = v.isocalendar()
            out.append({"iso_year": iso[0], "iso_week": iso[1],
                        "iso_day_of_week": iso[2]})
    return make_array(out, T.struct([("iso_year", T.int64()),
                                     ("iso_week", T.int64()),
                                     ("iso_day_of_week", T.int64())]))


@register_host("year_month_day")
def year_month_day(arr: Array) -> Array:
    return make_array([None if v is None else
                       {"year": v.year, "month": v.month, "day": v.day}
                       for v in arr.to_pylist()],
                      T.struct([("year", T.int64()), ("month", T.int64()),
                                ("day", T.int64())]))


register_alias("ascii_split_whitespace", "utf8_split_whitespace")


def _group_names(name, pattern):
    rx = re.compile(pattern)
    names = list(rx.groupindex)
    if not names:
        raise ArrowInvalid(f"{name} needs named capture groups")
    return rx, names


def _matches(rx, arr: Array):
    return [rx.search(v) if v is not None else None
            for v in arr.to_pylist()]


def _struct_of(children, fields, matched) -> Array:
    """A struct Array of its children's ArrayData, null where no row
    matched (a null row's fields null too)."""
    from ..array.data import ArrayData
    from ..buffer import Buffer
    from ..utils import bits
    ok = np.fromiter((m is not None for m in matched), np.bool_,
                     len(matched))
    nulls = int(len(ok) - ok.sum())
    return Array(ArrayData(T.struct(fields), len(ok), [
        Buffer(bits.pack_bits(ok)) if nulls else None], children,
        null_count=nulls))


@register_host("extract_regex")
def extract_regex(arr: Array, pattern: str = "") -> Array:
    """Each named group of the first match, null where none matches
    (built a field at a time)."""
    rx, names = _group_names("extract_regex", pattern)
    matched = _matches(rx, arr)
    return _struct_of([make_array([m.group(n) if m else None
                                   for m in matched], T.string()).data
                       for n in names],
                      [(n, T.string()) for n in names], matched)


@register_host("extract_regex_span")
def extract_regex_span(arr: Array, pattern: str = "") -> Array:
    """Each named group's [start, length] in the first match, null where
    none matches."""
    from ..array.data import ArrayData
    from ..buffer import Buffer
    from ..utils import bits
    rx, names = _group_names("extract_regex_span", pattern)
    matched = _matches(rx, arr)
    t = T.fixed_size_list(T.int32(), 2)
    ok = np.fromiter((m is not None for m in matched), np.bool_,
                     len(matched))
    validity = None if ok.all() else Buffer(bits.pack_bits(ok))
    kids = []
    for n in names:
        flat = []
        for m in matched:
            flat.extend((m.start(n), m.end(n) - m.start(n)) if m
                        else (None, None))
        kids.append(ArrayData(t, len(matched), [validity], [
            make_array(flat, T.int32()).data]))
    return _struct_of(kids, [(n, t) for n in names], matched)


@register_host("split_pattern_regex")
def split_pattern_regex(arr: Array, pattern: str = "",
                        max_splits: Optional[int] = None,
                        reverse: bool = False) -> Array:
    from .host_kernels import _build_string_list
    rx = re.compile(pattern)
    k = 0 if max_splits is None else max_splits
    vals = arr.to_pylist()
    return _build_string_list([None if v is None else rx.split(v, maxsplit=k)
                               for v in vals], len(vals))


@register_host("list_slice")
def list_slice(arr: Array, start: int = 0, stop: Optional[int] = None,
               step: int = 1, return_fixed_size_list=None) -> Array:
    return make_array([None if v is None else v[slice(start, stop, step)]
                       for v in arr.to_pylist()], arr.type)


@register_host("dictionary_decode")
def dictionary_decode(arr: Array) -> Array:
    if arr.type.id != TypeId.DICTIONARY:
        return arr
    return make_array(arr.to_pylist(), arr.type.value_type)


@register_host("pivot_wider")
def pivot_wider(keys: Array, values: Array, key_names=None,
                unexpected_key_behavior: str = "ignore") -> Array:
    """(key, value) rows as one struct row (aggregate_pivot.cc)."""
    names = list(key_names) if key_names is not None else \
        sorted({k for k in keys.to_pylist() if k is not None})
    row = {n: None for n in names}
    for k, v in zip(keys.to_pylist(), values.to_pylist()):
        if k is None:
            continue
        if k not in row:
            if unexpected_key_behavior == "raise":
                raise ArrowInvalid(f"unexpected pivot key {k!r}")
            continue
        if row[k] is not None:
            raise ArrowInvalid(f"duplicate pivot key {k!r}")
        row[k] = v
    return make_array([row], T.struct([(n, values.type) for n in names]))
