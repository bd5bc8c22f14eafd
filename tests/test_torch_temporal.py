"""The port's temporal functions against the JAX package's.

Every temporal name of the reference's ``temporal.py`` and of its
``extra_kernels.py`` runs on the same seeded column in both packages, one
parametrised case a name, type and option: date32, date64, timestamps of
each unit (and one with a zone), time32, time64 and durations. The values
hold dates before 1970, leap days, the days around each year end from 2014
to 2021 (ISO weeks 52, 53 and 1), times of day across the whole day and
negative durations; a tenth of the rows are null. Values, validity and
type must be exact, ``subsecond``'s f64 too.

The reference's own behaviours the port keeps (ROADMAP.md §3) each have a
test beside the reference's answer: ``us_week``/``us_year`` are the ISO
computation a day later, ``week``'s ``first_week_is_fully_in_year`` shift,
``is_dst`` always false, ``local_timestamp`` of a named zone as UTC,
``assume_timezone`` a relabel, ``round_temporal``'s tie up and its ignored
options, the week roundings' swapped start day, ``nanosecond`` 0 for other
units, ``nanoseconds_between`` without nanoseconds.
"""

import datetime

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arrow_tpu import types as RT
from arrow_tpu.device.column import DeviceColumn as JaxDeviceColumn
from arrow_tpu_torch import types as PT
from arrow_tpu_torch.compute.registry import get_function
from arrow_tpu_torch.device.column import DeviceColumn

from test_torch_types import (CAP, N, assert_same_column, assert_same_result,
                              run_both)
from worker_settings import collect_after_test, gc_off_in_module  # noqa: F401

# name -> (port type, reference type)
TEMPORAL = {
    "date32": (PT.date32(), RT.date32()),
    "date64": (PT.date64(), RT.date64()),
    "timestamp[s]": (PT.timestamp("s"), RT.timestamp("s")),
    "timestamp[ms]": (PT.timestamp("ms"), RT.timestamp("ms")),
    "timestamp[us]": (PT.timestamp("us"), RT.timestamp("us")),
    "timestamp[ns]": (PT.timestamp("ns"), RT.timestamp("ns")),
    "timestamp[us, +05:30]": (PT.timestamp("us", "+05:30"),
                              RT.timestamp("us", "+05:30")),
    "time32[s]": (PT.time32("s"), RT.time32("s")),
    "time32[ms]": (PT.time32("ms"), RT.time32("ms")),
    "time64[us]": (PT.time64("us"), RT.time64("us")),
    "time64[ns]": (PT.time64("ns"), RT.time64("ns")),
    "duration[s]": (PT.duration("s"), RT.duration("s")),
    "duration[ms]": (PT.duration("ms"), RT.duration("ms")),
    "duration[ns]": (PT.duration("ns"), RT.duration("ns")),
}
_PER_DAY = {"s": 86_400, "ms": 86_400_000, "us": 86_400_000_000,
            "ns": 86_400_000_000_000}
_EPOCH = datetime.date(1970, 1, 1)


def _day(y, m, d) -> int:
    return (datetime.date(y, m, d) - _EPOCH).days


def special_days() -> list:
    """Leap days and their neighbours (1900 is no leap year, 2000 is),
    the days around each year end from 2014 to 2021, and the epoch."""
    days = []
    for y in (1600, 1896, 1900, 1904, 1968, 1972, 2000, 2004, 2024, 2100):
        days += [_day(y, 2, 28), _day(y, 3, 1)]
        if y % 4 == 0 and (y % 100 or y % 400 == 0):
            days.append(_day(y, 2, 29))
    for y in range(2014, 2022):
        days += [_day(y, 12, d) for d in range(26, 32)]
        days += [_day(y + 1, 1, d) for d in range(1, 8)]
    return days + [-1, 0, 1, -365, -366, -719162]


def storage(name: str, seed: int) -> np.ndarray:
    """``N`` seeded values of type ``name`` in its storage dtype, then
    zeros to ``CAP``: special days (with a random time of day where the
    type has one) first, random days from 1860 to 2130 after them;
    times within the day, durations of either sign."""
    rng = np.random.default_rng(seed)
    pt = TEMPORAL[name][0]
    days = np.array(special_days(), dtype=np.int64)
    days = np.concatenate([days, rng.integers(-40_000, 58_000,
                                              N - len(days))])
    if name == "date32":
        v = days
    elif name == "date64":
        v = days * 86_400_000 + rng.integers(0, 86_400_000, N)
    else:
        per_day = _PER_DAY[pt.unit]
        within = rng.integers(0, per_day, N)
        within[:4] = [0, 1, per_day - 1, per_day // 2]
        if pt.id == PT.TypeId.TIMESTAMP:
            v = days * per_day + within
        elif pt.id in (PT.TypeId.TIME32, PT.TypeId.TIME64):
            v = within
        else:
            v = rng.integers(-900, 900, N) * per_day + within
    out = np.zeros(CAP, dtype=np.int32 if pt.id in (
        PT.TypeId.DATE32, PT.TypeId.TIME32) else np.int64)
    out[:N] = v
    return out


def temporal_pair(name: str, seed: int = 3, values=None):
    """The same column as a port and a reference DeviceColumn: a tenth of
    the live rows null."""
    v = storage(name, seed) if values is None else values
    rng = np.random.default_rng(seed + 100)
    valid = np.zeros(CAP, dtype=np.bool_)
    valid[:N] = rng.random(N) >= 0.1
    pt, rtype = TEMPORAL[name]
    return (DeviceColumn(torch.from_numpy(v.copy()),
                         torch.from_numpy(valid.copy()), pt),
            JaxDeviceColumn(jnp.asarray(v), jnp.asarray(valid), rtype))


def check(fn, names, tol=None, **options):
    """``fn`` over the columns ``names`` in both packages: the same
    values, validity and type, or both raise."""
    pairs = [temporal_pair(n, seed=3 + i) for i, n in enumerate(names)]
    got, want = run_both(fn, [p for p, _ in pairs], [r for _, r in pairs],
                         **options)
    assert_same_result(got, want, tol)
    return got


UNARY = ["year", "month", "day", "hour", "minute", "second", "millisecond",
         "microsecond", "nanosecond", "quarter", "day_of_year", "iso_year",
         "iso_week", "us_week", "is_leap_year", "is_dst", "us_year",
         "day_of_week", "week", "subsecond"]


@pytest.mark.parametrize("type_name", list(TEMPORAL))
@pytest.mark.parametrize("fn", UNARY)
def test_unary_matches_jax(fn, type_name):
    got = check(fn, [type_name], tol=None)
    if fn != "subsecond":
        return
    # subsecond: f64 within rtol 1e-12 of the reference's (checked exact
    # above) and of the microsecond count over 1e6
    us = get_function("microsecond").impl(None, temporal_pair(type_name)[0])
    assert got.values.dtype == torch.float64
    assert ((got.values * 1e6).round() % 1000 == us.values).all()


@pytest.mark.parametrize("week_start", range(1, 8))
@pytest.mark.parametrize("count_from_zero", [True, False])
@pytest.mark.parametrize("type_name", ["date32", "timestamp[ns]", "date64"])
def test_day_of_week_options_match_jax(type_name, count_from_zero,
                                       week_start):
    check("day_of_week", [type_name], count_from_zero=count_from_zero,
          week_start=week_start)


@pytest.mark.parametrize("first_full", [False, True])
@pytest.mark.parametrize("count_from_zero", [False, True])
@pytest.mark.parametrize("monday", [True, False])
@pytest.mark.parametrize("type_name", ["date32", "timestamp[s]"])
def test_week_options_match_jax(type_name, monday, count_from_zero,
                                first_full):
    check("week", [type_name], week_starts_monday=monday,
          count_from_zero=count_from_zero,
          first_week_is_fully_in_year=first_full)


ROUND_UNITS = [("microsecond", 1), ("millisecond", 1), ("second", 7),
               ("minute", 15), ("hour", 5), ("day", 1), ("day", 3),
               ("week", 1), ("week", 2), ("month", 1), ("month", 5),
               ("quarter", 1), ("year", 1), ("year", 3)]


@pytest.mark.parametrize("type_name", ["date32", "date64", "timestamp[s]",
                                       "timestamp[ns]", "time32[ms]",
                                       "time64[us]", "duration[ms]"])
@pytest.mark.parametrize("unit,multiple", ROUND_UNITS,
                         ids=[f"{u}{m}" for u, m in ROUND_UNITS])
@pytest.mark.parametrize("fn", ["floor_temporal", "ceil_temporal",
                                "round_temporal"])
def test_rounding_matches_jax(fn, unit, multiple, type_name):
    """Every unit, a multiple, each roundable type (a duration raises in
    both)."""
    check(fn, [type_name], unit=unit, multiple=multiple)
    if unit == "week":
        check(fn, [type_name], unit=unit, multiple=multiple,
              week_starts_monday=False)


BETWEEN = ["years_between", "days_between", "hours_between",
           "seconds_between", "minutes_between", "milliseconds_between",
           "microseconds_between", "nanoseconds_between", "weeks_between",
           "quarters_between", "month_interval_between"]
PAIRS = [("date32", "date32"), ("timestamp[ns]", "date64"),
         ("timestamp[s]", "timestamp[ms]"), ("time32[s]", "time64[ns]"),
         ("duration[ms]", "duration[ns]"), ("date64", "timestamp[us]")]


@pytest.mark.parametrize("pair", PAIRS, ids="-".join)
@pytest.mark.parametrize("fn", BETWEEN)
def test_between_matches_jax(fn, pair):
    check(fn, list(pair))


@pytest.mark.parametrize("week_start", [1, 3, 7])
@pytest.mark.parametrize("count_from_zero", [True, False])
def test_weeks_between_options_match_jax(count_from_zero, week_start):
    check("weeks_between", ["date32", "timestamp[ns]"],
          count_from_zero=count_from_zero, week_start=week_start)


_ZONES = [None, "UTC", "+05:30", "-08:00", "America/New_York"]


@pytest.mark.parametrize("tz", _ZONES)
@pytest.mark.parametrize("unit", ["s", "ms", "us", "ns"])
def test_local_timestamp_and_assume_timezone_match_jax(unit, tz):
    v = storage(f"timestamp[{unit}]", 5)
    pt, rt = PT.timestamp(unit, tz), RT.timestamp(unit, tz)
    pcol = DeviceColumn(torch.from_numpy(v.copy()), None, pt)
    rcol = JaxDeviceColumn(jnp.asarray(v), None, rt)
    for fn, opts in (("local_timestamp", {}),
                     ("assume_timezone", {"timezone": "Asia/Tokyo"})):
        got, want = run_both(fn, [pcol], [rcol], **opts)
        assert_same_result(got, want)


@pytest.mark.parametrize("fn", ["local_timestamp", "assume_timezone",
                                "year", "days_between"])
def test_non_temporal_columns_raise_as_in_jax(fn):
    """A date where a timestamp is needed, and an int64 where a temporal
    type is needed, raise in both."""
    pairs = [temporal_pair("date32"), temporal_pair("date32")]
    if fn in ("year", "days_between"):
        v = np.arange(CAP, dtype=np.int64)
        pairs = [(DeviceColumn(torch.from_numpy(v), None, PT.int64()),
                  JaxDeviceColumn(jnp.asarray(v), None, RT.int64()))] * 2
    arity = 2 if fn == "days_between" else 1
    got, want = run_both(fn, [p for p, _ in pairs[:arity]],
                         [r for _, r in pairs[:arity]])
    assert isinstance(want, Exception) and isinstance(got, ValueError)


def test_strftime_names_the_host_boundary():
    """strftime and strptime are host-tier names (``host_kernels.py``):
    they resolve, and run on host Arrays, as the reference registers
    them."""
    for name in ("strftime", "strptime"):
        assert get_function(name).kind == "host"


# --- the reference's behaviours the port keeps -------------------------------

def _dates(*ymd):
    v = np.zeros(CAP, dtype=np.int32)
    v[:len(ymd)] = [_day(*d) for d in ymd]
    return temporal_pair("date32", values=v)


def _values(fn, pair, **options):
    got, want = run_both(fn, [pair[0]], [pair[1]], **options)
    assert_same_column(got, want)
    return got.values[:pair[0].values.numel()].tolist()


def test_us_week_and_us_year_are_iso_of_the_next_day():
    """2022-01-01 is a Saturday, 2022-01-02 a Sunday, 2023-12-31 a
    Sunday, 2024-12-29 a Sunday."""
    days = [(2022, 1, 1), (2022, 1, 2), (2023, 12, 31), (2024, 12, 29)]
    pair = _dates(*days)
    nxt = [datetime.date(*d) + datetime.timedelta(days=1) for d in days]
    assert _values("us_week", pair)[:4] == [d.isocalendar()[1] for d in nxt]
    assert _values("us_year", pair)[:4] == [d.isocalendar()[0] for d in nxt]


def test_week_first_week_fully_in_year_shifts_by_one():
    """2021-01-04 is ISO week 1 and 2021 starts on a Friday: the reference
    gives week 0 with the option; 2018 starts on a Monday: no shift."""
    pair = _dates((2021, 1, 4), (2018, 1, 1))
    assert _values("week", pair)[:2] == [1, 1]
    assert _values("week", pair, first_week_is_fully_in_year=True)[:2] == \
        [0, 1]


def test_is_dst_is_always_false():
    """July in New York: daylight saving time, all the same false."""
    us = int(datetime.datetime(2020, 7, 1, 12).timestamp()) * 10 ** 6
    v = np.full(CAP, us, dtype=np.int64)
    pcol = DeviceColumn(torch.from_numpy(v), None,
                        PT.timestamp("us", "America/New_York"))
    rcol = JaxDeviceColumn(jnp.asarray(v), None,
                           RT.timestamp("us", "America/New_York"))
    got, want = run_both("is_dst", [pcol], [rcol])
    assert_same_column(got, want)
    assert not got.values.any()


def test_local_timestamp_of_a_named_zone_is_utc():
    v = np.arange(CAP, dtype=np.int64) * 3_600_000_000
    for tz, shift in (("Asia/Tokyo", 0), ("+09:00", 9 * 3_600_000_000)):
        pcol = DeviceColumn(torch.from_numpy(v), None, PT.timestamp("us", tz))
        rcol = JaxDeviceColumn(jnp.asarray(v), None, RT.timestamp("us", tz))
        got, want = run_both("local_timestamp", [pcol], [rcol])
        assert_same_column(got, want)
        assert torch.equal(got.values, torch.from_numpy(v) + shift)


def test_assume_timezone_relabels_only():
    v = np.arange(CAP, dtype=np.int64)
    pcol = DeviceColumn(torch.from_numpy(v), None, PT.timestamp("ms"))
    rcol = JaxDeviceColumn(jnp.asarray(v), None, RT.timestamp("ms"))
    got, want = run_both("assume_timezone", [pcol], [rcol],
                         timezone="Europe/Paris")
    assert_same_column(got, want)
    assert torch.equal(got.values, pcol.values)
    assert got.type == PT.timestamp("ms", "Europe/Paris")


def test_round_temporal_tie_rounds_up_and_ignores_two_options():
    """12:00 is a tie between the two days: it rounds up; 00:00 with
    ``ceil_is_strictly_greater`` stays where it is, and
    ``calendar_based_origin`` changes nothing."""
    noon = _PER_DAY["s"] // 2
    v = np.zeros(CAP, dtype=np.int64)
    v[:3] = [noon, 0, _PER_DAY["s"] * 3 + 3600]
    pcol, rcol = temporal_pair("timestamp[s]", values=v)
    got, want = run_both("round_temporal", [pcol], [rcol], unit="day")
    assert_same_column(got, want)
    assert got.values[:3].tolist() == [_PER_DAY["s"], 0, _PER_DAY["s"] * 3]
    for opts in ({"ceil_is_strictly_greater": True},
                 {"calendar_based_origin": True}):
        got, want = run_both("ceil_temporal", [pcol], [rcol], unit="day",
                             **opts)
        assert_same_column(got, want)
        assert got.values[:3].tolist() == [_PER_DAY["s"], 0,
                                           _PER_DAY["s"] * 4]


@pytest.mark.parametrize("type_name", ["timestamp[us]", "time64[us]",
                                       "duration[ms]", "date64"])
def test_nanosecond_is_zero_but_for_ns(type_name):
    assert not any(_values("nanosecond", temporal_pair(type_name)))


def test_nanoseconds_between_loses_the_nanoseconds():
    """Two ns timestamps 1,999 ns apart: 1,000 ns between them (the span
    floors to microseconds first), in both packages."""
    a = np.zeros(CAP, dtype=np.int64)
    b = np.zeros(CAP, dtype=np.int64)
    b[0], a[1], b[1] = 1_999, -1, 1
    pa, ra = temporal_pair("timestamp[ns]", values=a)
    pb, rb = temporal_pair("timestamp[ns]", values=b)
    got, want = run_both("nanoseconds_between", [pa, pb], [ra, rb])
    assert_same_column(got, want)
    assert got.values[:2].tolist() == [1_000, 1_000]



def test_week_rounding_swaps_the_start_day_as_the_reference_does():
    """At unit="week" the reference puts the boundaries on Sundays when
    weeks start on Monday, and on Mondays when they do not; the port
    keeps it (pyarrow floors 2024-01-03 to 2024-01-01 with
    week_starts_monday=True, to 2023-12-31 with False)."""
    pair = _dates((2024, 1, 3))
    monday = _values("floor_temporal", pair, unit="week")
    sunday = _values("floor_temporal", pair, unit="week",
                     week_starts_monday=False)
    assert (monday[0], sunday[0]) == (_day(2023, 12, 31), _day(2024, 1, 1))
