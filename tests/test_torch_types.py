"""The port's device type set against the JAX package's.

* Every type of the reference's device set round-trips: ``batch_from_numpy``
  then ``download``, with nulls and padding, gives what the reference's
  ``upload_table`` then ``download_table(...).to_pydict()`` gives. The
  types the port refuses (decimals wider than 18 digits, fixed-size
  binary) raise, naming ROADMAP item 11.
* Promotion: for every pair drawn from bool, the 11 numeric dtypes, a Python
  int, a Python float and a numpy scalar of each dtype, ``add``,
  ``multiply`` and ``less`` give the reference's values, dtype and output
  type (one parametrised test, a case per pair).
* Registry coverage: every name the reference's ``elementwise.py``
  registers, read from its registry at test time, is registered in the
  port, and so is ``case_when``.
* ``cast``: the whole matrix of the device types, the temporal unit
  rescales both ways, decimals, and each safe failure.

The helpers here (``TYPES``, ``column_pair``, ``assert_same_column``) build
the same seeded column as a port and a reference DeviceColumn and compare
results; ``test_torch_elementwise_types.py`` and
``test_torch_typed_keys.py`` use them too.
"""

import datetime
import decimal

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import arrow_tpu as at
from arrow_tpu import types as RT
from arrow_tpu.compute import registry as jax_registry
from arrow_tpu.compute.elementwise import ErrGuard
from arrow_tpu.device.column import DeviceColumn as JaxDeviceColumn
from arrow_tpu.device.column import download_table, upload_table
from arrow_tpu_torch import dtypes
from arrow_tpu_torch import types as PT
from arrow_tpu_torch.compute.registry import ExecContext, get_function
from arrow_tpu_torch.device.column import (DeviceColumn, batch_from_numpy,
                                           download, round_up)
from worker_settings import collect_after_test, gc_off_in_module  # noqa: F401

N = 200
CAP = round_up(N)

# name -> (port type, reference type)
TYPES = {
    "bool": (PT.bool_(), RT.bool_()),
    "int8": (PT.int8(), RT.int8()), "int16": (PT.int16(), RT.int16()),
    "int32": (PT.int32(), RT.int32()), "int64": (PT.int64(), RT.int64()),
    "uint8": (PT.uint8(), RT.uint8()), "uint16": (PT.uint16(), RT.uint16()),
    "uint32": (PT.uint32(), RT.uint32()),
    "uint64": (PT.uint64(), RT.uint64()),
    "float16": (PT.float16(), RT.float16()),
    "float32": (PT.float32(), RT.float32()),
    "float64": (PT.float64(), RT.float64()),
    "date32": (PT.date32(), RT.date32()),
    "date64": (PT.date64(), RT.date64()),
    "timestamp[s]": (PT.timestamp("s"), RT.timestamp("s")),
    "timestamp[ns]": (PT.timestamp("ns"), RT.timestamp("ns")),
    "timestamp[us, UTC]": (PT.timestamp("us", "UTC"),
                           RT.timestamp("us", "UTC")),
    "time32[s]": (PT.time32("s"), RT.time32("s")),
    "time32[ms]": (PT.time32("ms"), RT.time32("ms")),
    "time64[us]": (PT.time64("us"), RT.time64("us")),
    "time64[ns]": (PT.time64("ns"), RT.time64("ns")),
    "duration[ms]": (PT.duration("ms"), RT.duration("ms")),
    "duration[ns]": (PT.duration("ns"), RT.duration("ns")),
    "month_interval": (PT.month_interval(), RT.month_interval()),
    "decimal128(12, 2)": (PT.decimal128(12, 2), RT.decimal128(12, 2)),
    "decimal64(9, 3)": (PT.decimal64(9, 3), RT.decimal64(9, 3)),
}
NUMERIC = ("bool", "int8", "int16", "int32", "int64", "uint8", "uint16",
           "uint32", "uint64", "float16", "float32", "float64")


def storage_values(name: str, rng, n: int = N) -> np.ndarray:
    """Seeded values of type ``name`` in its reference dtype: whole
    integer ranges (both ends included), floats with NaN, -0.0 and
    infinities, temporal counts in a plausible span."""
    t = TYPES[name][0]
    vd = dtypes.dtype_of_type(t)
    if name == "bool":
        return rng.integers(0, 2, n).astype(np.bool_)
    if t.is_decimal:
        bound = 10 ** t.precision - 1
        return rng.integers(-bound, bound, n, dtype=np.int64)
    if t.id == PT.TypeId.TIME32:
        return rng.integers(0, 86_400 * (1000 if t.unit == "ms" else 1),
                            n).astype(np.int32)
    if t.id == PT.TypeId.TIME64:
        return rng.integers(0, 86_400 * (10 ** 6 if t.unit == "us"
                                         else 10 ** 9), n, dtype=np.int64)
    if t.is_temporal or t.id == PT.TypeId.INTERVAL_MONTHS:
        # about a century either side of the epoch, in the type's unit
        unit = getattr(t, "unit", "ms" if vd == "int64" else "day")
        span = 3 * 10 ** 9 * {"day": 1e-5, "s": 1, "ms": 10 ** 3,
                              "us": 10 ** 6, "ns": 10 ** 9}[unit]
        return rng.integers(-int(span), int(span), n).astype(vd)
    if dtypes.is_float(vd):
        v = rng.normal(size=n) * 50
        v[::11] = np.nan
        v[1::13] = -0.0
        v[2::29] = np.inf
        v[3::31] = -np.inf
        return v.astype(vd)
    lo, hi = dtypes.int_range(vd)
    v = rng.integers(lo, hi, n, dtype=vd, endpoint=True)
    v[:4] = [lo, hi, 0, 1]
    return v


def column_pair(name: str, seed: int, nulls: bool = True, values=None):
    """The same seeded column as a port and a reference DeviceColumn at
    capacity ``CAP``: ``N`` live rows (a fifth null), zeros behind."""
    rng = np.random.default_rng(seed)
    v = storage_values(name, rng) if values is None else values
    vals = np.zeros(CAP, dtype=v.dtype)
    vals[:len(v)] = v
    valid = None
    if nulls:
        valid = np.zeros(CAP, dtype=np.bool_)
        valid[:N] = rng.random(N) > 0.2
    pt, rtype = TYPES[name]
    port = DeviceColumn(
        torch.from_numpy(vals.view(_np_storage(pt)).copy()),
        None if valid is None else torch.from_numpy(valid.copy()), pt)
    ref = JaxDeviceColumn(jnp.asarray(vals),
                          None if valid is None else jnp.asarray(valid),
                          rtype)
    return port, ref


def _np_storage(pt) -> np.dtype:
    return torch.empty(0, dtype=dtypes.STORAGE[
        dtypes.dtype_of_type(pt)]).numpy().dtype


def contexts(n: int = N):
    return (ExecContext(CAP, torch.tensor(n, dtype=torch.int32)),
            jax_registry.ExecContext(CAP, jnp.asarray(n, jnp.int32)))


def type_name(t) -> str:
    """A type's name in the port's spelling, for either package."""
    r = repr(t)
    return {"halffloat": "float16", "float": "float32", "double": "float64",
            "date32[day]": "date32", "date64[ms]": "date64"}.get(r, r)


def _close(got, want, tol_dtype) -> np.ndarray:
    """Elementwise: 1 ulp of ``tol_dtype`` at f16/f32, rtol 1e-9 at f64
    (NaN with NaN, infinities equal)."""
    g, w = got.astype(np.float64), want.astype(np.float64)
    same = (g == w) | (np.isnan(g) & np.isnan(w))
    with np.errstate(invalid="ignore", over="ignore"):
        if tol_dtype == np.float64:
            tol = 1e-9 * np.maximum(np.abs(w), np.abs(g))
        else:
            tol = np.spacing(np.maximum(np.abs(w), np.abs(g)).astype(
                tol_dtype)).astype(np.float64)
        return same | (np.abs(g - w) <= tol)


def assert_same_column(port: DeviceColumn, ref, tol=None, truth=None,
                       ulp_of=None):
    """Values (at the reference's dtype), validity and type equal.
    ``tol``: None for exact, ``"ulp"`` for 1 ulp at f16/f32 and rtol 1e-9
    at f64. With ``truth`` (the f64 value of the function), a value
    may instead lie that close to the correctly rounded result, where the
    reference's CPU approximation is farther from it (XLA's CPU backend
    flushes subnormal results to zero and approximates some f32
    functions, such as ``tanh`` and ``sinh``, to a few ulp). ``ulp_of``:
    the dtype whose ulp bounds an f64 result computed from a narrower
    float's intermediate (``logb`` of an f32 column by an int)."""
    want = np.asarray(ref.values)
    got = port.values.numpy()
    if got.dtype != want.dtype:
        got = got.view(want.dtype) if got.itemsize == want.itemsize \
            else got
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    if tol is None or want.dtype.kind != "f":
        np.testing.assert_array_equal(got, want)
    else:
        tol_dtype = want.dtype if ulp_of is None else np.dtype(ulp_of)
        ok = _close(got, want, tol_dtype)
        if truth is not None:
            with np.errstate(all="ignore"):
                rounded = np.asarray(truth).astype(want.dtype)
            ok |= _close(got, rounded, tol_dtype)
        assert ok.all(), (got[~ok][:5], want[~ok][:5])
    rv = None if ref.validity is None else np.asarray(ref.validity)
    pv = None if port.validity is None else port.validity.numpy()
    if rv is None or pv is None:
        assert rv is None or rv.all()
        assert pv is None or pv.all()
    else:
        np.testing.assert_array_equal(pv, rv)
    assert type_name(port.type) == type_name(ref.type)


def run_both(fn: str, port_args, ref_args, n: int = N, **options):
    """(port result or the exception it raised, reference result or the
    exception it raised); a reference ErrGuard whose flag is set counts
    as raised."""
    pctx, rctx = contexts(n)
    try:
        got = get_function(fn).impl(pctx, *port_args, **options)
    except Exception as e:  # noqa: BLE001 - compared below
        got = e
    try:
        want = jax_registry.get_function(fn).impl(rctx, *ref_args,
                                                  **options)
        if isinstance(want, ErrGuard):
            want = ArithmeticError(want.msg) if bool(want.flag) \
                else want.result
    except Exception as e:  # noqa: BLE001
        want = e
    return got, want


def assert_same_result(got, want, tol=None, truth=None, ulp_of=None):
    if isinstance(want, Exception):
        assert isinstance(got, Exception), (
            f"the reference raised {want!r}, the port gave {got!r}")
        return
    assert not isinstance(got, Exception), (
        f"the port raised {got!r}, the reference did not")
    assert_same_column(got, want, tol, truth, ulp_of)


# --- round trips ----------------------------------------------------------

@pytest.mark.parametrize("name", [n for n in TYPES if n != "bool"] +
                         ["bool", "null"])
def test_round_trip_matches_reference(name):
    """batch_from_numpy then download equals the reference's upload then
    download of the same values, with nulls and a short row count."""
    rng = np.random.default_rng(11)
    if name == "null":
        batch = batch_from_numpy([("c", "null", np.zeros(N), None, None)],
                                 N, device="cpu")
        ref = at.table({"c": at.array([None] * N, RT.null())})
        assert download(batch)["c"] == \
            download_table(upload_table(ref)).to_pydict()["c"]
        return
    pt, rtype = TYPES[name]
    vals = storage_values(name, rng)
    valid = rng.random(N) > 0.2
    batch = batch_from_numpy([("c", pt, vals, valid, None)], N,
                             device="cpu")
    assert batch.capacity == CAP
    assert batch.column("c").values.dtype == dtypes.STORAGE[
        dtypes.dtype_of_type(pt)]
    ref_col = JaxDeviceColumn(
        jnp.asarray(np.pad(vals, (0, CAP - N))),
        jnp.asarray(np.pad(valid, (0, CAP - N))), rtype)
    from arrow_tpu.device.column import DeviceBatch as JaxBatch
    ref_batch = JaxBatch(RT.schema([RT.field("c", rtype)]), [ref_col],
                         jnp.asarray(N, jnp.int32))
    want = download_table(ref_batch).to_pydict()["c"]
    got = download(batch)["c"]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, float) and np.isnan(w):
            assert np.isnan(g)
        else:
            assert g == w and type(g) is type(w), (g, w)
    # the reference's host upload of those Python values gives them back
    if not (PT.TypeId.TIMESTAMP == pt.id and pt.unit == "ns"):
        host = at.table({"c": at.array(want, rtype)})
        back = download_table(upload_table(host)).to_pydict()["c"]
        for g, w in zip(got, back):
            assert g == w or (isinstance(w, float) and np.isnan(w))


def test_round_trip_decimal_and_temporal_host_values():
    """Decimals from ``decimal.Decimal`` values, timestamps from
    ``datetime64``, durations from ``timedelta64``."""
    decs = [decimal.Decimal("1.25"), decimal.Decimal("-3.10"), None,
            decimal.Decimal("9999999999.99")]
    ts = np.array(["1998-09-02", "1970-01-01", "1969-12-31T23:59:59",
                   "2000-02-29"], "datetime64[s]")
    dur = np.array([1500, -1, 0, 86_400_000], "timedelta64[ms]")
    batch = batch_from_numpy([
        ("d", "decimal128(12, 2)", decs, [True, True, False, True], None),
        ("t", "timestamp[ms]", ts, None, None),
        ("u", "duration[us]", dur, None, None),
        ("e", "date64", np.array(["1995-03-15", "1970-01-02", "1969-12-31",
                                  "2000-01-01"], "datetime64[D]"),
         None, None)], 4, device="cpu")
    got = download(batch)
    assert got["d"] == decs
    assert batch.column("d").values[:4].tolist() == [125, -310, 0,
                                                     999999999999]
    assert got["t"] == [datetime.datetime(1998, 9, 2),
                        datetime.datetime(1970, 1, 1),
                        datetime.datetime(1969, 12, 31, 23, 59, 59),
                        datetime.datetime(2000, 2, 29)]
    assert got["u"] == [datetime.timedelta(milliseconds=1500),
                        datetime.timedelta(milliseconds=-1),
                        datetime.timedelta(0), datetime.timedelta(days=1)]
    assert got["e"] == [datetime.date(1995, 3, 15), datetime.date(1970, 1, 2),
                        datetime.date(1969, 12, 31), datetime.date(2000, 1, 1)]


@pytest.mark.parametrize("spec", ["decimal128(20, 2)", "decimal256(40, 0)",
                                  "fixed_size_binary[4]", "binary"])
def test_refused_types_name_the_host_boundary(spec):
    """These types ride the device as codes over a host dictionary: they
    are named now, and ``batch_from_numpy`` (plain numpy values) refuses
    them, pointing to the host boundary's ``upload_column``."""
    t = PT.type_for_name(spec)
    assert repr(t) == spec
    with pytest.raises(ValueError, match="host boundary"):
        batch_from_numpy([("c", t, [decimal.Decimal(1)], None, None)], 1,
                         device="cpu")


def test_predicates_and_bit_widths_match_reference():
    for name, (pt, rtype) in TYPES.items():
        for pred in ("is_integer", "is_signed_integer",
                     "is_unsigned_integer", "is_floating", "is_numeric",
                     "is_temporal"):
            assert getattr(pt, pred) == getattr(rtype, pred), (name, pred)
        assert pt.bit_width == rtype.bit_width, name
        if "UTC" not in name:
            assert type_name(PT.type_for_name(type_name(rtype))) == \
                type_name(rtype)
        assert dtypes.dtype_of_type(pt) == np.dtype(
            at.device.column.jnp_dtype_for(rtype)).name, name


# --- promotion --------------------------------------------------------------

def _literal_cases():
    out = [("py_int", 3), ("py_neg_int", -2), ("py_float", 1.5),
           ("py_bool", True)]
    for n in NUMERIC:
        out.append((f"np_{n}", np.dtype(n).type(1)))
    return out


_PAIRS = [(a, b) for i, a in enumerate(NUMERIC) for b in NUMERIC[i:]] + \
    [(a, lit) for a in NUMERIC for lit, _ in _literal_cases()]
_LITERALS = dict(_literal_cases())


@pytest.mark.parametrize("fn", ["add", "multiply", "less"])
@pytest.mark.parametrize("pair", _PAIRS, ids=lambda p: f"{p[0]}-{p[1]}")
def test_promotion_matches_jax(pair, fn):
    """Values, dtype and output type of a binary over each pair of column
    dtypes (78 pairs, the 21 that ``torch.promote_types`` refuses among
    them) and each column dtype with each literal kind."""
    a, b = pair
    pa, ra = column_pair(a, 1)
    if b in _LITERALS:
        pb = rb = _LITERALS[b]
    else:
        pb, rb = column_pair(b, 2)
    got, want = run_both(fn, [pa, pb], [ra, rb])
    assert_same_result(got, want)
    got, want = run_both(fn, [pb, pa], [rb, ra])
    assert_same_result(got, want)


# --- registry coverage ------------------------------------------------------

def test_every_reference_elementwise_name_is_registered():
    import arrow_tpu.compute.elementwise  # noqa: F401 - registers
    import arrow_tpu.compute.vector_misc  # noqa: F401
    ref = sorted(n for n, f in jax_registry._REGISTRY.items()
                 if getattr(f.impl, "__module__", "").endswith(
                     "compute.elementwise"))
    assert len(ref) >= 90
    missing = []
    for n in ref + ["case_when"]:
        try:
            get_function(n)
        except NotImplementedError:
            missing.append(n)
    assert missing == []


# --- cast -------------------------------------------------------------------

_CAST_TARGETS = NUMERIC + ("date32", "date64", "timestamp[s]",
                           "timestamp[ns]", "time32[ms]", "time64[us]",
                           "duration[ms]", "decimal128(12, 2)")


@pytest.mark.parametrize("safe", [False, True])
@pytest.mark.parametrize("dst", _CAST_TARGETS)
@pytest.mark.parametrize("src", NUMERIC + ("date32", "date64",
                                           "timestamp[s]", "timestamp[ns]",
                                           "time32[s]", "time64[ns]",
                                           "duration[ns]",
                                           "decimal128(12, 2)"))
def test_cast_matrix_matches_jax(src, dst, safe):
    """Every source to every target, safe and unsafe: the same values,
    type and validity, and a safe cast that loses data raises where the
    reference's deferred error would."""
    pa, ra = column_pair(src, 5)
    got, want = _cast_both(pa, ra, dst, safe)
    assert_same_result(got, want)


def _cast_both(pa, ra, dst, safe):
    pctx, rctx = contexts()
    try:
        got = get_function("cast").impl(pctx, pa, to_type=TYPES[dst][0],
                                        safe=safe)
    except Exception as e:  # noqa: BLE001
        got = e
    try:
        want = jax_registry.get_function("cast").impl(
            rctx, ra, to_type=TYPES[dst][1], safe=safe)
        if isinstance(want, ErrGuard):
            want = ValueError(want.msg) if bool(want.flag) else want.result
    except Exception as e:  # noqa: BLE001
        want = e
    return got, want


@pytest.mark.parametrize("src,dst,values", [
    ("float64", "int8", [1.0, 127.0, -128.0, 2.5]),
    ("float64", "uint32", [0.0, 4294967295.0, -1.0]),
    ("float32", "int64", [1.0, np.nan]),
    ("int64", "int16", [1, 32767, 40000]),
    ("int64", "uint8", [0, 255, -1]),
    ("uint64", "uint32", [0, 2 ** 32]),
    ("float64", "decimal128(12, 2)", [12345.0, 0.5]),
])
def test_cast_safe_failures(src, dst, values):
    """Each safe failure raises ValueError in the port; the same values
    cast unsafely agree with the reference."""
    v = np.zeros(N, dtype=np.dtype(dtypes.dtype_of_type(TYPES[src][0])))
    v[:len(values)] = np.array(values).astype(v.dtype)
    pa, ra = column_pair(src, 3, nulls=False, values=v)
    got, want = _cast_both(pa, ra, dst, True)
    assert isinstance(want, ValueError) and isinstance(got, ValueError)
    got, want = _cast_both(pa, ra, dst, False)
    assert_same_result(got, want)


@pytest.mark.parametrize("src,dst", [
    ("date32", "timestamp[s]"), ("date32", "date64"), ("date64", "date32"),
    ("timestamp[ns]", "timestamp[s]"), ("timestamp[s]", "timestamp[ns]"),
    ("timestamp[s]", "date32"), ("duration[ns]", "duration[ms]"),
    ("time32[s]", "time64[ns]"), ("time64[ns]", "time32[ms]")])
def test_temporal_rescales_both_ways(src, dst):
    """A finer unit multiplies, a coarser one floor-divides (negative
    counts round down), as the reference's ``_temporal_rescale``."""
    v = np.zeros(N, dtype=np.dtype(dtypes.dtype_of_type(TYPES[src][0])))
    v[:6] = [0, 1, -1, 86_399, -86_401, 12_345]
    pa, ra = column_pair(src, 4, values=v)
    got, want = _cast_both(pa, ra, dst, True)
    assert_same_result(got, want)
