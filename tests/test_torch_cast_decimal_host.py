"""The host cast matrix (``compute/cast_host.py``), the cast to a string
type (``registry._cast_to_string_host``) and exact compute on decimals
wider than 18 digits (``compute/decimal_host.py``) against the JAX package
on the same host values, made from a seed with numpy, through both
packages' ``call_function`` (the port's on ``device="cpu"``); and a plan's
cast of a non-dictionary column to a string, which raises ValueError in
both. Tolerance: types and values exact."""

import datetime as dt
import decimal

import numpy as np
import pytest

import arrow_tpu as at
import arrow_tpu.acero as jac
import arrow_tpu_torch.acero as pac
import arrow_tpu_torch.types as PT
from arrow_tpu_torch.compute import cast_host, decimal_host

from test_torch_host_kernels import check
from test_torch_host_table import carry_table, port_type
from worker_settings import collect_after_test, gc_off_in_module  # noqa: F401

D = decimal.Decimal


def _cast(a, t, safe=True):
    return check("cast", [a], {"to_type": t, "safe": safe})


# --- casts to strings -------------------------------------------------------------

def _values(kind, seed=1, n=16):
    rng = np.random.default_rng(seed)
    nulls = rng.random(n) < 0.2
    if kind in ("int8", "int64", "uint32", "uint64"):
        info = np.iinfo(kind)
        v = [int(x) for x in rng.integers(max(info.min, -2**40),
                                          min(info.max, 2**40), n)]
    elif kind in ("float32", "float64"):
        v = [float(x) for x in rng.normal(scale=1e3, size=n).astype(kind)]
        v[:3] = [float("nan"), -0.0, float("inf")]
    elif kind == "bool":
        v = [bool(x) for x in rng.integers(0, 2, n)]
    elif kind in ("date32", "date64"):
        v = [dt.date(1970, 1, 1) + dt.timedelta(days=int(x))
             for x in rng.integers(-5000, 20000, n)]
    elif kind.startswith("decimal"):
        v = [D(int(x)).scaleb(-2) for x in rng.integers(-10**6, 10**6, n)]
    else:
        v = [int(x) for x in rng.integers(-10**15, 10**15, n)]
    return [None if m else x for x, m in zip(v, nulls)]


STRING_SOURCES = ["int8", "int64", "uint32", "uint64", "float32", "float64",
                  "bool", "date32", "date64", "timestamp[s]",
                  "timestamp[ms]", "timestamp[us]", "timestamp[ns]",
                  "decimal128(12, 2)", "decimal128(38, 2)", "duration[ms]"]


def _rtype(name):
    from arrow_tpu.api import type_for_alias
    if name.startswith("decimal128("):
        p, s = name[len("decimal128("):-1].split(",")
        return at.decimal128(int(p), int(s))
    return type_for_alias(name)


@pytest.mark.parametrize("to", ["string", "large_string"])
@pytest.mark.parametrize("src", STRING_SOURCES)
def test_cast_to_string(src, to):
    rt = _rtype(src)
    ra = at.array(_values(src), rt)
    for v in (ra, ra.slice(3, 8)):
        _cast(v, _rtype(to))


def test_cast_string_to_string_and_back():
    ra = at.array(["1.5", None, "-2", "1e3"])
    _cast(ra, at.large_string())
    for t in (at.float64(), at.int64()):
        _cast(ra, t)


# --- the host matrix -----------------------------------------------------------

MATRIX = [
    # (values, source type, target type)
    ([1, None, 3], at.int64(), at.null()),
    ([None, None], at.null(), at.int32()),
    ([None, None], at.null(), at.string()),
    (["a", None, "b", "a"], at.string(), at.dictionary(at.int32(),
                                                        at.string())),
    ([1, None, 300], at.int64(), at.dictionary(at.int8(), at.int16())),
    (["x", "y", None], at.dictionary(at.int32(), at.string()), at.binary()),
    ([[1, 2], None, [3]], at.list_(at.int64()), at.list_(at.float64())),
    ([[1, 2], None, [3, 4]], at.list_(at.int64()),
     at.fixed_size_list(at.int32(), 2)),
    ([[1, 2], [3]], at.list_(at.int64()), at.fixed_size_list(at.int32(), 2)),
    ([[1, 2], None], at.large_list(at.int32()), at.list_(at.string())),
    ([{"a": 1, "b": "x"}, None], at.struct([("a", at.int64()),
                                             ("b", at.string())]),
     at.struct([("a", at.float64()), ("c", at.int64())])),
    ([[("k", 1)], None], at.map_(at.string(), at.int64()),
     at.map_(at.string(), at.float64())),
    ([b"ab", None, b"\xff"], at.binary(), at.string()),
    ([b"ab", None], at.binary(), at.string()),
    (["ab", None], at.string(), at.binary()),
    (["abc", None], at.string(), at.fixed_size_binary(3)),
    (["ab", None], at.string(), at.fixed_size_binary(3)),
    ([b"abcd", None], at.fixed_size_binary(4), at.large_binary()),
    ([D("1.25"), None, D("-3.50")], at.decimal128(10, 2), at.int64()),
    ([D("1.00"), None, D("-3.00")], at.decimal128(10, 2), at.int8()),
    ([D("1.25"), None], at.decimal128(38, 2), at.float64()),
    ([D("1.25"), None], at.decimal128(10, 2), at.decimal128(38, 4)),
    ([D("1.255"), None], at.decimal128(10, 3), at.decimal128(10, 2)),
    ([1, None, 123456], at.int64(), at.decimal128(38, 2)),
    ([1, None, 123456], at.int64(), at.decimal128(5, 2)),
    ([1.5, None, 2.675], at.float64(), at.decimal128(20, 2)),
    (["1.5", None, "7"], at.string(), at.decimal128(20, 3)),
    ([D("7.00"), None], at.decimal256(40, 2), at.decimal128(12, 2)),
]


@pytest.mark.parametrize("safe", [True, False])
@pytest.mark.parametrize("case", range(len(MATRIX)))
def test_try_cast_host_matrix(case, safe):
    vals, src, dst = MATRIX[case]
    ra = at.array(vals, src)
    got = _cast(ra, dst, safe)
    if got is not None:
        assert cast_host._needs_host(port_type(src), port_type(dst))


def test_cast_that_stays_on_the_device():
    assert not cast_host._needs_host(PT.int64(), PT.float64())
    assert cast_host.try_cast_host([None], {"to_type": PT.int8()}) is None
    _cast(at.array([1, None, 2]), at.float32())


# --- a plan's cast to a string --------------------------------------------------

def test_plan_cast_to_string_raises_in_both():
    """A non-dictionary column cast to a string in a plan: codes without
    a dictionary in the reference, whose download refuses them with
    ValueError; the port raises the same ValueError in the cast."""
    rt = at.table({"x": [1, 2, None], "s": ["a", "b", "c"]})

    def plan(ac, tbl, to):
        return ac.Declaration.from_sequence([
            ac.Declaration("table_source", ac.TableSourceNodeOptions(tbl)),
            ac.Declaration("project", ac.ProjectNodeOptions(
                [ac.Expression.call("cast", ac.field("x"), to_type=to)],
                ["xs"]))])

    with pytest.raises(ValueError, match="missing dictionary"):
        plan(jac, rt, at.string()).to_table()
    with pytest.raises(ValueError, match="missing dictionary"):
        plan(pac, carry_table(rt), PT.string()).to_table(device="cpu")
    with pytest.raises(ValueError, match="in a plan"):
        plan(pac, carry_table(rt), PT.decimal128(38, 2)).to_table(
            device="cpu")


# --- wide decimals -------------------------------------------------------------

def _wide(seed, n=20, scale=2, t=None, nulls=0.2):
    rng = np.random.default_rng(seed)
    vals = [None if rng.random() < nulls else
            D(int(x) * 10**12 + int(y)).scaleb(-scale)
            for x, y in zip(rng.integers(-10**6, 10**6, n),
                            rng.integers(0, 10**12, n))]
    return at.array(vals, t or at.decimal128(38, scale))


@pytest.mark.parametrize("name", ["sum", "mean", "product", "min", "max",
                                  "min_max", "variance", "stddev",
                                  "approximate_median"])
@pytest.mark.parametrize("opts", [{}, {"skip_nulls": False},
                                  {"min_count": 30}])
def test_wide_decimal_aggregates(name, opts):
    for ra in (_wide(1), _wide(2, nulls=0.0), _wide(3).slice(4, 9),
               _wide(4, t=at.decimal256(60, 2)), _wide(5, n=0)):
        check(name, [ra], opts or None)


def test_wide_decimal_quantile():
    check("quantile", [_wide(6)], {"q": 0.3})
    check("quantile", [_wide(6)], {"q": 0.5, "interpolation": "lower"})


@pytest.mark.parametrize("name", ["add", "subtract", "multiply",
                                  "add_checked", "multiply_checked"])
def test_wide_decimal_arithmetic(name):
    a, b = _wide(7, scale=2), _wide(8, scale=3, t=at.decimal128(30, 3))
    check(name, [a, b])
    check(name, [a.slice(2, 6), b.slice(5, 6)])
    check(name, [a, D("1.5")])
    check(name, [a, 3])
    check(name, [_wide(9, t=at.decimal256(70, 2)), a])


@pytest.mark.parametrize("name", ["negate", "abs", "sign", "abs_checked"])
def test_wide_decimal_unary(name):
    check(name, [_wide(10)])


@pytest.mark.parametrize("name", ["divide", "first_last", "cumulative_sum",
                                  "mode"])
def test_wide_decimal_without_a_kernel(name):
    """The reference has no kernel of these for a wide decimal; both
    raise."""
    with pytest.raises(ValueError):
        decimal_host.maybe_wide_decimal_call(
            name, [decimal_host.make_array([D("1.00")],
                                           PT.decimal128(38, 2))], {})
    check(name, [_wide(11)])


def test_multiply_past_the_ceiling():
    check("multiply", [_wide(12), _wide(13)])


def test_not_a_wide_decimal():
    assert decimal_host.maybe_wide_decimal_call(
        "sum", [decimal_host.make_array([D("1.00")], PT.decimal128(12, 2))],
        {}) is None
