"""The element-wise functions the port gained with the type set, against
the JAX package: each over every type of the reference's device set, with
null rows and dead (padding) rows, values, validity and output type
compared. Where the reference raises (or its deferred error is set), the
port raises.

Tolerances: exact for integer, bool, decimal and temporal results, and for
float ``+ - * /``, comparisons, ``floor``, ``ceil``, ``trunc``, ``round``
and ``sign``; the transcendental unaries (and ``power``, ``atan2``,
``logb``) within rtol 1e-9 at f64 and 1 ulp of their dtype at f32 and
f16.
"""

import numpy as np
import pytest

from test_torch_types import (N, TYPES, assert_same_result, column_pair,
                              run_both)
from worker_settings import collect_after_test, gc_off_in_module  # noqa: F401

ALL = tuple(TYPES)

TRANSCENDENTAL = ("sqrt", "exp", "expm1", "ln", "log2", "log10", "log1p",
                  "sin", "cos", "tan", "asin", "acos", "atan", "sinh",
                  "cosh", "tanh", "asinh", "acosh", "atanh")
EXACT_UNARY = ("abs", "sign", "negate", "floor", "ceil", "trunc",
               "bit_wise_not", "is_nan", "is_finite", "is_inf", "is_null",
               "is_valid", "true_unless_null", "round",
               "round_to_multiple")
ALIASES = {"abs_checked": "abs", "negate_checked": "negate",
           "sqrt_checked": "sqrt", "ln_checked": "ln",
           "log2_checked": "log2", "log10_checked": "log10",
           "log1p_checked": "log1p", "sin_checked": "sin",
           "cos_checked": "cos", "tan_checked": "tan",
           "asin_checked": "asin", "acos_checked": "acos",
           "acosh_checked": "acosh", "atanh_checked": "atanh",
           "divide_checked": "divide", "power_checked": "power",
           "logb_checked": "logb", "shift_left_checked": "shift_left",
           "shift_right_checked": "shift_right"}


_NUMPY = {"sqrt": np.sqrt, "exp": np.exp, "expm1": np.expm1, "ln": np.log,
          "log2": np.log2, "log10": np.log10, "log1p": np.log1p,
          "sin": np.sin, "cos": np.cos, "tan": np.tan, "asin": np.arcsin,
          "acos": np.arccos, "atan": np.arctan, "sinh": np.sinh,
          "cosh": np.cosh, "tanh": np.tanh, "asinh": np.arcsinh,
          "acosh": np.arccosh, "atanh": np.arctanh}


def _f64(col) -> np.ndarray:
    """A reference column's values as f64, as the reference converts
    them (unsigned values unsigned)."""
    return np.asarray(col.values).astype(np.float64)


@pytest.mark.parametrize("name", ALL)
@pytest.mark.parametrize("fn", TRANSCENDENTAL + EXACT_UNARY)
def test_unary_matches_jax(fn, name):
    pa, ra = column_pair(name, 21)
    got, want = run_both(fn, [pa], [ra])
    truth = None
    if fn in TRANSCENDENTAL:
        with np.errstate(all="ignore"):
            truth = _NUMPY[fn](_f64(ra))
    assert_same_result(got, want,
                       "ulp" if fn in TRANSCENDENTAL else None, truth)


@pytest.mark.parametrize("name", ("float16", "float32", "float64"))
@pytest.mark.parametrize("ndigits", [0, 2, -1])
@pytest.mark.parametrize("mode", [
    "half_to_even", "down", "up", "towards_zero", "towards_infinity",
    "half_down", "half_up", "half_towards_zero", "half_towards_infinity",
    "half_to_odd"])
def test_round_modes_match_jax(mode, ndigits, name):
    rng = np.random.default_rng(3)
    # halves and near-halves, where the modes differ
    v = (rng.integers(-400, 400, N) / 4.0).astype(name)
    pa, ra = column_pair(name, 22, values=v)
    got, want = run_both("round", [pa], [ra], ndigits=ndigits,
                         round_mode=mode)
    assert_same_result(got, want)
    got, want = run_both("round_to_multiple", [pa], [ra], multiple=0.5,
                         round_mode=mode)
    assert_same_result(got, want)


def _second(fn, name, seed):
    """The second operand of a binary: for the shifts, amounts around the
    width (negative ones too); else another seeded column."""
    if not fn.startswith("shift"):
        return column_pair(name, seed)
    port, ref = column_pair(name, seed)
    width = 8 * port.values.element_size()
    amounts = np.random.default_rng(seed).integers(-2, width + 3, N)
    return column_pair(name, seed, values=amounts.astype(
        np.asarray(ref.values).dtype))


BINARY = ("add_checked", "subtract_checked", "multiply_checked", "power",
          "atan2", "logb", "bit_wise_and", "bit_wise_or", "bit_wise_xor",
          "shift_left", "shift_right", "xor", "and_not", "and_not_kleene",
          "min_element_wise", "max_element_wise", "coalesce", "fill_null",
          "divide")
FLOAT_BINARY = ("power", "atan2", "logb")


def _binary_truth(fn, a, b):
    """The f64 value of a float binary over reference columns or
    literals, or None."""
    if fn not in FLOAT_BINARY:
        return None
    x, y = (_f64(v) if hasattr(v, "values") else np.float64(v)
            for v in (a, b))
    with np.errstate(all="ignore"):
        return {"power": np.power, "atan2": np.arctan2,
                "logb": lambda p, q: np.log(p) / np.log(q)}[fn](x, y)


@pytest.mark.parametrize("name", ALL)
@pytest.mark.parametrize("fn", BINARY)
def test_binary_matches_jax(fn, name):
    """Column with column of one type, then with an int and a float
    literal on either side."""
    pa, ra = column_pair(name, 31)
    pb, rb = _second(fn, name, 32)
    tol = "ulp" if fn in FLOAT_BINARY else None
    got, want = run_both(fn, [pa, pb], [ra, rb])
    assert_same_result(got, want, tol, _binary_truth(fn, ra, rb))
    for lit in (3, 0.5):
        if fn in ("coalesce", "fill_null"):
            got, want = run_both(fn, [pa, lit], [ra, lit])
            assert_same_result(got, want, tol)
            continue
        # logb of a narrow float by an int: its f32/f16 log bounds the f64
        ulp_of = name if fn == "logb" and name in ("float16",
                                                   "float32") else None
        got, want = run_both(fn, [pa, lit], [ra, lit])
        assert_same_result(got, want, tol, _binary_truth(fn, ra, lit),
                           ulp_of)
        got, want = run_both(fn, [lit, pa], [lit, ra])
        assert_same_result(got, want, tol, _binary_truth(fn, lit, ra),
                           ulp_of)


@pytest.mark.parametrize("pair", [("int8", "int32"), ("uint8", "int8"),
                                  ("uint32", "int64"), ("int64", "uint64"),
                                  ("float16", "int64"), ("uint16", "float32"),
                                  ("date32", "int32")],
                         ids=lambda p: f"{p[0]}-{p[1]}")
@pytest.mark.parametrize("fn", ["min_element_wise", "max_element_wise",
                                "coalesce", "power", "atan2",
                                "bit_wise_or", "shift_left"])
def test_mixed_binary_matches_jax(fn, pair):
    pa, ra = column_pair(pair[0], 41)
    pb, rb = column_pair(pair[1], 42)
    tol = "ulp" if fn in FLOAT_BINARY else None
    got, want = run_both(fn, [pa, pb], [ra, rb])
    assert_same_result(got, want, tol, _binary_truth(fn, ra, rb))


@pytest.mark.parametrize("name", ALL)
@pytest.mark.parametrize("inclusive", ["both", "left", "right", "neither"])
def test_between_matches_jax(name, inclusive):
    px, rx = column_pair(name, 51)
    pl, rl = column_pair(name, 52)
    ph, rh = column_pair(name, 53)
    got, want = run_both("between", [px, pl, ph], [rx, rl, rh],
                         inclusive=inclusive)
    assert_same_result(got, want)
    got, want = run_both("between", [px, 0, 100], [rx, 0, 100],
                         inclusive=inclusive)
    assert_same_result(got, want)


@pytest.mark.parametrize("name", ALL)
@pytest.mark.parametrize("skip_nulls", [True, False])
def test_three_way_min_max_and_coalesce_match_jax(name, skip_nulls):
    cols = [column_pair(name, s) for s in (61, 62, 63)]
    p = [c[0] for c in cols]
    r = [c[1] for c in cols]
    for fn in ("min_element_wise", "max_element_wise"):
        got, want = run_both(fn, p, r, skip_nulls=skip_nulls)
        assert_same_result(got, want)
    got, want = run_both("coalesce", p + [7], r + [7])
    assert_same_result(got, want)


@pytest.mark.parametrize("name", ALL)
def test_choose_matches_jax(name):
    """Indices in range, negative and out of range, with null indices and
    null cases."""
    rng = np.random.default_rng(71)
    pi, ri = column_pair("int8", 72,
                         values=rng.integers(-4, 5, N).astype(np.int8))
    cols = [column_pair(name, s) for s in (73, 74, 75)]
    got, want = run_both("choose", [pi] + [c[0] for c in cols],
                         [ri] + [c[1] for c in cols])
    assert_same_result(got, want)


@pytest.mark.parametrize("name", ALL)
def test_case_when_matches_jax(name):
    c1 = column_pair("bool", 81)
    c2 = column_pair("bool", 82)
    v1 = column_pair(name, 83)
    v2 = column_pair(name, 84)
    for extra in ([], [v2]):
        got, want = run_both(
            "case_when", [[c1[0], c2[0]], v1[0], v2[0]] + [x[0]
                                                           for x in extra],
            [[c1[1], c2[1]], v1[1], v2[1]] + [x[1] for x in extra])
        assert_same_result(got, want)


@pytest.mark.parametrize("name,bounds", [
    ("int8", (-128, 127)), ("int16", (-32768, 32767)),
    ("uint32", (0, 2 ** 32 - 1)), ("int64", (-2 ** 63, 2 ** 63 - 1))])
@pytest.mark.parametrize("fn", ["add_checked", "subtract_checked",
                                "multiply_checked"])
def test_checked_arithmetic_raises_at_the_bounds(fn, name, bounds):
    """At the type's bounds the checked forms raise ArithmeticError where
    the reference's deferred flag is set, and agree with it (and with the
    plain form's wrapped values) where it is not."""
    lo, hi = bounds
    dt = np.asarray(column_pair(name, 1)[1].values).dtype
    a = np.zeros(N, dtype=dt)
    b = np.zeros(N, dtype=dt)
    a[:4] = [hi, lo, hi, 2]
    b[:4] = {"add_checked": [1, 0, 0, 3], "subtract_checked": [0, 1, 0, 1],
             "multiply_checked": [2, 1, 1, 5]}[fn]
    if name.startswith("uint") and fn == "subtract_checked":
        a[1], b[1] = 0, 1
    pa, ra = column_pair(name, 91, nulls=False, values=a)
    pb, rb = column_pair(name, 92, nulls=False, values=b)
    got, want = run_both(fn, [pa, pb], [ra, rb])
    assert isinstance(want, Exception) and isinstance(got, ArithmeticError)
    # the rows that overflow, nulled, no longer raise
    ok = [2, 3]
    a2, b2 = np.zeros(N, dtype=dt), np.zeros(N, dtype=dt)
    a2[ok], b2[ok] = a[ok], b[ok]
    pa, ra = column_pair(name, 93, nulls=False, values=a2)
    pb, rb = column_pair(name, 94, nulls=False, values=b2)
    got, want = run_both(fn, [pa, pb], [ra, rb])
    assert_same_result(got, want)
    plain = fn[:-len("_checked")]
    got_plain, _ = run_both(plain, [pa, pb], [ra, rb])
    assert got_plain.values.equal(got.values)


@pytest.mark.parametrize("alias", sorted(ALIASES))
def test_checked_aliases_are_their_plain_forms(alias):
    from arrow_tpu_torch.compute.registry import get_function
    assert get_function(alias) is get_function(ALIASES[alias])
    from arrow_tpu.compute import registry as jax_registry
    assert jax_registry.get_function(alias).impl is \
        jax_registry.get_function(ALIASES[alias]).impl
