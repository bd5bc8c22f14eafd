"""The port's eager compute API (``compute/__init__.py``,
``compute/registry.py``'s ``call_function``, ``compute/dispatch.py``, the
Array/Table methods that call compute) against the JAX package's on the
same host values, made from a seed with numpy: the names that
``tests/test_compute.py`` and ``tests/test_dispatch.py`` call, with
``dispatch.py``'s implicit casts, and ``Table.filter``/``take``/
``sort_by``/``group_by``. Every port call names ``device="cpu"``.
Tolerance: values, validity and order exact, floats within rtol 1e-9."""

import datetime as dt
import decimal
import importlib
import math

import numpy as np
import pytest

import arrow_tpu as at
import arrow_tpu.compute as jpc
import arrow_tpu_torch.compute as pc
import arrow_tpu_torch.types as PT
from arrow_tpu_torch.array.array import array
from arrow_tpu_torch.compute.registry import Scalar

from test_torch_host_table import carry_array, carry_table, port_type
from worker_settings import collect_after_test, gc_off_in_module  # noqa: F401

ttable = importlib.import_module("arrow_tpu_torch.table")
RTOL = 1e-9
N = 40


def _close(a, b):
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (math.isnan(a) and math.isnan(b)) or \
            math.isclose(a, b, rel_tol=RTOL)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_close(x, y) for x, y in zip(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_close(a[k], b[k]) for k in a)
    return a == b and type(a) is type(b) or (a == b and not isinstance(
        a, (bool, float)) and not isinstance(b, (bool, float)))


def _py(r):
    if hasattr(r, "to_pylist"):
        return r.to_pylist()
    if hasattr(r, "as_py"):
        return r.as_py()
    if isinstance(r, dict):
        return {k: _py(v) for k, v in r.items()}
    return r


def _port_arg(a):
    if isinstance(a, at.Array):
        return carry_array(a)
    if isinstance(a, at.DataType):
        return port_type(a)
    return a


def both(name, *args, **opts):
    """``name`` through both packages' public API on the same values (the
    reference's Arrays carried across); the two results as Python
    values."""
    want = getattr(jpc, name)(*args, **opts)
    got = getattr(pc, name)(*[_port_arg(a) for a in args], device="cpu",
                            **{k: _port_arg(v) for k, v in opts.items()})
    assert type(got).__name__ == type(want).__name__ or (
        isinstance(want, dict) and isinstance(got, dict)), name
    g, w = _py(got), _py(want)
    assert _close(g, w), (name, g, w)
    return got


def _ints(seed, n=N, lo=-50, hi=50, nulls=0.15):
    rng = np.random.default_rng(seed)
    return at.array([None if rng.random() < nulls else int(v)
                     for v in rng.integers(lo, hi, n)])


def _floats(seed, n=N, nulls=0.15):
    rng = np.random.default_rng(seed)
    v = [None if rng.random() < nulls else float(x)
         for x in rng.standard_normal(n) * 100]
    v[1] = float("nan")
    return at.array(v)


def _strings(seed, n=N, nulls=0.15):
    rng = np.random.default_rng(seed)
    words = ["pear", "apple", "fig", "", "kiwi", "Äpfel"]
    return at.array([None if rng.random() < nulls else words[int(i)]
                     for i in rng.integers(0, len(words), n)])


def _bools(seed, n=N, nulls=0.15):
    rng = np.random.default_rng(seed)
    return at.array([None if rng.random() < nulls else bool(v)
                     for v in rng.integers(0, 2, n)])


UNARY = ["negate", "abs", "round", "invert", "cumulative_sum",
         "cumulative_min", "cumulative_max", "pairwise_diff", "unique",
         "drop_null", "array_sort_indices", "sum", "mean", "count",
         "count_distinct", "min_max", "variance", "stddev", "first", "last",
         "hash32", "is_null", "is_valid"]


@pytest.mark.parametrize("name", UNARY)
@pytest.mark.parametrize("kind", ["int64", "float64"])
def test_unary_names_match_reference(name, kind):
    if name == "invert":
        a = _bools(3)
    else:
        a = _ints(1) if kind == "int64" else _floats(2)
    both(name, a)


@pytest.mark.parametrize("name", ["add", "subtract", "multiply", "divide",
                                  "min_element_wise", "max_element_wise",
                                  "equal", "less", "greater_equal",
                                  "coalesce"])
@pytest.mark.parametrize("kinds", [("int64", "int64"),
                                   ("float64", "int64"),
                                   ("float64", "scalar")])
def test_binary_names_match_reference(name, kinds):
    a = _ints(4) if kinds[0] == "int64" else _floats(5)
    b = _ints(6, lo=1, hi=9) if kinds[1] == "int64" else 3
    if name == "divide" and kinds == ("int64", "int64"):
        b = at.array([v if v else 1 for v in b.to_pylist()])
    both(name, a, b)


def test_boolean_and_selection_names():
    a, b, c = _bools(7), _bools(8), _bools(9)
    for name in ("and_", "or_", "any", "all"):
        both(name, *((a, b) if name in ("and_", "or_") else (a,)))
    both("if_else", c, _ints(10), _ints(11))
    both("fill_null", _ints(12), 99)
    both("filter", _ints(13), a)
    both("filter", _ints(13), a, null_selection_behavior="emit_null")
    idx = at.array([3, 0, None, 39, 7])
    both("take", _floats(14), idx)
    both("sort_indices", _floats(15))
    both("select_k_unstable", _ints(16, nulls=0), k=5)
    for tb in ("first", "min", "max", "dense"):
        both("rank", _ints(17, lo=0, hi=6), tiebreaker=tb)
    both("value_counts", _strings(18))
    # no NaN: the reference counts NaN rows in a quantile, Arrow and the
    # port do not (ROADMAP.md section 3)
    both("quantile", at.array([float(v) for v in np.random.default_rng(
        19).standard_normal(N)]), q=0.25, interpolation="linear")
    both("top_k_unstable", _ints(20, nulls=0), 4)
    both("bottom_k_unstable", _ints(20, nulls=0), 4)
    both("dictionary_encode", _strings(21))
    both("add_checked", _ints(22), _ints(23))
    with pytest.raises(Exception):
        pc.add_checked(array([2 ** 62]), array([2 ** 62]), device="cpu")


def test_partition_nth_meets_its_contract():
    a = _ints(24, nulls=0)
    got = pc.partition_nth_indices(carry_array(a), pivot=10,
                                   device="cpu").to_pylist()
    vals = a.to_pylist()
    assert sorted(got) == list(range(len(vals)))
    pivot = vals[got[10]]
    assert all(vals[i] <= pivot for i in got[:10])
    assert all(vals[i] >= pivot for i in got[11:])


@pytest.mark.parametrize("target", [at.int32(), at.float32(), at.int8(),
                                    at.bool_(), at.float64()])
def test_cast_matches_reference(target):
    a = at.array([1.0, None, 3.0, 0.0])
    both("cast", a, to_type=target)
    got = pc.cast(carry_array(a), port_type(target), device="cpu")
    assert got.to_pylist() == jpc.cast(a, target).to_pylist()
    assert carry_array(a).cast(port_type(target), device="cpu").type == \
        port_type(target)
    with pytest.raises(Exception):
        pc.cast(array([300]), to_type=PT.int8(), device="cpu")


# --- dispatch.py's implicit casts (tests/test_dispatch.py's cases) -----------

def test_string_dictionary_dispatch():
    both("equal", at.array(["a", "b", "c"]), at.array(["a", "x", "c"]))
    both("less", at.array(["a", "c", "b"]), at.array(["b", "b", "b"]))
    both("equal", at.array(["a", "b", "c"]), "b")
    both("less", at.array(["a", "b", "c"]), "b")
    both("equal", at.array(["a", "b"]), "zz")
    both("equal", _strings(30), _strings(31))
    both("min_element_wise", at.array(["b", "a"]), at.array(["a", "c"]))
    both("fill_null", at.array(["a", None]), "zz")
    both("if_else", at.array([True, False]), at.array(["y", "z"]),
         at.array(["n", "m"]))
    d = at.array(["a", "b"], at.dictionary(at.int32(), at.string()))
    e = at.array(["b", "b"], at.dictionary(at.int32(), at.string()))
    both("equal", d, e)


def test_numeric_dictionary_decays():
    d = at.array([10, 20, 10], at.dictionary(at.int32(), at.int64()))
    both("equal", d, at.array([10, 20, 30], at.int64()))


def test_temporal_dispatch():
    both("equal", at.array([1], at.timestamp("s")),
         at.array([1000], at.timestamp("ms")))
    both("equal", at.array([dt.date(2020, 1, 1)], at.date32()),
         at.array([dt.datetime(2020, 1, 1)], at.timestamp("us")))
    both("equal", at.array([dt.date(2020, 1, 1), dt.date(2020, 1, 2)],
                           at.date32()), dt.date(2020, 1, 2))
    both("less", at.array([1, 5], at.duration("s")),
         at.array([2000, 4000], at.duration("ms")))


@pytest.mark.parametrize("la, lb, ta, tb", [
    ([1, 2], [1.5, 2.5], at.int32(), at.float64()),
    ([1], [1000], at.int8(), at.int16()),
    ([200], [100], at.uint8(), at.int8()),
])
def test_numeric_promotion_matches_reference(la, lb, ta, tb):
    got = both("add", at.array(la, ta), at.array(lb, tb))
    want = jpc.add(at.array(la, ta), at.array(lb, tb))
    assert got.type == port_type(want.type)


def test_decimal_literal_dispatch():
    a = at.array([decimal.Decimal("1.25"), None], at.decimal128(12, 2))
    both("equal", a, decimal.Decimal("1.25"))


# --- host values of every shape ------------------------------------------------

def test_call_function_takes_chunked_arrays_scalars_and_columns():
    t = at.table({"x": [1, 2, None, 4], "y": [0.5, 1.5, 2.5, None]})
    tt = carry_table(t)
    got = pc.call_function("add", [tt.column("x"), Scalar(2, PT.int64())],
                           device="cpu")
    assert got.to_pylist() == jpc.call_function(
        "add", [t.column("x"), 2]).to_pylist()
    two = ttable.ChunkedArray([array([1, 2]), array([None, 4])])
    assert pc.call_function("multiply", [two, 3], device="cpu"
                            ).to_pylist() == [3, 6, None, 12]
    assert pc.sum(tt.column("y"), device="cpu").as_py() == 4.5
    assert "add" in pc.list_functions() and "hash_list" in \
        pc.list_functions()
    assert pc.get_function("hash_sum").kind == "hash_aggregate"
    with pytest.raises(AttributeError):
        pc.hash_sum
    with pytest.raises(AttributeError):
        pc.no_such_function


def test_array_methods_call_the_eager_api():
    a = carry_array(_ints(40))
    ref = _ints(40)
    assert a.filter(carry_array(_bools(41)), device="cpu").to_pylist() == \
        ref.filter(_bools(41)).to_pylist()
    assert a.take(array([0, 2]), device="cpu").to_pylist() == \
        ref.take(at.array([0, 2])).to_pylist()
    assert a.drop_null(device="cpu").to_pylist() == ref.drop_null(
        ).to_pylist()
    assert a.sort(device="cpu").to_pylist() == ref.sort().to_pylist()
    assert a.unique(device="cpu").to_pylist() == ref.unique().to_pylist()
    assert a.fill_null(0, device="cpu").to_pylist() == \
        ref.fill_null(0).to_pylist()
    assert a.is_null(device="cpu").to_pylist() == ref.is_null().to_pylist()
    assert a.sum(device="cpu").as_py() == ref.sum().as_py()
    assert a.dictionary_encode(device="cpu").to_pylist() == \
        ref.dictionary_encode().to_pylist()
    assert a.value_counts(device="cpu").to_pylist() == \
        ref.value_counts().to_pylist()


# --- the Table forms ------------------------------------------------------------

def _table(seed=50, n=60):
    rng = np.random.default_rng(seed)
    return at.table({
        "k": [None if rng.random() < 0.1 else f"k{int(v)}"
              for v in rng.integers(0, 5, n)],
        "i": [None if rng.random() < 0.1 else int(v)
              for v in rng.integers(0, 100, n)],
        "f": [float(v) for v in rng.standard_normal(n)],
        "d": [dt.date(2020, 1, 1) + dt.timedelta(days=int(v))
              for v in rng.integers(0, 400, n)]})


def test_table_filter_take_sort_group_by_match_reference():
    ref = _table()
    t = carry_table(ref)
    mask = _bools(51, n=ref.num_rows)
    assert t.filter(carry_array(mask), device="cpu").to_pydict() == \
        ref.filter(mask).to_pydict()
    expr_t = t.filter(__import__("arrow_tpu_torch.acero", fromlist=["f"])
                      .field("i") > 50, device="cpu")
    assert expr_t.to_pydict() == ref.filter(at.acero.field("i") > 50
                                            ).to_pydict()
    idx = at.array([5, 0, 59, 3])
    assert t.take(carry_array(idx), device="cpu").to_pydict() == \
        ref.take(idx).to_pydict()
    assert t.drop_null(device="cpu").to_pydict() == \
        ref.drop_null().to_pydict()
    for keys in ([("i", "descending")], [("k", "ascending"),
                                         ("f", "descending")], "f"):
        for np_ in ("at_end", "at_start"):
            assert t.sort_by(keys, null_placement=np_,
                             device="cpu").to_pydict() == \
                ref.sort_by(keys, null_placement=np_).to_pydict()
    aggs = [("i", "sum"), ("f", "mean"), ("i", "count"), ("f", "max"),
            ("i", "list")]
    got = t.group_by("k").aggregate(aggs, device="cpu").to_pydict()
    want = ref.group_by("k").aggregate(aggs).to_pydict()
    assert list(got) == list(want)
    for name in want:
        assert _close(got[name], want[name]), name
    rb = t.to_batches()[0]
    assert rb.filter(carry_array(mask), device="cpu").to_pydict() == \
        ref.filter(mask).to_pydict()
    assert pc.filter(rb, carry_array(mask), device="cpu").num_rows == \
        ref.filter(mask).num_rows
    assert pc.sort_indices(t, sort_keys=[("i", "ascending")],
                           device="cpu").to_pylist() == \
        jpc.sort_indices(ref, sort_keys=[("i", "ascending")]).to_pylist()
