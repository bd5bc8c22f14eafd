"""The 26 host-tier names (``compute/host_kernels.py``, the host names of
``compute/extra_kernels.py``, ``vector_misc.mode``) and the device tier of
the nested ones (``compute/device_nested.py``) against the JAX package on
the same host values, made from a seed with numpy, the reference's Arrays
carried across by their buffers. The five nested names run on
``device="cpu"`` (the compaction's plain version) against both of the
reference's tiers (``ARROW_TPU_DEVICE_NESTED`` on and off). Also the
eager ``run_end_encode``'s run-end encoded Array and ``random``'s bits.
Tolerance: types, values, validity and order exact; NaN equals NaN."""

import datetime as dt
import math

import numpy as np
import pytest
import torch

import arrow_tpu as at
import arrow_tpu.compute as jpc
import arrow_tpu_torch.compute as pc
import arrow_tpu_torch.types as PT
from arrow_tpu_torch.array.array import array
from arrow_tpu_torch.compute import device_nested, host_kernels, selection
from arrow_tpu_torch.compute.registry import call_function

from test_torch_host_table import carry_array, port_type
from worker_settings import collect_after_test, gc_off_in_module  # noqa: F401

N = 24


def same(a, b) -> bool:
    """Python values equal, NaN equal to NaN, into containers."""
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    return a == b and type(a) is type(b)


def check(name, args, options=None, device="cpu"):
    """``name`` through both packages' ``call_function`` on the same
    values (a reference type in ``options`` as the port's); the port's
    result. Raises where both raise."""
    port_options = None if options is None else {
        k: port_type(v) if isinstance(v, at.DataType) else v
        for k, v in options.items()}
    try:
        want = jpc.call_function(name, args, options)
    except Exception as e:  # noqa: BLE001 - the port must raise too
        with pytest.raises(Exception) as got:
            call_function(name, [carry_array(a) if isinstance(a, at.Array)
                                 else a for a in args], port_options,
                          device=device)
        assert type(got.value).__name__ == type(e).__name__ or isinstance(
            got.value, (ValueError, KeyError, IndexError)), (got.value, e)
        return None
    got = call_function(name, [carry_array(a) if isinstance(a, at.Array)
                               else a for a in args], port_options,
                        device=device)
    if hasattr(want, "to_pylist"):
        assert got.type == port_type(want.type), (name, got.type, want.type)
        assert len(got) == len(want), name
        assert same(got.to_pylist(), want.to_pylist()), (
            name, got.to_pylist(), want.to_pylist())
    else:
        assert same(got.as_py(), want.as_py()), (name, got, want)
    return got


# --- list columns of every child type -----------------------------------------

def _child_values(kind, rng, n):
    if kind == "f64":
        v = rng.normal(size=n)
        v[rng.random(n) < 0.1] = np.nan
        return [None if rng.random() < 0.15 else float(x) for x in v]
    if kind == "string":
        words = ["ab", "", "c", "dé", "xyz", "q"]
        return [None if rng.random() < 0.15 else words[i]
                for i in rng.integers(0, len(words), n)]
    if kind == "int64":
        return [None if rng.random() < 0.15 else int(x)
                for x in rng.integers(-5, 5, n)]
    # a list of lists
    return [None if rng.random() < 0.15 else
            [int(x) for x in rng.integers(0, 9, rng.integers(0, 3))]
            for _ in range(n)]


_CHILD_TYPES = {"f64": at.float64(), "string": at.string(),
                "int64": at.int64(), "list": at.list_(at.int64())}


def list_column(kind, seed, n=N, layout="list"):
    """A reference list column of ``kind`` children with empty and null
    lists (``layout``: list, large_list or fixed_size_list of 2)."""
    rng = np.random.default_rng(seed)
    if layout == "fixed_size_list":
        vals = _child_values(kind, rng, 2 * n)
        rows = [None if rng.random() < 0.2 else vals[2 * i:2 * i + 2]
                for i in range(n)]
        return at.array(rows, at.fixed_size_list(_CHILD_TYPES[kind], 2))
    lens = rng.integers(0, 5, n)
    vals = _child_values(kind, rng, int(lens.sum()))
    rows, pos = [], 0
    for ln in lens:
        rows.append(None if rng.random() < 0.2 else vals[pos:pos + ln])
        pos += ln
    t = (at.list_ if layout == "list" else at.large_list)(_CHILD_TYPES[kind])
    return at.array(rows, t)


NESTED_CASES = [(k, lay) for k in ("f64", "string", "int64", "list")
                for lay in ("list", "large_list")] + [
    ("f64", "fixed_size_list"), ("string", "fixed_size_list")]


@pytest.fixture(params=["on", "off"])
def reference_tier(request, monkeypatch):
    monkeypatch.setenv("ARROW_TPU_DEVICE_NESTED", request.param)
    return request.param


def _variants(ra):
    """The whole column, a slice in its middle, its first row alone and an
    empty slice."""
    return [ra, ra.slice(5, 11), ra.slice(0, 1), ra.slice(3, 0)]


@pytest.mark.parametrize("kind,layout", NESTED_CASES)
@pytest.mark.parametrize("name", ["list_value_length", "list_flatten",
                                  "list_parent_indices"])
def test_nested(name, kind, layout, reference_tier):
    ra = list_column(kind, hash((name, kind, layout)) % 1000, layout=layout)
    for v in _variants(ra):
        check(name, [v])


@pytest.mark.parametrize("kind,layout", NESTED_CASES)
@pytest.mark.parametrize("index", [0, 1, 3])
def test_list_element(kind, layout, index, reference_tier):
    ra = list_column(kind, 11 + index, layout=layout)
    for v in _variants(ra):
        check("list_element", [v], {"index": index})


def test_list_element_of_empty_child(reference_tier):
    check("list_element", [at.array([[], None, []],
                                    at.list_(at.float64()))], {"index": 0})


def test_nested_without_null_parents():
    """No null list: the flatten is the child's range itself, with no
    launch; lengths and parents the same as the reference's."""
    ra = at.array([[1.0, 2.0], [], [3.0, None, 4.0]], at.list_(at.float64()))
    for name in ("list_flatten", "list_value_length", "list_parent_indices"):
        check(name, [ra])
        check(name, [ra.slice(1, 2)])


def test_flatten_runs_one_compaction(monkeypatch):
    """With null parents, list_flatten moves the child's values and
    validity in one call of the compaction (K2's entry point), and its
    device form is made once a list column and device."""
    calls = []
    real = selection.compact_by_mask

    def counting(keep, arrays):
        calls.append(len(arrays))
        return real(keep, arrays)
    monkeypatch.setattr(selection, "compact_by_mask", counting)
    pa = carry_array(list_column("f64", 3))
    assert pa.null_count
    pc.list_flatten(pa, device="cpu")
    assert calls == [2]
    ld = device_nested.list_device(pa, "cpu")
    assert device_nested.list_device(pa, "cpu") is ld
    calls.clear()
    pc.list_flatten(carry_array(at.array([[1.0], [2.0, 3.0]],
                                         at.list_(at.float64()))),
                    device="cpu")
    assert calls == []


def test_nested_names_refuse_a_missing_card():
    """Without ``device``, the device tier runs on the card: here, with
    no CUDA, it raises rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    pa = carry_array(list_column("f64", 5))
    for name in ("list_value_length", "list_flatten", "list_parent_indices",
                 "list_element"):
        with pytest.raises(RuntimeError):
            call_function(name, [pa])


# --- run-end encoding -----------------------------------------------------------

def _ree_inputs():
    rng = np.random.default_rng(21)
    ints = [None if rng.random() < 0.1 else int(x)
            for x in np.repeat(rng.integers(0, 4, 12), rng.integers(1, 4, 12))]
    floats = [float("nan") if x == 2 else None if x is None else x / 3
              for x in ints]
    strs = [None if x is None else "s" * x for x in ints]
    return {"int64": at.array(ints, at.int64()),
            "f64": at.array(floats, at.float64()),
            "string": at.array(strs, at.string()),
            "all_null": at.array([None] * 7, at.int64())}


@pytest.mark.parametrize("name", ["int64", "f64", "string", "all_null"])
def test_run_end_encode_is_an_ree_array(name):
    """The eager run_end_encode gives the reference's run_end_encoded
    Array: type, length, logical values and both children."""
    ra = _ree_inputs()[name]
    got = check("run_end_encode", [ra])
    want = jpc.call_function("run_end_encode", [ra])
    assert got.type.id == PT.TypeId.RUN_END_ENCODED
    for i in range(2):
        g, w = got.data.children[i], want.data.children[i]
        assert g.type == port_type(w.type)
        assert same(PTarray(g).to_pylist(), w_array(w).to_pylist())


def PTarray(d):
    from arrow_tpu_torch.array.array import Array
    return Array(d)


def w_array(d):
    from arrow_tpu.array.array import Array
    return Array(d)


@pytest.mark.parametrize("name", ["int64", "f64", "string", "all_null"])
def test_run_end_decode(name, reference_tier):
    """run_end_decode inverts the eager run_end_encode, whole and sliced,
    in both packages alike."""
    ra = _ree_inputs()[name]
    ree = jpc.call_function("run_end_encode", [ra])
    for v in (ree, ree.slice(2, 6), ree.slice(len(ree) - 1, 1)):
        check("run_end_decode", [v])
    got = pc.run_end_decode(pc.call_function(
        "run_end_encode", [carry_array(ra)], device="cpu"), device="cpu")
    assert same(got.to_pylist(), ra.to_pylist())


# --- random -------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**40 + 3])
@pytest.mark.parametrize("n", [0, 1, 5, 1023, 4097])
def test_random_bits(seed, n):
    """threefry2x32 in torch gives the reference's uniform doubles bit for
    bit."""
    want = np.asarray(jpc.call_function("random", [n],
                                        {"initializer": seed}).to_numpy())
    got = pc.random(n, initializer=seed, device="cpu").to_numpy()
    assert got.dtype == np.float64 and len(got) == n
    assert np.array_equal(got.view(np.int64), want.view(np.int64))
    assert ((got >= 0) & (got < 1)).all()


def test_random_system_seed_and_errors():
    a = pc.random(8, device="cpu").to_numpy()
    assert ((a >= 0) & (a < 1)).all()
    check("random", [-1])


# --- strftime / strptime ------------------------------------------------------

def _timestamps(unit, seed=3, n=N):
    rng = np.random.default_rng(seed)
    per = {"s": 1, "ms": 10**3, "us": 10**6, "ns": 10**9}[unit]
    secs = rng.integers(-2_000_000_000, 4_000_000_000, n)
    frac = rng.integers(0, per, n)
    vals = [None if rng.random() < 0.15 else int(s * per + f)
            for s, f in zip(secs, frac)]
    return at.array(vals, at.timestamp(unit))


@pytest.mark.parametrize("unit", ["s", "ms", "us", "ns"])
@pytest.mark.parametrize("fmt", ["%Y-%m-%dT%H:%M:%S", "%Y-%m-%d %H:%M:%S.%f",
                                 "%d/%m/%y %I%p %j", "%a %b %d %Y",
                                 "%A %B", "%%Y=%Y"])
def test_strftime(unit, fmt):
    ra = _timestamps(unit)
    for v in (ra, ra.slice(4, 9), ra.slice(0, 0)):
        check("strftime", [v], {"format": fmt})


def test_strftime_of_dates():
    ra = at.array([dt.date(2020, 1, 2), None, dt.date(1969, 12, 31)])
    check("strftime", [ra], {"format": "%Y/%m/%d"})


@pytest.mark.parametrize("unit", ["s", "ms", "us", "ns"])
@pytest.mark.parametrize("fmt", ["%Y-%m-%d %H:%M:%S", "%Y%m%d", "%d.%m.%Y"])
def test_strptime_round_trip(unit, fmt):
    ra = _timestamps("s")
    text = jpc.call_function("strftime", [ra], {"format": fmt})
    got = check("strptime", [text], {"format": fmt, "unit": unit})
    assert got is not None


@pytest.mark.parametrize("error_is_null", [True, False])
def test_strptime_bad_rows(error_is_null):
    ra = at.array(["2020-02-30 00:00:00", "2021-01-01 10:11:12", None,
                   "2020-1-5 1:2:3", "garbage"])
    for v in (ra, ra.slice(1, 2)):
        check("strptime", [v], {"format": "%Y-%m-%d %H:%M:%S", "unit": "s",
                                "error_is_null": error_is_null})


# --- splits and joins -----------------------------------------------------------

def _strings(seed=5, n=N):
    rng = np.random.default_rng(seed)
    words = ["alpha", "b", "", "gamma delta", " lead", "trail ", "x  y",
             "dé ja", "t\tab"]
    return at.array([None if rng.random() < 0.15 else
                     " ".join(words[i] for i in rng.integers(0, len(words),
                                                              rng.integers(0, 4)))
                     for _ in range(n)])


@pytest.mark.parametrize("opts", [{}, {"pattern": " "}, {"pattern": "a"},
                                  {"pattern": " ", "max_splits": 1},
                                  {"pattern": " ", "max_splits": 1,
                                   "reverse": True}])
def test_split_pattern(opts):
    ra = _strings()
    for v in (ra, ra.slice(3, 7), ra.slice(0, 0)):
        check("split_pattern", [v], opts)


@pytest.mark.parametrize("name", ["utf8_split_whitespace",
                                  "ascii_split_whitespace"])
@pytest.mark.parametrize("opts", [{}, {"max_splits": 1}])
def test_split_whitespace(name, opts):
    ra = _strings(6)
    for v in (ra, ra.slice(2, 5)):
        check(name, [v], opts)


@pytest.mark.parametrize("opts", [{"pattern": "[ae]"},
                                  {"pattern": r"\s+", "max_splits": 2}])
def test_split_pattern_regex(opts):
    ra = _strings(7)
    for v in (ra, ra.slice(5, 6)):
        check("split_pattern_regex", [v], opts)


def test_binary_join():
    ra = at.array([["a", "b"], None, [], ["c", None], ["dé"]],
                  at.list_(at.string()))
    for v in (ra, ra.slice(1, 4)):
        check("binary_join", [v, "-"])
    split = jpc.call_function("split_pattern", [_strings(8)],
                              {"pattern": " "})
    check("binary_join", [split, " "])


# --- structs and maps -------------------------------------------------------------

def test_make_struct_and_struct_field():
    a = at.array([1, None, 3, 4])
    b = at.array(["x", "y", None, "z"])
    c = at.array([1.5, 2.5, None, 4.5]).slice(0, 4)
    got = check("make_struct", [a, b, c], {"field_names": ["a", "b", "c"]})
    assert [f.name for f in got.type.fields] == ["a", "b", "c"]
    check("make_struct", [a, b])
    check("make_struct", [a.slice(1, 2), b.slice(2, 2)])
    st = at.array([{"a": 1, "b": "x"}, None, {"a": None, "b": "z"}],
                  at.struct([("a", at.int64()), ("b", at.string())]))
    for sel in ({"field": "a"}, {"field": "b"}, {"indices": 1},
                {"indices": [0]}):
        check("struct_field", [st], sel)
        check("struct_field", [st.slice(1, 2)], sel)


@pytest.mark.parametrize("occurrence", ["first", "last", "all"])
def test_map_lookup(occurrence):
    rows = [[("a", 1), ("b", 2), ("a", 3)], None, [], [("b", None)],
            [("c", 5), ("a", 6)]]
    ra = at.array(rows, at.map_(at.string(), at.int64()))
    for key in ("a", "b", "zz"):
        for v in (ra, ra.slice(2, 3)):
            check("map_lookup", [v], {"query_key": key,
                                      "occurrence": occurrence})


# --- mode, pivot, decode --------------------------------------------------------

@pytest.mark.parametrize("values", [
    [1, 2, 2, 3, 3, None, 4], [2.5, float("nan"), 2.5, None, 1.0],
    ["b", "a", "b", "a", None, "c"], [None, None], []])
@pytest.mark.parametrize("opts", [{}, {"n": 2}, {"n": 5},
                                  {"skip_nulls": False},
                                  {"min_count": 6}])
def test_mode(values, opts):
    ra = at.array(values, at.int64() if not values else None)
    check("mode", [ra], opts)


def test_pivot_wider():
    keys = at.array(["b", "a", None, "c"])
    vals = at.array([1.0, 2.0, 3.0, None])
    check("pivot_wider", [keys, vals])
    check("pivot_wider", [keys, vals], {"key_names": ["a", "z"]})
    check("pivot_wider", [keys, vals], {"key_names": ["a"],
                                        "unexpected_key_behavior": "raise"})
    check("pivot_wider", [at.array(["a", "a"]), at.array([1, 2])])


def test_dictionary_decode():
    ra = jpc.call_function("dictionary_encode",
                           [at.array(["x", None, "y", "x"])]) \
        if "dictionary_encode" in jpc.list_functions() else None
    ra = ra if ra is not None else at.array(
        ["x", None, "y", "x"], at.dictionary(at.int32(), at.string()))
    for v in (ra, ra.slice(1, 2)):
        check("dictionary_decode", [v])
    check("dictionary_decode", [at.array([1, None])])


# --- the interval and calendar names -------------------------------------------

def _dates(seed, n=N):
    rng = np.random.default_rng(seed)
    return at.array([None if rng.random() < 0.15 else int(x)
                     for x in rng.integers(-1000, 20000, n)], at.date32())


@pytest.mark.parametrize("kind", ["date32", "timestamp"])
@pytest.mark.parametrize("name", ["day_time_interval_between",
                                  "month_day_nano_interval_between"])
def test_interval_between(name, kind):
    if kind == "date32":
        a, b = _dates(1), _dates(2)
    else:
        a, b = _timestamps("us", 1), _timestamps("us", 2)
    got = check(name, [a, b])
    check(name, [a.slice(3, 8), b.slice(3, 8)])
    assert got.type.id in (PT.TypeId.INTERVAL_DAY_TIME,
                           PT.TypeId.INTERVAL_MONTH_DAY_NANO)
    assert same(got.slice(2, 5).to_pylist(), got.to_pylist()[2:7])


@pytest.mark.parametrize("name", ["iso_calendar", "year_month_day"])
def test_calendar_structs(name):
    for v in (_dates(3), _timestamps("ms", 4), _dates(5).slice(2, 9)):
        got = check(name, [v])
    assert [f.name for f in got.type.fields] == (
        ["iso_year", "iso_week", "iso_day_of_week"] if name == "iso_calendar"
        else ["year", "month", "day"])


@pytest.mark.parametrize("name", ["extract_regex", "extract_regex_span"])
def test_extract_regex(name):
    ra = at.array(["13-456-789", None, "x", "99-1-2", "7-88-999"])
    for v in (ra, ra.slice(1, 3)):
        check(name, [v], {"pattern": r"(?P<cc>\d+)-(?P<rest>\d+)"})
    check(name, [ra], {"pattern": r"\d+"})


@pytest.mark.parametrize("opts", [{"start": 1}, {"start": 0, "stop": 2},
                                  {"start": 0, "stop": None, "step": 2}])
def test_list_slice(opts):
    ra = list_column("int64", 9)
    for v in (ra, ra.slice(4, 6)):
        check("list_slice", [v], opts)


def test_every_host_name_is_covered():
    """The 26 names the reference registers on its host tier all have a
    test here."""
    names = {n for n, f in __import__(
        "arrow_tpu.compute.registry", fromlist=["x"])._REGISTRY.items()
        if f.kind == "host"}
    ours = {n for n, f in __import__(
        "arrow_tpu_torch.compute.registry",
        fromlist=["x"]).function_registry().items() if f.kind == "host"}
    assert names <= ours
    assert len(names) == 26
    covered = {"list_value_length", "list_flatten", "list_parent_indices",
               "list_element", "run_end_decode", "random", "strftime",
               "strptime", "split_pattern", "utf8_split_whitespace",
               "ascii_split_whitespace", "split_pattern_regex",
               "binary_join", "make_struct", "struct_field", "map_lookup",
               "mode", "pivot_wider", "dictionary_decode",
               "day_time_interval_between",
               "month_day_nano_interval_between", "iso_calendar",
               "year_month_day", "extract_regex", "extract_regex_span",
               "list_slice"}
    assert names == covered
    assert host_kernels.uniform_threefry(7, 3, "cpu").dtype == torch.float64
    assert array([1]).type == PT.int64()


@pytest.mark.parametrize("name,opts", [
    ("split_pattern", {"pattern": " "}), ("split_pattern", {"pattern": "a"}),
    ("utf8_split_whitespace", {}), ("ascii_split_whitespace", {})])
def test_split_of_ascii_rows_by_bytes(name, opts):
    """ASCII rows split in numpy over the data buffer (one separator
    byte, or the ASCII whitespace Python's ``str.split()`` splits on),
    nulls, empties, runs of separators and slices included."""
    rng = np.random.default_rng(31)
    words = ["alpha", "b", "", " lead", "trail ", "x  y", "t\tab",
             "f\x1cs", "aa", "\n"]
    ra = at.array([None if rng.random() < 0.15 else
                   " ".join(words[i] for i in rng.integers(
                       0, len(words), rng.integers(0, 4)))
                   for _ in range(3 * N)])
    for v in (ra, ra.slice(7, 20), ra.slice(0, 0), ra.slice(5, 1)):
        check(name, [v], opts)
