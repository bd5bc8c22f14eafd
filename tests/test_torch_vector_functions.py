"""The port's vector functions against the JAX package's, over every type.

Each registered name of the reference's ``selection.py``, ``vector_sort.py``
and ``grouper.py`` runs on the same seeded column in both packages
(``test_torch_types.column_pair``: 200 live rows of 1,024, a fifth null,
NaN, -0.0 and infinities in the floats, both ends of the integer ranges),
one parametrised case a type and option, and on dictionary columns of
strings and of numbers:

* ``filter``/``array_filter`` under a nullable mask with both
  ``null_selection_behavior``s, ``drop_null``, ``take``/``array_take``
  with null indices (an index out of range raises IndexError in the port
  where the reference's ErrGuard flags it; ``boundscheck=False`` reads
  row 0), ``inverse_permutation`` and ``scatter``;
* ``sort_indices`` (both orders and null placements, and with a second
  key), ``array_sort_indices``, ``select_k_unstable``,
  ``partition_nth_indices`` and ``rank`` under all four tiebreakers;
* the five ``cumulative_*`` functions with ``skip_nulls`` both ways and a
  ``start``, and ``pairwise_diff`` at periods 1 and -3;
* ``unique``, ``value_counts``, ``dictionary_encode`` and
  ``unique_batch``, and ``move.spread_rows``.

Indices, ranks, counts, validity and row order must be exact, and so must
the value dtype and type. Floats: 1 ulp at f16/f32 and rtol 1e-9 at f64;
a cumulative float sum or product is held within that tolerance of the
running sum (product) of magnitudes, since both packages add in their
own order. The helpers here (``assert_same``, ``dict_pair``) compare
vector and aggregate results for ``test_torch_aggregates_full.py`` and
``test_torch_stats_plans.py`` too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import arrow_tpu as at
from arrow_tpu import types as RT
from arrow_tpu.compute import registry as jax_registry
from arrow_tpu.compute.aggregate import AggResult as JaxAggResult
from arrow_tpu.compute.elementwise import ErrGuard
from arrow_tpu.compute.grouper import unique_batch as jax_unique_batch
from arrow_tpu.compute.move import spread_rows as jax_spread_rows
from arrow_tpu.compute.selection import Compacted as JaxCompacted
from arrow_tpu.device.column import DeviceBatch as JaxDeviceBatch
from arrow_tpu.device.column import DeviceColumn as JaxDeviceColumn
from arrow_tpu_torch import types as PT
from arrow_tpu_torch.compute.aggregate import AggResult
from arrow_tpu_torch.compute.grouper import unique_batch
from arrow_tpu_torch.compute.move import spread_rows
from arrow_tpu_torch.compute.registry import get_function
from arrow_tpu_torch.compute.selection import Compacted
from arrow_tpu_torch.device.column import DeviceBatch, DeviceColumn

from test_torch_types import (CAP, N, TYPES, _close, column_pair, contexts,
                              run_both, type_name)
from worker_settings import collect_after_test, gc_off_in_module  # noqa: F401

ALL_TYPES = list(TYPES)
DICTS = {
    # first-appearance dictionaries, not sorted, one with a null value
    "dict_string": ("pear", "apple", None, "fig", "kiwi", "banana", "date"),
    "dict_int64": (40, -7, 12, 0, 99, -3),
}


def dict_pair(kind: str, seed: int, nulls: bool = True):
    """A dictionary-coded column in both packages: codes into
    ``DICTS[kind]``, a fifth of the rows null."""
    rng = np.random.default_rng(seed)
    words = DICTS[kind]
    codes = np.zeros(CAP, dtype=np.int32)
    codes[:N] = rng.integers(0, len(words), N)
    valid = None
    if nulls:
        valid = np.zeros(CAP, dtype=np.bool_)
        valid[:N] = rng.random(N) > 0.2
    if kind == "dict_string":
        ptype = PT.dictionary(PT.int32(), PT.string())
        rtype, rdict = RT.dictionary(RT.int32(), RT.string()), \
            at.array(list(words), RT.string())
    else:
        ptype = PT.dictionary(PT.int32(), PT.int64())
        rtype, rdict = RT.dictionary(RT.int32(), RT.int64()), \
            at.array(list(words), RT.int64())
    port = DeviceColumn(torch.from_numpy(codes.copy()),
                        None if valid is None else torch.from_numpy(
                            valid.copy()), ptype, words)
    ref = JaxDeviceColumn(jnp.asarray(codes),
                          None if valid is None else jnp.asarray(valid),
                          rtype, rdict)
    return port, ref


def any_pair(name: str, seed: int, nulls: bool = True):
    if name in DICTS:
        return dict_pair(name, seed, nulls)
    return column_pair(name, seed, nulls)


def type_key(t):
    """A type in a form both packages share (their dictionary, struct
    and list reprs differ)."""
    tid = int(t.id)
    if tid == int(PT.TypeId.DICTIONARY):
        return ("dictionary", type_key(t.index_type),
                type_key(t.value_type))
    if tid in (int(PT.TypeId.STRUCT), int(PT.TypeId.LIST)):
        return (tid, tuple((f.name if tid == int(PT.TypeId.STRUCT) else "",
                            type_key(f.type)) for f in t.fields))
    return type_name(t)


def _dictionary(d):
    if d is None:
        return None
    return tuple(d) if not hasattr(d, "to_pylist") else tuple(d.to_pylist())


def assert_same_column(port: DeviceColumn, ref, tol=None, abs_tol=None):
    """Values at the reference's dtype (floats within ``tol``: "ulp" is 1
    ulp at f16/f32 and rtol 1e-9 at f64; ``abs_tol`` an array of absolute
    bounds), validity, type and dictionary."""
    want = np.asarray(ref.values)
    got = port.values.numpy()
    if got.dtype != want.dtype and got.itemsize == want.itemsize:
        got = got.view(want.dtype)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    if want.dtype.kind != "f" or (tol is None and abs_tol is None):
        np.testing.assert_array_equal(got, want)
    else:
        ok = _close(got, want, want.dtype)
        if abs_tol is not None:
            with np.errstate(invalid="ignore"):
                ok |= np.abs(got.astype(np.float64) - want) <= abs_tol
        assert ok.all(), (np.nonzero(~ok)[0][:5], got[~ok][:5],
                          want[~ok][:5])
    rv = None if ref.validity is None else np.asarray(ref.validity)
    pv = None if port.validity is None else port.validity.numpy()
    if rv is None or pv is None:
        assert rv is None or rv.all()
        assert pv is None or pv.all()
    else:
        np.testing.assert_array_equal(pv, rv)
    assert type_key(port.type) == type_key(ref.type)
    assert _dictionary(port.dictionary) == _dictionary(ref.dictionary)


def _scalar(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _same_value(got, want, tol):
    g, w = _scalar(got), _scalar(want)
    if w.dtype.kind == "f":
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        if tol is None:
            assert (g == w) or (np.isnan(g) and np.isnan(w)), (g, w)
        else:
            ok = _close(g.reshape(1), w.reshape(1), w.dtype)[0]
            if not isinstance(tol, str):
                ok = ok or abs(float(g) - float(w)) <= tol
            assert ok, (g, w)
    else:
        if g.dtype != w.dtype and g.itemsize == w.itemsize:
            g = g.view(w.dtype)
        assert g.dtype == w.dtype and g == w, (g, w)


def assert_same_agg(got: AggResult, want, tol=None):
    """Validity exact; a value where it is valid (the value under a null
    is not part of the result), within ``tol`` ("ulp" as above, or a
    number: an absolute bound) for floats."""
    assert type_key(got.type) == type_key(want.type)
    assert (got.fields is None) == (want.fields is None)
    assert _dictionary(got.dictionary) == _dictionary(want.dictionary)
    if want.fields is None:
        gv, wv, gok, wok = [got.value], [want.value], [got.valid], \
            [want.valid]
    else:
        assert tuple(got.fields) == tuple(want.fields)
        gv, wv, gok, wok = got.value, want.value, got.valid, want.valid
    for g, w, gk, wk in zip(gv, wv, gok, wok):
        assert bool(gk) == bool(wk), (gk, wk)
        if bool(wk):
            _same_value(g, w, tol)


def assert_same(got, want, tol=None, abs_tol=None):
    """Compare a port result with the reference's: both raised, or the
    same Compacted (count and column), column, dict of them or
    AggResult. A reference ErrGuard whose flag is set counts as raised,
    else its result is compared."""
    if isinstance(want, ErrGuard):
        want = ArithmeticError(want.msg) if bool(want.flag) else want.result
    if isinstance(want, Exception):
        assert isinstance(got, Exception), (
            f"the reference raised {want!r}, the port gave {got!r}")
        return
    assert not isinstance(got, Exception), (
        f"the port raised {got!r}, the reference did not")
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            assert_same(got[k], want[k], tol, abs_tol)
    elif isinstance(want, JaxCompacted):
        assert isinstance(got, Compacted)
        assert int(got.count) == int(want.count)
        assert_same_column(got.column, want.column, tol, abs_tol)
    elif isinstance(want, JaxAggResult):
        assert_same_agg(got, want, tol)
    else:
        assert isinstance(want, JaxDeviceColumn), type(want)
        assert_same_column(got, want, tol, abs_tol)


# --- registry coverage -----------------------------------------------------

_REFERENCE_MODULES = ("selection", "vector_sort", "grouper", "aggregate",
                      "hash_agg")


def test_every_reference_name_is_registered():
    """Every name the reference's selection, vector_sort, grouper,
    aggregate and hash_agg modules register (read from its registry)
    resolves through the port's ``get_function``; the names that stay
    queued raise naming their item."""
    import importlib
    for m in _REFERENCE_MODULES:
        importlib.import_module(f"arrow_tpu.compute.{m}")
    ref = sorted(n for n, f in jax_registry._REGISTRY.items()
                 if getattr(f.impl, "__module__", "").rsplit(".", 1)[-1]
                 in _REFERENCE_MODULES)
    assert len(ref) >= 60
    missing = []
    for n in ref:
        try:
            get_function(n)
        except NotImplementedError:
            missing.append(n)
    assert missing == []
    assert get_function("tdigest").name == "tdigest"
    assert get_function("hash_tdigest").name == "hash_tdigest"
    # the host-tier grouped aggregates resolve as the reference registers
    # them: their body raises, the aggregate node's host path runs them
    assert get_function("hash_list").kind == "hash_aggregate"
    with pytest.raises(ValueError, match="aggregate node"):
        get_function("hash_list").impl(None, None, None, None)


# --- selection ---------------------------------------------------------------

def _mask_pair(seed: int):
    return column_pair("bool", seed, nulls=True)


@pytest.mark.parametrize("behavior", ["drop", "emit_null"])
@pytest.mark.parametrize("fn", ["filter", "array_filter"])
@pytest.mark.parametrize("name", ALL_TYPES + list(DICTS))
def test_filter(name, fn, behavior):
    p, r = any_pair(name, 1)
    pm, rm = _mask_pair(2)
    got, want = run_both(fn, [p, pm], [r, rm],
                         null_selection_behavior=behavior)
    assert_same(got, want)


@pytest.mark.parametrize("nulls", [True, False])
@pytest.mark.parametrize("name", ALL_TYPES + list(DICTS))
def test_drop_null(name, nulls):
    p, r = any_pair(name, 3, nulls)
    got, want = run_both("drop_null", [p], [r])
    assert_same(got, want)


def _index_pair(seed: int, high: int = N, nulls: bool = True,
                name: str = "int32"):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, high, N).astype(np.dtype(name))
    return column_pair(name, seed, nulls, values=idx)


@pytest.mark.parametrize("case", ["checked", "unchecked", "out_of_range"])
@pytest.mark.parametrize("fn", ["take", "array_take"])
@pytest.mark.parametrize("name", ALL_TYPES + list(DICTS))
def test_take(name, fn, case):
    """Null indices give null rows; an index out of range raises where
    ``boundscheck`` is set (IndexError in the port, the ErrGuard's flag in
    the reference) and reads row 0 where it is not."""
    p, r = any_pair(name, 4)
    high = N if case == "checked" else N + 40
    pi, ri = _index_pair(5, high=high if case != "out_of_range" else CAP + 9)
    got, want = run_both(fn, [p, pi], [r, ri],
                         boundscheck=case != "unchecked")
    if case == "out_of_range":
        assert isinstance(got, IndexError)
    assert_same(got, want)


def test_take_n_values_limit():
    p, r = column_pair("int64", 6)
    pi, ri = _index_pair(7, high=N)
    got, want = run_both("take", [p, pi], [r, ri], n_values=N // 2,
                         boundscheck=False)
    assert_same(got, want)
    got, want = run_both("take", [p, pi], [r, ri], n_values=N // 2)
    assert isinstance(got, IndexError)
    assert_same(got, want)


@pytest.mark.parametrize("nulls", [True, False])
@pytest.mark.parametrize("name", ["int32", "int64", "uint32", "uint64"])
def test_inverse_permutation(name, nulls):
    """A permutation of the live rows' positions, with nulls among its
    indices: the slots no live index reaches are null."""
    rng = np.random.default_rng(8)
    perm = rng.permutation(N).astype(np.dtype(name))
    p, r = column_pair(name, 8, nulls, values=perm)
    got, want = run_both("inverse_permutation", [p], [r])
    assert_same(got, want)


@pytest.mark.parametrize("name", ALL_TYPES + list(DICTS))
def test_scatter(name):
    p, r = any_pair(name, 9)
    rng = np.random.default_rng(10)
    pi, ri = column_pair("int64", 10, True,
                         values=rng.permutation(N).astype(np.int64))
    got, want = run_both("scatter", [p, pi], [r, ri])
    assert_same(got, want)


# --- sorts -------------------------------------------------------------------

@pytest.mark.parametrize("placement", ["at_end", "at_start"])
@pytest.mark.parametrize("order", ["ascending", "descending"])
@pytest.mark.parametrize("name", ALL_TYPES + list(DICTS))
def test_sort_indices(name, order, placement):
    """One key, then the same key with a second (int16 with nulls, the
    other order) to break its ties."""
    p, r = any_pair(name, 11)
    got, want = run_both("sort_indices", [p], [r], sort_keys=[("x", order)],
                         null_placement=placement)
    assert_same(got, want)
    p2, r2 = column_pair("int16", 12)
    other = "ascending" if order == "descending" else "descending"
    got, want = run_both("sort_indices", [p, p2], [r, r2],
                         sort_keys=[("x", order), ("y", other)],
                         null_placement=placement)
    assert_same(got, want)
    got, want = run_both("array_sort_indices", [p], [r], order=order,
                         null_placement=placement)
    assert_same(got, want)


@pytest.mark.parametrize("name", ALL_TYPES + list(DICTS))
def test_select_k_and_partition(name):
    p, r = any_pair(name, 13)
    for k in (1, 17, N + 5):
        got, want = run_both("select_k_unstable", [p], [r], k=k,
                             sort_keys=[("x", "descending")])
        assert_same(got, want)
    got, want = run_both("partition_nth_indices", [p], [r], pivot=37,
                         null_placement="at_start")
    assert_same(got, want)


def test_select_k_puts_nulls_last_whatever_the_order():
    """The reference's ``select_k_unstable`` takes no ``null_placement``:
    its nulls come last, descending too; the port keeps that."""
    p, r = column_pair("int64", 14)
    got, want = run_both("select_k_unstable", [p], [r], k=N,
                         sort_keys=[("x", "descending")])
    assert_same(got, want)
    perm = got.column.values.numpy()[:N]
    valid = p.validity.numpy()[perm]
    assert valid[:valid.sum()].all() and not valid[valid.sum():].any()


def test_dictionary_sorts_by_its_codes():
    """``sort_indices`` of a dictionary column orders its codes, not its
    values (the reference's ``order_word`` reads no dictionary; an
    order_by node ranks the values)."""
    p, r = dict_pair("dict_string", 15, nulls=False)
    got, want = run_both("sort_indices", [p], [r])
    assert_same(got, want)
    codes = p.values.numpy()[got.column.values.numpy()[:N]]
    assert (np.diff(codes) >= 0).all()
    words = [DICTS["dict_string"][c] for c in codes]
    assert words != sorted(words, key=lambda w: (w is None, w))


@pytest.mark.parametrize("tiebreaker", ["first", "min", "max", "dense"])
@pytest.mark.parametrize("name", ALL_TYPES + list(DICTS))
def test_rank(name, tiebreaker):
    """Heavy ties (50 distinct values where the type allows), nulls, NaN;
    nulls at the end for first and max, at the start for min and
    dense."""
    rng = np.random.default_rng(16)
    values = None
    if name not in DICTS and name != "bool":
        v = np.asarray(column_pair(name, 16, False)[1].values)[:N]
        values = v[rng.integers(0, 50, N)]
    p, r = (dict_pair(name, 16) if name in DICTS
            else column_pair(name, 17, True, values=values))
    placement = "at_end" if tiebreaker in ("first", "max") else "at_start"
    order = "descending" if tiebreaker in ("max", "dense") else "ascending"
    got, want = run_both("rank", [p], [r], sort_keys=order,
                         null_placement=placement, tiebreaker=tiebreaker)
    assert_same(got, want)


# --- cumulative and pairwise -------------------------------------------------

_CUMULATIVE = ("cumulative_sum", "cumulative_prod", "cumulative_min",
               "cumulative_max", "cumulative_mean")


def _cum_bound(fn, ref, r, skip_nulls):
    """Absolute bounds for a cumulative float sum or product: the
    tolerance of its dtype times the running sum (product) of
    magnitudes, each package adding in its own order."""
    if fn not in ("cumulative_sum", "cumulative_prod", "cumulative_mean"):
        return None
    v = np.asarray(r.values).astype(np.float64)
    live = np.arange(CAP) < N
    if r.validity is not None:
        live &= np.asarray(r.validity)
    dt = np.asarray(ref.values).dtype
    if dt.kind != "f":
        return None
    eps = {2: 2 ** -10, 4: 2 ** -23, 8: 1e-9}[dt.itemsize]
    with np.errstate(all="ignore"):
        if fn == "cumulative_prod":
            run = np.cumprod(np.where(live, np.abs(v), 1.0))
        else:
            run = np.cumsum(np.where(live, np.abs(v), 0.0))
            if fn == "cumulative_mean":
                run = run / np.maximum(np.cumsum(live), 1)
    return 4 * eps * np.arange(1, CAP + 1).clip(max=64) * run


@pytest.mark.parametrize("skip_nulls", [False, True])
@pytest.mark.parametrize("fn", _CUMULATIVE)
@pytest.mark.parametrize("name", ALL_TYPES)
def test_cumulative(name, fn, skip_nulls):
    """The value dtype and type of each (``jnp`` keeps int8-int32 and
    turns bool into int64), and with ``skip_nulls=True`` the column's own
    validity, as the reference keeps it. Floats without NaN and
    infinities in a second column, so the sums are compared in earnest."""
    for seed, values in ((18, None), (19, "finite")):
        if values == "finite":
            if not name.startswith("float"):
                continue
            rng = np.random.default_rng(seed)
            dt = np.asarray(column_pair(name, seed)[1].values).dtype
            scale = 0.5 if fn == "cumulative_prod" else 50.0
            values = (rng.normal(size=N) * scale + (
                1.0 if fn == "cumulative_prod" else 0.0)).astype(dt)
        p, r = column_pair(name, seed, True, values=values)
        got, want = run_both(fn, [p], [r], skip_nulls=skip_nulls)
        assert_same(got, want, tol="ulp",
                    abs_tol=None if isinstance(want, Exception) else
                    _cum_bound(fn, want, r, skip_nulls))


@pytest.mark.parametrize("fn", ["cumulative_sum", "cumulative_prod",
                                "cumulative_min", "cumulative_max"])
@pytest.mark.parametrize("name", ["int8", "uint32", "int64", "float64"])
def test_cumulative_start(name, fn):
    p, r = column_pair(name, 20, True,
                       values=np.arange(1, N + 1).astype(np.dtype(name)) % 7)
    got, want = run_both(fn, [p], [r], start=3)
    assert_same(got, want, tol="ulp")


def test_cumulative_long_float_sum_is_blocked_and_close():
    """Above one block the port's float scan runs block by block; it stays
    within rtol 1e-9 of numpy's sequential sum and repeats its bits."""
    from arrow_tpu_torch.compute.vector_sort import _SCAN_BLOCK, _scan
    rng = np.random.default_rng(21)
    x = rng.normal(size=5 * _SCAN_BLOCK * _SCAN_BLOCK // 4 + 3) * 1e3 + 7.0
    t = torch.from_numpy(x)
    got = _scan(t, "sum").numpy()
    want = np.cumsum(x)
    bound = 1e-12 * np.cumsum(np.abs(x)) * 64
    assert (np.abs(got - want) <= bound).all()
    assert np.array_equal(got, _scan(t, "sum").numpy())
    y = np.exp(rng.normal(size=3 * _SCAN_BLOCK + 5) * 1e-3)
    got = _scan(torch.from_numpy(y), "prod").numpy()
    np.testing.assert_allclose(got, np.cumprod(y), rtol=1e-12)


@pytest.mark.parametrize("period", [1, -3])
@pytest.mark.parametrize("name", ALL_TYPES)
def test_pairwise_diff(name, period):
    """A bool column raises in both (numpy's boolean subtract)."""
    p, r = column_pair(name, 22)
    for fn in ("pairwise_diff", "pairwise_diff_checked"):
        got, want = run_both(fn, [p], [r], period=period)
        assert_same(got, want, tol="ulp")


# --- unique, value_counts, dictionary_encode --------------------------------

@pytest.mark.parametrize("fn", ["unique", "value_counts",
                                "dictionary_encode"])
@pytest.mark.parametrize("name", ALL_TYPES + list(DICTS))
def test_distinct_values(name, fn):
    """Values in order of first appearance (null one value, NaN one, -0.0
    and 0.0 two), on 20 distinct values so that runs repeat."""
    rng = np.random.default_rng(23)
    values = None
    if name not in DICTS and name != "bool":
        v = np.asarray(column_pair(name, 23, False)[1].values)[:N]
        values = v[rng.integers(0, 20, N)]
    p, r = (dict_pair(name, 23) if name in DICTS
            else column_pair(name, 24, True, values=values))
    got, want = run_both(fn, [p], [r])
    assert_same(got, want)


def test_unique_batch_two_keys():
    p1, r1 = column_pair("int16", 25, True,
                         values=np.arange(N).astype(np.int16) % 5)
    p2, r2 = dict_pair("dict_string", 26)
    pctx, rctx = contexts()
    from arrow_tpu.types import Field as RField, Schema as RSchema
    from arrow_tpu_torch.types import Field, Schema
    pb = DeviceBatch(Schema([Field("a", p1.type), Field("b", p2.type)]),
                     [p1, p2], torch.tensor(N, dtype=torch.int32))
    rb = JaxDeviceBatch(RSchema([RField("a", r1.type), RField("b", r2.type)]),
                        [r1, r2], jnp.asarray(N, jnp.int32))
    got = unique_batch(pctx, pb, ["b", "a"])
    want = jax_unique_batch(rctx, rb, ["b", "a"])
    assert int(got.row_count) == int(want.row_count)
    for g, w in zip(got.columns, want.columns):
        assert_same_column(g, w)


def test_spread_rows_direct():
    """``out[dest[i]] = a[i]`` for live rows; untouched slots zero, as
    the reference's direct branch gives."""
    rng = np.random.default_rng(27)
    n, size = 300, 512
    dest = rng.permutation(size)[:n].astype(np.int64)
    live = rng.random(n) > 0.3
    a = rng.normal(size=n)
    b = rng.integers(-9, 9, (n, 3)).astype(np.int32)
    got, got_live = spread_rows(torch.from_numpy(dest),
                                torch.from_numpy(live),
                                [torch.from_numpy(a), torch.from_numpy(b)],
                                size)
    want, want_live = jax_spread_rows(jnp.asarray(dest), jnp.asarray(live),
                                      [jnp.asarray(a), jnp.asarray(b)], size)
    np.testing.assert_array_equal(got_live.numpy(), np.asarray(want_live))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
