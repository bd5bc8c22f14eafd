"""Every scalar and grouped aggregate of the port, with its options,
against the JAX package's, over every type.

* Scalar: ``sum``, ``product``, ``mean``, ``min``, ``max``, ``min_max``,
  ``count`` (three modes), ``count_all``, ``any``, ``all``, ``first``,
  ``last``, ``first_last``, ``index``, ``variance``, ``stddev`` (``ddof``
  0 and 1), ``skew``, ``kurtosis`` (biased and not), ``quantile`` (five
  interpolations, a list of ``q``), ``median``, ``approximate_median``
  and ``count_distinct`` (three modes), with ``skip_nulls`` both ways
  and ``min_count`` 0, 1 and above the row count; on each type of
  ``test_torch_types.TYPES`` (floats with NaN, -0.0 and infinities, and
  again finite), dictionary columns of strings and of numbers, under a
  folded filter's row mask, and on empty and all-null inputs.
* Grouped: every ``hash_`` name with the same options, by a general key
  (int16 with nulls, the sort grouper) and a perfect-hash key (a
  dictionary), at the segment bound the plan node passes.

Validity, counts, indices and integer values exact; a float value within
rtol 1e-9 (1 ulp at f16/f32), or, for a sum, mean, product or moment,
within 1e-9 of the largest magnitude it is computed from (its terms'
sum of magnitudes; for skew and kurtosis the largest moment involved),
since each package adds in its own order. The two defects the port
repairs are shown on Arrow's own answers (pyarrow is the test oracle
only): scalar ``count_distinct`` and ``quantile``/``median`` where the
input holds NaN or both zeros.
"""

import functools
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arrow_tpu import types as RT
from arrow_tpu.compute import registry as jax_registry
from arrow_tpu.compute.aggregate import AggResult as JaxAggResult
from arrow_tpu.compute.grouper import group_ids as jax_group_ids
from arrow_tpu.compute.registry import ExecContext as JaxExecContext
from arrow_tpu.device.column import DeviceColumn as JaxDeviceColumn
from arrow_tpu_torch import types as PT
from arrow_tpu_torch.compute.grouper import group_ids, group_slot_bound_exact
from arrow_tpu_torch.compute.registry import ExecContext, get_function
from arrow_tpu_torch.device.column import DeviceColumn

from test_torch_types import CAP, N, TYPES, column_pair, run_both
from test_torch_vector_functions import DICTS, assert_same, dict_pair

FLOATS = ("float16", "float32", "float64")
CASES = list(TYPES) + [f"{f}_finite" for f in FLOATS] + list(DICTS)


def pair(case: str, seed: int, nulls: bool = True):
    """The case's column in both packages; ``<float>_finite`` has no NaN
    or infinity, so sums and moments are compared in earnest."""
    if case in DICTS:
        return dict_pair(case, seed, nulls)
    if case.endswith("_finite"):
        name = case[:-len("_finite")]
        rng = np.random.default_rng(seed)
        v = (rng.normal(size=N) * 30 + 5).astype(name)
        return column_pair(name, seed, nulls, values=v)
    return column_pair(case, seed, nulls)


def _bound(fn, ref_col, live, opts):
    """An absolute tolerance for a float result: 1e-9 (2**-10 at f16,
    2**-20 at f32) of the magnitude it is computed from."""
    v = np.asarray(ref_col.values)
    if v.dtype.kind not in "fiub" or ref_col.dictionary is not None:
        return None
    x = v.astype(np.float64)[live]
    scale = getattr(ref_col.type, "scale", None)
    if scale is not None:
        x = x * 10.0 ** -scale
    x = x[np.isfinite(x)]
    if not len(x):
        return None
    eps = {2: 2 ** -10, 4: 2 ** -20}.get(v.itemsize, 1e-9) \
        if v.dtype.kind == "f" else 1e-9
    with np.errstate(all="ignore"):
        mag = {"sum": np.abs(x).sum(), "mean": np.abs(x).mean(),
               "product": np.prod(np.abs(x))}.get(fn)
        if mag is None:
            c = np.abs(x - x.mean())
            var = (c ** 2).mean()
            mag = {"variance": var, "stddev": np.sqrt(var),
                   "skew": (c ** 3).mean() / max(var, 1e-300) ** 1.5,
                   "kurtosis": (c ** 4).mean() / max(var, 1e-300) ** 2}.get(
                       fn, np.abs(x).max())
    return 64 * eps * mag


def _live(ref_col, n, mask=None):
    live = np.arange(CAP) < n
    if mask is not None:
        live &= mask
    if ref_col.validity is not None:
        live &= np.asarray(ref_col.validity)
    return live


def _run_scalar(fn, p, r, n=N, mask=None, **opts):
    pctx, rctx = ExecContext(CAP, torch.tensor(n, dtype=torch.int32)), \
        JaxExecContext(CAP, jnp.asarray(n, jnp.int32))
    if mask is not None:
        pctx.row_mask_ = torch.from_numpy(mask & (np.arange(CAP) < n))
        rctx.row_mask_ = jnp.asarray(mask & (np.arange(CAP) < n))
    try:
        got = get_function(fn).impl(pctx, p, **opts)
    except Exception as e:  # noqa: BLE001 - compared below
        got = e
    try:
        want = jax_registry.get_function(fn).impl(rctx, r, **opts)
    except Exception as e:  # noqa: BLE001
        want = e
    return got, want


_NULL_OPTS = [{}, {"skip_nulls": False}, {"min_count": 0},
              {"min_count": N + 1}]
_SCALAR = (
    [("sum", o) for o in _NULL_OPTS] + [("product", o) for o in _NULL_OPTS]
    + [("mean", o) for o in _NULL_OPTS]
    + [(f, o) for f in ("min", "max", "min_max", "first", "last",
                        "first_last", "any", "all")
       for o in ({}, {"skip_nulls": False})]
    + [("count", {"mode": m}) for m in ("only_valid", "only_null", "all")]
    + [("count_all", {})]
    + [(f, o) for f in ("variance", "stddev")
       for o in ({}, {"ddof": 1}, {"skip_nulls": False}, {"min_count": 150})]
    + [(f, o) for f in ("skew", "kurtosis")
       for o in ({}, {"biased": False}, {"skip_nulls": False})]
    + [("quantile", {"q": [0.0, 0.1, 0.5, 0.77, 1.0], "interpolation": i})
       for i in ("linear", "lower", "higher", "nearest", "midpoint")]
    + [("median", {}), ("approximate_median", {"skip_nulls": False})]
    + [("count_distinct", {"mode": m}) for m in ("only_valid", "only_null",
                                                 "all")]
)
_SCALAR_IDS = [f + "".join(f"-{k}={v}" for k, v in o.items()
                           if k != "q") for f, o in _SCALAR]
# where the port follows Arrow rather than the reference (ROADMAP.md §3)
_ARROW_ONLY = ("count_distinct", "quantile", "median", "approximate_median")


def _has_nan(r):
    v = np.asarray(r.values)
    return v.dtype.kind == "f" and np.isnan(v[:N]).any()


def _has_both_zeros(r):
    v = np.asarray(r.values)[:N]
    return v.dtype.kind == "f" and (np.signbit(v) & (v == 0)).any() and \
        (~np.signbit(v) & (v == 0)).any()


@pytest.mark.parametrize("fn,opts", _SCALAR, ids=_SCALAR_IDS)
@pytest.mark.parametrize("case", CASES)
def test_scalar_aggregate(case, fn, opts):
    """Every scalar aggregate and option on every type, on all 200 live
    rows and under a folded filter's mask. Where the input holds NaN (or
    -0.0 beside 0.0, for count_distinct) the port gives Arrow's answer,
    which ``test_count_distinct_defect`` and ``test_quantile_defect``
    show; elsewhere the reference's."""
    p, r = pair(case, 31)
    mask = np.random.default_rng(32).random(CAP) < 0.6
    for m in (None, mask):
        got, want = _run_scalar(fn, p, r, mask=m, **opts)
        if fn in _ARROW_ONLY and r.dictionary is None and (
                _has_nan(r) or (fn == "count_distinct"
                                and _has_both_zeros(r))):
            want = _arrow_oracle(fn, r, m, opts)
        live = _live(r, N, m)
        assert_same(got, want, tol=_bound(fn, r, live, opts) or "ulp")


def _arrow_oracle(fn, r, mask, opts):
    """Arrow's answer from the reference's own parts: count_distinct as
    its ``hash_count_distinct`` of one group counts (by equality words);
    a quantile as its quantile of the column with the NaN rows nulled,
    valid where enough non-NaN values are live (and, with
    ``skip_nulls=False``, no null is)."""
    rctx = JaxExecContext(CAP, jnp.asarray(N, jnp.int32))
    row = np.arange(CAP) < N
    if mask is not None:
        row &= mask
    rctx.row_mask_ = jnp.asarray(row)
    if fn == "count_distinct":
        hcd = jax_registry.get_function("hash_count_distinct").impl
        gids = jnp.where(jnp.asarray(row), 0, CAP).astype(jnp.int64)
        res = hcd(rctx, r, gids, jnp.asarray(1, jnp.int64), **opts)
        return JaxAggResult(res.column.values[0], jnp.asarray(True),
                            RT.int64())
    v = np.asarray(r.values)
    valid = np.ones(CAP, bool) if r.validity is None else \
        np.asarray(r.validity)
    no_nan = JaxDeviceColumn(r.values, jnp.asarray(valid & ~np.isnan(v)),
                             r.type)
    q_opts = {k: x for k, x in opts.items() if k != "skip_nulls"}
    res = jax_registry.get_function(fn).impl(rctx, no_nan, **q_opts)
    ok = (row & valid & ~np.isnan(v)).sum() >= max(
        opts.get("min_count", 0), 1)
    if not opts.get("skip_nulls", True):
        ok &= not (row & ~valid).any()
    oks = tuple(jnp.asarray(ok) for _ in res.fields) if res.fields \
        else jnp.asarray(ok)
    return JaxAggResult(res.value, oks, res.type, res.fields)


@pytest.mark.parametrize("case", CASES)
def test_scalar_index(case):
    p, r = pair(case, 33)
    v = np.asarray(r.values)
    for value in (v[7].item(), v[150].item()):
        got, want = _run_scalar("index", p, r, value=value)
        assert_same(got, want)


@pytest.mark.parametrize("fn", ["sum", "mean", "min", "max", "min_max",
                                "product", "first", "last", "any", "all",
                                "variance", "quantile", "count_distinct",
                                "count"])
@pytest.mark.parametrize("input_", ["empty", "all_null"])
def test_scalar_aggregate_of_nothing(fn, input_):
    """No live row: each result is what the reference gives (null, or the
    identity where ``min_count=0``)."""
    p, r = pair("float64_finite" if fn != "any" else "bool", 34,
                nulls=True)
    n = N
    if input_ == "empty":
        n = 0
    else:
        p.validity.zero_()
        r = JaxDeviceColumn(r.values, jnp.zeros(CAP, jnp.bool_), r.type)
    for opts in ({}, {"min_count": 0}):
        if fn in ("count", "count_distinct", "quantile") and opts:
            continue
        got, want = _run_scalar(fn, p, r, n=n, **opts)
        assert_same(got, want)


_NAN_INPUT = [3.0, 1.0, np.nan, 1.0, -0.0, 0.0, 5.0, np.nan, 2.0, 1.0]
_ZEROS_INPUT = [3.0, 1.0, 4.0, 1.0, -0.0, 0.0, 5.0, 7.0, 2.0, 1.0]


def _float_pair(values):
    v = np.asarray(values, dtype=np.float64)
    return column_pair("float64", 0, False, values=v)


@pytest.mark.parametrize("values,arrow", [(_NAN_INPUT, 7),
                                          (_ZEROS_INPUT, 8)])
def test_count_distinct_defect(values, arrow):
    """The reference's scalar count_distinct sorts with a +inf sentinel:
    NaN sorts behind it (a sentinel is counted in the NaNs' place) and
    -0.0 == 0.0 merges the zeros. Arrow counts 7 and 8; the reference 6
    and 7; the port Arrow's, as its own ``hash_count_distinct`` does."""
    import pyarrow as pa
    import pyarrow.compute as pc
    assert pc.count_distinct(pa.array(values)).as_py() == arrow
    p, r = _float_pair(values)
    got, want = _run_scalar("count_distinct", p, r, n=len(values))
    assert int(want.value) == arrow - 1
    assert int(got.value) == arrow and bool(got.valid)


@pytest.mark.parametrize("q,arrow,reference", [
    (0.5, 1.0, 1.5), (1.0, 5.0, float("nan")), (0.0, -0.0, -0.0)])
def test_quantile_defect(q, arrow, reference):
    """The reference counts NaN rows as live and reads its +inf sentinel
    for them: its median of the NaN input is 1.5 and its q=1.0 NaN (inf -
    inf). Arrow leaves NaN out (median 1.0); so does the port."""
    import pyarrow as pa
    import pyarrow.compute as pc
    assert pc.quantile(pa.array(_NAN_INPUT), q=q).to_pylist() == [arrow]
    p, r = _float_pair(_NAN_INPUT)
    got, want = _run_scalar("quantile", p, r, n=len(_NAN_INPUT), q=q)
    w = float(want.value)
    assert w == reference or (np.isnan(w) and np.isnan(reference))
    assert float(got.value) == arrow and bool(got.valid)
    got, _ = _run_scalar("median", p, r, n=len(_NAN_INPUT))
    assert float(got.value) == 1.0


def test_quantile_matches_the_reference_without_nan():
    """On the same values without NaN both packages agree at every q."""
    v = [x for x in _NAN_INPUT if not np.isnan(x)]
    p, r = _float_pair(v)
    for i in ("linear", "lower", "higher", "nearest", "midpoint"):
        got, want = _run_scalar("quantile", p, r, n=len(v),
                                q=[0.0, 0.25, 0.5, 0.9, 1.0], interpolation=i)
        assert_same(got, want)


# --- grouped ----------------------------------------------------------------

_GROUPED = (
    [("hash_sum", o) for o in _NULL_OPTS[:3]]
    + [("hash_product", o) for o in _NULL_OPTS[:3]]
    + [("hash_mean", o) for o in _NULL_OPTS[:3]]
    + [(f, o) for f in ("hash_min", "hash_max", "hash_min_max",
                        "hash_first", "hash_last")
       for o in ({}, {"skip_nulls": False})]
    + [("hash_one", {})]
    + [(f, o) for f in ("hash_any", "hash_all")
       for o in ({}, {"skip_nulls": False}, {"min_count": 3})]
    + [(f, o) for f in ("hash_variance", "hash_stddev")
       for o in ({}, {"ddof": 1}, {"skip_nulls": False},
                 {"min_count": 12})]
    + [("hash_count", {"mode": m}) for m in ("only_valid", "only_null",
                                             "all")]
    + [("hash_count_distinct", {"mode": m})
       for m in ("only_valid", "only_null", "all")]
)
_GROUPED_IDS = [f + "".join(f"-{k}={v}" for k, v in o.items())
                for f, o in _GROUPED]


def _keys(kind: str):
    """A general key (int16, 13 values, nulls: the sort grouper) or a
    perfect-hash one (a dictionary of strings with a null value)."""
    if kind == "general":
        v = (np.arange(N) * 7 % 13).astype(np.int16)
        return column_pair("int16", 35, True, values=v)
    return dict_pair("dict_string", 36)


@functools.lru_cache(maxsize=None)
def _grouping(kind: str):
    """The key's group ids through both packages under a folded filter's
    mask (seeded), made once a kind: (contexts, group results, bound)."""
    mask = (np.random.default_rng(38).random(CAP) < 0.8) & \
        (np.arange(CAP) < N)
    return _group(_keys(kind), mask)


def _group(key, mask):
    pk, rk = key
    pctx = ExecContext(CAP, torch.tensor(N, dtype=torch.int32))
    rctx = JaxExecContext(CAP, jnp.asarray(N, jnp.int32))
    pctx.row_mask_ = torch.from_numpy(mask)
    rctx.row_mask_ = jnp.asarray(mask)
    g, jg = group_ids(pctx, [pk]), jax_group_ids(rctx, [rk])
    assert int(g.num_groups) == int(jg.num_groups)
    return pctx, rctx, g, jg, group_slot_bound_exact([pk], CAP), mask


def _run_grouped(fn, grouping, p, r, opts):
    pctx, rctx, g, jg, nseg, _ = grouping
    try:
        got = get_function(fn).impl(pctx, p, g.group_ids, g.num_groups,
                                    num_segments=nseg, **opts)
    except Exception as e:  # noqa: BLE001 - compared below
        got = e
    impl = jax_registry.get_function(fn).impl
    kw = dict(opts)
    if "num_segments" in inspect.signature(impl).parameters:
        kw["num_segments"] = nseg
    try:
        want = impl(rctx, r, jg.group_ids, jg.num_groups, **kw)
    except Exception as e:  # noqa: BLE001
        want = e
    return got, want, int(g.num_groups), g.group_ids.numpy()


def _head(res, n):
    """The first ``n`` rows (the live groups) of a grouped result."""
    if isinstance(res, (Exception, type(None))):
        return res
    if isinstance(res, dict):
        return {k: _head(v, n) for k, v in res.items()}
    c = res.column
    cut = type(c)(c.values[:n], None if c.validity is None
                  else c.validity[:n], c.type, c.dictionary)
    return type(res)(cut, res.count)


def _group_bound(fn, r, gids, live, n):
    """Per-group absolute tolerances, as ``_bound`` for each group."""
    base = fn[len("hash_"):]
    if base not in ("sum", "mean", "product", "variance", "stddev"):
        return None
    out = np.zeros(n)
    for gid in range(n):
        b = _bound(base, r, live & (gids == gid), {})
        out[gid] = 0.0 if b is None else b
    return out


# every case by the general key; one type of each family by the
# perfect-hash key, whose segment bound is below the row capacity
_PERFECT_CASES = ("bool", "int8", "uint32", "uint64", "float32", "float64",
                  "float64_finite", "timestamp[s]", "decimal128(12, 2)",
                  "dict_string", "dict_int64")
_GROUPINGS = [(c, "general") for c in CASES] + \
    [(c, "perfect") for c in _PERFECT_CASES]


@pytest.mark.parametrize("fn,opts", _GROUPED, ids=_GROUPED_IDS)
@pytest.mark.parametrize("case,keys", _GROUPINGS)
def test_grouped_aggregate(case, keys, fn, opts):
    """The live groups' values, validity, type and dictionary; the port
    reduces at the node's bound (``num_segments``) where the reference's
    any, all, variance and first run at the row capacity."""
    p, r = pair(case, 37)
    grouping = _grouping(keys)
    got, want, n, gids = _run_grouped(fn, grouping, p, r, opts)
    mask = grouping[-1]
    if isinstance(want, Exception) or isinstance(got, Exception):
        assert_same(got, want)
        return
    live = _live(r, N, mask)
    bound = _group_bound(fn, r, gids[:CAP], live, n)
    assert_same(_head(got, n), _head(want, n), tol="ulp", abs_tol=bound)


def test_hash_any_all_ignore_skip_nulls():
    """The reference's ``hash_any``/``hash_all`` take ``skip_nulls`` and
    ignore it: a group with a null and no true is False, not null. The
    port keeps that."""
    v = np.zeros(N, dtype=np.bool_)
    p, r = column_pair("bool", 39, True, values=v)
    for fn in ("hash_any", "hash_all"):
        got, want, n, _ = _run_grouped(fn, _grouping("general"), p, r,
                                       {"skip_nulls": False})
        assert got.column.validity is None and want.column.validity is None
        assert_same(_head(got, n), _head(want, n))


def test_cumulative_skip_nulls_keeps_the_column_validity():
    """With ``skip_nulls=True`` the reference's ``_cumulative`` keeps the
    column's own validity, padding rows included; the port keeps it."""
    p, r = column_pair("int64", 40)
    got, want = run_both("cumulative_sum", [p], [r], skip_nulls=True)
    assert_same(got, want)
    np.testing.assert_array_equal(got.validity.numpy(), p.validity.numpy())


def test_hash_product_wraps_as_numpy():
    """An int8 column's product per group is an int64 product that
    wraps, as numpy's does."""
    rng = np.random.default_rng(41)
    v = rng.integers(2, 7, N).astype(np.int8)
    p, r = column_pair("int8", 41, False, values=v)
    key = column_pair("int16", 42, False,
                      values=(np.arange(N) % 3).astype(np.int16))
    got, want, n, gids = _run_grouped(
        "hash_product", _group(key, np.arange(CAP) < N), p, r, {})
    assert_same(_head(got, n), _head(want, n))
    for gid in range(n):
        assert int(got.column.values[gid]) == int(np.prod(
            v[gids[:N] == gid].astype(np.int64)))


def test_scalar_count_all_reads_no_column():
    p, r = column_pair("float64", 43)
    got, want = _run_scalar("count_all", p, r)
    assert_same(got, want)
    got = get_function("count_all").impl(
        ExecContext(CAP, torch.tensor(N, dtype=torch.int32)))
    assert int(got.value) == N


def test_struct_and_list_types():
    t = PT.struct([("min", PT.int8()), ("max", PT.int8())])
    assert repr(t) == "struct<min: int8, max: int8>"
    assert t == PT.struct([("min", PT.int8()), ("max", PT.int8())])
    assert repr(PT.list_(PT.float64())) == "list<float64>"
    assert PT.list_(PT.float64()).fields[0].type == PT.float64()


def test_product_of_decimal_raises_as_the_reference():
    p, r = column_pair("decimal128(12, 2)", 44)
    got, want = _run_scalar("product", p, r)
    assert isinstance(got, ValueError) and isinstance(want, ValueError)
    col = DeviceColumn(torch.zeros(4, dtype=torch.int32), None,
                       PT.dictionary(PT.int32(), PT.string()), ("a",))
    with pytest.raises(ValueError, match="code-valued"):
        get_function("sum").impl(
            ExecContext(4, torch.tensor(4, dtype=torch.int32)), col)
