"""The rest of compute (ROADMAP items 9.9 and 9.10) against the JAX
package: the 20 names the port lacked, the string cast tier, the cast of a
literal and ``coalesce``/``if_else`` over two dictionaries.

Each name runs on the same seeded columns (``test_torch_types``'s
``column_pair``: whole integer ranges, uint16 and uint32 values at and
above 2**15 and 2**31, floats with NaN, -0.0 and infinities, a fifth of
the rows null over stored values) through the reference's function and the
port's. Keys, indices, counts, codes, hashes and validity are exact;
floats within rtol 1e-9 at f64 and 1 ulp at f16/f32 (``"ulp"``); the
grouped moments, which the reference sums in another order, within 64
ulp of the magnitude they come from (``test_torch_aggregates_full``'s
bound); ``rank_normal``'s probit (``torch.special.ndtri`` beside
``jax.scipy.special.ndtri``) within rtol 1e-9.

The differences kept on purpose, each with a test here: the grouped
quantiles leave NaN out, as the port's scalar ``quantile`` does; grouped
``skew``/``kurtosis`` honour ``biased=False`` as the scalar ones do;
``coalesce``, ``if_else`` and ``replace_with_mask`` re-encode two
dictionaries against their union, as the reference's eager call does for
the first two; a dictionary column without nulls comes out of
``coalesce`` as itself. The names still unresolved are exactly item 11's
29.
"""

import functools
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import arrow_tpu as at
import arrow_tpu.compute.extra_kernels  # noqa: F401 - registers its names
import arrow_tpu.compute.hashing  # noqa: F401
import arrow_tpu.compute.vector_misc  # noqa: F401
from arrow_tpu import types as RT
from arrow_tpu.compute import dispatch as jax_dispatch
from arrow_tpu.compute import registry as jax_registry
from arrow_tpu.compute.elementwise import ErrGuard
from arrow_tpu.compute.elementwise import _parse_one as reference_parse
from arrow_tpu.compute.grouper import group_ids as jax_group_ids
from arrow_tpu.compute.registry import ExecContext as JaxExecContext
from arrow_tpu.device.column import DeviceColumn as JaxDeviceColumn
from arrow_tpu.device.column import jnp_dtype_for
from arrow_tpu_torch import types as PT
from arrow_tpu_torch.compute import registry
from arrow_tpu_torch.compute.grouper import group_ids, group_slot_bound_exact
from arrow_tpu_torch.compute.registry import ExecContext, get_function
from arrow_tpu_torch.device.column import DeviceColumn

from test_torch_types import (CAP, N, TYPES, assert_same_result, column_pair,
                              contexts, run_both, type_name)
from test_torch_vector_functions import DICTS, assert_same, dict_pair

ALL = list(TYPES) + list(DICTS)


def any_pair(name, seed, nulls=True, values=None):
    if name in DICTS:
        return dict_pair(name, seed, nulls)
    return column_pair(name, seed, nulls, values=values)


# --- hash32 (item 9.10) ------------------------------------------------------

@pytest.mark.parametrize("name", ALL)
def test_hash32_is_bit_exact(name):
    """Every type of the device set, null rows over stored values, NaN and
    -0.0 among the floats, the unsigned ranges' top halves: the same
    uint32 bits and the column's validity."""
    p, r = any_pair(name, 3)
    got, want = run_both("hash32", [p], [r])
    assert_same(got, want)
    assert got.validity is p.validity


@pytest.mark.parametrize("name", ["float16", "float32", "float64"])
def test_hash32_of_nan_payloads_and_signed_zeros(name):
    """f64 NaNs of any payload hash as one quiet NaN, -0.0 apart from
    0.0; f32 (and f16 through f32) NaNs by their own bits."""
    bits = {"float16": (np.uint16, [0x7E00, 0xFE00, 0x7C01, 0x8000, 0]),
            "float32": (np.uint32, [0x7FC00000, 0xFFC00000, 0x7F800001,
                                    0x80000000, 0]),
            "float64": (np.uint64, [0x7FF8000000000000, 0xFFF8000000000000,
                                    0x7FF0000000000001, 1 << 63, 0])}[name]
    raw = np.array(bits[1] * (N // 5), dtype=bits[0]).view(name)
    p, r = column_pair(name, 4, values=raw)
    got, want = run_both("hash32", [p], [r])
    assert_same(got, want)
    h = got.values.numpy()
    assert (h[3] != h[4]) and (h[0] != h[1] if name != "float64"
                               else h[0] == h[1] == h[2])


# --- vector_misc -------------------------------------------------------------

_SETS = {"int": [5, None, -1, 0, 5, 127], "float": [0.5, -0.0, None, 1e300],
         "dict_string": ["fig", None, "pear", "nope", "fig"],
         "dict_int64": [12, None, 40, 12]}


def _value_set(name):
    if name in DICTS:
        return _SETS[name]
    return _SETS["float" if name.startswith("float") else "int"]


@pytest.mark.parametrize("skip_nulls", [False, True])
@pytest.mark.parametrize("fn", ["index_in", "index_in_meta_binary",
                                "is_in_meta_binary"])
@pytest.mark.parametrize("name", ["int8", "int64", "uint32", "float32",
                                  "float64", "dict_string", "dict_int64"])
def test_set_lookup(name, fn, skip_nulls):
    """The first index in the set (a null row the set's first null unless
    ``skip_nulls``), null where absent, 0 under the nulls."""
    p, r = any_pair(name, 5)
    vs = _value_set(name)
    if name not in DICTS:
        # values of the column itself, so rows are found
        vals = np.asarray(r.values)[:6].tolist()
        vs = vals[:3] + [None] + vals[1:2] + vs[:2]
    got, want = run_both(fn, [p], [r], value_set=vs,
                           skip_nulls=skip_nulls)
    assert_same(got, want)


@pytest.mark.parametrize("fn", ["fill_null_forward", "fill_null_backward"])
@pytest.mark.parametrize("name", ALL)
def test_fill_null(name, fn):
    p, r = any_pair(name, 6)
    got, want = run_both(fn, [p], [r])
    assert_same(got, want)


@pytest.mark.parametrize("name", ALL)
def test_run_end_encode(name):
    """Run ends and values, the run count, and what lies past the runs:
    the stored values repeated over runs of 4 rows under a validity of
    its own, so a run breaks where the stored value or the validity
    changes (NaN at every row)."""
    p, r = any_pair(name, 7)
    v = np.asarray(r.values)[np.repeat(np.arange(CAP // 4), 4)]
    p = DeviceColumn(torch.from_numpy(v.view(p.values.numpy().dtype).copy()),
                     p.validity, p.type, p.dictionary)
    r = JaxDeviceColumn(jnp.asarray(v), r.validity, r.type, r.dictionary)
    n = int(np.random.default_rng(7).integers(N // 2, N))
    got, want = run_both("run_end_encode", [p], [r], n=n)
    assert_same(got, want)


def _mask_pair(seed, n=N):
    rng = np.random.default_rng(seed)
    m = np.zeros(CAP, dtype=np.bool_)
    m[:n] = rng.random(n) < 0.4
    valid = np.zeros(CAP, dtype=np.bool_)
    valid[:n] = rng.random(n) > 0.1
    return (DeviceColumn(torch.from_numpy(m.copy()),
                         torch.from_numpy(valid.copy()), PT.bool_()),
            JaxDeviceColumn(jnp.asarray(m), jnp.asarray(valid), RT.bool_()))


@pytest.mark.parametrize("name", ["bool", "int16", "uint16", "uint64",
                                  "float16", "float64", "timestamp[ns]",
                                  "decimal128(12, 2)", "dict_string"])
def test_replace_with_mask(name):
    """The k-th true, valid, live mask row takes replacement k; a null
    mask row is null. Replacements of another dtype (int32 into
    int16) convert as ``astype``."""
    p, r = any_pair(name, 8)
    rep_name = "int32" if name == "int16" else name
    rp, rr = any_pair(rep_name, 9)
    mp, mr = _mask_pair(10)
    got, want = run_both("replace_with_mask", [p, mp, rp], [r, mr, rr])
    assert_same(got, want)


def _decoded(col, n):
    """A dictionary column's live rows as values (None where null)."""
    d = col.dictionary
    d = tuple(d.to_pylist()) if hasattr(d, "to_pylist") else d
    codes = np.asarray(col.values)[:n]
    valid = np.ones(n, bool) if col.validity is None \
        else np.asarray(col.validity)[:n]
    return [d[int(c)] if ok else None for c, ok in zip(codes, valid)]


def _two_dictionaries(seed):
    """Two string columns over different dictionaries, in both packages."""
    rng = np.random.default_rng(seed)
    out = []
    for words in (("pear", "apple", "fig", None), ("kiwi", "fig", "yam")):
        codes = np.zeros(CAP, dtype=np.int32)
        codes[:N] = rng.integers(0, len(words), N)
        valid = np.zeros(CAP, dtype=np.bool_)
        valid[:N] = rng.random(N) > 0.3
        out.append((DeviceColumn(torch.from_numpy(codes.copy()),
                                 torch.from_numpy(valid.copy()),
                                 PT.dictionary(PT.int32(), PT.string()),
                                 words),
                    JaxDeviceColumn(jnp.asarray(codes), jnp.asarray(valid),
                                    RT.dictionary(RT.int32(), RT.string()),
                                    at.array(list(words), RT.string()))))
    return out


def _reference_eager(fn, cols, **options):
    """The reference's eager call over device columns: its dispatch
    re-encodes the dictionaries against their union, then the function."""
    pctx, rctx = contexts()
    cols = jax_dispatch.unify_device_dicts(list(cols))
    return jax_registry.get_function(fn).impl(rctx, *cols, **options)


@pytest.mark.parametrize("fn", ["coalesce", "if_else", "replace_with_mask"])
def test_two_dictionaries_are_unified(fn):
    """A kept difference from the reference's plans (which mix the two
    columns' codes): the values of the reference's eager call, over the
    union dictionary."""
    (a, ra), (b, rb) = _two_dictionaries(11)
    pctx, _ = contexts()
    if fn == "if_else":
        cp, cr = _mask_pair(12)
        got = get_function(fn).impl(pctx, cp, a, b)
        want = _reference_eager(fn, [cr, ra, rb])
    elif fn == "coalesce":
        got = get_function(fn).impl(pctx, a, b)
        want = _reference_eager(fn, [ra, rb])
    else:
        mp, mr = _mask_pair(12)
        got = get_function(fn).impl(pctx, a, mp, b).column
        want = _reference_eager(fn, [ra, mr, rb]).column
    assert got.dictionary == tuple(sorted({"pear", "apple", "fig", "kiwi",
                                           "yam"}))
    assert _decoded(got, N) == _decoded(want, N)


def test_coalesce_keeps_a_dictionary_column_without_nulls():
    """Arrow's answer, kept on purpose: the reference gives the codes as
    int32 where the first column has no validity."""
    (a, ra), (b, rb) = _two_dictionaries(13)
    a = DeviceColumn(a.values, None, a.type, a.dictionary[:3])
    a.values[:N] %= 3
    pctx, _ = contexts()
    got = get_function("coalesce").impl(pctx, a, b)
    assert got is a
    want = _reference_eager("coalesce", [JaxDeviceColumn(
        jnp.asarray(a.values.numpy()), None, ra.type,
        at.array(list(a.dictionary), RT.string())), rb])
    assert want.dictionary is None and repr(want.type) == "int32"


# --- extra_kernels: math, statistics, ranks ----------------------------------

_PAIRS = [("float64", "float64"), ("float32", "float32"),
          ("int32", "float64"), ("int64", "int16"), ("float16", "float16"),
          ("float32", "int8"), ("uint32", "float32")]


@pytest.mark.parametrize("a,b", _PAIRS)
def test_hypot(a, b):
    """Within 1 ulp of the reference's value or of the correctly rounded
    one (f16 and f32 are computed in f64 and rounded once; XLA's f32
    ``hypot`` can be a few ulp off)."""
    pa, ra = column_pair(a, 14)
    pb, rb = column_pair(b, 15)
    x = np.asarray(ra.values).astype(np.float64)
    for other, rother in ((pb, rb), (3.0, 3.0)):
        y = np.asarray(rother.values).astype(np.float64) \
            if not isinstance(rother, float) else rother
        with np.errstate(all="ignore"):
            truth = np.hypot(x, y)
        got, want = run_both("hypot", [pa, other], [ra, rother])
        assert_same_result(got, want, tol="ulp", truth=truth)


@pytest.mark.parametrize("mode", ["half_to_even", "down", "up",
                                  "towards_zero", "half_away_from_zero",
                                  "half_up"])
@pytest.mark.parametrize("a", ["float64", "float32", "int64",
                               "decimal128(12, 2)"])
def test_round_binary(a, mode):
    """``b`` a row from -3 to 4 digits (an int8 column with nulls) and a
    literal; f64 out."""
    vals = None
    if a.startswith("float"):
        vals = (np.random.default_rng(16).normal(size=N) * 1e4).astype(a)
    pa, ra = column_pair(a, 16, values=vals)
    digits = np.random.default_rng(17).integers(-3, 5, N).astype(np.int8)
    pb, rb = column_pair("int8", 17, values=digits)
    got, want = run_both("round_binary", [pa, pb], [ra, rb],
                           round_mode=mode)
    assert_same(got, want, tol="ulp")
    got, want = run_both("round_binary", [pa, 2], [ra, 2],
                           round_mode=mode)
    assert_same(got, want, tol="ulp")


@pytest.mark.parametrize("name", ALL)
def test_indices_nonzero(name):
    p, r = any_pair(name, 18)
    got, want = run_both("indices_nonzero", [p], [r])
    assert_same(got, want)


@pytest.mark.parametrize("limits", [(0.0, 1.0), (0.1, 0.9), (0.05, 0.5)])
@pytest.mark.parametrize("name", ["int8", "uint32", "int64", "float16",
                                  "float32", "float64", "decimal128(12, 2)",
                                  "uint64"])
def test_winsorize(name, limits):
    """The reference's quantiles of the live lanes (a NaN counts, and
    sorts after the dead lanes), its output types."""
    p, r = column_pair(name, 19)
    got, want = run_both("winsorize", [p], [r], lower_limit=limits[0],
                           upper_limit=limits[1])
    assert_same(got, want)


@pytest.mark.parametrize("placement", ["at_end", "at_start"])
@pytest.mark.parametrize("fn", ["rank_quantile", "rank_normal"])
@pytest.mark.parametrize("name", ["int16", "uint64", "float32", "float64",
                                  "date64", "dict_string"])
def test_rank_quantile_and_normal(name, fn, placement):
    """``(mean of the min and max ranks - 0.5) / n``, n every live row:
    exact; its probit within rtol 1e-9 (NaN past 1, on the padding)."""
    p, r = any_pair(name, 20)
    got, want = run_both(fn, [p], [r], null_placement=placement,
                           sort_keys="descending")
    assert_same(got, want, tol=None if fn == "rank_quantile" else "ulp")


@pytest.mark.parametrize("q", [0.5, 0.1, [0.9, 0.25]])
@pytest.mark.parametrize("name", ["int32", "uint16", "float64_finite",
                                  "decimal128(12, 2)"])
def test_tdigest(name, q):
    """The exact linear quantile, as the reference's; the port's
    ``quantile`` beside it (NaN-free input: where a NaN is present the
    port leaves it out, ``test_torch_aggregates_full``)."""
    if name == "float64_finite":
        vals = np.random.default_rng(21).normal(size=N) * 30
        p, r = column_pair("float64", 21, values=vals)
    else:
        p, r = column_pair(name, 21)
    got, want = run_both("tdigest", [p], [r], q=q)
    assert_same(got, want, tol="ulp")
    pctx, _ = contexts()
    same = get_function("quantile").impl(pctx, p, q=q)
    for x, y in zip(np.atleast_1d(got.value), np.atleast_1d(same.value)):
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))


# --- the grouped aggregates --------------------------------------------------

def _keys(kind):
    """12 groups by an int16 key (the grouped-sum kernel's range on the
    card: ``num_segments`` 128 or below) or 13 by the sort grouper over
    the row capacity (1,024 segments: the kernel's other range)."""
    if kind == "small":
        v = (np.arange(N) * 5 % 12).astype(np.int16)
        return column_pair("int16", 30, True, values=v)
    v = (np.arange(N) * 7 % 13).astype(np.int16)
    return column_pair("int16", 31, True, values=v)


@functools.lru_cache(maxsize=None)
def _grouping(kind):
    pk, rk = _keys(kind)
    mask = (np.random.default_rng(32).random(CAP) < 0.85) & \
        (np.arange(CAP) < N)
    pctx = ExecContext(CAP, torch.tensor(N, dtype=torch.int32))
    rctx = JaxExecContext(CAP, jnp.asarray(N, jnp.int32))
    pctx.row_mask_ = torch.from_numpy(mask)
    rctx.row_mask_ = jnp.asarray(mask)
    g, jg = group_ids(pctx, [pk]), jax_group_ids(rctx, [rk])
    assert int(g.num_groups) == int(jg.num_groups)
    nseg = 128 if kind == "small" else group_slot_bound_exact([pk], CAP)
    return pctx, rctx, g, jg, nseg, mask


def _grouped(fn, kind, p, r, **opts):
    pctx, rctx, g, jg, nseg, _ = _grouping(kind)
    got = get_function(fn).impl(pctx, p, g.group_ids, g.num_groups,
                                num_segments=nseg, **opts)
    impl = jax_registry.get_function(fn).impl
    kw = dict(opts)
    if "num_segments" in inspect.signature(impl).parameters:
        kw["num_segments"] = nseg
    want = impl(rctx, r, jg.group_ids, jg.num_groups, **kw)
    return got, want, int(g.num_groups)


def _head(res, n):
    if isinstance(res, dict):
        return {k: _head(v, n) for k, v in res.items()}
    c = res.column
    return type(res)(type(c)(c.values[:n], None if c.validity is None
                             else c.validity[:n], c.type, c.dictionary),
                     res.count)


def _moment_bound(fn, r, kind, n):
    """64 ulp of the moment's magnitude a group (the reference sums in
    another order)."""
    _, _, _, jg, _, mask = _grouping(kind)
    gids = np.asarray(jg.group_ids)
    live = mask & (np.arange(CAP) < N)
    if r.validity is not None:
        live &= np.asarray(r.validity)
    x = np.asarray(r.values).astype(np.float64)
    scale = getattr(r.type, "scale", None)
    if scale is not None:
        x = x * 10.0 ** -scale
    out = np.zeros(n)
    for gid in range(n):
        xs = x[live & (gids == gid)]
        xs = xs[np.isfinite(xs)]
        if len(xs) < 2:
            continue
        c = np.abs(xs - xs.mean())
        var = max((c ** 2).mean(), 1e-300)
        mag = (c ** 3).mean() / var ** 1.5 if fn == "hash_skew" else \
            (c ** 4).mean() / var ** 2
        out[gid] = 64 * 1e-9 * mag
    return out


_GROUPED_TYPES = ["int8", "uint32", "int64", "float32", "float64",
                  "decimal128(12, 2)", "bool"]


@pytest.mark.parametrize("kind", ["small", "general"])
@pytest.mark.parametrize("fn", ["hash_skew", "hash_kurtosis"])
@pytest.mark.parametrize("name", _GROUPED_TYPES)
def test_grouped_moments(name, fn, kind):
    """At the defaults, the reference's values and validity."""
    vals = None
    if name in ("float32", "float64"):
        vals = (np.random.default_rng(33).normal(size=N) * 30 + 5).astype(
            name)
    p, r = column_pair(name, 33, values=vals)
    got, want, n = _grouped(fn, kind, p, r)
    assert_same(_head(got, n), _head(want, n), tol="ulp",
                abs_tol=_moment_bound(fn, r, kind, n))


@pytest.mark.parametrize("fn,scalar", [("hash_skew", "skew"),
                                       ("hash_kurtosis", "kurtosis")])
def test_grouped_moments_unbiased_follow_the_scalar(fn, scalar):
    """A kept difference: the reference's grouped moments ignore
    ``biased``; the port's take ``biased=False`` as its scalar ``skew``
    and ``kurtosis`` do, group by group."""
    vals = np.random.default_rng(34).normal(size=N) * 30
    p, r = column_pair("float64", 34, values=vals)
    pctx, _, g, _, nseg, mask = _grouping("small")
    got = get_function(fn).impl(pctx, p, g.group_ids, g.num_groups,
                                num_segments=nseg, biased=False)
    biased = get_function(fn).impl(pctx, p, g.group_ids, g.num_groups,
                                   num_segments=nseg)
    gids = g.group_ids.numpy()
    for gid in range(int(g.num_groups)):
        ctx = ExecContext(CAP, torch.tensor(N, dtype=torch.int32))
        ctx.row_mask_ = torch.from_numpy(mask & (gids == gid))
        want = get_function(scalar).impl(ctx, p, biased=False)
        assert float(got.column.values[gid]) == pytest.approx(
            float(want.value), rel=1e-9)
        assert float(got.column.values[gid]) != float(
            biased.column.values[gid])


_QUANTILE_CASES = [(f, o, name) for f, o in (
    ("hash_approximate_median", {}), ("hash_tdigest", {"q": 0.3}),
    ("hash_tdigest", {"q": [0.9, 0.1]}), ("hash_first_last", {}),
    ("hash_first_last", {"skip_nulls": False}))
    for name in ("int8", "uint32", "int64", "float32", "float64",
                 "decimal128(12, 2)", "date32")] + [
    ("hash_first_last", o, "dict_string")
    for o in ({}, {"skip_nulls": False})]


@pytest.mark.parametrize("kind", ["small", "general"])
@pytest.mark.parametrize("fn,opts,name", _QUANTILE_CASES)
def test_grouped_quantiles_and_first_last(name, fn, opts, kind):
    """NaN-free values: the reference's quantiles (within rtol 1e-9), first
    and last exactly, with their validity and dictionary."""
    vals = None
    if name.startswith("float"):
        vals = (np.random.default_rng(35).normal(size=N) * 30).astype(name)
    p, r = any_pair(name, 35, values=vals)
    got, want, n = _grouped(fn, kind, p, r, **opts)
    assert_same(_head(got, n), _head(want, n), tol="ulp")


def test_grouped_quantiles_leave_nan_out():
    """A kept difference: a group's NaN rows are not among its values (as
    the port's scalar ``quantile`` leaves them out); the reference
    counts them and reads NaN or its +inf sentinel."""
    vals = np.random.default_rng(36).normal(size=N) * 30
    vals[::3] = np.nan
    p, r = column_pair("float64", 36, values=vals)
    got, want, n = _grouped("hash_approximate_median", "small", p, r)
    pctx, _, g, _, _, mask = _grouping("small")
    gids = g.group_ids.numpy()
    live = mask & p.validity.numpy() & ~np.isnan(p.values.numpy())
    for gid in range(n):
        xs = p.values.numpy()[live & (gids == gid)]
        assert bool(got.column.validity[gid]) == (len(xs) > 0)
        if len(xs):
            assert float(got.column.values[gid]) == pytest.approx(
                np.median(xs), rel=1e-9)
    w = np.asarray(want.column.values)[:n]
    assert not np.array_equal(got.column.values.numpy()[:n], w)


# --- the cast tiers ----------------------------------------------------------

_STRINGS = ("1", " 42 ", "-3", "1_000", "x", "1.5", "1e3", "nan", "-inf",
            "true", "No", "T", "2020-01-02", "1969-12-31T23:59:59.5",
            "2020-01-02T03:04:05+05:30", "300", "", None, "4294967295")
_TARGETS = ["bool", "int8", "int32", "int64", "uint8", "uint32", "uint64",
            "float16", "float32", "float64", "date32", "date64",
            "timestamp[s]", "timestamp[ns]", "decimal128(12, 2)"]


def _strings_pair(words, seed):
    rng = np.random.default_rng(seed)
    codes = np.zeros(CAP, dtype=np.int32)
    codes[:N] = rng.integers(0, len(words), N)
    valid = np.zeros(CAP, dtype=np.bool_)
    valid[:N] = rng.random(N) > 0.2
    return (DeviceColumn(torch.from_numpy(codes.copy()),
                         torch.from_numpy(valid.copy()),
                         PT.dictionary(PT.int32(), PT.string()),
                         tuple(words)),
            JaxDeviceColumn(jnp.asarray(codes), jnp.asarray(valid),
                            RT.dictionary(RT.int32(), RT.string()),
                            at.array(list(words), RT.string())))


def _cast_both(p, r, pt, rt, safe):
    """(the port's cast or what it raised, the reference's)."""
    pctx, rctx = contexts()
    try:
        got = get_function("cast").impl(pctx, p, to_type=pt, safe=safe)
    except (ValueError, OverflowError) as e:
        got = e
    try:
        want = jax_registry.get_function("cast").impl(rctx, r, to_type=rt,
                                                      safe=safe)
    except (ValueError, OverflowError) as e:
        want = e
    return got, want


@pytest.mark.parametrize("safe", [False, True])
@pytest.mark.parametrize("target", _TARGETS)
def test_cast_from_strings(target, safe):
    """Each distinct value parsed by the reference's rules: unsafe, a
    value that does not parse is null; safe, a live row that does not
    parse raises, and a column whose values all parse casts. A parsed
    value out of the target's range raises OverflowError in both, and
    nothing parses as a decimal."""
    pt, rt = TYPES[target]
    p, r = _strings_pair(_STRINGS, 40)
    assert_same(*_cast_both(p, r, pt, rt, safe))
    if not pt.is_decimal:
        ok = []
        for w in _STRINGS:
            try:
                np.asarray([0 if w is None else reference_parse(w, rt)],
                           dtype=jnp_dtype_for(rt))
                ok.append(w)
            except (ValueError, ArithmeticError):
                pass
        assert len(ok) >= 2
        p, r = _strings_pair(ok, 41)
        got, want = _cast_both(p, r, pt, rt, safe)
        assert not isinstance(want, ErrGuard) or not bool(want.flag)
        assert_same(got, want)


@pytest.mark.parametrize("value,target,safe", [
    (5, "float32", True), (2.5, "int32", False), (2.5, "int32", True),
    (1, "bool", True), (-1, "uint16", False), (300, "int8", True),
    (np.float32(1.25), "float64", True), (7, "date32", True)])
def test_cast_of_a_literal(value, target, safe):
    """What the reference's ``jnp.asarray`` path gives: a 0-d column of
    the target type (a lossy safe cast raises)."""
    pctx, rctx = contexts()
    try:
        got = get_function("cast").impl(pctx, value, to_type=target,
                                        safe=safe)
    except ValueError as e:
        got = e
    want = jax_registry.get_function("cast").impl(
        rctx, value, to_type=TYPES[target][1], safe=safe)
    if isinstance(want, ErrGuard):
        if bool(want.flag):
            assert isinstance(got, ValueError)
            return
        want = want.result
    assert not isinstance(got, Exception), got
    assert got.values.dim() == 0 and got.validity is None
    w = np.asarray(want.values)
    g = got.values.numpy()
    assert (g.view(w.dtype) if g.dtype != w.dtype else g) == w, (g, w)
    assert type_name(got.type) == type_name(want.type)


# --- the registry ------------------------------------------------------------

def test_only_item_11_is_left():
    """281 of the reference's 310 names resolve; the 29 that do not are
    the reference's host tier and its host-tier grouped aggregates, each
    raising naming item 11."""
    import importlib
    for m in ("aggregate", "elementwise", "extra_kernels", "grouper",
              "hash_agg", "hashing", "selection", "strings", "temporal",
              "vector_misc", "vector_sort"):
        importlib.import_module(f"arrow_tpu.compute.{m}")
    importlib.import_module("arrow_tpu.compute")
    names = sorted(jax_registry._REGISTRY)
    missing = []
    for n in names:
        try:
            get_function(n)
        except NotImplementedError as e:
            assert "item 11" in str(e), (n, e)
            missing.append(n)
    assert sorted(missing) == sorted(registry._HOST_TIER + (
        "hash_list", "hash_distinct", "hash_pivot_wider"))
    assert len(missing) == 29
    assert len(names) - len(missing) == 281
