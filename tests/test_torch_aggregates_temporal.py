"""The compute functions the last eleven TPC-H plans add, against the JAX
package on seeded numpy inputs:

* ``hash_min`` / ``hash_max`` over floats with nulls, NaN and -0.0 (bit
  for bit: a NaN in a group gives NaN, -0.0 orders below 0.0), integers,
  bools and dictionary values (compared by value, the sorted dictionary
  passed through), under a row mask, with ``skip_nulls`` both ways;
* ``hash_count_distinct`` in its three modes, over null keys and values,
  on the perfect-hash and the general grouper;
* ``year``, ``month`` and ``day`` of date32 across negative days, leap
  days and 1 March;
* ``cast``: its results, and its safe failures raising where the
  reference flags a deferred error;
* ``utf8_slice_codeunits``: the derived dictionary deduplicated in order
  of first appearance, and a group-by over it;
* the byte-pool string tier (``compute/device_strings.py``): its tables
  bit-identical to the host tier's on a dictionary of at least 4,096
  values, its gates, and the predicates against the JAX functions.
"""

import datetime

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import arrow_tpu as at
from arrow_tpu import acero as jacero
from arrow_tpu.compute import hash_agg as jax_hash_agg
from arrow_tpu.compute.elementwise import ErrGuard
from arrow_tpu.compute.grouper import group_ids as jax_group_ids
from arrow_tpu.compute.registry import ExecContext as JaxExecContext
from arrow_tpu.compute.registry import get_function as jax_get_function
from arrow_tpu.device.column import DeviceColumn as JaxDeviceColumn
from arrow_tpu.device.column import upload_table
from arrow_tpu.table import Table
from arrow_tpu_torch import acero as tacero
from arrow_tpu_torch.compute import device_strings, hash_agg, strings
from arrow_tpu_torch.compute.grouper import group_ids, group_slot_bound_exact
from arrow_tpu_torch.compute.registry import ExecContext, get_function
from arrow_tpu_torch.device.column import DeviceColumn
from arrow_tpu_torch.types import TypeId, type_for_name

from test_torch_grouper_agg import (_KEY_SPECS, CAP, _compare_column,
                                    _contexts, _setup)
from test_torch_q1 import assert_tables_match, carry_across

_JAX_TYPES = {"float64": at.float64(), "float32": at.float32(),
              "int64": at.int64(), "int32": at.int32(), "bool": at.bool_(),
              "date32": at.date32()}


def _pair(values, valid=None, type_name=None, dictionary=None):
    """The same column in both packages."""
    type_name = type_name or str(values.dtype)
    port_valid = None if valid is None else torch.from_numpy(valid.copy())
    jax_valid = None if valid is None else jnp.asarray(valid)
    if dictionary is not None:
        return (DeviceColumn(torch.from_numpy(values.copy()), port_valid,
                             type_for_name("dictionary"), tuple(dictionary)),
                JaxDeviceColumn(jnp.asarray(values), jax_valid,
                                at.dictionary(at.int32(), at.string()),
                                at.array(list(dictionary), at.string())))
    return (DeviceColumn(torch.from_numpy(values.copy()), port_valid,
                         type_for_name(type_name)),
            JaxDeviceColumn(jnp.asarray(values), jax_valid,
                            _JAX_TYPES[type_name]))


def _values(rng, kind):
    """A column of CAP values of ``kind``, 10% null, and its dictionary."""
    valid = rng.random(CAP) >= 0.1
    if kind == "float64":
        v = rng.choice([-0.0, 0.0, 1.5, -2.25, np.inf, -np.inf], CAP)
        v = np.where(rng.random(CAP) < 0.5, rng.normal(size=CAP) * 1e3, v)
        v[rng.random(CAP) < 0.02] = np.nan
        return v, valid, None
    if kind == "float32":
        v = (rng.normal(size=CAP) * 1e3).astype(np.float32)
        v[::50] = -0.0
        v[::211] = np.nan
        return v, valid, None
    if kind == "int64":
        return rng.integers(-50, 50, CAP), valid, None
    if kind == "bool":
        return rng.random(CAP) < 0.7, valid, None
    # dictionary values, not in sorted order, with a null slot
    words = ("pear", "apple", None, "fig", "kiwi", "banana", "date")
    return rng.integers(0, len(words), CAP).astype(np.int32), valid, words


def _groups(seed, keys, filtered):
    """Group ids of the same keys through both packages: dictionary keys
    with nulls (perfect hash), or int64 keys with nulls (the general
    grouper)."""
    if keys != "int64":
        rng, ctx, jctx, pkeys, jkeys = _setup(seed, filtered,
                                              _KEY_SPECS[keys])
    else:
        rng = np.random.default_rng(seed)
        pk, jk = _pair(rng.integers(0, 40, CAP), rng.random(CAP) >= 0.05)
        pkeys, jkeys = [pk], [jk]
        ctx, jctx = _contexts(rng, filtered)
    return rng, ctx, jctx, group_ids(ctx, pkeys), jax_group_ids(jctx, jkeys), \
        group_slot_bound_exact(pkeys, CAP)


def _bits(a):
    a = np.asarray(a)
    return a.view({1: np.uint8, 4: np.int32, 8: np.int64}[a.itemsize])


@pytest.mark.parametrize("skip_nulls", [True, False])
@pytest.mark.parametrize("kind", ["float64", "float32", "int64", "bool",
                                  "dictionary"])
@pytest.mark.parametrize("fname", ["grouped_min", "grouped_max"])
@pytest.mark.parametrize("keys,filtered", [("one", False), ("three", True),
                                           ("int64", True)])
def test_grouped_min_max_matches_jax(fname, kind, skip_nulls, keys,
                                     filtered):
    rng, ctx, jctx, g, jg, nseg = _groups(3, keys, filtered)
    v, valid, words = _values(rng, kind)
    pcol, jcol = _pair(v, valid, dictionary=words)
    port = getattr(hash_agg, fname)(ctx, pcol, g.group_ids, g.num_groups,
                                    skip_nulls=skip_nulls, num_segments=nseg)
    jax = getattr(jax_hash_agg, fname)(jctx, jcol, jg.group_ids,
                                       jg.num_groups, skip_nulls=skip_nulls,
                                       num_segments=nseg)
    assert int(port.count) == int(jax.count)
    np.testing.assert_array_equal(port.column.validity.numpy(),
                                  np.asarray(jax.column.validity))
    pv, jv = port.column.values.numpy(), np.asarray(jax.column.values)
    assert pv.dtype == jv.dtype and pv.shape == jv.shape == (nseg,)
    # bit for bit, identities of empty groups included
    np.testing.assert_array_equal(_bits(pv), _bits(jv))
    assert int(port.column.type.id) == int(jax.column.type.id)
    if words is None:
        assert port.column.dictionary is None
    else:
        assert list(port.column.dictionary) == \
            jax.column.dictionary.to_pylist()
        assert list(port.column.dictionary) == sorted(
            w for w in words if w is not None) + [None]


def test_float_min_max_nan_and_signed_zero():
    """A NaN anywhere in a group gives NaN; -0.0 is the min and 0.0 the
    max of {-0.0, 0.0} whatever their order, as XLA's reductions give."""
    v = np.array([1.0, np.nan, 2.0, -0.0, 0.0, 0.0, -0.0, np.nan, 5.0,
                  np.inf, 3.0, -2.5])
    g = np.array([0, 0, 1, 2, 2, 3, 3, 4, 4, 5, 6, 6])
    ctx = ExecContext(len(v), torch.tensor(len(v), dtype=torch.int32))
    col = DeviceColumn(torch.from_numpy(v), None, type_for_name("float64"))
    lo = hash_agg.grouped_min(ctx, col, torch.from_numpy(g), torch.tensor(7),
                              num_segments=8).column.values.numpy()
    hi = hash_agg.grouped_max(ctx, col, torch.from_numpy(g), torch.tensor(7),
                              num_segments=8).column.values.numpy()
    assert np.isnan(lo[[0, 4]]).all() and np.isnan(hi[[0, 4]]).all()
    assert np.signbit(lo[2]) and np.signbit(lo[3])
    assert not np.signbit(hi[2]) and not np.signbit(hi[3])
    assert (lo[[1, 5, 6, 7]] == [2.0, np.inf, -2.5, np.inf]).all()
    assert (hi[[1, 5, 6, 7]] == [2.0, np.inf, 3.0, -np.inf]).all()


@pytest.mark.parametrize("mode", ["only_valid", "only_null", "all"])
@pytest.mark.parametrize("kind", ["int64", "float64", "dictionary"])
@pytest.mark.parametrize("keys,filtered", [("q1", False), ("three", True),
                                           ("int64", False),
                                           ("int64", True)])
def test_grouped_count_distinct_matches_jax(mode, kind, keys, filtered):
    rng, ctx, jctx, g, jg, nseg = _groups(5, keys, filtered)
    v, valid, words = _values(rng, kind)
    pcol, jcol = _pair(v, valid, dictionary=words)
    jax = jax_hash_agg.grouped_count_distinct(jctx, jcol, jg.group_ids,
                                              jg.num_groups, mode=mode)
    port = hash_agg.grouped_count_distinct(ctx, pcol, g.group_ids,
                                           g.num_groups, mode=mode)
    _compare_column(port, jax, CAP, 0)
    # at the grouper's segment bound, as the aggregate node calls it
    bounded = hash_agg.grouped_count_distinct(
        ctx, pcol, g.group_ids, g.num_groups, mode=mode, num_segments=nseg)
    np.testing.assert_array_equal(bounded.column.values.numpy(),
                                  np.asarray(jax.column.values)[:nseg])
    assert int(np.asarray(jax.column.values).sum()) > 0


def _dates(rng):
    """date32 days: random ones from 1600 to 2400, the days around every
    29 February and 1 March from 1896 to 2004, and the epoch's
    neighbours."""
    special = []
    for y in range(1896, 2005):
        for m, d in ((2, 28), (3, 1)):
            special.append((datetime.date(y, m, d)
                            - datetime.date(1970, 1, 1)).days)
        if y % 4 == 0 and (y % 100 or y % 400 == 0):
            special.append((datetime.date(y, 2, 29)
                            - datetime.date(1970, 1, 1)).days)
    special += [-1, 0, 1, -719162, -365, -366]
    rand = rng.integers(-135_000, 157_000, CAP - len(special))
    return np.concatenate([special, rand]).astype(np.int32)


@pytest.mark.parametrize("fn", ["year", "month", "day"])
def test_calendar_fields_match_jax(fn):
    rng = np.random.default_rng(9)
    days = _dates(rng)
    valid = rng.random(CAP) >= 0.1
    pcol, jcol = _pair(days, valid, "date32")
    ctx = ExecContext(CAP, torch.tensor(CAP, dtype=torch.int32))
    jctx = JaxExecContext(CAP, jnp.asarray(CAP, jnp.int32))
    port = get_function(fn).impl(ctx, pcol)
    jax = jax_get_function(fn).impl(jctx, jcol)
    assert port.values.dtype == torch.int64 and port.type.id == TypeId.INT64
    np.testing.assert_array_equal(port.values.numpy(),
                                  np.asarray(jax.values))
    np.testing.assert_array_equal(port.validity.numpy(), valid)
    epoch = datetime.date(1970, 1, 1)
    want = [getattr(epoch + datetime.timedelta(days=int(d)), fn)
            for d in days[:300]]
    assert port.values[:300].tolist() == want


@pytest.mark.parametrize("src,dst", [
    ("int64", "float64"), ("int32", "float64"), ("int64", "int32"),
    ("float64", "int64"), ("float64", "float32"), ("bool", "int64"),
    ("int64", "bool"), ("date32", "date32"), ("date32", "int64"),
    ("int32", "date32")])
def test_cast_matches_jax(src, dst):
    rng = np.random.default_rng(11)
    if src == "float64":
        v = rng.integers(-1000, 1000, CAP).astype(np.float64)
    elif src == "bool":
        v = rng.random(CAP) < 0.5
    else:
        v = rng.integers(-1000, 1000, CAP).astype(
            np.int32 if src in ("int32", "date32") else np.int64)
    valid = rng.random(CAP) >= 0.1
    pcol, jcol = _pair(v, valid, src)
    ctx = ExecContext(CAP, torch.tensor(CAP - 100, dtype=torch.int32))
    jctx = JaxExecContext(CAP, jnp.asarray(CAP - 100, jnp.int32))
    port = get_function("cast").impl(ctx, pcol, target_type=dst)
    jax = jax_get_function("cast").impl(jctx, jcol, to_type=dst)
    if isinstance(jax, ErrGuard):
        assert not bool(jax.flag)
        jax = jax.result
    assert port.values.numpy().dtype == np.asarray(jax.values).dtype
    np.testing.assert_array_equal(port.values.numpy(), np.asarray(jax.values))
    assert int(port.type.id) == int(jax.type.id)
    np.testing.assert_array_equal(port.validity.numpy(), valid)


@pytest.mark.parametrize("src,dst,bad", [
    ("float64", "int64", 2.5), ("float64", "int32", 3e9),
    ("float64", "int64", np.nan), ("int64", "int32", 2**40)])
def test_cast_safe_failures_raise(src, dst, bad):
    """A lossy value on a live row raises (the reference flags it); the
    same value on a null row or past the row count does not, nor with
    ``safe=False``."""
    v = np.arange(CAP).astype(src)
    valid = np.ones(CAP, dtype=bool)
    ctx = ExecContext(CAP, torch.tensor(CAP - 10, dtype=torch.int32))
    jctx = JaxExecContext(CAP, jnp.asarray(CAP - 10, jnp.int32))
    for row, null, lossy in ((7, False, True), (8, True, False),
                             (CAP - 3, False, False)):
        w, ok = v.copy(), valid.copy()
        w[row], ok[row] = bad, not null
        pcol, jcol = _pair(w, ok, src)
        jax = jax_get_function("cast").impl(jctx, jcol, to_type=dst)
        assert isinstance(jax, ErrGuard) and bool(jax.flag) == lossy
        if lossy:
            with pytest.raises(ValueError, match="lose data"):
                get_function("cast").impl(ctx, pcol, to_type=dst)
        else:
            get_function("cast").impl(ctx, pcol, to_type=dst)
        get_function("cast").impl(ctx, pcol, to_type=dst, safe=False)


def test_cast_of_strings_names_the_roadmap():
    """A string column parses its dictionary (item 9.9); a cast of numbers
    to strings still raises naming its ROADMAP item."""
    col = DeviceColumn(torch.tensor([1, 0, 1, 1], dtype=torch.int32), None,
                       type_for_name("dictionary"), ("1", "2"))
    ctx = ExecContext(4, torch.tensor(4, dtype=torch.int32))
    out = get_function("cast").impl(ctx, col, target_type="int64")
    assert out.values.tolist() == [2, 1, 2, 2]
    nums = DeviceColumn(torch.arange(4), None, type_for_name("int64"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_function("cast").impl(ctx, nums, target_type="string")


# --- utf8_slice_codeunits ---------------------------------------------------

_PHONES = ("13-555-0101", "31-555-0102", "13-555-0103", None, "24-1",
           "31-9", "x", "", "24-555", "13")


@pytest.mark.parametrize("start,stop,step", [(0, 2, 1), (3, None, 1),
                                             (0, None, 2), (1, 4, 1)])
def test_slice_dedupes_the_derived_dictionary(start, stop, step):
    rng = np.random.default_rng(13)
    codes = rng.integers(0, len(_PHONES), CAP).astype(np.int32)
    valid = rng.random(CAP) >= 0.1
    pcol, jcol = _pair(codes, valid, dictionary=_PHONES)
    ctx = ExecContext(CAP, torch.tensor(CAP, dtype=torch.int32))
    jctx = JaxExecContext(CAP, jnp.asarray(CAP, jnp.int32))
    opts = dict(start=start, stop=stop, step=step)
    port = get_function("utf8_slice_codeunits").impl(ctx, pcol, **opts)
    jax = jax_get_function("utf8_slice_codeunits").impl(jctx, jcol, **opts)
    assert list(port.dictionary) == jax.dictionary.to_pylist()
    assert len(set(port.dictionary)) == len(port.dictionary)
    np.testing.assert_array_equal(port.values.numpy(), np.asarray(jax.values))
    assert port.values.dtype == torch.int32
    np.testing.assert_array_equal(port.validity.numpy(), valid)


def test_group_by_a_derived_dictionary_matches_jax():
    """Q22's shape: the first two characters of a phone number, kept by
    ``is_in``, grouped and ordered by: one group a code, not a slot."""
    rng = np.random.default_rng(14)
    n = 5000
    phones = [f"{rng.integers(10, 35)}-{i:06d}" for i in range(n)]
    table = Table.from_pydict({
        "phone": at.array(phones, at.string()),
        "bal": at.array(rng.normal(5000, 3000, n), at.float64())})

    def plan(mod, src):
        d = mod.Declaration
        return d.from_sequence([
            d("table_source", mod.TableSourceNodeOptions(src)),
            d("project", mod.ProjectNodeOptions(
                [mod.Expression.call("utf8_slice_codeunits",
                                     mod.field("phone"), start=0, stop=2),
                 mod.field("bal")], ["code", "bal"])),
            d("filter", mod.FilterNodeOptions(mod.Expression.call(
                "is_in", mod.field("code"),
                value_set=["13", "31", "23", "29", "30", "18", "17"]))),
            d("aggregate", mod.AggregateNodeOptions(
                [([], "count_all", None, "n"), ("bal", "sum", None, "total"),
                 ("bal", "max", None, "top")], keys=["code"])),
            d("order_by", mod.OrderByNodeOptions([("code", "ascending")]))])

    got = plan(tacero, carry_across(upload_table(table))).to_table()
    want = plan(jacero, table).to_table().to_pydict()
    assert got["code"] == ["13", "17", "18", "23", "29", "30", "31"]
    assert_tables_match(got, want)


# --- the byte-pool tier -----------------------------------------------------

def _names(rng, n, extra=()):
    """``n`` distinct part-name-like values, one without a number, and
    ``extra``."""
    words = np.array(["forest", "Forest", "green", "ivory", "lace", "rose",
                      "FOREST", "mint", "blush", "almond"])
    picks = words[rng.integers(0, len(words), (n, 3))]
    vals = [" ".join(p) + f" {i}" for i, p in enumerate(picks)]
    return tuple(vals) + ("mint lace mint",) + tuple(extra)


_POOL_CASES = [
    ("starts_with", "forest", False), ("starts_with", "FOREST", True),
    ("starts_with", "", False), ("ends_with", "7", False),
    ("ends_with", "99", False), ("match_substring", "lace mint", False),
    ("match_substring", "ROSE", True), ("match_substring", "", False),
    ("match_like", "forest%", False), ("match_like", "%9", False),
    ("match_like", "%green rose%", True),
    ("match_like", "mint lace mint", False),
    ("match_like", "%ivory_%", False), ("match_like", "forest%green%", False),
]


@pytest.mark.parametrize("fn,pattern,ignore_case", _POOL_CASES)
@pytest.mark.parametrize("extra", [(), (None, "", "forest été")],
                         ids=["ascii", "null_and_utf8"])
def test_pool_tables_bit_identical_to_host(fn, pattern, ignore_case, extra):
    """The pool tier serves the predicates of a dictionary of at least
    4,096 values; its lookups equal the host tier's, and the JAX
    package's."""
    rng = np.random.default_rng(21)
    words = _names(rng, device_strings.DEVICE_STRINGS_MIN + 10, extra)
    codes = rng.integers(0, len(words), 3 * len(words)).astype(np.int32)
    valid = rng.random(len(codes)) >= 0.05
    pcol = DeviceColumn(torch.from_numpy(codes), torch.from_numpy(valid),
                        type_for_name("dictionary"), words)
    impl = get_function(fn).impl
    got = impl(None, pcol, pattern=pattern, ignore_case=ignore_case)
    small = device_strings.DEVICE_STRINGS_MIN
    try:
        device_strings.DEVICE_STRINGS_MIN = 10 ** 9   # the host tier
        host = impl(None, pcol, pattern=pattern, ignore_case=ignore_case)
    finally:
        device_strings.DEVICE_STRINGS_MIN = small
    assert torch.equal(got.values, host.values)
    assert got.values.dtype == torch.bool
    assert torch.equal(got.validity, pcol.validity)
    assert 0 < int(got.values.sum())
    _, jcol = _pair(codes, valid, dictionary=words)
    n = len(codes)
    jax = jax_get_function(fn).impl(JaxExecContext(n, jnp.asarray(n)), jcol,
                                    pattern=pattern, ignore_case=ignore_case)
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(jax.values))


def test_pool_gates():
    """The pool serves large dictionaries only, not ASCII-folding a pool
    with non-ASCII bytes nor a non-ASCII pattern; it is made once a
    dictionary and device."""
    rng = np.random.default_rng(22)
    words = _names(rng, device_strings.DEVICE_STRINGS_MIN)
    col = DeviceColumn(torch.zeros(8, dtype=torch.int32), None,
                       type_for_name("dictionary"), words)
    table = device_strings.pool_predicate("starts_with", col, "forest")
    assert table is not None and table.shape == (len(words),)
    want = np.array([w.startswith("forest") for w in words])
    np.testing.assert_array_equal(table.numpy(), want)
    pool = device_strings.dictionary_pool(words, torch.device("cpu"))
    assert pool is device_strings.dictionary_pool(words, torch.device("cpu"))
    assert pool.mat.dtype == torch.uint8 and pool.ascii_only
    assert pool.mat.shape == (len(words), max(map(len, words)))
    small = DeviceColumn(col.values, None, col.type, words[:100])
    assert device_strings.pool_predicate("starts_with", small, "f") is None
    assert device_strings.pool_predicate("starts_with", col, "fé") \
        is None
    utf8 = words + ("Été",)
    ucol = DeviceColumn(col.values, None, col.type, utf8)
    assert device_strings.pool_predicate("starts_with", ucol, "x",
                                         ignore_case=True) is None
    assert device_strings.pool_predicate("starts_with", ucol, "x") \
        is not None
    assert strings.starts_with(None, ucol, pattern="É",
                               ignore_case=True).values.shape == (8,)
