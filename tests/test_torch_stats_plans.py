"""``chip_smoke.py``'s phase 3g at SF 0.01 on the CPU: the vector functions
and the statistics aggregates over Q1's lineitem and the typed lineitem of
phase 3f (``chip_smoke.stats_inputs``), path by path:

* against ``chip_smoke``'s numpy oracle for the path, as phase 3g holds the
  port on the card (``STATS_PATHS``);
* against the JAX package: the same registered functions over the same
  columns (``sort_take``, ``cumulative``, ``distinct``, ``select``), and
  the same declarations through both packages' ``to_table()``
  (``stats_grouped``, ``stats_scalar``). Keys, indices, counts, validity
  and order exact; floats within rtol 1e-9 (a running sum within 1e-9 of
  its running sum of magnitudes);
* the float results that phase 3g runs twice give the same bits twice.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import arrow_tpu.acero as jacero
from arrow_tpu.compute import registry as jax_registry
from arrow_tpu.compute.registry import ExecContext as JaxExecContext
from arrow_tpu.device.column import DeviceColumn as JaxDeviceColumn

import chip_smoke
from arrow_tpu_torch.io import tpch
from arrow_tpu_torch.io.tpch_device import q1_device_batch
from arrow_tpu_torch.types import TypeId

from test_torch_typed_plans import _ref_type, _same, _to_reference
from test_torch_vector_functions import assert_same

SF = 0.01


@pytest.fixture(scope="module")
def stats():
    lineitem, _ = q1_device_batch(SF, device="cpu")
    part = tpch.part_table(SF, device="cpu")
    s = chip_smoke.stats_inputs(lineitem,
                                chip_smoke.typed_tables(lineitem, part))
    return s, chip_smoke.stats_columns(s)


@pytest.mark.parametrize("path", chip_smoke.STATS_PATHS,
                         ids=lambda p: p.name)
def test_stats_path_matches_its_oracle(stats, path):
    s, c = stats
    msg = path.check(c, path.run(s))
    assert msg


def _ref_col(col):
    """A port column as a reference DeviceColumn over the same stored
    values, validity and dictionary."""
    import arrow_tpu as at
    from arrow_tpu import types as RT
    v = col.values.numpy()
    if col.type.is_unsigned_integer:
        v = v.view(np.dtype(f"uint{8 * v.itemsize}"))
    rtype = RT.dictionary(RT.int32(), RT.string()) \
        if col.type.id == TypeId.DICTIONARY else _ref_type(col.type)
    return JaxDeviceColumn(
        jnp.asarray(v),
        None if col.validity is None else jnp.asarray(col.validity.numpy()),
        rtype, None if col.dictionary is None
        else at.array(list(col.dictionary), RT.string()))


def _both(fn, ctx_batch, cols, **opts):
    """(port result, reference result) of ``fn`` over ``cols`` (port
    DeviceColumns), in the context of ``ctx_batch`` (a batch or a
    (capacity, row count) pair)."""
    from arrow_tpu_torch.compute.registry import ExecContext, get_function
    cap, rows = (ctx_batch.capacity, ctx_batch.row_count) \
        if hasattr(ctx_batch, "capacity") else ctx_batch
    got = get_function(fn).impl(ExecContext(cap, rows), *cols, **opts)
    jctx = JaxExecContext(cap, jnp.asarray(int(rows), jnp.int32))
    want = jax_registry.get_function(fn).impl(
        jctx, *[_ref_col(c) for c in cols], **opts)
    return got, want


def test_sort_take_matches_reference(stats):
    s, _ = stats
    t = s["typed"]
    li = t.column
    got, want = _both("sort_indices", t, [li(k) for k, _ in
                                          chip_smoke.SORT_KEYS],
                      sort_keys=chip_smoke.SORT_KEYS,
                      null_placement="at_start")
    assert_same(got, want)
    perm = got.column
    for k in chip_smoke.TAKE_COLUMNS:
        g, w = _both("take", (perm.capacity, got.count), [li(k), perm])
        assert_same(g, w)
    g, w = _both("inverse_permutation", (perm.capacity, got.count), [perm])
    assert_same(g, w)
    g, w = _both("select_k_unstable", t, [li(k) for k, _ in
                                          chip_smoke.TOPK_KEYS],
                 k=chip_smoke.STATS_K, sort_keys=chip_smoke.TOPK_KEYS)
    assert_same(g, w)
    for tb in chip_smoke.TIEBREAKERS:
        g, w = _both("rank", t, [li("l_quantity")], tiebreaker=tb)
        assert_same(g, w)
    g, w = _both("partition_nth_indices", t, [li("l_quantity")], pivot=7)
    assert_same(g, w)


def test_cumulative_matches_reference(stats):
    s, c = stats
    li, t = s["lineitem"], s["typed"]
    price = li.column("l_extendedprice")
    bound = 1e-9 * np.cumsum(np.abs(price.values.numpy()))
    for fn in ("cumulative_sum", "cumulative_min", "cumulative_max",
               "cumulative_mean"):
        g, w = _both(fn, li, [price])
        assert_same(g, w, tol="ulp", abs_tol=bound)
        for skip in (False, True):
            g, w = _both(fn, t, [t.column("l_suppkey")], skip_nulls=skip)
            assert_same(g, w, tol="ulp")
    for period in (1, -3):
        g, w = _both("pairwise_diff", li, [li.column("l_orderkey")],
                     period=period)
        assert_same(g, w)


def test_distinct_matches_reference(stats):
    s, _ = stats
    t = s["typed"]
    supp = t.column("l_suppkey")
    for fn in ("unique", "value_counts", "dictionary_encode"):
        g, w = _both(fn, t, [supp])
        assert_same(g, w)
    g, w = _both("unique", t, [t.column("l_returnflag")])
    assert_same(g, w)
    for col, mode in (("l_partkey", "only_valid"), ("l_suppkey", "all")):
        g, w = _both("count_distinct", t, [t.column(col)], mode=mode)
        assert_same(g, w)


def test_select_matches_reference(stats):
    """The nullable mask both ways, drop_null, take with null indices; an
    index out of range raises IndexError in the port where the
    reference's ErrGuard raises its flag."""
    from arrow_tpu.compute.elementwise import ErrGuard
    s, _ = stats
    t = s["typed"]
    supp = t.column("l_suppkey")
    for fn, behavior in (("filter", "drop"), ("array_filter", "emit_null")):
        g, w = _both(fn, t, [supp, s["mask"]],
                     null_selection_behavior=behavior)
        assert_same(g, w)
    g, w = _both("drop_null", t, [supp])
    assert_same(g, w)
    idx = s["idx"]
    g, w = _both("take", (idx.capacity, t.row_count),
                 [t.column("l_extendedprice"), idx])
    assert isinstance(w, ErrGuard) and not bool(w.flag)
    assert_same(g, w.result)
    with pytest.raises(IndexError):
        _both("take", (idx.capacity, t.row_count),
              [t.column("l_extendedprice"), s["bad_idx"]])
    jctx = JaxExecContext(idx.capacity, jnp.asarray(int(t.row_count),
                                                    jnp.int32))
    w = jax_registry.get_function("take").impl(
        jctx, _ref_col(t.column("l_extendedprice")), _ref_col(s["bad_idx"]))
    assert bool(w.flag)


def _reference_inputs(s):
    return {"typed": _to_reference(s["typed"]),
            "lineitem": _to_reference(s["lineitem"])}


def test_stats_grouped_matches_reference(stats):
    s, _ = stats
    ref = _reference_inputs(s)
    for got_decl, want_decl in zip(chip_smoke.stats_grouped_decls(s),
                                   chip_smoke.stats_grouped_decls(ref,
                                                                  jacero)):
        got = got_decl.to_table()
        assert len(next(iter(got.values()))) > 0
        _same(got, want_decl.to_table().to_pydict())


def test_stats_scalar_matches_reference(stats):
    s, _ = stats
    got = chip_smoke.stats_scalar_decl(s).to_table()
    want = chip_smoke.stats_scalar_decl(_reference_inputs(s),
                                        jacero).to_table().to_pydict()
    _same(got, want)


def test_float_results_repeat_their_bits(stats):
    s, _ = stats
    first, second = chip_smoke.stats_repeats(s), chip_smoke.stats_repeats(s)
    assert len(first) == 5
    for a, b in zip(first, second):
        assert a.dtype == b.dtype and np.array_equal(
            a.numpy().view(np.uint8), b.numpy().view(np.uint8))
