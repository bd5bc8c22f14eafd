"""TPC-H Q4 and Q13 of the port against the JAX package, and the pieces
they add.

* ``io/tpch.py``: lineitem, orders and customer bit-identical to
  ``arrow_tpu.io.tpch``'s at SF 0.005 and 0.01 (customer's plain-string
  ``c_name`` and ``c_phone`` as the reference's upload encodes them).
* Q4 and Q13 through both packages' plans over their own generators at
  SF 0.005 (the reference's ``tests/test_tpch_full.py``) and 0.01: keys,
  counts and order exact.
* The Kleene and intersection boolean functions over full 3x3 truth
  tables, and ``match_like`` on a dictionary-coded column, against the
  JAX functions.
* Grouped ``count`` over a column whose nulls come from an outer join,
  ``count_all``, and an aggregate over another aggregate's output.
* ``chip_smoke.py``'s numpy oracles for Q4 and Q13, and the filter masks
  it holds the compaction kernel to, against the port on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import arrow_tpu as at
from arrow_tpu.compute.registry import ExecContext as JaxExecContext
from arrow_tpu.compute.registry import get_function as jax_get_function
from arrow_tpu.device.column import DeviceColumn as JaxDeviceColumn
from arrow_tpu.device.column import upload_table
from arrow_tpu.io import tpch as jax_tpch
from arrow_tpu.io import tpch_queries as jax_queries
from arrow_tpu.table import Table
from arrow_tpu_torch.acero import (Declaration, Expression,
                                   FilterNodeOptions, TableSourceNodeOptions,
                                   field)
from arrow_tpu_torch.acero.exec import execute_declaration
from arrow_tpu_torch.compute.registry import ExecContext, get_function
from arrow_tpu_torch.compute.strings import match_like
from arrow_tpu_torch.device.column import DeviceColumn, round_up
from arrow_tpu_torch.io import tpch
from arrow_tpu_torch.io import tpch_queries
from arrow_tpu_torch.kernels.compact import compact_plain
from arrow_tpu_torch.types import bool_, int64

import chip_smoke
from test_torch_join_types import _case_tables, _run_both
from test_torch_q1 import assert_tables_match
from worker_settings import collect_after_test, gc_off_in_module  # noqa: F401

SCALE_FACTORS = [0.005, 0.01]


@pytest.mark.parametrize("sf", SCALE_FACTORS)
@pytest.mark.parametrize("table", ["lineitem", "orders", "customer"])
def test_tables_bit_identical(table, sf):
    jt = getattr(jax_tpch, f"{table}_table")(sf)
    jb = upload_table(jt)
    tb = getattr(tpch, f"{table}_table")(sf, device="cpu")
    n = jt.num_rows
    assert int(tb.row_count) == n and tb.capacity == round_up(n)
    assert tb.schema.names == jt.column_names
    for f, tc in zip(tb.schema.fields, tb.columns):
        jc = jb.column(f.name)
        want = np.asarray(jc.values)[:n]
        got = tc.values[:n].numpy()
        assert got.dtype == want.dtype, f.name
        assert got.tobytes() == want.tobytes(), f.name
        assert not tc.values[n:].any(), f.name
        assert int(f.type.id) == int(jc.type.id), f.name
        assert tc.validity is None
        if jc.dictionary is None:
            assert tc.dictionary is None, f.name
        else:
            assert list(tc.dictionary) == jc.dictionary.to_pylist(), f.name


@pytest.mark.parametrize("sf", SCALE_FACTORS)
def test_q4_matches_jax(sf):
    want = jax_queries.q4_plan(jax_tpch.orders_table(sf),
                               jax_tpch.lineitem_table(sf)) \
        .to_table().to_pydict()
    got = tpch_queries.q4_plan(tpch.orders_table(sf, device="cpu"),
                               tpch.lineitem_table(sf, device="cpu")) \
        .to_table().to_pydict()
    assert got["o_orderpriority"] == list(tpch.ORDERPRIORITY)
    assert sum(got["order_count"]) > 0
    assert_tables_match(got, want)


@pytest.mark.parametrize("sf", SCALE_FACTORS)
def test_q13_matches_jax(sf):
    want = jax_queries.q13_plan(jax_tpch.customer_table(sf),
                                jax_tpch.orders_table(sf)) \
        .to_table().to_pydict()
    got = tpch_queries.q13_plan(tpch.customer_table(sf, device="cpu"),
                                tpch.orders_table(sf, device="cpu")) \
        .to_table().to_pydict()
    assert sum(got["custdist"]) == int(150_000 * sf)
    assert_tables_match(got, want)


@pytest.mark.parametrize("sf", SCALE_FACTORS)
def test_chip_smoke_oracles_match_port(sf):
    orders = tpch.orders_table(sf, device="cpu")
    customer = tpch.customer_table(sf, device="cpu")
    lineitem = tpch.lineitem_table(sf, device="cpu")
    want, n_orders = chip_smoke.q4_oracle(orders, lineitem)
    assert n_orders == sum(want["order_count"]) > 0
    chip_smoke.check_result(
        "Q4", tpch_queries.q4_plan(orders, lineitem).to_table().to_pydict(), want)
    want, n_kept = chip_smoke.q13_oracle(customer, orders)
    assert 0 < n_kept < int(orders.row_count)
    chip_smoke.check_result(
        "Q13", tpch_queries.q13_plan(customer, orders).to_table().to_pydict(), want)


def test_chip_smoke_filter_inputs_match_plans():
    """Each keep mask chip_smoke's phase 2 compacts with keeps the rows
    that the plan's own filter keeps, over every column of its batch."""
    sf = 0.005
    orders = tpch.orders_table(sf, device="cpu")
    lineitem = tpch.lineitem_table(sf, device="cpu")
    cases, _ = chip_smoke.q4_q13_filter_inputs(lineitem, orders)
    f, call = field, Expression.call
    lo = tpch_queries.DATE_1993_07_01
    predicates = {
        "Q4 lineitem filter": (lineitem,
                               f("l_commitdate") < f("l_receiptdate")),
        "Q4 orders filter": (orders, (f("o_orderdate") >= lo)
                             & (f("o_orderdate") < lo + 92)),
        "Q13 orders filter": (orders, call("invert", call(
            "match_like", f("o_comment"), pattern="%special%requests%")))}
    assert [name for name, _, _ in cases] == list(predicates)
    for name, keep, cols in cases:
        batch, predicate = predicates[name]
        assert len(cols) == len(batch.columns), name
        want = execute_declaration(Declaration.from_sequence([
            Declaration("table_source", TableSourceNodeOptions(batch)),
            Declaration("filter", FilterNodeOptions(predicate))]))
        outs, count = compact_plain(keep, cols)
        n = int(want.row_count)
        assert int(count) == n and 0 < n < int(batch.row_count), name
        for got, w in zip(outs, want.columns):
            assert torch.equal(got[:n], w.values[:n]), name


# --- boolean logic and LIKE --------------------------------------------------

_TRUTH = [True, False, None]


def _truth_columns(null_value: bool):
    """Every (a, b) pair of true, false and null as two 9-row columns;
    null lanes hold ``null_value``."""
    pairs = [(a, b) for a in _TRUTH for b in _TRUTH]
    cols = []
    for side in (0, 1):
        vals = np.array([null_value if p[side] is None else p[side]
                         for p in pairs])
        valid = np.array([p[side] is not None for p in pairs])
        cols.append((vals, valid))
    return cols


@pytest.mark.parametrize("null_value", [False, True])
@pytest.mark.parametrize("fn", ["and_kleene", "or_kleene", "and", "or",
                                "invert"])
def test_boolean_truth_tables(fn, null_value):
    cols = _truth_columns(null_value)
    args = cols[:1] if fn == "invert" else cols
    jargs = [JaxDeviceColumn(jnp.asarray(v), jnp.asarray(m), at.bool_())
             for v, m in args]
    targs = [DeviceColumn(torch.from_numpy(v), torch.from_numpy(m), bool_())
             for v, m in args]
    want = jax_get_function(fn).impl(JaxExecContext(9, jnp.int32(9)), *jargs)
    got = get_function(fn).impl(ExecContext(9, torch.tensor(9)), *targs)
    np.testing.assert_array_equal(got.validity.numpy(),
                                  np.asarray(want.validity))
    np.testing.assert_array_equal(got.values.numpy(),
                                  np.asarray(want.values))
    if fn == "and_kleene":  # false & null is false, true & null is null
        assert got.validity[1 * 3 + 2] and not got.values[1 * 3 + 2]
        assert not got.validity[0 * 3 + 2]
    if fn == "or_kleene":   # true | null is true, false | null is null
        assert got.validity[0 * 3 + 2] and got.values[0 * 3 + 2]
        assert not got.validity[1 * 3 + 2]


def _strings_table(rng):
    pool = ["special requests", "furiously special deposits requests",
            "Special Requests", "requests special", "a_c%", "abc", "",
            "slyly special even requests", "a%c", "x\\y"]
    n = 700
    vals = [pool[i] if rng.random() > 0.1 else None
            for i in rng.integers(0, len(pool), n)]
    return Table.from_pydict({"s": at.array(vals, at.string()),
                              "k": at.array(np.arange(n), at.int64())})


@pytest.mark.parametrize("pattern,ignore_case", [
    ("%special%requests%", False), ("%special%requests%", True),
    ("a\\_c%", False), ("a_c", False), ("%", False), ("abc", False),
    ("special%", False), ("%requests", False), ("x\\\\y", False),
    ("", False)])
def test_match_like_on_dictionary_column(pattern, ignore_case):
    table = _strings_table(np.random.default_rng(len(pattern)))

    def make(mod, t, _unused):
        src = mod.Declaration
        like = mod.Expression.call("match_like", mod.field("s"),
                                   pattern=pattern, ignore_case=ignore_case)
        return src.from_sequence([
            src("table_source", mod.TableSourceNodeOptions(t)),
            src("project", mod.ProjectNodeOptions(
                [mod.field("k"), like, ~like], ["k", "m", "not_m"]))])

    got, want = _run_both(make, table, table)
    assert_tables_match(got, want)
    assert None in got["m"]


def test_match_like_filter_and_conjunction():
    """``invert(match_like)`` as a filter and ``&``/``|`` of comparisons
    (Q4's and Q13's predicates) through both packages."""
    table = _strings_table(np.random.default_rng(3))

    def make(mod, t, _unused):
        src = mod.Declaration
        f = mod.field
        keep = mod.Expression.call("invert", mod.Expression.call(
            "match_like", f("s"), pattern="%special%requests%"))
        return src.from_sequence([
            src("table_source", mod.TableSourceNodeOptions(t)),
            src("filter", mod.FilterNodeOptions(
                keep & ((f("k") >= 100) & (f("k") < 600)
                        | (f("k") < 7))))])

    got, want = _run_both(make, table, table)
    assert 0 < len(got["k"]) < 700
    assert_tables_match(got, want)


def test_match_like_needs_a_dictionary_column():
    col = DeviceColumn(torch.arange(4), None, int64())
    with pytest.raises(NotImplementedError,
                       match="requires a string column"):
        match_like(None, col, pattern="%")


# --- the aggregates Q4 and Q13 need ------------------------------------------

def _outer_then(mod, p, b, aggs):
    """A left outer join, its build column ``bv`` null on unmatched probe
    rows, then the aggregate nodes ``aggs`` (mod -> Declarations)."""
    src = mod.Declaration
    join = src("hashjoin", mod.HashJoinNodeOptions(
        "left outer", left_keys=["pk"], right_keys=["bk"],
        right_output=["bv"]), inputs=[
            src("table_source", mod.TableSourceNodeOptions(p)),
            src("table_source", mod.TableSourceNodeOptions(b))])
    return src.from_sequence([join] + aggs(mod))


def test_count_over_outer_join_nulls():
    probe, build, _ = _case_tables("dup_null", np.random.default_rng(60))
    got, want = _run_both(lambda mod, p, b: _outer_then(mod, p, b, lambda m: [
        m.Declaration("aggregate", m.AggregateNodeOptions(
            [("bv", "count", None, "n_bv"), ("pv", "count", None, "n_pv")],
            keys=["pk"]))]), probe, build)
    assert 0 in got["n_bv"]  # unmatched probe keys count no build rows
    assert_tables_match(got, want)


def test_count_all():
    probe, build, _ = _case_tables("dup_null", np.random.default_rng(61))
    got, want = _run_both(lambda mod, p, b: _outer_then(mod, p, b, lambda m: [
        m.Declaration("aggregate", m.AggregateNodeOptions(
            [([], "count_all", None, "rows")], keys=["x"]))]), probe, build)
    assert sum(got["rows"]) > 5000
    assert_tables_match(got, want)


def test_aggregate_over_aggregate():
    """Q13's shape: counts per key, then the keys counted per count."""
    probe, build, _ = _case_tables("dup_null", np.random.default_rng(62))
    got, want = _run_both(lambda mod, p, b: _outer_then(mod, p, b, lambda m: [
        m.Declaration("aggregate", m.AggregateNodeOptions(
            [("bv", "count", None, "c_count")], keys=["pk"])),
        m.Declaration("aggregate", m.AggregateNodeOptions(
            [([], "count_all", None, "custdist")], keys=["c_count"])),
        m.Declaration("order_by", m.OrderByNodeOptions(
            [("custdist", "descending"), ("c_count", "descending")]))]),
        probe, build)
    assert len(got["c_count"]) > 3
    assert_tables_match(got, want)
