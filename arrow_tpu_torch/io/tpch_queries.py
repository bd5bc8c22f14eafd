"""TPC-H plans (counterpart of ``arrow_tpu/io/tpch_queries.py`` and of the
Q1 chain that ``__graft_entry__.py`` runs): Q1, Q3, Q4, Q5, Q6, Q9-style,
Q10-style, Q12-style, Q13, Q14 and Q19, each over DeviceBatches in the
reference's plan shape. Q1's eight aggregates are the reference
benchmark's (acero/tpch_benchmark.cc:39, Plan_Q1)."""

from __future__ import annotations

import datetime
from typing import List, Optional

from ..acero import (AggregateNodeOptions, Declaration, Expression,
                     FetchNodeOptions, FilterNodeOptions,
                     HashJoinNodeOptions, OrderByNodeOptions,
                     ProjectNodeOptions, TableSourceNodeOptions, field)
from ..device.column import DeviceBatch


def _days(y, m, d) -> int:
    return (datetime.date(y, m, d) - datetime.date(1970, 1, 1)).days


DATE_1998_09_02 = _days(1998, 9, 2)
DATE_1995_03_15 = _days(1995, 3, 15)
DATE_1993_07_01 = _days(1993, 7, 1)
DATE_1994_01_01 = _days(1994, 1, 1)
DATE_1995_01_01 = _days(1995, 1, 1)
DATE_1995_09_01 = _days(1995, 9, 1)

_LIT = Expression.literal
_CALL = Expression.call


def _src(batch: DeviceBatch) -> Declaration:
    return Declaration("table_source", TableSourceNodeOptions(batch))


def _filter(expr) -> Declaration:
    return Declaration("filter", FilterNodeOptions(expr))


def _filtered(batch: DeviceBatch, predicate) -> Declaration:
    return Declaration.from_sequence([_src(batch), _filter(predicate)])


def _proj(exprs, names) -> Declaration:
    return Declaration("project", ProjectNodeOptions(exprs, names))


def _agg(aggs, keys=()) -> Declaration:
    return Declaration("aggregate", AggregateNodeOptions(aggs, keys=keys))


def _join(jt, lk, rk, right_output=None, inputs=None) -> Declaration:
    return Declaration("hashjoin", HashJoinNodeOptions(
        jt, left_keys=lk, right_keys=rk, right_output=right_output),
        inputs=inputs)


def _order(keys) -> Declaration:
    return Declaration("order_by", OrderByNodeOptions(keys))


def _fetch(limit, offset=0) -> Declaration:
    return Declaration("fetch", FetchNodeOptions(offset, limit))


def _volume() -> Expression:
    return field("l_extendedprice") * (1.0 - field("l_discount"))


def q1_chain_decls() -> List[Declaration]:
    """filter -> project -> aggregate -> order_by, for ``compile_chain``."""
    disc_price = _volume()
    charge = disc_price * (1.0 + field("l_tax"))
    return [
        _filter(field("l_shipdate") <= DATE_1998_09_02),
        _proj([field("l_returnflag"), field("l_linestatus"),
               field("l_quantity"), field("l_extendedprice"),
               disc_price, charge, field("l_discount")],
              ["l_returnflag", "l_linestatus", "l_quantity",
               "l_extendedprice", "disc_price", "charge", "l_discount"]),
        _agg([("l_quantity", "sum", None, "sum_qty"),
              ("l_extendedprice", "sum", None, "sum_base_price"),
              ("disc_price", "sum", None, "sum_disc_price"),
              ("charge", "sum", None, "sum_charge"),
              ("l_quantity", "mean", None, "avg_qty"),
              ("l_extendedprice", "mean", None, "avg_price"),
              ("l_discount", "mean", None, "avg_disc"),
              ("l_quantity", "count", None, "count_order")],
             keys=["l_returnflag", "l_linestatus"]),
        _order([("l_returnflag", "ascending"), ("l_linestatus", "ascending")]),
    ]


def q1_plan(lineitem: DeviceBatch) -> Declaration:
    return Declaration.from_sequence([_src(lineitem)] + q1_chain_decls())


def q3_plan(customer: DeviceBatch, orders: DeviceBatch,
            lineitem: DeviceBatch, limit: int = 10) -> Declaration:
    """Shipping priority: three filters, orders join customer, lineitem
    join that, revenue by (order, date, priority), the top ``limit``."""
    co = _join("inner", ["o_custkey"], ["c_custkey"], [], [
        _filtered(orders, field("o_orderdate") < DATE_1995_03_15),
        _filtered(customer, field("c_mktsegment") == "BUILDING")])
    col = _join("inner", ["l_orderkey"], ["o_orderkey"],
                ["o_orderdate", "o_shippriority"], [
                    _filtered(lineitem, field("l_shipdate") > DATE_1995_03_15),
                    co])
    return Declaration.from_sequence([
        col,
        _proj([field("l_orderkey"), _volume(), field("o_orderdate"),
               field("o_shippriority")],
              ["l_orderkey", "volume", "o_orderdate", "o_shippriority"]),
        _agg([("volume", "sum", None, "revenue")],
             keys=["l_orderkey", "o_orderdate", "o_shippriority"]),
        _order([("revenue", "descending"), ("o_orderdate", "ascending")]),
        _fetch(limit),
    ])


def q4_plan(orders: DeviceBatch, lineitem: DeviceBatch,
            date_lo: Optional[int] = None) -> Declaration:
    """Order-priority checking: the orders of one quarter that have a
    lineitem received after its commit date (a left semi join), counted
    by priority."""
    lo = DATE_1993_07_01 if date_lo is None else date_lo
    late = _filtered(lineitem, field("l_commitdate") < field("l_receiptdate"))
    ords = _filtered(orders, (field("o_orderdate") >= lo)
                     & (field("o_orderdate") < lo + 92))
    return Declaration.from_sequence([
        Declaration("hashjoin", HashJoinNodeOptions(
            "left semi", left_keys=["o_orderkey"],
            right_keys=["l_orderkey"]), inputs=[ords, late]),
        _agg([([], "count_all", None, "order_count")],
             keys=["o_orderpriority"]),
        _order([("o_orderpriority", "ascending")]),
    ])


def q13_plan(customer: DeviceBatch, orders: DeviceBatch,
             word1: str = "special", word2: str = "requests"
             ) -> Declaration:
    """Customer distribution: customers left outer join their orders
    whose comment is not like ``%word1%word2%``, orders counted per
    customer, then customers counted per order count."""
    ords = _filtered(orders, _CALL("invert", _CALL(
        "match_like", field("o_comment"), pattern=f"%{word1}%{word2}%")))
    return Declaration.from_sequence([
        _join("left outer", ["c_custkey"], ["o_custkey"], ["o_orderkey"],
              [_src(customer), ords]),
        _agg([("o_orderkey", "count", None, "c_count")], keys=["c_custkey"]),
        _agg([([], "count_all", None, "custdist")], keys=["c_count"]),
        _order([("custdist", "descending"), ("c_count", "descending")]),
    ])


def q9_style_plan(part: DeviceBatch, supplier: DeviceBatch,
                  lineitem: DeviceBatch, partsupp: DeviceBatch,
                  orders: DeviceBatch, nation: DeviceBatch) -> Declaration:
    """Multi-way join and a high-cardinality aggregate (BASELINE config 4):
    lineitem joins BRASS parts, partsupp on two keys, supplier, nation and
    orders; profit by nation and order year (``o_orderdate / 365``, a
    date32 column as in the reference)."""
    pt = _filtered(part, _CALL("match_substring", field("p_type"),
                               pattern="BRASS"))
    j1 = _join("inner", ["l_partkey"], ["p_partkey"], [],
               [_src(lineitem), pt])
    j2 = _join("inner", ["l_partkey", "l_suppkey"],
               ["ps_partkey", "ps_suppkey"], ["ps_supplycost"],
               [j1, _src(partsupp)])
    j3 = _join("inner", ["l_suppkey"], ["s_suppkey"], ["s_nationkey"],
               [j2, _src(supplier)])
    j4 = _join("inner", ["s_nationkey"], ["n_nationkey"], ["n_name"],
               [j3, _src(nation)])
    j5 = _join("inner", ["l_orderkey"], ["o_orderkey"], ["o_orderdate"],
               [j4, _src(orders)])
    return Declaration.from_sequence([
        j5,
        _proj([field("n_name"), _CALL("divide", field("o_orderdate"), 365),
               _volume() - field("ps_supplycost") * field("l_quantity")],
              ["nation", "o_year", "amount"]),
        _agg([("amount", "sum", None, "sum_profit")],
             keys=["nation", "o_year"]),
        _order([("nation", "ascending"), ("o_year", "descending")]),
    ])


def q6_plan(lineitem: DeviceBatch) -> Declaration:
    """Forecasting revenue change: a five-way conjunction folded into a
    scalar sum as a row mask."""
    cond = ((field("l_shipdate") >= DATE_1994_01_01)
            & (field("l_shipdate") < DATE_1995_01_01)
            & (field("l_discount") >= 0.05)
            & (field("l_discount") <= 0.07)
            & (field("l_quantity") < 24.0))
    return Declaration.from_sequence([
        _src(lineitem), _filter(cond),
        _proj([field("l_extendedprice") * field("l_discount")], ["revenue"]),
        _agg([("revenue", "sum", None, "revenue")], keys=[]),
    ])


def q10_style_plan(customer: DeviceBatch, orders: DeviceBatch,
                   lineitem: DeviceBatch, limit: int = 20) -> Declaration:
    """Returned-item reporting: two joins, revenue by customer, top-k."""
    ords = _filtered(orders, (field("o_orderdate") >= DATE_1994_01_01)
                     & (field("o_orderdate") < DATE_1994_01_01 + 92))
    li = _filtered(lineitem, field("l_returnflag") == "R")
    lo = _join("inner", ["l_orderkey"], ["o_orderkey"], ["o_custkey"],
               [li, ords])
    loc = _join("inner", ["o_custkey"], ["c_custkey"],
                ["c_custkey", "c_mktsegment"], [lo, _src(customer)])
    return Declaration.from_sequence([
        loc,
        _proj([field("c_custkey"), field("c_mktsegment"), _volume()],
              ["c_custkey", "c_mktsegment", "volume"]),
        _agg([("volume", "sum", None, "revenue")],
             keys=["c_custkey", "c_mktsegment"]),
        _order([("revenue", "descending"), ("c_custkey", "ascending")]),
        _fetch(limit),
    ])


def q12_style_plan(orders: DeviceBatch, lineitem: DeviceBatch
                   ) -> Declaration:
    """Shipping modes: one join, then high- and low-priority line counts
    per ship mode (``if_else`` of int literals, summed)."""
    li = _filtered(lineitem, (field("l_receiptdate") >= DATE_1994_01_01)
                   & (field("l_receiptdate") < DATE_1995_01_01)
                   & ((field("l_shipmode") == "MAIL")
                      | (field("l_shipmode") == "SHIP")))
    lo = _join("inner", ["l_orderkey"], ["o_orderkey"], ["o_orderpriority"],
               [li, _src(orders)])
    is_urgent = ((field("o_orderpriority") == "1-URGENT")
                 | (field("o_orderpriority") == "2-HIGH"))
    return Declaration.from_sequence([
        lo,
        _proj([field("l_shipmode"),
               _CALL("if_else", is_urgent, _LIT(1), _LIT(0)),
               _CALL("if_else", is_urgent, _LIT(0), _LIT(1))],
              ["l_shipmode", "high_line", "low_line"]),
        _agg([("high_line", "sum", None, "high_line_count"),
              ("low_line", "sum", None, "low_line_count")],
             keys=["l_shipmode"]),
        _order([("l_shipmode", "ascending")]),
    ])


def q5_plan(customer: DeviceBatch, orders: DeviceBatch,
            lineitem: DeviceBatch, supplier: DeviceBatch,
            nation: DeviceBatch, region: DeviceBatch,
            region_name: str = "ASIA") -> Declaration:
    """Local supplier volume: customer, orders, lineitem, supplier (on
    ``l_suppkey`` and ``c_nationkey = s_nationkey``) and the nations of one
    region, revenue per nation in one year of orders."""
    nat = _join("inner", ["n_regionkey"], ["r_regionkey"], [], [
        _src(nation), _filtered(region, field("r_name") == region_name)])
    ords = _filtered(orders, (field("o_orderdate") >= DATE_1994_01_01)
                     & (field("o_orderdate") < DATE_1995_01_01))
    oc = _join("inner", ["o_custkey"], ["c_custkey"], ["c_nationkey"],
               [ords, _src(customer)])
    lo = _join("inner", ["l_orderkey"], ["o_orderkey"], ["c_nationkey"],
               [_src(lineitem), oc])
    ls = _join("inner", ["l_suppkey", "c_nationkey"],
               ["s_suppkey", "s_nationkey"], ["s_nationkey"],
               [lo, _src(supplier)])
    ln = _join("inner", ["s_nationkey"], ["n_nationkey"], ["n_name"],
               [ls, nat])
    return Declaration.from_sequence([
        ln,
        _proj([field("n_name"), _volume()], ["n_name", "volume"]),
        _agg([("volume", "sum", None, "revenue")], keys=["n_name"]),
        _order([("revenue", "descending")]),
    ])


def q14_plan(lineitem: DeviceBatch, part: DeviceBatch,
             date_lo: Optional[int] = None) -> Declaration:
    """Promotion effect: 100 x the revenue of PROMO parts over all revenue
    in one month; two scalar sums, then their ratio (null when the month
    has no rows)."""
    lo = DATE_1995_09_01 if date_lo is None else date_lo
    li = _filtered(lineitem, (field("l_shipdate") >= lo)
                   & (field("l_shipdate") < lo + 30))
    return Declaration.from_sequence([
        _join("inner", ["l_partkey"], ["p_partkey"], ["p_type"],
              [li, _src(part)]),
        _proj([_CALL("if_else", _CALL("starts_with", field("p_type"),
                                      pattern="PROMO"),
                     _volume(), _LIT(0.0)), _volume()],
              ["promo", "volume"]),
        _agg([("promo", "sum", None, "promo"),
              ("volume", "sum", None, "total")], keys=[]),
        _proj([field("promo") * 100.0 / field("total")], ["promo_revenue"]),
    ])


def q19_plan(lineitem: DeviceBatch, part: DeviceBatch) -> Declaration:
    """Discounted revenue: lineitem joins part, then a disjunction of
    three brand/container/quantity/size envelopes folded into a scalar
    sum."""
    li = _filtered(lineitem, _CALL("is_in", field("l_shipmode"),
                                   value_set=["AIR", "REG AIR"])
                   & (field("l_shipinstruct") == "DELIVER IN PERSON"))
    j = _join("inner", ["l_partkey"], ["p_partkey"],
              ["p_brand", "p_container", "p_size"], [li, _src(part)])

    def envelope(brand, size, containers, qty_lo, size_hi):
        return ((field("p_brand") == brand)
                & _CALL("is_in", field("p_container"),
                        value_set=[f"{size} {c}" for c in containers])
                & (field("l_quantity") >= qty_lo)
                & (field("l_quantity") <= qty_lo + 10.0)
                & (field("p_size") >= 1) & (field("p_size") <= size_hi))

    b1 = envelope("Brand#12", "SM", ("CASE", "BOX", "PACK", "PKG"), 1.0, 5)
    b2 = envelope("Brand#23", "MED", ("BAG", "BOX", "PKG", "PACK"), 10.0, 10)
    b3 = envelope("Brand#34", "LG", ("CASE", "BOX", "PACK", "PKG"), 20.0, 15)
    return Declaration.from_sequence([
        j, _filter(b1 | b2 | b3),
        _proj([_volume()], ["volume"]),
        _agg([("volume", "sum", None, "revenue")], keys=[]),
    ])
