"""TPC-H Q1, Q3, Q4 and Q13 as plans (counterpart of
``arrow_tpu/io/tpch_queries.py`` and of the Q1 chain that
``__graft_entry__.py`` runs). Q1's eight aggregates are the reference
benchmark's (acero/tpch_benchmark.cc:39, Plan_Q1)."""

from __future__ import annotations

import datetime
from typing import List, Optional

from ..acero import (AggregateNodeOptions, Declaration, Expression,
                     FetchNodeOptions, FilterNodeOptions,
                     HashJoinNodeOptions, OrderByNodeOptions,
                     ProjectNodeOptions, TableSourceNodeOptions, field)
from ..device.column import DeviceBatch

DATE_1998_09_02 = (datetime.date(1998, 9, 2)
                   - datetime.date(1970, 1, 1)).days
DATE_1995_03_15 = (datetime.date(1995, 3, 15)
                   - datetime.date(1970, 1, 1)).days
DATE_1993_07_01 = (datetime.date(1993, 7, 1)
                   - datetime.date(1970, 1, 1)).days


def q1_chain_decls() -> List[Declaration]:
    """filter -> project -> aggregate -> order_by, for ``compile_chain``."""
    disc_price = field("l_extendedprice") * (1.0 - field("l_discount"))
    charge = disc_price * (1.0 + field("l_tax"))
    return [
        Declaration("filter", FilterNodeOptions(
            field("l_shipdate") <= DATE_1998_09_02)),
        Declaration("project", ProjectNodeOptions(
            [field("l_returnflag"), field("l_linestatus"),
             field("l_quantity"), field("l_extendedprice"),
             disc_price, charge, field("l_discount")],
            ["l_returnflag", "l_linestatus", "l_quantity",
             "l_extendedprice", "disc_price", "charge", "l_discount"])),
        Declaration("aggregate", AggregateNodeOptions(
            [("l_quantity", "sum", None, "sum_qty"),
             ("l_extendedprice", "sum", None, "sum_base_price"),
             ("disc_price", "sum", None, "sum_disc_price"),
             ("charge", "sum", None, "sum_charge"),
             ("l_quantity", "mean", None, "avg_qty"),
             ("l_extendedprice", "mean", None, "avg_price"),
             ("l_discount", "mean", None, "avg_disc"),
             ("l_quantity", "count", None, "count_order")],
            keys=["l_returnflag", "l_linestatus"])),
        Declaration("order_by", OrderByNodeOptions(
            [("l_returnflag", "ascending"), ("l_linestatus", "ascending")])),
    ]


def q1_plan(lineitem: DeviceBatch) -> Declaration:
    return Declaration.from_sequence(
        [Declaration("table_source", TableSourceNodeOptions(lineitem))]
        + q1_chain_decls())


def _filtered(batch: DeviceBatch, predicate) -> Declaration:
    return Declaration.from_sequence([
        _source(batch), Declaration("filter", FilterNodeOptions(predicate))])


def q3_plan(customer: DeviceBatch, orders: DeviceBatch,
            lineitem: DeviceBatch, limit: int = 10) -> Declaration:
    """Shipping priority: three filters, orders join customer, lineitem
    join that, revenue by (order, date, priority), the top ``limit``."""
    co = Declaration("hashjoin", HashJoinNodeOptions(
        "inner", left_keys=["o_custkey"], right_keys=["c_custkey"],
        right_output=[]), inputs=[
            _filtered(orders, field("o_orderdate") < DATE_1995_03_15),
            _filtered(customer, field("c_mktsegment") == "BUILDING")])
    col = Declaration("hashjoin", HashJoinNodeOptions(
        "inner", left_keys=["l_orderkey"], right_keys=["o_orderkey"],
        right_output=["o_orderdate", "o_shippriority"]), inputs=[
            _filtered(lineitem, field("l_shipdate") > DATE_1995_03_15), co])
    return Declaration.from_sequence([
        col,
        Declaration("project", ProjectNodeOptions(
            [field("l_orderkey"),
             field("l_extendedprice") * (1.0 - field("l_discount")),
             field("o_orderdate"), field("o_shippriority")],
            ["l_orderkey", "volume", "o_orderdate", "o_shippriority"])),
        Declaration("aggregate", AggregateNodeOptions(
            [("volume", "sum", None, "revenue")],
            keys=["l_orderkey", "o_orderdate", "o_shippriority"])),
        Declaration("order_by", OrderByNodeOptions(
            [("revenue", "descending"), ("o_orderdate", "ascending")])),
        Declaration("fetch", FetchNodeOptions(0, limit)),
    ])


def _source(batch: DeviceBatch) -> Declaration:
    return Declaration("table_source", TableSourceNodeOptions(batch))


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
        Declaration("aggregate", AggregateNodeOptions(
            [([], "count_all", None, "order_count")],
            keys=["o_orderpriority"])),
        Declaration("order_by", OrderByNodeOptions(
            [("o_orderpriority", "ascending")])),
    ])


def q13_plan(customer: DeviceBatch, orders: DeviceBatch,
             word1: str = "special", word2: str = "requests"
             ) -> Declaration:
    """Customer distribution: customers left outer join their orders
    whose comment is not like ``%word1%word2%``, orders counted per
    customer, then customers counted per order count."""
    ords = _filtered(orders, Expression.call("invert", Expression.call(
        "match_like", field("o_comment"), pattern=f"%{word1}%{word2}%")))
    return Declaration.from_sequence([
        Declaration("hashjoin", HashJoinNodeOptions(
            "left outer", left_keys=["c_custkey"], right_keys=["o_custkey"],
            right_output=["o_orderkey"]), inputs=[_source(customer), ords]),
        Declaration("aggregate", AggregateNodeOptions(
            [("o_orderkey", "count", None, "c_count")], keys=["c_custkey"])),
        Declaration("aggregate", AggregateNodeOptions(
            [([], "count_all", None, "custdist")], keys=["c_count"])),
        Declaration("order_by", OrderByNodeOptions(
            [("custdist", "descending"), ("c_count", "descending")])),
    ])
