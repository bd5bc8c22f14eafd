"""TPC-H plans (counterpart of ``arrow_tpu/io/tpch_queries.py`` and of the
Q1 chain that ``__graft_entry__.py`` runs): all 22 of the reference's
plans (Q9, Q10 and Q12 in their ``_style`` forms), each over DeviceBatches
in the reference's plan shape, with its defaults and argument order. Q1's
eight aggregates are the reference benchmark's (acero/tpch_benchmark.cc:39,
Plan_Q1). Q11, Q15 and Q22 bridge a scalar subquery to its rows by an
inner join on a projected constant key (``_with_unit_key``)."""

from __future__ import annotations

import datetime
from typing import List, Optional

import numpy as np

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


def _with_unit_key(decl: Declaration, cols, names) -> Declaration:
    """``decl``'s columns ``cols`` as ``names``, and a constant int64 join
    key ``__k1`` (the scalar-subquery bridge)."""
    return Declaration.from_sequence([
        decl, _proj([field(c) if isinstance(c, str) else c for c in cols]
                    + [_LIT(np.int64(1))], list(names) + ["__k1"])])


def q2_plan(part: DeviceBatch, supplier: DeviceBatch, partsupp: DeviceBatch,
            nation: DeviceBatch, region: DeviceBatch, size: int = 15,
            type_suffix: str = "BRASS", region_name: str = "EUROPE",
            limit: int = 100) -> Declaration:
    """Minimum-cost supplier: the least ``ps_supplycost`` per part among
    one region's suppliers, joined back on (part, cost)."""
    sup = _join("inner", ["s_nationkey"], ["n_nationkey"],
                ["n_name", "n_regionkey"],
                [_src(supplier),
                 _join("inner", ["n_regionkey"], ["r_regionkey"], [],
                       [_src(nation),
                        _filtered(region, field("r_name") == region_name)])])
    supplier_cols = ["s_name", "s_address", "s_phone", "s_acctbal",
                     "s_comment", "n_name"]
    eu_ps = _join("inner", ["ps_suppkey"], ["s_suppkey"], supplier_cols,
                  [_src(partsupp), sup])
    minc = Declaration.from_sequence([
        eu_ps,
        _agg([("ps_supplycost", "min", None, "min_cost")],
             keys=["ps_partkey"])])
    pt = _filtered(part, (field("p_size") == size)
                   & _CALL("ends_with", field("p_type"), pattern=type_suffix))
    pm = _join("inner", ["p_partkey"], ["ps_partkey"], ["min_cost"],
               [pt, minc])
    res = _join("inner", ["p_partkey", "min_cost"],
                ["ps_partkey", "ps_supplycost"], supplier_cols, [pm, eu_ps])
    out = ["s_acctbal", "s_name", "n_name", "p_partkey", "p_mfgr",
           "s_address", "s_phone", "s_comment"]
    return Declaration.from_sequence([
        res,
        _proj([field(c) for c in out], out),
        _order([("s_acctbal", "descending"), ("n_name", "ascending"),
                ("s_name", "ascending"), ("p_partkey", "ascending")]),
        _fetch(limit)])


def q7_plan(supplier: DeviceBatch, lineitem: DeviceBatch,
            orders: DeviceBatch, customer: DeviceBatch, nation: DeviceBatch,
            nation1: str = "FRANCE", nation2: str = "GERMANY"
            ) -> Declaration:
    """Volume shipping between two nations, by supplier nation, customer
    nation and ship year."""
    def renamed(key, name):
        return Declaration.from_sequence([
            _src(nation),
            _proj([field("n_nationkey"), field("n_name")], [key, name])])

    sup = _join("inner", ["s_nationkey"], ["n1_key"], ["supp_nation"],
                [_src(supplier), renamed("n1_key", "supp_nation")])
    cus = _join("inner", ["c_nationkey"], ["n2_key"], ["cust_nation"],
                [_src(customer), renamed("n2_key", "cust_nation")])
    li = _filtered(lineitem, (field("l_shipdate") >= _days(1995, 1, 1))
                   & (field("l_shipdate") <= _days(1996, 12, 31)))
    j1 = _join("inner", ["l_orderkey"], ["o_orderkey"], ["o_custkey"],
               [li, _src(orders)])
    j2 = _join("inner", ["o_custkey"], ["c_custkey"], ["cust_nation"],
               [j1, cus])
    j3 = _join("inner", ["l_suppkey"], ["s_suppkey"], ["supp_nation"],
               [j2, sup])
    pair_ok = (((field("supp_nation") == nation1)
                & (field("cust_nation") == nation2))
               | ((field("supp_nation") == nation2)
                  & (field("cust_nation") == nation1)))
    return Declaration.from_sequence([
        j3, _filter(pair_ok),
        _proj([field("supp_nation"), field("cust_nation"),
               _CALL("year", field("l_shipdate")), _volume()],
              ["supp_nation", "cust_nation", "l_year", "volume"]),
        _agg([("volume", "sum", None, "revenue")],
             keys=["supp_nation", "cust_nation", "l_year"]),
        _order([("supp_nation", "ascending"), ("cust_nation", "ascending"),
                ("l_year", "ascending")])])


def q8_plan(part: DeviceBatch, supplier: DeviceBatch, lineitem: DeviceBatch,
            orders: DeviceBatch, customer: DeviceBatch, nation: DeviceBatch,
            region: DeviceBatch, p_type: str = "ECONOMY ANODIZED STEEL",
            nation_name: str = "BRAZIL", region_name: str = "AMERICA"
            ) -> Declaration:
    """National market share within a region, by order year: six joins
    (one a left semi join to the region's nations), then the ratio of two
    grouped sums."""
    pt = _filtered(part, field("p_type") == p_type)
    rg = _filtered(region, field("r_name") == region_name)
    cust_nat = _join("inner", ["n_regionkey"], ["r_regionkey"], [],
                     [_src(nation), rg])
    supp_nat = Declaration.from_sequence([
        _src(nation),
        _proj([field("n_nationkey"), field("n_name")],
              ["sn_key", "supp_nation"])])
    ords = _filtered(orders, (field("o_orderdate") >= _days(1995, 1, 1))
                     & (field("o_orderdate") <= _days(1996, 12, 31)))
    j1 = _join("inner", ["l_partkey"], ["p_partkey"], [],
               [_src(lineitem), pt])
    j2 = _join("inner", ["l_orderkey"], ["o_orderkey"],
               ["o_custkey", "o_orderdate"], [j1, ords])
    j3 = _join("inner", ["o_custkey"], ["c_custkey"], ["c_nationkey"],
               [j2, _src(customer)])
    j4 = _join("left semi", ["c_nationkey"], ["n_nationkey"], None,
               [j3, cust_nat])
    j5 = _join("inner", ["l_suppkey"], ["s_suppkey"], ["s_nationkey"],
               [j4, _src(supplier)])
    j6 = _join("inner", ["s_nationkey"], ["sn_key"], ["supp_nation"],
               [j5, supp_nat])
    vol = _volume()
    return Declaration.from_sequence([
        j6,
        _proj([_CALL("year", field("o_orderdate")), vol,
               _CALL("if_else", field("supp_nation") == nation_name,
                     vol, _LIT(0.0))],
              ["o_year", "volume", "nation_volume"]),
        _agg([("nation_volume", "sum", None, "nation_vol"),
              ("volume", "sum", None, "total_vol")], keys=["o_year"]),
        _proj([field("o_year"), field("nation_vol") / field("total_vol")],
              ["o_year", "mkt_share"]),
        _order([("o_year", "ascending")])])


def q11_plan(partsupp: DeviceBatch, supplier: DeviceBatch,
             nation: DeviceBatch, nation_name: str = "GERMANY",
             fraction: float = 0.0001) -> Declaration:
    """Important stock: each part's stock value over one nation's
    suppliers, kept above ``fraction`` of the total (a ``keys=[]``
    aggregate joined back on the constant key)."""
    nat = _filtered(nation, field("n_name") == nation_name)
    sup = _join("left semi", ["s_nationkey"], ["n_nationkey"], None,
                [_src(supplier), nat])
    ps = Declaration.from_sequence([
        _join("left semi", ["ps_suppkey"], ["s_suppkey"], None,
              [_src(partsupp), sup]),
        _proj([field("ps_partkey"),
               field("ps_supplycost") * _CALL(
                   "cast", field("ps_availqty"), target_type="float64")],
              ["ps_partkey", "value"])])
    per_part = _with_unit_key(Declaration.from_sequence([
        ps, _agg([("value", "sum", None, "value")], keys=["ps_partkey"])]),
        ["ps_partkey", "value"], ["ps_partkey", "value"])
    total = _with_unit_key(Declaration.from_sequence([
        ps, _agg([("value", "sum", None, "total")], keys=[])]),
        ["total"], ["total"])
    return Declaration.from_sequence([
        _join("inner", ["__k1"], ["__k1"], ["total"], [per_part, total]),
        _filter(field("value") > field("total") * fraction),
        _proj([field("ps_partkey"), field("value")],
              ["ps_partkey", "value"]),
        _order([("value", "descending"), ("ps_partkey", "ascending")])])


def q15_plan(lineitem: DeviceBatch, supplier: DeviceBatch,
             date_lo: Optional[int] = None) -> Declaration:
    """Top supplier: revenue per supplier over one quarter, the rows equal
    to its scalar max (joined back on the constant key), then supplier
    details."""
    lo = _days(1996, 1, 1) if date_lo is None else date_lo
    rev = Declaration.from_sequence([
        _src(lineitem),
        _filter((field("l_shipdate") >= lo)
                & (field("l_shipdate") < lo + 90)),
        _proj([field("l_suppkey"), _volume()], ["supplier_no", "volume"]),
        _agg([("volume", "sum", None, "total_revenue")],
             keys=["supplier_no"])])
    rev_k = _with_unit_key(rev, ["supplier_no", "total_revenue"],
                           ["supplier_no", "total_revenue"])
    mx = _with_unit_key(Declaration.from_sequence([
        rev, _agg([("total_revenue", "max", None, "max_revenue")],
                  keys=[])]), ["max_revenue"], ["max_revenue"])
    top = Declaration.from_sequence([
        _join("inner", ["__k1"], ["__k1"], ["max_revenue"], [rev_k, mx]),
        _filter(field("total_revenue") == field("max_revenue"))])
    return Declaration.from_sequence([
        _join("inner", ["supplier_no"], ["s_suppkey"],
              ["s_name", "s_address", "s_phone"], [top, _src(supplier)]),
        _proj([field(c) for c in ["supplier_no", "s_name", "s_address",
                                  "s_phone", "total_revenue"]],
              ["s_suppkey", "s_name", "s_address", "s_phone",
               "total_revenue"]),
        _order([("s_suppkey", "ascending")])])


def q16_plan(partsupp: DeviceBatch, part: DeviceBatch, supplier: DeviceBatch,
             brand: str = "Brand#45", type_prefix: str = "MEDIUM POLISHED",
             sizes=(49, 14, 23, 45, 19, 3, 36, 9)) -> Declaration:
    """Parts/supplier relationship: distinct suppliers per (brand, type,
    size), suppliers with complaints left out by a left anti join."""
    pt = _filtered(part, (field("p_brand") != brand)
                   & _CALL("invert", _CALL("starts_with", field("p_type"),
                                           pattern=type_prefix))
                   & _CALL("is_in", field("p_size"), value_set=list(sizes)))
    bad_sup = _filtered(supplier, _CALL("match_like", field("s_comment"),
                                        pattern="%Customer%Complaints%"))
    ps = _join("left anti", ["ps_suppkey"], ["s_suppkey"], None,
               [_src(partsupp), bad_sup])
    return Declaration.from_sequence([
        _join("inner", ["ps_partkey"], ["p_partkey"],
              ["p_brand", "p_type", "p_size"], [ps, pt]),
        _agg([("ps_suppkey", "count_distinct", None, "supplier_cnt")],
             keys=["p_brand", "p_type", "p_size"]),
        _order([("supplier_cnt", "descending"), ("p_brand", "ascending"),
                ("p_type", "ascending"), ("p_size", "ascending")])])


def q17_plan(lineitem: DeviceBatch, part: DeviceBatch,
             brand: str = "Brand#23", container: str = "MED BOX"
             ) -> Declaration:
    """Small-quantity-order revenue: the correlated average quantity as a
    grouped mean by part over all of lineitem, joined back per part."""
    pt = _filtered(part, (field("p_brand") == brand)
                   & (field("p_container") == container))
    li_p = _join("inner", ["l_partkey"], ["p_partkey"], [],
                 [_src(lineitem), pt])
    avg_q = Declaration.from_sequence([
        _src(lineitem),
        _agg([("l_quantity", "mean", None, "avg_qty")], keys=["l_partkey"]),
        _proj([field("l_partkey"), field("avg_qty")],
              ["ap_partkey", "avg_qty"])])
    return Declaration.from_sequence([
        _join("inner", ["l_partkey"], ["ap_partkey"], ["avg_qty"],
              [li_p, avg_q]),
        _filter(field("l_quantity") < field("avg_qty") * 0.2),
        _agg([("l_extendedprice", "sum", None, "total")], keys=[]),
        _proj([field("total") / 7.0], ["avg_yearly"])])


def q18_plan(customer: DeviceBatch, orders: DeviceBatch,
             lineitem: DeviceBatch, quantity: float = 300.0,
             limit: int = 100) -> Declaration:
    """Large-volume customers: orders whose lines sum to more than
    ``quantity`` units (a filter over a grouped sum), with their customer,
    the top ``limit`` by price, date and key."""
    big = Declaration.from_sequence([
        _src(lineitem),
        _agg([("l_quantity", "sum", None, "sum_qty")], keys=["l_orderkey"]),
        _filter(field("sum_qty") > quantity)])
    jo = _join("inner", ["l_orderkey"], ["o_orderkey"],
               ["o_custkey", "o_orderdate", "o_totalprice"],
               [big, _src(orders)])
    jc = _join("inner", ["o_custkey"], ["c_custkey"], ["c_name"],
               [jo, _src(customer)])
    return Declaration.from_sequence([
        jc,
        _proj([field(c) for c in
               ["c_name", "o_custkey", "l_orderkey", "o_orderdate",
                "o_totalprice", "sum_qty"]],
              ["c_name", "c_custkey", "o_orderkey", "o_orderdate",
               "o_totalprice", "sum_qty"]),
        _order([("o_totalprice", "descending"),
                ("o_orderdate", "ascending"),
                ("o_orderkey", "ascending")]),
        _fetch(limit)])


def q20_plan(supplier: DeviceBatch, nation: DeviceBatch,
             partsupp: DeviceBatch, part: DeviceBatch, lineitem: DeviceBatch,
             name_prefix: str = "forest", nation_name: str = "CANADA",
             date_lo: Optional[int] = None) -> Declaration:
    """Potential part promotion: one nation's suppliers with stock of a
    ``name_prefix`` part above half of the year's shipped quantity."""
    lo = _days(1994, 1, 1) if date_lo is None else date_lo
    shipped = Declaration.from_sequence([
        _src(lineitem),
        _filter((field("l_shipdate") >= lo)
                & (field("l_shipdate") < lo + 365)),
        _agg([("l_quantity", "sum", None, "sum_qty")],
             keys=["l_partkey", "l_suppkey"]),
        _proj([field("l_partkey"), field("l_suppkey"), field("sum_qty")],
              ["lp_partkey", "lp_suppkey", "sum_qty"])])
    forest_part = _filtered(part, _CALL("starts_with", field("p_name"),
                                        pattern=name_prefix))
    ps = _join("inner", ["ps_partkey", "ps_suppkey"],
               ["lp_partkey", "lp_suppkey"], ["sum_qty"],
               [_join("left semi", ["ps_partkey"], ["p_partkey"], None,
                      [_src(partsupp), forest_part]), shipped])
    qualifying = Declaration.from_sequence([
        ps,
        _filter(_CALL("cast", field("ps_availqty"), target_type="float64")
                > field("sum_qty") * 0.5)])
    nat = _filtered(nation, field("n_name") == nation_name)
    sup = _join("left semi", ["s_nationkey"], ["n_nationkey"], None,
                [_src(supplier), nat])
    return Declaration.from_sequence([
        _join("left semi", ["s_suppkey"], ["ps_suppkey"], None,
              [sup, qualifying]),
        _proj([field("s_name"), field("s_address")], ["s_name", "s_address"]),
        _order([("s_name", "ascending")])])


def q21_plan(supplier: DeviceBatch, lineitem: DeviceBatch,
             orders: DeviceBatch, nation: DeviceBatch,
             nation_name: str = "SAUDI ARABIA", limit: int = 100
             ) -> Declaration:
    """Suppliers who kept orders waiting: the EXISTS / NOT EXISTS pair as
    distinct suppliers per order (two ``count_distinct``s), late lines of
    finished multi-supplier orders where only one supplier was late."""
    stats = Declaration.from_sequence([
        _src(lineitem),
        _agg([("l_suppkey", "count_distinct", None, "nsupp")],
             keys=["l_orderkey"]),
        _proj([field("l_orderkey"), field("nsupp")],
              ["so_orderkey", "nsupp"])])
    late = _filtered(lineitem, field("l_receiptdate") > field("l_commitdate"))
    late_stats = Declaration.from_sequence([
        late,
        _agg([("l_suppkey", "count_distinct", None, "nlate")],
             keys=["l_orderkey"]),
        _proj([field("l_orderkey"), field("nlate")],
              ["lo_orderkey", "nlate"])])
    f_orders = _filtered(orders, field("o_orderstatus") == "F")
    nat = _filtered(nation, field("n_name") == nation_name)
    sup = _join("left semi", ["s_nationkey"], ["n_nationkey"], None,
                [_src(supplier), nat])
    l1 = _join("left semi", ["l_orderkey"], ["o_orderkey"], None,
               [late, f_orders])
    l1 = _join("inner", ["l_suppkey"], ["s_suppkey"], ["s_name"], [l1, sup])
    l1 = _join("inner", ["l_orderkey"], ["so_orderkey"], ["nsupp"],
               [l1, stats])
    l1 = _join("inner", ["l_orderkey"], ["lo_orderkey"], ["nlate"],
               [l1, late_stats])
    return Declaration.from_sequence([
        l1,
        _filter((field("nsupp") > 1) & (field("nlate") == 1)),
        _agg([([], "count_all", None, "numwait")], keys=["s_name"]),
        _order([("numwait", "descending"), ("s_name", "ascending")]),
        _fetch(limit)])


def q21_residual_plan(supplier: DeviceBatch, lineitem: DeviceBatch,
                      orders: DeviceBatch, nation: DeviceBatch,
                      nation_name: str = "SAUDI ARABIA", limit: int = 100
                      ) -> Declaration:
    """Q21 as TPC-H spells it: the EXISTS a left semi join and the NOT
    EXISTS a left anti join (against the late lines) on ``l_orderkey``,
    each with the residual filter that the other line's supplier differs.
    The build sides are projected to renamed columns first, so the pair's
    names do not collide. The same answer as ``q21_plan``."""
    late = _filtered(lineitem, field("l_receiptdate") > field("l_commitdate"))
    f_orders = _filtered(orders, field("o_orderstatus") == "F")
    nat = _filtered(nation, field("n_name") == nation_name)
    sup = _join("left semi", ["s_nationkey"], ["n_nationkey"], None,
                [_src(supplier), nat])
    l1 = _join("left semi", ["l_orderkey"], ["o_orderkey"], None,
               [late, f_orders])
    l1 = _join("inner", ["l_suppkey"], ["s_suppkey"], ["s_name"], [l1, sup])
    for jt, lines, prefix in (("left semi", _src(lineitem), "l2"),
                              ("left anti", late, "l3")):
        other = Declaration.from_sequence([lines, _proj(
            [field("l_orderkey"), field("l_suppkey")],
            [f"{prefix}_orderkey", f"{prefix}_suppkey"])])
        l1 = Declaration("hashjoin", HashJoinNodeOptions(
            jt, left_keys=["l_orderkey"], right_keys=[f"{prefix}_orderkey"],
            filter=field("l_suppkey") != field(f"{prefix}_suppkey")),
            inputs=[l1, other])
    return Declaration.from_sequence([
        l1,
        _agg([([], "count_all", None, "numwait")], keys=["s_name"]),
        _order([("numwait", "descending"), ("s_name", "ascending")]),
        _fetch(limit)])


def q22_plan(customer: DeviceBatch, orders: DeviceBatch,
             codes=("13", "31", "23", "29", "30", "18", "17")
             ) -> Declaration:
    """Global sales opportunity: customers of some country codes (the
    first two characters of ``c_phone``, a derived dictionary) richer than
    their average and without orders, counted and summed by code."""
    cust = Declaration.from_sequence([
        _src(customer),
        _proj([_CALL("utf8_slice_codeunits", field("c_phone"), start=0,
                     stop=2), field("c_custkey"), field("c_acctbal")],
              ["cntrycode", "c_custkey", "c_acctbal"]),
        _filter(_CALL("is_in", field("cntrycode"), value_set=list(codes)))])
    avg_bal = _with_unit_key(Declaration.from_sequence([
        cust,
        _filter(field("c_acctbal") > 0.0),
        _agg([("c_acctbal", "mean", None, "avg_bal")], keys=[])]),
        ["avg_bal"], ["avg_bal"])
    cust_k = _with_unit_key(cust, ["cntrycode", "c_custkey", "c_acctbal"],
                            ["cntrycode", "c_custkey", "c_acctbal"])
    rich = Declaration.from_sequence([
        _join("inner", ["__k1"], ["__k1"], ["avg_bal"], [cust_k, avg_bal]),
        _filter(field("c_acctbal") > field("avg_bal"))])
    no_orders = _join("left anti", ["c_custkey"], ["o_custkey"], None,
                      [rich, _src(orders)])
    return Declaration.from_sequence([
        no_orders,
        _agg([([], "count_all", None, "numcust"),
              ("c_acctbal", "sum", None, "totacctbal")],
             keys=["cntrycode"]),
        _order([("cntrycode", "ascending")])])
