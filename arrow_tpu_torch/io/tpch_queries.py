"""TPC-H Q1 as a plan (counterpart of ``arrow_tpu/io/tpch_queries.py`` and of
the Q1 chain that ``__graft_entry__.py`` runs). The eight aggregates are
the reference benchmark's (acero/tpch_benchmark.cc:39, Plan_Q1)."""

from __future__ import annotations

import datetime
from typing import List

from ..acero import (AggregateNodeOptions, Declaration, FilterNodeOptions,
                     OrderByNodeOptions, ProjectNodeOptions,
                     TableSourceNodeOptions, field)
from ..device.column import DeviceBatch

DATE_1998_09_02 = (datetime.date(1998, 9, 2)
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
