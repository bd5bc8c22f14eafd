"""TPC-H tables generated on the host (counterpart of
``arrow_tpu/io/tpch.py``): lineitem, orders and customer.

Each table draws from ``np.random.default_rng(seed)`` in the reference's
order, so every column is bit-identical to the reference generator's, and
is uploaded as a DeviceBatch (``device.column.batch_from_numpy``).
Dictionary columns are int32 codes plus a tuple of the dictionary's
strings. The port has no plain-string columns yet: customer's ``c_name``
and ``c_phone`` are left out of its batch, but ``c_phone``'s random draws
are still made, so the columns after it stay identical to the
reference's. ``device=None`` means the card.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..device.column import DeviceBatch, batch_from_numpy

_EPOCH_1992 = 8035   # days from 1970-01-01 to 1992-01-01
_EPOCH_1998 = 10561  # ... to 1998-12-01

RETURNFLAGS = ("R", "A", "N")
LINESTATUS = ("O", "F")
SHIPMODES = ("REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB")
SHIPINSTRUCT = ("DELIVER IN PERSON", "COLLECT COD", "NONE",
                "TAKE BACK RETURN")
ORDERPRIORITY = ("1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED",
                 "5-LOW")
ORDERSTATUS = ("F", "O", "P")
MKTSEGMENTS = ("AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY",
               "HOUSEHOLD")
# comment word salad; a fraction of orders comments embed the Q13 pattern
# 'special ... requests'
_COMMENT_WORDS = (
    "carefully", "quickly", "furiously", "slyly", "blithely", "ironic",
    "final", "pending", "regular", "express", "bold", "silent", "even",
    "unusual", "packages", "deposits", "foxes", "accounts", "theodolites",
    "instructions", "dependencies", "platelets", "requests", "asymptotes",
)

# (name, type name, values, validity, dictionary): batch_from_numpy's spec
Column = Tuple[str, str, np.ndarray, None, Optional[Tuple[str, ...]]]


def _dict_col(rng, name: str, choices: Sequence[str], n: int) -> Column:
    codes = rng.integers(0, len(choices), n).astype(np.int32)
    return (name, "dictionary", codes, None, tuple(str(c) for c in choices))


def _col(name: str, type_name: str, values) -> Column:
    return (name, type_name, values, None, None)


def _comment_pool(rng, pool_size: int, special: Optional[str] = None,
                  special_frac: float = 0.05) -> List[str]:
    """Pool of word-salad comments; ``special_frac`` of them embed the
    two-word ``special`` pattern with a filler word between (the shape the
    TPC-H LIKE '%a%b%' predicates probe)."""
    pool = []
    for _ in range(pool_size):
        words = list(rng.choice(_COMMENT_WORDS, 6))
        if special is not None and rng.random() < special_frac:
            a, b = special.split()
            words[2:4] = [a, str(rng.choice(_COMMENT_WORDS)), b]
        pool.append(" ".join(words))
    return pool


def lineitem_table(scale_factor: float = 1.0, seed: int = 0,
                   device=None) -> DeviceBatch:
    n = int(6_001_215 * scale_factor)
    rng = np.random.default_rng(seed)
    n_orders = max(int(1_500_000 * scale_factor), 1)
    orderkey = rng.integers(1, n_orders + 1, n)
    shipdate = (_EPOCH_1992
                + rng.integers(0, _EPOCH_1998 - _EPOCH_1992, n))
    quantity = rng.integers(1, 51, n).astype(np.float64)
    extendedprice = np.round(rng.uniform(900.0, 105_000.0, n), 2)
    discount = np.round(rng.integers(0, 11, n) * 0.01, 2)
    tax = np.round(rng.integers(0, 9, n) * 0.01, 2)
    cols = [
        _col("l_orderkey", "int64", orderkey),
        _col("l_partkey", "int64", rng.integers(
            1, max(int(200_000 * scale_factor), 2), n)),
        _col("l_suppkey", "int64", rng.integers(
            1, max(int(10_000 * scale_factor), 2), n)),
        _col("l_linenumber", "int64", rng.integers(1, 8, n)),
        _col("l_quantity", "float64", quantity),
        _col("l_extendedprice", "float64", extendedprice),
        _col("l_discount", "float64", discount),
        _col("l_tax", "float64", tax),
        _dict_col(rng, "l_returnflag", RETURNFLAGS, n),
        _dict_col(rng, "l_linestatus", LINESTATUS, n),
        _col("l_shipdate", "date32", shipdate),
        _col("l_commitdate", "date32", shipdate + rng.integers(-30, 30, n)),
        _col("l_receiptdate", "date32", shipdate + rng.integers(1, 31, n)),
        _dict_col(rng, "l_shipinstruct", SHIPINSTRUCT, n),
        _dict_col(rng, "l_shipmode", SHIPMODES, n),
    ]
    return batch_from_numpy(cols, n, device=device)


def orders_table(scale_factor: float = 1.0, seed: int = 1,
                 device=None) -> DeviceBatch:
    n = max(int(1_500_000 * scale_factor), 1)
    rng = np.random.default_rng(seed)
    n_cust = max(int(150_000 * scale_factor), 2)
    cols = [
        _col("o_orderkey", "int64", np.arange(1, n + 1)),
        _col("o_custkey", "int64", rng.integers(1, n_cust, n)),
        _dict_col(rng, "o_orderstatus", ORDERSTATUS, n),
        _col("o_totalprice", "float64",
             np.round(rng.uniform(850.0, 560_000.0, n), 2)),
        _col("o_orderdate", "date32", _EPOCH_1992 + rng.integers(
            0, _EPOCH_1998 - _EPOCH_1992 - 151, n)),
        _dict_col(rng, "o_orderpriority", ORDERPRIORITY, n),
        _dict_col(rng, "o_clerk", [f"Clerk#{i:09d}" for i in
                                   range(1, max(int(n / 1000), 2))], n),
        _col("o_shippriority", "int64", np.zeros(n, dtype=np.int64)),
        _dict_col(rng, "o_comment", _comment_pool(
            rng, 256, special="special requests"), n),
    ]
    return batch_from_numpy(cols, n, device=device)


def customer_table(scale_factor: float = 1.0, seed: int = 2,
                   device=None) -> DeviceBatch:
    """Customer without ``c_name`` and ``c_phone`` (plain strings)."""
    n = max(int(150_000 * scale_factor), 2)
    rng = np.random.default_rng(seed)
    nationkey = rng.integers(0, 25, n)
    # c_phone's three random parts, drawn as the reference draws them
    for lo, hi in ((100, 1000), (100, 1000), (1000, 10_000)):
        rng.integers(lo, hi, n)
    cols = [
        _col("c_custkey", "int64", np.arange(1, n + 1)),
        _col("c_nationkey", "int64", nationkey),
        _dict_col(rng, "c_mktsegment", MKTSEGMENTS, n),
        _col("c_acctbal", "float64",
             np.round(rng.uniform(-999.99, 9999.99, n), 2)),
        _dict_col(rng, "c_comment", _comment_pool(rng, 256), n),
    ]
    return batch_from_numpy(cols, n, device=device)
