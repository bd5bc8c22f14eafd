"""TPC-H tables generated on the host (counterpart of
``arrow_tpu/io/tpch.py``): all eight tables.

Each table draws from ``np.random.default_rng(seed)`` in the reference's
order, so every column is bit-identical to the reference generator's, and
is uploaded as a DeviceBatch (``device.column.batch_from_numpy``), or made
a host ``Table`` (``*_host_table``, ``generate_host``; ``host_and_device``
makes both of one generation).
Dictionary columns are int32 codes plus a tuple of the dictionary's
strings. The port keeps every string column as codes: a plain-string
column of the reference (``c_name``, ``c_phone``, ``p_name``,
``s_name``, ``s_address``, ``s_phone``, ``n_name``, ``r_name``) is
encoded here in order of first appearance, as the reference's upload
encodes it (``_encode``), so its type, codes and dictionary match the
reference's device batch. ``c_name`` and ``c_phone`` hold about 1.5M
distinct values at SF10 and ``p_name`` about 2M, so the fixed-width
strings are built as byte matrices (``_fixed``) and encoded by one
``np.unique`` over them, with no loop over the rows in Python but
``p_name``'s joins of its five words. ``device=None`` means the card.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import types as T
from ..array.array import Array, array as make_array
from ..array.data import ArrayData
from ..buffer import Buffer
from ..device.column import (DeviceBatch, _gather_bytes, _host_values,
                             batch_from_numpy)
from ..table import Table

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
PART_TYPES = tuple(f"{a} {b} {c}" for a in
                   ("STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY",
                    "PROMO")
                   for b in ("ANODIZED", "BURNISHED", "PLATED", "POLISHED",
                             "BRUSHED")
                   for c in ("TIN", "NICKEL", "BRASS", "STEEL", "COPPER"))
NATIONS = ("ALGERIA", "ARGENTINA", "BRAZIL", "CANADA", "EGYPT", "ETHIOPIA",
           "FRANCE", "GERMANY", "INDIA", "INDONESIA", "IRAN", "IRAQ",
           "JAPAN", "JORDAN", "KENYA", "MOROCCO", "MOZAMBIQUE", "PERU",
           "CHINA", "ROMANIA", "SAUDI ARABIA", "VIETNAM", "RUSSIA",
           "UNITED KINGDOM", "UNITED STATES")
REGIONS = ("AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST")
NATION_REGION = (0, 1, 1, 1, 4, 0, 3, 3, 2, 2, 4, 4, 2, 4, 0, 0, 0, 1, 2,
                 3, 4, 2, 3, 3, 1)
MANUFACTURERS = tuple(f"Manufacturer#{i}" for i in range(1, 6))
BRANDS = tuple(f"Brand#{b}" for b in range(11, 56))
CONTAINERS = tuple(f"{a} {b}" for a in ("SM", "LG", "MED", "JUMBO", "WRAP")
                   for b in ("CASE", "BOX", "BAG", "JAR", "PKG", "PACK",
                             "CAN", "DRUM"))
# the reference's p_name word pool (dbgen's colours; Q20 filters
# p_name LIKE 'forest%')
P_NAME_WORDS = (
    "almond", "antique", "aquamarine", "azure", "beige", "bisque", "black",
    "blanched", "blue", "blush", "brown", "burlywood", "burnished",
    "chartreuse", "chiffon", "chocolate", "coral", "cornflower", "cornsilk",
    "cream", "cyan", "dark", "deep", "dim", "dodger", "drab", "firebrick",
    "floral", "forest", "frosted", "gainsboro", "ghost", "goldenrod",
    "green", "grey", "honeydew", "hot", "hrose", "indian", "ivory",
)
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


def _encode(name: str, strings: np.ndarray) -> Column:
    """A plain-string column dictionary-encoded in order of first
    appearance, as the reference's upload encodes it
    (``arrow_tpu/device/column.py``, ``_dictionary_encode_host``): type
    string, int32 codes and the dictionary. ``strings`` is a numpy array
    of str or of ASCII bytes."""
    uniq, first, inverse = np.unique(strings, return_index=True,
                                     return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty(len(order), dtype=np.int32)
    rank[order] = np.arange(len(order), dtype=np.int32)
    values = uniq[order]
    if values.dtype.kind == "S":
        values = values.astype(str)
    return (name, "string", rank[inverse.reshape(-1)], None,
            tuple(values.tolist()))


def _digits(values: np.ndarray, width: int) -> np.ndarray:
    """(n, width) ASCII digits of non-negative integers below
    10**width, zero-padded as ``%0<width>d`` gives them."""
    values = np.asarray(values, dtype=np.int64)
    if len(values) and (values.min() < 0 or values.max() >= 10 ** width):
        raise ValueError(f"values do not fit {width} digits")
    powers = 10 ** np.arange(width - 1, -1, -1, dtype=np.int64)
    return (values[:, None] // powers % 10 + ord("0")).astype(np.uint8)


def _fixed(n: int, parts) -> np.ndarray:
    """Fixed-width ASCII strings, one a row, as an ``S`` array: each part
    is a (n, w) byte matrix or a str that every row holds."""
    mats = [np.broadcast_to(np.frombuffer(p.encode("ascii"), np.uint8),
                            (n, len(p))) if isinstance(p, str) else p
            for p in parts]
    mat = np.ascontiguousarray(np.concatenate(mats, axis=1))
    return mat.view(f"S{mat.shape[1]}").reshape(n)


def _keyed_names(prefix: str, keys: np.ndarray) -> np.ndarray:
    """The reference's ``<prefix>#%09d`` names (``_name_col``)."""
    return _fixed(len(keys), [prefix + "#", _digits(keys, 9)])


def _phone(rng, nationkey: np.ndarray) -> np.ndarray:
    """The reference's phone strings ``NN-DDD-DDD-DDDD`` (``NN`` the
    nation key + 10), drawn in its order."""
    n = len(nationkey)
    parts = [_digits(nationkey + 10, 2)]
    for width, lo, hi in ((3, 100, 1000), (3, 100, 1000), (4, 1000, 10_000)):
        parts += ["-", _digits(rng.integers(lo, hi, n), width)]
    return _fixed(n, parts)


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


def _lineitem_columns(scale_factor: float = 1.0, seed: int = 0):
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
    return cols, n


def _orders_columns(scale_factor: float = 1.0, seed: int = 1):
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
    return cols, n


def _customer_columns(scale_factor: float = 1.0, seed: int = 2):
    n = max(int(150_000 * scale_factor), 2)
    rng = np.random.default_rng(seed)
    nationkey = rng.integers(0, 25, n)
    keys = np.arange(1, n + 1)
    cols = [
        _col("c_custkey", "int64", keys),
        _encode("c_name", _keyed_names("Customer", keys)),
        _col("c_nationkey", "int64", nationkey),
        _encode("c_phone", _phone(rng, nationkey)),
        _dict_col(rng, "c_mktsegment", MKTSEGMENTS, n),
        _col("c_acctbal", "float64",
             np.round(rng.uniform(-999.99, 9999.99, n), 2)),
        _dict_col(rng, "c_comment", _comment_pool(rng, 256), n),
    ]
    return cols, n


def _part_columns(scale_factor: float = 1.0, seed: int = 3):
    """``p_brand`` follows ``p_mfgr``'s codes and comes last, as in the
    reference."""
    n = max(int(200_000 * scale_factor), 2)
    rng = np.random.default_rng(seed)
    # the reference's first mfgr and brand draws (unused)
    rng.integers(1, 6, n)
    rng.integers(1, 6, n)
    # p_name: five words of the pool drawn one after another, joined by
    # spaces
    words = np.array(P_NAME_WORDS, dtype=object)
    picks = [words[rng.integers(0, len(words), n)] for _ in range(5)]
    name = np.array(list(map(" ".join, zip(*picks))), dtype="S")
    mfgr = _dict_col(rng, "p_mfgr", MANUFACTURERS, n)
    cols = [
        _col("p_partkey", "int64", np.arange(1, n + 1)),
        _encode("p_name", name),
        mfgr,
        _dict_col(rng, "p_type", PART_TYPES, n),
        _col("p_size", "int64", rng.integers(1, 51, n)),
        _dict_col(rng, "p_container", CONTAINERS, n),
        _col("p_retailprice", "float64",
             np.round(rng.uniform(900.0, 2000.0, n), 2)),
    ]
    brand = (mfgr[2] + 1) * 10 + rng.integers(1, 6, n)
    cols.append(("p_brand", "dictionary", (brand - 11).astype(np.int32),
                 None, BRANDS))
    return cols, n


def _supplier_columns(scale_factor: float = 1.0, seed: int = 4):
    n = max(int(10_000 * scale_factor), 2)
    rng = np.random.default_rng(seed)
    nationkey = rng.integers(0, 25, n)
    keys = np.arange(1, n + 1)
    cols = [
        _col("s_suppkey", "int64", keys),
        _encode("s_name", _keyed_names("Supplier", keys)),
        _encode("s_address", np.char.mod("addr-%x",
                                         rng.integers(0, 1 << 40, n))),
        _col("s_nationkey", "int64", nationkey),
        _encode("s_phone", _phone(rng, nationkey)),
        _col("s_acctbal", "float64",
             np.round(rng.uniform(-999.99, 9999.99, n), 2)),
        _dict_col(rng, "s_comment", _comment_pool(
            rng, 256, special="Customer Complaints"), n),
    ]
    return cols, n


def _partsupp_columns(scale_factor: float = 1.0, seed: int = 5):
    n = max(int(800_000 * scale_factor), 2)
    rng = np.random.default_rng(seed)
    cols = [
        _col("ps_partkey", "int64", rng.integers(
            1, max(int(200_000 * scale_factor), 2), n)),
        _col("ps_suppkey", "int64", rng.integers(
            1, max(int(10_000 * scale_factor), 2), n)),
        _col("ps_supplycost", "float64",
             np.round(rng.uniform(1.0, 1000.0, n), 2)),
        _col("ps_availqty", "int64", rng.integers(1, 10_000, n)),
    ]
    return cols, n


def _nation_columns():
    return [
        _col("n_nationkey", "int64", np.arange(25)),
        _encode("n_name", np.array(NATIONS)),
        _col("n_regionkey", "int64", np.array(NATION_REGION)),
    ], 25


def _region_columns():
    return [
        _col("r_regionkey", "int64", np.arange(5)),
        _encode("r_name", np.array(REGIONS)),
    ], 5


def nation_table(device=None) -> DeviceBatch:
    return batch_from_numpy(*_nation_columns(), device=device)


def region_table(device=None) -> DeviceBatch:
    return batch_from_numpy(*_region_columns(), device=device)


def nation_host_table() -> Table:
    return host_table(*_nation_columns())


def region_host_table() -> Table:
    return host_table(*_region_columns())


TABLES = ("lineitem", "orders", "customer", "part", "supplier", "partsupp",
          "nation", "region")


def _columns(name: str, scale_factor: float):
    if name in ("nation", "region"):
        return globals()[f"_{name}_columns"]()
    return globals()[f"_{name}_columns"](scale_factor)


def generate(scale_factor: float = 1.0, device=None) -> Dict[str, DeviceBatch]:
    """All eight TPC-H tables by name."""
    return {name: batch_from_numpy(*_columns(name, scale_factor),
                                   device=device) for name in TABLES}


def generate_host(scale_factor: float = 1.0) -> Dict[str, Table]:
    """All eight TPC-H tables by name, as host Tables: the counterparts of
    the reference's ``*_table`` makers."""
    return {name: host_table(*_columns(name, scale_factor))
            for name in TABLES}


def host_and_device(name: str, scale_factor: float = 1.0, device=None
                    ) -> Tuple[Table, DeviceBatch]:
    """One table generated once, as a host Table and as the DeviceBatch
    its maker (``<name>_table``) gives: the host numpy arrays serve
    both."""
    cols, n = _columns(name, scale_factor)
    return host_table(cols, n), batch_from_numpy(cols, n, device=device)


def host_table(columns: Sequence[Column], n: int) -> Table:
    """A host Table of ``batch_from_numpy`` column specs: a ``dictionary``
    spec as a dictionary array (its codes over its strings), a ``string``
    spec as a string array (its codes decoded: the strings the encoder
    was given), any other as its values. ``upload_table`` of it gives the
    batch ``batch_from_numpy`` makes of the same specs, bit for bit."""
    arrays, names = [], []
    for name, type_name, values, _, dictionary in columns:
        t = T.type_for_name(type_name)
        if type_name == "dictionary":
            arr = Array(ArrayData(t, n, [None, Buffer(
                np.asarray(values, dtype=np.int32))], null_count=0,
                dictionary=make_array(list(dictionary), T.string()).data))
        elif type_name == "string":
            codes = np.asarray(values, dtype=np.int64)
            dd = make_array(list(dictionary), T.string()).data
            doffs = dd.offsets().astype(np.int64)
            offs, data = _gather_bytes(dd.data_bytes(), doffs[codes],
                                       doffs[codes + 1] - doffs[codes])
            arr = Array(ArrayData(t, n, [None, Buffer(offs.astype(np.int32)),
                                         Buffer(data)], null_count=0))
        else:
            store = _host_values(t, values)
            arr = Array(ArrayData(t, n, [None, Buffer(
                store.view(t.to_numpy_dtype()))], null_count=0))
        arrays.append(arr)
        names.append(name)
    return Table.from_arrays(arrays, names)


def lineitem_table(scale_factor: float = 1.0, seed: int = 0,
               device=None) -> DeviceBatch:
    return batch_from_numpy(*_lineitem_columns(scale_factor, seed),
                            device=device)


def lineitem_host_table(scale_factor: float = 1.0, seed: int = 0) -> Table:
    return host_table(*_lineitem_columns(scale_factor, seed))


def orders_table(scale_factor: float = 1.0, seed: int = 1,
               device=None) -> DeviceBatch:
    return batch_from_numpy(*_orders_columns(scale_factor, seed),
                            device=device)


def orders_host_table(scale_factor: float = 1.0, seed: int = 1) -> Table:
    return host_table(*_orders_columns(scale_factor, seed))


def customer_table(scale_factor: float = 1.0, seed: int = 2,
               device=None) -> DeviceBatch:
    return batch_from_numpy(*_customer_columns(scale_factor, seed),
                            device=device)


def customer_host_table(scale_factor: float = 1.0, seed: int = 2) -> Table:
    return host_table(*_customer_columns(scale_factor, seed))


def part_table(scale_factor: float = 1.0, seed: int = 3,
               device=None) -> DeviceBatch:
    return batch_from_numpy(*_part_columns(scale_factor, seed),
                            device=device)


def part_host_table(scale_factor: float = 1.0, seed: int = 3) -> Table:
    return host_table(*_part_columns(scale_factor, seed))


def supplier_table(scale_factor: float = 1.0, seed: int = 4,
               device=None) -> DeviceBatch:
    return batch_from_numpy(*_supplier_columns(scale_factor, seed),
                            device=device)


def supplier_host_table(scale_factor: float = 1.0, seed: int = 4) -> Table:
    return host_table(*_supplier_columns(scale_factor, seed))


def partsupp_table(scale_factor: float = 1.0, seed: int = 5,
               device=None) -> DeviceBatch:
    return batch_from_numpy(*_partsupp_columns(scale_factor, seed),
                            device=device)


def partsupp_host_table(scale_factor: float = 1.0, seed: int = 5) -> Table:
    return host_table(*_partsupp_columns(scale_factor, seed))
