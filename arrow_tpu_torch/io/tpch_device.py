"""TPC-H tables generated on the device (counterpart of
``arrow_tpu/io/tpch_device.py``): Q1's lineitem, and Q3's customer,
orders and lineitem narrowed to the columns Q3 reads.

Each column is a splitmix64 hash of the row index, mapped onto the column's
range by a multiply-shift, so the data are made where they are used and
never cross from the host. The columns are bit-identical to the reference
generator's, padding rows included.

torch has no unsigned 64-bit shifts, so the hash runs in int64:
multiplication and xor wrap exactly as in uint64, a logical right shift is
an arithmetic shift with the high bits masked off, and the constants above
2**63 are written as their two's-complement int64 values.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import default_device
from .. import types as T
from ..device.column import DeviceBatch, DeviceColumn, round_up
from ..types import Field, Schema

_EPOCH_1992 = 8035   # days from 1970-01-01 to 1992-01-01
_EPOCH_1998 = 10561  # ... to 1998-12-01

RETURNFLAGS = ("R", "A", "N")
LINESTATUS = ("O", "F")
SHIPMODES = ("REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB")
SHIPINSTRUCT = ("DELIVER IN PERSON", "COLLECT COD", "NONE",
                "TAKE BACK RETURN")
MKTSEGMENTS = ("AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY",
               "HOUSEHOLD")

_U64 = (1 << 64) - 1


def _as_int64(u: int) -> int:
    """The int64 with the bits of the uint64 ``u``."""
    u &= _U64
    return u - (1 << 64) if u >> 63 else u


_GOLDEN = 0x9E3779B97F4A7C15
_MIX1 = 0xBF58476D1CE4E5B9
_MIX2 = 0x94D049BB133111EB
_MIX1_I64 = _as_int64(_MIX1)
_MIX2_I64 = _as_int64(_MIX2)


def _srl(h: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bits."""
    return (h >> k) & ((1 << (64 - k)) - 1)


def _mix(h: torch.Tensor) -> torch.Tensor:
    h = (h ^ _srl(h, 30)) * _MIX1_I64
    h = (h ^ _srl(h, 27)) * _MIX2_I64
    return h ^ _srl(h, 31)


def _mix_scalar(u: int) -> int:
    u = ((u ^ (u >> 30)) * _MIX1) & _U64
    u = ((u ^ (u >> 27)) * _MIX2) & _U64
    return u ^ (u >> 31)


def _gen_column(cap: int, i: int, kind: str, lo: int, hi: int,
                dtype: torch.dtype, seed: int,
                device: torch.device, start: int = 0) -> torch.Tensor:
    """Rows ``[start, start + cap)`` of generated column ``i``."""
    key = _as_int64(_mix_scalar(((i + 1) * _GOLDEN + seed) & _U64))
    h = _mix(torch.arange(start, start + cap, dtype=torch.int64,
                          device=device) ^ key)
    u = _srl(_srl(h, 32) * (hi - lo), 32) + lo
    if kind == "cents":
        return u.to(torch.float64) * 0.01
    if kind == "float_int":
        return u.to(torch.float64)
    return u.to(dtype)


def q1_device_batch(scale_factor: float, seed: int = 0, device=None,
                    rows: Optional[Tuple[int, int]] = None
                    ) -> Tuple[DeviceBatch, int]:
    """A 15-column lineitem DeviceBatch of ``int(6,001,215 * SF)`` rows made
    on the device; ``rows=(start, stop)`` makes only those rows (a rank's
    shard), bit for bit the whole table's. Returns (batch, the whole
    table's row count)."""
    dev = default_device(device)
    n = int(6_001_215 * scale_factor)
    sf = scale_factor
    n_orders = max(int(1_500_000 * sf), 2)

    dicts = {"l_returnflag": RETURNFLAGS, "l_linestatus": LINESTATUS,
             "l_shipinstruct": SHIPINSTRUCT, "l_shipmode": SHIPMODES}
    dict_t = T.dictionary(T.int32(), T.string())
    spec = [
        # (name, kind, lo, hi, type, device dtype)
        ("l_orderkey", "int", 1, n_orders + 1, T.int64(), torch.int64),
        ("l_partkey", "int", 1, max(int(200_000 * sf), 2), T.int64(),
         torch.int64),
        ("l_suppkey", "int", 1, max(int(10_000 * sf), 2), T.int64(),
         torch.int64),
        ("l_linenumber", "int", 1, 8, T.int64(), torch.int64),
        ("l_quantity", "float_int", 1, 51, T.float64(), torch.float64),
        ("l_extendedprice", "cents", 90_000, 10_500_000, T.float64(),
         torch.float64),
        ("l_discount", "cents", 0, 11, T.float64(), torch.float64),
        ("l_tax", "cents", 0, 9, T.float64(), torch.float64),
        ("l_returnflag", "dict", 0, len(RETURNFLAGS), dict_t, torch.int32),
        ("l_linestatus", "dict", 0, len(LINESTATUS), dict_t, torch.int32),
        ("l_shipdate", "int", _EPOCH_1992, _EPOCH_1998, T.date32(),
         torch.int32),
        ("l_commitdate", "int", _EPOCH_1992 - 30, _EPOCH_1998 + 30,
         T.date32(), torch.int32),
        ("l_receiptdate", "int", _EPOCH_1992 + 1, _EPOCH_1998 + 31,
         T.date32(), torch.int32),
        ("l_shipinstruct", "dict", 0, len(SHIPINSTRUCT), dict_t,
         torch.int32),
        ("l_shipmode", "dict", 0, len(SHIPMODES), dict_t, torch.int32),
    ]
    return _device_batch(spec, n, dicts, seed, dev, rows)


def _device_batch(spec, n: int, dicts, seed: int, device: torch.device,
                  rows: Optional[Tuple[int, int]] = None
                  ) -> Tuple[DeviceBatch, int]:
    """A DeviceBatch of n rows from a column spec: (name, kind, lo, hi,
    type, device dtype) a column, where kind ``iota`` gives the keys
    1..capacity (o_orderkey, c_custkey), ``zeros`` zeros, and any other
    kind a generated column; only rows ``[start, stop)`` where ``rows`` is
    given. Returns (batch, n)."""
    start, stop = rows if rows is not None else (0, n)
    if not 0 <= start <= stop <= n:
        raise ValueError(f"rows {rows} outside the table's {n}")
    cap = round_up(stop - start)
    cols = []
    for i, (name, kind, lo, hi, t, dt) in enumerate(spec):
        if kind == "iota":
            v = torch.arange(start, start + cap, dtype=torch.int64,
                             device=device) + 1
        elif kind == "zeros":
            v = torch.zeros(cap, dtype=dt, device=device)
        else:
            v = _gen_column(cap, i, kind, lo, hi, dt, seed, device, start)
        cols.append(DeviceColumn(v, None, t, dicts.get(name)))
    schema = Schema([Field(name, t) for name, _k, _lo, _hi, t, _d in spec])
    return DeviceBatch(schema, cols, torch.tensor(stop - start,
                                                  dtype=torch.int32,
                                                  device=device)), n


def q3_device_plan(scale_factor: float, seed: int = 0, limit: int = 10,
                   device=None):
    """TPC-H Q3 over three tables made on the device, narrowed to the
    columns Q3 reads: customer (c_custkey, c_mktsegment), orders
    (o_orderkey, o_custkey, o_orderdate, o_shippriority) and lineitem
    (l_orderkey, l_extendedprice, l_discount, l_shipdate), with the
    reference generator's seeds (seed + 11, + 23, + 37). Returns
    (plan, lineitem rows)."""
    from .tpch_queries import q3_plan

    t = q3_device_tables(scale_factor, seed, device)
    return q3_plan(t["customer"][0], t["orders"][0], t["lineitem"][0],
                   limit), t["lineitem"][1]


def q3_device_tables(scale_factor: float, seed: int = 0, device=None,
                     shard: Optional[Tuple[int, int]] = None):
    """``q3_device_plan``'s three tables by name, each (batch, the whole
    table's rows); ``shard=(rank, size)`` makes only each table's
    contiguous ``ceil(n / size)`` rows of that rank, bit for bit the
    whole table's."""
    dev = default_device(device)
    sf = scale_factor
    n_li = int(6_001_215 * sf)
    n_ord = max(int(1_500_000 * sf), 2)
    n_cust = max(int(150_000 * sf), 2)
    dict_t = T.dictionary(T.int32(), T.string())

    def rows(n):
        return None if shard is None else shard_rows(n, *shard)

    return {
        "customer": _device_batch([
            ("c_custkey", "iota", 0, 0, T.int64(), torch.int64),
            ("c_mktsegment", "int", 0, len(MKTSEGMENTS), dict_t,
             torch.int32),
        ], n_cust, {"c_mktsegment": MKTSEGMENTS}, seed + 11, dev,
            rows(n_cust)),
        "orders": _device_batch([
            ("o_orderkey", "iota", 0, 0, T.int64(), torch.int64),
            ("o_custkey", "int", 1, n_cust, T.int64(), torch.int64),
            ("o_orderdate", "int", _EPOCH_1992, _EPOCH_1998 - 151,
             T.date32(), torch.int32),
            ("o_shippriority", "zeros", 0, 0, T.int64(), torch.int64),
        ], n_ord, {}, seed + 23, dev, rows(n_ord)),
        "lineitem": _device_batch([
            ("l_orderkey", "int", 1, n_ord + 1, T.int64(), torch.int64),
            ("l_extendedprice", "cents", 90_000, 10_500_000, T.float64(),
             torch.float64),
            ("l_discount", "cents", 0, 11, T.float64(), torch.float64),
            ("l_shipdate", "int", _EPOCH_1992, _EPOCH_1998, T.date32(),
             torch.int32),
        ], n_li, {}, seed + 37, dev, rows(n_li)),
    }


def shard_rows(n: int, rank: int, size: int) -> Tuple[int, int]:
    """(start, stop) of rank's contiguous ``ceil(n / size)`` rows of n, as
    the distributed layer splits a whole batch."""
    per = -(-n // size) if n else 0
    start = min(rank * per, n)
    return start, min(start + per, n)
