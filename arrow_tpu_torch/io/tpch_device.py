"""TPC-H lineitem generated on the device (counterpart of
``arrow_tpu/io/tpch_device.py``).

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

from typing import Tuple

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
                device: torch.device) -> torch.Tensor:
    key = _as_int64(_mix_scalar(((i + 1) * _GOLDEN + seed) & _U64))
    h = _mix(torch.arange(cap, dtype=torch.int64, device=device) ^ key)
    u = _srl(_srl(h, 32) * (hi - lo), 32) + lo
    if kind == "cents":
        return u.to(torch.float64) * 0.01
    if kind == "float_int":
        return u.to(torch.float64)
    return u.to(dtype)


def q1_device_batch(scale_factor: float, seed: int = 0,
                    device=None) -> Tuple[DeviceBatch, int]:
    """A 15-column lineitem DeviceBatch of ``int(6,001,215 * SF)`` rows made
    on the device. Returns (batch, row count)."""
    dev = default_device(device)
    n = int(6_001_215 * scale_factor)
    cap = round_up(n)
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
    cols = [DeviceColumn(_gen_column(cap, i, kind, lo, hi, dt, seed, dev),
                         None, t, dicts.get(name))
            for i, (name, kind, lo, hi, t, dt) in enumerate(spec)]
    schema = Schema([Field(name, t) for name, _k, _lo, _hi, t, _d in spec])
    return DeviceBatch(schema, cols, torch.tensor(n, dtype=torch.int32,
                                                  device=dev)), n
