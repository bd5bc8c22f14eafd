"""Value dtypes: the reference's device dtype of every type, how the port
stores each in a tensor, and JAX's type promotion lattice.

A value dtype is a numpy dtype name (``"uint32"``), the dtype the
reference's ``jnp`` arrays carry. The port stores every column at its
reference width. bool, int8 to int64, uint8 and the three floats are the
torch dtypes of the same name. **uint16, uint32 and uint64 are stored in
the signed torch dtype of the same width holding their bits** (int16,
int32, int64): torch has few kernels for its own wider unsigned dtypes
(no ``add``, ``lt``, ``index_add_`` or ``sort``), and the compaction
kernel moves bytes by element size either way. Operations that need the
value widen first (``load``): uint16 to int32, uint32 to int64; uint64
stays as its int64 bits, and the operations that differ from signed
int64 (order, division, conversion to float) say so.

``promote`` is the lattice of ``jax.numpy.promote_types`` under x64 (the
reference's setting), with Python ints and floats as weak types: an int8
column plus a Python int stays int8, int32 with uint32 gives int64 and
int64 with uint64 gives float64."""

from __future__ import annotations

from typing import Dict, FrozenSet, Tuple

import numpy as np
import torch

from . import types as T
from .types import DataType, TypeId

INT64_MIN = -(1 << 63)
INT64_MAX = (1 << 63) - 1

NAMES = ("bool", "int8", "int16", "int32", "int64", "uint8", "uint16",
         "uint32", "uint64", "float16", "float32", "float64")

STORAGE: Dict[str, torch.dtype] = {
    "bool": torch.bool, "int8": torch.int8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "uint8": torch.uint8,
    "uint16": torch.int16, "uint32": torch.int32, "uint64": torch.int64,
    "float16": torch.float16, "float32": torch.float32,
    "float64": torch.float64}

# the dtype ``load`` widens to: every value representable, every torch
# kernel present (uint64: its bits)
COMPUTE: Dict[str, torch.dtype] = dict(STORAGE, uint16=torch.int32,
                                       uint32=torch.int64)

_TYPE_DTYPES = {
    TypeId.NA: "int8", TypeId.BOOL: "bool", TypeId.INT8: "int8",
    TypeId.INT16: "int16", TypeId.INT32: "int32", TypeId.INT64: "int64",
    TypeId.UINT8: "uint8", TypeId.UINT16: "uint16", TypeId.UINT32: "uint32",
    TypeId.UINT64: "uint64", TypeId.HALF_FLOAT: "float16",
    TypeId.FLOAT: "float32", TypeId.DOUBLE: "float64",
    TypeId.STRING: "int32", TypeId.DATE32: "int32", TypeId.DATE64: "int64",
    TypeId.TIMESTAMP: "int64", TypeId.TIME32: "int32",
    TypeId.TIME64: "int64", TypeId.DURATION: "int64",
    TypeId.INTERVAL_MONTHS: "int32", TypeId.DECIMAL32: "int64",
    TypeId.DECIMAL64: "int64", TypeId.DECIMAL128: "int64",
    TypeId.DECIMAL256: "int64",
    # code-valued on the device: int32 codes over a host dictionary
    # (strings and binaries), over a value-sorted dictionary (fixed-size
    # binary, decimals wider than 18 digits) or row ids over the host
    # Array (nested types)
    TypeId.BINARY: "int32", TypeId.LARGE_STRING: "int32",
    TypeId.LARGE_BINARY: "int32", TypeId.FIXED_SIZE_BINARY: "int32",
    TypeId.LIST: "int32", TypeId.LARGE_LIST: "int32",
    TypeId.FIXED_SIZE_LIST: "int32", TypeId.STRUCT: "int32",
    TypeId.MAP: "int32"}

_MAKE = {"bool": T.bool_, "int8": T.int8, "int16": T.int16,
         "int32": T.int32, "int64": T.int64, "uint8": T.uint8,
         "uint16": T.uint16, "uint32": T.uint32, "uint64": T.uint64,
         "float16": T.float16, "float32": T.float32, "float64": T.float64}

_FROM_TORCH = {torch.bool: "bool", torch.int8: "int8",
               torch.int16: "int16", torch.int32: "int32",
               torch.int64: "int64", torch.uint8: "uint8",
               torch.float16: "float16", torch.float32: "float32",
               torch.float64: "float64"}


def dtype_of_type(t: DataType) -> str:
    """The value dtype of a logical type (a dictionary's: its codes')."""
    if t.id == TypeId.DICTIONARY:
        return _TYPE_DTYPES[t.index_type.id]
    if t.is_decimal and t.precision > 18:
        return "int32"
    try:
        return _TYPE_DTYPES[t.id]
    except KeyError:
        raise NotImplementedError(
            f"no device representation for {t!r}") from None


def type_of_dtype(name: str) -> DataType:
    """The logical type of a value dtype (the reference's
    ``from_numpy_dtype``)."""
    return _MAKE[name]()


def dtype_of_values(values: torch.Tensor, t=None) -> str:
    """A column's value dtype: its type's where the values are stored as
    that type stores them, else the storage dtype's (the reference keeps
    some results typed by an operand while their values have the
    promoted dtype: a date32 column plus ``np.int64(1)`` is int64 values
    typed date32)."""
    if t is not None:
        name = dtype_of_type(t)
        if STORAGE[name] == values.dtype:
            return name
    return _FROM_TORCH[values.dtype]


def is_float(name: str) -> bool:
    return name.startswith("float")


def is_unsigned(name: str) -> bool:
    return name.startswith("uint")


def is_integer(name: str) -> bool:
    return name.startswith("int") or name.startswith("uint")


def bits(name: str) -> int:
    return 1 if name == "bool" else int(np.dtype(name).itemsize * 8)


def int_range(name: str) -> Tuple[int, int]:
    info = np.iinfo(name)
    return int(info.min), int(info.max)


# --- storage <-> values ---------------------------------------------------

def load(values: torch.Tensor, name: str) -> torch.Tensor:
    """Stored values -> the ``COMPUTE`` dtype (uint16 and uint32 widened,
    zero-extended)."""
    if name == "uint16":
        return values.to(torch.int32) & 0xFFFF
    if name == "uint32":
        return values.to(torch.int64) & 0xFFFFFFFF
    return values


def store(x: torch.Tensor, name: str) -> torch.Tensor:
    """``COMPUTE`` values -> storage (the low bits of the wide ones)."""
    want = STORAGE[name]
    return x if x.dtype == want else x.to(want)


def _u64_to_float(b: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """uint64 bits -> float, correctly rounded: values at and above 2**63
    halve with a sticky low bit, convert, and double."""
    half = ((b >> 1) & INT64_MAX) | (b & 1)
    return torch.where(b < 0, half.to(dt) * 2, b.to(dt))


def _float_to_int(x: torch.Tensor, name: str) -> torch.Tensor:
    """XLA's float -> integer conversion: truncation, saturating at the
    range's ends, NaN to 0."""
    f = torch.trunc(x.to(torch.float64))
    f = torch.where(torch.isnan(f), 0.0, f)
    if name == "uint64":
        return torch.where(
            f >= 2.0 ** 64, -1, torch.where(
                f >= 2.0 ** 63, (f - 2.0 ** 64).clamp(
                    -(2.0 ** 63), 0).to(torch.int64),
                f.clamp(0, 2.0 ** 63 - 1024).to(torch.int64)))
    lo, hi = int_range(name)
    if name == "int64":
        return torch.where(f >= 2.0 ** 63, INT64_MAX, torch.where(
            f < -(2.0 ** 63), INT64_MIN,
            f.clamp(-(2.0 ** 63), 2.0 ** 63 - 1024).to(torch.int64)))
    return f.clamp(lo, hi).to(COMPUTE[name])


def convert(x: torch.Tensor, src: str, dst: str) -> torch.Tensor:
    """``COMPUTE`` values of ``src`` -> ``COMPUTE`` values of ``dst``, as
    ``astype`` does in the reference: integers wrap to the target's
    width, floats round to nearest, floats to integers as
    ``_float_to_int``, anything to bool is ``!= 0``."""
    if src == dst:
        return x
    if dst == "bool":
        return x != 0
    want = COMPUTE[dst]
    if is_float(dst):
        if src == "uint64":
            return _u64_to_float(x, want)
        return x.to(want)
    if is_float(src):
        return _float_to_int(x, dst)
    if dst == "uint16":
        return x.to(torch.int32) & 0xFFFF
    if dst == "uint32":
        return x.to(torch.int64) & 0xFFFFFFFF
    if dst in ("int8", "int16", "int32", "uint8"):
        return x.to(want)  # wraps: the low bits
    return x.to(torch.int64)  # int64 / uint64: sign-extended bits


def as_float64(values: torch.Tensor, name: str) -> torch.Tensor:
    """Stored values as f64 (the reference's ``astype(float64)``)."""
    return convert(load(values, name), name, "float64")


def order_key(x: torch.Tensor, name: str) -> torch.Tensor:
    """``COMPUTE`` values whose signed order is the value order: uint64
    bits with the sign bit flipped, others as they are."""
    return x ^ INT64_MIN if name == "uint64" else x


def u64_floordiv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned 64-bit floor division of int64 bit patterns (``b`` != 0):
    a divisor at or above 2**63 gives 0 or 1; else the dividend halves,
    divides, doubles, and the remainder fixes the last bit."""
    big_b = b < 0
    safe_b = torch.where(big_b, 1, b)
    q = (((a >> 1) & INT64_MAX) // safe_b) << 1
    r = a - q * safe_b
    q = q + (order_key(r, "uint64") >= order_key(safe_b, "uint64")).long()
    ge = order_key(a, "uint64") >= order_key(b, "uint64")
    return torch.where(big_b, ge.long(), q)


# --- promotion ------------------------------------------------------------

WEAK_INT, WEAK_FLOAT = "int*", "float*"

# jax._src.dtypes._type_promotion_lattice ('standard'), without the
# complex, bfloat16 and float8 types the device does not hold
_EDGES = {
    "bool": ("int*",), "int*": ("uint8", "int8"),
    "uint8": ("int16", "uint16"), "uint16": ("int32", "uint32"),
    "uint32": ("int64", "uint64"), "uint64": ("float*",),
    "int8": ("int16",), "int16": ("int32",), "int32": ("int64",),
    "int64": ("float*",), "float*": ("float16",), "float16": ("float32",),
    "float32": ("float64",), "float64": ()}


def _upper(node: str) -> FrozenSet[str]:
    seen, todo = {node}, [node]
    while todo:
        for n in _EDGES[todo.pop()]:
            if n not in seen:
                seen.add(n)
                todo.append(n)
    return frozenset(seen)


_UPPER = {n: _upper(n) for n in _EDGES}


def lub(*kinds: str) -> str:
    """The least upper bound of promotion kinds (a dtype name, or
    ``WEAK_INT``/``WEAK_FLOAT`` for a Python literal) in the lattice."""
    common = frozenset.intersection(*(_UPPER[k] for k in kinds))
    return next(n for n in common if _UPPER[n] >= common)


def promote(*kinds: str) -> str:
    """The value dtype of a result over operands of these kinds: their
    ``lub``, a weak bound materialised as int64 or float64."""
    bound = lub(*kinds)
    return {WEAK_INT: "int64", WEAK_FLOAT: "float64"}.get(bound, bound)


_INEXACT = {"bool": "float32", "int8": "float16", "uint8": "float16",
            "int16": "float32", "uint16": "float32", WEAK_INT: WEAK_FLOAT}


def to_inexact(kind: str) -> str:
    """The float a ``jnp`` function that needs one gives a kind
    (``dtypes.to_inexact_dtype``): bool to f32, 8-bit integers to f16,
    16-bit to f32, wider integers to f64, a weak int to a weak float."""
    if kind in _INEXACT:
        return _INEXACT[kind]
    return kind if is_float(kind) or kind == WEAK_FLOAT else "float64"


def literal_kind(value) -> str:
    """A literal's promotion kind: a Python bool is bool, a Python int or
    float is weak, a numpy scalar has its own dtype."""
    if isinstance(value, np.generic):
        name = np.dtype(type(value)).name
        if name not in NAMES:
            raise NotImplementedError(
                f"no device literal for {type(value).__name__} values")
        return name
    if isinstance(value, bool):
        return "bool"
    if isinstance(value, int):
        if not INT64_MIN <= value <= INT64_MAX:
            raise OverflowError(f"Python int {value} is out of the int64 "
                                "range of a device literal")
        return WEAK_INT
    if isinstance(value, float):
        return WEAK_FLOAT
    raise NotImplementedError(
        f"no device literal for {type(value).__name__} values")


def literal_dtype(value) -> str:
    """The value dtype a literal takes alone (a weak int is int64)."""
    return promote(literal_kind(value))


def literal(value, name: str, device) -> torch.Tensor:
    """A literal as a 0-d ``COMPUTE`` tensor of dtype ``name``, converted
    as the reference converts it (a weak int wraps to the width)."""
    kind = literal_kind(value)
    src = promote(kind)
    if src == "uint64":
        x = torch.tensor(int(np.asarray(value).view(np.int64)),
                         dtype=torch.int64, device=device)
    else:
        x = torch.tensor(np.asarray(value).item(), dtype=COMPUTE[src],
                         device=device)
    return convert(x, src, name)
