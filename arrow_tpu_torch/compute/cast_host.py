"""The host-tier cast matrix: nested, dictionary, decimal, binary and null
casts (counterpart of ``arrow_tpu/compute/cast_host.py``; reference:
compute/kernels/scalar_cast_nested.cc, scalar_cast_dictionary.cc, the
binary paths of scalar_cast_string.cc and the cast.cc dispatcher).

The device ``cast`` (``elementwise.py``) keeps the numeric, bool and
temporal paths; a cast between layouts of variable length or with
children runs here on host Arrays, value by value, as the reference's
does. An extension type casts through its storage type, as the
reference's does (extension_type.h:39: the two share a layout). A string
or binary column casts to its view layout in numpy, which the reference
cannot (its ``cast`` has no view target).

Entry: ``try_cast_host(args, options) -> Array | None`` (None: not a case
of the host matrix, the call goes on to the device cast).
"""

from __future__ import annotations

import decimal as _dec
from typing import Any, Optional

from ..array.array import Array, array as make_array
from ..array.construct import binary_view_data
from ..table import ChunkedArray
from ..types import DataType, TypeId
from .registry import ArrowInvalid

_STRINGS = (TypeId.STRING, TypeId.LARGE_STRING)
_BINARIES = (TypeId.BINARY, TypeId.LARGE_BINARY)
_LISTS = (TypeId.LIST, TypeId.LARGE_LIST, TypeId.FIXED_SIZE_LIST)
_DECIMALS = (TypeId.DECIMAL128, TypeId.DECIMAL256, TypeId.DECIMAL32,
             TypeId.DECIMAL64)

_INT_RANGE = {
    TypeId.INT8: (-2**7, 2**7 - 1), TypeId.INT16: (-2**15, 2**15 - 1),
    TypeId.INT32: (-2**31, 2**31 - 1), TypeId.INT64: (-2**63, 2**63 - 1),
    TypeId.UINT8: (0, 2**8 - 1), TypeId.UINT16: (0, 2**16 - 1),
    TypeId.UINT32: (0, 2**32 - 1), TypeId.UINT64: (0, 2**64 - 1),
}


def _is_ext(t: DataType) -> bool:
    return t.id == TypeId.EXTENSION


def _retype(data, t: DataType):
    from ..array.data import ArrayData
    return ArrayData(t, data.length, data.buffers, data.children,
                     null_count=data._null_count, offset=data.offset,
                     dictionary=data.dictionary)


def _needs_host(src: DataType, dst: DataType) -> bool:
    if _is_ext(src) or _is_ext(dst):
        return True
    if dst.id in (TypeId.DICTIONARY, TypeId.NA) or src.id == TypeId.NA:
        return True
    for ids in (_LISTS, _DECIMALS, (TypeId.STRUCT,), (TypeId.MAP,)):
        if src.id in ids or dst.id in ids:
            return True
    if dst.id in _BINARIES or dst.id == TypeId.FIXED_SIZE_BINARY:
        return True
    if _to_view(src.value_type if src.id == TypeId.DICTIONARY else src,
                dst):
        return True
    if src.id in _BINARIES or src.id == TypeId.FIXED_SIZE_BINARY:
        return True
    return src.id == TypeId.DICTIONARY and (
        dst.id == TypeId.DICTIONARY or src.value_type.id not in _STRINGS
        or dst.id in _STRINGS)


def _to_view(src: DataType, dst: DataType) -> bool:
    """A string column to string_view, a binary one to binary_view (the
    reference has no cast to a view type)."""
    return (src.id in _STRINGS and dst.id == TypeId.STRING_VIEW) or \
        (src.id in _BINARIES and dst.id == TypeId.BINARY_VIEW)


def try_cast_host(args, options) -> Optional[Array]:
    t = (options or {}).get("to_type") or (options or {}).get("target_type")
    if t is None or not isinstance(t, DataType):
        return None
    a = args[0]
    if isinstance(a, ChunkedArray):
        a = a.combine()
    if not isinstance(a, Array) or not _needs_host(a.type, t):
        return None
    return _cast_array(a, t, (options or {}).get("safe", True))


def _cast_array(a: Array, t: DataType, safe: bool) -> Array:
    src = a.type
    if src == t:
        return a
    # an extension source or target: cast the storage, retype it
    if _is_ext(src) and not _is_ext(t):
        return _cast_array(Array(_retype(a.data, src.storage_type)), t, safe)
    if _is_ext(t):
        storage = a if src == t.storage_type else \
            _cast_array(a, t.storage_type, safe)
        return Array(_retype(storage.data, t))
    if t.id == TypeId.NA:
        if safe and a.null_count != len(a):
            raise ArrowInvalid("cannot cast non-null values to null type")
        return make_array([None] * len(a), t)
    if src.id == TypeId.NA:
        return make_array([None] * len(a), t)

    # a dictionary target: cast the dense values, encode at the target
    if t.id == TypeId.DICTIONARY:
        dense = make_array(a.to_pylist(),
                           src.value_type if src.id == TypeId.DICTIONARY
                           else src)
        values = _cast_array(dense, t.value_type, safe)
        return make_array(values.to_pylist(), t)
    # a dictionary source: decode, then cast the dense values
    if src.id == TypeId.DICTIONARY:
        return _cast_array(make_array(a.to_pylist(), src.value_type), t,
                           safe)
    if _to_view(src, t):
        d = a.data
        return Array(binary_view_data(d.offsets(), d.data_bytes(),
                                      d.validity_mask(), t))

    if src.id in _LISTS and t.id in _LISTS:
        conv = _value_caster(src.value_type, t.value_type, safe)
        fixed = t.id == TypeId.FIXED_SIZE_LIST
        out = []
        for v in a.to_pylist():
            if v is None:
                out.append(None)
                continue
            if fixed and len(v) != t.list_size:
                raise ArrowInvalid(
                    f"cannot cast list of length {len(v)} to "
                    f"fixed_size_list[{t.list_size}]")
            out.append([conv(x) for x in v])
        return make_array(out, t)
    if src.id == TypeId.STRUCT and t.id == TypeId.STRUCT:
        src_names = [f.name for f in src.fields]
        convs = {}
        for f in t.fields:
            if f.name not in src_names:
                if not f.nullable and safe:
                    raise ArrowInvalid(
                        f"struct cast: missing non-nullable field "
                        f"{f.name!r}")
                convs[f.name] = None
            else:
                sf = src.fields[src_names.index(f.name)]
                convs[f.name] = _value_caster(sf.type, f.type, safe)
        out = []
        for v in a.to_pylist():
            if v is None:
                out.append(None)
                continue
            out.append({f.name: None if convs[f.name] is None
                        else convs[f.name](v.get(f.name))
                        for f in t.fields})
        return make_array(out, t)
    if src.id == TypeId.MAP and t.id == TypeId.MAP:
        kc = _value_caster(src.key_type, t.key_type, safe)
        vc = _value_caster(src.item_type, t.item_type, safe)
        return make_array([None if v is None else
                           [(kc(k), vc(x)) for k, x in v]
                           for v in a.to_pylist()], t)
    if src.id in _LISTS or t.id in _LISTS or src.id == TypeId.STRUCT \
            or t.id == TypeId.STRUCT:
        raise ArrowInvalid(f"unsupported cast {src!r} -> {t!r}")

    conv = _value_caster(src, t, safe)
    return make_array([conv(v) for v in a.to_pylist()], t)


def _guard(f):
    return lambda v: None if v is None else f(v)


def _value_caster(src: DataType, dst: DataType, safe: bool):
    """The cast of one Python value of ``src`` to one of ``dst``."""
    if src == dst:
        return lambda v: v
    if dst.id == TypeId.NA:
        return lambda v: None
    nested = _LISTS + (TypeId.STRUCT, TypeId.MAP, TypeId.DICTIONARY)
    if src.id in nested or dst.id in nested:
        # nested in nested: a one-element array cast
        return _guard(lambda v: _cast_array(make_array([v], src), dst,
                                            safe)[0])
    if dst.id in _STRINGS:
        if src.id in _BINARIES or src.id == TypeId.FIXED_SIZE_BINARY:
            if not safe:
                return _guard(lambda v: v.decode("utf-8", errors="replace"))

            def b2s(v):
                try:
                    return v.decode("utf-8")
                except UnicodeDecodeError:
                    raise ArrowInvalid("invalid UTF-8 in binary->string cast")
            return _guard(b2s)
        if src.id in _STRINGS:
            return lambda v: v
        if src.id in _DECIMALS:
            return _guard(str)
        if src.id == TypeId.BOOL:
            return _guard(lambda v: "true" if v else "false")
        return _guard(_format_scalar)
    if dst.id in _BINARIES:
        if src.id in _STRINGS:
            return _guard(lambda v: v.encode("utf-8"))
        if src.id in _BINARIES or src.id == TypeId.FIXED_SIZE_BINARY:
            return _guard(bytes)
        raise ArrowInvalid(f"unsupported cast {src!r} -> {dst!r}")
    if dst.id == TypeId.FIXED_SIZE_BINARY:
        w = dst.byte_width

        def to_fsb(v):
            b = v.encode() if isinstance(v, str) else bytes(v)
            if len(b) != w:
                raise ArrowInvalid(f"cannot cast {len(b)}-byte value to "
                                   f"fixed_size_binary[{w}]")
            return b
        return _guard(to_fsb)
    if dst.id in _DECIMALS:
        return _guard(_decimal_caster(dst, safe))
    if src.id in _DECIMALS:
        if dst.is_integer:
            lo, hi = _INT_RANGE[dst.id]

            def dec2i(v):
                iv = int(v)
                if safe and (v != iv or not lo <= iv <= hi):
                    raise ArrowInvalid(f"decimal {v} does not fit {dst!r}")
                return iv if safe else max(lo, min(hi, iv))
            return _guard(dec2i)
        if dst.is_floating:
            return _guard(float)
        raise ArrowInvalid(f"unsupported cast {src!r} -> {dst!r}")
    if dst.is_integer:
        lo, hi = _INT_RANGE[dst.id]

        def to_int(v):
            if isinstance(v, str):
                iv = int(v.strip())
            else:
                iv = int(v)
                if safe and isinstance(v, float) and v != iv:
                    raise ArrowInvalid(
                        f"float value {v} truncates in cast to {dst!r}")
            if safe and not lo <= iv <= hi:
                raise ArrowInvalid(f"value {iv} out of range for {dst!r}")
            return iv
        return _guard(to_int)
    if dst.is_floating:
        return _guard(lambda v: float(v.strip() if isinstance(v, str)
                                      else v))
    if dst.id == TypeId.BOOL:
        def to_bool(v):
            if isinstance(v, str):
                lv = v.strip().lower()
                if lv in ("true", "1", "t", "yes"):
                    return True
                if lv in ("false", "0", "f", "no"):
                    return False
                raise ArrowInvalid(f"cannot parse {v!r} as boolean")
            return bool(v)
        return _guard(to_bool)
    if (dst.is_temporal or src.is_temporal) and src.id in _STRINGS:
        return _guard(lambda v: _parse_one(v, dst))
    raise ArrowInvalid(f"unsupported cast {src!r} -> {dst!r}")


def _decimal_caster(dst: DataType, safe: bool):
    """One value to ``dst``'s decimal: rounded half to even to its scale
    (a float from its repr), raising where a rescale loses digits (but a
    float's) or the value needs more than its precision."""
    q = _dec.Decimal(1).scaleb(-dst.scale)
    pmax = _dec.Decimal(10) ** (dst.precision - dst.scale)

    def to_dec(v):
        if isinstance(v, str):
            d = _dec.Decimal(v)
        elif isinstance(v, float):
            d = _dec.Decimal(repr(v))
        else:
            d = _dec.Decimal(v)
        out = d.quantize(q, rounding=_dec.ROUND_HALF_EVEN)
        if safe and out != d and not isinstance(v, float):
            raise ArrowInvalid(f"rescaling decimal value {d} loses data")
        if abs(out) >= pmax:
            raise ArrowInvalid(f"decimal value {out} out of range for "
                               f"decimal({dst.precision}, {dst.scale})")
        return out
    return to_dec


def _parse_one(v: str, t: DataType):
    from .elementwise import _parse_one as parse
    try:
        return parse(v, t)
    except (ValueError, ArithmeticError):
        raise ArrowInvalid(f"cannot parse {v!r} as {t!r}")


def _format_scalar(v: Any) -> str:
    import numpy as np
    if isinstance(v, float):
        return np.format_float_positional(v, trim="-")
    if hasattr(v, "isoformat"):
        return v.isoformat()
    return str(v)
