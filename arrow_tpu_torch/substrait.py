"""Substrait plan interchange (counterpart of ``arrow_tpu/substrait.py``;
reference: cpp/src/arrow/engine/substrait/, serde.h
DeserializePlan/SerializePlan, relation_internal.cc's rel -> Declaration
mapping, extension_set.cc's function registry mapping).

No Substrait protobuf package is needed: this module speaks the protobuf
wire format itself with a small codec (messages of (field, wire-type)
tagged varints and length-delimited blobs), with the field numbers of the
public spec (substrait.io, proto/substrait/algebra.proto and plan.proto).
The producer gives the reference's bytes for the same Declaration.

Relations: ReadRel(named_table), FilterRel, ProjectRel, AggregateRel,
SortRel, FetchRel, JoinRel and SetRel (union all). Expressions: field
selection, literals (bool, int, float, string, binary), scalar function
calls, casts, if-then and singular-or-list; measures. Types: bool, the
signed integers, f32, f64, string, binary, timestamp and date32; there
is no mapping for a dictionary type, as in the reference, so a plan
over a dictionary column does not serialize.

``deserialize_plan(plan, table_provider)`` gives the Declaration (host
work only); ``run_query(plan, table_provider, device=None)`` runs it on
``device``, the card unless ``device="cpu"``.
"""

from __future__ import annotations

import struct
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from . import types as T
from .acero import (AggregateNodeOptions, Declaration, Expression,
                    FetchNodeOptions, FilterNodeOptions,
                    HashJoinNodeOptions, OrderByNodeOptions,
                    ProjectNodeOptions, TableSourceNodeOptions)
from .compute.registry import ArrowInvalid
from .table import Table

def _alias_type(name: str) -> T.DataType:
    from .api import type_for_alias
    return type_for_alias(name)


# --- minimal protobuf wire codec -------------------------------------------


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wt: int) -> bytes:
    return _varint(field << 3 | wt)


def fv(field: int, v: int) -> bytes:
    """varint field"""
    return _tag(field, 0) + _varint(int(v))


def fm(field: int, payload: bytes) -> bytes:
    """length-delimited (message / string / bytes) field"""
    return _tag(field, 2) + _varint(len(payload)) + payload


def fs(field: int, s: str) -> bytes:
    return fm(field, s.encode())


def fd(field: int, x: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", x)


class PB:
    """Parsed protobuf message: field -> list of raw values."""

    __slots__ = ("fields",)

    def __init__(self, data: bytes):
        self.fields: Dict[int, List] = {}
        i, n = 0, len(data)
        while i < n:
            tag, i = self._rv(data, i)
            f, wt = tag >> 3, tag & 7
            if wt == 0:
                v, i = self._rv(data, i)
            elif wt == 2:
                ln, i = self._rv(data, i)
                v = data[i:i + ln]
                i += ln
            elif wt == 1:
                v = struct.unpack("<d", data[i:i + 8])[0]
                i += 8
            elif wt == 5:
                v = struct.unpack("<f", data[i:i + 4])[0]
                i += 4
            else:
                raise ArrowInvalid(f"bad wire type {wt}")
            self.fields.setdefault(f, []).append(v)

    @staticmethod
    def _rv(b: bytes, i: int) -> Tuple[int, int]:
        v = s = 0
        while True:
            byte = b[i]
            i += 1
            v |= (byte & 0x7F) << s
            s += 7
            if not byte & 0x80:
                return v, i

    def msg(self, f: int) -> Optional["PB"]:
        v = self.fields.get(f)
        return PB(v[0]) if v else None

    def msgs(self, f: int) -> List["PB"]:
        return [PB(x) for x in self.fields.get(f, [])]

    def u(self, f: int, default=0) -> int:
        v = self.fields.get(f)
        return v[0] if v else default

    def s(self, f: int) -> Optional[str]:
        v = self.fields.get(f)
        return v[0].decode() if v else None

    def strs(self, f: int) -> List[str]:
        return [x.decode() for x in self.fields.get(f, [])]

    def raw(self, f: int) -> Optional[bytes]:
        v = self.fields.get(f)
        return v[0] if v else None

    def has(self, f: int) -> bool:
        return f in self.fields


# --- type mapping (substrait Type oneof field numbers) ---------------------
# bool=1 i8=2 i16=3 i32=5 i64=7 fp32=10 fp64=11 string=12 binary=13
# timestamp=14 date=16 time=17 decimal=24 (spec order, confirmed against
# pyarrow's serialize_schema output for i64/fp64/string)

_TYPE_TO_SUB = {
    T.TypeId.BOOL: 1, T.TypeId.INT8: 2, T.TypeId.INT16: 3,
    T.TypeId.INT32: 5, T.TypeId.INT64: 7, T.TypeId.FLOAT: 10,
    T.TypeId.DOUBLE: 11, T.TypeId.STRING: 12, T.TypeId.BINARY: 13,
    T.TypeId.TIMESTAMP: 14, T.TypeId.DATE32: 16,
}
_SUB_TO_TYPE = {
    1: T.bool_(), 2: T.int8(), 3: T.int16(), 5: T.int32(), 7: T.int64(),
    10: T.float32(), 11: T.float64(), 12: T.string(), 13: T.binary(),
    14: T.timestamp("us"), 16: T.date32(),
}
_NULLABLE = 1


def _enc_type(t: T.DataType) -> bytes:
    f = _TYPE_TO_SUB.get(t.id)
    if f is None:
        raise ArrowInvalid(f"no substrait mapping for {t!r}")
    return fm(f, fv(2, _NULLABLE))


def _dec_type(p: PB) -> T.DataType:
    for f, t in _SUB_TO_TYPE.items():
        if p.has(f):
            return t
    raise ArrowInvalid(f"unknown substrait type fields {list(p.fields)}")


def _enc_named_struct(schema: T.Schema) -> bytes:
    names = b"".join(fs(1, f.name) for f in schema)
    types = b"".join(fm(1, _enc_type_inner(f.type)) for f in schema)
    # Struct: {1: types, 2: type_variation_reference, 3: nullability}
    return names + fm(2, types + fv(3, _NULLABLE))


def _enc_type_inner(t: T.DataType) -> bytes:
    # the payload of a Type message (for embedding into Struct.types)
    f = _TYPE_TO_SUB.get(t.id)
    if f is None:
        raise ArrowInvalid(f"no substrait mapping for {t!r}")
    return fm(f, fv(2, _NULLABLE))


def _dec_named_struct(p: PB) -> T.Schema:
    names = p.strs(1)
    st = p.msg(2)
    types = [_dec_type(tp) for tp in st.msgs(1)] if st else []
    return T.Schema([T.Field(n, t) for n, t in zip(names, types)])


# --- function name registry ------------------------------------------------

_URI = "https://github.com/substrait-io/substrait/blob/main/extensions/"

# Function-registry mapping breadth mirrors the reference's default
# extension-id registry (engine/substrait/extension_set.cc:1066-1258):
# overflowable arithmetic with the "overflow" option selecting _checked
# variants, trig/log/rounding families, Kleene booleans, bitwise,
# temporal extract via enum argument, concat, variance/std_dev with the
# "distribution" option — plus the substrait string yaml
# (substring/starts_with/.../char_length), which the engine can serve
# natively.

_Y_AR = "functions_arithmetic.yaml"
_Y_LOG = "functions_logarithmic.yaml"
_Y_RND = "functions_rounding.yaml"
_Y_CMP = "functions_comparison.yaml"
_Y_BOOL = "functions_boolean.yaml"
_Y_STR = "functions_string.yaml"
_Y_DT = "functions_datetime.yaml"
_Y_AGG = "functions_aggregate_generic.yaml"
_Y_ARROW = ("https://github.com/apache/arrow/blob/main/format/substrait/"
            "extension_types.yaml")

# substrait arithmetic names that take the "overflow" option and have a
# _checked engine variant (reference DecodeOptionlessOverflowableArithmetic)
_OVERFLOWABLE = {"add", "subtract", "multiply", "divide", "negate",
                 "power", "sqrt", "abs"}

# substrait name -> engine name (direct 1:1 decode)
_SUB_FN = {
    "add": "add", "subtract": "subtract", "multiply": "multiply",
    "divide": "divide", "power": "power", "abs": "abs",
    "negate": "negate", "sqrt": "sqrt",
    # optionless arithmetic
    "exp": "exp", "sign": "sign",
    "cos": "cos", "sin": "sin", "tan": "tan",
    "acos": "acos", "asin": "asin", "atan": "atan", "atan2": "atan2",
    "cosh": "cosh", "sinh": "sinh", "tanh": "tanh",
    "acosh": "acosh", "asinh": "asinh", "atanh": "atanh",
    # logarithmic
    "ln": "ln", "log10": "log10", "log2": "log2", "logb": "logb",
    "log1p": "log1p",
    # rounding (round itself carries the "rounding" option -> round_binary)
    "ceil": "ceil", "floor": "floor",
    # comparison
    "gt": "greater", "lt": "less", "gte": "greater_equal",
    "lte": "less_equal", "equal": "equal", "not_equal": "not_equal",
    "is_null": "is_null", "is_not_null": "is_valid",
    "is_nan": "is_nan", "is_finite": "is_finite",
    "is_not_distinct_from": "is_not_distinct_from",
    "coalesce": "coalesce", "between": "between",
    # boolean — substrait and/or are three-valued (reference maps _kleene)
    "and": "and_kleene", "or": "or_kleene", "not": "invert", "xor": "xor",
    # bitwise
    "bitwise_and": "bit_wise_and", "bitwise_or": "bit_wise_or",
    "bitwise_xor": "bit_wise_xor", "bitwise_not": "bit_wise_not",
    # string
    "like": "match_like", "concat": "binary_join_element_wise",
    "lower": "utf8_lower", "upper": "utf8_upper",
    "char_length": "utf8_length", "reverse": "utf8_reverse",
    "string_split": None, "substring": None, "starts_with": None,
    "ends_with": None, "contains": None, "replace": None,
    "ltrim": None, "rtrim": None, "trim": None,
    # datetime
    "extract": None,
    "round": None,
}
# engine name -> substrait name (producer); checked variants fold onto the
# same substrait name with overflow=ERROR (reference
# EncodeOptionlessOverflowableArithmetic<true>)
_ENGINE_TO_SUB = {v: k for k, v in _SUB_FN.items() if v}
_ENGINE_TO_SUB.update({
    "and": "and", "or": "or",       # binary non-Kleene still encode
    "utf8_ltrim_whitespace": "ltrim", "utf8_rtrim_whitespace": "rtrim",
    "utf8_trim_whitespace": "trim",
})
for _nm in _OVERFLOWABLE:
    if _SUB_FN.get(_nm):
        _ENGINE_TO_SUB[_SUB_FN[_nm] + "_checked"] = _nm
# temporal component kernels encode as extract + enum argument
_EXTRACT_COMPONENTS = {
    "YEAR": "year", "ISO_YEAR": "iso_year", "QUARTER": "quarter",
    "MONTH": "month", "DAY": "day", "DAY_OF_WEEK": "day_of_week",
    "DAY_OF_YEAR": "day_of_year", "HOUR": "hour", "MINUTE": "minute",
    "SECOND": "second", "MILLISECOND": "millisecond",
    "MICROSECOND": "microsecond",
}
_ENGINE_TO_EXTRACT = {v: k for k, v in _EXTRACT_COMPONENTS.items()}

# substrait aggregate name -> engine name
_SUB_AGG = {
    "sum": "sum", "sum0": "sum", "min": "min", "max": "max",
    "avg": "mean", "count": "count", "count_all": "count_all",
    "any_value": "first", "first": "first", "last": "last",
    "string_agg": None, "approx_count_distinct": "count_distinct",
    "median": "approximate_median", "product": "product",
    "variance": "variance", "std_dev": "stddev",
}
_ENGINE_TO_SUB_AGG = {v: k for k, v in _SUB_AGG.items() if v}
_ENGINE_TO_SUB_AGG["first"] = "first"   # prefer over any_value
_ENGINE_TO_SUB_AGG["sum"] = "sum"

_FN_YAML = {}
for _nm in ("add subtract multiply divide modulus power abs negate sqrt "
            "exp sign cos sin tan acos asin atan atan2 cosh sinh tanh "
            "acosh asinh atanh sum sum0 min max avg variance std_dev "
            "median product").split():
    _FN_YAML[_nm] = _Y_AR
for _nm in "ln log10 log2 logb log1p".split():
    _FN_YAML[_nm] = _Y_LOG
for _nm in "ceil floor round".split():
    _FN_YAML[_nm] = _Y_RND
for _nm in ("gt lt gte lte equal not_equal is_null is_not_null is_nan "
            "is_finite is_not_distinct_from coalesce between").split():
    _FN_YAML[_nm] = _Y_CMP
for _nm in "and or not xor".split():
    _FN_YAML[_nm] = _Y_BOOL
for _nm in ("like concat lower upper char_length reverse substring "
            "starts_with ends_with contains replace ltrim rtrim trim "
            "string_split string_agg").split():
    _FN_YAML[_nm] = _Y_STR
for _nm in "extract".split():
    _FN_YAML[_nm] = _Y_DT
for _nm in "count count_all any_value approx_count_distinct".split():
    _FN_YAML[_nm] = _Y_AGG
for _nm in "bitwise_and bitwise_or bitwise_xor bitwise_not".split():
    _FN_YAML[_nm] = _Y_AR
for _nm in "first last".split():
    _FN_YAML[_nm] = _Y_ARROW


class _ExtCollector:
    """Assigns extension-URI and function anchors on the producer side."""

    def __init__(self):
        self.uris: Dict[str, int] = {}
        self.fns: Dict[str, int] = {}

    def anchor(self, sub_name: str) -> int:
        if sub_name not in self.fns:
            yaml = _FN_YAML.get(sub_name, "functions_arithmetic.yaml")
            if yaml not in self.uris:
                self.uris[yaml] = len(self.uris) + 1
            self.fns[sub_name] = len(self.fns) + 1
        return self.fns[sub_name]

    def encode(self) -> bytes:
        out = b""
        for yaml, ua in self.uris.items():
            out += fm(1, fv(1, ua) + fs(2, _URI + yaml))
        for name, anchor in self.fns.items():
            ua = self.uris[_FN_YAML.get(name, "functions_arithmetic.yaml")]
            out += fm(2, fm(3, fv(1, ua) + fv(2, anchor) + fs(3, name)))
        return out


# --- expression encode/decode ----------------------------------------------


def _enc_field_ref(idx: int) -> bytes:
    # Expression.selection(2) = FieldReference{1: direct ReferenceSegment
    # {2: struct_field{1: field}}, 4: root_reference{}}
    seg = fm(2, fv(1, idx)) if idx else fm(2, b"")
    return fm(2, fm(1, seg) + fm(4, b""))


def _enc_literal(v) -> bytes:
    # Expression.literal(1); Literal oneof mirrors Type numbering
    if isinstance(v, bool):
        lit = fv(1, 1 if v else 0)
    elif isinstance(v, int):
        lit = fv(7, v & 0xFFFFFFFFFFFFFFFF)
    elif isinstance(v, float):
        lit = fd(11, v)
    elif isinstance(v, str):
        lit = fs(12, v)
    elif isinstance(v, bytes):
        lit = fm(13, v)
    else:
        raise ArrowInvalid(f"cannot encode literal {v!r}")
    return fm(1, lit)


def _enc_expr(expr: Expression, schema: T.Schema,
              ext: _ExtCollector) -> bytes:
    if expr.kind == Expression.KIND_FIELD:
        idx = schema.get_field_index(expr.name)
        if idx < 0:
            raise ArrowInvalid(f"unknown field {expr.name!r}")
        return _enc_field_ref(idx)
    if expr.kind == Expression.KIND_LITERAL:
        return _enc_literal(expr.value)
    if expr.kind == Expression.KIND_CALL:
        if expr.fn == "cast":
            to = expr.options.get("target_type")
            if to is None:
                raise ArrowInvalid("cast without target_type")
            if isinstance(to, str):
                to = _alias_type(to)
            # Expression.Cast{1: type, 2: input, 3: failure_behavior}
            body = fm(1, fm(_TYPE_TO_SUB[to.id], fv(2, _NULLABLE))) + \
                fm(2, _enc_expr(expr.args[0], schema, ext)) + fv(3, 2)
            return fm(11, body)
        enum_args: List[str] = []
        options: List[Tuple[str, str]] = []
        fn = expr.fn
        if fn in _ENGINE_TO_EXTRACT:      # year(x) -> extract ENUM x
            sub = "extract"
            enum_args.append(_ENGINE_TO_EXTRACT[fn])
        elif fn in _ENGINE_TO_SUB:
            sub = _ENGINE_TO_SUB[fn]
            if sub in _OVERFLOWABLE:
                options.append(("overflow", "ERROR" if
                                fn.endswith("_checked") else "SILENT"))
            if fn == "is_null" and expr.options.get("nan_is_null"):
                raise ArrowInvalid(
                    "substrait has no is_null(nan_is_null=True); "
                    "use is_null || is_nan")
        else:
            raise ArrowInvalid(
                f"no substrait name for function {expr.fn!r}")
        anchor = ext.anchor(sub)
        args = b"".join(fm(4, fs(1, e)) for e in enum_args)
        args += b"".join(fm(4, fm(3, _enc_expr(a, schema, ext)))
                         for a in expr.args)
        opts = b"".join(fm(5, fs(1, nm) + fs(2, pref))
                        for nm, pref in options)
        out_t = _expr_type(expr, schema)
        body = fv(1, anchor) + fm(3, _enc_type_inner_payload(out_t)) + \
            args + opts
        return fm(3, body)
    raise ArrowInvalid(f"cannot encode expression kind {expr.kind}")


_BOOL_FNS = {"greater", "less", "greater_equal", "less_equal", "equal",
             "not_equal", "and", "or", "invert", "xor", "is_null",
             "is_valid", "match_like", "and_kleene", "or_kleene",
             "is_nan", "is_finite", "is_not_distinct_from", "between",
             "starts_with", "ends_with", "match_substring"}
_INT_FNS = {"year", "iso_year", "quarter", "month", "day", "day_of_week",
            "day_of_year", "hour", "minute", "second", "millisecond",
            "microsecond", "utf8_length", "sign"}


def _expr_type(expr: Expression, schema: T.Schema) -> T.DataType:
    """Static result-type inference for the producer's output_type slots."""
    if expr.kind == Expression.KIND_FIELD:
        return schema.field(expr.name).type
    if expr.kind == Expression.KIND_LITERAL:
        v = expr.value
        if isinstance(v, bool):
            return T.bool_()
        if isinstance(v, int):
            return T.int64()
        if isinstance(v, float):
            return T.float64()
        if isinstance(v, str):
            return T.string()
        return T.binary()
    if expr.fn in _BOOL_FNS:
        return T.bool_()
    if expr.fn in _INT_FNS:
        return T.int64()
    if expr.fn == "divide":
        return T.float64()
    if expr.fn == "cast":
        to = expr.options.get("target_type")
        return _alias_type(to) if isinstance(to, str) else to
    for a in expr.args:
        if a.kind != Expression.KIND_LITERAL:
            return _expr_type(a, schema)
    return _expr_type(expr.args[0], schema)


def _enc_type_inner_payload(t: T.DataType) -> bytes:
    f = _TYPE_TO_SUB.get(t.id)
    if f is None:
        raise ArrowInvalid(f"no substrait mapping for {t!r}")
    return fm(f, fv(2, _NULLABLE))


_ROUND_MODES = {
    "FLOOR": "down", "CEILING": "up", "TRUNCATE": "towards_zero",
    "AWAY_FROM_ZERO": "towards_infinity", "TIE_DOWN": "half_down",
    "TIE_UP": "half_up", "TIE_TOWARDS_ZERO": "half_towards_zero",
    "TIE_AWAY_FROM_ZERO": "half_towards_infinity",
    "TIE_TO_EVEN": "half_to_even", "TIE_TO_ODD": "half_to_odd",
}


def _lit_or_raise(e: Expression, what: str):
    if e.kind != Expression.KIND_LITERAL:
        raise ArrowInvalid(f"substrait {what} must be a literal")
    return e.value


def _decode_scalar_call(base: str, args: List[Expression],
                        enum_args: List[str],
                        options: Dict[str, List[str]]) -> Expression:
    """Resolve a substrait call to an engine expression, applying the
    reference's variant logic (extension_set.cc): the "overflow" option
    selects _checked arithmetic, "rounding" selects the round mode,
    extract's enum argument selects the temporal kernel, and the string
    functions whose arrow forms take FunctionOptions (pattern,
    replacement, slice bounds) lift literal arguments into options."""
    if base in _OVERFLOWABLE:
        pref = options.get("overflow", ["SILENT"])
        eng = _SUB_FN[base]
        if pref and pref[0] == "ERROR":
            eng += "_checked"
        elif pref and pref[0] == "SATURATE":
            raise ArrowInvalid("SATURATE overflow is not implemented")
        return Expression.call(eng, *args)
    if base == "extract":
        if not enum_args:
            raise ArrowInvalid("extract requires a component enum")
        comp = enum_args[0].upper()
        eng = _EXTRACT_COMPONENTS.get(comp)
        if eng is None:
            raise ArrowInvalid(f"unsupported extract component {comp!r}")
        return Expression.call(eng, *args)
    if base == "round":
        pref = options.get("rounding", ["TIE_TO_EVEN"])
        mode = _ROUND_MODES.get(pref[0] if pref else "TIE_TO_EVEN",
                                "half_to_even")
        if len(args) == 2:
            nd = _lit_or_raise(args[1], "round ndigits")
            return Expression.call("round", args[0], ndigits=int(nd),
                                   round_mode=mode)
        return Expression.call("round", args[0], round_mode=mode)
    if base == "concat":
        return Expression.call("binary_join_element_wise", *args,
                               Expression.literal(""))
    if base == "substring":
        # substrait substring(input, start, length): 1-based start
        start = int(_lit_or_raise(args[1], "substring start")) - 1
        kw = {"start": start}
        if len(args) > 2:
            kw["stop"] = start + int(_lit_or_raise(args[2],
                                                   "substring length"))
        return Expression.call("utf8_slice_codeunits", args[0], **kw)
    if base in ("starts_with", "ends_with", "contains"):
        eng = {"starts_with": "starts_with", "ends_with": "ends_with",
               "contains": "match_substring"}[base]
        pat = _lit_or_raise(args[1], f"{base} pattern")
        return Expression.call(eng, args[0], pattern=pat)
    if base == "replace":
        pat = _lit_or_raise(args[1], "replace search")
        rep = _lit_or_raise(args[2], "replace replacement")
        return Expression.call("replace_substring", args[0], pattern=pat,
                               replacement=rep)
    if base in ("ltrim", "rtrim", "trim"):
        eng = {"ltrim": "utf8_ltrim", "rtrim": "utf8_rtrim",
               "trim": "utf8_trim"}[base]
        if len(args) > 1:
            chars = _lit_or_raise(args[1], "trim characters")
            return Expression.call(eng, args[0], characters=chars)
        return Expression.call(eng + "_whitespace", args[0])
    eng = _SUB_FN.get(base)
    if eng is None:
        raise ArrowInvalid(f"unmapped substrait function {base!r}")
    return Expression.call(eng, *args)


def _dec_expr(p: PB, schema: T.Schema, fn_names: Dict[int, str]):
    if p.has(1):      # literal
        lit = p.msg(1)
        if lit.has(1):
            return Expression.literal(bool(lit.u(1)))
        for f in (2, 3, 5, 7):
            if lit.has(f):
                v = lit.u(f)
                if v >= 1 << 63:
                    v -= 1 << 64
                return Expression.literal(v)
        for f in (10, 11):
            if lit.has(f):
                return Expression.literal(lit.fields[f][0])
        if lit.has(12):
            return Expression.literal(lit.s(12))
        if lit.has(13):
            return Expression.literal(lit.raw(13))
        raise ArrowInvalid(f"unsupported literal fields {list(lit.fields)}")
    if p.has(2):      # selection
        ref = p.msg(2)
        seg = ref.msg(1)
        idx = 0
        if seg is not None and seg.has(2):
            idx = seg.msg(2).u(1)
        return Expression.field(schema[idx].name)
    if p.has(3):      # scalar function
        sf = p.msg(3)
        anchor = sf.u(1)
        sub_name = fn_names.get(anchor)
        if sub_name is None:
            raise ArrowInvalid(f"unknown function anchor {anchor}")
        base = sub_name.split(":")[0]
        args: List[Expression] = []
        enum_args: List[str] = []
        for fa in sf.msgs(4):
            v = fa.msg(3)
            if v is not None:
                args.append(_dec_expr(v, schema, fn_names))
            elif fa.s(1) is not None:
                enum_args.append(fa.s(1))
            else:
                raise ArrowInvalid("type-valued function argument")
        options: Dict[str, List[str]] = {}
        for op_ in sf.msgs(5):
            nm = op_.s(1)
            if nm:
                options[nm] = op_.strs(2)
        return _decode_scalar_call(base, args, enum_args, options)
    if p.has(11):     # cast {1: type, 2: input}
        c = p.msg(11)
        inner = _dec_expr(c.msg(2), schema, fn_names)
        to = _dec_type(c.msg(1))
        return Expression.call("cast", inner,
                               target_type=to)
    if p.has(4):      # if_then {1: ifs{1: if, 2: then}, 2: else}
        f = p.msg(4)
        clauses = [( _dec_expr(c.msg(1), schema, fn_names),
                     _dec_expr(c.msg(2), schema, fn_names))
                   for c in f.msgs(1)]
        out = _dec_expr(f.msg(2), schema, fn_names) if f.msg(2) \
            else Expression.literal(None)
        for cond, then in reversed(clauses):   # right-fold to if_else
            out = Expression.call("if_else", cond, then, out)
        return out
    if p.has(7):      # singular_or_list {1: value, 2: options}
        f = p.msg(7)
        val = _dec_expr(f.msg(1), schema, fn_names)
        alts = [_dec_expr(o, schema, fn_names) for o in f.msgs(2)]
        out = None
        for alt in alts:              # OR of equalities (IN semantics)
            eq = Expression.call("equal", val, alt)
            out = eq if out is None else Expression.call("or", out, eq)
        return out if out is not None else Expression.literal(False)
    raise ArrowInvalid(f"unsupported expression fields {list(p.fields)}")


# --- producer: Declaration -> plan bytes -----------------------------------


def _source_schema(options) -> T.Schema:
    """A table source's schema: its host Table's, or its DeviceBatch's."""
    return options.table.schema if options.is_host \
        else options.batch.schema


def _schema_of(decl: Declaration) -> T.Schema:
    """Static output schema tracking for the supported producer subset."""
    n = decl.factory_name
    if n == "table_source":
        return _source_schema(decl.options)
    if n in ("filter", "fetch", "order_by"):
        return _schema_of(decl.inputs[0])
    if n == "project":
        raise ArrowInvalid("project schema tracking handled inline")
    raise ArrowInvalid(f"substrait producer: unsupported node {n}")


def _enc_rel(decl: Declaration, ext: _ExtCollector) -> Tuple[bytes, T.Schema]:
    n = decl.factory_name
    if n == "table_source":
        src_schema = _source_schema(decl.options)
        ns = _enc_named_struct(src_schema)
        name = getattr(decl.options, "substrait_name", None) or "main"
        read = fm(2, ns) + fm(7, fs(1, name))
        return fm(1, read), src_schema
    if n == "filter":
        inner, schema = _enc_rel(decl.inputs[0], ext)
        cond = _enc_expr(decl.options.filter_expression, schema, ext)
        return fm(2, fm(2, inner) + fm(3, cond)), schema
    if n == "project":
        inner, schema = _enc_rel(decl.inputs[0], ext)
        exprs = b"".join(fm(3, _enc_expr(e, schema, ext))
                         for e in decl.options.expressions)
        names = decl.options.names or [
            f"col{i}" for i in range(len(decl.options.expressions))]
        out_schema = T.Schema(
            [T.Field(nm, T.float64()) for nm in names])  # names only
        # ProjectRel output = input columns THEN expressions; emit an
        # output_mapping (RelCommon.emit) selecting only the expressions
        n_in = len(schema.names)
        mapping = b"".join(fv(1, n_in + i)
                           for i in range(len(decl.options.expressions)))
        common = fm(1, fm(2, mapping))
        return fm(7, common + fm(2, inner) + exprs), out_schema
    if n == "fetch":
        inner, schema = _enc_rel(decl.inputs[0], ext)
        o = decl.options.offset or 0
        c = decl.options.count
        body = fm(2, inner) + fv(3, o)
        if c is not None and c >= 0:
            body += fv(4, c)
        return fm(3, body), schema
    if n == "order_by":
        inner, schema = _enc_rel(decl.inputs[0], ext)
        sorts = b""
        for key, order in decl.options.sort_keys:
            idx = schema.get_field_index(key)
            direction = 2 if order == "ascending" else 4
            sorts += fm(3, fm(1, _enc_field_ref(idx)) + fv(2, direction))
        return fm(5, fm(2, inner) + sorts), schema
    if n == "aggregate":
        inner, schema = _enc_rel(decl.inputs[0], ext)
        keys = list(decl.options.keys)
        groupings = b""
        if keys:
            g = b"".join(fm(1, _enc_field_ref(schema.get_field_index(k)))
                         for k in keys)
            groupings = fm(3, g)
        measures = b""
        out_fields = [T.Field(k, schema.field(k).type) for k in keys]
        for agg in decl.options.aggregates:
            target, fname, _opts, out_name = agg
            sub_name = _ENGINE_TO_SUB_AGG.get(fname)
            if sub_name is None:
                raise ArrowInvalid(f"no substrait aggregate for {fname!r}")
            anchor = ext.anchor(sub_name)
            body = fv(1, anchor)
            tgt = target if isinstance(target, str) else \
                (target[0] if target else None)
            if fname == "count_all":
                out_t = T.int64()
            else:
                ft = schema.field(tgt).type
                out_t = T.float64() if fname in ("mean", "variance",
                                                 "stddev") else (
                    T.int64() if fname in ("count", "count_distinct")
                    else ft)
                body += fm(7, fm(3, _enc_field_ref(
                    schema.get_field_index(tgt))))
            body += fm(5, _enc_type_inner_payload(out_t))
            body += fv(4, 3)  # phase AGGREGATION_PHASE_INITIAL_TO_RESULT
            if fname in ("variance", "stddev"):
                ddof = (_opts or {}).get("ddof", 0)
                body += fm(8, fs(1, "distribution") +
                           fs(2, "SAMPLE" if ddof else "POPULATION"))
            measures += fm(4, fm(1, body))
            out_fields.append(T.Field(out_name, out_t))
        out_schema = T.Schema(out_fields)
        return fm(4, fm(2, inner) + groupings + measures), out_schema
    if n == "hashjoin":
        o = decl.options
        left, ls = _enc_rel(decl.inputs[0], ext)
        right, rs = _enc_rel(decl.inputs[1], ext)
        jt = {"inner": 1, "full outer": 2, "left outer": 3,
              "right outer": 4, "left semi": 5, "left anti": 6}.get(
                  o.join_type)
        if jt is None:
            raise ArrowInvalid(
                f"substrait join type for {o.join_type!r} unsupported")
        nl = len(ls.names)
        conds = []
        eq_anchor = ext.anchor("equal")
        for lk, rk in zip(o.left_keys, o.right_keys):
            li = ls.get_field_index(lk)
            ri = rs.get_field_index(rk) + nl
            call = fv(1, eq_anchor) + \
                fm(3, _enc_type_inner_payload(T.bool_())) + \
                fm(4, fm(3, _enc_field_ref(li))) + \
                fm(4, fm(3, _enc_field_ref(ri)))
            conds.append(fm(3, call))
        cond = conds[0]
        and_anchor = None
        for extra in conds[1:]:
            if and_anchor is None:
                and_anchor = ext.anchor("and")
            call = fv(1, and_anchor) + \
                fm(3, _enc_type_inner_payload(T.bool_())) + \
                fm(4, fm(3, cond)) + fm(4, fm(3, extra))
            cond = fm(3, call)
        out_schema = T.Schema(list(ls) + list(rs))
        body = fm(2, left) + fm(3, right) + fm(4, cond) + fv(6, jt)
        return fm(6, body), out_schema
    if n == "union":
        # SetRel (Rel field 8), op UNION_ALL=6 (substrait algebra.proto;
        # reference consumer: engine/substrait/relation_internal.cc Set)
        parts = [_enc_rel(i, ext) for i in decl.inputs]
        schema = parts[0][1]
        body = b"".join(fm(2, rel) for rel, _ in parts) + fv(3, 6)
        return fm(8, body), schema
    raise ArrowInvalid(f"substrait producer: unsupported node {n!r}")


def serialize_plan(decl: Declaration,
                   output_names: Optional[Sequence[str]] = None) -> bytes:
    """Declaration tree -> Substrait Plan bytes."""
    ext = _ExtCollector()
    rel, schema = _enc_rel(decl, ext)
    names = list(output_names) if output_names is not None else \
        list(schema.names)
    root = fm(1, rel) + b"".join(fs(2, nm) for nm in names)
    plan_rel = fm(2, root)
    version = fm(6, fv(2, 44) + fs(5, "arrow_tpu"))
    return ext.encode() + fm(3, plan_rel) + version


# --- consumer: plan bytes -> Declaration -> Table --------------------------


def _collect_fn_names(plan: PB) -> Dict[int, str]:
    out: Dict[int, str] = {}
    for decl in plan.msgs(2):
        f = decl.msg(3)
        if f is not None:
            out[f.u(2)] = f.s(3) or ""
    return out


def _dec_rel(p: PB, fn_names, table_provider) -> Tuple[Declaration, T.Schema]:
    if p.has(1):      # ReadRel
        r = p.msg(1)
        schema = _dec_named_struct(r.msg(2)) if r.msg(2) else T.Schema([])
        nt = r.msg(7)
        if nt is None:
            raise ArrowInvalid("only named_table reads are supported")
        names = nt.strs(1)
        tbl = table_provider(names, schema)
        if not isinstance(tbl, Table):
            raise ArrowInvalid("table_provider must return a host Table")
        d = Declaration("table_source", TableSourceNodeOptions(tbl))
        out_schema = tbl.schema
        if r.msg(3) is not None:   # pushed filter
            cond = _dec_expr(r.msg(3), out_schema, fn_names)
            d = Declaration("filter", FilterNodeOptions(cond), inputs=[d])
        return d, out_schema
    if p.has(2):      # FilterRel
        f = p.msg(2)
        child, schema = _dec_rel(f.msg(2), fn_names, table_provider)
        cond = _dec_expr(f.msg(3), schema, fn_names)
        return Declaration("filter", FilterNodeOptions(cond),
                           inputs=[child]), schema
    if p.has(3):      # FetchRel
        f = p.msg(3)
        child, schema = _dec_rel(f.msg(2), fn_names, table_provider)
        return Declaration("fetch",
                           FetchNodeOptions(f.u(3), f.u(4, -1)),
                           inputs=[child]), schema
    if p.has(7):      # ProjectRel
        f = p.msg(7)
        child, schema = _dec_rel(f.msg(2), fn_names, table_provider)
        exprs = [Expression.field(nm) for nm in schema.names]
        names = list(schema.names)
        for i, ep in enumerate(f.msgs(3)):
            exprs.append(_dec_expr(ep, schema, fn_names))
            names.append(f"expr{i}")
        emit = None
        common = f.msg(1)
        if common is not None and common.msg(2) is not None:
            emit = common.msg(2).fields.get(1, [])
        if emit:
            exprs = [exprs[i] for i in emit]
            names = [names[i] for i in emit]
        out_schema = T.Schema(
            [schema.field(nm) if nm in schema.names else
             T.Field(nm, T.float64()) for nm in names])
        return Declaration("project", ProjectNodeOptions(exprs, names),
                           inputs=[child]), out_schema
    if p.has(5):      # SortRel
        f = p.msg(5)
        child, schema = _dec_rel(f.msg(2), fn_names, table_provider)
        keys = []
        for sf in f.msgs(3):
            e = _dec_expr(sf.msg(1), schema, fn_names)
            direction = sf.u(2, 2)
            keys.append((e.name, "ascending" if direction in (1, 2)
                         else "descending"))
        return Declaration("order_by", OrderByNodeOptions(keys),
                           inputs=[child]), schema
    if p.has(4):      # AggregateRel
        f = p.msg(4)
        child, schema = _dec_rel(f.msg(2), fn_names, table_provider)
        keys = []
        for g in f.msgs(3):
            for ge in g.msgs(1):
                keys.append(_dec_expr(ge, schema, fn_names).name)
        aggs = []
        for i, m in enumerate(f.msgs(4)):
            mf = m.msg(1)
            if mf is None:
                continue
            sub = fn_names.get(mf.u(1), "").split(":")[0]
            eng = _SUB_AGG.get(sub)
            if eng is None:
                raise ArrowInvalid(f"unmapped aggregate {sub!r}")
            targets = [_dec_expr(fa.msg(3), schema, fn_names).name
                       for fa in mf.msgs(7) if fa.msg(3) is not None]
            if sub == "count" and not targets:
                eng = "count_all"
            opts = None
            if eng in ("variance", "stddev"):
                # "distribution" option (functions_arithmetic.yaml#L1240):
                # SAMPLE -> ddof=1, POPULATION -> ddof=0
                dist = ["SAMPLE"]
                for op_ in mf.msgs(8):
                    if op_.s(1) == "distribution":
                        dist = op_.strs(2) or dist
                opts = {"ddof": 1 if dist[0] == "SAMPLE" else 0}
            target = targets[0] if targets else schema.names[0]
            aggs.append((target, eng, opts, f"{eng}_{i}"))
        agg_fields = [T.Field(k, schema.field(k).type) for k in keys]
        # the measures' names too (their types are the plan's to find),
        # so that a relation above may refer to them: the reference's
        # consumer keeps the keys alone, and a sort of a measure fails
        out_schema = T.Schema(agg_fields + [T.Field(a[3], T.float64())
                                            for a in aggs])
        return Declaration(
            "aggregate", AggregateNodeOptions(aggs, keys=keys),
            inputs=[child]), out_schema
    if p.has(6):      # JoinRel
        f = p.msg(6)
        left, ls = _dec_rel(f.msg(2), fn_names, table_provider)
        right, rs = _dec_rel(f.msg(3), fn_names, table_provider)
        jt = {1: "inner", 2: "full outer", 3: "left outer",
              4: "right outer", 5: "left semi", 6: "left anti"}.get(
                  f.u(6), "inner")
        # expression must be equi-join: equal(field(l), field(r)) or ANDs
        lkeys, rkeys = [], []

        def walk(e: PB):
            sf = e.msg(3)
            if sf is None:
                raise ArrowInvalid("join expression must be equalities")
            name = fn_names.get(sf.u(1), "").split(":")[0]
            args = [fa.msg(3) for fa in sf.msgs(4)]
            if name == "and":
                for a in args:
                    walk(a)
                return
            if name != "equal":
                raise ArrowInvalid("only equi-joins supported")
            refs = []
            for a in args:
                ref = a.msg(2)
                seg = ref.msg(1)
                refs.append(seg.msg(2).u(1) if seg and seg.has(2) else 0)
            li, ri = refs
            nl = len(ls.names)
            if li < nl <= ri:
                lkeys.append(ls.names[li])
                rkeys.append(rs.names[ri - nl])
            elif ri < nl <= li:
                lkeys.append(ls.names[ri])
                rkeys.append(rs.names[li - nl])
            else:
                raise ArrowInvalid("join keys must reference both sides")
        walk(f.msg(4))
        out_schema = T.Schema(list(ls) + list(rs))
        return Declaration("hashjoin", HashJoinNodeOptions(
            join_type=jt, left_keys=lkeys, right_keys=rkeys),
            inputs=[left, right]), out_schema
    if p.has(8):      # SetRel
        f = p.msg(8)
        op = f.u(3)
        if op != 6:  # UNION_ALL (the op the reference consumer accepts)
            raise ArrowInvalid(f"unsupported set operation {op}")
        children = [_dec_rel(c, fn_names, table_provider)
                    for c in f.msgs(2)]
        # legacy single-repeated-input encoding puts inputs in field 1
        if not children:
            children = [_dec_rel(c, fn_names, table_provider)
                        for c in f.msgs(1)]
        if len(children) < 2:
            raise ArrowInvalid("set relation needs >= 2 inputs")
        decls = [c[0] for c in children]
        return Declaration("union", None, inputs=decls), children[0][1]
    raise ArrowInvalid(f"unsupported rel fields {list(p.fields)}")


def run_query(plan_bytes, table_provider: Callable, device=None) -> Table:
    """Execute a serialized Substrait plan on ``device`` (the card unless
    ``device="cpu"``), giving a host Table (pyarrow.substrait.run_query;
    reference entry: engine/substrait/serde.h DeserializePlans).

    table_provider(names: list[str], schema: Schema) -> a host Table.
    """
    decl, names = deserialize_plan(plan_bytes, table_provider)
    tbl = decl.to_table(device=device)
    if names and len(names) == len(tbl.schema.names):
        tbl = tbl.rename_columns(names)
    return tbl


def deserialize_plan(plan_bytes, table_provider: Callable):
    """(the Declaration of a serialized Substrait plan, its root's output
    names); decoded on the host, nothing runs."""
    plan = PB(bytes(plan_bytes))
    fn_names = _collect_fn_names(plan)
    rels = plan.msgs(3)
    if not rels:
        raise ArrowInvalid("plan has no relations")
    pr = rels[-1]
    names: List[str] = []
    if pr.has(2):
        root = pr.msg(2)
        rel = root.msg(1)
        names = root.strs(2)
    else:
        rel = pr.msg(1)
    if rel is None:
        raise ArrowInvalid("plan relation has no rel payload")
    decl, _ = _dec_rel(rel, fn_names, table_provider)
    return decl, names


# --- expression / schema interchange (pyarrow.substrait API) ----------------

class SubstraitSchema:
    """serialize_schema result: `.schema` = NamedStruct bytes,
    `.expression` = an ExtendedExpression carrying only base_schema."""

    def __init__(self, schema: bytes, expression: bytes):
        self.schema = schema
        self.expression = expression

    def to_pysubstrait(self):
        import importlib
        try:
            proto = importlib.import_module(
                "substrait.gen.proto.extended_expression_pb2")
        except ImportError as e:
            raise ImportError(
                "the 'substrait' python package is required") from e
        msg = proto.ExtendedExpression()
        msg.ParseFromString(self.expression)
        return msg


class BoundExpressions:
    """deserialize_expressions result: schema + named expressions."""

    def __init__(self, schema: T.Schema, expressions: Dict[str, Expression]):
        self.schema = schema
        self.expressions = expressions

    @classmethod
    def from_substrait(cls, message) -> "BoundExpressions":
        buf = message if isinstance(message, (bytes, bytearray)) else \
            message.SerializeToString()
        return deserialize_expressions(bytes(buf))


def _version_msg(field: int) -> bytes:
    return fm(field, fv(2, 44) + fs(5, "arrow_tpu"))


def serialize_schema(schema: T.Schema) -> SubstraitSchema:
    """Schema -> Substrait NamedStruct bytes (+ ExtendedExpression
    envelope), mutually readable with pyarrow."""
    ns = _enc_named_struct(schema)
    expression = fm(4, ns) + _version_msg(7)
    return SubstraitSchema(ns, expression)


def deserialize_schema(buf) -> T.Schema:
    """Substrait NamedStruct bytes -> Schema."""
    return _dec_named_struct(PB(bytes(buf)))


def serialize_expressions(exprs: Sequence[Expression],
                          names: Sequence[str], schema: T.Schema,
                          allow_arrow_extensions: bool = False) -> bytes:
    """Bound expressions -> Substrait ExtendedExpression bytes
    (substrait/extended_expression.proto; engine/substrait/serde.h
    SerializeExpressions)."""
    if len(exprs) != len(names):
        raise ArrowInvalid("exprs and names must have equal length")
    ext = _ExtCollector()
    refs = b""
    for e, nm in zip(exprs, names):
        enc = _enc_expr(e, schema, ext)
        refs += fm(3, fm(1, enc) + fs(3, nm))
    return (ext.encode() + refs + fm(4, _enc_named_struct(schema)) +
            _version_msg(7))


def deserialize_expressions(buf) -> BoundExpressions:
    """Substrait ExtendedExpression bytes -> BoundExpressions."""
    p = PB(bytes(buf))
    fn_names = _collect_fn_names(p)
    base = p.msg(4)
    schema = _dec_named_struct(base) if base is not None else T.Schema([])
    out: Dict[str, Expression] = {}
    for ref in p.msgs(3):
        expr_msg = ref.msg(1)
        if expr_msg is None:
            continue
        expr = _dec_expr(expr_msg, schema, fn_names)
        for nm in ref.strs(3) or [f"expr_{len(out)}"]:
            out[nm] = expr
    return BoundExpressions(schema, out)


def get_supported_functions() -> List[str]:
    """Full substrait function ids this consumer understands
    (pyarrow.substrait.get_supported_functions analogue)."""
    special = {"extract", "round", "substring", "starts_with",
               "ends_with", "contains", "replace", "ltrim", "rtrim",
               "trim", "concat"}
    names = ({k for k, v in _SUB_FN.items() if v} | special |
             {k for k, v in _SUB_AGG.items() if v})
    out = []
    for sub_name in sorted(names):
        yaml = _FN_YAML.get(sub_name, "functions_arithmetic.yaml")
        out.append(f"{_URI}{yaml}#{sub_name}")
    return out
