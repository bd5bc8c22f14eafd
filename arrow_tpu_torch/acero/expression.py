"""Expression trees: literal / field_ref / call (counterpart of
``arrow_tpu/acero/expression.py``). An expression evaluates eagerly over a
DeviceBatch through the compute registry. A comparison of a
dictionary-coded column with a literal translates the literal through the
host dictionary, and one of two dictionary-coded columns re-encodes both
against their sorted union dictionary (``unify_device_dicts``) and
compares the codes (an empty dictionary compares as null on every row,
as every row of such a column is null); the string functions
(``compute/strings.py`` and ``compute/extra_kernels.py``), ``if_else``,
``coalesce``, the null and float predicates, ``index_in``, ``cast`` and
``hash32`` take dictionary-coded columns themselves; ``is_in`` looks the
value set up by dictionary slot (``compute/vector_misc.py``) and keeps a
null row null, as the reference's plans do. A function of the values
(arithmetic, rounding, the math functions) raises on a dictionary-coded
column: its codes are not values. ``fold_constants`` and
``simplify_with_guarantee`` simplify a tree on the host (a dataset's
partition pruning)."""

from __future__ import annotations

import bisect
from typing import Optional

import numpy as np
import torch

from .. import types as T
from ..compute import extra_kernels  # noqa: F401 - registers string names
from ..compute.elementwise import unify_device_dicts
from ..compute.registry import ExecContext, get_function
from ..compute.strings import STRING_FUNCTIONS, slot_lookup
from ..compute.vector_misc import value_set_lookup
from ..device.column import DeviceBatch, DeviceColumn


class Expression:
    KIND_LITERAL = "literal"
    KIND_FIELD = "field_ref"
    KIND_CALL = "call"

    __slots__ = ("kind", "value", "name", "fn", "args", "options")

    def __init__(self, kind, value=None, name=None, fn=None, args=(),
                 options=None):
        self.kind = kind
        self.value = value
        self.name = name
        self.fn = fn
        self.args = list(args)
        self.options = options or {}

    @staticmethod
    def literal(v) -> "Expression":
        return Expression(Expression.KIND_LITERAL, value=v)

    @staticmethod
    def field(name) -> "Expression":
        return Expression(Expression.KIND_FIELD, name=name)

    @staticmethod
    def call(fn: str, *args, **options) -> "Expression":
        args = [a if isinstance(a, Expression) else Expression.literal(a)
                for a in args]
        return Expression(Expression.KIND_CALL, fn=fn, args=args,
                          options=options)

    # --- operators (pyarrow.dataset.field()-style sugar) ------------------
    def _bin(self, fn, other, swap=False):
        other = other if isinstance(other, Expression) \
            else Expression.literal(other)
        a, b = (other, self) if swap else (self, other)
        return Expression.call(fn, a, b)

    def __eq__(self, o): return self._bin("equal", o)          # noqa: E704
    def __ne__(self, o): return self._bin("not_equal", o)      # noqa: E704
    def __lt__(self, o): return self._bin("less", o)           # noqa: E704
    def __le__(self, o): return self._bin("less_equal", o)     # noqa: E704
    def __gt__(self, o): return self._bin("greater", o)        # noqa: E704
    def __ge__(self, o): return self._bin("greater_equal", o)  # noqa: E704
    def __add__(self, o): return self._bin("add", o)           # noqa: E704
    def __radd__(self, o): return self._bin("add", o, True)    # noqa: E704
    def __sub__(self, o): return self._bin("subtract", o)      # noqa: E704
    def __rsub__(self, o): return self._bin("subtract", o, True)  # noqa: E704
    def __mul__(self, o): return self._bin("multiply", o)      # noqa: E704
    def __rmul__(self, o): return self._bin("multiply", o, True)  # noqa: E704
    def __truediv__(self, o): return self._bin("divide", o)    # noqa: E704
    def __rtruediv__(self, o): return self._bin("divide", o, True)  # noqa
    def __and__(self, o): return self._bin("and_kleene", o)    # noqa: E704
    def __or__(self, o): return self._bin("or_kleene", o)      # noqa: E704
    def __invert__(self): return Expression.call("invert", self)  # noqa: E704

    def isin(self, values) -> "Expression":
        return Expression.call("is_in", self, value_set=list(values))

    def is_valid(self) -> "Expression":
        return Expression.call("is_valid", self)

    def is_null(self, nan_is_null: bool = False) -> "Expression":
        return Expression.call("is_null", self, nan_is_null=nan_is_null)

    def is_nan(self) -> "Expression":
        return Expression.call("is_nan", self)

    def cast(self, target_type, safe: bool = True,
             options=None) -> "Expression":
        return Expression.call("cast", self, to_type=target_type,
                               safe=safe)

    def to_substrait(self, schema, allow_arrow_extensions: bool = False):
        """This expression as a one-expression Substrait
        ExtendedExpression (pyarrow Expression.to_substrait), bytes."""
        from ..substrait import serialize_expressions
        return serialize_expressions([self], ["expression"], schema)

    @staticmethod
    def from_substrait(message) -> "Expression":
        """The one expression of a Substrait ExtendedExpression."""
        from ..substrait import deserialize_expressions
        buf = message if isinstance(message, (bytes, bytearray)) else (
            message.to_pybytes() if hasattr(message, "to_pybytes")
            else message.SerializeToString())
        bound = deserialize_expressions(bytes(buf))
        if len(bound.expressions) != 1:
            raise ValueError("expected exactly one expression, got "
                             f"{len(bound.expressions)}")
        return next(iter(bound.expressions.values()))

    def equals(self, other: "Expression") -> bool:
        return repr(self) == repr(other)

    def __hash__(self):
        return hash(repr(self))

    def field_names(self) -> list:
        """The names of the fields this expression reads."""
        if self.kind == self.KIND_FIELD:
            return [self.name]
        out = []
        for a in self.args:
            out.extend(a.field_names())
        return out

    def __repr__(self):
        if self.kind == self.KIND_LITERAL:
            return repr(self.value)
        if self.kind == self.KIND_FIELD:
            return f"field({self.name})"
        return f"{self.fn}({', '.join(map(repr, self.args))})"

    def evaluate(self, batch: DeviceBatch,
                 ctx: Optional[ExecContext] = None):
        """This expression over a DeviceBatch -> DeviceColumn (or a Python
        literal for a pure-literal expression)."""
        if ctx is None:
            ctx = ExecContext(batch.capacity, batch.row_count)
        return _evaluate(self, batch, ctx)


_COMPARISONS = ("equal", "not_equal", "less", "less_equal", "greater",
                "greater_equal")
# functions that take dictionary-coded columns themselves
_DICTIONARY_FUNCTIONS = frozenset(STRING_FUNCTIONS + [
    "if_else", "coalesce", "fill_null", "is_null", "is_valid", "is_nan",
    "is_finite", "is_inf", "true_unless_null", "index_in", "cast",
    "hash32"])


def _evaluate(expr: Expression, batch: DeviceBatch, ctx: ExecContext):
    if expr.kind == Expression.KIND_LITERAL:
        return expr.value
    if expr.kind == Expression.KIND_FIELD:
        return batch.column(expr.name)
    args = [_evaluate(a, batch, ctx) for a in expr.args]
    if expr.fn == "is_in":
        col = args[0]
        found, _ = value_set_lookup(col, expr.options.get("value_set", ()))
        return DeviceColumn(found, col.validity, T.bool_())
    if expr.fn in _COMPARISONS:
        args = _translate_string_compare(expr.fn, args)
    if expr.fn not in _DICTIONARY_FUNCTIONS \
            and any(_is_string_col(a) for a in args):
        raise NotImplementedError(
            f"{expr.fn} does not take dictionary-coded (string) columns: "
            "their codes are not values")
    return get_function(expr.fn).impl(ctx, *args, **expr.options)


def _is_string_col(c) -> bool:
    return isinstance(c, DeviceColumn) and c.dictionary is not None


def _translate_string_compare(fn, args):
    """A dictionary-coded column against a literal becomes a compare of
    device integers: equality through a per-slot hit table (derived
    dictionaries may hold a value in several slots), ordering through dense
    value ranks against the literal's rank, or a half-step below its
    insertion point when the dictionary lacks it."""
    a, b = args
    a_str, b_str = _is_string_col(a), _is_string_col(b)
    if not a_str and not b_str:
        return args
    if a_str and b_str:
        # both re-encoded against their sorted union dictionary: the codes
        # are order-preserving ranks, compared as integers
        ua, ub = unify_device_dicts([a, b])
        return [DeviceColumn(c.values.to(torch.int64), c.validity, T.int64())
                for c in (ua, ub)]
    col, lit = (a, b) if a_str else (b, a)
    if isinstance(lit, bool) or not isinstance(lit, (str, bytes, int,
                                                     float)):
        raise TypeError(
            f"cannot compare dictionary-coded values with {type(lit)}")
    vals = list(col.dictionary)
    if fn in ("equal", "not_equal"):
        hits = np.array([v == lit for v in vals], dtype=np.int64)
        new = [DeviceColumn(slot_lookup(col, hits), col.validity,
                            T.int64()), 1]
    else:
        uniq = sorted(set(vals))
        rank_of = {v: i for i, v in enumerate(uniq)}
        ranks = np.array([rank_of[v] for v in vals], dtype=np.int64)
        rank = rank_of[lit] if lit in rank_of \
            else bisect.bisect_left(uniq, lit) - 0.5
        new = [DeviceColumn(slot_lookup(col, ranks), col.validity, T.int64()),
               rank]
    return new if a_str else new[::-1]


# --- simplification ------------------------------------------------------

def fold_constants(expr: Expression) -> Expression:
    """Pure-literal subtrees evaluated on the host, and the Boolean
    short-circuits of a literal operand (reference:
    ``acero/expression.py`` ``fold_constants``; compute/expression.h:214
    FoldConstants)."""
    if expr.kind != Expression.KIND_CALL:
        return expr
    args = [fold_constants(a) for a in expr.args]
    if all(a.kind == Expression.KIND_LITERAL for a in args) and \
            expr.fn in _PY_FOLDS:
        try:
            return Expression.literal(
                _PY_FOLDS[expr.fn](*[a.value for a in args]))
        except Exception:  # noqa: BLE001 - left unfolded, as the reference
            pass
    # Boolean short-circuits (partition pruning relies on these)
    if expr.fn in ("and_kleene", "and") and len(args) == 2:
        for i, a in enumerate(args):
            if a.kind == Expression.KIND_LITERAL:
                if a.value is False:
                    return Expression.literal(False)
                if a.value is True:
                    return args[1 - i]
    if expr.fn in ("or_kleene", "or") and len(args) == 2:
        for i, a in enumerate(args):
            if a.kind == Expression.KIND_LITERAL:
                if a.value is True:
                    return Expression.literal(True)
                if a.value is False:
                    return args[1 - i]
    return Expression(Expression.KIND_CALL, fn=expr.fn, args=args,
                      options=expr.options)


_PY_FOLDS = {
    "add": lambda a, b: a + b,
    "subtract": lambda a, b: a - b,
    "multiply": lambda a, b: a * b,
    "equal": lambda a, b: a == b,
    "not_equal": lambda a, b: a != b,
    "less": lambda a, b: a < b,
    "less_equal": lambda a, b: a <= b,
    "greater": lambda a, b: a > b,
    "greater_equal": lambda a, b: a >= b,
    "and_kleene": lambda a, b: a and b,
    "or_kleene": lambda a, b: a or b,
    "invert": lambda a: not a,
}


def simplify_with_guarantee(expr: Expression,
                            guarantee: Optional[Expression]) -> Expression:
    """``expr`` with the fields an equality ``guarantee`` pins (``field ==
    literal`` terms, and-ed) replaced by their literals, then folded: the
    partition pruning of a dataset (reference: expression.h:224)."""
    if guarantee is None:
        return fold_constants(expr)
    pinned: dict = {}
    _collect_pins(guarantee, pinned)
    return fold_constants(_substitute(expr, pinned))


def _collect_pins(g: Expression, out: dict):
    if g.kind != Expression.KIND_CALL:
        return
    if g.fn == "equal" and len(g.args) == 2:
        a, b = g.args
        if a.kind == Expression.KIND_FIELD and \
                b.kind == Expression.KIND_LITERAL:
            out[a.name] = b.value
        elif b.kind == Expression.KIND_FIELD and \
                a.kind == Expression.KIND_LITERAL:
            out[b.name] = a.value
    elif g.fn == "and_kleene":
        for a in g.args:
            _collect_pins(a, out)


def _substitute(e: Expression, pins: dict) -> Expression:
    if e.kind == Expression.KIND_FIELD and e.name in pins:
        return Expression.literal(pins[e.name])
    if e.kind == Expression.KIND_CALL:
        return Expression(Expression.KIND_CALL, fn=e.fn,
                          args=[_substitute(a, pins) for a in e.args],
                          options=e.options)
    return e


def field(name) -> Expression:
    return Expression.field(name)


def scalar(v) -> Expression:
    return Expression.literal(v)
