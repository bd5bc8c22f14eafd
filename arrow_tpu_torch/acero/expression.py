"""Expression trees: literal / field_ref / call (counterpart of
``arrow_tpu/acero/expression.py``). An expression evaluates eagerly over a
DeviceBatch through the compute registry. A comparison of a
dictionary-coded column with a literal translates the literal through the
host dictionary, and one of two dictionary-coded columns re-encodes both
against their sorted union dictionary (``unify_device_dicts``) and
compares the codes; the string functions (``compute/strings.py`` and
``compute/extra_kernels.py``) and ``if_else`` take dictionary-coded
columns themselves; ``is_in`` looks the value set up by dictionary slot
(``compute/vector_misc.py``) and keeps a null row null, as the
reference's plans do. Every other function raises on a dictionary-coded
column."""

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
_DICTIONARY_FUNCTIONS = frozenset(STRING_FUNCTIONS + ["if_else"])


def _evaluate(expr: Expression, batch: DeviceBatch, ctx: ExecContext):
    if expr.kind == Expression.KIND_LITERAL:
        return expr.value
    if expr.kind == Expression.KIND_FIELD:
        return batch.column(expr.name)
    args = [_evaluate(a, batch, ctx) for a in expr.args]
    if expr.fn == "is_in":
        col = args[0]
        return DeviceColumn(value_set_lookup(
            col, expr.options.get("value_set", ())), col.validity, T.bool_())
    if expr.fn in _COMPARISONS:
        args = _translate_string_compare(expr.fn, args)
    if expr.fn not in _DICTIONARY_FUNCTIONS \
            and any(_is_string_col(a) for a in args):
        raise NotImplementedError(
            f"{expr.fn} on dictionary-coded columns is not ported yet "
            "(ROADMAP.md, queue 1, item 9: the long tail)")
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
    if not vals:
        raise NotImplementedError(
            "comparing a column with an empty dictionary is not ported yet "
            "(ROADMAP.md, queue 1, item 9.9: the rest of compute)")
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


def field(name) -> Expression:
    return Expression.field(name)


def scalar(v) -> Expression:
    return Expression.literal(v)
