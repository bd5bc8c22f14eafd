"""Expression trees: literal / field_ref / call (counterpart of
``arrow_tpu/acero/expression.py``). An expression evaluates eagerly over a
DeviceBatch through the compute registry."""

from __future__ import annotations

from typing import Optional

from ..compute.registry import ExecContext, get_function
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

    def __hash__(self):
        return hash(repr(self))

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


def _evaluate(expr: Expression, batch: DeviceBatch, ctx: ExecContext):
    if expr.kind == Expression.KIND_LITERAL:
        return expr.value
    if expr.kind == Expression.KIND_FIELD:
        return batch.column(expr.name)
    args = [_evaluate(a, batch, ctx) for a in expr.args]
    if any(isinstance(a, DeviceColumn) and a.dictionary is not None
           for a in args):
        raise NotImplementedError(
            f"{expr.fn} on dictionary-coded columns translates literals "
            "through the dictionary, which is not ported yet (ROADMAP.md, "
            "queue 1, item 7: joins, then Q3 end to end)")
    return get_function(expr.fn).impl(ctx, *args, **expr.options)


def field(name) -> Expression:
    return Expression.field(name)


def scalar(v) -> Expression:
    return Expression.literal(v)
