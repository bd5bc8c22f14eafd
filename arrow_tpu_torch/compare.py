"""Deep equality with float options (counterpart of ``arrow_tpu/compare.py``;
reference: cpp/src/arrow/compare.h ``ArrayEquals``/``ArrayApproxEquals``
with ``EqualOptions``: atol, nans_equal, signed_zeros_equal)."""

from __future__ import annotations

import math
from typing import Any, Optional

__all__ = ["EqualOptions", "array_equals", "table_equals"]


class EqualOptions:
    """Float comparison knobs (compare.h EqualOptions). Defaults mirror
    the reference: atol=1e-5 only applies via approx_equals; exact
    equality treats NaNs unequal unless nans_equal."""

    def __init__(self, atol: float = 1e-5, nans_equal: bool = False,
                 signed_zeros_equal: bool = True):
        self.atol = atol
        self.nans_equal = nans_equal
        self.signed_zeros_equal = signed_zeros_equal

    def with_atol(self, atol: float) -> "EqualOptions":
        return EqualOptions(atol, self.nans_equal,
                            self.signed_zeros_equal)

    def with_nans_equal(self, v: bool) -> "EqualOptions":
        return EqualOptions(self.atol, v, self.signed_zeros_equal)

    def with_signed_zeros_equal(self, v: bool) -> "EqualOptions":
        return EqualOptions(self.atol, self.nans_equal, v)


def _scalar_eq(a: Any, b: Any, opts: EqualOptions, approx: bool) -> bool:
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, float) and isinstance(b, float):
        if math.isnan(a) or math.isnan(b):
            return opts.nans_equal and math.isnan(a) and math.isnan(b)
        if not opts.signed_zeros_equal and a == 0 and b == 0:
            return math.copysign(1, a) == math.copysign(1, b)
        if approx:
            return abs(a - b) <= opts.atol
        return a == b
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(
            _scalar_eq(x, y, opts, approx) for x, y in zip(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(
            _scalar_eq(a[k], b[k], opts, approx) for k in a)
    return a == b


def array_equals(a, b, options: Optional[EqualOptions] = None,
                 approx: bool = False) -> bool:
    """ArrayEquals / ArrayApproxEquals (compare.h)."""
    opts = options or EqualOptions()
    if a.type != b.type or len(a) != len(b):
        return False
    return all(_scalar_eq(x, y, opts, approx)
               for x, y in zip(a.to_pylist(), b.to_pylist()))


def table_equals(a, b, options: Optional[EqualOptions] = None,
                 approx: bool = False) -> bool:
    if a.schema.names != b.schema.names or a.num_rows != b.num_rows:
        return False
    return all(array_equals(ca.combine(), cb.combine(), options, approx)
               for ca, cb in zip(a.columns, b.columns))
