"""String functions on dictionary-coded columns (counterpart of
``arrow_tpu/compute/strings.py``): case, reverse, trims, pads, center,
slices and repeats, replaces, the ``*_is_*`` predicates, lengths,
substring and regex matches, counts and finds, ``match_like`` and
``binary_join_element_wise``. Regexes are Python's ``re``, as in the
reference.

A str -> bool or str -> int function gives one value a dictionary slot,
looked up by the codes on the device. For a dictionary of at least
``DEVICE_STRINGS_MIN`` values the table of the predicates and lengths the
byte pool serves comes from the pool (``device_strings.py``); for a
smaller one, or where the pool's gates decline, from the host tier, one
Python call a slot. Both give the same table. A null dictionary slot
takes the reference's value: False for the substring and regex matches,
0 for counts, -1 for finds, and the function of ``""`` for the
``*_is_*`` predicates and lengths. A null row stays null. Counts, finds
and lengths are int32, as their type says.

A str -> str function maps each dictionary value once and keeps the
codes; where two values map to one, the new dictionary keeps each value
once, in order of first appearance, and the codes are remapped by one
gather (``map_to_new_dictionary``), so grouping, joins and sorts that key
on codes see one code a value. The case functions, reverse, the trims,
pads, center and ``utf8_slice_codeunits`` first try the byte pool's
transform (``device_strings.pool_transform``) in their own body, so plans
and direct calls take the same tier (the reference's plans trace, and only
its eager calls take the pool). Null slots follow the tier the reference's
eager call takes: the host tier maps a null slot to the function of
``""`` for the case functions, reverse and ``utf8_zero_fill`` and keeps it
null for the others; the pool leaves it empty.
"""

from __future__ import annotations

import itertools
import re
from typing import Callable, Optional

import numpy as np
import torch

from .. import types as T
from ..device.column import DeviceColumn
from .device_strings import pool_predicate, pool_transform
from .elementwise import _and_validity
from .registry import register, register_alias

# the names of the string functions, filled as this module and
# ``extra_kernels`` register them: plans hand them dictionary-coded columns
STRING_FUNCTIONS = []


def _string(name: str):
    STRING_FUNCTIONS.append(name)
    return register(name, "elementwise")


def _alias(alias: str, name: str):
    STRING_FUNCTIONS.append(alias)
    register_alias(alias, name)


def slot_lookup(col: DeviceColumn, table) -> torch.Tensor:
    """``table`` (one entry per dictionary slot: a sequence, or a tensor
    on the column's device) looked up by the column's codes, clamped into
    the dictionary."""
    if not isinstance(table, torch.Tensor):
        table = torch.from_numpy(np.asarray(table))
    table = table.to(col.values.device)
    if not len(table):
        return torch.zeros(col.capacity, dtype=table.dtype,
                           device=col.values.device)
    safe = col.values.long().clamp(0, len(table) - 1)
    return table[safe]


def require_string(name: str, col):
    if not isinstance(col, DeviceColumn) or col.dictionary is None:
        raise NotImplementedError(f"{name}: requires a string column")


def host_table(col: DeviceColumn, fn: Callable, dtype, null) -> np.ndarray:
    """``fn`` of each dictionary value, ``null`` for a null slot."""
    d = col.dictionary
    values = (null if v is None else fn(v) for v in d) if None in d \
        else map(fn, d)
    return np.fromiter(values, dtype=dtype, count=len(d))


def _lookup(col: DeviceColumn, table, out_type) -> DeviceColumn:
    return DeviceColumn(slot_lookup(col, table), col.validity, out_type)


def map_to_new_dictionary(col: DeviceColumn, vals: list) -> DeviceColumn:
    """``col`` with its dictionary replaced by ``vals`` (one a slot), each
    value kept once in order of first appearance and the codes remapped
    by one gather where two slots share a value (reference:
    ``_map_to_new_dictionary``)."""
    first = dict.fromkeys(vals)
    if len(first) == len(vals):
        return DeviceColumn(col.values, col.validity, col.type, tuple(vals))
    index = {v: i for i, v in enumerate(first)}
    remap = np.fromiter(map(index.__getitem__, vals), dtype=np.int32,
                        count=len(vals))
    return DeviceColumn(slot_lookup(col, remap), col.validity, col.type,
                        tuple(first))


def transform(name: str, col, fn: Callable, kernel: Optional[str] = None,
              pool_options: Optional[dict] = None,
              null_as_empty: bool = False) -> DeviceColumn:
    """``fn`` of each dictionary value: through the byte pool's
    ``kernel`` with ``pool_options`` where its gates pass, else on the
    host, a null slot mapped as ``fn("")`` (``null_as_empty``) or kept
    null."""
    require_string(name, col)
    if kernel is not None and pool_options is not None:
        out = pool_transform(kernel, col, pool_options)
        if out is not None:
            return out
    if null_as_empty:
        vals = [fn("" if v is None else v) for v in col.dictionary]
    else:
        vals = [None if v is None else fn(v) for v in col.dictionary]
    return map_to_new_dictionary(col, vals)


# --- case conversion and reverse ---------------------------------------------

def _case(name: str, fn: Callable, kernel: str):
    @_string(name)
    def _fn(ctx, col):
        return transform(name, col, fn, kernel, {}, null_as_empty=True)
    return _fn


for _kernel, _fn in (("upper", str.upper), ("lower", str.lower),
                     ("swapcase", str.swapcase),
                     ("capitalize", str.capitalize), ("title", str.title)):
    _case(f"utf8_{_kernel}", _fn, _kernel)
    # the reference's ascii_* case functions are str's methods too
    _alias(f"ascii_{_kernel}", f"utf8_{_kernel}")
_case("utf8_reverse", lambda s: s[::-1], "reverse")
_alias("ascii_reverse", "utf8_reverse")


# --- the *_is_* predicates and lengths ---------------------------------------

def _str_to_bool(name: str, fn: Callable, pool_name: Optional[str] = None):
    """A predicate whose null slot is ``fn("")``."""
    @_string(name)
    def _fn(ctx, col):
        require_string(name, col)
        table = None if pool_name is None else pool_predicate(pool_name, col)
        if table is None:
            table = host_table(col, fn, np.bool_, fn(""))
        return _lookup(col, table, T.bool_())
    return _fn


def _ascii_and(test: Callable) -> Callable:
    return lambda s: s.isascii() and test(s)


for _name, _fn in (("alnum", str.isalnum), ("alpha", str.isalpha),
                   ("decimal", str.isdecimal), ("lower", str.islower),
                   ("upper", str.isupper), ("space", str.isspace)):
    _str_to_bool(f"utf8_is_{_name}", _fn)
    _str_to_bool(f"ascii_is_{_name}", _ascii_and(_fn))
_str_to_bool("utf8_is_digit", str.isdigit)
_str_to_bool("utf8_is_numeric", str.isnumeric)
_str_to_bool("utf8_is_title", str.istitle)
_str_to_bool("utf8_is_printable", str.isprintable)
_str_to_bool("string_is_ascii", str.isascii, "string_is_ascii")


def _length(name: str, fn: Callable):
    @_string(name)
    def _fn(ctx, col):
        return _int_lookup(name, col, fn, 0)
    return _fn


_length("utf8_length", len)
_length("binary_length", lambda s: len(s.encode()))


# --- trims, pads, center -----------------------------------------------------

def _trim(name: str, kernel: str, method: str, whitespace: bool):
    strip = getattr(str, method)
    if whitespace:
        @_string(name)
        def _fn(ctx, col, characters: Optional[str] = None):
            return transform(name, col, strip, kernel, {"whitespace": True}
                             if characters is None else None)
    else:
        @_string(name)
        def _fn(ctx, col, characters: str = ""):
            return transform(name, col, lambda v: strip(v, characters),
                             kernel, {"characters": characters})
    return _fn


for _kernel, _method in (("trim", "strip"), ("ltrim", "lstrip"),
                         ("rtrim", "rstrip")):
    _trim(f"utf8_{_kernel}_whitespace", _kernel, _method, True)
    _trim(f"utf8_{_kernel}", _kernel, _method, False)


def _pad(name: str, kernel: str, method: str):
    just = getattr(str, method)

    @_string(name)
    def _fn(ctx, col, width: int = 0, padding: str = " ",
            lean_left_on_odd_padding: bool = True):
        return transform(name, col, lambda v: just(v, width, padding),
                         kernel, {"width": width, "padding": padding})
    return _fn


_pad("utf8_lpad", "lpad", "rjust")
_pad("utf8_rpad", "rpad", "ljust")
_pad("utf8_center", "center", "center")
_alias("ascii_lpad", "utf8_lpad")
_alias("ascii_rpad", "utf8_rpad")


# --- slice, repeat, reverse of bytes -----------------------------------------

@_string("utf8_slice_codeunits")
def utf8_slice_codeunits(ctx, col, start: int = 0,
                         stop: Optional[int] = None,
                         step: int = 1) -> DeviceColumn:
    """``v[start:stop:step]`` of each dictionary value."""
    return transform("utf8_slice_codeunits", col,
                     lambda v: v[start:stop:step], "slice",
                     {"start": start, "stop": stop, "step": step})


@_string("binary_repeat")
def binary_repeat(ctx, col, num_repeats: int = 1):
    return transform("binary_repeat", col, lambda v: v * num_repeats)


@_string("binary_reverse")
def binary_reverse(ctx, col):
    return transform("binary_reverse", col, lambda v: v[::-1])


# --- substring matches, counts and finds -------------------------------------

def _predicate(name: str, col, test: Callable[[str], bool],
               pool_name: Optional[str] = None, pattern: str = "",
               ignore_case: bool = False) -> DeviceColumn:
    """``test`` of each dictionary value, looked up by the codes (a null
    slot matches nothing): the table from the byte pool's ``pool_name``
    predicate where it serves, else from ``test`` on the host."""
    require_string(name, col)
    table = None if pool_name is None else pool_predicate(
        pool_name, col, pattern, ignore_case)
    if table is None:
        table = host_table(col, lambda v: bool(test(v)), np.bool_, False)
    return _lookup(col, table, T.bool_())


def _flags(ignore_case: bool) -> int:
    return re.IGNORECASE if ignore_case else 0


def _folded(pattern: str, ignore_case: bool):
    """(the pattern, a function of a value) both lowercased under
    ``ignore_case``."""
    if ignore_case:
        return pattern.lower(), str.lower
    return pattern, lambda v: v


@_string("match_substring")
def match_substring(ctx, col, pattern: str = "",
                    ignore_case: bool = False) -> DeviceColumn:
    rx = re.compile(re.escape(pattern), _flags(ignore_case))
    return _predicate("match_substring", col, rx.search, "match_substring",
                      pattern, ignore_case)


@_string("match_substring_regex")
def match_substring_regex(ctx, col, pattern: str = "",
                          ignore_case: bool = False) -> DeviceColumn:
    rx = re.compile(pattern, _flags(ignore_case))
    return _predicate("match_substring_regex", col, rx.search)


@_string("starts_with")
def starts_with(ctx, col, pattern: str = "",
                ignore_case: bool = False) -> DeviceColumn:
    p, fold = _folded(pattern, ignore_case)
    return _predicate("starts_with", col, lambda v: fold(v).startswith(p),
                      "starts_with", pattern, ignore_case)


@_string("ends_with")
def ends_with(ctx, col, pattern: str = "",
              ignore_case: bool = False) -> DeviceColumn:
    p, fold = _folded(pattern, ignore_case)
    return _predicate("ends_with", col, lambda v: fold(v).endswith(p),
                      "ends_with", pattern, ignore_case)


def _like_to_regex(pattern: str) -> str:
    """SQL LIKE as an anchored regular expression: ``%`` any run, ``_`` one
    character, a backslash escapes the next character."""
    out = []
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if c == "\\" and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if c == "%":
            out.append(".*")
        elif c == "_":
            out.append(".")
        else:
            out.append(re.escape(c))
        i += 1
    return "^" + "".join(out) + "$"


@_string("match_like")
def match_like(ctx, col, pattern: str = "",
               ignore_case: bool = False) -> DeviceColumn:
    """SQL LIKE (reference: ``_match_like``). A pattern whose only
    wildcards are ``%`` at its ends is a prefix, suffix, substring or
    equality test, which the byte pool can serve."""
    rx = re.compile(_like_to_regex(pattern), _flags(ignore_case))
    body = pattern.strip("%")
    lead, trail = pattern.startswith("%"), pattern.endswith("%")
    simple = ("_" not in body and "%" not in body and "\\" not in body
              and len(pattern) - len(body) == lead + trail)
    pool_name = None
    if simple:
        pool_name = ("match_substring" if lead and trail else
                     "ends_with" if lead else
                     "starts_with" if trail else "equal_string")
    return _predicate("match_like", col, rx.match, pool_name, body,
                      ignore_case)


def _int_lookup(name: str, col, fn: Callable, null: int,
                pattern: str = "", ignore_case: bool = False
                ) -> DeviceColumn:
    """``fn`` of each value as int32, ``null`` for a null slot: from the
    byte pool's ``name`` where it serves, else on the host."""
    require_string(name, col)
    table = pool_predicate(name, col, pattern, ignore_case)
    if table is None:
        table = host_table(col, fn, np.int32, null)
    return _lookup(col, table, T.int32())


@_string("count_substring")
def count_substring(ctx, col, pattern: str = "", ignore_case: bool = False):
    """Non-overlapping occurrences of ``pattern`` (``str.count``)."""
    p, fold = _folded(pattern, ignore_case)
    return _int_lookup("count_substring", col, lambda v: fold(v).count(p),
                       0, pattern, ignore_case)


@_string("find_substring")
def find_substring(ctx, col, pattern: str = "", ignore_case: bool = False):
    """The first index of ``pattern`` (``str.find``), -1 where absent."""
    p, fold = _folded(pattern, ignore_case)
    return _int_lookup("find_substring", col, lambda v: fold(v).find(p),
                       -1, pattern, ignore_case)


# --- replace -----------------------------------------------------------------

@_string("replace_substring")
def replace_substring(ctx, col, pattern: str = "", replacement: str = "",
                      max_replacements: Optional[int] = None):
    n = -1 if max_replacements is None else max_replacements
    return transform("replace_substring", col,
                     lambda v: v.replace(pattern, replacement, n))


@_string("replace_substring_regex")
def replace_substring_regex(ctx, col, pattern: str = "",
                            replacement: str = "",
                            max_replacements: Optional[int] = None):
    rx = re.compile(pattern)
    n = 0 if max_replacements is None else max_replacements
    return transform("replace_substring_regex", col,
                     lambda v: rx.sub(replacement, v, count=n))


# --- concatenation -----------------------------------------------------------

_JOIN_MAX_VALUES = 1 << 20


@_string("binary_join_element_wise")
def binary_join_element_wise(ctx, *cols, null_handling: str = "emit_null"):
    """Row-wise concatenation of dictionary-coded columns, the last one
    the separator (literals are dropped, as in the reference): a row's
    code is the mixed-radix code of its inputs' codes, its dictionary the
    product of theirs (up to 2**20 values), null where any input is."""
    scols = [c for c in cols if isinstance(c, DeviceColumn)]
    for c in scols:
        require_string("binary_join_element_wise", c)
    if len(scols) < 2:
        raise ValueError("binary_join_element_wise: need at least 2 columns "
                         "+ separator")
    sizes = [len(c.dictionary) for c in scols]
    if int(np.prod(sizes, dtype=object)) > _JOIN_MAX_VALUES:
        raise NotImplementedError(
            "binary_join_element_wise dictionary product too large")
    combined = torch.zeros(scols[0].capacity, dtype=torch.int64,
                           device=scols[0].values.device)
    for c, s in zip(scols, sizes):
        combined = combined * s + c.values.to(torch.int64)
    vals = tuple((sep or "").join(p or "" for p in ps)
                 for *ps, sep in itertools.product(
                     *(c.dictionary for c in scols)))
    return DeviceColumn(combined.to(torch.int32),
                        _and_validity(*(c.validity for c in scols)),
                        scols[0].type, vals)

