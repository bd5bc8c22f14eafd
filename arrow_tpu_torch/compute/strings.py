"""String functions on dictionary-coded columns: the predicates
``match_substring``, ``starts_with``, ``ends_with`` and ``match_like``, and
the transform ``utf8_slice_codeunits`` (counterpart of
``arrow_tpu/compute/strings.py``).

A predicate gives one boolean a dictionary slot, looked up by the codes on
the device. For a dictionary of at least ``DEVICE_STRINGS_MIN`` values
the table comes from the device byte pool (``device_strings.py``); for a
smaller one, or where the pool's gates decline, from the reference's host
tier (``_map_to_lookup``), one Python test a slot. Both give the same
table. A null dictionary value matches nothing; a null row stays null.

A transform maps each dictionary value once on the host and keeps the
codes; where two values map to one (a slice), the new dictionary keeps
each value once, in order of first appearance, and the codes are remapped
by one gather (``map_to_new_dictionary``), so grouping, joins and sorts
that key on codes see one code a value.
"""

from __future__ import annotations

import re
from typing import Callable, Optional

import numpy as np
import torch

from .. import types as T
from ..device.column import DeviceColumn
from .device_strings import pool_predicate
from .registry import register

_LONG_TAIL = "(ROADMAP.md, queue 1, item 9.8: temporal and strings)"


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


def _require_dictionary(name: str, col):
    if not isinstance(col, DeviceColumn) or col.dictionary is None:
        raise NotImplementedError(
            f"{name} on a column that is not dictionary-coded is not ported "
            "yet " + _LONG_TAIL)


def _predicate(name: str, col, test: Callable[[str], bool],
               pool_name: Optional[str] = None, pattern: str = "",
               ignore_case: bool = False) -> DeviceColumn:
    """``test`` of each dictionary value, looked up by the codes: the
    table from the byte pool's ``pool_name`` predicate where it serves,
    else from ``test`` on the host."""
    _require_dictionary(name, col)
    table = None if pool_name is None else pool_predicate(
        pool_name, col, pattern, ignore_case)
    if table is None:
        table = np.array([v is not None and bool(test(v))
                          for v in col.dictionary], dtype=np.bool_)
    return DeviceColumn(slot_lookup(col, table), col.validity, T.bool_())


def _flags(ignore_case: bool) -> int:
    return re.IGNORECASE if ignore_case else 0


@register("match_substring", "elementwise")
def match_substring(ctx, col, pattern: str = "",
                    ignore_case: bool = False) -> DeviceColumn:
    rx = re.compile(re.escape(pattern), _flags(ignore_case))
    return _predicate("match_substring", col, rx.search, "match_substring",
                      pattern, ignore_case)


@register("starts_with", "elementwise")
def starts_with(ctx, col, pattern: str = "",
                ignore_case: bool = False) -> DeviceColumn:
    p = pattern.lower() if ignore_case else pattern
    return _predicate("starts_with", col, lambda v: (
        v.lower() if ignore_case else v).startswith(p), "starts_with",
        pattern, ignore_case)


@register("ends_with", "elementwise")
def ends_with(ctx, col, pattern: str = "",
              ignore_case: bool = False) -> DeviceColumn:
    p = pattern.lower() if ignore_case else pattern
    return _predicate("ends_with", col, lambda v: (
        v.lower() if ignore_case else v).endswith(p), "ends_with",
        pattern, ignore_case)


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


@register("match_like", "elementwise")
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


def map_to_new_dictionary(col: DeviceColumn, vals: list) -> DeviceColumn:
    """``col`` with its dictionary replaced by ``vals`` (one a slot), each
    value kept once in order of first appearance and the codes remapped
    by one gather where two slots share a value (reference:
    ``_map_to_new_dictionary``)."""
    first = {}
    for v in vals:
        if v not in first:
            first[v] = len(first)
    if len(first) == len(vals):
        return DeviceColumn(col.values, col.validity, col.type, tuple(vals))
    remap = np.fromiter((first[v] for v in vals), dtype=np.int32,
                        count=len(vals))
    return DeviceColumn(slot_lookup(col, remap), col.validity, col.type,
                        tuple(first))


@register("utf8_slice_codeunits", "elementwise")
def utf8_slice_codeunits(ctx, col, start: int = 0,
                         stop: Optional[int] = None,
                         step: int = 1) -> DeviceColumn:
    """``v[start:stop:step]`` of each dictionary value."""
    _require_dictionary("utf8_slice_codeunits", col)
    return map_to_new_dictionary(col, [
        None if v is None else v[start:stop:step] for v in col.dictionary])


# the functions that take dictionary-coded columns themselves
STRING_FUNCTIONS = ("match_substring", "starts_with", "ends_with",
                    "match_like", "utf8_slice_codeunits")
