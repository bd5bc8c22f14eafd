"""String predicates on dictionary-coded columns: ``match_substring``,
``starts_with``, ``ends_with`` and ``match_like`` (counterpart of
``arrow_tpu/compute/strings.py``).

Each runs the reference's host tier (``_map_to_lookup``): one boolean per
dictionary slot, computed on the host, then looked up by the codes on the
device. A null dictionary value matches nothing; a null row stays null.
The reference's device byte-pool tier for large dictionaries
(``device_strings.py``) is not ported (ROADMAP.md, queue 1, item 9).
"""

from __future__ import annotations

import re
from typing import Callable, Sequence

import numpy as np
import torch

from .. import types as T
from ..device.column import DeviceColumn
from .registry import register

_LONG_TAIL = "(ROADMAP.md, queue 1, item 9: the long tail)"


def slot_lookup(col: DeviceColumn, table: Sequence) -> torch.Tensor:
    """``table`` (one entry per dictionary slot) looked up by the column's
    codes, clamped into the dictionary."""
    table = np.asarray(table)
    if not len(table):
        return torch.zeros(col.capacity, dtype=torch.from_numpy(table).dtype,
                           device=col.values.device)
    safe = col.values.long().clamp(0, len(table) - 1)
    return torch.from_numpy(table).to(col.values.device)[safe]


def _predicate(name: str, col, test: Callable[[str], bool]
               ) -> DeviceColumn:
    """``test`` of each dictionary value, looked up by the codes."""
    if not isinstance(col, DeviceColumn) or col.dictionary is None:
        raise NotImplementedError(
            f"{name} on a column that is not dictionary-coded is not ported "
            "yet " + _LONG_TAIL)
    table = np.array([v is not None and bool(test(v))
                      for v in col.dictionary], dtype=np.bool_)
    return DeviceColumn(slot_lookup(col, table), col.validity, T.bool_())


def _flags(ignore_case: bool) -> int:
    return re.IGNORECASE if ignore_case else 0


@register("match_substring", "elementwise")
def match_substring(ctx, col, pattern: str = "",
                    ignore_case: bool = False) -> DeviceColumn:
    rx = re.compile(re.escape(pattern), _flags(ignore_case))
    return _predicate("match_substring", col, rx.search)


@register("starts_with", "elementwise")
def starts_with(ctx, col, pattern: str = "",
                ignore_case: bool = False) -> DeviceColumn:
    p = pattern.lower() if ignore_case else pattern
    return _predicate("starts_with", col, lambda v: (
        v.lower() if ignore_case else v).startswith(p))


@register("ends_with", "elementwise")
def ends_with(ctx, col, pattern: str = "",
              ignore_case: bool = False) -> DeviceColumn:
    p = pattern.lower() if ignore_case else pattern
    return _predicate("ends_with", col, lambda v: (
        v.lower() if ignore_case else v).endswith(p))


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
    """SQL LIKE (reference: ``_match_like``)."""
    rx = re.compile(_like_to_regex(pattern), _flags(ignore_case))
    return _predicate("match_like", col, rx.match)


STRING_FUNCTIONS = ("match_substring", "starts_with", "ends_with",
                    "match_like")
