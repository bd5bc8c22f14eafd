"""Compute function registry and execution context (counterpart of
``arrow_tpu/compute/registry.py``). A function is a Python callable over
DeviceColumns that runs PyTorch operations eagerly."""

from __future__ import annotations

from typing import Callable, Dict

import torch


class ExecContext:
    """Per-call execution state handed to kernels. ``row_mask_`` may be set
    to a narrower mask (a filter folded into an aggregate)."""

    __slots__ = ("capacity", "row_count", "row_mask_")

    def __init__(self, capacity: int, row_count: torch.Tensor):
        self.capacity = capacity
        self.row_count = row_count
        self.row_mask_ = None

    def row_mask(self) -> torch.Tensor:
        if self.row_mask_ is None:
            self.row_mask_ = (torch.arange(self.capacity, dtype=torch.int32,
                                           device=self.row_count.device)
                              < self.row_count)
        return self.row_mask_


class Function:
    __slots__ = ("name", "kind", "impl")

    def __init__(self, name: str, kind: str, impl: Callable):
        self.name = name
        self.kind = kind
        self.impl = impl


_REGISTRY: Dict[str, Function] = {}


def register(name: str, kind: str):
    def deco(fn):
        _REGISTRY[name] = Function(name, kind, fn)
        return fn
    return deco


def register_alias(alias: str, name: str):
    _REGISTRY[alias] = _REGISTRY[name]


# names of the reference's registry that are not ported yet, by the
# ROADMAP item (queue 1) that holds them; any other unknown name is item 9
_QUEUED = {"tdigest": "9.9", "hash_tdigest": "9.9", "hash32": "10",
           **{n: "11" for n in ("list", "distinct", "pivot_wider",
                                "hash_list", "hash_distinct",
                                "hash_pivot_wider")}}


def get_function(name: str) -> Function:
    if name not in _REGISTRY:
        # the modules that register functions, imported on first lookup
        from . import (aggregate, elementwise, grouper,  # noqa: F401
                       hash_agg, selection, strings, temporal, vector_misc,
                       vector_sort)
    f = _REGISTRY.get(name)
    if f is None:
        raise NotImplementedError(
            f"compute function {name!r} is not ported yet (ROADMAP.md, "
            f"queue 1, item {_QUEUED.get(name, '9: the long tail')})")
    return f
