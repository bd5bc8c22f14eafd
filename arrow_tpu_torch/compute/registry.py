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


def get_function(name: str) -> Function:
    if name not in _REGISTRY:
        # the modules that register functions, imported on first lookup
        from . import (aggregate, elementwise, hash_agg,  # noqa: F401
                       strings, temporal, vector_misc)
    f = _REGISTRY.get(name)
    if f is None:
        raise NotImplementedError(
            f"compute function {name!r} is not ported yet (ROADMAP.md, "
            "queue 1, item 9: the long tail)")
    return f
