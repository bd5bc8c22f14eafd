"""Compute function registry, execution context and the eager entry point
(counterpart of ``arrow_tpu/compute/registry.py``). A function is a Python
callable over DeviceColumns that runs PyTorch operations eagerly;
``call_function`` takes host Arrays, ChunkedArrays and Python scalars,
uploads them, runs the function and downloads its result."""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch


class ArrowInvalid(ValueError):
    pass


class ArrowNotImplementedError(NotImplementedError):
    pass


class Scalar:
    """A typed single value (reference: scalar.h:54): a Python value, or
    None for null."""

    __slots__ = ("value", "type")

    def __init__(self, value, type):
        self.value = value
        self.type = type

    @property
    def is_valid(self) -> bool:
        return self.value is not None

    def as_py(self):
        return self.value

    def __repr__(self):
        return f"Scalar({self.value!r}, {self.type!r})"

    def __eq__(self, other):
        if isinstance(other, Scalar):
            return self.value == other.value and self.type == other.type
        return self.value == other

    __hash__ = None

    def cast(self, target_type, safe=True, options=None, device=None):
        """This value as ``target_type`` (scalar.h CastTo): a one-row
        Array's cast on ``device`` (the card unless ``device="cpu"``)."""
        from ..array.array import array as make_array
        out = make_array([self.value], self.type).cast(target_type,
                                                       device=device)
        return Scalar(out.to_pylist()[0], target_type)

    def equals(self, other) -> bool:
        return (isinstance(other, Scalar) and self.type == other.type
                and self.value == other.value)

    def validate(self, *, full: bool = False):
        return None


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
    """kind: 'elementwise', 'aggregate', 'hash_aggregate', 'vector' or
    'host' (runs on host Arrays). ``ctx_arg``: the array argument whose
    row count the call's context takes (``take`` keys off its
    indices). ``takes_device``: a host function with a device tier, given
    the call's ``device``."""
    __slots__ = ("name", "kind", "impl", "ctx_arg", "takes_device")

    def __init__(self, name: str, kind: str, impl: Callable,
                 ctx_arg: int = 0, takes_device: bool = False):
        self.name = name
        self.kind = kind
        self.impl = impl
        self.ctx_arg = ctx_arg
        self.takes_device = takes_device


_REGISTRY: Dict[str, Function] = {}


def register(name: str, kind: str, ctx_arg: int = 0):
    def deco(fn):
        _REGISTRY[name] = Function(name, kind, fn, ctx_arg)
        return fn
    return deco


def register_host(name: str, takes_device: bool = False):
    """A host-tier function: runs on host Arrays directly. With
    ``takes_device`` it has a device tier (``device_nested.py``) and is
    called with the call's ``device``."""
    def deco(fn):
        _REGISTRY[name] = Function(name, "host", fn,
                                   takes_device=takes_device)
        return fn
    return deco


# name -> the host-tier function that the eager ``call_function`` runs in
# place of the registered one, where that one gives a form only plans read
# (``register_eager``)
_EAGER: Dict[str, Callable] = {}


def register_eager(name: str):
    """``call_function(name, ...)`` runs the decorated host-tier function,
    given the arrays, ``device=`` and the options as keywords; plans go on
    calling the function registered under ``name``."""
    def deco(fn):
        _EAGER[name] = fn
        return fn
    return deco


def register_alias(alias: str, name: str):
    _REGISTRY[alias] = _REGISTRY[name]


def _load():
    # the modules that register functions, imported on first lookup
    from . import (aggregate, elementwise, extra_kernels,  # noqa: F401
                   grouper, hash_agg, hashing, host_kernels, selection,
                   strings, temporal, vector_misc, vector_sort)


def _host_only_grouped(name: str):
    """A grouped aggregate whose output is a list or a struct: the
    aggregate node's host path runs it (``acero/host_agg.py``), as the
    reference registers it (``extra_kernels.py:722-735``)."""
    @register(name, "hash_aggregate")
    def _impl(ctx, values, gids, num_groups, **options):
        raise ArrowInvalid(
            f"{name} runs via Table.group_by / the aggregate node "
            "(host-tier variable-length output)")
    return _impl


for _name in ("hash_list", "hash_distinct", "hash_pivot_wider"):
    _host_only_grouped(_name)


def list_functions() -> List[str]:
    _load()
    return sorted(_REGISTRY)


def function_registry() -> Dict[str, Function]:
    _load()
    return _REGISTRY


def get_function(name: str) -> Function:
    if name not in _REGISTRY:
        _load()
    f = _REGISTRY.get(name)
    if f is None:
        raise NotImplementedError(
            f"no compute function {name!r}: the reference registers "
            "none by that name")
    return f


# --- the eager entry point ----------------------------------------------------

def _host_value(v):
    from ..array.array import Array
    from ..table import ChunkedArray
    if isinstance(v, ChunkedArray):
        return v.combine().to_pylist()
    if isinstance(v, Array):
        return v.to_pylist()
    return v


def call_function(name: str, args: Sequence, options=None, device=None):
    """The pyarrow.compute entry point (reference: ``call_function``):
    host ``Array``s, ``ChunkedArray``s (a Table's columns), ``Scalar``s
    and Python scalars are uploaded to ``device`` (the card unless
    ``device="cpu"`` is given), the port's device function runs there,
    and its result comes back as a host ``Array`` or ``Scalar``
    (``materialize``). An element-wise function first applies the
    reference's implicit casts (``dispatch.unify_inputs``) and recodes
    two or more dictionary columns into one sorted union
    (``dispatch.unify_device_dicts``). ``options`` is a dict or a
    ``FunctionOptions`` object (``compute/options.py``), which may also
    stand among ``args``."""
    from .. import default_device
    from ..array.array import Array
    from ..device.column import DeviceColumn, round_up, upload_column
    from ..table import ChunkedArray
    from ..types import DataType, type_for_name
    from .options import FunctionOptions
    if isinstance(options, FunctionOptions):
        options = options.to_kwargs()
    options = {k: _host_value(v) for k, v in (options or {}).items()}
    # an options object among the arguments is options, as in the
    # reference (``registry.py:250-256``) and pyarrow
    norm_args = []
    for a in args:
        if isinstance(a, FunctionOptions):
            options.update({k: _host_value(v)
                            for k, v in a.to_kwargs().items()})
        else:
            norm_args.append(a)
    args = norm_args
    eager = _EAGER.get(name)
    if eager is not None:
        return eager(*args, device=device, **options)
    if name == "cast" and len(args) >= 2 and \
            isinstance(args[1], (DataType, str)):
        t = args[1]
        options.setdefault("to_type", type_for_name(t)
                           if isinstance(t, str) else t)
        args = args[:1] + args[2:]
    elif any(isinstance(a, DataType) for a in args):
        raise ArrowInvalid(f"{name}: pass DataType arguments via options, "
                           "not positionally")
    fn = get_function(name)
    # the reference's order (registry.py:279-291): the wide decimals, the
    # host cast matrix, the cast to a string type
    from .decimal_host import maybe_wide_decimal_call
    hit = maybe_wide_decimal_call(name, args, options)
    if hit is not None:
        return hit
    if name == "cast":
        from .cast_host import try_cast_host
        hit = try_cast_host(args, options)
        if hit is None:
            hit = _cast_to_string_host(args, options)
        if hit is not None:
            return hit
    if fn.kind == "host":
        if fn.takes_device:
            options["device"] = device
        return fn.impl(*[a.combine() if isinstance(a, ChunkedArray) else a
                         for a in args], **options)
    dev = default_device(device)
    if fn.kind == "elementwise" and name != "cast":
        from .dispatch import unify_inputs
        args = unify_inputs(name, args, options, dev)
    args = [a.combine() if isinstance(a, ChunkedArray) else
            a.value if isinstance(a, Scalar) else a for a in args]
    arrays = [(i, a) for i, a in enumerate(args) if isinstance(a, Array)]
    prepared = list(args)
    if arrays:
        if fn.kind == "elementwise":
            n = len(arrays[0][1])
            if any(len(a) != n for _, a in arrays[1:]):
                raise ArrowInvalid("array arguments must have equal length")
            for i, a in arrays:
                prepared[i] = upload_column(a, round_up(n), dev)
        else:
            n = len(arrays[min(fn.ctx_arg, len(arrays) - 1)][1])
            for i, a in arrays:
                prepared[i] = upload_column(a, round_up(len(a)), dev)
    cols = [p for p in prepared if isinstance(p, DeviceColumn)]
    if not cols:
        raise ArrowInvalid(f"{name}: need at least one array argument")
    if not arrays:
        n = cols[0].capacity
    if fn.kind == "elementwise" and name != "cast":
        from .dispatch import unify_device_dicts
        prepared = unify_device_dicts(prepared)
    ctx_col = cols[min(fn.ctx_arg, len(cols) - 1)]
    ctx = ExecContext(ctx_col.capacity,
                      torch.tensor(n, dtype=torch.int32, device=dev))
    out = materialize(fn.impl(ctx, *prepared, **options), n)
    if name == "run_end_encode":
        # the reference's RunEndEncodedArray (registry.py:359-367)
        from .. import types as T
        from ..array.data import ArrayData
        ends, values = out["run_ends"], out["values"]
        length = int(ends.data.values()[-1]) if len(ends) else 0
        return Array(ArrayData(T.run_end_encoded(ends.type, values.type),
                               length, [], children=[ends.data, values.data],
                               null_count=0))
    return out


def _cast_to_string_host(args, options):
    """A cast of a host Array to a string type, formatted on the host
    (reference ``registry._cast_to_string_host``, after
    scalar_cast_string.cc): bool as true/false, floats positional and
    trimmed, dates ISO, timestamps ``%Y-%m-%d %H:%M:%S`` with the unit's
    fraction digits, the rest by ``str``. None where the call is not such
    a cast."""
    import numpy as np
    from ..array.array import Array, array as make_array
    from ..table import ChunkedArray
    from ..types import TypeId
    t = (options or {}).get("to_type") or (options or {}).get("target_type")
    if t is None or t.id not in (TypeId.STRING, TypeId.LARGE_STRING):
        return None
    a = args[0]
    if isinstance(a, ChunkedArray):
        a = a.combine()
    if not isinstance(a, Array):
        return None
    sid = a.type.id
    if sid in (TypeId.STRING, TypeId.LARGE_STRING):
        return a if sid == t.id else make_array(a.to_pylist(), t)
    digits = {"s": 0, "ms": 3, "us": 6, "ns": 9}.get(
        getattr(a.type, "unit", "s"), 0)

    def fmt(v):
        if v is None:
            return None
        if isinstance(v, bool) or sid == TypeId.BOOL:
            return "true" if v else "false"
        if isinstance(v, float):
            return np.format_float_positional(v, trim="-")
        if hasattr(v, "isoformat"):
            if not hasattr(v, "hour"):
                return v.isoformat()
            s = v.strftime("%Y-%m-%d %H:%M:%S")
            if digits:
                s += f".{v.microsecond:06d}"[:1 + digits].ljust(
                    digits + 1, "0")
            return s
        return str(v)

    return make_array([fmt(v) for v in a.to_pylist()], t)


def materialize(result, n: int):
    """A device result as host values: a DeviceColumn (its first ``n``
    rows) or a ``Compacted`` (its live rows) as an ``Array``, an
    ``AggResult`` as a ``Scalar``, a tuple or dict of them likewise."""
    from .aggregate import AggResult
    from .selection import Compacted
    from ..device.column import DeviceColumn, download_column
    if isinstance(result, Compacted):
        return download_column(result.column, int(result.count))
    if isinstance(result, DeviceColumn):
        return download_column(result, n)
    if isinstance(result, AggResult):
        return _agg_scalar(result)
    if isinstance(result, tuple):
        return tuple(materialize(r, n) for r in result)
    if isinstance(result, dict):
        return {k: materialize(v, n) for k, v in result.items()}
    if isinstance(result, torch.Tensor) and result.dim() == 0:
        return result.item()
    raise TypeError(f"unexpected kernel result {type(result)}")


def _py_scalar(value, t, dictionary):
    """One device value of type ``t`` as the reference's Python value (a
    code decoded through ``dictionary``)."""
    from ..device.column import DeviceColumn, download_column
    if dictionary is not None:
        return dictionary[int(value)]
    v = value if isinstance(value, torch.Tensor) else torch.tensor(value)
    col = DeviceColumn(v.reshape(1).cpu(), None, t)
    return download_column(col, 1).to_pylist()[0]


def _agg_scalar(r) -> Scalar:
    from ..types import TypeId
    if r.fields is not None and r.type.id in (TypeId.LIST,
                                              TypeId.LARGE_LIST):
        # one value a q (``quantile``, ``tdigest`` of several q), as
        # Arrow gives them
        vt = r.type.value_type
        return Scalar([_py_scalar(v, vt, r.dictionary) if bool(ok)
                       else None for v, ok in zip(r.value, r.valid)],
                      r.type)
    if r.fields is not None:
        ftypes = [f.type for f in getattr(r.type, "fields", ())] or \
            [None] * len(r.fields)
        return Scalar({name: _py_scalar(v, ft, r.dictionary) if bool(ok)
                       else None for name, v, ok, ft in zip(
                           r.fields, r.value, r.valid, ftypes)}, r.type)
    if not bool(r.valid):
        return Scalar(None, r.type)
    return Scalar(_py_scalar(r.value, r.type, r.dictionary), r.type)
