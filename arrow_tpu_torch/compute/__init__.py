"""Compute functions over DeviceColumns, and the public eager API over host
values (counterpart of ``arrow_tpu/compute/__init__.py``; reference:
python/pyarrow/compute.py:244).

Each function takes host ``Array``s, ``ChunkedArray``s and Python scalars,
runs the port's device function on ``device`` (the card unless
``device="cpu"`` is given) and gives a host ``Array`` or ``Scalar``
(``registry.call_function``). Besides the explicit wrappers below, every
registered name is a wrapper of its own (``__getattr__``): ``compute.add(a,
b, device="cpu")``; ``and_``/``or_`` for the keywords. Options come as
keywords, as a dict or as a ``FunctionOptions`` object (``options.py``:
``compute.quantile(a, options=QuantileOptions(q=[0.1, 0.9]))``).

User-defined functions (reference: ``register_scalar_function`` and the
rest, python/pyarrow/_compute.pyx): a UDF is a Python function of a
``UdfContext`` and host Arrays, registered as a host-tier function; its
body may call this module's functions, which run on the card."""

from __future__ import annotations

import os

import numpy as np

from .registry import (ArrowInvalid, ArrowNotImplementedError,  # noqa: F401
                       ExecContext, Scalar, call_function, get_function,
                       list_functions, register_eager)
from .options import *  # noqa: F401,F403 - the FunctionOptions classes
from .options import FunctionOptions, __all__ as _OPTIONS
from .registry import Function
# pyarrow.compute builds expressions too: t.filter(pc.field("a") > 1)
from ..acero.expression import Expression, field, scalar  # noqa: F401

__all__ = [
    "call_function", "list_functions", "get_function", "function_registry",
    "Scalar", "ArrowInvalid", "ArrowNotImplementedError", "Expression",
    "field", "scalar", "utf8_zfill", "Kernel", "ScalarKernel",
    "VectorKernel", "ScalarAggregateKernel", "HashAggregateKernel",
    "Function", "ScalarFunction", "VectorFunction", "ScalarAggregateFunction",
    "HashAggregateFunction", "FunctionRegistry",
    "filter", "take", "drop_null", "sort_indices", "array_sort_indices",
    "select_k_unstable", "rank", "unique", "value_counts",
    "dictionary_encode", "partition_nth_indices", "top_k_unstable",
    "bottom_k_unstable", "UdfContext", "register_scalar_function",
    "register_aggregate_function", "register_vector_function",
    "register_tabular_function", "call_tabular_function",
] + _OPTIONS


def _combine(a):
    from ..table import ChunkedArray
    return a.combine() if isinstance(a, ChunkedArray) else a


def _is_tabular(x) -> bool:
    from ..table import RecordBatch, Table
    return isinstance(x, (Table, RecordBatch))


def filter(values, mask, null_selection_behavior: str = "drop",
           device=None):
    """Rows of ``values`` (an Array, or a Table or RecordBatch) where
    ``mask`` is true."""
    if _is_tabular(values):
        return _filter_table(values, mask, null_selection_behavior, device)
    return call_function("filter", [_combine(values), _combine(mask)],
                         {"null_selection_behavior": null_selection_behavior},
                         device=device)


def _filter_table(tbl, mask, null_selection_behavior, device):
    from .. import default_device
    from ..device.column import (download_batch, upload_batch,
                                 upload_column)
    from ..table import RecordBatch, Table
    from .selection import filter_batch
    dev = default_device(device)
    is_table = isinstance(tbl, Table)
    rb = RecordBatch(tbl.schema, [c.combine() for c in tbl.columns]) \
        if is_table else tbl
    db = upload_batch(rb, device=dev)
    out = download_batch(filter_batch(
        db, upload_column(_combine(mask), db.capacity, dev),
        null_selection_behavior))
    return Table.from_batches([out]) if is_table else out


def take(values, indices, boundscheck: bool = True, device=None):
    """Rows ``indices`` of ``values`` (an Array, or a Table or
    RecordBatch, column by column)."""
    if _is_tabular(values):
        from ..table import RecordBatch, Table
        cols = [_combine(c) for c in values.columns]
        taken = [take(c, indices, boundscheck, device) for c in cols]
        make = Table if isinstance(values, Table) else RecordBatch
        return make.from_arrays(taken, values.schema.names)
    v = _combine(values)
    return call_function("take", [v, _combine(indices), len(v)],
                         {"boundscheck": boundscheck}, device=device)


def drop_null(values, device=None):
    if _is_tabular(values):
        from ..array.array import array as make_array
        cols = [_combine(c) for c in values.columns]
        m = np.ones(values.num_rows, dtype=bool)
        for c in cols:
            m &= c.is_valid_mask()
        return filter(values, make_array(m), device=device)
    return call_function("drop_null", [_combine(values)], device=device)


def _norm_sort_keys(sort_keys):
    return [(k, "ascending") if isinstance(k, str) else (k[0], k[1])
            for k in sort_keys]


def sort_indices(data, sort_keys=None, null_placement: str = "at_end",
                 order: str = "ascending", device=None):
    """The stable sort's permutation (uint64) of an Array, or of a Table
    or RecordBatch by ``sort_keys``."""
    if _is_tabular(data):
        keys = _norm_sort_keys(sort_keys or [(data.schema.names[0],
                                              "ascending")])
        cols = [_combine(data.column(name)) for name, _ in keys]
    else:
        keys = [("", order)]
        cols = [_combine(data)]
    return call_function("sort_indices", cols,
                         {"sort_keys": keys,
                          "null_placement": null_placement}, device=device)


def array_sort_indices(values, order: str = "ascending",
                       null_placement: str = "at_end", device=None):
    return sort_indices(values, order=order, null_placement=null_placement,
                        device=device)


def select_k_unstable(data, k: int, sort_keys=None, device=None):
    return sort_indices(data, sort_keys=sort_keys,
                        device=device).slice(0, k)


def rank(values, sort_keys="ascending", null_placement: str = "at_end",
         tiebreaker: str = "first", device=None):
    return call_function("rank", [_combine(values)],
                         {"sort_keys": sort_keys,
                          "null_placement": null_placement,
                          "tiebreaker": tiebreaker}, device=device)


def unique(values, device=None):
    return call_function("unique", [_combine(values)], device=device)


def value_counts(values, device=None):
    """A struct Array of ``values`` and ``counts`` (vector_hash.cc)."""
    from .. import types as T
    from ..array.array import Array
    from ..array.data import ArrayData
    res = call_function("value_counts", [_combine(values)], device=device)
    vals, counts = res["values"], res["counts"]
    st = T.struct([("values", vals.type), ("counts", T.int64())])
    return Array(ArrayData(st, len(vals), [None],
                           children=[vals.data, counts.data], null_count=0))


@register_eager("dictionary_encode")
def dictionary_encode(values, device=None, null_encoding_behavior="mask"):
    """A dictionary array of ``values`` in order of first appearance
    (vector_hash.cc DictionaryEncode): the unique non-null values, codes
    by ``index_in``, nulls null (``null_encoding_behavior="mask"``, the
    only behavior the reference has). It is also what the eager
    ``call_function("dictionary_encode")`` gives; plans keep the
    grouper's codes (``grouper.dictionary_encode``)."""
    from .. import types as T
    from ..array.array import Array
    from ..array.data import ArrayData
    if null_encoding_behavior != "mask":
        raise ArrowNotImplementedError(
            f"dictionary_encode: null_encoding_behavior="
            f"{null_encoding_behavior!r} (only 'mask')")
    a = _combine(values)
    if a.type.id == T.TypeId.DICTIONARY:
        return a
    uniq = call_function("unique", [a], device=device)
    if uniq.null_count:
        uniq = call_function("drop_null", [uniq], device=device)
    codes = call_function("index_in", [a],
                          {"value_set": tuple(uniq.to_pylist())},
                          device=device)
    d = codes.data
    return Array(ArrayData(T.dictionary(T.int32(), a.type), d.length,
                           list(d.buffers), null_count=d._null_count,
                           offset=d.offset, dictionary=uniq.data))


def partition_nth_indices(values, pivot: int, device=None):
    return call_function("partition_nth_indices", [_combine(values)],
                         {"pivot": pivot}, device=device)


def top_k_unstable(values, k, sort_keys=None, device=None):
    """Indices of the k largest elements (api_vector.h SelectKOptions)."""
    keys = [("dummy", "descending")] if sort_keys is None \
        else [(n, "descending") for n in sort_keys]
    return call_function("select_k_unstable", [_combine(values)],
                         {"k": k, "sort_keys": keys}, device=device)


def bottom_k_unstable(values, k, sort_keys=None, device=None):
    """Indices of the k smallest elements."""
    keys = [("dummy", "ascending")] if sort_keys is None \
        else [(n, "ascending") for n in sort_keys]
    return call_function("select_k_unstable", [_combine(values)],
                         {"k": k, "sort_keys": keys}, device=device)


def utf8_zfill(strings, width=None, padding="0", *, options=None,
               memory_pool=None, device=None):
    """Alias of ``utf8_zero_fill`` (pyarrow.compute.utf8_zfill)."""
    opts = {"width": width, "padding": padding} if options is None else \
        (options.to_kwargs() if hasattr(options, "to_kwargs")
         else dict(options))
    return call_function("utf8_zero_fill", [_combine(strings)], opts,
                         device=device)


class Kernel:
    """A kernel descriptor (compute/kernel.h). The port's kernels are
    Python callables over DeviceColumns; the class exists for the API."""


class ScalarKernel(Kernel):
    pass


class VectorKernel(Kernel):
    pass


class ScalarAggregateKernel(Kernel):
    pass


class HashAggregateKernel(Kernel):
    pass


class ScalarFunction(Function):
    __slots__ = ()


class VectorFunction(Function):
    __slots__ = ()


class ScalarAggregateFunction(Function):
    __slots__ = ()


class HashAggregateFunction(Function):
    __slots__ = ()


class FunctionRegistry:
    """The registered functions by name (compute/registry.h:46)."""

    def list_functions(self):
        return list_functions()

    def get_function(self, name):
        return get_function(name)


def function_registry() -> FunctionRegistry:
    """The function registry (pyarrow.compute.function_registry); the
    name -> Function dict itself is ``registry.function_registry()``."""
    return FunctionRegistry()


class UdfContext:
    """The first argument of a UDF (pyarrow.compute.UdfContext): the
    default memory pool and the length of the call's batch."""

    def __init__(self, batch_length: int = 0):
        from ..memory import default_memory_pool
        self.memory_pool = default_memory_pool()
        self.batch_length = batch_length


def _udf_doc(function_doc) -> str:
    return function_doc.get("summary", "") if isinstance(function_doc, dict) \
        else str(function_doc)


def _register_udf(function_name, impl):
    from .registry import _REGISTRY, Function
    _REGISTRY[function_name] = Function(function_name, "host", impl)
    globals()[function_name] = _make_wrapper(function_name)


def register_scalar_function(func, function_name, function_doc, in_types,
                             out_type):
    """A scalar UDF: ``func(ctx, *arrays)`` gives an Array (or values made
    one of ``out_type``); called through ``call_function`` and as
    ``compute.<function_name>`` on host Arrays."""
    from ..array.array import Array, array as make_array
    from ..table import ChunkedArray

    def impl(*args, **options):
        args = [_combine(a) for a in args]
        out = func(UdfContext(len(args[0]) if args and hasattr(
            args[0], "__len__") else 0), *args)
        if not isinstance(out, (Array, ChunkedArray)) and \
                out_type is not None and not hasattr(out, "type"):
            out = make_array(out, out_type)
        return out
    impl.__doc__ = _udf_doc(function_doc)
    _register_udf(function_name, impl)


def register_aggregate_function(func, function_name, function_doc,
                                in_types, out_type):
    """An aggregate UDF: ``func(ctx, *arrays)`` gives one value, returned
    as a ``Scalar`` of ``out_type``."""
    def impl(*args, **options):
        args = [_combine(a) for a in args]
        out = func(UdfContext(len(args[0]) if args else 0), *args)
        return out if isinstance(out, Scalar) else Scalar(out, out_type)
    impl.__doc__ = _udf_doc(function_doc)
    _register_udf(function_name, impl)


def register_vector_function(func, function_name, function_doc, in_types,
                             out_type):
    """A vector UDF (whole arrays in, an array out)."""
    register_scalar_function(func, function_name, function_doc, in_types,
                             out_type)


_TABULAR_FUNCS: dict = {}


def register_tabular_function(func, function_name, function_doc, in_types,
                              out_type):
    """A UDF that makes a table: ``func(ctx, *args)`` gives a Table or a
    RecordBatchReader."""
    _TABULAR_FUNCS[function_name] = func


def call_tabular_function(function_name, args=None, func_registry=None):
    """The registered tabular UDF's output as a RecordBatchReader (a Table
    it gives is read batch by batch)."""
    from ..table import Table
    fn = _TABULAR_FUNCS.get(function_name)
    if fn is None:
        raise KeyError(f"no tabular function {function_name!r}")
    out = fn(UdfContext(), *(args or ()))
    return out.to_reader() if isinstance(out, Table) else out


def _make_wrapper(name: str):
    def wrapper(*args, device=None, options=None, **kwargs):
        if isinstance(options, FunctionOptions):
            options = options.to_kwargs()
        opts = dict(options or {})
        opts.update(kwargs)
        return call_function(name, list(args), opts or None, device=device)
    wrapper.__name__ = wrapper.__qualname__ = name
    wrapper.__doc__ = f"compute function {name!r} over host values"
    return wrapper


_ALIASES = {"and_": "and", "or_": "or"}


def __getattr__(name: str):
    """A wrapper of the registered function ``name`` (not of a grouped
    ``hash_`` aggregate, which the aggregate node runs)."""
    target = _ALIASES.get(name, name)
    if name.startswith("_") or target.startswith("hash_") or \
            os.path.exists(os.path.join(os.path.dirname(__file__),
                                        name + ".py")) \
            or target not in list_functions():
        # a submodule's name is the import system's to resolve
        raise AttributeError(name)
    fn = _make_wrapper(target)
    globals()[name] = fn
    return fn
