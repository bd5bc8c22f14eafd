"""Compiled projections and filters, Gandiva's API (counterpart of
``arrow_tpu/gandiva.py``; reference: cpp/src/gandiva/ ``Projector``
projector.h:41, ``Filter`` filter.h:41, the cache of gandiva/cache.h and
selection_vector.h).

Gandiva JIT-compiles an expression tree once and evaluates it over many
record batches. Here an expression list lowers once, at
``make_projector``/``make_filter``, to the plan executor's chain of node
functions (``acero.exec.compile_chain``), which ``evaluate`` runs over
each batch uploaded to ``device`` (the card unless ``device="cpu"``),
once a batch, as a table source is (``acero/source_cache.py``):

* a process-wide cache keyed on (schema, expression tree), as
  gandiva/cache.h's, so making the same projector again is free;
* ``Filter.evaluate`` gives the ``SelectionVector`` of the rows whose
  condition is true (a null condition is not selected). It is computed on
  the device: the condition's rows, then the row ids compacted by them in
  one compaction (K2, as the registered ``indices_nonzero``), and only
  the positions are downloaded. The reference downloads the whole
  condition column and builds the mask row by row in Python;
* ``Projector.evaluate(batch, selection)`` projects only the selected
  rows, gathered on the device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .acero import Declaration, ProjectNodeOptions
from .acero.expression import Expression, field, scalar
from .table import RecordBatch, Table
from .types import Schema


class TreeExprBuilder:
    """Reference: gandiva/tree_expr_builder.h, kept for API parity;
    composing Expressions is the native way."""

    @staticmethod
    def make_field(f) -> Expression:
        return field(f if isinstance(f, str) else f.name)

    @staticmethod
    def make_literal(v) -> Expression:
        return scalar(v)

    @staticmethod
    def make_function(name: str, args: Sequence[Expression],
                      return_type=None) -> Expression:
        return Expression.call(name, *args)

    @staticmethod
    def make_expression(expr: Expression, result_field) -> Tuple:
        name = result_field if isinstance(result_field, str) \
            else result_field.name
        return (expr, name)

    @staticmethod
    def make_condition(expr: Expression) -> Expression:
        return expr

    @staticmethod
    def make_and(exprs: Sequence[Expression]) -> Expression:
        out = exprs[0]
        for e in exprs[1:]:
            out = Expression.call("and_kleene", out, e)
        return out

    @staticmethod
    def make_or(exprs: Sequence[Expression]) -> Expression:
        out = exprs[0]
        for e in exprs[1:]:
            out = Expression.call("or_kleene", out, e)
        return out

    @staticmethod
    def make_in_expression(expr: Expression, values) -> Expression:
        return expr.isin(values)


class SelectionVector:
    """Selected row positions (reference: gandiva/selection_vector.h), a
    uint32 numpy array; ``to_array()`` gives an Arrow Array, as
    SelectionVector::ToArray does."""

    def __init__(self, indices):
        self.indices = np.asarray(indices, dtype=np.uint32)

    def __len__(self) -> int:
        return len(self.indices)

    def to_array(self):
        from .array.array import array as make_array
        return make_array(self.indices)


def _upload(batch, device):
    """``batch`` (a RecordBatch or a Table) on ``device``, over its
    columns' uploads kept by ``acero/source_cache.py``, as a table
    source's: evaluating again over the same batch uploads nothing."""
    from .acero import TableSourceNodeOptions
    if not isinstance(batch, (RecordBatch, Table)):
        raise TypeError(f"cannot evaluate over {type(batch)!r}")
    return TableSourceNodeOptions(batch).upload(device)


class Projector:
    """A compiled projection: the expression list lowers once, at
    construction, to one chain of node functions (LLVMGenerator::Build's
    place); ``evaluate`` runs it over a batch."""

    def __init__(self, schema: Schema,
                 exprs: List[Tuple[Expression, str]]):
        from .acero.exec import compile_chain
        self.schema = schema
        self.exprs = list(exprs)
        self._names = [n for _, n in self.exprs]
        self._fn = compile_chain([
            Declaration("project", ProjectNodeOptions(
                [e for e, _ in self.exprs], self._names)),
        ])

    def evaluate(self, batch, selection: Optional[SelectionVector] = None,
                 device=None) -> List:
        """One Array an expression over ``batch`` (a RecordBatch or a
        Table) on ``device``; with ``selection``, over its rows alone, in
        its order (reference: Projector::Evaluate(batch,
        selection_vector, ...))."""
        from .compute.selection import take_batch
        from .device.column import download_batch
        db = _upload(batch, device)
        if selection is not None:
            dev = db.row_count.device
            idx = torch.from_numpy(selection.indices.astype(np.int64)).to(
                dev)
            if len(idx) and int(idx.max()) >= int(db.row_count):
                raise IndexError("selection vector index out of range")
            db = take_batch(db, idx, torch.tensor(
                len(idx), dtype=torch.int32, device=dev))
        host = download_batch(self._fn(db))
        return [host.column(n) for n in self._names]


class Filter:
    """A compiled filter condition; ``evaluate`` gives the
    SelectionVector of the rows where it is true."""

    def __init__(self, schema: Schema, condition: Expression):
        from .acero.exec import compile_chain
        self.schema = schema
        self.condition = condition
        self._fn = compile_chain([
            Declaration("project", ProjectNodeOptions(
                [condition], ["__cond__"])),
        ])

    def evaluate(self, batch, device=None) -> SelectionVector:
        """The positions of ``batch``'s rows whose condition is true,
        found on ``device``: one compaction of the row ids, and only the
        positions come back."""
        from .compute.move import compact_by_mask
        db = _upload(batch, device)
        cond = self._fn(db).column("__cond__")
        keep = cond.valid_mask(db.row_mask()) & cond.values.to(torch.bool)
        rows = torch.arange(db.capacity, dtype=torch.int64,
                            device=keep.device)
        (pos,), count = compact_by_mask(keep, [rows])
        return SelectionVector(pos[:int(count)].cpu().numpy())


# --- the projector and filter cache (gandiva/cache.h) -----------------------

_CACHE: Dict[tuple, object] = {}


def _schema_key(schema: Schema) -> tuple:
    try:
        return tuple((f.name, str(f.type)) for f in schema.fields)
    except AttributeError:
        return (repr(schema),)


def make_projector(schema: Schema,
                   exprs: List[Tuple[Expression, str]]) -> Projector:
    key = ("proj", _schema_key(schema),
           tuple((repr(e), n) for e, n in exprs))
    hit = _CACHE.get(key)
    if hit is None:
        hit = _CACHE[key] = Projector(schema, exprs)
    return hit


def make_filter(schema: Schema, condition: Expression) -> Filter:
    key = ("filt", _schema_key(schema), repr(condition))
    hit = _CACHE.get(key)
    if hit is None:
        hit = _CACHE[key] = Filter(schema, condition)
    return hit


def get_registered_function_signatures() -> List[str]:
    """The names a projector or filter expression may call (reference:
    gandiva GetRegisteredFunctionSignatures)."""
    from .compute import registry
    return sorted(registry.list_functions())
