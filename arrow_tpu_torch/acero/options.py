"""Plan node options (counterpart of ``arrow_tpu/acero/options.py``). A table
source holds a DeviceBatch: the port has no host Table."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

from ..device.column import DeviceBatch
from .expression import Expression


class TableSourceNodeOptions:
    def __init__(self, batch: DeviceBatch):
        self.batch = batch


class FilterNodeOptions:
    def __init__(self, filter_expression: Expression):
        self.filter_expression = filter_expression


class ProjectNodeOptions:
    def __init__(self, expressions: Sequence[Expression],
                 names: Optional[Sequence[str]] = None):
        self.expressions = [e if isinstance(e, Expression)
                            else Expression.literal(e) for e in expressions]
        self.names = list(names) if names is not None else None


class AggregateNodeOptions:
    """aggregates: (target, function, options, output_name) each, or
    (target, function, output_name)."""

    def __init__(self, aggregates: Sequence[Tuple], keys: Sequence = ()):
        norm = []
        for agg in aggregates:
            if len(agg) == 4:
                target, fn, options, out_name = agg
            elif len(agg) == 3:
                target, fn, out_name = agg
                options = None
            else:
                raise ValueError("aggregate spec needs 3 or 4 elements")
            norm.append((target, fn, options or {}, out_name))
        self.aggregates = norm
        self.keys = [str(k) for k in keys]


class OrderByNodeOptions:
    def __init__(self, sort_keys: Sequence[Tuple[str, str]],
                 null_placement: str = "at_end"):
        self.sort_keys = [(k, "ascending") if isinstance(k, str) else
                          (k[0], k[1]) for k in sort_keys]
        self.null_placement = null_placement


class FetchNodeOptions:
    def __init__(self, offset: int = 0, count: int = -1):
        self.offset = int(offset)
        self.count = int(count)


JOIN_TYPES = ("inner", "left outer", "right outer", "full outer",
              "left semi", "right semi", "left anti", "right anti")


class HashJoinNodeOptions:
    """An equi-join; the left input probes, the right input builds.
    ``filter`` is a residual predicate on each matched pair. An empty
    output list emits no columns of that side; None emits all."""

    def __init__(self, join_type: str = "inner",
                 left_keys: Sequence[str] = (),
                 right_keys: Sequence[str] = (),
                 left_output: Optional[Sequence[str]] = None,
                 right_output: Optional[Sequence[str]] = None,
                 output_suffix_for_left: str = "",
                 output_suffix_for_right: str = "",
                 disable_bloom_filter: bool = False,
                 filter: Optional[Expression] = None):
        if join_type not in JOIN_TYPES:
            raise ValueError(f"bad join type {join_type!r}")
        self.join_type = join_type
        self.disable_bloom_filter = disable_bloom_filter
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        self.left_output = list(left_output) if left_output is not None \
            else None
        self.right_output = list(right_output) if right_output is not None \
            else None
        self.output_suffix_for_left = output_suffix_for_left
        self.output_suffix_for_right = output_suffix_for_right
        self.filter_expression = filter
