"""Declarative plans: expressions, node options, the plan executor."""

from .exec import Declaration, compile_chain  # noqa: F401
from .expression import Expression, field, scalar  # noqa: F401
from .query_context import (ArrowMemoryError, QueryContext,  # noqa: F401
                            QueryOptions)
from .options import (AggregateNodeOptions,  # noqa: F401
                      AsofJoinNodeOptions, FetchNodeOptions,
                      FilterNodeOptions, HashJoinNodeOptions,
                      OrderByNodeOptions, OrderBySinkNodeOptions,
                      ProjectNodeOptions, SelectKSinkNodeOptions,
                      SinkNodeOptions, SortedMergeNodeOptions,
                      TableSinkNodeOptions, TableSourceNodeOptions,
                      UnionNodeOptions)
