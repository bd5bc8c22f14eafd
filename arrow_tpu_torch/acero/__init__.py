"""Declarative plans: expressions, node options, the plan executor.
``release_uploads(table)`` frees the card and page-locked memory that
table sources keep for a host Table's columns (``source_cache``)."""

from .exec import (Declaration, compile_chain,  # noqa: F401
                   execute_declaration)
from .expression import Expression, field, scalar  # noqa: F401
from .query_context import (ArrowMemoryError, QueryContext,  # noqa: F401
                            QueryOptions)
from .options import (AggregateNodeOptions,  # noqa: F401
                      AsofJoinNodeOptions, ConsumingSinkNodeOptions,
                      ExecNodeOptions,
                      FetchNodeOptions, FilterNodeOptions,
                      HashJoinNodeOptions, OrderByNodeOptions,
                      OrderBySinkNodeOptions, PivotLongerNodeOptions,
                      PivotLongerRowTemplate, ProjectNodeOptions,
                      RecordBatchReaderSourceNodeOptions,
                      ScanNodeOptions, SelectKSinkNodeOptions, SinkNodeOptions,
                      SortedMergeNodeOptions, TableSinkNodeOptions,
                      TableSourceNodeOptions, UnionNodeOptions)
from .source_cache import release as release_uploads  # noqa: F401
