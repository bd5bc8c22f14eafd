"""Declarative plans: expressions, node options, the plan executor."""

from .exec import Declaration, compile_chain  # noqa: F401
from .expression import Expression, field, scalar  # noqa: F401
from .options import (AggregateNodeOptions, FetchNodeOptions,  # noqa: F401
                      FilterNodeOptions, HashJoinNodeOptions,
                      OrderByNodeOptions, ProjectNodeOptions,
                      TableSourceNodeOptions)
