"""Declarative plans: expressions, node options, the chain executor."""

from .exec import Declaration, compile_chain  # noqa: F401
from .expression import Expression, field, scalar  # noqa: F401
from .options import (AggregateNodeOptions, FilterNodeOptions,  # noqa: F401
                      OrderByNodeOptions, ProjectNodeOptions,
                      TableSourceNodeOptions)
