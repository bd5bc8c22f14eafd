"""Per-query execution state (counterpart of
``arrow_tpu/acero/query_context.py``).

Reference analogue: acero/query_context.h:36 — QueryContext owns the
query's memory accounting, metrics and cancellation state, so a query's
footprint is attributable and boundable.

The accounting is capacity-based, as the reference's: every node output's
padded tensor bytes (``numel() * element_size()`` of each column's values
and one byte a row of a validity mask) add to the query's materialized
total. The total is a deterministic upper bound on what the plan's
outputs hold on the card (the caching allocator may free an intermediate
early), the right direction of error for a budget check.

``QueryOptions(memory_limit=...)`` turns the accounting into enforcement:
going over the limit raises ArrowMemoryError before further nodes run
(reference: CappedMemoryPool, memory_pool.h:254, and QueryOptions,
exec_plan.h:510).
"""

from __future__ import annotations

import threading
from typing import List, Optional, Tuple

__all__ = ["QueryOptions", "QueryContext", "ArrowMemoryError",
           "current_query_context", "query_scope"]


class ArrowMemoryError(ValueError):
    """The query went over its memory budget (reference:
    Status::OutOfMemory from a capped pool). A ValueError, where the
    reference's derives from ArrowInvalid, a ValueError."""


class QueryOptions:
    """Per-query settings (reference: acero/exec_plan.h:510 QueryOptions).

    memory_limit: an optional byte budget for the plan's node outputs.
    collect_metrics: record each node's dispatch time on the context.
    """

    def __init__(self, memory_limit: Optional[int] = None,
                 collect_metrics: bool = True):
        self.memory_limit = memory_limit
        self.collect_metrics = collect_metrics


class QueryContext:
    """State for one plan execution (reference acero/query_context.h:36):
    byte accounting, node metrics, cancellation."""

    def __init__(self, options: Optional[QueryOptions] = None,
                 stop_token=None):
        self.options = options or QueryOptions()
        self.bytes_materialized = 0
        self.node_metrics: List[Tuple[str, float, int]] = []
        if stop_token is None:
            from ..cancel import default_stop_token
            stop_token = default_stop_token()
        self.stop_token = stop_token

    # --- memory accounting -------------------------------------------
    @staticmethod
    def batch_nbytes(batch) -> int:
        """Padded bytes of a DeviceBatch: values, and a byte a row of each
        validity mask."""
        total = 0
        for c in batch.columns:
            total += c.values.numel() * c.values.element_size()
            if c.validity is not None:
                total += c.validity.numel()
        return total

    def track_batch(self, factory: str, batch) -> int:
        n = self.batch_nbytes(batch)
        self.bytes_materialized += n
        limit = self.options.memory_limit
        if limit is not None and self.bytes_materialized > limit:
            raise ArrowMemoryError(
                f"query exceeded memory_limit={limit} bytes at node "
                f"'{factory}' (tracked {self.bytes_materialized})")
        return n

    # --- metrics -----------------------------------------------------
    def record_node(self, factory: str, seconds: float,
                    out_bytes: int) -> None:
        if self.options.collect_metrics:
            self.node_metrics.append((factory, seconds, out_bytes))

    def to_string(self) -> str:
        lines = [f"{f}: {s * 1e3:.2f} ms dispatch, {b} B out"
                 for f, s, b in self.node_metrics]
        lines.append(f"materialized bytes: {self.bytes_materialized}")
        return "\n".join(lines)


_TLS = threading.local()


def current_query_context() -> Optional[QueryContext]:
    return getattr(_TLS, "ctx", None)


class query_scope:
    """Context manager installing a QueryContext for the current thread
    (the plan executor consults it at each node)."""

    def __init__(self, ctx: QueryContext):
        self.ctx = ctx

    def __enter__(self) -> QueryContext:
        self.prev = getattr(_TLS, "ctx", None)
        _TLS.ctx = self.ctx
        return self.ctx

    def __exit__(self, *exc):
        _TLS.ctx = self.prev
