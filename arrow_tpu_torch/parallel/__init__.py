"""Distributed execution over a ``torch.distributed`` process group."""

from .distributed import (  # noqa: F401
    DistAggSpec, Mesh, ShardBatch, broadcast_join_batches,
    broadcast_join_tables, distributed_groupby, distributed_join_batches,
    distributed_join_tables, distributed_q1, distributed_sort_batch,
    distributed_sort_table, exchange_rows, gather_host, make_mesh,
    partition_ids, salted_join_batches, salted_join_tables, shard_batch,
    shard_table,
)
