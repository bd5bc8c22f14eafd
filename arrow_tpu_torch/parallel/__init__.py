"""Distributed execution over a ``torch.distributed`` process group."""

from .distributed import (  # noqa: F401
    DistAggSpec, Mesh, ShardBatch, broadcast_join_batches,
    distributed_groupby, distributed_join_batches, distributed_q1,
    distributed_sort_batch, exchange_rows, gather_host, make_mesh,
    partition_ids, salted_join_batches, shard_batch,
)
